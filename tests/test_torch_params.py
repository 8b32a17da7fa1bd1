"""The parameter bridge (inklayer_tpu_torch.params): JAX param trees of the
TINY SAM and GroundingDINO load into the port's modules with
load_state_dict(strict=True), every key round-trips through the forward
rules of inklayer_tpu.io.weights, and each layout transform inverts the
forward one exactly."""

import numpy as np
import pytest

from inklayer_tpu.io import weights as W
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_gdino import TINY as TINY_GDINO
from tests.test_torch_gdino import gdino_pair
from tests.test_torch_sam import MASK_PROMPT, sam_pair


@pytest.mark.parametrize("pair_fn", [sam_pair, gdino_pair])
def test_bridged_state_dict_loads_strict(pair_fn):
    _, params, model = pair_fn()  # load_state_dict(strict=True) inside
    flat = flatten_tree(params["params"])
    # every param but SAM's mask-prompt convnet, which the JAX tree lacks
    assert sum(v.size for v in flat.values()) == sum(
        p.numel() for k, p in model.state_dict().items()
        if not k.startswith(MASK_PROMPT))


def _forward(sd, rules, ignore=()):
    """The JAX package's converter applied to a torch state dict."""
    flat, _ = W.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, rules, strict=True,
        ignore=ignore)
    return flat


def test_sam_bridge_inverts_the_checkpoint_rules():
    _, params, model = sam_pair()
    flat = flatten_tree(params["params"])
    back = _forward(model.state_dict(), W.SAM_RULES)
    # load_sam_params' two-way MLP rename (lin1/lin2 -> layer0/layer1)
    back = {k.replace("/mlp/layer10/", "/mlp/layer0/")
            .replace("/mlp/layer20/", "/mlp/layer1/"): v
            for k, v in back.items()}
    # the rules map the mask-prompt convnet, and load_sam_params' template
    # (the JAX tree) drops it
    back = {k: v for k, v in back.items()
            if not k.startswith("prompt_encoder/mask_")}
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_gdino_bridge_inverts_the_checkpoint_rules():
    _, params, model = gdino_pair()
    flat = flatten_tree(params["params"])
    back = W._split_in_proj(_forward(model.state_dict(), W.GDINO_RULES,
                                     W.GDINO_IGNORE), TINY_GDINO.dec_layers)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("name,shape", [("linear", (3, 5)),
                                        ("conv", (2, 3, 4, 5)),
                                        ("convT", (4, 5, 2, 3))])
def test_layout_transforms_invert(rng, name, shape):
    from inklayer_tpu_torch.params import _INVERSE_TRANSFORMS

    torch_w = rng.standard_normal(shape).astype(np.float32)
    flax_w = W.TRANSFORMS[name](torch_w)
    np.testing.assert_array_equal(_INVERSE_TRANSFORMS[name](flax_w), torch_w)


def test_unknown_param_is_refused():
    with pytest.raises(KeyError):
        jax_to_torch_state_dict({"image_encoder/nonexistent/kernel":
                                 np.zeros((2, 2), np.float32)}, W.SAM_RULES)
