"""Port parity: SAM decoder export (``io/export.py``) at the TINY config of
tests/test_sam.py — the saved ``.pt2`` program, loaded again, against the
port's ``decode_boxes`` (float32, the same ops: atol = rtol = 1e-5) and
against the JAX package's exported StableHLO decode through the bridged
params (atol = rtol = 1e-3, the SAM parity tolerance of
tests/test_torch_sam.py).  Export follows the device rule: traced with the
kernels' rule (``use_kernel`` true, as on the card) a LayerNorm is
recorded as its custom op, whose CPU version is the plain one (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.export import export_sam_decoder as jax_export
from inklayer_tpu.io.export import load_exported as jax_load
from inklayer_tpu_torch import runtime
from inklayer_tpu_torch.io.export import (export_fn, export_sam_decoder,
                                          load_exported)
from tests.test_sam import TINY
from tests.test_torch_sam import sam_pair

EXACT = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm, params, tm = sam_pair(std=0.5)
    path = str(tmp_path_factory.mktemp("export") / "sam_decoder.pt2")
    program, blob = export_sam_decoder(tm, TINY, path, box_capacity=4)
    return params, tm, path, program, blob


def _inputs(rng):
    grid = TINY.image_size // TINY.patch_size
    emb = rng.standard_normal((1, grid, grid, TINY.prompt_embed_dim)
                              ).astype(np.float32)
    boxes = np.asarray([[8.0, 8.0, 40.0, 48.0], [0.0, 0.0, 64.0, 64.0],
                        [30.0, 2.0, 33.0, 60.0], [5.0, 40.0, 20.0, 44.0]],
                       np.float32)
    return emb, boxes


def test_saved_program_matches_decode_boxes(exported, rng):
    _, tm, path, _, blob = exported
    with open(path, "rb") as f:
        assert f.read() == blob
    program = load_exported(path).module()
    emb, boxes = _inputs(rng)
    with torch.no_grad():
        logits, iou = program(torch.from_numpy(emb), torch.from_numpy(boxes))
        want_logits, want_iou = tm.decode_boxes(torch.from_numpy(emb),
                                                torch.from_numpy(boxes))
    assert logits.shape == (4, 1, 16, 16) and iou.shape == (4, 1)
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), **EXACT)
    np.testing.assert_allclose(iou.numpy(), want_iou.numpy(), **EXACT)
    # the image encoder's weights stay out of the program
    names = set(load_exported(path).state_dict)
    assert names and not any("image_encoder" in n for n in names)


def test_saved_program_matches_the_jax_export(exported, rng, tmp_path):
    params, _, path, _, _ = exported
    jpath = str(tmp_path / "sam_decoder.stablehlo")
    jax_export(params, TINY, jpath, box_capacity=4)
    emb, boxes = _inputs(rng)
    want_logits, want_iou = jax_load(jpath).call(jnp.asarray(emb),
                                                 jnp.asarray(boxes))
    with torch.no_grad():
        logits, iou = load_exported(path).module()(torch.from_numpy(emb),
                                                   torch.from_numpy(boxes))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **MODEL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), **MODEL)


def test_export_runs_inside_disable_kernels(tmp_path):
    """``export_fn`` leaves the kernel switch as its caller set it: on its
    own the traced forward sees it closed; inside a caller's
    ``disable_kernels`` it runs there."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(runtime._disable_depth)
            return x * 2

    export_fn(Probe(), (torch.ones(3),))
    with runtime.disable_kernels():
        _, blob = export_fn(Probe(), (torch.ones(3),),
                            str(tmp_path / "p.pt2"))
    assert seen == [0, 1]
    assert runtime._disable_depth == 0
    out = load_exported(str(tmp_path / "p.pt2")).module()(torch.arange(3.0))
    np.testing.assert_array_equal(out.numpy(), [0.0, 2.0, 4.0])


@pytest.mark.parametrize("residual", [False, True])
def test_traced_layernorm_is_its_custom_op(monkeypatch, tmp_path, rng,
                                           residual):
    """Traced where the kernel would launch (``use_kernel`` true, as for a
    CUDA tensor), the LayerNorm becomes ``inklayer::layernorm*_2d``; the
    saved program runs that op's CPU version, the plain one, exactly."""
    from inklayer_tpu_torch.nn.layers import LayerNorm
    from inklayer_tpu_torch.ops import norm

    ln = LayerNorm(32)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.normal_()
    x, y = (torch.from_numpy(rng.standard_normal((2, 300, 32)
                                                 ).astype(np.float32))
            for _ in range(2))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = ln

        def forward(self, x, y):
            return self.ln(x, y) if residual else self.ln(x + y)

    monkeypatch.setattr(norm, "use_kernel", lambda *t: True)
    program, _ = export_fn(Net(), (x, y), str(tmp_path / "ln.pt2"))
    monkeypatch.undo()
    op = "layernorm_residual_2d" if residual else "layernorm_2d"
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert f"inklayer.{op}.default" in targets, targets
    assert not any("aten.mean" in t or "aten.rsqrt" in t for t in targets)
    with torch.no_grad():
        got = load_exported(str(tmp_path / "ln.pt2")).module()(x, y)
        want = Net()(x, y)
    for g, w in zip(got if residual else [got], want if residual else [want]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
