"""Checkpoint loading: the port's reader and key policy
(inklayer_tpu_torch.io.weights) and ``build_pipeline(models_dir=...)``,
against the JAX package's inklayer_tpu/io/weights.py.

Synthetic reference-layout state dicts (SAM and Depth-Anything-V2 from
tests/test_weights.py; GroundingDINO, UNet, ControlNet, VAE and CLIP from
the inverted rule tables, as tests/test_weights_diffusion.py builds them)
are written as ``.pth`` files, the diffusion ones also as
``.safetensors``.  Each file loads through the JAX package's loader and
through the port's, and both models run on the same seeded numpy input.

Tolerances, those of the parity tests of each model: SAM and GDINO fp32
atol = rtol = 1e-3 (tests/test_torch_sam.py, test_torch_gdino.py); depth,
CLIP, UNet, ControlNet and VAE relative L2 <= 1e-4
(tests/test_torch_depth.py, test_torch_diffusion.py).  The safetensors
reader and writer: bit for bit.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io import weights as W
from inklayer_tpu.models.depth import DepthAnythingV2 as JaxDepth
from inklayer_tpu.models.diffusion import (AutoencoderKL as JaxVAE,
                                           CLIPTextEncoder as JaxCLIP,
                                           ControlNet as JaxControlNet,
                                           UNet2DCondition as JaxUNet)
from inklayer_tpu.models.gdino import GroundingDINO as JaxGDINO
from inklayer_tpu.models.gdino import subsentence_masks
from inklayer_tpu.models.sam import Sam as JaxSam
from inklayer_tpu_torch.io import weights as TW
from inklayer_tpu_torch.models.depth import DepthAnythingV2
from inklayer_tpu_torch.models.diffusion import (AutoencoderKL,
                                                 CLIPTextEncoder, ControlNet,
                                                 UNet2DCondition)
from inklayer_tpu_torch.models.gdino import GroundingDINO
from inklayer_tpu_torch.models.sam import Sam
from tests.test_depth import TINY as TINY_DEPTH
from tests.test_diffusion import TINY as TINY_DIFFUSION
from tests.test_gdino import TINY as TINY_GDINO
from tests.test_sam import TINY as TINY_SAM
from tests.test_weights import (_tiny_depth_torch_state_dict,
                                _tiny_sam_torch_state_dict)
from tests.test_weights_diffusion import (_INV_SHAPES, _invert_rule,
                                          _source_key, _synthesize)

MODEL = dict(atol=1e-3, rtol=1e-3)  # SAM, GDINO
REL = 1e-4  # depth, CLIP, UNet, ControlNet, VAE
IDS = np.asarray([[101, 4874, 1012, 102]])  # "object."


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _save_pth(sd, path, wrap=None, prefix=""):
    tensors = {prefix + k: torch.as_tensor(v) for k, v in sd.items()}
    torch.save(tensors if wrap is None else {wrap: tensors}, path)
    return str(path)


def _template(model, args):
    return jax.eval_shape(lambda k: model.init(k, *args), jax.random.key(0))


def _nchw(a):
    return torch.from_numpy(np.array(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2), order="C"))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# SAM, GroundingDINO, Depth-Anything-V2 (.pth)
# ---------------------------------------------------------------------------


def _sam_args(cfg=TINY_SAM):
    return (jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
            jnp.zeros((2, 4)))


def test_sam_checkpoint_matches_jax(rng, tmp_path):
    sd = _tiny_sam_torch_state_dict(rng)
    path = _save_pth(sd, tmp_path / "sam_vit_h_4b8939.pth")
    params = W.load_sam_params(path, TINY_SAM, JaxSam(TINY_SAM), _sam_args())
    tm = TW.load_checkpoint(Sam(TINY_SAM), path).eval()
    # the mask-prompt convnet, which the JAX tree drops, lands in the port
    np.testing.assert_array_equal(
        tm.prompt_encoder.mask_downscaling[3].weight.detach().numpy(),
        sd["prompt_encoder.mask_downscaling.3.weight"])
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[8.0, 8.0, 40.0, 48.0], [0.0, 0.0, 64.0, 64.0]],
                       np.float32)
    want_logits, want_iou = jax.jit(JaxSam(TINY_SAM).apply)(
        params, jnp.asarray(img), jnp.asarray(boxes))
    with torch.no_grad():
        logits, iou = tm(torch.from_numpy(img), torch.from_numpy(boxes))
    assert np.abs(np.asarray(want_logits)).max() > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **MODEL)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), **MODEL)


def _gdino_args(cfg=TINY_GDINO):
    attn, pos = subsentence_masks(IDS)
    bucket = cfg.shape_buckets[0]
    return (jnp.zeros((1,) + bucket + (3,)), jnp.zeros((1,) + bucket, bool),
            jnp.asarray(IDS, jnp.int32), jnp.asarray(attn),
            jnp.asarray(pos.astype(np.int32)))


def gdino_state_dict(rng, cfg=TINY_GDINO):
    """A reference-layout GroundingDINO state dict covering every param of
    the JAX template: packed nn.MultiheadAttention in_proj tensors and the
    inverted GDINO_RULES (tests/test_weights_diffusion.py
    test_gdino_conversion_coverage)."""
    d = cfg.hidden_dim
    sd, covered = {}, set()

    def packed(key, layer_paths):
        sd[f"{key}.in_proj_weight"] = \
            rng.standard_normal((3 * d, d)).astype(np.float32) * 0.02
        sd[f"{key}.in_proj_bias"] = \
            rng.standard_normal((3 * d,)).astype(np.float32) * 0.02
        for nm in "qkv":
            for kind in ("kernel", "bias"):
                covered.add(layer_paths.format(nm=nm, kind=kind))

    for i in range(cfg.dec_layers):
        packed(f"transformer.decoder.layers.{i}.self_attn",
               f"transformer/dec_layer_{i}/sa_{{nm}}/{{kind}}")
        packed(f"transformer.decoder.layers.{i}.ca_text",
               f"transformer/dec_layer_{i}/ca_text_{{nm}}/{{kind}}")
    for i in range(cfg.enc_layers):
        packed(f"transformer.encoder.text_layers.{i}.self_attn",
               f"transformer/enc_text_{i}/{{nm}}_proj/{{kind}}")
    inverted = sorted(((r, *_invert_rule(r)) for r in W.GDINO_RULES
                       if not r.path.startswith("__special")),
                      key=lambda t: t[2])
    flat, _ = jax.tree_util.tree_flatten_with_path(
        _template(JaxGDINO(cfg), _gdino_args(cfg)))
    for path, leaf in flat:
        fpath = "/".join(str(getattr(p, "key", p)) for p in path[1:])
        if fpath in covered:
            continue
        rule, regex = next((r, rx) for r, rx, _ in inverted
                           if rx.match(fpath))
        key = _source_key(rule, list(regex.match(fpath).groups()))
        shape = _INV_SHAPES[rule.transform_name](tuple(leaf.shape))
        sd[key] = rng.standard_normal(shape).astype(np.float32) * 0.2
    return sd


# keys of a real GroundingDINO checkpoint that both loaders drop
GDINO_DROPPED = {
    "bert.pooler.dense.weight": (16, 16), "bert.pooler.dense.bias": (16,),
    "label_enc.weight": (2001, 32),
    "bbox_embed.1.layers.0.weight": (32, 32),
    "transformer.decoder.bbox_embed.0.layers.0.bias": (32,),
}


def test_gdino_checkpoint_matches_jax(rng, tmp_path):
    sd = gdino_state_dict(rng)
    for k, shape in GDINO_DROPPED.items():
        sd[k] = np.zeros(shape, np.float32)
    sd["bert.embeddings.position_ids"] = np.arange(8)[None]
    # the training checkpoint's wrapper and DataParallel prefix
    path = _save_pth(sd, tmp_path / "inklayer_gdino.pth", wrap="model",
                     prefix="module.")
    params = W.load_gdino_params(path, TINY_GDINO, JaxGDINO(TINY_GDINO),
                                 _gdino_args())
    tm = TW.load_checkpoint(GroundingDINO(TINY_GDINO), path,
                            TW.GDINO_IGNORE).eval()
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((1, 64, 64), bool)
    pad[:, 50:, :] = True
    attn, pos = subsentence_masks(IDS)
    want_logits, want_boxes = jax.jit(JaxGDINO(TINY_GDINO).apply)(
        params, jnp.asarray(img), jnp.asarray(pad),
        jnp.asarray(IDS, jnp.int32), jnp.asarray(attn),
        jnp.asarray(pos.astype(np.int32)))
    with torch.no_grad():
        logits, boxes = tm(torch.from_numpy(img), torch.from_numpy(pad),
                           torch.from_numpy(IDS), torch.from_numpy(attn),
                           torch.from_numpy(pos))
    want_logits = np.asarray(want_logits)
    finite = np.isfinite(want_logits)
    np.testing.assert_array_equal(np.isfinite(logits.numpy()), finite)
    np.testing.assert_allclose(logits.numpy()[finite], want_logits[finite],
                               **MODEL)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), **MODEL)


def test_depth_checkpoint_matches_jax(rng, tmp_path):
    sd = _tiny_depth_torch_state_dict(rng)  # with mask_token: dropped
    path = _save_pth(sd, tmp_path / "depth_anything_v2_vitb.pth")
    jm = JaxDepth(TINY_DEPTH)
    params = W.load_depth_params(
        path, TINY_DEPTH, jm,
        (jnp.zeros((1, TINY_DEPTH.input_size, TINY_DEPTH.input_size, 3)),))
    tm = TW.load_checkpoint(DepthAnythingV2(TINY_DEPTH), path,
                            TW.DEPTH_IGNORE).eval()
    x = rng.standard_normal((1, 56, 70, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= REL


# ---------------------------------------------------------------------------
# the diffusion components (.pth and .safetensors)
# ---------------------------------------------------------------------------


def _diffusion_spec(name, cfg=TINY_DIFFUSION):
    """(JAX module, its example args, the port module, the JAX rules, the
    JAX loader) of one diffusion component at ``cfg``."""
    s8, c, t = cfg.resolution // 8, cfg.cross_attention_dim, cfg.text_maxlen
    if name == "text":
        heads = max(1, c // 64)
        return (JaxCLIP(hidden=c, heads=heads, max_len=t),
                (jnp.zeros((2, t), jnp.int32),),
                CLIPTextEncoder(hidden=c, heads=heads, max_len=t),
                W.CLIP_TEXT_RULES, W.load_clip_text_params)
    if name == "unet":
        return (JaxUNet(block_channels=cfg.unet_block_channels, context_dim=c),
                (jnp.zeros((2, s8, s8, 9)), jnp.zeros((2,), jnp.int32),
                 jnp.zeros((2, t, c))),
                UNet2DCondition(block_channels=cfg.unet_block_channels,
                                context_dim=c),
                W.UNET_RULES, W.load_unet_params)
    if name == "controlnet":
        return (JaxControlNet(block_channels=cfg.unet_block_channels,
                              context_dim=c),
                (jnp.zeros((2, s8, s8, 4)), jnp.zeros((2,), jnp.int32),
                 jnp.zeros((2, t, c)),
                 jnp.zeros((2, cfg.resolution, cfg.resolution, 3))),
                ControlNet(block_channels=cfg.unet_block_channels,
                           context_dim=c),
                W.CONTROLNET_RULES, W.load_controlnet_params)
    return (JaxVAE(cfg.vae_channels, cfg.latent_channels),
            (jnp.zeros((1, cfg.resolution, cfg.resolution, 3)),),
            AutoencoderKL(cfg.vae_channels, cfg.latent_channels),
            W.VAE_RULES, W.load_vae_params)


def _diffusion_outputs(name, jm, params, tm, rng):
    """[(port output, JAX output)] of one component on seeded inputs."""
    cfg = TINY_DIFFUSION
    s8, c, t = cfg.resolution // 8, cfg.cross_attention_dim, cfg.text_maxlen
    if name == "text":
        ids = rng.integers(0, 1000, (2, t)).astype(np.int32)
        with torch.no_grad():
            got = tm(torch.from_numpy(ids).long())
        return [(got.numpy(), jm.apply(params, jnp.asarray(ids)))]
    x = rng.standard_normal((2, s8, s8, 9)).astype(np.float32)
    ts = np.asarray([999, 500], np.int32)
    ctx = rng.standard_normal((2, t, c)).astype(np.float32)
    if name == "unet":
        want = jm.apply(params, jnp.asarray(x), jnp.asarray(ts),
                        jnp.asarray(ctx))
        with torch.no_grad():
            got = tm(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx))
        return [(_nhwc(got), want)]
    if name == "controlnet":
        cond = rng.uniform(-1, 1, (2, cfg.resolution, cfg.resolution, 3)
                           ).astype(np.float32)
        down_j, mid_j = jm.apply(params, jnp.asarray(x[..., :4]),
                                 jnp.asarray(ts), jnp.asarray(ctx),
                                 jnp.asarray(cond))
        with torch.no_grad():
            down_t, mid_t = tm(_nchw(x[..., :4]), torch.from_numpy(ts),
                               torch.from_numpy(ctx), _nchw(cond))
        return [(_nhwc(g), w) for g, w in zip(down_t, down_j)] + \
            [(_nhwc(mid_t), mid_j)]
    img = rng.uniform(-1, 1, (2, cfg.resolution, cfg.resolution, 3)
                      ).astype(np.float32)
    z = rng.standard_normal((2, s8, s8, 4)).astype(np.float32)
    with torch.no_grad():
        got_z, got_x = tm.encode(_nchw(img)), tm.decode(_nchw(z))
    return [(_nhwc(got_z), jm.apply(params, jnp.asarray(img),
                                    method=JaxVAE.encode)),
            (_nhwc(got_x), jm.apply(params, jnp.asarray(z),
                                    method=JaxVAE.decode))]


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
@pytest.mark.parametrize("name", ["text", "unet", "controlnet", "vae"])
def test_diffusion_checkpoint_matches_jax(name, fmt, rng, tmp_path):
    jm, args, tm, rules, jax_loader = _diffusion_spec(name)
    sd = _synthesize(rules, _template(jm, args), rng)
    if name == "text":  # an I64 buffer of real CLIP files, dropped by both
        sd["text_model.embeddings.position_ids"] = np.arange(
            TINY_DIFFUSION.text_maxlen)[None]
    path = str(tmp_path / f"{name}.{fmt}")
    if fmt == "pth":
        _save_pth(sd, path)
    else:  # the JAX package reads it with the safetensors package
        TW.save_safetensors({k: torch.from_numpy(np.asarray(v))
                             for k, v in sd.items()}, path)
    params = jax_loader(path, jm, args)
    tm = TW.load_checkpoint(tm, path, TW.DIFFUSION_IGNORE).eval()
    for got, want in _diffusion_outputs(name, jm, params, tm, rng):
        assert np.abs(np.asarray(want)).max() > 0
        assert _rel(got, want) <= REL


# ---------------------------------------------------------------------------
# the loader's refusals, wrappers and prefixes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault,error", [("unknown key", KeyError),
                                         ("missing param", KeyError),
                                         ("shape mismatch", ValueError)])
def test_faulty_checkpoint_raises_like_jax(rng, tmp_path, fault, error):
    sd = _tiny_sam_torch_state_dict(rng)
    if fault == "unknown key":
        sd["image_encoder.blocks.0.attn.extra"] = np.zeros(3, np.float32)
    elif fault == "missing param":
        del sd["mask_decoder.iou_token.weight"]
    else:
        sd["image_encoder.neck.1.bias"] = np.zeros(7, np.float32)
    path = _save_pth(sd, tmp_path / "sam.pth")
    with pytest.raises(error):
        W.load_sam_params(path, TINY_SAM, JaxSam(TINY_SAM), _sam_args())
    with pytest.raises(error, match="sam.pth"):
        TW.load_checkpoint(Sam(TINY_SAM), path)


@pytest.mark.parametrize("wrap", [None, "model", "state_dict", "module"])
@pytest.mark.parametrize("prefix", ["", "module.", "model.", "module.model."])
def test_wrappers_and_prefixes_like_jax(tmp_path, wrap, prefix):
    sd = {"0.weight": np.arange(6, dtype=np.float32).reshape(2, 3),
          "0.bias": np.ones(2, np.float32), "1.weight": np.eye(2, 2,
                                                               dtype=np.float32),
          "1.bias": np.zeros(2, np.float32)}
    path = _save_pth(sd, tmp_path / "m.pth", wrap=wrap, prefix=prefix)
    want = W.load_torch_state_dict(path)
    got = TW.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    model = TW.load_checkpoint(torch.nn.Sequential(torch.nn.Linear(3, 2),
                                                   torch.nn.Linear(2, 2)),
                               path)
    np.testing.assert_array_equal(model[0].weight.detach().numpy(),
                                  sd["0.weight"])


class _TrainingArgs:  # pickled beside the weights, as training scripts do
    lr = 1e-4


def test_pickled_objects_are_refused_with_a_pointer(tmp_path):
    """weights_only=True (the JAX package unpickles anything)."""
    path = str(tmp_path / "inklayer_gdino.pth")
    torch.save({"model": {"w": torch.ones(2)}, "args": _TrainingArgs()}, path)
    assert set(W.load_torch_state_dict(path)) == {"w"}
    with pytest.raises(pickle.UnpicklingError,
                       match="inklayer_gdino.pth.*add_safe_globals"):
        TW.load_torch_state_dict(path)


# ---------------------------------------------------------------------------
# the safetensors reader and writer
# ---------------------------------------------------------------------------


def _tensors(dtype):
    gen = torch.Generator().manual_seed(0)
    return {"a.weight": (torch.randn(3, 5, generator=gen) * 3).to(dtype),
            "b": torch.randn(7, generator=gen).to(dtype),
            "c.scalar": torch.tensor(1.5).to(dtype),
            "d.empty": torch.zeros(0, 4, dtype=dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_own_safetensors_reader_equals_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "t.safetensors")
    st.save_file(_tensors(dtype), path, metadata={"format": "pt"})
    want = st.load_file(path)
    got = TW.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_writer_round_trips(tmp_path, dtype):
    path = str(tmp_path / "t.safetensors")
    tensors = _tensors(dtype)
    tensors["view"] = tensors["a.weight"].t()  # not contiguous
    TW.save_safetensors(tensors, path)
    got = TW.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with open(path, "rb") as f:  # the data section starts 8-aligned
        assert int.from_bytes(f.read(8), "little") % 8 == 0


def test_truncated_safetensors_file_raises(tmp_path):
    path = str(tmp_path / "t.safetensors")
    TW.save_safetensors(_tensors(torch.float32), path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="offsets"):
        TW.read_safetensors(path)


# ---------------------------------------------------------------------------
# build_pipeline(models_dir=...) and main --models_dir
# ---------------------------------------------------------------------------


def tiny_port_config(tmp_path):
    """The port's PipelineConfig of TINY_PIPE with the TINY diffusion
    section (through the JAX package's JSON)."""
    from inklayer_tpu.config import save_config
    from inklayer_tpu_torch.config import load_config
    from tests.test_pipeline import TINY_PIPE

    path = str(tmp_path / "tiny.json")
    save_config(dataclasses.replace(
        TINY_PIPE, diffusion=dataclasses.replace(TINY_DIFFUSION,
                                                 num_steps=2)), path)
    return path, load_config(path)


def write_models_dir(cfg, models_dir, seed=123):
    """Reference-layout files of the port's seeded placeholder models at
    ``cfg`` (fp32), in the layout build_pipeline looks for; returns
    {component: state dict written}."""
    from inklayer_tpu_torch import build

    os.makedirs(models_dir, exist_ok=True)
    pipe = build.build_pipeline(cfg, device="cpu", dtype=torch.float32,
                                seed=seed)
    written = {"gdino": pipe.detector.model.state_dict(),
               "sam": pipe.sam.model.state_dict(),
               "depth": pipe.depth.model.state_dict()}
    torch.save({"model": {"module." + k: v
                          for k, v in written["gdino"].items()}},
               os.path.join(models_dir, "inklayer_gdino.pth"))
    torch.save(written["sam"], os.path.join(models_dir,
                                            "sam_vit_h_4b8939.pth"))
    torch.save(written["depth"], os.path.join(
        models_dir, f"depth_anything_v2_{cfg.depth.encoder}.pth"))
    sd15 = os.path.join(models_dir, "stable-diffusion-inpainting")
    files = {
        "unet": os.path.join(sd15, "unet",
                             "diffusion_pytorch_model.safetensors"),
        "vae": os.path.join(sd15, "vae", "diffusion_pytorch_model.safetensors"),
        "text": os.path.join(sd15, "text_encoder", "pytorch_model.bin"),
        "controlnet": os.path.join(models_dir, "control_v11p_sd15_inpaint",
                                   "diffusion_pytorch_model.safetensors")}
    models = build.build_diffusion_models(cfg, "cpu", torch.float32,
                                          seed=seed)
    for name, path in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sd = models[name].state_dict()
        if path.endswith(".bin"):
            torch.save(sd, path)
        else:
            TW.save_safetensors(sd, path)
        written[name] = sd
    return written


def _equal_state(model, want):
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].float(), v.float()), k


def test_build_pipeline_loads_every_file_under_models_dir(tmp_path, capsys):
    from inklayer_tpu_torch.build import build_pipeline

    _, cfg = tiny_port_config(tmp_path)
    models_dir = str(tmp_path / "models")
    written = write_models_dir(cfg, models_dir)
    os.makedirs(os.path.join(models_dir, "bert-base-uncased"))
    vocab = os.path.join(models_dir, "bert-base-uncased", "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "object",
                           "."]) + "\n")
    tok = os.path.join(models_dir, "clip-vit-large-patch14")
    os.makedirs(tok)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        f.write('{"<|startoftext|>": 1, "<|endoftext|>": 2, "a</w>": 3}')
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version\n")
    capsys.readouterr()
    pipe = build_pipeline(cfg, device="cpu", dtype=torch.float32, seed=0,
                          models_dir=models_dir)
    _equal_state(pipe.detector.model, written["gdino"])
    _equal_state(pipe.sam.model, written["sam"])
    _equal_state(pipe.depth.model, written["depth"])
    assert pipe.detector.tokenizer.vocab["object"] == 4  # our vocab.txt
    diffusion = pipe.inpainter.get_pipeline()  # built on first use
    for name in ("text", "unet", "controlnet", "vae"):
        _equal_state(getattr(diffusion, {"text": "text_encoder"}.get(
            name, name)), written[name])
    assert diffusion.tokenizer.vocab["a</w>"] == 3
    out = capsys.readouterr().out
    assert "WARNING" not in out
    for name in ("gdino", "sam", "depth", "text", "unet", "controlnet",
                 "vae"):
        assert f"loaded {name} from {models_dir}" in out, name


def test_missing_files_give_placeholders_and_a_warning(tmp_path, capsys):
    from inklayer_tpu_torch.build import build_pipeline

    _, cfg = tiny_port_config(tmp_path)
    models_dir = str(tmp_path / "models")
    written = write_models_dir(cfg, models_dir)
    os.remove(os.path.join(models_dir, "sam_vit_h_4b8939.pth"))
    os.remove(os.path.join(models_dir, "stable-diffusion-inpainting", "vae",
                           "diffusion_pytorch_model.safetensors"))
    placeholder = build_pipeline(cfg, device="cpu", dtype=torch.float32,
                                 seed=0)
    capsys.readouterr()
    pipe = build_pipeline(cfg, device="cpu", dtype=torch.float32, seed=0,
                          models_dir=models_dir)
    _equal_state(pipe.sam.model, placeholder.sam.model.state_dict())
    _equal_state(pipe.detector.model, written["gdino"])
    diffusion = pipe.inpainter.get_pipeline()
    _equal_state(diffusion.vae,
                 placeholder.inpainter.get_pipeline().vae.state_dict())
    _equal_state(diffusion.unet, written["unet"])
    out = capsys.readouterr().out
    assert f"WARNING: no sam checkpoint under {models_dir}" in out
    assert f"WARNING: no vae checkpoint under {models_dir}" in out
    assert out.count("WARNING") == 2


def test_main_loads_models_dir_on_the_cpu(tmp_path, capsys):
    from inklayer_tpu_torch.main import main
    from tests.test_self_golden import _sketch
    from tests.test_torch_pipeline import PORT_OUTPUTS

    cfg_path, cfg = tiny_port_config(tmp_path)
    models_dir = str(tmp_path / "models")
    write_models_dir(cfg, models_dir)
    main(["--img", _sketch(tmp_path), "--out_dir", str(tmp_path / "out"),
          "--config", cfg_path, "--device", "cpu", "--models_dir",
          models_dir])
    assert sorted(os.listdir(tmp_path / "out" / "golden_sketch")) == \
        PORT_OUTPUTS
    out = capsys.readouterr().out
    assert f"loaded sam from {models_dir}" in out and "WARNING" not in out
