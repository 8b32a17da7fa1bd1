"""Port parity: the diffusion models of the inpainting stage
(inklayer_tpu_torch.models.diffusion) against the JAX package on the CPU,
at the TINY config of tests/test_diffusion.py (blocks (8, 16, 16, 16),
context 16, 64^2 images, 8^2 latents): the DPM-Solver++ schedule and
tables, the CLIP tokenizer's fallback ids, and the CLIP text encoder,
UNet (with ControlNet residuals), ControlNet and VAE with the JAX params
moved across by ``jax_to_torch_state_dict`` and the four rule tables,
loaded with ``strict=True``.

Tolerances: the solver tables exactly (both float64 -> float32); the
models in fp32, relative L2 error <= 1e-4 (float32 summation order; the
UNet and VAE stack some 40 convolutions; the readings are 1e-7 to 3e-6).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.weights import (CLIP_TEXT_RULES, CONTROLNET_RULES,
                                     UNET_RULES, VAE_RULES, Rule,
                                     _sdxl_unet_rules)
from inklayer_tpu.models.diffusion import (AutoencoderKL as JaxVAE,
                                           CLIPTextEncoder as JaxCLIP,
                                           CLIPTokenizer as JaxTokenizer,
                                           ControlNet as JaxControlNet,
                                           DPMSolverMultistepScheduler as JaxSched,
                                           UNet2DCondition as JaxUNet)
from inklayer_tpu.models.diffusion.pipeline import _solver_tables
from inklayer_tpu_torch.config import DiffusionConfig
from inklayer_tpu_torch.models.diffusion import (AutoencoderKL,
                                                 CLIPTextEncoder,
                                                 CLIPTokenizer, ControlNet,
                                                 DPMSolverMultistepScheduler,
                                                 UNet2DCondition,
                                                 solver_tables)
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_diffusion import TINY
from tests.test_torch_sam import random_jax_params

REL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nchw(a):
    return torch.from_numpy(np.array(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2), order="C"))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bridge(jm, args, tm, rules, seed, std=0.2):
    params = random_jax_params(jm, args, seed, std)
    tm.load_state_dict(jax_to_torch_state_dict(flatten_tree(params["params"]),
                                               rules), strict=True)
    return params, tm.eval()


def diffusion_pair(cfg=TINY, seed: int = 10):
    """{name: (JAX module, its params, the bridged torch module)} for the
    text encoder, UNet, ControlNet and VAE of ``cfg``."""
    s8, c, t = cfg.resolution // 8, cfg.cross_attention_dim, cfg.text_maxlen
    heads = max(1, c // 64)
    specs = {
        "text": (JaxCLIP(hidden=c, heads=heads, max_len=t),
                 (jnp.zeros((2, t), jnp.int32),),
                 CLIPTextEncoder(hidden=c, heads=heads, max_len=t),
                 CLIP_TEXT_RULES),
        "unet": (JaxUNet(block_channels=cfg.unet_block_channels,
                         context_dim=c),
                 (jnp.zeros((2, s8, s8, 9)), jnp.zeros((2,), jnp.int32),
                  jnp.zeros((2, t, c))),
                 UNet2DCondition(block_channels=cfg.unet_block_channels,
                                 context_dim=c), UNET_RULES),
        "controlnet": (JaxControlNet(block_channels=cfg.unet_block_channels,
                                     context_dim=c),
                       (jnp.zeros((2, s8, s8, 4)), jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, t, c)),
                        jnp.zeros((2, cfg.resolution, cfg.resolution, 3))),
                       ControlNet(block_channels=cfg.unet_block_channels,
                                  context_dim=c), CONTROLNET_RULES),
        "vae": (JaxVAE(cfg.vae_channels, cfg.latent_channels),
                (jnp.zeros((1, cfg.resolution, cfg.resolution, 3)),),
                AutoencoderKL(cfg.vae_channels, cfg.latent_channels),
                VAE_RULES),
    }
    out = {}
    for i, (name, (jm, args, tm, rules)) in enumerate(specs.items()):
        # the text encoder's embeddings at 0.2 would swamp 12 layers
        params, tm = _bridge(jm, args, tm, rules, seed + i,
                             0.05 if name == "text" else 0.2)
        out[name] = (jm, params, tm)
    return out


@pytest.fixture(scope="module")
def models():
    return diffusion_pair()


# ---------------------------------------------------------------------------
# scheduler and tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [2, 3, 30])
def test_solver_tables_equal_jax(steps):
    want = _solver_tables(JaxSched(), steps)
    got = solver_tables(DPMSolverMultistepScheduler(), steps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_schedule_equals_jax():
    jax_s, port_s = JaxSched(), DPMSolverMultistepScheduler()
    for name in ("alpha_t", "sigma_t", "lambda_t"):
        np.testing.assert_array_equal(getattr(port_s, name),
                                      getattr(jax_s, name))
    np.testing.assert_array_equal(port_s.timesteps(30),
                                  jax_s.set_timesteps(30).timesteps)


@pytest.mark.parametrize("which", ["prompt", "negative_prompt",
                                   "single_layer_negative_prompt"])
@pytest.mark.parametrize("max_len", [77, 16])
def test_tokenizer_fallback_ids_equal_jax(which, max_len):
    text = getattr(DiffusionConfig(), which)
    np.testing.assert_array_equal(CLIPTokenizer().encode(text, max_len),
                                  JaxTokenizer().encode(text, max_len))


def test_tokenizer_with_vocab_files_equal_jax(tmp_path):
    import json

    vocab = {"<|startoftext|>": 1, "<|endoftext|>": 2, "li": 5, "ne</w>": 6,
             "line</w>": 7, "a</w>": 8}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#v\nl i\nn e</w>\nli ne</w>\n")
    args = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    for text in ("a line", "Line lines!", ""):
        np.testing.assert_array_equal(CLIPTokenizer(*args).encode(text, 8),
                                      JaxTokenizer(*args).encode(text, 8))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def test_clip_text_encoder_matches_jax(models):
    jm, params, tm = models["text"]
    ids = np.concatenate([JaxTokenizer().encode(DiffusionConfig().prompt, 16),
                          JaxTokenizer().encode("a b", 16)])
    want = jm.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert _rel(got.numpy(), want) <= REL


def _unet_inputs(rng, b=2):
    s8, c, t = TINY.resolution // 8, TINY.cross_attention_dim, TINY.text_maxlen
    return (rng.standard_normal((b, s8, s8, 9)).astype(np.float32),
            np.asarray([999, 500][:b], np.int32),
            rng.standard_normal((b, t, c)).astype(np.float32))


def test_controlnet_matches_jax(models, rng):
    jm, params, tm = models["controlnet"]
    x, ts, ctx = _unet_inputs(rng)
    cond = rng.uniform(-1, 1, (2, TINY.resolution, TINY.resolution, 3)
                       ).astype(np.float32)
    down_j, mid_j = jm.apply(params, jnp.asarray(x[..., :4]), jnp.asarray(ts),
                             jnp.asarray(ctx), jnp.asarray(cond),
                             conditioning_scale=1.2)
    with torch.no_grad():
        down_t, mid_t = tm(_nchw(x[..., :4]), torch.from_numpy(ts),
                           torch.from_numpy(ctx), _nchw(cond),
                           conditioning_scale=1.2)
    assert len(down_t) == len(down_j) == 12
    for g, w in zip(down_t, down_j):
        assert _rel(_nhwc(g), w) <= REL
    assert _rel(_nhwc(mid_t), mid_j) <= REL


def test_unet_with_controlnet_residuals_matches_jax(models, rng):
    jc, cparams, tc = models["controlnet"]
    ju, uparams, tu = models["unet"]
    x, ts, ctx = _unet_inputs(rng)
    cond = rng.uniform(-1, 1, (2, TINY.resolution, TINY.resolution, 3)
                       ).astype(np.float32)
    down, mid = jc.apply(cparams, jnp.asarray(x[..., :4]), jnp.asarray(ts),
                         jnp.asarray(ctx), jnp.asarray(cond))
    want = ju.apply(uparams, jnp.asarray(x), jnp.asarray(ts),
                    jnp.asarray(ctx), down_residuals=down, mid_residual=mid)
    with torch.no_grad():
        got = tu(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                 down_residuals=[_nchw(d) for d in down],
                 mid_residual=_nchw(mid))
        plain = tu(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    assert got.shape == (2, 4, 8, 8)
    assert _rel(_nhwc(got), want) <= REL
    # the residuals matter: without them the output moves
    assert _rel(_nhwc(plain), want) > 1e-2


def test_vae_encode_decode_match_jax(models, rng):
    jm, params, tm = models["vae"]
    x = rng.uniform(-1, 1, (2, TINY.resolution, TINY.resolution, 3)
                    ).astype(np.float32)
    z_j = jm.apply(params, jnp.asarray(x), method=JaxVAE.encode)
    with torch.no_grad():
        z_t = tm.encode(_nchw(x))
    assert z_t.shape == (2, 4, 8, 8)
    assert _rel(_nhwc(z_t), z_j) <= REL
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(z), method=JaxVAE.decode)
    with torch.no_grad():
        got = tm.decode(_nchw(z))
    assert _rel(_nhwc(got), want) <= REL


def _with_proj(rules, kind):
    """``rules`` with the transformers' proj_in / proj_out as ``kind``
    ("conv": 1x1 convolutions, "linear": linear layers)."""
    return [Rule(r.pattern, r.path, kind)
            if re.search(r"proj_(in|out)\\\.weight$", r.pattern) else r
            for r in rules]


# each SDXL option of the UNet on its own, on the TINY SD1.5 config; the
# rule table that bridges that layout
SDXL_OPTIONS = {
    "transformer_layers": ({"transformer_layers": (2, 2, 2, 0)},
                           _with_proj(_sdxl_unet_rules((2, 2, 2, 0)), "conv")),
    "linear_proj": ({"linear_proj": True}, _with_proj(UNET_RULES, "linear")),
    "head_dim": ({"head_dim": 8}, UNET_RULES),
    "addition_embed_dim": (
        {"addition_embed_dim": 4, "addition_proj_dim": 12 + 6 * 4},
        UNET_RULES + [
            Rule(r"add_embedding\.(linear_[12])\.weight",
                 r"add_embedding/\1/kernel", "linear"),
            Rule(r"add_embedding\.(linear_[12])\.bias",
                 r"add_embedding/\1/bias")]),
}


@pytest.mark.parametrize("option", list(SDXL_OPTIONS))
def test_unet_refuses_the_sdxl_options(option, rng):
    """Named for the refusal it replaces: each SDXL option, alone on the
    SD1.5 layout, builds and matches the JAX UNet."""
    kw, rules = SDXL_OPTIONS[option]
    c = TINY.cross_attention_dim
    jm = JaxUNet(block_channels=TINY.unet_block_channels, context_dim=c,
                 **kw)
    tm = UNet2DCondition(block_channels=TINY.unet_block_channels,
                         context_dim=c, **kw)
    x, ts, ctx = _unet_inputs(rng)
    text_time = "addition_embed_dim" in kw
    pooled = rng.standard_normal((2, 12)).astype(np.float32)
    tids = np.asarray([[768, 768, 0, 0, 768, 768]] * 2, np.float32)
    args = (jnp.zeros((2, 8, 8, 9)), jnp.zeros((2,), jnp.int32),
            jnp.zeros((2, TINY.text_maxlen, c)))
    if text_time:
        args += (None, None, False, jnp.zeros((2, 12)), jnp.zeros((2, 6)))
    params, tm = _bridge(jm, args, tm, rules, 17)
    kw_j = dict(pooled_text=jnp.asarray(pooled),
                time_ids=jnp.asarray(tids)) if text_time else {}
    kw_t = dict(pooled_text=torch.from_numpy(pooled),
                time_ids=torch.from_numpy(tids)) if text_time else {}
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ts),
                    jnp.asarray(ctx), **kw_j)
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                 **kw_t)
    assert got.shape == (2, 4, 8, 8)
    assert _rel(_nhwc(got), want) <= REL
