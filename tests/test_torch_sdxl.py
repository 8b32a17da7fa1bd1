"""Port parity: the SDXL inpainting backend
(inklayer_tpu_torch.models.diffusion.sdxl) against the JAX package on the
CPU, and the mmdetection alt route of the runner.

The tiny config is tests/test_diffusion.py's ``test_sdxl_tiny_end_to_end``
with transformer depths (0, 2, 2) (``_sdxl_unet_rules`` bridges depth >= 2
only; the full config has no depth-1 level): blocks (8, 16, 16), linear
projections, head_dim 8, text_time embedding 4 (proj 16 + 24), context 24
= CLIP-L 8 + bigG 16, VAE (8, 8, 8, 8), 64^2 images, 8^2 latents.  Params
go through ``jax_to_torch_state_dict`` with ``_sdxl_unet_rules((0, 2, 2))``,
``SDXL_TEXT_RULES`` and ``VAE_RULES``, loaded with ``strict=True``.

Tolerances: fp32 on both sides, relative L2 <= 1e-4 (``REL`` of
tests/test_torch_diffusion.py; float32 summation order); the uint8 images
of ``generate`` within 1 grey level (a float output that straddles an
integer truncates to neighbouring levels).  Checkpoint files load exactly
(both readers see the same stored values).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from inklayer_tpu.io import weights as W
from inklayer_tpu.models.diffusion import UNet2DCondition as JaxUNet
from inklayer_tpu.models.diffusion.clip_text import \
    CLIPTokenizer as JaxTokenizer
from inklayer_tpu.models.diffusion.pipeline import _solver_tables
from inklayer_tpu.models.diffusion.scheduler import \
    DPMSolverMultistepScheduler as JaxSched
from inklayer_tpu.models.diffusion.sdxl import CLIPTextTower as JaxTower
from inklayer_tpu.models.diffusion.sdxl import SDXLConfig as JaxSDXLConfig
from inklayer_tpu.models.diffusion.sdxl import \
    SDXLInpaintPipeline as JaxSDXLPipeline
from inklayer_tpu.models.diffusion.sdxl import \
    build_sdxl_models as jax_build_sdxl
from inklayer_tpu_torch.io import weights as PW
from inklayer_tpu_torch.models.diffusion import AutoencoderKL, UNet2DCondition
from inklayer_tpu_torch.models.diffusion.sdxl import (CLIPTextTower,
                                                      SDXLConfig,
                                                      SDXLInpaintPipeline,
                                                      build_sdxl_models)
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_torch_diffusion import REL, _bridge, _nchw, _nhwc, _rel

DEPTHS = (0, 2, 2)
UNET_RULES = W._sdxl_unet_rules(DEPTHS)
TINY_KW = dict(resolution=64, block_channels=(8, 16, 16),
               transformer_layers=DEPTHS, context_dim=24, pooled_dim=16,
               vae_channels=(8, 8, 8, 8), text_l_hidden=8, text_g_hidden=16,
               text_l_layers=2, text_g_layers=2)
TINY_UNET = dict(in_channels=9, block_channels=(8, 16, 16),
                 transformer_layers=DEPTHS, linear_proj=True, head_dim=8,
                 context_dim=24, addition_embed_dim=4,
                 addition_proj_dim=16 + 6 * 4)


def _unet_args(b=2):
    return (jnp.zeros((b, 8, 8, 9)), jnp.zeros((b,), jnp.int32),
            jnp.zeros((b, 7, 24)), None, None, False, jnp.zeros((b, 16)),
            jnp.zeros((b, 6)))


def _tower_pair(hidden, layers, pooled, act, seed):
    heads = max(1, hidden // 8)
    jm = JaxTower(hidden=hidden, layers=layers, heads=heads,
                  pooled_proj=pooled, act=act)
    tm = CLIPTextTower(hidden=hidden, layers=layers, heads=heads,
                       pooled_proj=pooled, act=act)
    params, tm = _bridge(jm, (jnp.zeros((2, 77), jnp.int32),), tm,
                         W.SDXL_TEXT_RULES, seed, 0.05)
    return jm, params, tm


# 8 and 16 channels are one channel per GroupNorm group, which removes the
# time embedding's per-channel shift: the wide case (2 channels per group)
# is the one where the text_time input can move the output
WIDE_UNET = dict(TINY_UNET, block_channels=(64, 64, 64), head_dim=32)


@pytest.fixture(scope="module")
def unet_pairs():
    out = {}
    for i, (name, kw) in enumerate((("tiny", TINY_UNET),
                                    ("wide", WIDE_UNET))):
        jm = JaxUNet(**kw)
        params, tm = _bridge(jm, _unet_args(), UNet2DCondition(**kw),
                             UNET_RULES, 20 + i)
        out[name] = (jm, params, tm)
    return out


def _prompt_ids():
    cfg = SDXLConfig()
    tok = JaxTokenizer()
    return np.concatenate([tok.encode(cfg.negative_prompt),
                           tok.encode(cfg.prompt)])


# ---------------------------------------------------------------------------
# UNet and text towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which, text_time", [("tiny", True),
                                               ("tiny", False),
                                               ("wide", True)])
def test_sdxl_unet_matches_jax(unet_pairs, rng, which, text_time):
    jm, params, tm = unet_pairs[which]
    x = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    ts = np.asarray([999, 500], np.int32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    tids = np.asarray([[64, 64, 0, 0, 64, 64], [512, 384, 16, 8, 64, 48]],
                      np.float32)
    kw_j = dict(pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids)) \
        if text_time else {}
    kw_t = dict(pooled_text=torch.from_numpy(pooled),
                time_ids=torch.from_numpy(tids)) if text_time else {}
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                    **kw_j)
    with torch.no_grad():
        got = tm(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                 **kw_t)
    assert got.shape == (2, 4, 8, 8)
    assert _rel(_nhwc(got), want) <= REL
    if which == "wide":  # the text_time input moves the output
        with torch.no_grad():
            plain = tm(_nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx))
        assert _rel(_nhwc(plain), want) > 1e-2


def test_sdxl_unet_layout():
    """Three levels, the last with attention and no downsampler; the mid
    block as deep as the deepest level; the up levels mirrored, three
    transformers each where the level has them."""
    tm = UNet2DCondition(**TINY_UNET)
    assert not hasattr(tm.down_blocks[0], "attentions")
    assert [len(b.attentions[0].transformer_blocks)
            for b in tm.down_blocks[1:]] == [2, 2]
    assert not hasattr(tm.down_blocks[2], "downsamplers")
    assert len(tm.mid_block.attentions[0].transformer_blocks) == 2
    assert [len(getattr(b, "attentions", [])) for b in tm.up_blocks] \
        == [3, 3, 0]
    assert isinstance(tm.down_blocks[1].attentions[0].proj_in,
                      torch.nn.Linear)


@pytest.mark.parametrize("role", ["clip_l", "bigg"])
def test_text_tower_matches_jax(role):
    hidden, pooled, act = (8, 0, "quick_gelu") if role == "clip_l" \
        else (16, 12, "gelu")
    jm, params, tm = _tower_pair(hidden, 2, pooled, act, 30)
    ids = _prompt_ids()
    pen_j, pool_j = jm.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        pen_t, pool_t = tm(torch.from_numpy(ids).long())
    assert pen_t.shape == (2, 77, hidden)
    assert _rel(pen_t.numpy(), pen_j) <= REL
    if pooled:
        assert pool_t.shape == (2, pooled)
        assert _rel(pool_t.numpy(), pool_j) <= REL
    else:
        assert pool_t is None and pool_j is None


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pipelines(strength, num_steps):
    """(JAX pipeline, port pipeline) of the tiny config sharing params."""
    jcfg = JaxSDXLConfig(num_steps=num_steps, strength=strength, **TINY_KW)
    _, vae_j, tl_j, tg_j = jax_build_sdxl(jcfg)
    unet_j = JaxUNet(**TINY_UNET)
    specs = {
        "unet": (unet_j, _unet_args(), UNet2DCondition(**TINY_UNET),
                 UNET_RULES, 0.2),
        "vae": (vae_j, (jnp.zeros((1, 64, 64, 3)),),
                AutoencoderKL((8, 8, 8, 8), 4), W.VAE_RULES, 0.2),
        "text_l": (tl_j, (jnp.zeros((2, 77), jnp.int32),),
                   CLIPTextTower(hidden=8, layers=2, heads=1),
                   W.SDXL_TEXT_RULES, 0.05),
        "text_g": (tg_j, (jnp.zeros((2, 77), jnp.int32),),
                   CLIPTextTower(hidden=16, layers=2, heads=1, pooled_proj=16,
                                 act="gelu"), W.SDXL_TEXT_RULES, 0.05),
    }
    params, models = {}, {}
    for i, (name, (jm, args, tm, rules, std)) in enumerate(specs.items()):
        params[name], models[name] = _bridge(jm, args, tm, rules, 40 + i, std)
    jpipe = JaxSDXLPipeline(params, jcfg)
    jpipe.unet = unet_j  # the tiny head_dim, before the first trace
    pipe = SDXLInpaintPipeline(
        models, SDXLConfig(num_steps=num_steps, strength=strength, **TINY_KW))
    return jpipe, pipe


def _image_and_mask(rng):
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[10:40, 20:50] = 255
    return img, mask


@pytest.mark.parametrize("strength, t_start", [(0.9, 0), (0.5, 2)])
def test_sample_matches_jax(rng, strength, t_start):
    """``sample`` against JAX ``_sample`` on the same noise; t_start 2
    starts from the noised image latents with ``x0_prev`` 0."""
    steps = 4
    jpipe, pipe = _pipelines(strength, steps)
    cfg = pipe.cfg
    assert max(0, int(round(steps * (1 - cfg.strength)))) == t_start
    ctx_j, pooled_j = jpipe._encode_prompt(cfg.prompt, cfg.negative_prompt)
    ctx_t, pooled_t = pipe.encode_prompt(cfg.prompt, cfg.negative_prompt)
    assert ctx_t.shape == (2, 77, 24) and pooled_t.shape == (2, 16)
    assert _rel(ctx_t.numpy(), ctx_j) <= REL
    assert _rel(pooled_t.numpy(), pooled_j) <= REL
    img, mask = _image_and_mask(rng)
    img01 = img.astype(np.float32) / 255.0
    mask01 = mask.astype(np.float32)[..., None] / 255.0
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    tables = _solver_tables(JaxSched(), steps)
    tids = np.asarray([[64, 64, 0, 0, 64, 64]] * 2, np.float32)
    want = jpipe._sample(
        jpipe.params, ctx_j, pooled_j, jnp.asarray(img01),
        jnp.asarray(mask01), jnp.asarray(noise),
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(tids),
        steps=steps, guidance=7.5, t_start=t_start)
    got = pipe.sample(ctx_t, pooled_t, _nchw(img01[None]),
                      _nchw(mask01[None]), _nchw(noise), tables,
                      torch.from_numpy(tids), steps, 7.5, t_start)
    assert got.shape == (3, 64, 64)
    assert pipe.stage_times["steps"] == steps - t_start
    assert _rel(got.permute(1, 2, 0).numpy(), want) <= REL


def test_generate_matches_jax(rng):
    jpipe, pipe = _pipelines(0.99, 3)
    img, mask = _image_and_mask(rng)
    image = Image.fromarray(img).resize((80, 72))
    mask_im = Image.fromarray(mask).resize((80, 72))
    want = np.asarray(jpipe.generate(image, mask_im))
    # the JAX package's draw, handed to the port
    noise = np.asarray(jax.random.normal(jax.random.key(pipe.cfg.seed),
                                         (1, 8, 8, 4)))
    got = pipe.generate(image, mask_im, noise=_nchw(noise))
    assert got.size == image.size
    got = np.asarray(got)
    assert got.shape == want.shape == (72, 80, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert set(pipe.stage_times) == {"encode", "loop", "decode", "steps"}
    # noise=None draws from the seeded CPU generator: the same on a rerun
    a = np.asarray(pipe.generate(image, mask_im))
    b = np.asarray(pipe.generate(image, mask_im))
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints in the published layout
# ---------------------------------------------------------------------------


def _write(tensors, path, dtype):
    PW.save_safetensors({k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in tensors.items()}, path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16],
                         ids=["F32", "F16"])
def test_sdxl_checkpoints_load_in_both_packages(tmp_path, dtype):
    """The tiny UNet and both towers, written with the diffusers /
    transformers keys (the towers with ``position_ids``, which both
    loaders drop), load strictly into the port and give the JAX loader's
    params exactly."""
    unet_j = JaxUNet(**TINY_UNET)
    unet_params, unet_t = _bridge(unet_j, _unet_args(1),
                                  UNet2DCondition(**TINY_UNET), UNET_RULES, 50)
    tl_j, tl_params, tl_t = _tower_pair(8, 2, 0, "quick_gelu", 51)
    tg_j, tg_params, tg_t = _tower_pair(16, 2, 12, "gelu", 52)
    pos = {"text_model.embeddings.position_ids": torch.arange(77)[None]}
    cases = {
        "unet": (unet_t, unet_j, _unet_args(1), UNET_RULES,
                 lambda p, m, a: W._load_component(p, UNET_RULES, m, a),
                 PW.load_sdxl_unet, {}),
        "text_l": (tl_t, tl_j, (jnp.zeros((1, 77), jnp.int32),),
                   W.SDXL_TEXT_RULES, W.load_clip_text_params,
                   lambda m, p: PW.load_checkpoint(m, p, PW.DIFFUSION_IGNORE),
                   pos),
        "text_g": (tg_t, tg_j, (jnp.zeros((1, 77), jnp.int32),),
                   W.SDXL_TEXT_RULES, W.load_sdxl_text_params,
                   PW.load_sdxl_text, pos),
    }
    for name, (tm, jm, args, rules, jax_load, port_load, extra) in \
            cases.items():
        path = str(tmp_path / f"{name}.safetensors")
        _write({**tm.state_dict(), **extra}, path, dtype)
        fresh = type(tm)(**_ctor_kwargs(name))
        port_load(fresh, path)
        want = {k: v.to(dtype).float() for k, v in tm.state_dict().items()}
        got = fresh.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
        via_jax = jax_to_torch_state_dict(
            flatten_tree(jax_load(path, jm, args)["params"]), rules)
        assert set(via_jax) == set(got), name
        for k in got:
            assert torch.equal(via_jax[k], got[k]), (name, k)


def _ctor_kwargs(name):
    return {"unet": TINY_UNET,
            "text_l": dict(hidden=8, layers=2, heads=1),
            "text_g": dict(hidden=16, layers=2, heads=2, pooled_proj=12,
                           act="gelu")}[name]


def test_bigg_file_without_text_projection_raises(tmp_path):
    tower = CLIPTextTower(hidden=16, layers=1, heads=2, pooled_proj=12,
                          act="gelu")
    sd = {k: v for k, v in tower.state_dict().items()
          if k != "text_projection.weight"}
    path = str(tmp_path / "text_encoder_2.safetensors")
    PW.save_safetensors(sd, path)
    with pytest.raises(KeyError, match="text_projection"):
        PW.load_sdxl_text(CLIPTextTower(hidden=16, layers=1, heads=2,
                                        pooled_proj=12, act="gelu"), path)


def test_build_sdxl_models_placeholders_and_files(tmp_path):
    """``build.build_sdxl_models`` on the CPU: seeded placeholders are the
    same on a rebuild, differ between components, and a component with a
    file loads it instead (written in fp16, so the values round)."""
    from inklayer_tpu_torch.build import build_sdxl_models as build

    cfg = SDXLConfig(**TINY_KW)
    a = build(cfg, "cpu", torch.float32, seed=3)
    b = build(cfg, "cpu", torch.float32, seed=3)
    for name in a:
        sd_a, sd_b = a[name].state_dict(), b[name].state_dict()
        assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    emb = lambda m: m.text_model.embeddings.token_embedding.weight[:, :8]
    assert not torch.equal(emb(a["text_l"]), emb(a["text_g"]))
    paths = {name: str(tmp_path / f"{name}.safetensors")
             for name in ("unet", "text_g")}
    for name, path in paths.items():
        PW.save_safetensors({k: v.half() for k, v in a[name].state_dict()
                             .items()}, path)
    c = build(cfg, "cpu", torch.float32, seed=4, paths=paths)
    for name in paths:
        for k, v in a[name].state_dict().items():
            assert torch.equal(c[name].state_dict()[k], v.half().float()), k
    assert not torch.equal(emb(c["text_l"]), emb(a["text_l"]))


# ---------------------------------------------------------------------------
# full width, no weights
# ---------------------------------------------------------------------------


def _zero_view(shape):
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape,
                                           (0,) * len(shape))


@pytest.mark.parametrize("which", ["unet", "text_g"])
def test_full_width_keys_map_to_the_jax_tree(which):
    """The full-width SDXL UNet and bigG tower, built on the meta device:
    every key maps through the JAX rules to a path of the JAX init's tree
    with the transformed shape, every JAX path is hit once, and the
    parameter counts are equal."""
    cfg = SDXLConfig()
    with torch.device("meta"):
        unet, _vae, _tl, text_g = build_sdxl_models(cfg)
    jcfg = JaxSDXLConfig()
    jax_unet, _, _, jax_text_g = jax_build_sdxl(jcfg)
    if which == "unet":
        model, rules = unet, W.SDXL_UNET_RULES
        jm, args = jax_unet, (jnp.zeros((1, 16, 16, 9)),
                              jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1, 77, 2048)), None, None, False,
                              jnp.zeros((1, 1280)), jnp.zeros((1, 6)))
    else:
        model, rules = text_g, W.SDXL_TEXT_RULES
        jm, args = jax_text_g, (jnp.zeros((1, 77), jnp.int32),)
    shapes = jax.eval_shape(lambda k: jm.init(k, *args), jax.random.key(0))
    want = {"/".join(str(getattr(p, "key", p)) for p in path[1:]):
            tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    hits = {}
    for key, t in model.state_dict().items():
        for rule in rules:
            hit = rule.apply(key)
            if hit is not None:
                fpath, transform = hit
                break
        else:
            raise AssertionError(f"no rule for {key}")
        assert fpath in want, (key, fpath)
        assert tuple(transform(_zero_view(tuple(t.shape))).shape) \
            == want[fpath], key
        hits[fpath] = hits.get(fpath, 0) + 1
    assert hits == {p: 1 for p in want}
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == sum(int(np.prod(s)) for s in want.values())
    if which == "unet":
        assert n_port == 2_567_478_084  # the published SDXL-inpaint UNet


# ---------------------------------------------------------------------------
# the runner's mmdetection alt route
# ---------------------------------------------------------------------------

ALT = {"bboxes": [[0.05, 0.05, 0.6, 0.55], [0.4, 0.3, 0.95, 0.9],
                  [0.1, 0.5, 0.5, 0.95], [0.3, 0.1, 0.9, 0.5]],
       "scores": [0.9, 0.8, 0.7, 0.6]}


@pytest.fixture(scope="module")
def mmdet_runs(tmp_path_factory):
    """The JAX and port runs of one sketch (and the port's run_dir) with
    ``mmdet_out/alt.json`` written into each output directory right after
    it is prepared (the JAX runner globs after prepare_out_dir, which
    empties a non-empty directory), and the port's run without it."""
    from inklayer_tpu.io import outputs as jax_out
    from inklayer_tpu_torch.io import outputs as port_out
    from tests.test_self_golden import _sketch
    from tests.test_torch_pipeline import pipeline_pair

    _cfg, jax_pipe, port = pipeline_pair()
    tmp = tmp_path_factory.mktemp("mmdet")
    sketch = _sketch(tmp)
    plain = port.run(sketch, str(tmp / "plain"))
    mp = pytest.MonkeyPatch()

    def with_alt(prepare):
        def wrapped(base, name):
            out_dir = prepare(base, name)
            os.makedirs(os.path.join(out_dir, "mmdet_out"))
            with open(os.path.join(out_dir, "mmdet_out", "alt.json"),
                      "w") as f:
                json.dump(ALT, f)
            return out_dir
        return wrapped

    mp.setattr(jax_out, "prepare_out_dir", with_alt(jax_out.prepare_out_dir))
    mp.setattr(port_out, "prepare_out_dir",
               with_alt(port_out.prepare_out_dir))
    try:
        runs = (jax_pipe.run(sketch, str(tmp / "jax")),
                port.run(sketch, str(tmp / "torch")),
                port.run_dir([sketch], str(tmp / "torch_dir"))[0])
    finally:
        mp.undo()
    return runs + (plain,)


def _final_json(out_dir):
    with open(os.path.join(out_dir, "bboxes_final.json")) as f:
        return json.load(f)


def _final_masks(out_dir):
    d = os.path.join(out_dir, "masks_final")
    names = sorted(os.listdir(d), key=lambda n: int(n[5:-4]))
    return names, [np.asarray(Image.open(os.path.join(d, n)).convert("L"))
                   > 127 for n in names]


@pytest.mark.parametrize("entry", ["run", "run_dir"])
def test_mmdet_boxes_replace_gdino_as_in_jax(mmdet_runs, entry):
    jax_dir, run_dir_out, sweep_dir, plain_dir = mmdet_runs
    port_dir = run_dir_out if entry == "run" else sweep_dir
    want, got = _final_json(jax_dir), _final_json(port_dir)
    assert got["kept_indices"] == want["kept_indices"]
    assert 0 < len(got["kept_indices"]) <= len(ALT["bboxes"])
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-9)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-9)
    # the kept boxes are the alt route's, not GroundingDINO's
    for i, box in zip(got["kept_indices"], got["bboxes"]):
        np.testing.assert_allclose(box, ALT["bboxes"][i], atol=1e-9)
    j_names, j_masks = _final_masks(jax_dir)
    t_names, t_masks = _final_masks(port_dir)
    assert t_names == j_names and t_names
    for a, b in zip(t_masks, j_masks):
        union = (a | b).sum()
        assert union == 0 or (a & b).sum() / union >= 0.99
    assert _final_json(plain_dir) != got


def test_placeholder_draw_equals_randn_times_std():
    """``init_placeholder_params`` fills fp32 CPU tensors of 16 values or
    more in place; every value is still that of one ``randn * std`` per
    tensor in registration order (what every seeded placeholder build of
    the port relies on), for tensors below and above 16 values."""
    from inklayer_tpu_torch.build import (PLACEHOLDER_STD,
                                          init_placeholder_params)

    model = CLIPTextTower(vocab_size=40, hidden=4, layers=1, heads=1,
                          max_len=3, pooled_proj=2, act="gelu")
    sizes = {t.numel() for t in model.parameters()}
    assert min(sizes) < 16 <= max(sizes)
    init_placeholder_params(model, 7)
    gen = torch.Generator().manual_seed(7)
    for name, t in model.named_parameters():
        want = torch.randn(t.shape, generator=gen) * PLACEHOLDER_STD
        if "norm" not in name:  # LayerNorms: scale 1, shift 0
            assert torch.equal(t.detach(), want), name
