"""Port parity: Depth-Anything-V2 on the TINY config of tests/test_depth.py
(DINOv2 + DPT through the parameter bridge) and the resampling it uses,
against the JAX package on the CPU.

Tolerances: the resize ops 1e-5 absolute on inputs in [0, 1] (same
float32 weight matrices, a different summation order); the model 1e-4
relative (L2) in fp32; the quantized depth map within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inklayer_tpu.io.weights import DEPTH_RULES
from inklayer_tpu.models.depth import DepthAnythingV2 as JaxDepth
from inklayer_tpu.models.depth import DepthEstimator as JaxEstimator
from inklayer_tpu.ops import image as J
from inklayer_tpu_torch.models.depth import (DepthAnythingV2, DepthEstimator,
                                             depth_bucket)
from inklayer_tpu_torch.models.depth.dpt import quantize_depth
from inklayer_tpu_torch.ops import image as T
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from tests.test_depth import TINY
from tests.test_torch_sam import random_jax_params


def depth_pair(cfg=TINY, seed: int = 2, std: float = 0.2):
    """(JAX DepthAnythingV2, its params, the bridged torch model)."""
    jm = JaxDepth(cfg)
    args = (jnp.zeros((1, cfg.input_size, cfg.input_size, 3)),)
    params = random_jax_params(jm, args, seed, std)
    tm = DepthAnythingV2(cfg)
    tm.load_state_dict(jax_to_torch_state_dict(flatten_tree(params["params"]),
                                               DEPTH_RULES), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return depth_pair()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("shape,out", [((75, 60, 3), (56, 70)),
                                       ((20, 30, 3), (41, 33)),
                                       ((37, 37, 8), (40, 50)),
                                       ((750, 750, 3), (518, 518))])
def test_bicubic_antialias_resize_matches_jax(rng, shape, out):
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(J.resize(jnp.asarray(x), out, "bicubic",
                               antialias=True))
    got = T.resize(torch.from_numpy(x), out, "bicubic").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,out", [((1, 7, 9, 4), (28, 36)),
                                       ((2, 37, 37, 3), (750, 750)),
                                       ((1, 5, 6, 2), (5, 6))])
def test_align_corners_resize_matches_jax(rng, shape, out):
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(J.resize_align_corners(jnp.asarray(x), out))
    got = T.resize_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 out).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bridged_depth_params_load_strict(pair):
    _, params, tm = pair
    flat = flatten_tree(params["params"])
    assert sum(v.size for v in flat.values()) == sum(
        p.numel() for p in tm.state_dict().values())


def test_full_vitb_tree_maps_every_key():
    """Every param of the full ViT-B tree has a checkpoint key in the port's
    module with the shape the bridge produces (shapes from
    jax.eval_shape; no arrays)."""
    from inklayer_tpu.config import DepthConfig as JaxDepthConfig
    from inklayer_tpu_torch.config import DepthConfig

    jm = JaxDepth(JaxDepthConfig())
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 518, 518, 3))),
                            jax.random.key(0))
    zeros = flatten_tree(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
    assert len(zeros) > 150
    got = jax_to_torch_state_dict(zeros, DEPTH_RULES)
    want = DepthAnythingV2(DepthConfig()).state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.shape == want[key].shape, key


@pytest.mark.parametrize("hw", [(56, 56), (56, 70)])
def test_tiny_depth_model_matches_jax(pair, rng, hw):
    """(56, 70) interpolates the position embedding (bicubic)."""
    jm, params, tm = pair
    x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, *hw)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-4


def test_depth_estimator_and_quantized_map_match_jax(pair, rng):
    _, params, tm = pair
    image = (rng.random((100, 130, 3)) * 255).astype(np.uint8)
    want = np.asarray(JaxEstimator(params, TINY).infer_image(image))
    got = DepthEstimator(tm).infer_image_device(torch.from_numpy(image))
    assert got.shape == (100, 130)
    assert _rel(got.numpy(), want) <= 1e-4
    from inklayer_tpu.pipeline.runner import _quantize_depth

    want_u8 = np.asarray(_quantize_depth(jnp.asarray(want)))
    got_u8 = quantize_depth(got).numpy()
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("hw", [(750, 750), (480, 640), (1333, 800)])
def test_depth_bucket_matches_jax(hw):
    from inklayer_tpu.config import DepthConfig as JaxDepthConfig
    from inklayer_tpu.models.depth import depth_bucket as jax_bucket
    from inklayer_tpu_torch.config import DepthConfig

    assert depth_bucket(*hw, DepthConfig()) == jax_bucket(*hw,
                                                          JaxDepthConfig())


# ---------------------------------------------------------------------------
# device constants, the eager path's choice, capture-time launch counting
# ---------------------------------------------------------------------------


def _old_align_corners_matrix(n_in, n_out):
    """The matrix resize_align_corners built per call before the cache."""
    s = (n_out - 1) / max(n_in - 1, 1) if n_out > 1 else 1.0
    return T.weight_matrix(n_in, n_out, np.float32(s),
                           np.float32(0.5 - 0.5 * s), antialias=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_in,n_out", [(750, 518), (37, 57), (5, 5),
                                        (518, 750), (1, 9)])
def test_device_constants_equal_the_host_matrices(n_in, n_out, dtype):
    cpu = torch.device("cpu")
    got = T.on_device(T.resize_matrix, (n_in, n_out, True, "bicubic"), cpu,
                      dtype)
    want = torch.from_numpy(T.resize_matrix(n_in, n_out, True, "bicubic"))
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))
    got = T.on_device(T.weight_matrix, T.align_corners_args(n_in, n_out),
                      cpu, dtype)
    want = torch.from_numpy(_old_align_corners_matrix(n_in, n_out))
    assert got.dtype == dtype and torch.equal(got, want.to(dtype))


def test_depth_normalisation_constants_equal_the_old_uploads():
    from inklayer_tpu_torch.models.depth.dpt import DEPTH_MEAN, DEPTH_STD

    for values in (DEPTH_MEAN, DEPTH_STD):
        got = T.device_vector(values, torch.device("cpu"))
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.tensor(values))


@pytest.mark.parametrize("shape,out", [((75, 60, 3), (56, 70)),
                                       ((37, 37, 8), (40, 50))])
def test_cached_resizes_equal_the_per_call_uploads(rng, shape, out):
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    h, w = shape[:2]
    wh = torch.from_numpy(T.resize_matrix(h, out[0], True, "bicubic"))
    ww = torch.from_numpy(T.resize_matrix(w, out[1], True, "bicubic"))
    y = torch.einsum("oh,hwc->owc", wh, x.reshape(h, w, -1))
    want = torch.einsum("pw,owc->opc", ww, y).reshape(*out, *shape[2:])
    for _ in range(2):
        assert torch.equal(T.resize(x, out, "bicubic"), want)
    xc = x.permute(2, 0, 1)
    mh = torch.from_numpy(_old_align_corners_matrix(h, out[0]))
    mw = torch.from_numpy(_old_align_corners_matrix(w, out[1]))
    want = torch.matmul(torch.matmul(mh, xc), mw.T)
    for _ in range(2):
        assert torch.equal(T.resize_align_corners(xc, out), want)


def test_a_second_lookup_uploads_nothing(monkeypatch):
    cpu = torch.device("cpu")
    args = (97, 31, True, "bicubic")  # a key no other test uses
    made = []

    def counted(*a):
        made.append(a)
        return T.resize_matrix(*a)

    first = T.on_device(counted, args, cpu, torch.float32)
    assert T.on_device(counted, args, cpu, torch.float32) is first
    assert made == [args]
    # held constants answer first, and a holding scope collects what it
    # reads; the cache is bounded
    held = {}
    with T.holding(held):
        assert T.on_device(counted, args, cpu, torch.float32) is first
    assert list(held.values()) == [first]
    for n in range(T.DEVICE_ENTRIES):
        T.on_device(T.resize_matrix, (200 + n, 7, True, "bilinear"), cpu,
                    torch.float32)
    assert made == [args]
    with T.holding(held):
        assert T.on_device(counted, args, cpu, torch.float32) is first
    assert made == [args]
    again = T.on_device(counted, args, cpu, torch.float32)
    assert made == [args, args] and torch.equal(again, first)


def test_constants_made_under_inference_mode_can_be_saved_for_backward():
    with torch.inference_mode():
        m = T.on_device(T.resize_matrix, (53, 29, True, "bilinear"),
                        torch.device("cpu"), torch.float32)
    assert not m.is_inference()
    x = torch.ones(53, 4, 1, requires_grad=True)
    T.resize(x, (29, 4)).sum().backward()
    assert x.grad is not None


def _depth_counts(est, image, calls=3):
    """The estimator's maps and each call's ``depth`` span ``graphed``."""
    from torch.profiler import ProfilerActivity, profile

    from inklayer_tpu_torch import spans

    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        maps = [est.infer_image_device(image) for _ in range(calls)]
    graphed = [r.counts.get("graphed") for r in spans.take()
               if r.name == "depth"]
    return maps, graphed


def _direct(model, image, cfg=TINY):
    """The estimator's map computed step by step, eagerly."""
    from inklayer_tpu_torch.models.depth.dpt import DEPTH_MEAN, DEPTH_STD

    h, w = image.shape[:2]
    x = (image.float() / 255.0 - torch.tensor(DEPTH_MEAN)) \
        / torch.tensor(DEPTH_STD)
    x = T.resize(x, depth_bucket(h, w, cfg), "bicubic")
    with torch.no_grad():
        return T.resize_align_corners(model(x[None])[0], (h, w))


def test_the_cpu_path_stays_eager_and_unchanged(pair, rng):
    _, _, tm = pair
    image = torch.from_numpy((rng.random((100, 130, 3)) * 255).astype(
        np.uint8))
    est = DepthEstimator(tm)
    assert est.replayable()
    maps, graphed = _depth_counts(est, image)
    assert graphed == [0, 0, 0]
    want = _direct(tm, image)
    assert all(torch.equal(m, want) for m in maps)
    assert not est._graphs


def test_hooks_keep_the_forward_eager(pair):
    _, _, tm = pair
    est = DepthEstimator(tm)
    handle = tm.depth_head.register_forward_pre_hook(lambda *a: None)
    try:
        assert not est.replayable()
    finally:
        handle.remove()
    assert est.replayable()
    handle = torch.nn.modules.module.register_module_forward_hook(
        lambda *a: None)
    try:
        assert not est.replayable()
    finally:
        handle.remove()
    assert est.replayable()


def test_a_tp_sharded_model_stays_eager_and_unchanged(rng, tmp_path):
    """A one-rank tp group (gloo, file rendezvous): every block sharded,
    the estimator not replayable, its maps the sharded model's own."""
    import torch.distributed as dist

    from inklayer_tpu_torch.parallel.tp import TPGroup

    image = torch.from_numpy((rng.random((60, 80, 3)) * 255).astype(
        np.uint8))
    _, _, tm = depth_pair()
    est = DepthEstimator(tm)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        tp = TPGroup(dist.group.WORLD, 0, 1)
        for blk in tm.pretrained.blocks:
            blk.shard_tp(tp)
        assert all(blk.tp is tp for blk in tm.pretrained.blocks)
        assert not est.replayable()
        maps, graphed = _depth_counts(est, image)
        assert graphed == [0, 0, 0]
        want = _direct(tm, image)
        assert all(torch.equal(m, want) for m in maps)
    finally:
        dist.destroy_process_group()


def test_an_mlp_sharded_alone_keeps_the_forward_eager(pair):
    """A tp plan that splits a block's MLP but not its heads leaves
    ``Block.tp`` None; the MLP's collectives still rule out a replay."""
    _, _, tm = pair
    est = DepthEstimator(tm)
    mlp = tm.pretrained.blocks[0].mlp
    mlp.tp = object()
    try:
        assert not est.replayable()
    finally:
        mlp.tp = None
    assert est.replayable()


def test_capture_counts_launches_apart_and_replays_add_them():
    import threading

    from inklayer_tpu_torch import _kernels

    before = _kernels.launch_counts()
    with _kernels.captured_launches() as counts:
        for _ in range(12):
            _kernels.count_launch("flash_attention", "d64")
        for _ in range(28):
            _kernels.count_launch("layernorm")
        # another thread's launches ran: they count as usual
        other = threading.Thread(
            target=_kernels.count_launch, args=("layernorm",))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        with _kernels.captured_launches() as inner:
            _kernels.count_launch("mlp_gelu")
        assert inner == {"mlp_gelu": 1}
    assert counts == {"flash_attention": 12, "flash_attention/d64": 12,
                      "layernorm": 28}
    after = _kernels.launch_counts()
    assert after["layernorm"] == before["layernorm"] + 1
    assert {k: v for k, v in after.items() if k != "layernorm"} == \
        {k: v for k, v in before.items() if k != "layernorm"}
    for k in range(1, 4):
        _kernels.add_launches(counts)
        now = _kernels.launch_counts()
        for key, n in counts.items():
            assert now[key] == after.get(key, 0) + k * n, key
    _kernels.add_launches({"flash_attention/d999": 2})
    assert _kernels.launch_counts()["flash_attention/d999"] == 2
    del _kernels.LAUNCHES["flash_attention/d999"]
