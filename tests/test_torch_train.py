"""Port parity: fine-tuning on one process — the losses, the DINO set loss
with its greedy matching, ``disable_kernels``, the ``Trainer`` against the
JAX ``Trainer`` (two steps of each recipe from the same params), the
checkpoints and the train CLI.

The JAX recipes' loss functions are the JAX CLI's (``scripts/train.py``)
bodies, copied: the JAX CLI draws its params with ``model.init`` (flax's
RNG, ~25 s eager on the CPU), the port with a torch generator, so parity
starts both from one random JAX tree carried over by the bridge.

Tolerances: the loss functions on the same inputs rtol 1e-5, atol 1e-6
(float32, other summation orders); greedy assignments equal; the
optimizer and the clipping against optax rtol 1e-6.  Trainer steps (lr
1e-5, the CLI's): losses rtol 1e-5; each leaf's first-step gradient
against the JAX Trainer's within 1e-4 of the leaf's norm plus 1e-6 of
the global norm (a 5% error in one MLP's backward fails it); the update
of each parameter (new minus old) within 0.1 lr for all but 1% of each
leaf's entries (one in a leaf of under 100) and within 2.5 lr for all.
The first Adam step moves each entry by about lr times the sign of its
gradient, so where float32 leaves a gradient at the noise level the two
packages step 2 lr apart, and the second step carries that on; a leaf
whose whole gradient is at that level (a key bias under softmax, a bias
in front of a norm) may step apart anywhere.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from inklayer_tpu.io.weights import DEPTH_RULES, GDINO_RULES, SAM_RULES
from inklayer_tpu.parallel import detection_loss as JD
from inklayer_tpu.parallel import train as JT
from inklayer_tpu.parallel.mesh import make_mesh
from inklayer_tpu_torch import runtime
from inklayer_tpu_torch.io.checkpoint import (convert_and_cache, load_params,
                                              save_params)
from inklayer_tpu_torch.parallel import detection_loss as TD
from inklayer_tpu_torch.parallel import train as TT
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from inklayer_tpu_torch.scripts import train as cli
from tests.test_torch_sam import random_jax_params

LOSS = dict(rtol=1e-5, atol=1e-6)
LR = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def test_mask_losses_match_jax(rng):
    logits = (rng.standard_normal((3, 16, 16)) * 4).astype(np.float32)
    target = (rng.random((3, 16, 16)) > 0.6).astype(np.float32)
    iou = rng.random((3, 1)).astype(np.float32)
    for name, args in (("focal_loss", (logits, target)),
                       ("dice_loss", (logits, target)),
                       ("sam_mask_loss", (logits, iou, target))):
        want = getattr(JT, name)(*map(jnp.asarray, args))
        got = getattr(TT, name)(*map(_t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS,
                                   err_msg=name)


def test_silog_loss_matches_jax(rng):
    pred = rng.random((20, 24)).astype(np.float32) + 0.05
    tgt = rng.random((20, 24)).astype(np.float32)
    tgt[rng.random((20, 24)) < 0.2] = 0.0
    want = JT.silog_loss(jnp.asarray(pred), jnp.asarray(tgt),
                         jnp.asarray(tgt > 0))
    got = TT.silog_loss(_t(pred), _t(tgt), _t(tgt > 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS)
    # the JAX package's own checks: equal maps give ~0, a scaled map more
    flat = torch.full((8, 8), 2.0)
    assert float(TT.silog_loss(flat, flat, flat > 0)) < 1e-5
    assert float(TT.silog_loss(flat * 3, flat, flat > 0)) > 0.1


def test_box_helpers_match_jax(rng):
    a = rng.random((7, 4)).astype(np.float32)
    b = rng.random((5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TD.box_cxcywh_to_xyxy(_t(a)).numpy(),
        np.asarray(JD.box_cxcywh_to_xyxy(jnp.asarray(a))), **LOSS)
    xa = np.asarray(JD.box_cxcywh_to_xyxy(jnp.asarray(a)))
    xb = np.asarray(JD.box_cxcywh_to_xyxy(jnp.asarray(b)))
    np.testing.assert_allclose(
        TD.generalized_box_iou(_t(xa), _t(xb)).numpy(),
        np.asarray(JD.generalized_box_iou(jnp.asarray(xa), jnp.asarray(xb))),
        **LOSS)


@pytest.mark.parametrize("case", ["random", "ties", "invalid"])
def test_greedy_assignment_matches_jax(rng, case):
    cost = rng.standard_normal((9, 6)).astype(np.float32)
    valid = np.ones(6, bool)
    if case == "ties":  # equal costs: the first minimum wins in both
        cost = np.round(cost)
    if case == "invalid":
        valid[[1, 4]] = False
    want = np.asarray(JD.greedy_assignment(jnp.asarray(cost),
                                           jnp.asarray(valid)))
    got = TD.greedy_assignment(_t(cost), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()


def _det_inputs(rng, b=2, nq=10, m=4, t=8):
    logits = rng.standard_normal((b, nq, t)).astype(np.float32) * 3
    logits[:, :, -2:] = -np.inf  # padded tokens
    boxes = (rng.random((b, nq, 4)) * 0.5 + 0.2).astype(np.float32)
    gts = (rng.random((b, m, 4)) * 0.5 + 0.2).astype(np.float32)
    pm = np.zeros((b, m, t), np.float32)
    pm[:, :, 1] = 1.0
    pm[:, 1::2, 3] = 1.0
    valid = np.ones((b, m), bool)
    valid[0, 2:] = False  # padded GTs: all scatter onto query 0
    gts[0, 2:] = 0.0
    boxes[0, 0] = gts[0, 0] + 0.01  # ... which a valid GT takes too
    logits[0, 0, 1] = 6.0
    return logits, boxes, gts, pm, valid


def test_detection_loss_and_grads_match_jax(rng):
    args = _det_inputs(rng)

    def jax_total(lg, bx):
        return JD.detection_loss(lg, bx, *map(jnp.asarray, args[2:]))[0]

    # jitted: the eager fori_loop of the matching takes ~10 s
    want, want_m = jax.jit(JD.detection_loss)(*map(jnp.asarray, args))
    want_g = jax.jit(jax.grad(jax_total, argnums=(0, 1)))(
        jnp.asarray(args[0]), jnp.asarray(args[1]))
    lg, bx = _t(args[0]).requires_grad_(), _t(args[1]).requires_grad_()
    got, got_m = TD.detection_loss(lg, bx, *map(_t, args[2:]))
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].detach().numpy(),
                                   np.asarray(want_m[k]), **LOSS, err_msg=k)
    for g, w in zip((lg.grad, bx.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_detection_loss_ignores_padded_gts(rng):
    """Image 0's two padded GTs scatter zero rows onto query 0, which its
    first GT matched: the loss equals the loss without the padding (a
    last-write scatter would drop that GT's target row)."""
    logits, boxes, gts, pm, valid = (_t(a) for a in _det_inputs(rng))
    padded, _ = TD.detection_loss(logits[:1], boxes[:1], gts[:1], pm[:1],
                                  valid[:1])
    bare, _ = TD.detection_loss(logits[:1], boxes[:1], gts[:1, :2],
                                pm[:1, :2], valid[:1, :2])
    np.testing.assert_allclose(padded.numpy(), bare.numpy(), **LOSS)


def test_detection_loss_perfect_prediction_lower():
    """The JAX package's own check, on the port."""
    nq, t = 8, 6
    gt = torch.tensor([[[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.2]]])
    pm = torch.zeros((1, 2, t))
    pm[0, 0, 1] = pm[0, 1, 2] = 1
    valid = torch.ones((1, 2), dtype=torch.bool)
    boxes = torch.rand((1, nq, 4), generator=torch.Generator().manual_seed(0))
    boxes[0, :2] = gt[0]
    logits = torch.full((1, nq, t), -8.0)
    logits[0, 0, 1] = logits[0, 1, 2] = 8.0
    good, gm = TD.detection_loss(logits, boxes, gt, pm, valid)
    bad, _ = TD.detection_loss(torch.zeros((1, nq, t)),
                               torch.full((1, nq, 4), 0.5), gt, pm, valid)
    assert float(good) < float(bad)
    assert float(gm["loss_l1"]) < 1e-5 and float(gm["loss_giou"]) < 1e-5


# ---------------------------------------------------------------------------
# disable_kernels
# ---------------------------------------------------------------------------


class _CudaStub:
    """Stands in for a CUDA tensor on the launch path's test."""
    is_cuda = True


def test_disable_kernels_nests_and_restores():
    t = _CudaStub()
    assert runtime.use_kernel(t)
    with runtime.disable_kernels():
        assert not runtime.use_kernel(t)
        with runtime.disable_kernels():
            assert not runtime.use_kernel(t)
        assert not runtime.use_kernel(t)
    assert runtime.use_kernel(t)
    with pytest.raises(RuntimeError):
        with runtime.disable_kernels():
            raise RuntimeError("inside")
    assert runtime.use_kernel(t) and runtime._disable_depth == 0
    assert not runtime.use_kernel(torch.zeros(2))  # CPU: plain either way


def test_plain_cpu_step_is_unchanged_by_the_switch(rng):
    """A CPU train step inside the switch equals the same step outside."""
    cfg, size = cli.task_config(cli.parse_args(
        ["--task", "sam", "--synthetic", "1", "--image_size", "64"]))
    models = []
    for _ in range(2):
        t = cli.sam_task(cfg, np.random.default_rng(0))
        models.append((t, cli.init_model(t, "cpu", 0)))
    batch = next(cli.batches([models[0][0].synth(0)], 1))
    (t, a), (_, b) = models
    trainer = TT.Trainer(t.loss_fn, a, max_grad_norm=1.0)
    loss_a = trainer.train_step(batch)
    opt = TT.adamw(b.parameters())
    loss_b = t.loss_fn(b, {k: _t(v) for k, v in batch.items()})
    loss_b.backward()
    for p in b.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    TT.clip_by_global_norm([p.grad for p in b.parameters()], 1.0)
    opt.step()
    assert float(loss_a) == float(loss_b.detach())
    for (k, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), k


def test_clip_by_global_norm_matches_optax(rng):
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             ((3, 4), (5,), (2, 2, 2))]
    for scale in (0.01, 10.0):
        gs = [g * scale for g in grads]
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())
        got = [_t(g.copy()) for g in gs]
        norm = TT.clip_by_global_norm(got, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(g) for g in gs])), rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)


def test_mesh_of_more_than_one_device_raises():
    """Without a process group, a mesh of one device is the single-process
    path and a larger one raises the JAX mesh message."""
    model = torch.nn.Linear(2, 2)
    assert TT.Trainer(lambda m, b: m(b).sum(), model,
                      mesh=(1, 1, 1)).mesh is None
    with pytest.raises(ValueError, match="mesh 2x1x1 needs 2 devices, "
                                         "have 1"):
        TT.Trainer(lambda m, b: m(b).sum(), model, mesh=(2, 1, 1))


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer, two steps per recipe
# ---------------------------------------------------------------------------


def _jax_models():
    from inklayer_tpu.config import DepthConfig, SamConfig
    from inklayer_tpu.models.depth.dpt import DepthAnythingV2
    from inklayer_tpu.models.gdino.gdino import GroundingDINO
    from inklayer_tpu.models.sam import Sam
    from tests.test_gdino import TINY

    # the JAX CLI's --synthetic configs (scripts/train.py)
    sam_cfg = SamConfig(image_size=64, encoder_embed_dim=32, encoder_depth=2,
                        encoder_num_heads=2, encoder_global_attn_indexes=(1,),
                        encoder_window_size=2, prompt_embed_dim=32)
    depth_cfg = DepthConfig(embed_dim=32, depth=4, num_heads=2, features=16,
                            out_channels=(16, 16, 32, 32),
                            intermediate_layers=(0, 1, 2, 3), input_size=56)
    return Sam(sam_cfg), DepthAnythingV2(depth_cfg), GroundingDINO(TINY)


def _jax_recipe(task):
    """(JAX model, its example args, the JAX CLI's loss_fn)."""
    sam, depth, gdino = _jax_models()
    if task == "sam":
        def loss_fn(params, batch):
            def one(img, boxes, target):
                logits, iou = sam.apply(params, img[None], boxes)
                return JT.sam_mask_loss(logits[:, 0], iou[:, 0], target)

            return jnp.mean(jax.vmap(one)(
                batch["image"], batch["boxes"], batch["mask"]))

        return sam, (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 4))), loss_fn
    if task == "depth":
        def loss_fn(params, batch):
            def one(img, target):
                pred = depth.apply(params, img[None])[0]
                pred = jax.image.resize(pred, target.shape, "bilinear")
                return JT.silog_loss(jax.nn.relu(pred) + 1e-3, target,
                                     target > 0)

            return jnp.mean(jax.vmap(one)(batch["image"], batch["depth"]))

        return depth, (jnp.zeros((1, 56, 56, 3)),), loss_fn
    from inklayer_tpu.models.gdino.bert import subsentence_masks

    ids = np.asarray([[101, 4874, 1012, 102, 0, 0]], np.int32)
    attn, pos = subsentence_masks(ids)
    text = (jnp.asarray(ids), jnp.asarray(attn),
            jnp.asarray(pos.astype(np.int32)))

    def loss_fn(params, batch):
        def one(img, gt_boxes):
            logits, boxes = gdino.apply(
                params, img[None], jnp.zeros((1, 64, 64), bool), *text)
            m = gt_boxes.shape[0]
            pos_maps = jnp.zeros((1, m, 16)).at[..., 1].set(1.0)
            valid = jnp.ones((1, m), bool)
            return JD.detection_loss(logits, boxes, gt_boxes[None], pos_maps,
                                     valid)[0]

        return jnp.mean(jax.vmap(one)(batch["image"], batch["boxes"]))

    return gdino, (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), bool),
                   *text), loss_fn


# each leaf's gradient against its JAX counterpart: L2 error within
# GRAD_RTOL of the leaf's norm plus GRAD_ATOL of the global norm (leaves
# whose exact gradient is 0, such as a key bias under softmax or a bias
# in front of a norm, hold float32 noise of up to ~1e-8 of it)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
DEPTH_OUT_BIAS = 80.0
RULES = {"sam": SAM_RULES, "depth": DEPTH_RULES, "gdino": GDINO_RULES}
SIZES = {"sam": 64, "depth": 56, "gdino": 64}


def _port_state(task, flat_params):
    return jax_to_torch_state_dict(flat_params, RULES[task])


def _stash_grads():
    """An identity optax transformation whose state is the last gradients
    it was given: the JAX Trainer's own gradients, read after its step."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.mark.parametrize("task", ["sam", "depth", "gdino"])
def test_two_trainer_steps_match_jax(task):
    jm, args, jax_loss = _jax_recipe(task)
    params = random_jax_params(jm, args, seed=3)
    if task == "depth":
        # lift the head's output clear of its ReLU: where the prediction is
        # ~0, log(relu(pred) + 1e-3) has a slope of 1e3 and a curvature of
        # 1e6, so float32 noise in the forward becomes ~0.4% in every
        # gradient (the model's own backward agrees to ~1e-6)
        params["params"]["depth_head"]["output_conv2_2"]["bias"] = \
            np.full((1,), DEPTH_OUT_BIAS, np.float32)
    cfg, size = cli.task_config(cli.parse_args(
        ["--task", task, "--synthetic", "2", "--image_size",
         str(SIZES[task])]))
    t = cli.make_task(task, cfg, size, np.random.default_rng(5))
    model = t.model
    sd = _port_state(task, flatten_tree(params["params"]))
    # every JAX leaf is a trainable parameter of the port (clipping and
    # weight decay see all of them)
    trainable = dict(model.named_parameters())
    assert set(sd) <= set(trainable), sorted(set(sd) - set(trainable))
    model.load_state_dict(sd, strict=False)
    samples = [t.synth(i) for i in range(2)]
    if task == "depth":  # a target of another size: the antialiased resize
        for s in samples:
            s["depth"] = s["depth"][:42, :50].copy()
    batch = next(cli.batches(samples, 2))

    # the port's gradients at the shared params: its backward of its loss
    t.loss_fn(model, {k: torch.as_tensor(v) for k, v in batch.items()}
              ).backward()
    tgrad = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    mesh = make_mesh(1, 1, 1)
    jtr = JT.Trainer(jax_loss, params, mesh, optimizer=optax.chain(
        _stash_grads(), optax.clip_by_global_norm(1.0), optax.adamw(LR)))
    # one compile for both steps: the optimizer state placed as the step
    # places its outputs
    jtr.opt_state = jax.device_put(jtr.opt_state,
                                   NamedSharding(mesh, PartitionSpec()))
    ttr = TT.Trainer(t.loss_fn, model, optimizer=TT.adamw(
        model.parameters(), LR), max_grad_norm=1.0)
    before = {k: v.clone() for k, v in sd.items()}
    losses = [(float(jtr.train_step(batch)), float(ttr.train_step(batch)))]
    # leaf by leaf against the JAX Trainer's first-step gradients (its
    # value_and_grad of the JAX CLI's loss, stashed by the optimizer)
    jgrad = _port_state(task, flatten_tree(
        jax.device_get(jtr.opt_state[0])["params"]))
    gnorm = float(np.sqrt(sum(float((g ** 2).sum())
                              for g in jgrad.values())))
    noise = set()  # leaves whose gradient is float32 noise in both
    for k, want in jgrad.items():
        got = torch.zeros_like(want) if tgrad[k] is None else tgrad[k]
        err = float((got - want).norm())
        assert err <= GRAD_RTOL * float(want.norm()) + GRAD_ATOL * gnorm, (
            k, err / gnorm, float(want.norm()) / gnorm)
        if float(want.norm()) <= GRAD_ATOL * gnorm:
            noise.add(k)
    losses.append((float(jtr.train_step(batch)), float(ttr.train_step(batch))))
    for step, (want, got) in enumerate(losses):
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"{task} step {step}")
    after = _port_state(task, flatten_tree(
        jax.device_get(jtr.params)["params"]))
    port = model.state_dict()
    for k, want in after.items():
        err = np.abs((port[k] - before[k]).numpy()
                     - (want - before[k]).numpy())
        assert err.max() <= 2.5 * LR, (k, err.max() / LR)
        # each leaf: at most 1% of its entries (one in a small leaf) step
        # apart, where a gradient entry at the noise level flips its sign;
        # a leaf whose whole gradient is noise steps anywhere within lr
        off = int((err > 0.1 * LR).sum())
        assert k in noise or off <= max(1, 0.01 * err.size), (
            k, off, err.size)
    moved = sum(float((port[k] - before[k]).abs().sum()) for k in after)
    assert moved > 0


def test_adamw_matches_optax(rng):
    """Three steps on given gradients, weight decay included."""
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    opt = optax.adamw(1e-2)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.nn.Parameter(_t(p0.copy()))
    topt = TT.adamw([tp], 1e-2)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_with_config(tmp_path):
    from inklayer_tpu_torch.config import PipelineConfig, load_config

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    save_params(model, str(tmp_path / "c"), config=PipelineConfig())
    sd = load_params(str(tmp_path / "c"))
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    fresh = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    assert load_params(str(tmp_path / "c"), template=fresh) is fresh
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with open(tmp_path / "c" / "config.json") as f:
        assert json.load(f)["gdino"]["num_queries"] == 900
    assert load_config(str(tmp_path / "c" / "config.json")) == \
        PipelineConfig()
    with pytest.raises(RuntimeError):  # strict: a shape that differs
        load_params(str(tmp_path / "c"), template=torch.nn.Sequential(
            torch.nn.Linear(3, 5), torch.nn.LayerNorm(5)))


def test_convert_and_cache_reuses_its_cache(tmp_path):
    src = tmp_path / "model.pth"
    torch.save({"w": torch.arange(6.0)}, src)
    calls = []

    def loader(path, scale):
        calls.append(path)
        return {"w": torch.load(path)["w"] * scale}

    first = convert_and_cache(str(src), str(tmp_path / "cache"), loader, 2.0)
    again = convert_and_cache(str(src), str(tmp_path / "cache"), loader, 2.0)
    assert len(calls) == 1
    assert torch.equal(first["w"], again["w"])
    st = os.stat(src)
    assert os.listdir(tmp_path / "cache") == [
        f"model.pth-{st.st_size}-{int(st.st_mtime)}"]
    os.utime(src, (st.st_atime, st.st_mtime + 5))  # a new source: a new key
    convert_and_cache(str(src), str(tmp_path / "cache"), loader, 2.0)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task,size", [("sam", 64), ("depth", 56),
                                       ("gdino", 64)])
def test_cli_synthetic_ckpt_and_resume(tmp_path, capsys, task, size):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--task", task, "--synthetic", "2", "--image_size", str(size),
            "--cpu", "--ckpt", ckpt, "--ckpt_every", "2"]
    trainer = cli.main(argv + ["--steps", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "step     3  loss" in out
    assert out.rstrip().endswith("done.")
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    saved = load_params(os.path.join(ckpt, "step_3"))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    resumed = cli.main(argv[:-4] + ["--steps", "0", "--resume",
                                    os.path.join(ckpt, "step_3")])
    assert "resumed from" in capsys.readouterr().out
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    cli.main(argv[:-4] + ["--steps", "1", "--resume",
                          os.path.join(ckpt, "step_3")])


def test_cli_refuses_a_mesh():
    """--dp 2 in one process (no torchrun) raises, naming torchrun."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(["--task", "sam", "--synthetic", "1", "--image_size", "64",
                  "--cpu", "--steps", "1", "--dp", "2"])


def test_cli_reads_a_data_directory(tmp_path):
    """--data: each recipe's files load into samples its loss takes (the
    tiny configs; the CLI builds the full ones for --data)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)
                        ).save(tmp_path / f"s{i}.png")
        Image.fromarray(((rng.random((64, 64)) > 0.5) * 255).astype(
            np.uint8)).save(tmp_path / f"s{i}_mask.png")
        np.save(tmp_path / f"s{i}_depth.npy",
                rng.random((64, 64)).astype(np.float32))
        with open(tmp_path / f"s{i}_boxes.json", "w") as f:
            json.dump([[0.4, 0.4, 0.3, 0.2]], f)
    for task, size in (("sam", 64), ("depth", 56), ("gdino", 64)):
        args = cli.parse_args(["--task", task, "--synthetic", "1",
                               "--image_size", str(size)])
        cfg, size = cli.task_config(args)
        t = cli.make_task(task, cfg, size, np.random.default_rng(0))
        args.synthetic, args.data = 0, str(tmp_path)
        samples = cli.load_samples(args, t)
        assert len(samples) == 2
        model = cli.init_model(t, "cpu", 0)
        loss = TT.Trainer(t.loss_fn, model).train_step(
            next(cli.batches(samples, 2)))
        assert np.isfinite(float(loss)), task
