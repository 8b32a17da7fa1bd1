"""Port parity: the (dp, fsdp, tp) mesh — the sharding rules against the JAX
package's, the mesh shapes, and one 4-rank job on the CPU (gloo) against
the JAX package on its 8 virtual devices and against the port's own
single-process steps.

The rank job (``torch_mesh_worker.py``, port only) runs beside the JAX
side in this process:

* a tp = 4 SAM encode (the JAX dry run's tiny SAM) against the JAX
  encode over the (1, 1, 4) mesh, and a dp = 4 GroundingDINO forward
  (rank r's rows) against the JAX forward over (4, 1, 1): atol 2e-5,
  rtol 1e-5 (``test_tp_inference.py``'s limits);
* two Trainer steps of the SAM recipe over (1, 2, 2) against the JAX
  Trainer over (1, 2, 2), and one step each of the SAM recipe over
  (2, 1, 2) and of the depth recipe (DINOv2's tp plan) over (1, 2, 2)
  against the port's single-process Trainer: losses and gradient norms
  rtol 1e-5, each leaf's first-step gradient and each parameter's update
  by ``test_torch_train.py``'s scheme.
"""

import copy
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from inklayer_tpu.io.weights import DEPTH_RULES, GDINO_RULES, SAM_RULES
from inklayer_tpu.models.gdino import GroundingDINO as JaxGDINO
from inklayer_tpu.models.sam import Sam as JaxSam
from inklayer_tpu.parallel import mesh as JM
from inklayer_tpu.parallel import sharding as JS
from inklayer_tpu.parallel import train as JT
from inklayer_tpu_torch.models.gdino import GroundingDINO
from inklayer_tpu_torch.models.sam import Sam
from inklayer_tpu_torch.parallel import dryrun
from inklayer_tpu_torch.parallel import mesh as TM
from inklayer_tpu_torch.parallel import sharding as TS
from inklayer_tpu_torch.parallel import train as TT
from inklayer_tpu_torch.params import flatten_tree, jax_to_torch_state_dict
from inklayer_tpu_torch.scripts import train as cli
from tests.test_torch_depth import depth_pair
from tests.test_torch_gdino import gdino_pair
from tests.test_torch_sam import random_jax_params, sam_pair
from tests.test_torch_train import (DEPTH_OUT_BIAS, GRAD_ATOL, GRAD_RTOL, LR,
                                    _jax_recipe, _port_state, _stash_grads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODE = dict(atol=2e-5, rtol=1e-5)
RANKS_TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# the rules and the mesh shapes (no processes)
# ---------------------------------------------------------------------------


# the bridge's inverse transforms as axis orders: torch dim i holds the
# flax dim ORDER[transform][i]
ORDER = {"linear": (1, 0), "conv": (3, 2, 0, 1), "convT": (2, 3, 0, 1)}


@pytest.mark.parametrize("which", ["sam", "depth", "gdino"])
def test_spec_for_param_matches_jax_transposed(which):
    """Every parameter of the tiny models: the port's spec is the JAX
    spec of its flax leaf, carried through the bridge's transpose (GDINO's
    packed in_proj: each of its q, k, v leaves)."""
    from inklayer_tpu_torch.params import (_IN_PROJ, _SAM_TWO_WAY_MLP,
                                           _InverseRule)

    pair, rules = {"sam": (sam_pair, SAM_RULES),
                   "depth": (depth_pair, DEPTH_RULES),
                   "gdino": (gdino_pair, GDINO_RULES)}[which]
    _, params, tm = pair()
    inverse = [_InverseRule(r) for r in rules]
    got = {name: TS.spec_for_param(name, p.dim(), TS.param_layout(tm, name))
           for name, p in tm.named_parameters()}
    checked = 0
    for path, leaf in flatten_tree(params["params"]).items():
        jspec = tuple(JS.spec_for_param(path, leaf.ndim))
        jspec += (None,) * (leaf.ndim - len(jspec))
        if any(rx.fullmatch(path) for rx, _ in _IN_PROJ):
            # sa_q/kernel ... are rows of one packed in_proj_weight
            if leaf.ndim == 2:
                assert jspec == ("fsdp", "tp"), (path, jspec)
            continue
        fixed = _SAM_TWO_WAY_MLP.sub(
            lambda m: f"{m.group(1)}layer{int(m.group(2)) + 1}0/", path)
        inv = next(i for i in inverse if i.torch_key(fixed))
        order = ORDER.get(inv.rule.transform_name, tuple(range(leaf.ndim)))
        want = tuple(jspec[i] for i in order) if leaf.ndim >= 2 else jspec
        key = inv.torch_key(fixed)
        assert got[key] == want, (key, got[key], want)
        checked += 1
    packed = [k for k in got if k.endswith("in_proj_weight")]
    assert all(got[k] == ("tp", "fsdp") for k in packed)
    assert checked > 20 and (which != "gdino" or packed)


def test_param_sharding_rules_drop_axes_that_do_not_divide():
    model = Sam(dryrun.SAM_CFG)
    rules = TS.param_sharding_rules(model, (1, 2, 4))
    assert rules["image_encoder.blocks.0.attn.qkv.weight"] == ("tp", "fsdp")
    assert rules["image_encoder.blocks.0.attn.proj.weight"] == ("fsdp", "tp")
    assert rules["image_encoder.blocks.0.mlp.lin2.bias"] == (None,)
    # a (3, 16) rel-pos table: fsdp on the head dim, dropped where the
    # mesh axis does not divide it, as the JAX rules drop it
    assert rules["image_encoder.blocks.0.attn.rel_pos_h"] == (None, "fsdp")
    wide = TS.param_sharding_rules(model, (1, 4, 1))
    assert wide["mask_decoder.iou_token.weight"] == (None, "fsdp")
    assert wide["prompt_encoder.point_embeddings.0.weight"] == (None, "fsdp")
    odd = TS.param_sharding_rules(model, (1, 3, 1))
    assert odd["image_encoder.blocks.0.attn.rel_pos_h"] == (None, None)


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_shape_matches_jax(n):
    assert TM.auto_mesh_shape(n) == tuple(JM.auto_mesh(n).devices.shape)


def test_make_mesh_refuses_a_world_it_does_not_fill():
    with pytest.raises(ValueError, match=r"mesh 2x1x1 needs 2 devices, have 1"):
        TM.make_mesh(2, 1, 1)
    with pytest.raises(ValueError, match="needs 8 devices"):
        TM.make_mesh(2, 2, 2)
    with pytest.raises(ValueError, match=r"mesh 2x1x1 needs 2 devices"):
        JM.make_mesh(2, 1, 1, devices=jax.devices()[:1])


def test_use_kernel_refuses_a_dtensor(tmp_path):
    """A DTensor never reaches a kernel wrapper (its data_ptr() is not the
    rank's shard): on a one-rank gloo mesh, every op's gate raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from inklayer_tpu_torch import runtime
    from inklayer_tpu_torch.ops.mlp import mlp_gelu

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = TM.make_mesh(1, 1, 1, device_type="cpu")
        w = distribute_tensor(torch.ones(4, 4), mesh["fsdp"])
        with pytest.raises(TypeError, match="DTensor"):
            runtime.use_kernel(torch.ones(2), w)
        with pytest.raises(TypeError, match="DTensor"):
            mlp_gelu(torch.ones(2, 4), w, torch.ones(4), w, torch.ones(4))
        assert not runtime.use_kernel(torch.ones(2))  # plain tensors pass
    finally:
        dist.destroy_process_group()


def test_shard_batch_gives_each_dp_rank_its_slice():
    class Mesh:  # the two calls shard_batch makes
        def __init__(self, dp, rank):
            self.dp, self.rank = dp, rank

        def size(self, i):
            return self.dp

        def get_local_rank(self, axis):
            return self.rank

    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    parts = [TS.shard_batch(batch, Mesh(4, r)) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([p["a"] for p in parts]),
                                  batch["a"])
    assert torch.equal(torch.cat([p["b"] for p in parts]), batch["b"])
    with pytest.raises(ValueError, match="dp=3"):
        TS.shard_batch(batch, Mesh(3, 0))


# ---------------------------------------------------------------------------
# one 4-rank job against the JAX package and the port's single process
# ---------------------------------------------------------------------------


def _save(path, sd):
    np.savez(path, **{k: v.detach().numpy() for k, v in sd.items()})


def _port_model(task, flat, size):
    """The port's recipe model from a JAX tree: the bridged parameters, the
    port-only ones (SAM's mask-prompt convnet) from one seed."""
    args = cli.parse_args(["--task", task, "--synthetic", "2",
                           "--image_size", str(size)])
    cfg, size = cli.task_config(args)
    torch.manual_seed(0)
    t = cli.make_task(task, cfg, size, np.random.default_rng(5))
    t.model.load_state_dict(_port_state(task, flat), strict=False)
    return t, [t.synth(i) for i in range(2)]


@pytest.fixture(scope="module")
def mesh_job(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.default_rng(0)
    cfg = dryrun.SAM_CFG
    size = cfg.image_size

    # inputs and converted weights for the ranks
    jsam = JaxSam(cfg)
    sam_params = random_jax_params(
        jsam, (jnp.zeros((1, size, size, 3)), jnp.zeros((1, 4))), 7,
        std=0.05)
    torch.manual_seed(0)
    tsam = Sam(cfg)
    sd = jax_to_torch_state_dict(flatten_tree(sam_params["params"]),
                                 SAM_RULES)
    tsam.load_state_dict(sd, strict=False)
    _save(os.path.join(root, "sam.npz"), tsam.state_dict())
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    np.save(os.path.join(root, "x.npy"), x)

    gcfg = dryrun.GDINO_CFG
    jg = JaxGDINO(gcfg)
    det = dryrun.gdino_inputs(4, 64, rng)
    det_np = [t.numpy() for t in det]
    g_params = random_jax_params(
        jg, tuple(jnp.asarray(a[:1].astype(np.int32) if a.dtype == np.int64
                              else a[:1]) for a in det_np), 8, std=0.05)
    _save(os.path.join(root, "gdino.npz"), jax_to_torch_state_dict(
        flatten_tree(g_params["params"]), GDINO_RULES))
    np.savez(os.path.join(root, "detect_in.npz"),
             **dict(zip(("image", "pad", "ids", "attn", "pos"), det_np)))

    # the train jobs: (1, 2, 2) against the JAX Trainer; (2, 1, 2) and
    # the depth recipe over (1, 2, 2) against the port's single process
    jobs, port = [], {}
    for name, task, mesh, steps in (("sam_122", "sam", (1, 2, 2), 2),
                                    ("sam_212", "sam", (2, 1, 2), 1),
                                    ("depth_122", "depth", (1, 2, 2), 1)):
        jm, args, jloss = _jax_recipe(task)
        params = random_jax_params(jm, args, seed=3)
        if task == "depth":  # test_torch_train.py: clear of the ReLU
            params["params"]["depth_head"]["output_conv2_2"]["bias"] = \
                np.full((1,), DEPTH_OUT_BIAS, np.float32)
        t, samples = _port_model(task, flatten_tree(params["params"]),
                                 {"sam": 64, "depth": 56}[task])
        if task == "depth":
            for s in samples:
                s["depth"] = s["depth"][:42, :50].copy()
        batch = next(cli.batches(samples, 2))
        _save(os.path.join(root, f"{name}_params.npz"), t.model.state_dict())
        np.savez(os.path.join(root, f"{name}_batch.npz"), **batch)
        jobs.append({"name": name, "task": task, "mesh": mesh,
                     "steps": steps, "lr": LR,
                     "size": {"sam": 64, "depth": 56}[task],
                     "params": f"{name}_params.npz",
                     "batch": f"{name}_batch.npz"})
        port[name] = (task, t, params, jloss, batch)
    with open(os.path.join(root, "jobs.json"), "w") as f:
        json.dump(jobs, f)

    # the ranks run while this process computes the references
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", os.path.join(REPO, "tests",
                                               "torch_mesh_worker.py"), root],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        ref = {}
        mesh_tp = JM.make_mesh(1, 1, 4)
        shard = JS.param_sharding_rules(sam_params, mesh_tp)
        enc = jax.jit(lambda p, xx: jsam.apply(p, xx, method=JaxSam.encode),
                      in_shardings=(shard, JS.batch_sharding(mesh_tp)))
        ref["encode"] = np.asarray(enc(jax.tree.map(
            jax.device_put, sam_params, shard), jnp.asarray(x)))
        mesh_dp = JM.make_mesh(4, 1, 1)
        dp = NamedSharding(mesh_dp, PartitionSpec("dp"))
        fwd = jax.jit(jg.apply, in_shardings=(None, dp, dp, dp, dp, dp))
        ref["logits"], ref["boxes"] = map(np.asarray, fwd(
            g_params, *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                    else a) for a in det_np)))

        task, t, params, jloss, batch = port["sam_122"]
        mesh = JM.make_mesh(1, 2, 2)
        jtr = JT.Trainer(jloss, params, mesh, optimizer=optax.chain(
            _stash_grads(), optax.clip_by_global_norm(1.0), optax.adamw(LR)))
        jtr.opt_state = jax.device_put(jtr.opt_state,
                                       NamedSharding(mesh, PartitionSpec()))
        ref["sam_122"] = {"losses": [float(jtr.train_step(batch))]}
        ref["sam_122"]["grads"] = _port_state(task, flatten_tree(
            jax.device_get(jtr.opt_state[0])["params"]))
        ref["sam_122"]["losses"].append(float(jtr.train_step(batch)))
        ref["sam_122"]["after"] = _port_state(task, flatten_tree(
            jax.device_get(jtr.params)["params"]))
        ref["sam_122"]["before"] = _port_state(task, flatten_tree(
            params["params"]))

        for name in ("sam_212", "depth_122"):
            task, t, params, _, batch = port[name]
            model = copy.deepcopy(t.model)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            tr = TT.Trainer(t.loss_fn, model, optimizer=TT.adamw(
                model.parameters(), LR), max_grad_norm=1.0)
            loss = float(tr.train_step(batch))
            ref[name] = {"losses": [loss], "grad_norm": float(tr.grad_norm),
                         "grads": {k: p.grad.clone() for k, p in
                                   model.named_parameters()},
                         "before": before, "after": model.state_dict()}
        out, _ = proc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-6000:]
    got = {"encode": np.load(os.path.join(root, "encode.npy"))}
    got["detect"] = [dict(np.load(os.path.join(root, f"detect_{r}.npz")))
                     for r in range(4)]
    with open(os.path.join(root, "mesh_errors.json")) as f:
        got["mesh_errors"] = json.load(f)
    for name in port:
        with np.load(os.path.join(root, f"{name}.npz")) as f:
            got[name] = {k: f[k] for k in f.files}
    return ref, got


def test_tp4_sam_encode_matches_jax(mesh_job):
    ref, got = mesh_job
    np.testing.assert_allclose(got["encode"], ref["encode"], **ENCODE)


def test_dp4_gdino_detect_matches_jax(mesh_job):
    ref, got = mesh_job
    for r, part in enumerate(got["detect"]):
        np.testing.assert_allclose(part["boxes"], ref["boxes"][r:r + 1],
                                   **ENCODE)
        want = ref["logits"][r:r + 1]
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(part["logits"]))
        np.testing.assert_allclose(part["logits"][fin], want[fin], **ENCODE)


def test_make_mesh_refuses_shapes_that_do_not_fill_four_ranks(mesh_job):
    _, got = mesh_job
    assert got["mesh_errors"] == {
        "1x1x2": "mesh 1x1x2 holds 2 of 4 ranks: a rank outside the mesh "
                 "has no work",
        "2x1x4": "mesh 2x1x4 needs 8 devices, have 4"}


def _hold_step(name, want_losses, got, want_grads, before, want_after,
               unclip=1.0):
    """test_torch_train.py's scheme: losses rtol 1e-5; each leaf's
    gradient within GRAD_RTOL of its norm plus GRAD_ATOL of the global
    norm; each parameter's update within 2.5 lr, and within 0.1 lr for all
    but 1% of a leaf's entries (unless the leaf's gradient is noise)."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                               err_msg=name)
    gnorm = float(np.sqrt(sum(float((torch.as_tensor(g) ** 2).sum())
                              for g in want_grads.values())))
    noise = set()
    for k, want in want_grads.items():
        want = torch.as_tensor(want)
        mine = torch.from_numpy(got[f"grad/{k}"]) * unclip
        err = float((mine - want).norm())
        assert err <= GRAD_RTOL * float(want.norm()) + GRAD_ATOL * gnorm, (
            name, k, err / gnorm)
        if float(want.norm()) <= GRAD_ATOL * gnorm:
            noise.add(k)
    moved = 0.0
    for k, want in want_after.items():
        mine = torch.from_numpy(got[f"param/{k}"])
        step_err = ((mine - before[k]) - (torch.as_tensor(want)
                                          - before[k])).abs()
        assert float(step_err.max()) <= 2.5 * LR, (name, k)
        off = int((step_err > 0.1 * LR).sum())
        assert k in noise or off <= max(1, 0.01 * step_err.numel()), (
            name, k, off)
        moved += float((mine - before[k]).abs().sum())
    assert moved > 0, name


def test_trainer_over_122_matches_the_jax_trainer(mesh_job):
    """Two steps over (1, 2, 2) against the JAX Trainer over (1, 2, 2):
    the JAX gradients are read before clipping, the port's after it."""
    ref, got = mesh_job
    want, mine = ref["sam_122"], got["sam_122"]
    norm = float(mine["grad_norm"])
    assert np.isfinite(norm)
    _hold_step("sam_122", want["losses"], mine, want["grads"],
               want["before"], want["after"], unclip=max(norm, 1.0))


@pytest.mark.parametrize("name", ["sam_212", "depth_122"])
def test_mesh_step_matches_the_single_process_step(mesh_job, name):
    ref, got = mesh_job
    want, mine = ref[name], got[name]
    np.testing.assert_allclose(float(mine["grad_norm"]), want["grad_norm"],
                               rtol=1e-5)
    _hold_step(name, want["losses"], mine, want["grads"], want["before"],
               want["after"])


# ---------------------------------------------------------------------------
# the train CLI under torchrun
# ---------------------------------------------------------------------------


def test_train_cli_under_torchrun_resumes_in_one_process(tmp_path, capsys):
    """--cpu --dp 2 under torch.distributed.run: two steps, a whole-model
    checkpoint from rank 0; a single-process --resume restores it and its
    next step's loss is the mesh's."""
    from inklayer_tpu_torch.io.checkpoint import load_params

    ckpt = str(tmp_path / "ckpt")
    argv = ["--task", "gdino", "--synthetic", "2", "--image_size", "64",
            "--batch", "2", "--cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "inklayer_tpu_torch.scripts.train",
         *argv, "--dp", "2", "--steps", "3", "--ckpt", ckpt,
         "--ckpt_every", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = [l for l in res.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2 and res.stdout.count("done.") == 1, res.stdout
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3"]
    mesh_loss3 = float(lines[-1].split()[3])
    saved = load_params(os.path.join(ckpt, "step_2"))
    resumed = cli.main(argv + ["--steps", "0", "--resume",
                               os.path.join(ckpt, "step_2")])
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    capsys.readouterr()
    cli.main(argv + ["--steps", "1", "--resume",
                     os.path.join(ckpt, "step_2")])
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("step")][0]
    np.testing.assert_allclose(float(line.split()[3]), mesh_loss3,
                               rtol=1e-4)
