"""The port's diagnostic scripts (``inklayer_tpu_torch/scripts``:
``profile_pipeline``, ``analyze_sweep_stalls4``, ``profile_sam_decode``,
``ablate_gdino``, ``profile_gdino_roofline``, ``profile_sam``,
``profile_gdino``, ``profile_diffusion``) and the attribution pieces of
``profiling`` they share, on the CPU at tiny widths:

* every host key a script patches records calls on one run and on one
  2-sketch ``run_dir`` (a name patched where the runner does not look it
  up would read 0), except the two waits on the card, which the CPU path
  never calls; after the context, every patched name is the original
  object again, also when the body raised;
* ``classify`` puts every row in one class: the classes add up to the
  rows' total;
* ``msda_flops(GDinoConfig())`` equals the JAX script's expression
  (``scripts/profile_gdino_roofline.py:88-98``) evaluated on the JAX
  package's ``GDinoConfig()``;
* ``ablate_gdino``'s parts count no more FLOPs together than the whole
  forward;
* each script's ``main(["--device", "cpu", ...])`` returns every key of
  its JSON line, with the CPU's name and a null power limit;
* a trace is held to the launch counters (``check_port_events`` on the
  port's kernel names as the card's traces give them), and
  ``device_profile`` / ``device_profile_stages`` take an incomplete trace
  again, each stage held to its own launches;
* ``build.diffusion_modules`` under constant weights makes the modules
  ``build_diffusion_models`` makes.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import inklayer_tpu.config as J
from inklayer_tpu_torch import config as T
from inklayer_tpu_torch import profiling
from inklayer_tpu_torch.build import (build_diffusion_models, build_pipeline,
                                      init_placeholder_params)
from inklayer_tpu_torch.models.diffusion import ControlNetInpaintPipeline
from inklayer_tpu_torch.models.gdino import GroundingDINO
from inklayer_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from inklayer_tpu_torch.runtime import constant_model
from inklayer_tpu_torch.scripts import (ablate_gdino, analyze_sweep_stalls4,
                                        profile_diffusion, profile_gdino,
                                        profile_gdino_roofline,
                                        profile_pipeline, profile_sam,
                                        profile_sam_decode)
from tests.test_diffusion import TINY as TINY_DIFFUSION
from tests.test_self_golden import _sketch
from tests.test_torch_bench import _gdino, _tiny_pipeline_config

CPU = ["--device", "cpu"]
BUCKET = 64


@pytest.fixture(scope="module")
def pipe():
    """The port's default run at TINY widths with box threshold 0 and
    seeded weights under which NMS keeps some masks (SAM at std 0.5, as
    tests/test_torch_pipeline.py)."""
    cfg = _tiny_pipeline_config()
    cfg = dataclasses.replace(cfg, gdino=dataclasses.replace(
        cfg.gdino, box_threshold=0.0))
    p = build_pipeline(cfg, device="cpu", dtype=torch.float32)
    init_placeholder_params(p.detector.model, 2, 0.2)
    init_placeholder_params(p.sam.model, 1, 0.5)
    return p


@pytest.fixture(scope="module")
def sketch(tmp_path_factory):
    return _sketch(tmp_path_factory.mktemp("diag"))


@pytest.fixture(scope="module")
def gdino():
    return constant_model(lambda: GroundingDINO(_gdino(T)),
                          torch.device("cpu"), torch.float32)


def _keys_called(host, keys, skip=()):
    want = {k for _, _, k, w in keys for k in (k, w) if k} - set(skip)
    assert want <= set(host), sorted(want - set(host))
    assert all(host[k]["calls"] > 0 for k in want), host


MISSING = object()


def _names(keys):
    """What each namespace binds (an instance binds nothing of its own: its
    method is its class's)."""
    return [(t, n, vars(t).get(n, MISSING)) for t, n, _, _ in keys]


def _restored(before):
    return all(vars(t).get(n, MISSING) is orig for t, n, orig in before)


def _finite(res, keys):
    for k in keys:
        assert k in res, k
        v = res[k]
        if isinstance(v, float):
            assert math.isfinite(v), (k, v)


def test_profile_pipeline_keys_are_called_and_restored(pipe, sketch):
    """One run: every key of the default mode records calls, with and
    without the intermediates; the names are the originals again after."""
    for extra in ([], ["--intermediate"]):
        keys = profile_pipeline.host_keys(pipe, bool(extra))
        before = _names(keys)
        res = profile_pipeline.main(
            CPU + ["--iters", "1", "--img", sketch] + extra, pipe=pipe)
        _keys_called(res["host"], keys)
        assert _restored(before)
        _finite(res, ("iters", "run_ms", "run_ms_mean", "stage_ms", "host",
                      "thread_clock_step_ms", "trace", "card",
                      "power_limit_w"))
        assert res["power_limit_w"] is None and res["trace"] is None
        assert set(res["stage_ms"]) == set(pipe.stage_times)
        # the writes run on the writer threads, the run on this one
        assert res["host"]["save_png"]["threads"] == ["writer"]
        assert res["host"]["detect_device"]["threads"] == ["run"]


def test_sweep_keys_are_called_and_restored(pipe, sketch):
    """One 2-sketch run_dir per timed sweep: every key but the card's two
    waits records calls; the attributed CPU is within the process's."""
    keys = analyze_sweep_stalls4.sweep_keys(pipe, 1)
    before = _names(keys)
    res = analyze_sweep_stalls4.main(
        CPU + ["--n", "2", "--reps", "1", "--img", sketch], pipe=pipe)
    _keys_called(res["host"], keys, skip=analyze_sweep_stalls4.WAIT_KEYS)
    assert _restored(before)
    assert vars(torch.cuda.Stream)["synchronize"] is before[-2][2]
    _finite(res, ("n", "reps", "workers", "batch", "device_front",
                  "wall_ms_per_img", "sketches_per_s", "busy_ms_per_img",
                  "occupancy", "ceiling_sketches_per_s", "cpu_ms_per_img",
                  "cpu_share_one_core", "cpu_share_all_cores", "cpu_count",
                  "syncs_per_img", "host", "thread_clock_step_ms",
                  "attributed_cpu_ms_per_img",
                  "unattributed_cpu_ms_per_img", "card", "power_limit_w"))
    assert res["n"] == 2 and res["busy_ms_per_img"] is None
    assert 0 < res["attributed_cpu_ms_per_img"] <= res["cpu_ms_per_img"]
    # the one-worker sweep decodes the next image on its decode thread
    assert "pool" in res["host"]["decode_image"]["threads"]


def test_patch_restores_on_error_and_refuses_static_methods(pipe):
    class Ns:
        @staticmethod
        def s():
            return 1

    acct = profiling.HostAccount()
    det, orig = pipe.detector, type(pipe.detector).detect_device
    with pytest.raises(RuntimeError):
        with profiling.patch(det, "detect_device", "d", acct):
            assert "detect_device" in vars(det)
            raise RuntimeError("body failed")
    assert "detect_device" not in vars(det)
    assert type(det).detect_device is orig
    with pytest.raises(TypeError):
        with profiling.patch(Ns, "s", "s", acct):
            pass
    assert Ns.s() == 1


def test_host_account_times_the_returned_wait():
    acct = profiling.HostAccount()
    start = acct.wrap("rb", lambda x: (lambda: x + 1), wait_key="rb.wait")
    wait = start(1)
    assert acct.calls == {"rb": 1}
    assert wait() == 2 and acct.calls == {"rb": 1, "rb.wait": 1}
    table = acct.table(per=2, kind=lambda ident: "me")
    assert table["rb"]["calls"] == 0.5 and table["rb"]["threads"] == ["me"]


def test_classify_sums_to_the_total():
    rng = np.random.default_rng(0)
    names = ["void attention_tile_kernel<64, false>(Args)",
             "void gemm_bias_act_kernel<256, true>(Args)",
             "void layernorm_kernel<128>(Args)",
             "void ms_deform_attn_kernel<32>(Args)", "cc_local", "cc_keep",
             "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32",
             "nvjet_tst_128x256_64x4_1x2_h_bz_coopB_TNT",
             "void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm>",
             "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::GeluCUDAKernelImpl>",
             "void at::native::elementwise_kernel<128, 2, "
             "direct_copy_kernel_cuda>",
             "void at::native::reduce_kernel<512, 1>",
             "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel",
             "fmha_cutlassF_bf16_aligned_64x64_rf_sm80",
             "Memcpy HtoD (Pageable -> Device)", "some_unknown_kernel"]
    rows = [(n, float(rng.random()), int(rng.integers(1, 9))) for n in names]
    classes = profiling.classify(rows)
    assert math.isclose(sum(c[1] for c in classes), sum(r[1] for r in rows))
    assert sum(c[2] for c in classes) == sum(r[2] for r in rows)
    by = {c[0]: c for c in classes}
    assert by["other"][3] == ["some_unknown_kernel"]
    assert by["port: components"][2] == rows[4][2] + rows[5][2]
    assert "sm90_xmma_fprop" in by["convolution (cuDNN)"][3][0]
    assert len(by["GEMM (cuBLAS/CUTLASS)"][3]) == 2
    assert "direct_copy" in by["copy/layout"][3][0]
    assert list(by) == [c[0] for c in sorted(classes, key=lambda c: -c[1])]


def test_msda_flops_equals_the_jax_expression():
    cfg = J.GDinoConfig()
    # scripts/profile_gdino_roofline.py:88-98, on the JAX package's config
    lvl_hw = [(100, 100), (50, 50), (25, 25), (13, 13)]
    nq_enc = sum(h * w for h, w in lvl_hw)
    hd = cfg.hidden_dim // cfg.nheads
    samples = cfg.nheads * cfg.num_feature_levels * cfg.enc_n_points
    per_query = samples * 4 * hd * 2 * 2
    deform_enc = cfg.enc_layers * nq_enc * per_query
    deform_dec = cfg.dec_layers * cfg.num_queries * samples * 4 * hd * 2 * 2
    want = deform_enc + deform_dec
    assert profile_gdino_roofline.msda_flops(T.GDinoConfig()) == want
    assert want > 0


def test_ablate_gdino_parts_count_within_the_forward(gdino, monkeypatch):
    monkeypatch.setattr(ablate_gdino, "BUCKET", BUCKET)
    monkeypatch.setattr(ablate_gdino, "WARM_CALLS", 0)
    res = ablate_gdino.main(CPU + ["--iters", "1"], model=gdino)
    parts = res["parts"]
    assert set(parts) == {"full", "swin", "bert", "transformer"}
    for row in parts.values():
        _finite(row, ("p50_ms", "first_s", "device_ms", "traced_wall_ms",
                      "gflop"))
        assert row["gflop"] > 0 and row["device_ms"] is None
    assert sum(parts[k]["gflop"] for k in ("swin", "bert", "transformer")) \
        <= parts["full"]["gflop"]
    _finite(res, ("bucket", "iters", "card", "power_limit_w"))
    assert res["bucket"] == BUCKET


def test_roofline_main_on_the_cpu(gdino, monkeypatch):
    monkeypatch.setattr(profile_gdino_roofline, "BUCKET", BUCKET)
    res = profile_gdino_roofline.main(CPU + ["--iters", "1"], model=gdino)
    _finite(res, ("bucket", "iters", "p50_ms", "first_s", "rtt_ms",
                  "counted_gflop", "msda_gflop", "total_gflop",
                  "peak_share_wall", "device_ms", "traced_wall_ms", "op_ms",
                  "peak_share_device", "top_kernels", "classes", "card",
                  "power_limit_w"))
    assert res["msda_gflop"] == pytest.approx(
        profile_gdino_roofline.msda_flops(gdino.cfg, BUCKET) / 1e9)
    assert res["total_gflop"] == pytest.approx(res["counted_gflop"]
                                               + res["msda_gflop"])
    assert res["classes"] is None  # no device trace on the CPU


def test_profile_sam_decode_main_on_the_cpu(pipe):
    res = profile_sam_decode.main(CPU + ["--cap", "16", "--hw", "96",
                                         "--calls", "1"], pipe=pipe)
    assert set(res["pieces"]) == {"encode", "decode", "masks_n16",
                                  "masks_n8", "pack_bits", "decode_to_masks"}
    for row in res["pieces"].values():
        assert row["p50_ms"] > 0 and row["device_ms"] is None
    _finite(res, ("cap", "hw", "calls", "rtt_ms", "pieces_sum_ms",
                  "segment_stage_ms", "segment_boxes", "card",
                  "power_limit_w"))
    assert res["segment_boxes"] > 0 and res["segment_stage_ms"] > 0


def test_profile_sam_and_gdino_main_on_the_cpu(pipe, sketch):
    model = constant_model(lambda: ImageEncoderViT(
        img_size=128, embed_dim=32, depth=2, num_heads=2,
        global_attn_indexes=(1,)), torch.device("cpu"), torch.float32)
    keys = ("iters", "first_s", "warm_ms", "traced_wall_ms", "busy_ms",
            "op_ms", "device_ops", "kernels", "card", "power_limit_w")
    res = profile_sam.main(CPU + ["--iters", "1"], model=model)
    _finite(res, keys + ("depth",))
    assert res["depth"] == 2 and res["warm_ms"] > 0
    res = profile_gdino.main(CPU + ["--iters", "1", "--img", sketch],
                             detector=pipe.detector)
    _finite(res, keys)
    assert res["warm_ms"] > 0 and res["kernels"] is None


def test_profile_diffusion_main_on_the_cpu(capsys):
    dcfg = dataclasses.replace(TINY_DIFFUSION, num_steps=2)
    dpipe = ControlNetInpaintPipeline(build_diffusion_models(
        T.PipelineConfig(diffusion=dcfg), "cpu", torch.float32), dcfg)
    res = profile_diffusion.main(CPU + ["--steps", "2"], pipe=dpipe)
    _finite(res, ("steps", "res", "batch", "first_s", "wall_ms_per_pass",
                  "ms_per_step", "stage_ms", "gflop_step", "gflop_text",
                  "gflop_vae", "tflop_pass", "peak_share_wall", "trace",
                  "card", "power_limit_w"))
    assert set(res["stage_ms"]) == {"encode", "loop", "decode"}
    assert res["gflop_step"] > 0 and res["gflop_vae"] > 0
    assert res["gflop_text"] > 0
    # a pass: the text encoder, the VAE and 2 steps
    assert res["tflop_pass"] * 1e3 == pytest.approx(
        res["gflop_text"] + res["gflop_vae"] + 2 * res["gflop_step"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(res))


# the port's kernels as the card's traces name them, and library kernels
# whose names come close
TRACED = {
    "void (anonymous namespace)::attention_tile_kernel<80, true>"
    "(CUtensorMap, CUtensorMap, CUtensorMap, float const*)": 3,
    "void (anonymous namespace)::attention_tile_kernel<64, false>"
    "(CUtensorMap, CUtensorMap, CUtensorMap, float const*)": 2,
    "void (anonymous namespace)::gemm_bias_act_kernel<256, true>"
    "(CUtensorMap, CUtensorMap, __nv_bfloat16 const*)": 4,
    "void (anonymous namespace)::gemm_bias_act_kernel<160, false>"
    "(CUtensorMap, CUtensorMap, __nv_bfloat16 const*)": 4,
    "void (anonymous namespace)::layernorm_kernel<__nv_bfloat16, 5>"
    "(__nv_bfloat16 const*, __nv_bfloat16 const*)": 7,
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
    "<float, float, false>(int, float, float const*)": 9,
    "void (anonymous namespace)::ms_deform_attn_kernel<__nv_bfloat16>"
    "(__nv_bfloat16 const*, (anonymous namespace)::Levels)": 2,
    "(anonymous namespace)::cc_local(unsigned char const*, int*, "
    "(anonymous namespace)::Cell*, (anonymous namespace)::Shape)": 3,
    "(anonymous namespace)::cc_border(unsigned char const*, int*, "
    "(anonymous namespace)::Shape, long)": 3,
    "void (anonymous namespace)::cc_finish<true>(unsigned char const*, "
    "int*, (anonymous namespace)::Cell*, (anonymous namespace)::Shape)": 2,
    "(anonymous namespace)::cc_keep(int const*, (anonymous namespace)::"
    "Cell const*, unsigned char*, (anonymous namespace)::Shape, long)": 2,
    "void (anonymous namespace)::conv3x3_kernel<192>(CUtensorMap, "
    "CUtensorMap, __nv_bfloat16*, float*, (anonymous namespace)::ConvGeom)":
    1,
    "(anonymous namespace)::conv3x3_reduce_kernel(float const*, "
    "__nv_bfloat16*, (anonymous namespace)::ConvGeom, int)": 1,
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": 5,
}
LAUNCHED = {"relpos_attention": 3, "flash_attention": 2,
            "flash_attention/d64": 2, "mlp_gelu": 4, "layernorm": 7,
            "ms_deform_attn": 2, "connected_components": 1,
            "clean_components": 2, "conv3x3": 1}


def test_a_trace_is_held_to_the_launch_counters():
    """Each launch counter's kernels are found in the trace by name (the
    MLP's two GEMMs a launch, the components' first pass for both labelling
    entry points, the keep pass for cleaning only); a kernel missing from
    the trace or one too many fails it, whichever it is."""
    profiling.check_port_events(TRACED, LAUNCHED)
    profiling.check_port_events({}, {})
    for name in TRACED:
        if name.startswith(("sm90", "void at::", "(anonymous namespace)::"
                            "cc_border", "void (anonymous namespace)::"
                            "cc_finish", "(anonymous namespace)::conv3x3_re")):
            continue
        for delta in (-1, 1):
            with pytest.raises(profiling.IncompleteTrace):
                profiling.check_port_events(
                    {**TRACED, name: TRACED[name] + delta}, LAUNCHED)
    with pytest.raises(profiling.IncompleteTrace, match="gemm_bias_act"):
        profiling.check_port_events(TRACED, {**LAUNCHED, "mlp_gelu": 3})
    assert issubclass(profiling.NoDeviceActivity, profiling.IncompleteTrace)


@pytest.fixture
def fake_trace(monkeypatch):
    """``device_profile`` on the CPU: no profiler, no card; ``_summary``
    returns what it was given, after raising IncompleteTrace for the first
    ``bad[0]`` traces.  The launch counters are put back after."""
    import contextlib

    from inklayer_tpu_torch import _kernels

    seen, bad = [], [0]

    def summary(prof, wall_us, top, launched):
        seen.append(launched)
        if len(seen) <= bad[0]:
            raise profiling.IncompleteTrace(f"trace {len(seen)}")
        return {"wall_ms": wall_us / 1e3, "launched": launched}

    monkeypatch.setattr(profiling, "_trace", contextlib.nullcontext)
    monkeypatch.setattr(profiling, "_summary", summary)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "retraced", [])
    monkeypatch.setattr(profiling, "TRACE_MARGIN_S", 0.0)
    monkeypatch.setattr(_kernels, "LAUNCHES", dict(_kernels.LAUNCHES))
    return seen, bad


def test_an_incomplete_trace_is_taken_again(fake_trace):
    from inklayer_tpu_torch import _kernels

    seen, bad = fake_trace
    calls = []

    def fn():
        calls.append(1)
        _kernels.count_launch("layernorm")

    bad[0] = profiling.TRACE_ATTEMPTS - 1
    res = profiling.device_profile(fn)
    assert len(calls) == profiling.TRACE_ATTEMPTS
    assert res["launched"]["layernorm"] == 1
    assert all(s["layernorm"] == 1 and s["mlp_gelu"] == 0 for s in seen)
    assert profiling.retraced == [f"trace {i}" for i in range(1, len(calls))]
    seen.clear()
    bad[0] = profiling.TRACE_ATTEMPTS
    with pytest.raises(profiling.IncompleteTrace):
        profiling.device_profile(fn)
    assert len(seen) == profiling.TRACE_ATTEMPTS


def test_each_stage_is_held_to_its_own_launches(fake_trace):
    """``device_profile_stages`` counts the launches of each stage apart,
    traces the whole call again when a stage is incomplete, and puts the
    split method back."""
    from inklayer_tpu_torch import _kernels

    seen, bad = fake_trace

    class Sampler:
        def add_time(self, key):
            return key

    sampler = Sampler()

    def fn():
        _kernels.count_launch("layernorm")
        sampler.add_time("encode")
        for _ in range(3):
            _kernels.count_launch("flash_attention", "d40")
        sampler.add_time("loop")

    bad[0] = 1
    stages = profiling.device_profile_stages(fn, sampler, "add_time")
    assert set(stages) == {"encode", "loop"}
    assert stages["encode"]["launched"]["layernorm"] == 1
    assert stages["encode"]["launched"]["flash_attention"] == 0
    assert stages["loop"]["launched"]["flash_attention"] == 3
    assert stages["loop"]["launched"]["layernorm"] == 0
    assert len(profiling.retraced) == 1 and "add_time" not in vars(sampler)


def test_diffusion_modules_are_the_built_ones():
    """chip_smoke's constant-weight diffusion models and
    ``build_diffusion_models`` make the same modules in the same layout."""
    from inklayer_tpu_torch.build import diffusion_layout, diffusion_modules

    cfg = T.PipelineConfig(diffusion=TINY_DIFFUSION)
    built = build_diffusion_models(cfg, "cpu", torch.float32)
    const = {name: diffusion_layout(name, constant_model(
        make, torch.device("cpu"), torch.float32))
        for name, make in diffusion_modules(cfg.diffusion).items()}
    assert list(built) == list(const) == ["text", "unet", "controlnet",
                                          "vae"]
    for name, model in built.items():
        want = {k: (v.shape, v.stride())
                for k, v in model.state_dict().items()}
        got = {k: (v.shape, v.stride())
               for k, v in const[name].state_dict().items()}
        assert got == want, name
