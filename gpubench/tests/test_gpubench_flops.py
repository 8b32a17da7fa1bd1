"""The FLOP and byte arithmetic: hand counts at one small shape, the
kernels' bounds at the production shapes, and the configuration's counts
against PyTorch's FLOP counter over the reference at tiny widths."""

import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.entries import models
from gpubench.manifest import ROOT, Manifest, load_json
from gpubench.peaks import bound_s

M = Manifest()
RELPOS = M.flops("relpos_attention")
GEMM = M.flops("linear_bias_act")
CFG = M.flops("inklayer-default")


def test_relpos_attention_small_shape():
    s = {"bh": 2, "n": 4, "d": 8, "kh": 2, "kw": 2}
    # q k^T and p v: 2 * (2 * 4 * 4 * 8) multiply-adds each way
    assert RELPOS.ops(s) == 2 * 2 * (2 * 4 * 4 * 8)
    # q, k, v, out: 4 * (2 * 4 * 8); rel_h, rel_w: 2 * (2 * 4 * 2); bf16
    assert RELPOS.bytes_moved(s) == 2 * (4 * 64 + 2 * 16)


def test_linear_bias_act_small_shape():
    s = {"m": 4, "k": 8, "h": 16, "n": 8}
    assert GEMM.ops(s) == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 8
    fc1 = 4 * 8 + 16 * 8 + 16 + 4 * 16
    fc2 = 4 * 16 + 8 * 16 + 8 + 4 * 8
    assert GEMM.bytes_moved(s) == 2 * (fc1 + fc2)


@pytest.mark.parametrize("arith,shape,ms", [
    # the bounds of PERF.md's kernel table (K1, K2, K3)
    ("relpos", {"bh": 400, "n": 196, "d": 80, "kh": 14, "kw": 14}, 0.0163),
    ("relpos", {"bh": 16, "n": 4096, "d": 80, "kh": 64, "kw": 64}, 0.0869),
    ("gemm", {"m": 4096, "k": 1280, "h": 5120, "n": 1280}, 0.1086),
])
def test_bounds_at_production_shapes(arith, shape, ms):
    a = RELPOS if arith == "relpos" else GEMM
    assert bound_s(a.ops(shape), a.bytes_moved(shape)) * 1e3 == \
        pytest.approx(ms, abs=1e-4)


def test_published_counts():
    cfg = load_json(os.path.join(ROOT, "gpubench/configs/"
                                 "inklayer-default.json"))
    per = CFG.per_sketch(cfg, (750, 750), 64)
    # PyTorch's counter over the port at 800^2 read 499.2 GFLOP (it also
    # counts the resampling products this count leaves out)
    assert per["gdino"] / 1e9 == pytest.approx(499.2, rel=0.01)
    # bench_sam_vith: 0.2204 of 989 TFLOP/s over 27.342 ms
    assert per["sam_encode"] / 1e12 == pytest.approx(
        0.2204 * 989 * 27.342e-3, rel=0.01)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_sam_encode_against_the_flop_counter():
    cfg = load_json(os.path.join(os.path.dirname(__file__), "data",
                                 "tiny.json"))
    make = models.reference_makers(cfg)["sam"]
    torch.manual_seed(0)
    sam = make().eval().requires_grad_(False)
    s = cfg["models"]["sam"]
    x = torch.randn(1, s["image_size"], s["image_size"], 3)
    with torch.no_grad():
        counted = _counted(lambda: sam.encode(x))
    assert CFG.sam_encode(s) == counted


def test_kernel_launches_of_a_request():
    cfg = load_json(os.path.join(ROOT, "gpubench/configs/"
                                 "inklayer-default.json"))
    b4 = M.cell("default.models-b4").traffic
    k = CFG.kernel_launches(cfg, b4)
    assert len(k["relpos_attention"]) == 32 and len(k["linear_bias_act"]) == 32
    glob = [s for s in k["relpos_attention"] if s["n"] == 4096]
    assert len(glob) == 4 and glob[0]["bh"] == 64
    assert k["linear_bias_act"][0]["m"] == 4 * 4096
