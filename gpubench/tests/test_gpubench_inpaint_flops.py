"""The inpainting configuration's FLOP arithmetic and K7's: hand counts at
small shapes, the kernel's bounds at the production shapes, the
configuration's counts against PyTorch's FLOP counter over the reference
at tiny widths, and the published count of a guided step."""

import copy
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.manifest import ROOT, Manifest, load_json
from gpubench.peaks import bound_s
from gpubench.reference.diffusion.controlnet import ControlNet
from gpubench.reference.diffusion.unet import UNet
from gpubench.reference.diffusion.vae import AutoencoderKL

M = Manifest()
FLASH = M.flops("flash_attention")
CFG = M.flops("inklayer-inpaint-sd15")
CONFIG = load_json(os.path.join(ROOT, "gpubench/configs/"
                                "inklayer-inpaint-sd15.json"))


def tiny() -> dict:
    cfg = copy.deepcopy(CONFIG)
    m = cfg["models"]
    for net in ("unet", "controlnet"):
        m[net].update(block_channels=[8, 16, 16, 16], context_dim=16,
                      num_heads=2)
    m["vae"].update(channels=[8, 8, 8, 8])
    m["text"].update(hidden=16, heads=1, max_len=16)
    cfg.update(resolution=64, num_steps=2)
    return cfg


def test_flash_attention_small_shape():
    s = {"bh": 2, "n": 4, "d": 8}
    # q k^T and p v: 2 * (2 * 4 * 4 * 8) multiply-adds each way
    assert FLASH.ops(s) == 2 * 2 * (2 * 4 * 4 * 8)
    # q, k, v, out: 4 * (2 * 4 * 8), bf16
    assert FLASH.bytes_moved(s) == 2 * 4 * 64


@pytest.mark.parametrize("shape,ms", [
    # the bounds of PERF.md's kernel table (K7 at head dims 40 and 80)
    ({"bh": 16, "n": 9216, "d": 40}, 0.2199),
    ({"bh": 16, "n": 2304, "d": 80}, 0.0275),
])
def test_flash_attention_bounds(shape, ms):
    assert bound_s(FLASH.ops(shape), FLASH.bytes_moved(shape)) * 1e3 == \
        pytest.approx(ms, abs=1e-4)


def _counted(fn) -> int:
    """FLOPs per sample of ``fn``, which runs a batch of two (GroupNorm
    refuses one value per group, and the tiny UNet's last level is 1 x
    1)."""
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            fn()
    return counter.get_total_flops() / 2


@pytest.mark.parametrize("part", ["unet", "controlnet", "vae_encode",
                                  "vae_decode"])
def test_counts_equal_the_flop_counter(part):
    cfg = tiny()
    m = cfg["models"]
    size = cfg["resolution"]
    lat = size // 8
    text = m["text"]["max_len"]
    t = torch.tensor([500, 20])
    ctx = torch.randn(2, text, m["unet"]["context_dim"])
    if part == "unet":
        net = UNet(**m["unet"])
        got = _counted(lambda: net(torch.randn(2, 9, lat, lat), t, ctx))
        want = CFG.unet(m["unet"], lat, text)
    elif part == "controlnet":
        net = ControlNet(**m["controlnet"])
        got = _counted(lambda: net(torch.randn(2, 4, lat, lat), t, ctx,
                                   torch.rand(2, 3, size, size), 1.0))
        want = CFG.controlnet(m["controlnet"], lat, text)
    elif part == "vae_encode":
        vae = AutoencoderKL(**m["vae"])
        got = _counted(lambda: vae.encode(torch.rand(2, 3, size, size)))
        want = CFG.vae_encode(m["vae"], size)
    else:
        vae = AutoencoderKL(**m["vae"])
        got = _counted(lambda: vae.decode(torch.randn(2, 4, lat, lat)))
        want = CFG.vae_decode(m["vae"], size)
    assert want == got


def test_per_call_is_its_parts():
    cfg = tiny()
    m = cfg["models"]
    parts = CFG.per_call(cfg, 4)
    assert parts["unet"] == 2 * 4 * 2 * CFG.unet(m["unet"], 8, 16)
    assert parts["vae_decode"] == 4 * CFG.vae_decode(m["vae"], 64)
    assert CFG.per_unit(cfg, {"batch": 3}) == sum(parts.values())


def test_published_step():
    # profile_diffusion's count: 5.84 TFLOP for one guided step (2 samples)
    # at 768^2
    parts = CFG.per_call(CONFIG, 1)
    step = (parts["unet"] + parts["controlnet"]) / CONFIG["num_steps"]
    assert step / 1e12 == pytest.approx(5.84, rel=0.01)


def test_flash_launches():
    shapes = CFG.kernel_launches(CONFIG, {"batch": 4})["flash_attention"]
    # per step: UNet 2 down + 3 up, ControlNet 2, on each of the 96^2 and
    # 48^2 levels; 24^2 = 576 keys take the library's attention
    assert len(shapes) == 30 * 14
    assert shapes.count({"bh": 64, "n": 9216, "d": 40}) == 30 * 7
    assert shapes.count({"bh": 64, "n": 2304, "d": 80}) == 30 * 7
