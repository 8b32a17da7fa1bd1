"""Entry ``inpaint``: ``main.py --inpaint``'s completion of one sketch's
occluded layers, through ``Inpainter.complete`` and the batched diffusion
backend (``ControlNetInpaintPipeline.inpaint_batch_fn``).

A request is one scene of five depth-ordered layers built from the
request's sketches (:func:`scene`): a seeded ellipse outline in front, and
behind it the request's sketches, each cropped at full scale into its own
quadrant of the canvas.  ``Inpainter.complete`` assembles the five layers,
inpaints the four the ellipse occludes in one bucket of four (UNet and
ControlNet at eight samples a solver step), and composites the original
ink back; the request's output is one unit, the sketch with its completed
layers.  Besides the generator's keys, the traffic file gives ``scene``
(the front ellipse: ``front_centre`` and ``front_axes`` as shares of the
side, ``front_px`` its outline's width).

The sampler records its state on the timed path
(``ControlNetInpaintPipeline.record``: references to the tensors each call
made, not copies), and the request returns it with its output, so only the
window's sampled request keeps it.  The check (:func:`judge`) holds that
state to a plain fp32 reference (``gpubench/reference/diffusion``):

* ``ts_gap``: the timesteps the UNet was given against the reference's
  schedule;
* ``solver_gap``: over every step, the L2 distance of the program's next
  latent from the reference's update (in float64) of the recorded latent
  and noise prediction, relative to the part of that update the noise
  prediction makes (so a prediction 1% off in the update reads 0.01 at any
  step);
* ``cfg_gap``: over every step, the relative L2 distance of the program's
  guided noise prediction from the configuration's guidance (in float64)
  of the UNet's two recorded predictions;
* ``eps_rel_l2``: on three seeded steps (the first and the last among
  them) of one seeded layer, the reference's ControlNet, UNet and guidance
  from the recorded latent, with its own text embeddings, masked-image
  encoding, mask and control image, against the program's noise
  prediction;
* ``edit_gap``: the share of pixels of the layers' images and edit masks
  that differ from a plain assembly of the scene's masks and sketch
  (``prepost.assemble``: silhouettes by ``scipy.ndimage``), exactly;
* ``input_gap``: the inputs of step 0 that no model makes, exactly: the
  latent and mask channels of the UNet's nine and the control image,
  against the reference's own rounded to the program's dtype;
* ``decode_rel_l1``: the reference's VAE decoding of the seeded layer's
  final latent against the program's image of it;
* ``layer_gap``: the share of pixels of the program's completed layers
  that differ from the reference's post-processing and composite of the
  program's images.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image, ImageDraw
from torch.profiler import record_function

from gpubench import weights
from gpubench.entries.models import _free, serving_dtype

SEED_OFFSETS = {"text": 0, "unet": 1, "controlnet": 2, "vae": 3}
# solver steps of a set-up request: every step has the same shapes
WARMUP_STEPS = 2


def _seed(seed: int, model: str) -> int:
    return (seed * 8 + SEED_OFFSETS[model]) % (1 << 63)


def reference_makers(config: dict) -> dict:
    """{model: constructor} of the reference's modules at the
    configuration's widths (the weights' schema)."""
    from gpubench.reference.diffusion.clip import CLIPTextEncoder
    from gpubench.reference.diffusion.controlnet import ControlNet
    from gpubench.reference.diffusion.unet import UNet
    from gpubench.reference.diffusion.vae import AutoencoderKL

    m = config["models"]
    return {"text": lambda: CLIPTextEncoder(**m["text"]),
            "unet": lambda: UNet(**m["unet"]),
            "controlnet": lambda: ControlNet(**m["controlnet"]),
            "vae": lambda: AutoencoderKL(**m["vae"])}


def seeded_state(config: dict, model: str, seed: int, device, dtype):
    makers = reference_makers(config)
    scale = config.get("norm_scale", {}).get(model, 1.0)
    return weights.seeded_state_dict(weights.schema(makers[model], scale),
                                     _seed(seed, model), device, dtype)


def diffusion_config(config: dict):
    """The program's ``DiffusionConfig`` of a configuration file; raises
    where the file asks for a width the program's modules do not take as
    an argument and do not have (the rest is held by the weights' strict
    load)."""
    from inklayer_tpu_torch.config import DiffusionConfig
    from inklayer_tpu_torch.models.diffusion import vae

    m = config["models"]
    u, t = m["unet"], m["text"]
    if t["heads"] != max(1, t["hidden"] // 64):
        raise ValueError(f"the program's text encoder has hidden // 64 "
                         f"heads, the configuration asks for {t['heads']}")
    if m["vae"]["scaling_factor"] != vae.SCALING_FACTOR:
        raise ValueError("the program's VAE scales latents by "
                         f"{vae.SCALING_FACTOR}")
    return DiffusionConfig(
        resolution=config["resolution"], num_steps=config["num_steps"],
        guidance_scale=config["guidance_scale"],
        controlnet_scale=config["controlnet_scale"], seed=config["seed"],
        num_passes=config["num_passes"], prompt=config["prompt"],
        negative_prompt=config["negative_prompt"],
        unet_block_channels=tuple(u["block_channels"]),
        unet_layers_per_block=u["layers_per_block"],
        unet_attention_head_dim=u["num_heads"],
        cross_attention_dim=u["context_dim"],
        latent_channels=m["vae"]["latent_channels"],
        vae_channels=tuple(m["vae"]["channels"]), text_maxlen=t["max_len"])


# --------------------------------------------------------------------------
# the scene
# --------------------------------------------------------------------------


def hull(points) -> list:
    """The convex hull of integer (x, y) points, counter-clockwise
    (Andrew's monotone chain)."""
    pts = sorted(set(map(tuple, points)))
    if len(pts) < 3:
        return pts

    def half(seq):
        out = []
        for x, y in seq:
            while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (y - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (x - out[-2][0])) <= 0:
                out.pop()
            out.append((x, y))
        return out[:-1]

    return half(pts) + half(pts[::-1])


def filled_hull(ink: np.ndarray) -> np.ndarray:
    """The filled convex hull of a bool image's True pixels."""
    region = Image.new("L", ink.shape[::-1], 0)
    rows = np.nonzero(ink.any(1))[0]
    # the hull of the pixels is the hull of each row's two ends
    lo = ink[rows].argmax(1)
    hi = ink.shape[1] - 1 - ink[rows, ::-1].argmax(1)
    pts = np.concatenate([np.stack([lo, rows], 1),
                          np.stack([hi, rows], 1)]).tolist()
    ImageDraw.Draw(region).polygon(
        [(float(x), float(y)) for x, y in hull(pts)], fill=255, outline=255)
    return np.asarray(region) > 0


def _ink(rgb: np.ndarray) -> np.ndarray:
    """Where an (H, W, 3) uint8 image is not white."""
    return (rgb[..., 0] < 255) | (rgb[..., 1] < 255) | (rgb[..., 2] < 255)


def crop(sk: np.ndarray, q: int) -> np.ndarray:
    """Quadrant ``q``'s (top left, top right, bottom left, bottom right)
    half-size window of a sketch at full scale: the window that puts the
    sketch's innermost ink pixel (the one farthest towards the canvas's
    centre) on the quadrant's corner at the centre, white where it leaves
    the sketch."""
    h, w = sk.shape[:2]
    hh, hw = h // 2, w // 2
    ys, xs = np.nonzero(_ink(sk))
    dx, dy = (1 if q % 2 == 0 else -1), (1 if q < 2 else -1)
    k = int(np.argmax(dx * xs + dy * ys))
    x0 = xs[k] - (hw - 1 if dx > 0 else 0)
    y0 = ys[k] - (hh - 1 if dy > 0 else 0)
    out = np.full((hh, hw, 3), 255, np.uint8)
    sy, sx = slice(max(y0, 0), min(y0 + hh, h)), slice(max(x0, 0),
                                                       min(x0 + hw, w))
    out[sy.start - y0: sy.stop - y0, sx.start - x0: sx.stop - x0] = sk[sy, sx]
    return out


def scene(sketches: List[np.ndarray], seed: int, spec: dict):
    """(the five depth-ordered bool masks, front first; the composite
    (H, W, 3) uint8 sketch) of one request.

    Layer 0 is an ellipse outline ``front_px`` wide in front, centred in
    the canvas's middle fifth (``front_centre``: its range as shares of the
    side), with axes of ``front_axes`` of the side; its filled interior is
    its region.  Layers 1-4 are the request's sketches, each cropped at
    full scale into its own quadrant (:func:`crop`: its innermost ink on
    the canvas's centre, inside the ellipse), with the filled hull of its
    strokes less every region in front as its region: so every back
    layer's region reaches into the front region's box, which is what
    makes the program's assembly inpaint it.  The composite keeps each
    layer's ink inside its own region only, so the ellipse hides the inner
    corner of every sketch."""
    h, w = sketches[0].shape[:2]
    rng = np.random.default_rng(
        [seed % (1 << 63), zlib.crc32(sketches[0].tobytes())])
    cx, cy = rng.uniform(*spec["front_centre"], 2) * (w, h)
    ax, ay = rng.uniform(*spec["front_axes"], 2) * (w, h) / 2
    box = [cx - ax, cy - ay, cx + ax, cy + ay]
    region = Image.new("L", (w, h), 0)
    ImageDraw.Draw(region).ellipse(box, fill=255)
    canvas = Image.new("RGB", (w, h), (255, 255, 255))
    ImageDraw.Draw(canvas).ellipse(box, outline=(0, 0, 0),
                                   width=int(spec["front_px"]))
    masks = [np.asarray(region) > 0]
    layers = [np.asarray(canvas)]
    inks = [_ink(layers[0])]
    front = masks[0].copy()
    hh, hw = h // 2, w // 2
    for q, sk in enumerate(sketches):
        y0, x0 = (q // 2) * hh, (q % 2) * hw
        part = crop(sk, q)
        layer = np.full_like(sk, 255)
        layer[y0:y0 + hh, x0:x0 + hw] = part
        ink = np.zeros((h, w), bool)
        ink[y0:y0 + hh, x0:x0 + hw] = _ink(part)
        mask = filled_hull(ink) & ~front
        front |= mask
        masks.append(mask)
        layers.append(layer)
        inks.append(ink)
    composite = np.full_like(sketches[0], 255)
    for mask, layer, ink in zip(masks, layers, inks):
        keep = mask & ink
        composite[keep] = layer[keep]
    return masks, composite


# --------------------------------------------------------------------------
# the system and its requests
# --------------------------------------------------------------------------


@dataclasses.dataclass
class System:
    device: torch.device
    pipe: object         # ControlNetInpaintPipeline
    inpainter: object    # Inpainter
    seed: int
    spec: dict
    scenes: dict         # id()s of a request's sketches -> its scene
    steps_wrapped: int = 0  # inpaint.step spans put in gpubench/step


def build(cell, seed: int, device: torch.device, traffic=None) -> System:
    """The port's CLIP text encoder, UNet, ControlNet and VAE with seeded
    weights made on ``device`` and loaded by ``load_state_dict`` (strict),
    behind ``ControlNetInpaintPipeline`` and ``Inpainter`` as
    ``build_inpainter`` puts them; the scenes of the traffic's pool."""
    from inklayer_tpu_torch.build import diffusion_layout, diffusion_modules
    from inklayer_tpu_torch.models.diffusion import ControlNetInpaintPipeline
    from inklayer_tpu_torch.pipeline.inpaint.orchestrate import Inpainter

    cfg = diffusion_config(cell.config)
    dtype = serving_dtype(cell.config, device)
    models = {}
    for name, make in diffusion_modules(cfg).items():
        state = seeded_state(cell.config, name, seed, device, dtype)
        # made on the device, not on the meta device as weights.build
        # does: there nn.Embedding's initialisation and the move to the
        # device import torch's compiler and symbolic-shape stacks (~10 s
        # of set-up on the card's host)
        with torch.device(device):
            model = make()
        model = model.to(dtype)
        model.load_state_dict(state, strict=True)
        models[name] = diffusion_layout(name, model.eval())
        del state
    pipe = ControlNetInpaintPipeline(models, cfg)
    ink = Inpainter(pipe.inpaint_fn(),
                    inpaint_batch_func=pipe.inpaint_batch_fn())
    spec = cell.traffic["scene"]
    scenes = {}
    if traffic is not None:
        for r in range(traffic.pool_size // traffic.batch):
            sk = traffic.request(r)
            scenes[tuple(map(id, sk))] = scene(sk, seed, spec)
    return System(device=device, pipe=pipe, inpainter=ink, seed=seed,
                  spec=spec, scenes=scenes)


@contextlib.contextmanager
def _both(first, second):
    with first, second as s:
        yield s


@contextlib.contextmanager
def step_spans(system: System):
    """While a profiler records: the program's ``inpaint.step`` spans of
    the diffusion pipeline each inside a ``gpubench/step`` range, so that
    the trace credits the kernels launched in a solver step to it (a
    stand-in for the pipeline module's ``span``, which the trace does not
    credit).  Raises where the request opened none, so that
    ``step_device_ms`` cannot fall silent unseen."""
    from inklayer_tpu_torch import spans
    from inklayer_tpu_torch.models.diffusion import pipeline

    if not torch.autograd.profiler._is_profiler_enabled:
        yield
        return

    def span(name, **counts):
        inner = spans.span(name, **counts)
        if name != "inpaint.step":
            return inner
        system.steps_wrapped += 1
        return _both(record_function("gpubench/step"), inner)

    before = system.steps_wrapped
    pipeline.span = span
    try:
        yield
    finally:
        pipeline.span = spans.span
    if system.steps_wrapped == before:
        raise RuntimeError("a traced request opened no inpaint.step span "
                           "through the diffusion pipeline's span")


def warm_up(system: System, sketches: List[np.ndarray]) -> None:
    """A set-up request (its sketches lie outside the traffic's pool): the
    sampler over the sketches as a bucket of layers, each with a box to
    fill, at :data:`WARMUP_STEPS` steps.  Every device shape of the
    window's requests is warmed (a step's shapes are those of every step);
    the host's assembly and pre/post-processing, which need no warming, are
    left out."""
    pipe, cfg = system.pipe, system.pipe.cfg
    h, w = sketches[0].shape[:2]
    box = np.zeros((h, w), np.uint8)
    box[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 255
    pipe.cfg = dataclasses.replace(cfg, num_steps=WARMUP_STEPS)
    try:
        pipe.generate_batch([Image.fromarray(s) for s in sketches],
                            [Image.fromarray(box)] * len(sketches))
    finally:
        pipe.cfg = cfg


def call(system: System, sketches: List[np.ndarray]) -> List[dict]:
    """One request: the scene's layers completed.  Returns one unit:
    ``layers`` (each layer's (H, W, 3) uint8 image, completed where it was
    inpainted), ``inputs`` ((layer index, layer image, edit mask) of each
    layer handed to the backend, in order), ``state`` (the sampler's
    record of its call) and ``scene`` (the masks and the sketch)."""
    got = system.scenes.get(tuple(map(id, sketches)))
    if got is None and system.scenes:
        warm_up(system, sketches)
        return []
    if got is None:
        got = scene(sketches, system.seed, system.spec)
    with record_function("gpubench/request"), step_spans(system):
        system.pipe.record = record = []
        try:
            done = system.inpainter.complete(*got)
        finally:
            system.pipe.record = None
    inputs = [(i, r.layer, r.edit_mask) for i, r in enumerate(done)
              if r.need_inpaint]
    return [{"layers": [r.final if r.need_inpaint else r.layer
                        for r in done],
             "inputs": inputs, "state": record, "scene": got}]


# --------------------------------------------------------------------------
# the reference and the check
# --------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_products():
    """fp32 products in fp32 (TF32 off), the flags put back after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def reference_model(config: dict, name: str, seed: int, device,
                    quantize=None):
    """The fp32 reference ``name`` with the program's seeded weights (made
    in the serving dtype, widened); ``quantize(model)`` (the control)
    rounds it in place.  Made on the device: moving a meta-device module
    there (``weights.build``) imports torch's symbolic-shape stack, seconds
    of a run."""
    state = seeded_state(config, name, seed, device,
                         serving_dtype(config, device))
    with torch.device(device):
        model = reference_makers(config)[name]()
    model.load_state_dict({k: v.float() for k, v in state.items()},
                          strict=True)
    model.eval()
    del state
    if quantize is not None:
        quantize(model)
    return model


class Reference:
    """The reference's four models on ``device``, built on first use."""

    def __init__(self, config: dict, seed: int, device, quantize=None):
        self.config, self.seed, self.device = config, seed, device
        self.quantize = quantize
        self.models = {}

    def __getitem__(self, name: str):
        if name not in self.models:
            self.models[name] = reference_model(
                self.config, name, self.seed, self.device, self.quantize)
        return self.models[name]

    def text(self) -> torch.Tensor:
        """(2, 77, hidden): the negative prompt's, then the prompt's."""
        ids = torch.tensor([self.config["negative_ids"],
                            self.config["prompt_ids"]], device=self.device)
        return self["text"](ids)

    def inputs(self, pairs):
        """(image01, mask01, control) (B, C, S, S) of the layers' (layer,
        edit mask) pairs, by the reference's pre-processing."""
        from gpubench.reference.diffusion.prepost import sampler_inputs

        got = [sampler_inputs(layer, edit, self.config["resolution"])
               for layer, edit in pairs]
        return [torch.from_numpy(np.stack(x)).permute(0, 3, 1, 2)
                .to(self.device) for x in zip(*got)]

    def extra(self, image01, mask01) -> torch.Tensor:
        """The UNet's mask and masked-image latent channels."""
        masked = (image01 * 2.0 - 1.0) * (mask01 < 0.5)
        lat = self["vae"].encode(masked)
        mask = F.interpolate(mask01, size=lat.shape[2:], mode="nearest-exact")
        return torch.cat([mask, lat], dim=1)

    def branches(self, x, t: int, emb, extra, control):
        """(unconditioned, conditioned) noise predictions of latents ``x``
        (B, C, h, w) at train step ``t``: ControlNet and UNet over
        [uncond x B, cond x B]."""
        c = self.config
        b = x.shape[0]
        xin = torch.cat([x, x])
        ts = torch.full((2 * b,), int(t), device=x.device)
        ctx = torch.cat([emb[0:1].expand(b, -1, -1),
                         emb[1:2].expand(b, -1, -1)])
        down, mid = self["controlnet"](xin, ts, ctx,
                                       torch.cat([control, control]),
                                       c["controlnet_scale"])
        out = self["unet"](torch.cat([xin, torch.cat([extra, extra])], 1),
                           ts, ctx, down, mid)
        return out[:b], out[b:]

    def decode(self, latents) -> torch.Tensor:
        return torch.clamp(self["vae"].decode(latents) * 0.5 + 0.5, 0, 1)


def schedule(config: dict):
    from gpubench.reference.diffusion.solver import Schedule

    return Schedule(config["num_steps"], config["train_timesteps"],
                    config["beta_start"], config["beta_end"])


def _rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp(min=1e-30))


def check_picks(seed: int, request: int, layers: int, steps: int):
    """(the layer, the steps) ``eps_rel_l2`` reads: seeded, the first and
    the last step always among them."""
    rng = np.random.default_rng([seed % (1 << 63), request, 11])
    j = int(rng.integers(layers))
    mid = int(rng.integers(1, steps - 1)) if steps > 2 else 0
    return j, sorted({0, mid, steps - 1})


@torch.no_grad()
def solver_readings(config: dict, rec: dict, n: int) -> dict:
    """``ts_gap``, ``solver_gap`` and ``cfg_gap`` of a sampler record over
    its first ``n`` layers (no model runs)."""
    steps = config["num_steps"]
    sched = schedule(config)
    got = {"ts_gap": max(float((t.long().cpu() - int(s)).abs().max())
                         for t, s in zip(rec["t"], sched.timesteps))
           if len(rec["t"]) == steps else 1e9}
    g = config["guidance_scale"]
    gap, cfg, x0 = 0.0, 0.0, None
    lat = rec["latents"]
    for i in range(steps):
        eps = rec["eps"][i][:n].double()
        nxt, x0 = sched.step(i, lat[i][:n].double(), eps, x0)
        part = (sched.eps_weight(i) * eps).norm().clamp(min=1e-300)
        gap = max(gap, float((lat[i + 1][:n].double() - nxt).norm() / part))
        pred = rec["pred"][i].double()
        u, c = pred[:len(pred) // 2][:n], pred[len(pred) // 2:][:n]
        cfg = max(cfg, _rel_l2(eps, u + g * (c - u)))
    got["solver_gap"], got["cfg_gap"] = gap, cfg
    return got


@torch.no_grad()
def readings(config: dict, seed: int, request: int, out: dict,
             device) -> dict:
    """The numbers compared for one request's output (see the module's
    docstring)."""
    from gpubench.reference.diffusion.prepost import (assemble, finish,
                                                      to_uint8)

    rec = out["state"]
    if len(rec) != 1 or not out["inputs"]:
        raise RuntimeError(f"the request made {len(rec)} sampler calls over "
                           f"{len(out['inputs'])} layers; the check reads "
                           "one call")
    rec = rec[0]
    n = len(out["inputs"])
    steps = config["num_steps"]
    sched = schedule(config)
    lat = rec["latents"]
    got = solver_readings(config, rec, n)
    ref = Reference(config, seed, device)
    with fp32_products():
        j, picks = check_picks(seed, request, n, steps)
        _, layer, edit = out["inputs"][j]
        image01, mask01, control = ref.inputs([(layer, edit)])
        extra = ref.extra(image01, mask01)
        emb = ref.text()
        g = config["guidance_scale"]
        got["eps_rel_l2"] = got["cond_share"] = 0.0
        for i in picks:
            u, c = ref.branches(lat[i][j:j + 1].float(), sched.timesteps[i],
                                emb, extra, control)
            prog = rec["eps"][i][j:j + 1].double()
            u, d = u.double(), (c - u).double()
            got["eps_rel_l2"] = max(got["eps_rel_l2"],
                                    _rel_l2(prog, u + g * d))
            # not compared: the share of the guided prediction the
            # prompt's conditioning makes; a guidance scale off by a share
            # s moves the prediction by about s times it
            got["cond_share"] = max(got["cond_share"], float(
                (g * d).norm() / (u + g * d).norm().clamp(min=1e-300)))
        nine = rec["unet_in"]
        b = nine.shape[0] // 2
        dt = nine.dtype
        want = torch.cat([lat[0][j:j + 1].to(dt), extra[:, :1].to(dt)], 1)
        got["input_gap"] = max(
            float((nine[row:row + 1, :want.shape[1]] - want).abs().max())
            for row in (j, b + j))
        got["input_gap"] = max(got["input_gap"], max(
            float((rec["control"][row:row + 1] - control.to(dt)).abs().max())
            for row in (j, b + j)))
        image = ref.decode(lat[-1][j:j + 1].float())
        prog = rec["image"][j:j + 1].float()
        got["decode_rel_l1"] = float((prog - image).abs().sum()
                                     / image.abs().sum().clamp(min=1e-30))
    del ref

    u8 = to_uint8(rec["image"][:n].float().permute(0, 2, 3, 1).cpu().numpy())
    differ = total = 0
    for k, (i, layer, edit) in enumerate(out["inputs"]):
        want = finish(u8[k], layer, edit)
        differ += int((out["layers"][i] != want).any(-1).sum())
        total += want.shape[0] * want.shape[1]
    got["layer_gap"] = differ / total

    masks, sketch = out["scene"]
    inputs = {i: (layer, edit) for i, layer, edit in out["inputs"]}
    differ = total = 0
    for i, (layer, edit, need) in enumerate(assemble(masks, sketch)):
        p_layer, p_edit = inputs.get(i, (out["layers"][i], None))
        no = np.zeros(layer.shape[:2], bool)
        differ += int(((p_layer != layer).any(-1)
                       | ((no if p_edit is None else p_edit)
                          != (no if edit is None else edit))).sum())
        total += layer.shape[0] * layer.shape[1]
    got["edit_gap"] = differ / total
    return got


def judge(cell, seed: int, samples, traffic, device) -> dict:
    """{number: {"value", "limit"}}: the largest of each number over the
    window's sampled requests, for the numbers the cell's traffic file
    gives limits for."""
    if not samples:
        raise RuntimeError("no request completed in the window")
    found = {}
    for r, outs in samples:
        for out in outs:
            for k, v in readings(cell.config, seed, r, out, device).items():
                found[k] = max(found.get(k, v), v)
    limits = cell.traffic["check"]["limits"]
    return {k: {"value": found[k], "limit": limits[k]} for k in limits}


# --------------------------------------------------------------------------
# the control: the reference below the configuration's precision, in the
# program's place
# --------------------------------------------------------------------------


@torch.no_grad()
def reference_sample(config: dict, seed: int, pairs, device, quantize=None,
                     solver_dtype=torch.float64, round_eps=None) -> dict:
    """The reference's own sampler over the layers' (layer, edit mask)
    pairs, recorded as the program records its state (``t``, ``latents``,
    ``pred``, ``eps``, ``unet_in``, ``control``, ``image``): the models
    rounded by ``quantize``, the guided prediction by ``round_eps``, the
    solver carried in ``solver_dtype``.  The initial
    noise is the program's: one standard normal latent drawn from a CPU
    generator seeded with the configuration's seed, shared by the
    layers."""
    c = config
    ref = Reference(c, seed, device, quantize)
    sched = schedule(c)
    b = len(pairs)
    lat_hw = c["resolution"] // 2 ** (len(c["models"]["vae"]["channels"]) - 1)
    gen = torch.Generator().manual_seed(int(c["seed"]))
    noise = torch.randn((c["models"]["vae"]["latent_channels"], lat_hw,
                         lat_hw), generator=gen)
    x = noise.to(device).expand(b, -1, -1, -1).to(solver_dtype)
    rec = {"t": [], "latents": [], "pred": [], "eps": []}
    g = c["guidance_scale"]
    with fp32_products():
        image01, mask01, control = ref.inputs(pairs)
        extra = ref.extra(image01, mask01)
        emb = ref.text()
        rec["unet_in"] = torch.cat([torch.cat([x.float(), extra], 1)] * 2)
        rec["control"] = torch.cat([control, control])
        x0 = None
        for i, t in enumerate(sched.timesteps):
            u, cond = ref.branches(x.float(), int(t), emb, extra, control)
            eps = u + g * (cond - u)
            if round_eps is not None:
                eps = round_eps(eps)
            rec["t"].append(torch.full((2 * b,), int(t)))
            rec["latents"].append(x)
            rec["pred"].append(torch.cat([u, cond]))
            rec["eps"].append(eps)
            x, x0 = sched.step(i, x, eps.to(solver_dtype), x0)
        rec["latents"].append(x)
        for name in ("text", "controlnet", "unet"):
            ref.models.pop(name)
        _free(device)
        rec["image"] = ref.decode(x.float())
    del ref
    _free(device)
    return rec


def control_output(config: dict, seed: int, traffic, request: int,
                   device) -> dict:
    """The control's output for request ``request``, in the program's
    output form: the reference's assembly of the scene, then
    :func:`reference_sample` in the precisions below the configuration's
    (the models and the guidance rounded to fp8 below their bf16, the
    solver carried in fp16 below the program's fp32), then the reference's
    post-processing and composite."""
    from gpubench.reference.diffusion.prepost import (assemble, finish,
                                                      to_uint8)
    from gpubench.reference.lowp import fp8, quantize_

    got = scene(traffic.request(request), seed, traffic.mix["scene"])
    asm = assemble(*got)
    inputs = [(i, layer, edit) for i, (layer, edit, need) in enumerate(asm)
              if need]
    rec = reference_sample(config, seed, [(l, e) for _, l, e in inputs],
                           device, quantize_, torch.float16, fp8)
    u8 = to_uint8(rec["image"].float().permute(0, 2, 3, 1).cpu().numpy())
    layers = [a[0] for a in asm]
    for k, (i, layer, edit) in enumerate(inputs):
        layers[i] = finish(u8[k], layer, edit)
    return {"layers": layers, "inputs": inputs, "state": [rec],
            "scene": got}
