"""Sam module + predictor (port of :mod:`inklayer_tpu.models.sam.sam`).

The predictor keeps the JAX package's state API, which the runner uses:
``compute_image_state`` (preprocess + ViT encode), ``decode_lowres_state``
(box prompts -> 256^2 low-res logits) and ``masks_from_lowres`` (upsample,
crop, resize to the input size, threshold); for the batched sweep
``precompute_image_states`` (one encode of several images) and
``predict_device_state`` (host pixel boxes -> masks).  Its host entries,
built on those, are the reference SamPredictor's: ``set_image`` /
``set_image_state`` keep one image's state, and ``predict_boxes``,
``predict_device`` and ``predict`` decode prompts against it;
``predict`` also takes point and mask prompts.  Resampling uses the
jax.image-exact weight matrices of :mod:`inklayer_tpu_torch.ops.image`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from inklayer_tpu_torch.config import SamConfig
from inklayer_tpu_torch.models.sam.image_encoder import ImageEncoderViT
from inklayer_tpu_torch.models.sam.mask_decoder import MaskDecoder
from inklayer_tpu_torch.models.sam.prompt_encoder import PromptEncoder
from inklayer_tpu_torch.ops.bits import to_host
from inklayer_tpu_torch.ops.image import (resize_batch, resize_scale,
                                          scale_pad_normalize)
from inklayer_tpu_torch.spans import span


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig = SamConfig()):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.image_encoder = ImageEncoderViT(
            img_size=cfg.image_size, patch_size=cfg.patch_size,
            embed_dim=cfg.encoder_embed_dim, depth=cfg.encoder_depth,
            num_heads=cfg.encoder_num_heads, out_chans=cfg.prompt_embed_dim,
            window_size=cfg.encoder_window_size,
            global_attn_indexes=cfg.encoder_global_attn_indexes)
        self.prompt_encoder = PromptEncoder(
            embed_dim=cfg.prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(cfg.image_size, cfg.image_size))
        self.mask_decoder = MaskDecoder(transformer_dim=cfg.prompt_embed_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """Preprocessed (B, S, S, 3) -> (B, S/16, S/16, 256)."""
        return self.image_encoder(image.to(self.dtype))

    def decode(self, embedding: torch.Tensor, boxes=None, points=None,
               masks=None, multimask_output: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, G, G, C) embedding + N prompts (model-space xyxy ``boxes``
        (N, 4), ``points`` (coords (N, P, 2), labels (N, P)), low-res
        ``masks`` (N, 4G, 4G, 1)) -> (low-res logits (N, M, 4G, 4G) fp32,
        iou (N, M)); M = 3 with ``multimask_output``, else 1."""
        sparse, dense = self.prompt_encoder(boxes=boxes, points=points,
                                            masks=masks)
        image_pe = self.prompt_encoder.get_dense_pe()
        n = sparse.shape[0]
        emb = embedding.expand(n, *embedding.shape[1:]).to(self.dtype)
        return self.mask_decoder(emb, image_pe, sparse, dense,
                                 multimask_output)

    def decode_boxes(self, embedding: torch.Tensor, boxes: torch.Tensor,
                     multimask_output: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, G, G, C) embedding + (N, 4) model-space xyxy boxes ->
        (low-res logits (N, M, 4G, 4G) fp32, iou (N, M))."""
        return self.decode(embedding, boxes=boxes,
                           multimask_output=multimask_output)

    def forward(self, image: torch.Tensor, boxes: torch.Tensor):
        return self.decode_boxes(self.encode(image), boxes)


class SamPredictor:
    """Box-prompted predictor over a :class:`Sam` module.

    ``encode_fn`` overrides the image-encoder call: it takes the
    preprocessed (S, S, 3) image and returns its (G, G, C) embedding.
    Serving sets it to a micro-batched encoder
    (:class:`inklayer_tpu_torch.serve.batcher.BatchedSamEncoder`), so that
    concurrent requests share one batched ViT launch."""

    def __init__(self, model: Sam, box_capacity: int = 64, encode_fn=None):
        self.model = model
        self.cfg = model.cfg
        self.box_capacity = box_capacity
        self.encode_fn = encode_fn
        self.state = None  # set_image's image state

    # -- the host entries (the reference SamPredictor) ---------------------
    def set_image(self, image) -> None:
        """Encode one (H, W, 3) uint8 RGB image (host array or tensor) on
        the model's device and keep its state for the predict calls."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        self.set_image_state(self.compute_image_state(image.to(self.device)))

    def set_image_state(self, state: dict) -> None:
        self.state = state

    def _image_state(self) -> dict:
        if self.state is None:
            raise RuntimeError("call set_image first")
        return self.state

    def _capacity(self, n: int) -> int:
        """``box_capacity``, doubled until n prompts fit: the decoder sees
        the chained path's shapes."""
        cap = self.box_capacity
        while cap < n:
            cap *= 2
        return cap

    @torch.inference_mode()
    def _decode_host_prompts(self, state: dict, boxes_xyxy=None,
                             point_coords=None, point_labels=None,
                             mask_input=None, multimask_output=False):
        """Prompts in input pixels (host) -> (low-res logits (N, M, 4G,
        4G), iou (N, M)) on the device, M = 3 with ``multimask_output``.
        Prompts are padded to :meth:`_capacity`; points alone get the
        reference's (0, 0) / -1 pad point (prompt_encoder.py:81-85)."""
        scale = np.asarray(state["scale"], np.float32)
        dev = self.device
        given = [a for a in (boxes_xyxy, point_coords, mask_input)
                 if a is not None]
        if not given:
            raise ValueError("give boxes, points or a mask input")
        n = len(given[0])
        cap = self._capacity(n)
        boxes = points = masks = None
        with span("segment.prompts"):
            if boxes_xyxy is not None:
                padded = np.zeros((cap, 4), np.float32)
                padded[:n] = np.asarray(boxes_xyxy, np.float32) \
                    * np.tile(scale, 2)
                boxes = torch.from_numpy(padded).to(dev)
            if point_coords is not None:
                coords = np.asarray(point_coords, np.float32) * scale
                labels = np.asarray(point_labels, np.int64)
                if boxes is None:
                    coords = np.concatenate(
                        [coords, np.zeros((n, 1, 2), np.float32)], axis=1)
                    labels = np.concatenate(
                        [labels, np.full((n, 1), -1, np.int64)], axis=1)
                pc = np.zeros((cap,) + coords.shape[1:], np.float32)
                pl = np.full((cap,) + labels.shape[1:], -1, np.int64)
                pc[:n], pl[:n] = coords, labels
                points = (torch.from_numpy(pc).to(dev),
                          torch.from_numpy(pl).to(dev))
            if mask_input is not None:
                m = torch.as_tensor(mask_input, dtype=torch.float32)
                masks = torch.zeros((cap,) + tuple(m.shape[1:]) + (1,),
                                    dtype=torch.float32, device=dev)
                masks[:n, ..., 0] = m.to(dev)
        with span("segment.decoder"):
            logits, iou = self.model.decode(state["embedding"], boxes,
                                            points, masks, multimask_output)
        return logits[:n], iou[:n]

    def _postprocess(self, low_res_logits: torch.Tensor) -> np.ndarray:
        """(N, 4G, 4G) logits -> (N, H, W) fp32 logits on the host, at the
        size of the image given to :meth:`set_image`."""
        return self._postprocess_device(low_res_logits).cpu().numpy()

    def _postprocess_device(self, low_res_logits: torch.Tensor
                            ) -> torch.Tensor:
        return self._postprocess_device_state(self._image_state(),
                                              low_res_logits)

    def _predict_host(self, boxes_xyxy=None, point_coords=None,
                      point_labels=None, mask_input=None,
                      multimask_output=False, return_logits=False):
        state = self._image_state()
        low, iou = self._decode_host_prompts(
            state, boxes_xyxy, point_coords, point_labels, mask_input,
            multimask_output)
        n, m = low.shape[:2]
        full = self._postprocess_device_state(
            state, low.reshape(n * m, *low.shape[2:]))
        full = full.reshape(n, m, *full.shape[1:])
        if not return_logits:
            full = full > self.cfg.mask_threshold
        if not multimask_output:
            full, iou, low = full[:, 0], iou[:, 0], low[:, 0]
        return (full.cpu().numpy(), iou.float().cpu().numpy(),
                low.cpu().numpy())

    def predict_boxes(self, boxes_xyxy, multimask_output: bool = False,
                      return_logits: bool = False):
        """(N, 4) xyxy boxes in input pixels -> (masks (N, H, W) bool, or
        fp32 logits with ``return_logits``; iou (N,); low-res logits (N,
        4G, 4G)), all on the host; with ``multimask_output`` each gains an
        axis of 3 after N."""
        return self._predict_host(boxes_xyxy,
                                  multimask_output=multimask_output,
                                  return_logits=return_logits)

    def predict_device(self, boxes_xyxy):
        """:meth:`predict_device_state` against :meth:`set_image`'s state:
        ((N, H, W) bool masks on the device, (N,) host iou)."""
        return self.predict_device_state(self._image_state(), boxes_xyxy)

    def predict(self, boxes=None, multimask_output: bool = False,
                point_coords=None, point_labels=None, mask_input=None):
        """The reference entry: (masks bool, iou, low-res logits) on the
        host, as :meth:`predict_boxes`.  Also takes points (``point_coords``
        (N, P, 2) in input pixels, ``point_labels`` (N, P): 1 positive, 0
        negative) and ``mask_input`` (N, 4G, 4G), the low-res logits of an
        earlier call."""
        return self._predict_host(boxes, point_coords, point_labels,
                                  mask_input, multimask_output)

    @property
    def device(self) -> torch.device:
        return self.model.image_encoder.pos_embed.device

    def _preprocess_meta(self, image: torch.Tensor):
        """ResizeLongestSide to the ROUNDED target shape; box coordinates
        then scale per axis by (nw / w, nh / h) (utils/transforms.py)."""
        c = self.cfg
        h, w = image.shape[:2]
        s = resize_scale((h, w), (c.image_size, c.image_size), "longest")
        nh, nw = int(h * s + 0.5), int(w * s + 0.5)
        pre = scale_pad_normalize(
            image, (np.float32(nh / h), np.float32(nw / w)), c.pixel_mean,
            c.pixel_std, (c.image_size, c.image_size))
        meta = {"scale": np.asarray([nw / w, nh / h], np.float32),
                "orig_hw": (h, w), "input_hw": (nh, nw)}
        return pre, meta

    @torch.inference_mode()
    def compute_image_state(self, image: torch.Tensor) -> dict:
        """(H, W, 3) uint8 image on the model's device -> state dict with
        the (1, G, G, C) embedding and the resize bookkeeping."""
        with span("segment.encode", images=1):
            with span("segment.preprocess"):
                pre, meta = self._preprocess_meta(image)
            with span("segment.vit"):
                if self.encode_fn is not None:
                    emb = self.encode_fn(pre)[None]
                else:
                    emb = self.model.encode(pre[None])
        return {"embedding": emb, **meta}

    @torch.inference_mode()
    def precompute_image_states(self, images) -> list:
        """ONE batched ViT encode of several (H, W, 3) uint8 images on the
        model's device; returns one state per image, as
        :meth:`compute_image_state` does for one."""
        pres, metas = [], []
        with span("segment.encode", images=len(images)):
            with span("segment.preprocess"):
                for image in images:
                    pre, meta = self._preprocess_meta(image)
                    pres.append(pre)
                    metas.append(meta)
            with span("segment.vit"):
                embs = self.model.encode(torch.stack(pres))
        return [{"embedding": embs[i: i + 1], **metas[i]}
                for i in range(len(images))]

    @torch.inference_mode()
    def predict_device_state(self, state: dict, boxes_xyxy):
        """(N, 4) xyxy boxes in input pixels (host) -> ((N, H, W) bool masks
        on the device, (N,) host iou).  The prompts are padded to
        ``box_capacity``, doubled until they fit, so the decoder sees the
        shapes of the chained path."""
        n = len(boxes_xyxy)
        with span("segment.decode", boxes=n, slots=self._capacity(n)):
            logits, iou = self._decode_host_prompts(state, boxes_xyxy)
            with span("segment.resample"):
                full = self._postprocess_device_state(state, logits[:, 0])
                masks = full > self.cfg.mask_threshold
            return masks, to_host(iou[:, 0].float())

    def _postprocess_device_state(self, state: dict, low_res_logits):
        """(n, 4G, 4G) logits -> (n, H, W) fp32 logits: upsample to the
        model size, crop the valid region, resize to the input size."""
        size = self.cfg.image_size
        ih, iw = state["input_hw"]
        up = resize_batch(low_res_logits.float(), (size, size))
        return resize_batch(up[:, :ih, :iw].contiguous(), state["orig_hw"])

    @torch.inference_mode()
    def decode_lowres_state(self, state: dict, boxes_model: torch.Tensor):
        """(cap, 4) boxes in model space -> ((cap, 4G, 4G) low-res logits,
        (cap,) iou)."""
        with span("segment.decode", slots=int(boxes_model.shape[0])):
            with span("segment.decoder"):
                logits, iou = self.model.decode_boxes(state["embedding"],
                                                      boxes_model)
        return logits[:, 0], iou[:, 0]

    @torch.inference_mode()
    def masks_from_lowres(self, state: dict, lowres: torch.Tensor,
                          n: int) -> torch.Tensor:
        """(cap, 4G, 4G) logits -> (n, H, W) bool masks for the first n
        prompts.  n is bucketed up to a power of two (capped at cap), as in
        the JAX package, then sliced."""
        cap = lowres.shape[0]
        b = 1
        while b < n:
            b *= 2
        b = min(b, cap)
        with span("segment.decode"), span("segment.resample"):
            full = self._postprocess_device_state(state, lowres[:b])
            return (full > self.cfg.mask_threshold)[:n]
