"""FLOPs of configuration ``inklayer-default`` from its published shapes.

Two FLOPs per multiply-add, counted over matrix products, convolutions and
the two products of every attention (scores and values); not counted:
normalisation, activations, softmax, resampling, the bilinear taps of
multi-scale deformable attention and the top-K.  The shapes are those the
default run gives a sketch of ``sketch_hw``: GroundingDINO at its shape
bucket, SAM at its square input, the depth model at its bucket.

``kernel_launches`` lists the launches of the port's kernels one request
makes at these shapes, for the kernels' roofline bounds
(``gpubench/flops/<kernel>.py``).
"""

from __future__ import annotations

import math

from gpubench.reference.config import DepthConfig
from gpubench.reference.depth.dpt import depth_bucket
from gpubench.reference.image import pick_bucket


def make_config(cls, data: dict):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in data.items()})


def _mm(m, k, n) -> float:
    return 2.0 * m * k * n


def gdino(cfg: dict, hw, text_tokens: int) -> float:
    """One image through GroundingDINO SwinT-OGC at its bucket."""
    bh, bw = pick_bucket(hw[0], hw[1], [tuple(x) for x in cfg["shape_buckets"]])
    sw = cfg["swin"]
    p, win = sw["patch_size"], sw["window_size"]
    h, w = bh // p, bw // p
    c = sw["embed_dim"]
    f = _mm(h * w, 3 * p * p, c)  # patch embedding
    feats = []
    for i, depth in enumerate(sw["depths"]):
        t = h * w
        tp = math.ceil(h / win) * win * math.ceil(w / win) * win
        per = (_mm(tp, c, 3 * c) + 2 * _mm(tp, win * win, c)
               + _mm(tp, c, c) + 2 * _mm(t, c, sw["mlp_ratio"] * c))
        f += depth * per
        feats.append((h, w, c))
        if i < len(sw["depths"]) - 1:  # patch merging
            h, w = (h + 1) // 2, (w + 1) // 2
            f += _mm(h * w, 4 * c, 2 * c)
            c *= 2
    d = cfg["hidden_dim"]
    levels = [feats[i] for i in sw["out_indices"]]
    for lh, lw, lc in levels:
        f += _mm(lh * lw, lc, d)  # 1x1 input projections
    lh, lw, lc = levels[-1]
    lh, lw = (lh + 1) // 2, (lw + 1) // 2
    f += _mm(lh * lw, 9 * lc, d)  # the extra 3x3 / 2 level
    s = sum(a * b for a, b, _ in levels) + lh * lw
    nt = text_tokens
    bert = cfg["bert"]
    hb = bert["hidden_size"]
    f += bert["num_layers"] * (_mm(nt, hb, 4 * hb) + 2 * _mm(nt, nt, hb)
                               + 2 * _mm(nt, hb, bert["intermediate_size"]))
    f += _mm(nt, hb, d)  # feat_map
    heads, lv = cfg["nheads"], cfg["num_feature_levels"]
    fe, ffn = cfg["fusion_embed_dim"], cfg["dim_feedforward"]

    def msda(q, pts):  # value, offsets, weights, output projections
        return (_mm(s, d, d) + _mm(q, d, heads * lv * pts * 2)
                + _mm(q, d, heads * lv * pts) + _mm(q, d, d))

    enc = (
        # image-text fusion: image and text projections, attention both
        # ways, the output projections
        _mm(s, d, fe) * 2 + _mm(nt, d, fe) * 2 + 2 * _mm(s, nt, fe) * 2
        + _mm(s, fe, d) + _mm(nt, fe, d)
        # text enhancer: self-attention and its feed-forward
        + _mm(nt, d, 4 * d) + 2 * _mm(nt, nt, d)
        + 2 * _mm(nt, d, cfg["text_enhancer_ffn"])
        + msda(s, cfg["enc_n_points"]) + 2 * _mm(s, d, ffn))
    f += cfg["enc_layers"] * enc
    nq = cfg["num_queries"]
    # two-stage query selection: output projection, class and box heads
    f += _mm(s, d, d) + _mm(s, d, nt) + 2 * _mm(s, d, d) + _mm(s, d, 4)
    dec = (_mm(nq, d, 4 * d) + 2 * _mm(nq, nq, d)             # self
           + _mm(nq, d, 2 * d) + _mm(nt, d, 2 * d)            # text cross
           + 2 * _mm(nq, nt, d)
           + msda(nq, cfg["dec_n_points"]) + 2 * _mm(nq, d, ffn)
           + _mm(nq, 2 * d, d) + _mm(nq, d, d)                 # query pos
           + 2 * _mm(nq, d, d) + _mm(nq, d, 4)                 # box head
           + _mm(nq, d, nt))                                   # logits
    return f + cfg["dec_layers"] * dec


def sam_encode(cfg: dict) -> float:
    """One image through SAM's ViT image encoder and neck."""
    g = cfg["image_size"] // cfg["patch_size"]
    c, win = cfg["encoder_embed_dim"], cfg["encoder_window_size"]
    t = g * g
    tw = math.ceil(g / win) ** 2 * win * win  # windows padded
    hd = c // cfg["encoder_num_heads"]
    f = _mm(t, 3 * cfg["patch_size"] ** 2, c)
    for i in range(cfg["encoder_depth"]):
        glob = i in cfg["encoder_global_attn_indexes"]
        n, tok = (t, t) if glob else (win * win, tw)
        side = g if glob else win
        f += (_mm(tok, c, 3 * c) + 2 * _mm(tok, n, c)
              + 2 * _mm(tok, side, hd) * cfg["encoder_num_heads"]  # rel terms
              + _mm(tok, c, c) + 2 * _mm(t, c, 4 * c))
    pe = cfg["prompt_embed_dim"]
    return f + _mm(t, c, pe) + _mm(t, 9 * pe, pe)


def sam_decode(cfg: dict, boxes: int) -> float:
    """SAM's mask decoder for ``boxes`` box prompts (the single-mask
    output; all four mask tokens are computed)."""
    g = cfg["image_size"] // cfg["patch_size"]
    c, t = cfg["prompt_embed_dim"], g * g
    tok = 5 + 2  # iou + 4 mask tokens, 2 box corners
    half = c // 2

    def attn(nq, nk, dim):
        return _mm(nq, c, dim) + 2 * _mm(nk, c, dim) + 2 * _mm(nq, nk, dim) \
            + _mm(nq, dim, c)

    layer = (attn(tok, tok, c) + attn(tok, t, half) + 2 * _mm(tok, c, 8 * c)
             + attn(t, tok, half))
    per = 2 * layer + attn(tok, t, half)
    up = _mm(4 * t, c, c // 4) + _mm(16 * t, c // 4, c // 8)
    heads = 4 * (2 * _mm(1, c, c) + _mm(1, c, c // 8)) \
        + 2 * _mm(1, c, c) + _mm(1, c, 4)
    masks = 4 * _mm(16 * t, c // 8, 1)
    return boxes * (per + up + heads + masks)


def depth(cfg: dict, hw) -> float:
    """One image through DINOv2 + the DPT head at its bucket."""
    bh, bw = depth_bucket(hw[0], hw[1], make_config(DepthConfig, cfg))
    p, c = cfg["patch_size"], cfg["embed_dim"]
    ph, pw = bh // p, bw // p
    t = ph * pw + 1
    f = _mm(ph * pw, 3 * p * p, c)
    f += cfg["depth"] * (_mm(t, c, 3 * c) + 2 * _mm(t, t, c) + _mm(t, c, c)
                         + 2 * _mm(t, c, 4 * c))
    oc, fe = cfg["out_channels"], cfg["features"]
    n = ph * pw
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw),
             ((ph + 1) // 2, (pw + 1) // 2)]
    for i, o in enumerate(oc):
        f += _mm(n, c, o)
    f += _mm(n, oc[0], 16 * oc[0]) + _mm(n, oc[1], 4 * oc[1])  # conv-T
    f += _mm(sizes[3][0] * sizes[3][1], 9 * oc[3], oc[3])
    for (sh, swd), o in zip(sizes, oc):
        f += _mm(sh * swd, 9 * o, fe)  # layer_rn
    rcu = lambda px: 2 * _mm(px, 9 * fe, fe)
    for i, (sh, swd) in enumerate(sizes):
        px = sh * swd
        f += rcu(px) * (1 if i == 3 else 2)
        out = sizes[i - 1] if i else (2 * sh, 2 * swd)
        f += _mm(out[0] * out[1], fe, fe)  # out_conv after the resize
    h1, w1 = 2 * sizes[0][0], 2 * sizes[0][1]
    f += _mm(h1 * w1, 9 * fe, fe // 2)
    f += _mm(bh * bw, 9 * (fe // 2), 32) + _mm(bh * bw, 32, 1)
    return f


def per_sketch(config: dict, hw, boxes: int) -> dict:
    """{part: FLOPs} of one sketch's model work."""
    m = config["models"]
    return {"gdino": gdino(m["gdino"], hw, len(config["caption_ids"])),
            "sam_encode": sam_encode(m["sam"]),
            "sam_decode": sam_decode(m["sam"], boxes),
            "depth": depth(m["depth"], hw)}


def per_unit(config: dict, traffic: dict) -> float:
    """FLOPs per sketch of the traffic's size and boxes."""
    return sum(per_sketch(config, tuple(traffic["sketch_hw"]),
                          int(traffic["boxes"])).values())


def kernel_launches(config: dict, traffic: dict) -> dict:
    """{kernel: [launch shape, ...]} of one request: the relpos attention
    (K1 windowed, K2 global) and the fused MLP (K3) of SAM's batched
    encode."""
    s = config["models"]["sam"]
    b = int(traffic["batch"])
    g = s["image_size"] // s["patch_size"]
    win, heads = s["encoder_window_size"], s["encoder_num_heads"]
    c = s["encoder_embed_dim"]
    hd = c // heads
    nwin = math.ceil(g / win) ** 2
    relpos, mlp = [], []
    for i in range(s["encoder_depth"]):
        if i in s["encoder_global_attn_indexes"]:
            relpos.append({"bh": b * heads, "n": g * g, "d": hd, "kh": g,
                           "kw": g})
        else:
            relpos.append({"bh": b * nwin * heads, "n": win * win, "d": hd,
                           "kh": win, "kw": win})
        mlp.append({"m": b * g * g, "k": c, "h": 4 * c, "n": c})
    return {"relpos_attention": relpos, "linear_bias_act": mlp}
