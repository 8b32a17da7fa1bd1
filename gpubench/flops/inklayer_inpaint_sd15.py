"""FLOPs of configuration ``inklayer-inpaint-sd15`` from its published
shapes.

Two FLOPs per multiply-add, counted over matrix products, convolutions and
the two products of every attention (scores and values); not counted:
normalisation, activations, softmax, resampling and the element-wise
guidance and solver arithmetic.  One unit is one bucket call of the
sampler: the VAE encoding of each layer's masked image, the solver steps
(ControlNet and UNet over the two guidance samples of each layer) and the
VAE decoding.  The text encoder is left out: the prompts' embeddings are
made once and kept.

``kernel_launches`` lists the launches of the port's flash attention
kernel (K7) one request makes at these shapes: the self-attention of every
UNet and ControlNet transformer whose level has at least
:data:`FLASH_MIN_KEYS` tokens (the program's dispatch to the kernel).
"""

from __future__ import annotations

FLASH_MIN_KEYS = 1024
BUCKETS = (1, 2, 4)


def _mm(m, k, n) -> float:
    return 2.0 * m * k * n


def conv(hw: int, cin: int, cout: int, k: int = 3) -> float:
    """A k x k convolution with ``hw`` x ``hw`` outputs."""
    return _mm(hw * hw, cin * k * k, cout)


def resnet(hw: int, cin: int, cout: int, temb: int = 0) -> float:
    f = conv(hw, cin, cout) + conv(hw, cout, cout)
    if cin != cout:
        f += conv(hw, cin, cout, 1)
    if temb:
        f += _mm(1, temb, cout)  # the time embedding's projection
    return f


def attention(n: int, m: int, c: int) -> float:
    """The two products of attention from ``n`` queries to ``m`` keys,
    ``c`` wide over all heads."""
    return 2 * _mm(n, m, c)


def transformer(hw: int, c: int, text: int, ctx: int) -> float:
    """GroupNorm, 1x1 in, self-attention, cross-attention to ``text``
    tokens ``ctx`` wide, GEGLU feed-forward, 1x1 out."""
    n = hw * hw
    return (2 * conv(hw, c, c, 1)
            + 4 * _mm(n, c, c) + attention(n, n, c)
            + 2 * _mm(n, c, c) + 2 * _mm(text, ctx, c) + attention(n, text, c)
            + _mm(n, c, 8 * c) + _mm(n, 4 * c, c))


def _levels(m: dict, latent: int):
    return [(latent >> i, c) for i, c in enumerate(m["block_channels"])]


def encoder(m: dict, latent: int, text: int) -> float:
    """conv_in's successors: the down blocks and the mid block (UNet and
    ControlNet alike), and the time embedding's MLP."""
    ch = m["block_channels"]
    temb = 4 * ch[0]
    f = _mm(1, ch[0], temb) + _mm(1, temb, temb)
    levels = _levels(m, latent)
    prev = ch[0]
    for i, (hw, c) in enumerate(levels):
        last = i == len(levels) - 1
        for j in range(m["layers_per_block"]):
            f += resnet(hw, prev if j == 0 else c, c, temb)
            if not last:
                f += transformer(hw, c, text, m["context_dim"])
            prev = c
        if not last:
            f += conv(hw // 2, c, c)
    hw, c = levels[-1]
    f += 2 * resnet(hw, c, c, temb) + transformer(hw, c, text,
                                                  m["context_dim"])
    return f


def skips(m: dict, latent: int):
    """(size, channels) of the down pass's features, conv_in's first."""
    levels = _levels(m, latent)
    out = [levels[0]]
    for i, (hw, c) in enumerate(levels):
        out += [(hw, c)] * m["layers_per_block"]
        if i < len(levels) - 1:
            out.append((hw // 2, c))
    return out


def unet(m: dict, latent: int, text: int) -> float:
    """One sample through the inpainting UNet."""
    ch = m["block_channels"]
    temb = 4 * ch[0]
    f = conv(latent, m["in_channels"], ch[0]) + encoder(m, latent, text)
    feats = skips(m, latent)
    levels = _levels(m, latent)[::-1]
    prev = ch[-1]
    for i, (hw, c) in enumerate(levels):
        for _ in range(m["layers_per_block"] + 1):
            f += resnet(hw, prev + feats.pop()[1], c, temb)
            if i > 0:
                f += transformer(hw, c, text, m["context_dim"])
            prev = c
        if i < len(levels) - 1:
            f += conv(2 * hw, c, c)
    return f + conv(latent, ch[0], m["out_channels"])


def controlnet(m: dict, latent: int, text: int) -> float:
    """One sample through the ControlNet: conv_in, the conditioning
    embedding from the full-size image, the encoder, the 1x1 outputs."""
    ch = m["block_channels"]
    cc = m["conditioning_channels"]
    hw = latent * 2 ** (len(cc) - 1)
    f = conv(latent, m["in_channels"], ch[0]) + conv(hw, 3, cc[0])
    for a, b in zip(cc[:-1], cc[1:]):
        f += conv(hw, a, a) + conv(hw // 2, a, b)
        hw //= 2
    f += conv(hw, cc[-1], ch[0]) + encoder(m, latent, text)
    f += sum(conv(s, c, c, 1) for s, c in skips(m, latent))
    return f + conv(latent >> (len(ch) - 1), ch[-1], ch[-1], 1)


def _vae_mid(hw: int, c: int) -> float:
    n = hw * hw
    return 2 * resnet(hw, c, c) + 4 * _mm(n, c, c) + attention(n, n, c)


def vae_encode(v: dict, size: int) -> float:
    ch = v["channels"]
    f, prev, hw = conv(size, 3, ch[0]), ch[0], size
    for i, c in enumerate(ch):
        f += resnet(hw, prev, c) + resnet(hw, c, c)
        if i < len(ch) - 1:
            hw //= 2
            f += conv(hw, c, c)
        prev = c
    lat = 2 * v["latent_channels"]
    return (f + _vae_mid(hw, ch[-1]) + conv(hw, ch[-1], lat)
            + conv(hw, lat, lat, 1))


def vae_decode(v: dict, size: int) -> float:
    ch = v["channels"]
    lat = v["latent_channels"]
    hw = size >> (len(ch) - 1)
    f = conv(hw, lat, lat, 1) + conv(hw, lat, ch[-1]) + _vae_mid(hw, ch[-1])
    prev = ch[-1]
    for i, c in enumerate(reversed(ch)):
        f += resnet(hw, prev, c) + 2 * resnet(hw, c, c)
        if i < len(ch) - 1:
            hw *= 2
            f += conv(hw, c, c)
        prev = c
    return f + conv(hw, ch[0], 3)


def bucket(traffic: dict) -> int:
    """The sampler's bucket for a request's layers (one a sketch)."""
    return next(b for b in BUCKETS if b >= int(traffic["batch"]))


def per_call(config: dict, slots: int) -> dict:
    """{part: FLOPs} of one sampler call over ``slots`` layers."""
    m = config["models"]
    size = config["resolution"]
    latent = size // 2 ** (len(m["vae"]["channels"]) - 1)
    text = m["text"]["max_len"]
    samples = 2 * slots * config["num_steps"]
    return {"vae_encode": slots * vae_encode(m["vae"], size),
            "controlnet": samples * controlnet(m["controlnet"], latent, text),
            "unet": samples * unet(m["unet"], latent, text),
            "vae_decode": slots * vae_decode(m["vae"], size)}


def per_unit(config: dict, traffic: dict) -> float:
    """FLOPs of one request: one sampler call at the request's bucket."""
    return sum(per_call(config, bucket(traffic)).values())


def kernel_launches(config: dict, traffic: dict) -> dict:
    """{kernel: [launch shape, ...]} of one request: K7 for the
    self-attention of each UNet and ControlNet transformer on a level of at
    least FLASH_MIN_KEYS tokens, per step, over the guidance samples and
    the heads."""
    m = config["models"]
    latent = config["resolution"] // 2 ** (len(m["vae"]["channels"]) - 1)
    bh = 2 * bucket(traffic) * m["unet"]["num_heads"]
    per_step = []
    for name, ups in (("unet", 1), ("controlnet", 0)):
        net = m[name]
        k = net["layers_per_block"]
        for hw, c in _levels(net, latent)[:-1]:
            if hw * hw >= FLASH_MIN_KEYS:
                per_step += [{"bh": bh, "n": hw * hw,
                              "d": c // net["num_heads"]}] \
                    * (k + ups * (k + 1))
    return {"flash_attention": per_step * config["num_steps"]}
