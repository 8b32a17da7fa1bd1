"""Plain fp32 CLIP ViT-L/14 text encoder (openai/clip-vit-large-patch14
``config.json`` ``text_config``): 49408 tokens, 77 positions, 768 wide, 12
layers of 12 heads, causal attention, quick-GELU, LayerNorm epsilon 1e-5;
SD1.5 conditions on the final LayerNorm of the last hidden state.
Parameters carry the transformers ``CLIPTextModel`` names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gpubench.reference.diffusion.nn import attention


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(hidden, hidden))

    def forward(self, x, causal):
        b, n, c = x.shape

        def split(t):
            return t.reshape(b, n, self.heads, -1).transpose(1, 2)

        out = attention(split(self.q_proj(x)), split(self.k_proj(x)),
                        split(self.v_proj(x)), mask=causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class MLP(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, 4 * hidden)
        self.fc2 = nn.Linear(4 * hidden, hidden)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class Layer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.self_attn = SelfAttention(hidden, heads)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.mlp = MLP(hidden)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class Embedding(nn.Module):
    """A lookup table; its weight is left uninitialised (the reference
    always loads its weights, and ``nn.Embedding``'s initialisation on the
    meta device imports torch's compiler stack)."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class Embeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, max_len: int):
        super().__init__()
        self.token_embedding = Embedding(vocab, hidden)
        self.position_embedding = Embedding(max_len, hidden)


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList(Layer(hidden, heads)
                                    for _ in range(layers))


class TextModel(nn.Module):
    def __init__(self, vocab: int, hidden: int, layers: int, heads: int,
                 max_len: int):
        super().__init__()
        self.embeddings = Embeddings(vocab, hidden, max_len)
        self.encoder = Encoder(hidden, layers, heads)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=1e-5)


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, hidden: int = 768,
                 layers: int = 12, heads: int = 12, max_len: int = 77):
        super().__init__()
        self.text_model = TextModel(vocab_size, hidden, layers, heads,
                                    max_len)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, n) token ids -> (B, n, hidden)."""
        tm = self.text_model
        n = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) \
            + tm.embeddings.position_embedding.weight[:n]
        causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
