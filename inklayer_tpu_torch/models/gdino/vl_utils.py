"""Vision-language utilities: positive-map construction.

A copy of :mod:`inklayer_tpu.models.gdino.vl_utils`: that package's
``__init__`` imports jax, which the port must not.

Parity target: GroundingDINO util/vl_utils.py create_positive_map — maps
each ground-truth phrase (character span in the caption) to the caption
tokens it covers, producing the (num_gt, max_text_len) supervision targets
used by the detection loss (parallel/detection_loss.py gt_pos_maps).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from inklayer_tpu_torch.models.gdino.tokenizer import WordPieceTokenizer


def tokenize_with_spans(tokenizer: WordPieceTokenizer, caption: str,
                        max_len: int = 256):
    """Tokenize and record each token's (char_start, char_end) span."""
    ids: List[int] = [tokenizer.cls_id]
    spans: List[Tuple[int, int]] = [(-1, -1)]
    pos = 0
    lower = caption.lower()
    for word in tokenizer._basic(caption):
        start = lower.find(word, pos)
        if start < 0:
            start = pos
        wp = tokenizer._wordpiece(word)
        # distribute char span across word pieces proportionally
        n = len(wp)
        for i, tid in enumerate(wp):
            s = start + (len(word) * i) // n
            e = start + (len(word) * (i + 1)) // n
            ids.append(tid)
            spans.append((s, e))
        pos = start + len(word)
    ids = ids[: max_len - 1] + [tokenizer.sep_id]
    spans = spans[: max_len - 1] + [(-1, -1)]
    return ids, spans


def create_positive_map(
    tokenizer: WordPieceTokenizer,
    caption: str,
    phrase_spans: Sequence[Tuple[int, int]],  # char ranges per GT phrase
    max_text_len: int = 256,
) -> np.ndarray:
    """(num_gt, max_text_len) float map: 1 where the token overlaps the
    phrase's character span."""
    _, tok_spans = tokenize_with_spans(tokenizer, caption, max_text_len)
    out = np.zeros((len(phrase_spans), max_text_len), np.float32)
    for gi, (ps, pe) in enumerate(phrase_spans):
        for ti, (ts, te) in enumerate(tok_spans):
            if ts < 0 or ti >= max_text_len:
                continue
            if ts < pe and te > ps:  # overlap
                out[gi, ti] = 1.0
    return out
