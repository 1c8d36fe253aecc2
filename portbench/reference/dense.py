"""Grouped-query attention (Mistral-Nemo's): q, k, v projections, rotary
embeddings on q and k, causal softmax attention where query head h reads
key/value head h // (H / K), the output projection. As published, with no
departure."""
from __future__ import annotations

import math

from .common import causal_attention, mm, rope


def gqa(x, w: dict, s, positions, precision: str = "fp32"):
    """x [N, L, d] (normed) -> [N, L, d]; ``w`` holds ``wq`` [d, H, hd],
    ``wk``/``wv`` [d, K, hd], ``wo`` [H, hd, d] in float32."""
    N, L, d = x.shape
    H, K, hd = s.heads, s.kv_heads, s.head_dim
    q = mm(x, w["wq"].reshape(d, H * hd), precision).view(N, L, H, hd)
    k = mm(x, w["wk"].reshape(d, K * hd), precision).view(N, L, K, hd)
    v = mm(x, w["wv"].reshape(d, K * hd), precision).view(N, L, K, hd)
    q = rope(q, positions, s.rope_theta)
    k = rope(k, positions, s.rope_theta)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    out = causal_attention(q, k, v, 1.0 / math.sqrt(hd), precision)
    return mm(out.reshape(N, L, H * hd), w["wo"].reshape(H * hd, d), precision)
