"""k5_roofline.prefill: the attention kernel's launches in the traced
window (``flash_attn_tc_kernel``), the sum of their bounds (max of bytes
at the HBM rate and operations at the bf16 rate, at the prefill's shape:
``portbench.sizes.k5_bytes_ops``) over the sum of their device times, in
%."""
import numpy as np

from portbench.sizes import bound_s, k5_bytes_ops
from portbench.trace import kernel_mask


def read(rec):
    tr = rec.get("trace")
    bs = rec.get("batches", [])
    if tr is None or not bs:
        return None
    hit = kernel_mask(tr, r"flash_attn_tc_kernel")
    if not hit.any():
        return None
    s, x = rec["sizes"], bs[0]
    one = bound_s(*k5_bytes_ops(x["requests"], x["prompt_len"], s.heads,
                                s.attn_kv_heads, s.dqk, s.dv))
    t = float(np.sum(tr["end"][hit] - tr["start"][hit]))
    return 100.0 * one * int(hit.sum()) / t
