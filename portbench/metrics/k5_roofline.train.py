"""k5_roofline.train: the attention kernel's forward launches
(``flash_attn_tc_kernel``: the forward and remat's recompute) and backward
calls (``bwd_dq_kernel`` then ``bwd_dkdv_kernel``, one pair a call) in the
traced window: the sum of their bounds at the step's shape
(``portbench.sizes.k5_bytes_ops``, ``k5_bwd_bytes_ops``) over the sum of
their device times, in %."""
import numpy as np

from portbench.sizes import bound_s, k5_bwd_bytes_ops, k5_bytes_ops
from portbench.trace import kernel_mask


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("steps"):
        return None
    fwd = kernel_mask(tr, r"flash_attn_tc_kernel")
    dq = kernel_mask(tr, r"bwd_dq_kernel")
    bwd = dq | kernel_mask(tr, r"bwd_dkdv_kernel")
    if not fwd.any() or not dq.any():
        return None
    s = rec["sizes"]
    shape = (rec["batch"], rec["seq_len"], s.heads, s.attn_kv_heads, s.dqk, s.dv)
    bound = int(fwd.sum()) * bound_s(*k5_bytes_ops(*shape)) \
        + int(dq.sum()) * bound_s(*k5_bwd_bytes_ops(*shape))
    dur = tr["end"] - tr["start"]
    return 100.0 * bound / float(np.sum(dur[fwd]) + np.sum(dur[bwd]))
