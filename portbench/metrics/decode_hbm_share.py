"""decode_hbm_share: the bytes every decode step of the window must move
(each weight once, the K/V slots in use read, one slot written;
``portbench.sizes.decode_step_bytes``) over the seconds from each batch's
first token to its last and the HBM rate, in %."""
from portbench.sizes import PEAK_HBM_BYTES_S, decode_step_bytes


def read(rec):
    bs = [x for x in rec.get("batches", []) if x["new_tokens"] > 1]
    if not bs:
        return None
    s = rec["sizes"]
    n_bytes = sum(decode_step_bytes(s, x["requests"], x["prompt_len"] + i + 1)
                  for x in bs for i in range(x["new_tokens"]))
    t = sum(x["t_last"] - x["t_first"] for x in bs)
    return 100.0 * n_bytes / t / PEAK_HBM_BYTES_S
