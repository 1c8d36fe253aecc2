"""decode_mfu: the model FLOPs of every decode step of the window (2 ×
active parameters × batch, attention over the slots in use;
``portbench.sizes.decode_step_flops``) over the seconds from each batch's
first token to its last, and the bf16 peak, in %. ``Engine.generate`` runs
one decode step a new token, the last one's token unused."""
from portbench.sizes import PEAK_BF16_FLOPS, decode_step_flops


def read(rec):
    bs = [x for x in rec.get("batches", []) if x["new_tokens"] > 1]
    if not bs:
        return None
    s = rec["sizes"]
    flops = sum(decode_step_flops(s, x["requests"], x["prompt_len"] + i + 1)
                for x in bs for i in range(x["new_tokens"]))
    t = sum(x["t_last"] - x["t_first"] for x in bs)
    return 100.0 * flops / t / PEAK_BF16_FLOPS
