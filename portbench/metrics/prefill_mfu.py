"""prefill_mfu: the model FLOPs of every prefill of the window (2 × active
trunk parameters × tokens, the head at each prompt's last position, causal
attention's q·k and p·v; ``portbench.sizes.prefill_flops``) over the
seconds of the engine's ``prefill`` stages (host spans, each ending when
the first tokens are on the host) and the bf16 peak, in %."""
from portbench.sizes import PEAK_BF16_FLOPS, prefill_flops


def read(rec):
    t = sum(b - a for n, a, b in rec["spans"] if n == "prefill")
    bs = rec.get("batches", [])
    if not bs or t <= 0:
        return None
    flops = sum(prefill_flops(rec["sizes"], x["requests"], x["prompt_len"]) for x in bs)
    return 100.0 * flops / t / PEAK_BF16_FLOPS
