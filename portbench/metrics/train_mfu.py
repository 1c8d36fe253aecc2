"""train_mfu: the model FLOPs of the window's training steps (6 × active
parameters × tokens and 3 × causal attention's forward, remat's recompute
not counted; ``portbench.sizes.train_step_flops``) over the window's
seconds and the bf16 peak, in %."""
from portbench.sizes import PEAK_BF16_FLOPS, train_step_flops


def read(rec):
    if not rec.get("steps"):
        return None
    f = train_step_flops(rec["sizes"], rec["batch"], rec["seq_len"]) * rec["steps"]
    return 100.0 * f / rec["window_s"] / PEAK_BF16_FLOPS
