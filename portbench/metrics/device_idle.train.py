"""device_idle.train: the share of the traced window in which no operation
runs on the card (the union of the trace's kernel, copy and set
intervals), in a cell that reports train_tokens_per_s."""
from portbench.trace import busy_s


def read(rec):
    tr = rec.get("trace")
    if tr is None or not len(tr["start"]):
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr["window_s"])
