"""device_idle.ttft: the share of the traced window in which no operation
runs on the card (the union of the trace's kernel, copy and set
intervals), in a cell that reports ttft_p95_ms."""
from portbench.trace import busy_s


def read(rec):
    tr = rec.get("trace")
    if tr is None or not len(tr["start"]):
        return None
    return 100.0 * (1.0 - busy_s(tr) / tr["window_s"])
