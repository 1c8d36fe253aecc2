"""ttft_p95_ms: the 95th percentile, over every request of the window, of
the time from its batch being handed to ``Engine.generate`` to its first
token being on the host (host clock)."""
import numpy as np


def read(rec):
    t = [b["t_first"] - b["t_submit"] for b in rec.get("batches", [])
         for _ in range(b["requests"])]
    return float(np.percentile(t, 95) * 1e3) if t else None
