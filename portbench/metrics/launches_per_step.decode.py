"""launches_per_step.decode: device operations launched from inside the
engine's ``decode`` stages (by the host time of each launch's runtime
call, matched by correlation id) over the number of decode steps."""
import numpy as np

from portbench.trace import in_spans


def read(rec):
    tr = rec.get("trace")
    steps = sum(1 for n, _, _ in rec["spans"] if n == "decode")
    if tr is None or not steps or np.isnan(tr["launch"]).all():
        return None
    return float(in_spans(tr["launch"], rec["spans"], "decode").sum()) / steps
