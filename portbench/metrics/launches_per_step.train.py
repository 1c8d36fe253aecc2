"""launches_per_step.train: device operations of the traced window over
the training steps it completed."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("steps"):
        return None
    return len(tr["start"]) / rec["steps"]
