"""tpot_ms: over every batch of the window, the sum of (its last token's
time − its first token's) over the sum of (tokens − 1): the time per
output token after the first, every stall between steps included (host
clock; no synchronisation between steps)."""


def read(rec):
    b = [x for x in rec.get("batches", []) if x["new_tokens"] > 1]
    if not b:
        return None
    return sum(x["t_last"] - x["t_first"] for x in b) * 1e3 \
        / sum(x["new_tokens"] - 1 for x in b)
