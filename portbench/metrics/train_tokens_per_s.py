"""train_tokens_per_s: the tokens of every training step the window
completed over the window's seconds (host clock; the window ends when the
last step has finished on the card)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("steps") else None
