"""Segment splits (``state.n_splits`` over the window) per million keys
acknowledged."""


def read(rec):
    if rec.op != "insert" or "n_splits" not in rec.counters or not rec.acked:
        return None
    return rec.counters["n_splits"] / (rec.acked / 1e6)
