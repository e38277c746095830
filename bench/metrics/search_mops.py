"""Lookups answered over the whole window's time (host clock)."""


def read(rec):
    if rec.op != "search" or rec.seconds <= 0 or not rec.acked:
        return None
    return rec.acked / rec.seconds / 1e6
