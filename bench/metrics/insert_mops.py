"""Keys acknowledged INSERTED over the whole window's time (host clock)."""


def read(rec):
    if rec.op != "insert" or rec.seconds <= 0 or not rec.acked:
        return None
    return rec.acked / rec.seconds / 1e6
