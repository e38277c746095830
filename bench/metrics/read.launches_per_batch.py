"""Kernel launches on the card per lookup batch, over the traced sub-window
(profiler)."""


def read(rec):
    if rec.op != "search" or rec.trace is None or not rec.trace["batches"]:
        return None
    return rec.trace["kernel_launches"] / rec.trace["batches"]
