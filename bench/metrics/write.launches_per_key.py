"""Kernel launches on the card per key inserted, over the traced sub-window
(profiler): the pacing of the eager lane step."""


def read(rec):
    if rec.op != "insert" or rec.trace is None or not rec.trace["ops"]:
        return None
    return rec.trace["kernel_launches"] / rec.trace["ops"]
