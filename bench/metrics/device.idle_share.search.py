"""Share of the traced sub-window of a read mix in which no operation ran
on the card (1 - busy union / window, profiler)."""


def read(rec):
    if rec.op != "search" or rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
