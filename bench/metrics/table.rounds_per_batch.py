"""Insert dispatches a load batch (``DashTable.insert_rounds`` over the
window, retry rounds after splits included)."""


def read(rec):
    if rec.op != "insert" or "insert_rounds" not in rec.counters or not rec.batches:
        return None
    return rec.counters["insert_rounds"] / rec.batches
