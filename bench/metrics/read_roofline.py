"""The traced lookup batches' least bytes (``bench/roofline.py``) over the
card's memory bandwidth, as a share of the card's busy time in them."""
from bench import roofline


def read(rec):
    if rec.op != "search" or rec.trace is None or rec.trace["busy_s"] <= 0:
        return None
    nbytes = sum(roofline.lookup_batch_bytes(keys) for keys in rec.traced_keys)
    return roofline.bytes_share(nbytes, rec.trace["busy_s"])
