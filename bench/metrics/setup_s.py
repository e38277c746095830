"""Process start to the first timed batch: imports, the kernels built or
loaded from the checkout's cache, the traffic made, the warm-up, the table
made and, for a read mix, the preload."""


def read(rec):
    return rec.setup_s
