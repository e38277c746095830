"""The card's published peaks and the byte counts of a lookup batch.

Peaks from NVIDIA's H100 SXM data sheet (dense, without sparsity), which
assume the card's full 700 W: a card set below it runs slower, so every
run prints the card's power limit beside its numbers (``card_line``).
"""
from __future__ import annotations

import subprocess

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # 80 GB HBM3
BF16_FLOPS_PER_S = 989e12      # tensor cores, dense

#: bytes a lookup needs at least, from the table's layout
#: (``repro_torch.core.layout``): a bucket's 16-byte fingerprint row and its
#: 4-byte metadata word, a record's two 4-byte key words and 4-byte value
FP_ROW, META_WORD, KEY, VALUE, FOUND = 16, 4, 8, 4, 1
#: buckets a lookup may find its key in (the home bucket and its neighbour)
CANDIDATE_BUCKETS = 2


def lookup_batch_bytes(keys: np.ndarray) -> int:
    """Least bytes a batch of lookups of loaded keys moves: each key read and
    its found flag and value written once; for each distinct key, both
    candidate buckets' fingerprint row and metadata word and the record's
    key and value read once (repeats of a key in the batch read nothing
    new). Directory words are left out: the whole directory is a few
    hundred KB that every batch shares."""
    n = int(keys.size)
    distinct = int(np.unique(keys).size)
    per_key = KEY + FOUND + VALUE
    per_distinct = CANDIDATE_BUCKETS * (FP_ROW + META_WORD) + KEY + VALUE
    return n * per_key + distinct * per_distinct


def bytes_share(nbytes: float, seconds: float) -> float:
    """Percent of the card's memory bandwidth that moving ``nbytes`` in
    ``seconds`` would use."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
