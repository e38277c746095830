"""The plain reference: what a Dash table's answers must be.

Sorted key and value arrays searched with ``np.searchsorted``; numpy only,
nothing of the program. Inserts have the table's sequential semantics: in
batch order, a key's first insert is ``INSERTED`` and stores its value, and
every later insert of the same key is ``EXISTS`` and changes nothing. A
lookup finds a key iff it was inserted, with the value stored then.

``key_bits`` below 64 compares keys on their low bits only. That is the
benchmark's control (``bench/control.py``): the same table one precision
below the 8-byte keys the configurations state.
"""
from __future__ import annotations

import numpy as np

#: status codes of a mutating operation (the table API's)
INSERTED, EXISTS = 0, 1


class Reference:
    def __init__(self, key_bits: int = 64):
        self.mask = np.uint64((1 << key_bits) - 1)
        self.keys = np.zeros(0, dtype=np.uint64)      # sorted, identity bits only
        self.values = np.zeros(0, dtype=np.uint32)

    @property
    def n_items(self) -> int:
        return int(self.keys.size)

    def _ident(self, keys) -> np.ndarray:
        return np.asarray(keys, dtype=np.uint64) & self.mask

    def _lookup(self, ident):
        # searched in sorted order: one pass over the table's keys
        order = np.argsort(ident, kind="stable")
        pos = np.empty(ident.size, dtype=np.int64)
        pos[order] = np.searchsorted(self.keys, ident[order])
        hit = pos < self.keys.size
        hit[hit] = self.keys[pos[hit]] == ident[hit]
        return pos, hit

    def insert(self, keys, values) -> np.ndarray:
        """Insert one batch in order; returns the statuses."""
        ident = self._ident(keys)
        values = np.asarray(values, dtype=np.uint32)
        uniq, first = np.unique(ident, return_index=True)
        fresh = ~self._lookup(uniq)[1]
        status = np.full(ident.size, EXISTS, dtype=np.int32)
        status[first[fresh]] = INSERTED
        new_keys, new_vals = uniq[fresh], values[first[fresh]]
        at = np.searchsorted(self.keys, new_keys)
        self.keys = np.insert(self.keys, at, new_keys)
        self.values = np.insert(self.values, at, new_vals)
        return status

    def search(self, keys):
        """(found, values) of a lookup batch; 0 where not found."""
        pos, hit = self._lookup(self._ident(keys))
        values = np.zeros(hit.size, dtype=np.uint32)
        values[hit] = self.values[pos[hit]]
        return hit, values


def mismatches(found, values, want_found, want_values) -> int:
    """Lookups whose found flag differs, or whose value differs where found."""
    found, want_found = np.asarray(found, bool), np.asarray(want_found, bool)
    wrong = found != want_found
    both = found & want_found
    wrong[both] |= np.asarray(values)[both] != np.asarray(want_values)[both]
    return int(np.count_nonzero(wrong))
