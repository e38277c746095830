"""Epoch-guarded snapshots: only the dirty report is ported so far."""
from __future__ import annotations


class DirtyHint:
    """Host-side dirty report drained from a table's ``DirtyTracker`` at
    publish: the segments the mutating paths routed writes to (plus whether
    the directory / the whole state changed). The version-plane diff stays
    the publish's ground truth; the hint is audited against it."""

    __slots__ = ("segments", "dir", "full")

    def __init__(self, segments=frozenset(), dir=False, full=False):
        self.segments = frozenset(int(s) for s in segments)
        self.dir = bool(dir)
        self.full = bool(full)
