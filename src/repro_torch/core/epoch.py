"""Epoch-based reclamation + copy-on-write versioned snapshot registry.

Ported from ``repro.core.epoch``. Dash readers hold no locks, so a snapshot
being read must not be reclaimed until every reader that could see it has
exited (paper Sec. 4.4). The unit of protection is a STATE SNAPSHOT (the
table version a read batch runs against): writers publish new versions; old
versions retire into the epoch's limbo list and are released two epochs
later — the classic 3-epoch scheme.

``EpochManager``
    The grace-period core: readers ``pin()`` an epoch around a read critical
    section; writers ``retire()`` superseded payloads; a payload is reclaimed
    once no pinned reader can still reference it (2 epochs later).

``PlanePool``
    Refcounts on published plane tensors, keyed by object identity (the
    pool keeps each tensor alive, so an id is never reused while pooled).
    Copy-on-write versions SHARE planes: an untouched plane of version v_n
    is the same tensor object in v_n+1, v_n+2, ... Retiring v_n releases one
    reference per plane; the pool drops its own reference only at zero, and
    the memory goes back to the allocator when the last tensor over it goes.

``SnapshotRegistry``
    ``publish_cow(cfg, live)`` installs the live state as the next version
    in O(dirty) bytes:

      * the per-bucket-row dirty mask is the version-plane diff against the
        previous version (``engine.changed_rows``: every plane mutation bumps
        its bucket's version word, core/bucket.py);
      * the dirty rows of the record planes are scattered (``index_copy_``
        on the flattened row axis) into the previous version's tensors IN
        PLACE when that version is unpinned and its planes are unshared —
        the torch rendering of the reference's buffer donation: the new
        version gets fresh tensor objects over the same storage, so the
        retired version's objects release like the reference's donated
        handles — and otherwise into clones of them (the pinned-reader path);
      * the directory and per-segment metadata carry no version words: one
        compare on the card decides alias-vs-copy for them; scalars and the
        key heap are small and cloned every publish.

    The engines here update the live planes in place, so no published plane
    may share storage with a live plane: the first and every forced-full
    publish clone the whole state, changed metadata and all scalar planes
    are clones, and record planes only ever receive rows copied out of the
    live state (:func:`shared_planes` checks this).

    The diff reads back to the host once per publish: the row mask and the
    metadata compares travel in one transfer.
"""
from __future__ import annotations

import math
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import layout


class EpochManager:
    def __init__(self, reclaim: Optional[Callable[[Any], None]] = None):
        self._lock = threading.Lock()
        self.global_epoch = 0
        self._active = defaultdict(int)        # epoch -> active readers
        self._limbo = defaultdict(list)        # retire epoch -> payloads
        self._reclaim = reclaim or (lambda obj: None)
        self.reclaimed = 0

    # -- readers -----------------------------------------------------------

    def enter(self) -> int:
        with self._lock:
            e = self.global_epoch
            self._active[e] += 1
            return e

    def exit(self, epoch: int):
        with self._lock:
            self._active[epoch] -= 1
            if self._active[epoch] == 0:
                del self._active[epoch]
            self._try_advance_locked()

    class _Guard:
        def __init__(self, mgr):
            self.mgr = mgr

        def __enter__(self):
            self.epoch = self.mgr.enter()
            return self.epoch

        def __exit__(self, *exc):
            self.mgr.exit(self.epoch)

    def pin(self) -> "_Guard":
        """with epochs.pin(): ... — lock-free read critical section."""
        return self._Guard(self)

    @property
    def active_readers(self) -> int:
        with self._lock:
            return sum(self._active.values())

    @property
    def limbo_size(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._limbo.values())

    # -- writers -----------------------------------------------------------

    def retire(self, obj: Any):
        """Queue an old snapshot/segment for reclamation once safe."""
        with self._lock:
            self._limbo[self.global_epoch].append(obj)
            self._try_advance_locked()

    def _try_advance_locked(self):
        # advance when no reader is pinned at or before the current epoch;
        # reclaim limbo entries 2 epochs old (nobody can reference them)
        if not self._active or min(self._active) >= self.global_epoch:
            self.global_epoch += 1
        safe = self.global_epoch - 2
        for e in [e for e in self._limbo if e <= safe]:
            for obj in self._limbo.pop(e):
                self._reclaim(obj)
                self.reclaimed += 1

    def flush(self):
        """Reclaim everything (quiescent point: e.g. engine shutdown)."""
        with self._lock:
            assert not self._active, "readers still pinned"
            self.global_epoch += 3
            for e in list(self._limbo):
                for obj in self._limbo.pop(e):
                    self._reclaim(obj)
                    self.reclaimed += 1


def _leaves(payload) -> list:
    """The leaves of a payload: a state's planes, a container's items, or
    the payload itself."""
    if isinstance(payload, dict):
        payload = list(payload.values())
    if isinstance(payload, (tuple, list)):
        return [x for p in payload for x in _leaves(p)]
    return [] if payload is None else [payload]


class PlanePool:
    """Refcounts on published plane tensors, keyed by object identity.

    A plane enters the pool when a snapshot referencing it is published
    (``incref``); each snapshot that aliases the same tensor object adds a
    reference. ``decref`` releases one reference and, at zero, drops the
    pool's reference to the tensor (``freed`` counts these): a plane still
    shared by a newer snapshot survives the older snapshot's reclamation.
    A tensor whose storage a newer version took over in place (the donated
    scatter) releases only its own object; the storage lives on in the
    newer version's tensor."""

    def __init__(self):
        self._refs: dict = {}          # id(tensor) -> [tensor, refcount]
        self.freed = 0

    def incref(self, leaf):
        e = self._refs.get(id(leaf))
        if e is None:
            self._refs[id(leaf)] = [leaf, 1]
        else:
            e[1] += 1

    def _try_delete(self, key) -> bool:
        """Drop the pool's reference to a plane; True iff it held one."""
        if self._refs.pop(key, None) is None:
            return False
        self.freed += 1
        return True

    def decref(self, leaf) -> bool:
        """Release one reference; True iff the pool let go of the plane."""
        e = self._refs.get(id(leaf))
        if e is None:               # never pooled: nothing of ours to drop
            return True
        e[1] -= 1
        if e[1] == 0:
            return self._try_delete(id(leaf))
        return False

    def refcount(self, leaf) -> int:
        e = self._refs.get(id(leaf))
        return 0 if e is None else e[1]

    @property
    def live_planes(self) -> int:
        return len(self._refs)


class Snapshot:
    """One published table version: a state + the version id it was
    published under + a pin count. Readers hold it only inside an epoch pin
    (or for as long as the frontend batch that acquired it is in flight);
    ``pins`` > 0 blocks the in-place scatter by the next publish."""

    __slots__ = ("version", "state", "pins")

    def __init__(self, version: int, state: Any):
        self.version = version
        self.state = state
        self.pins = 0

    def __repr__(self):  # pragma: no cover
        return f"Snapshot(v{self.version})"


def delete_buffers(snap: Snapshot):
    """Whole-snapshot reclaimer: drop the snapshot's reference to its
    payload, so the payload's memory goes when nothing else holds it.
    Correct ONLY for never-aliased snapshots (the ``publish`` path with
    standalone payloads); pooled registries release plane-level references
    instead — see ``PlanePool``."""
    snap.state = None


class DirtyHint:
    """Host-side dirty report drained from a table's ``DirtyTracker`` at
    publish: the segments the mutating paths routed writes to (plus whether
    the directory / the whole state changed). The version-plane diff stays
    the publish's ground truth; the hint is audited against it
    (``SnapshotRegistry.hint_misses``) and drives the force-full escape for
    paths outside the version discipline (crash simulation, restart)."""

    __slots__ = ("segments", "dir", "full")

    def __init__(self, segments=frozenset(), dir=False, full=False):
        self.segments = frozenset(int(s) for s in segments)
        self.dir = bool(dir)
        self.full = bool(full)


def shared_planes(state: layout.DashState, live: layout.DashState) -> list:
    """Names of the planes of ``state`` whose storage is also a plane of
    ``live`` — must be empty for every published snapshot."""
    live_ptrs = {t.untyped_storage().data_ptr() for t in live}
    return [n for n, t in zip(state._fields, state)
            if t.untyped_storage().data_ptr() in live_ptrs]


def _clone_state(live: layout.DashState) -> layout.DashState:
    return type(live)(*(t.clone() for t in live))


class SnapshotRegistry:
    """Monotonic published-version chain guarded by an EpochManager, with
    plane-pooled copy-on-write publishing.

    ``publish_cow(cfg, live)`` installs the live table state as the newest
    version copying only dirty planes (see module docstring); ``publish``
    installs a caller-owned payload as is. ``acquire()`` returns the current
    Snapshot under an epoch pin; use as a context manager:

        with registry.acquire() as snap:
            found, vals = search_batch(cfg, mode, snap.state, ...)

    Superseded versions retire into the EpochManager's limbo; reclamation
    releases plane-level references (``PlanePool``). Passing a custom
    ``reclaim`` (or a caller-owned ``epochs``) keeps snapshot-level
    reclamation for standalone payloads.

    Observability: ``publish_bytes`` / ``last_publish_bytes`` (bytes
    actually copied), ``planes_copied`` / ``planes_aliased`` (plane counts),
    ``publish_seconds``, ``hint_misses`` (dirty segments the host tracker
    failed to report — should stay 0), ``published`` / ``reclaimed``.
    """

    def __init__(self, epochs: Optional[EpochManager] = None,
                 reclaim: Optional[Callable[[Snapshot], None]] = None):
        self.pool = PlanePool()
        self._pooled = epochs is None and reclaim is None
        if self._pooled:
            self.epochs = EpochManager(reclaim=self._release)
        else:
            self.epochs = epochs or EpochManager(reclaim=reclaim
                                                 or delete_buffers)
        self._lock = threading.Lock()
        self._current: Optional[Snapshot] = None
        self._next_version = 0
        self.published = 0
        self.publish_bytes = 0
        self.last_publish_bytes = 0
        self.publish_seconds = 0.0
        self.planes_copied = 0
        self.planes_aliased = 0
        self.hint_misses = 0

    # -- plane-level reclamation ------------------------------------------

    def _release(self, snap: Snapshot):
        """Pooled reclaimer: drop one reference per plane; a plane goes
        only when the last aliasing snapshot releases it."""
        for leaf in _leaves(snap.state):
            self.pool.decref(leaf)

    @property
    def current(self) -> Optional[Snapshot]:
        with self._lock:
            return self._current

    @property
    def version(self) -> int:
        with self._lock:
            return -1 if self._current is None else self._current.version

    # -- publishing --------------------------------------------------------

    def _install(self, state: Any):
        """Register a fully-assembled state as the newest version (caller
        holds ``_lock``). Returns (snapshot, superseded-or-None)."""
        snap = Snapshot(self._next_version, state)
        self._next_version += 1
        if self._pooled:
            for leaf in _leaves(state):
                self.pool.incref(leaf)
        old, self._current = self._current, snap
        self.published += 1
        return snap, old

    def publish(self, state: Any) -> Snapshot:
        """Install ``state`` as the newest version; retire the old one.
        The caller passes a payload it will not mutate afterwards (no copy
        is made here)."""
        with self._lock:
            snap, old = self._install(state)
        if old is not None:
            self.epochs.retire(old)
        return snap

    def publish_cow(self, cfg: layout.DashConfig, live: layout.DashState,
                    dirty_hint: Optional[DirtyHint] = None) -> Snapshot:
        """O(dirty) publish of the live table state (see module docstring).

        ``live`` is only read. The first publish (and any ``dirty_hint``
        with ``full`` set, e.g. after a crash simulation that bypasses the
        version discipline, and every pointer-mode publish: the key heap
        carries no version words) clones the whole state.

        One publisher at a time; concurrent readers are supported. The
        diff, which waits for the write batch's pending device work, runs
        outside the registry lock."""
        assert self._pooled, "publish_cow needs the pool-managed registry"
        t0 = time.perf_counter()
        force_full = (dirty_hint is not None and dirty_hint.full) \
            or cfg.pointer_mode
        prev = self.current                # stable: single publisher

        if prev is None or force_full \
                or not isinstance(prev.state, layout.DashState):
            state = _clone_state(live)
            nbytes = layout.state_nbytes(state)
            with self._lock:
                self.planes_copied += len(state)
                snap, old = self._install(state)
        else:
            diff = self._cow_diff(cfg, prev, live, dirty_hint)
            with self._lock:
                snap, old, nbytes = self._assemble_cow_locked(
                    cfg, prev, live, *diff)
        with self._lock:
            self.publish_bytes += nbytes
            self.last_publish_bytes = nbytes
            self.publish_seconds += time.perf_counter() - t0
        if old is not None:
            self.epochs.retire(old)
        return snap

    def _cow_diff(self, cfg, prev: Snapshot, live: layout.DashState,
                  dirty_hint: Optional[DirtyHint]):
        """The row mask and the metadata compares, computed on the state's
        device and read back in ONE transfer; then the host id extraction
        and the dirty-hint audit."""
        from . import engine

        NB, BT = cfg.num_buckets, cfg.buckets_total
        meta_names = layout.DIR_PLANES + layout.SEG_META_PLANES
        mask = engine.changed_rows(prev.state.version, live.version)
        neq = torch.stack([(getattr(prev.state, n) != getattr(live, n)).any()
                           for n in meta_names])
        host = torch.cat([mask, neq]).cpu().numpy()
        mask, meta_neq = host[:-len(meta_names)], host[-len(meta_names):].tolist()
        lead_shape = tuple(live.version.shape[:-1])    # (S,)
        m = mask.reshape(lead_shape + (BT,))
        ids_bt = np.flatnonzero(mask)
        ids_nb = np.flatnonzero(m[..., :NB])

        # audit the host dirty hint against the device ground truth: every
        # device-dirty segment (and a changed directory) must have been
        # reported by some mutating path
        if dirty_hint is not None and len(lead_shape) == 1:
            if ids_bt.size:
                seen = set(np.unique(ids_bt // BT).tolist())
                self.hint_misses += len(seen - dirty_hint.segments)
            if meta_neq[0] and not dirty_hint.dir:   # DIR_PLANES lead
                self.hint_misses += 1
        return ids_bt, ids_nb, meta_neq

    def _assemble_cow_locked(self, cfg, prev: Snapshot,
                             live: layout.DashState, ids_bt, ids_nb, meta_neq):
        meta_names = layout.DIR_PLANES + layout.SEG_META_PLANES
        nlead = live.version.dim()             # leading axes + the bucket axis
        new = {}
        copied_bytes = 0
        for names, ids in ((layout.BT_PLANES, ids_bt),
                           (layout.NB_PLANES, ids_nb)):
            prev_leaves = [getattr(prev.state, n) for n in names]
            if ids.size == 0:
                # nothing in this group changed: alias the previous
                # version's planes (refcounted by _install)
                for n, leaf in zip(names, prev_leaves):
                    new[n] = leaf
                self.planes_aliased += len(names)
                continue
            live_leaves = [getattr(live, n) for n in names]
            rows = math.prod(live_leaves[0].shape[:nlead])
            idx = torch.from_numpy(ids).to(live.version.device)
            donate = prev.pins == 0 and all(
                self.pool.refcount(t) == 1 for t in prev_leaves)
            for n, base, src in zip(names, prev_leaves, live_leaves):
                if not donate:
                    base = base.clone()      # pinned / shared: a fresh copy
                base.view(rows, -1).index_copy_(
                    0, idx, src.view(rows, -1).index_select(0, idx))
                # in place: a new tensor object over the previous version's
                # storage (not a view, which would keep the old object
                # alive), so the retired version's object releases alone
                new[n] = base.detach() if donate else base
            if donate:
                copied_bytes += ids.size * sum(
                    t.numel() * t.element_size() // rows for t in live_leaves)
            else:
                copied_bytes += sum(t.numel() * t.element_size()
                                    for t in live_leaves)
            self.planes_copied += len(names)

        for n, changed in zip(meta_names, meta_neq):
            if changed:
                leaf = getattr(live, n).clone()
                new[n] = leaf
                copied_bytes += leaf.numel() * leaf.element_size()
                self.planes_copied += 1
            else:
                new[n] = getattr(prev.state, n)     # aliased, refcounted
                self.planes_aliased += 1

        # scalars + key heap: small, cloned every publish — a snapshot never
        # shares storage with the live planes the engines update in place
        for n in live._fields:
            if n in new:
                continue
            leaf = getattr(live, n).clone()
            new[n] = leaf
            copied_bytes += leaf.numel() * leaf.element_size()
            self.planes_copied += 1

        snap, old = self._install(type(live)(**new))
        return snap, old, copied_bytes

    # -- readers -----------------------------------------------------------

    class _Acquired:
        def __init__(self, registry: "SnapshotRegistry"):
            self.registry = registry

        def __enter__(self) -> Snapshot:
            # epoch FIRST: from this point no retired version this reader
            # could still see is reclaimed (pins only gate the in-place
            # scatter, reclamation consults epochs)
            self.epoch = self.registry.epochs.enter()
            try:
                with self.registry._lock:
                    snap = self.registry._current
                    assert snap is not None, "acquire() before first publish()"
                    snap.pins += 1
                    self.snap = snap
            except BaseException:
                self.registry.epochs.exit(self.epoch)   # don't leak the pin
                raise
            return snap

        def __exit__(self, *exc):
            with self.registry._lock:
                self.snap.pins -= 1
            self.registry.epochs.exit(self.epoch)

    def acquire(self) -> "_Acquired":
        """Pin an epoch (and the snapshot's pin count) and yield the newest
        published Snapshot."""
        return self._Acquired(self)

    @property
    def reclaimed(self) -> int:
        return self.epochs.reclaimed

    def flush(self):
        self.epochs.flush()

    def stats(self) -> dict:
        """One observability surface for benches and tests."""
        return {
            "published": self.published,
            "publish_bytes": self.publish_bytes,
            "last_publish_bytes": self.last_publish_bytes,
            "publish_seconds": self.publish_seconds,
            "planes_copied": self.planes_copied,
            "planes_aliased": self.planes_aliased,
            "reclaimed": self.reclaimed,
            "hint_misses": self.hint_misses,
            "live_planes": self.pool.live_planes,
        }
