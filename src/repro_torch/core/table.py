"""Host-facing Dash tables: batch planning + split retry + lazy recovery.

The card does the data-plane work (hashing, batched probes/inserts, SMOs);
the host plays the paper's "goto retry" loop (Alg. 1 line 31): when a batch
reports NEED_SPLIT, the host runs the SMO and retries the failed subset.
Per-segment lazy recovery (Sec. 4.8) hooks in before every access: the
accessing batch recovers the dirty segments it touches, all at once.
Ported from ``repro.core.table``. Each batch's keys are hashed on the card
(``kernels/hashmix.bulk_hash``) and its per-key segment ids looked up in the
device directory; the host reads back only what it plans with (the largest
per-segment lane count, the pressured segments, the statuses).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import fused, hashmix
from . import dash_eh, dash_lh, engine, hashing, layout, recovery, smo
from .epoch import DirtyHint
from .layout import NEED_SPLIT, DashConfig, DashState

#: ``DashEH.shrink`` merges a buddy pair while its records fit in this
#: share of one segment (the reference's default ``target_fill``)
SHRINK_TARGET_FILL = 0.8


class TableFullError(RuntimeError):
    pass


class DirtyTracker:
    """Dirty-plane accounting for the copy-on-write publish: every mutating
    path notes the segments it routed writes to (the same per-key segment
    ids that feed ``route_lanes``) plus whether the directory changed. The
    segments are kept as per-segment counts on the table's device, so noting
    a batch costs no host transfer; ``drain`` reads them back. ``note_full``
    marks mutations outside the version discipline (crash simulation,
    restart), forcing the next publish to copy the whole state."""

    def __init__(self, num_segments: int, device):
        self._hits = torch.zeros(num_segments, dtype=torch.int32, device=device)
        self.dir = False
        self.full = False

    def note_segments(self, ids):
        ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids) else ids,
                              device=self._hits.device).reshape(-1).long()
        self._hits.index_add_(0, ids.clamp(min=0), (ids >= 0).to(torch.int32))

    def note_dir(self):
        self.dir = True

    def note_full(self):
        self.full = True

    @property
    def segments(self) -> set:
        return set(self._hits.nonzero()[:, 0].tolist())

    @property
    def any(self) -> bool:
        return self.full or self.dir or bool(self._hits.any())

    def drain(self) -> DirtyHint:
        hint = DirtyHint(self.segments, self.dir, self.full)
        self._hits.zero_()
        self.dir = False
        self.full = False
        return hint


@dataclasses.dataclass
class InsertJob:
    """Resumable insert batch: the state of one ``insert`` retry loop, kept
    on the table's device."""
    hi: torch.Tensor
    lo: torch.Tensor
    w: torch.Tensor | None           # pointer mode: (n, W) key words
    vals: torch.Tensor
    out: torch.Tensor                # per-input statuses (NEED_SPLIT until done)
    pending: torch.Tensor            # input indices still unplaced
    first: bool = True               # first round: full batch, lazy recovery
    rounds: int = 0

    @property
    def done(self) -> bool:
        return self.pending.numel() == 0


# Largest batch that takes the fused latency path by default (the
# reference's calibration; the port keeps it so both plan alike).
FUSED_THRESHOLD_DEFAULT = 1024


class DashTable:
    """Shared host logic; subclasses define addressing + pressure handling.

    Runs on the card unless ``device`` names another (``device="cpu"`` for
    CPU runs). ``smo_mode="bulk"`` (default) splits every segment pressured
    in one round in a single bulk SMO with one directory publish;
    ``smo_mode="scalar"`` keeps the per-segment scan-rehash path — the
    differential baseline."""

    mode: str = "eh"

    def __init__(self, cfg: DashConfig, device=None, lazy_recovery: bool = True,
                 smo_mode: str = "bulk", state: DashState | None = None,
                 fused_threshold: int | None = None):
        if smo_mode not in ("bulk", "scalar"):
            raise ValueError(f"unknown smo_mode {smo_mode!r}")
        self.cfg = cfg
        # batches at or under this size take the fused latency path; 0
        # forces the routed/vmap paths
        self.fused_threshold = (FUSED_THRESHOLD_DEFAULT if fused_threshold is None
                                else int(fused_threshold))
        if state is None:
            self.device = layout.resolve_device(device)
            state = layout.make_state(cfg, self.mode, self.device)
        else:
            self.device = state.dir.device
        self.state: DashState = state
        self.lazy_recovery = lazy_recovery
        self.smo_mode = smo_mode
        self.recovered_segments = 0   # stat: lazy recoveries performed
        self.insert_rounds = 0        # stat: insert dispatches (retry rounds included)
        self.free_segments: list = []  # merged-away ids, recycled by splits
        self.dirty = DirtyTracker(cfg.max_segments, self.device)
        self.writeback = None         # durable PM-pool engine (persist/)
        self.lost_report: list = []   # quarantined rows from a verified reopen
        self.obs = None               # observability bundle (obs/), optional

    # -- key plumbing --------------------------------------------------------

    def _prep(self, keys=None, words=None):
        """(hi, lo, words) word tensors of a batch. Pointer mode takes the
        keys as (n, key_heap_words) uint32 rows and folds their identity
        pair; otherwise ``keys`` are uint64 and ``words`` is None."""
        if not self.cfg.pointer_mode:
            return (*hashing.split_keys(keys, self.device), None)
        if words is None:
            raise ValueError("pointer mode takes `words` (n, W) uint32")
        words = np.asarray(words, dtype=np.uint32)
        if words.ndim != 2 or words.shape[1] != self.cfg.key_heap_words:
            raise ValueError(f"words must be (n, {self.cfg.key_heap_words})")
        hi, lo = hashing.np_key_identity_from_words(words)
        return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                     .to(self.device) for a in (hi, lo, words))

    def _values(self, values):
        return torch.from_numpy(
            np.ascontiguousarray(values, dtype=np.uint32).view(np.int32)).to(self.device)

    # -- device-side routing (lazy recovery + batch planning) -----------------

    def _segments_of(self, hi, lo):
        """Physical segment of every key, hashed and looked up on the card."""
        h1, _, _ = hashmix.bulk_hash(hi, lo)
        return engine.locate(self.cfg, self.mode, self.state, h1)[0]

    _pow2 = staticmethod(engine._pow2_at_least)

    @staticmethod
    def _lane_quantum(n: int, floor: int = 8) -> int:
        """Round lane capacity up to a pow2 or 1.5*pow2 level (the
        reference's planning rule, kept so both packages plan alike)."""
        n = max(int(n), 1)
        p = max(floor, 1 << (n - 1).bit_length())
        mid = p // 2 + p // 4          # the 1.5*pow2 level below p
        return mid if n <= mid and mid >= floor else p

    @staticmethod
    def _max_per_segment(seg) -> int:
        live = seg[seg >= 0]
        return int(torch.bincount(live).max()) if live.numel() else 1

    def _write_plan(self, seg, n_total: int, fused_ok: bool = True):
        """(batching, capacity) for a mutating batch from its per-key segment
        ids: the exact lane capacity (max keys routed to one segment), and
        the fused path for small batches, else segment-parallel.
        ``fused_ok=False`` (delete/update) skips fused.

        The reference also falls back to its sequential scan engine when
        the capacity is not much shorter than the batch, because under
        ``vmap`` each of its lane steps pays for every segment. A lane step
        here costs the same for 2 segments as for 20k, so segment-parallel
        (``capacity`` steps) never loses to the scan (one step per key); the
        two give identical tables, and the scan stays the tests' oracle."""
        capacity = self._lane_quantum(self._max_per_segment(seg))
        if (fused_ok and n_total <= self.fused_threshold
                and fused.fused_insert_eligible(self.cfg)):
            return "fused", capacity
        return "segment", capacity

    def _search_plan(self, n: int) -> str:
        """The fused one-kernel path for small batches, the fingerprint
        kernel path for large batches on eligible configs, per-key vmap
        otherwise."""
        if n <= self.fused_threshold and fused.fused_search_eligible(self.cfg):
            return "fused"
        if n >= 256 and engine.pallas_search_eligible(self.cfg):
            return "pallas"
        return "vmap"

    def _ensure_recovered(self, touched):
        """Lazy per-segment recovery over precomputed touched segment ids."""
        if not self.lazy_recovery:
            return

        def note(segs, affected):
            # recovery may continue an in-flight SMO: the side-linked
            # neighbor (either direction) and the directory are fair game
            self.dirty.note_segments(affected)
            self.dirty.note_dir()

        self.state, recovered = recovery.lazy_recover_touched(
            self.cfg, self.mode, self.state, touched, note=note)
        self.recovered_segments += len(recovered)
        if self.obs is not None:
            for seg in recovered:
                self.obs.registry.counter("table.lazy_recoveries").inc()
                self.obs.tracer.instant("lazy_recovery", "recovery",
                                        segment=int(seg))

    # -- public ops -----------------------------------------------------------

    def insert_begin(self, keys=None, values=None, words=None) -> InsertJob:
        """Start a resumable insert batch (see InsertJob)."""
        hi, lo, w = self._prep(keys, words)
        n = hi.shape[0]
        return InsertJob(
            hi=hi, lo=lo, w=w, vals=self._values(values),
            out=torch.full((n,), NEED_SPLIT, dtype=torch.int32, device=self.device),
            pending=torch.arange(n, device=self.device))

    def insert_round(self, job: InsertJob) -> bool:
        """One insert dispatch over the job's pending subset. Updates
        ``job.out``/``job.pending``; does NOT run SMOs. Returns the LH
        stash-activation signal."""
        pending = job.pending
        hi, lo = job.hi[pending], job.lo[pending]
        # per-key segments: recomputed each round (splits remap keys)
        seg = self._segments_of(hi, lo)
        self.dirty.note_segments(seg)
        if job.first:
            self._ensure_recovered(seg)
        batching, capacity = self._write_plan(seg, pending.numel())
        self.state, statuses, activated = engine.insert_batch(
            self.cfg, self.mode, self.state, hi, lo, job.vals[pending], None,
            batching=batching, capacity=capacity,
            words=None if job.w is None else job.w[pending])
        job.out[pending] = statuses
        job.pending = pending[statuses == NEED_SPLIT]
        job.first = False
        job.rounds += 1
        self.insert_rounds += 1
        return bool(activated)

    def pressure_hints(self, job: InsertJob) -> np.ndarray:
        """Touched segments of the job's pending keys under the CURRENT
        directory."""
        seg = self._segments_of(job.hi[job.pending], job.lo[job.pending])
        return torch.unique(seg[seg >= 0]).cpu().numpy()

    def insert(self, keys=None, values=None, words=None, max_retries: int = 256):
        """Stop-the-world insert: pump the resumable job, splitting inline
        whenever a round reports pressure. Returns statuses (numpy)."""
        job = self.insert_begin(keys, values, words)
        for _ in range(max_retries):
            activated = self.insert_round(job)
            if activated:
                self._on_pressure(None)   # LH: stash-allocation split trigger
            if job.done:
                return job.out.cpu().numpy()
            self._on_pressure(self.pressure_hints(job))
        raise TableFullError("insert retry budget exhausted")

    def search(self, keys=None, words=None):
        """(found bool, values uint32) numpy arrays."""
        hi, lo, w = self._prep(keys, words)
        if self.lazy_recovery:
            self._ensure_recovered(self._segments_of(hi, lo))
        found, vals = engine.search_batch(self.cfg, self.mode, self.state, hi, lo,
                                          batching=self._search_plan(hi.shape[0]),
                                          words=w)
        return found.cpu().numpy(), vals.cpu().numpy().view(np.uint32)

    def delete(self, keys=None, words=None):
        hi, lo, w = self._prep(keys, words)
        seg = self._segments_of(hi, lo)
        self._ensure_recovered(seg)
        self.dirty.note_segments(seg)
        batching, capacity = self._write_plan(seg, seg.numel(), fused_ok=False)
        self.state, statuses = engine.delete_batch(
            self.cfg, self.mode, self.state, hi, lo,
            batching=batching, capacity=capacity, words=w)
        return statuses.cpu().numpy()

    def update(self, keys=None, values=None, words=None):
        hi, lo, w = self._prep(keys, words)
        seg = self._segments_of(hi, lo)
        self._ensure_recovered(seg)
        self.dirty.note_segments(seg)
        batching, capacity = self._write_plan(seg, seg.numel(), fused_ok=False)
        self.state, statuses = engine.update_batch(
            self.cfg, self.mode, self.state, hi, lo, self._values(values),
            batching=batching, capacity=capacity, words=w)
        return statuses.cpu().numpy()

    # -- lifecycle -------------------------------------------------------------

    def attach_writeback(self, wb):
        """Bind a durable PM-pool writeback engine (persist/writeback.py);
        ``flush()`` (and the serving frontend's publish) then mirror every
        acknowledged batch into the pool in O(dirty) bytes."""
        self.writeback = wb
        if self.obs is not None:
            wb.attach_obs(self.obs)

    def attach_obs(self, obs):
        """Bind an observability bundle (obs/): the table counts lazy
        recoveries and staged SMOs into its registry and propagates the
        bundle to an attached writeback (flush spans, scrub counters)."""
        self.obs = obs
        if self.writeback is not None:
            self.writeback.attach_obs(obs)

    def flush(self) -> int:
        """Make the live state durable: drain the dirty tracker and write
        only the dirty planes to the attached pool (ordered flush+fence —
        the acknowledgment point of the durable contract). Reads
        ``self.state`` now, whatever tensors an earlier publish handed out.
        Returns bytes written."""
        if self.writeback is None:
            raise RuntimeError("no pool attached (persist.create)")
        return self.writeback.flush(self.state, self.dirty.drain())

    def close(self):
        """Durable clean shutdown: set the clean marker and flush, so the
        next ``persist.reopen`` skips recovery entirely (paper Sec. 4.8's
        graceful path)."""
        self.graceful_shutdown()
        if self.writeback is not None:
            self.flush()
            self.writeback.pool.close()

    def graceful_shutdown(self):
        """Set the clean-shutdown marker: the next restart skips recovery."""
        self.state.clean.fill_(True)

    def restart(self):
        """Instant recovery (Sec. 4.8): O(1) work, constant in data size —
        one scalar read and at most one scalar write. Returns the work
        record (``clean``, ``seconds``). (Volatile restart of the live
        state; the durable equivalent — map the pool, read the superblock,
        same constant work — is ``persist.reopen``.)"""
        self.state, work = recovery.instant_restart(self.state)
        self.dirty.note_full()   # lazy recovery will rewrite at first touch
        return work

    def crash(self, rng: np.random.Generator | None = None, **kw):
        """Leave crash artifacts in the live state (``recovery.simulate_crash``
        keywords). The surgery rewrites planes WITHOUT version bumps, so the
        next publish (and durable flush) must not trust the version diff.
        With a pool attached, ``crash(); flush()`` emulates a crash with its
        artifacts IN the pool: they land durably and the reopened pool must
        recover them lazily."""
        self.dirty.note_full()
        self.state = recovery.simulate_crash(self.cfg, self.mode, self.state,
                                             rng or np.random.default_rng(0), **kw)

    # -- stats ----------------------------------------------------------------

    @property
    def load_factor(self) -> float:
        return float(layout.load_factor(self.cfg, self.state))

    @property
    def n_items(self) -> int:
        return int(self.state.n_items)

    @property
    def n_segments(self) -> int:
        return int(self.state.watermark)

    # -- structural modifications ---------------------------------------------

    def _on_pressure(self, seg_hint):
        raise NotImplementedError

    def smo_task_eligible(self) -> bool:
        """True iff pressure SMOs run through the staged bulk pipeline."""
        return self.smo_mode == "bulk" and smo.rebuild_eligible(self.cfg)

    def make_smo_task(self, seg_hint):
        raise NotImplementedError

    def _pump_smo(self, task):
        """Run every stage of a staged SMO task inline, then surface a
        planning shortfall as pool exhaustion (the feasible splits landed)."""
        self.note_smo(task)
        done = False
        while not done:
            self.state, done = task.pump(self.state)
        if task.shortfall:
            raise TableFullError("segment pool exhausted")

    def note_smo(self, task):
        """Record a staged SMO's dirty footprint (rebuilt + directory planes)."""
        self.dirty.note_segments(task.touched)
        self.dirty.note_dir()
        if self.obs is not None:
            self.obs.registry.counter("table.smo_tasks").inc()
            self.obs.registry.counter("table.smo_segments").inc(
                int(np.asarray(task.touched).size))


class DashEH(DashTable):
    """Dash extendible hashing (paper Sec. 4)."""

    mode = "eh"

    def _check_depth(self, segs):
        """Shared depth-exhaustion guard of the bulk and scalar paths."""
        idx = torch.as_tensor(np.asarray(segs, np.int64), device=self.device)
        if bool((self.state.local_depth[idx] >= self.cfg.dir_depth_max).any()):
            raise TableFullError("directory depth exhausted")

    def make_smo_task(self, seg_hint):
        """Bulk EH pressure plan: allocate every new id up front (recycled
        merge victims first, then the pool watermark) so all pressured
        segments split in one staged pipeline with one directory publish."""
        if seg_hint is None:
            return None                 # EH ignores stash-activation signals
        segs = [int(s) for s in np.asarray(seg_hint).reshape(-1)]
        self._check_depth(segs)
        wm = self.n_segments
        new_ids = []
        for _ in segs:
            if self.free_segments:
                new_ids.append(self.free_segments.pop())
            elif wm < self.cfg.max_segments:
                new_ids.append(wm)
                wm += 1
            else:
                break
        if not new_ids:
            raise TableFullError("segment pool exhausted")
        return smo.BulkSplitTask(self.cfg, segs[:len(new_ids)], new_ids,
                                 self.device, shortfall=len(segs) - len(new_ids))

    def _on_pressure(self, seg_hint):
        if seg_hint is None:
            return                      # EH ignores stash-activation signals
        if not self.smo_task_eligible():
            segs = [int(s) for s in np.asarray(seg_hint).reshape(-1)]
            self._check_depth(segs)
            return self._on_pressure_scalar(segs)
        task = self.make_smo_task(seg_hint)
        if task is not None:
            self._pump_smo(task)

    def _on_pressure_scalar(self, segs):
        """Reference path: scan-rehash SMOs, recycled ids first. A round's
        splits rehash together (``split_phase2_scan_many``), which gives the
        result of running them one after another; the splits that got an
        id land before the pool runs out. (The reference counts a recycled
        id against the watermark too, and so can report the pool exhausted
        early.)"""
        wm = self.n_segments
        olds, news = [], []
        for seg in segs:
            if self.free_segments:
                new_id = self.free_segments.pop()
            elif wm < self.cfg.max_segments:
                new_id, wm = wm, wm + 1
            else:
                break
            olds.append(seg)
            news.append(new_id)
        if olds:
            self.dirty.note_segments(olds + news)
            self.dirty.note_dir()
            for old, new in zip(olds, news):
                dash_eh.split_phase1(self.cfg, self.state, old, new)
            self.state, ok = dash_eh.split_phase2_scan_many(self.cfg, self.state,
                                                           olds, news)
            if not ok:
                raise AssertionError("split rehash failed to refit records")
        if len(olds) < len(segs):
            raise TableFullError("segment pool exhausted")

    @property
    def global_depth(self) -> int:
        return int(self.state.global_depth)

    def shrink(self) -> int:
        """Merge buddy segment pairs while their combined records fit under
        ``SHRINK_TARGET_FILL`` of one segment (paper Sec. 4.7: merge on low
        load factor). Freed ids are recycled by later splits. Returns merges.

        Each round plans every fitting pair from one buddy-pair scan and one
        counts pass, and the bulk path merges all of them in one call (the
        reference merges a round in fixed chunks of 8 pairs, which its jit
        needs and which gives the same state: the pairs are disjoint);
        cascading merges land in the next round."""
        cap = int(self.cfg.seg_capacity * SHRINK_TARGET_FILL)
        use_bulk = self.smo_task_eligible()
        merges = 0
        while True:
            counts = self._segment_counts()
            dirv = self.state.dir.cpu().numpy()
            depths = self.state.local_depth.cpu().numpy()
            pairs = smo.find_buddy_pairs(self.cfg, dirv, depths)
            if pairs.size:
                pairs = pairs[counts[pairs[:, 0]] + counts[pairs[:, 1]] <= cap]
            if pairs.size == 0:
                return merges
            c0, c1 = counts[pairs[:, 0]], counts[pairs[:, 1]]
            victim = np.where(c0 <= c1, pairs[:, 0], pairs[:, 1])
            keep = np.where(c0 <= c1, pairs[:, 1], pairs[:, 0])
            self.dirty.note_segments(pairs)
            self.dirty.note_dir()
            if use_bulk:
                kt, vt = (torch.from_numpy(x.astype(np.int32)).to(self.device)
                          for x in (keep, victim))
                self.state, ok = smo.bulk_merge(
                    self.cfg, self.state, kt, vt,
                    torch.ones(keep.size, dtype=torch.bool, device=self.device))
                redo = np.nonzero(~ok.cpu().numpy())[0]
            else:
                redo = range(keep.size)
            for i in redo:
                self.state, ok1 = dash_eh.merge_segments_scan(
                    self.cfg, self.state, int(keep[i]), int(victim[i]))
                if not ok1:
                    raise AssertionError("merge failed to refit records")
            self.free_segments.extend(int(v) for v in victim)
            merges += pairs.shape[0]

    def _segment_counts(self) -> np.ndarray:
        """Records per segment, from the packed bucket counts."""
        return layout.meta_count(self.state.meta).sum(1).cpu().numpy()


class DashLH(DashTable):
    """Dash linear hashing (paper Sec. 5)."""

    mode = "lh"

    #: bulk expansion stride (paper Sec. 5.2 hybrid expansion: grow by a
    #: segment-array stride, not one segment — see
    #: dash_lh.hybrid_expansion_directory)
    expansion_stride = 8

    def _check_headroom(self):
        """(watermark, Next, round size) after the pool/round bound checks
        the bulk and scalar paths share."""
        cfg = self.cfg
        wm = self.n_segments
        if wm >= cfg.max_segments:
            raise TableFullError("segment pool exhausted")
        level, nxt = (int(x) for x in layout.lh_level_next(self.state.lh_word))
        round_size = (1 << cfg.lh_base_log2) << level
        if round_size + nxt >= cfg.max_segments:
            raise TableFullError("lh directory exhausted")
        return wm, nxt, round_size

    def make_smo_task(self, seg_hint=None):
        """Bulk stride expansion plan: split Next..Next+R-1 in one staged
        SMO, capped at the round boundary and the pool/directory headroom.
        LH pressure ignores the segment hint (it always splits at Next)."""
        cfg = self.cfg
        wm, nxt, round_size = self._check_headroom()
        R = max(1, min(self.expansion_stride, round_size - nxt,
                       cfg.max_segments - wm,
                       cfg.max_segments - (round_size + nxt)))
        old_phys = self.state.lh_dir[nxt:nxt + R].cpu().numpy()
        return smo.BulkSplitNextTask(
            cfg, R, touched=np.concatenate([old_phys, wm + np.arange(R)]))

    def _on_pressure(self, seg_hint):
        if not self.smo_task_eligible():
            wm, nxt, _ = self._check_headroom()
            self.dirty.note_segments([int(self.state.lh_dir[nxt]), wm])
            self.state, ok = dash_lh.split_next_scan(self.cfg, self.state)
            if not ok:
                raise AssertionError("LH split rehash failed to refit records")
            return
        self._pump_smo(self.make_smo_task(seg_hint))

    @property
    def active_segments(self) -> int:
        return dash_lh.lh_active_segments(self.cfg, self.state)
