"""Host-facing Dash tables: batch planning + split retry.

The card does the data-plane work (hashing, batched probes/inserts, SMOs);
the host plays the paper's "goto retry" loop (Alg. 1 line 31): when a batch
reports NEED_SPLIT, the host runs the SMO and retries the failed subset.
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
from . import dash_eh, engine, hashing, layout, recovery, smo
from .epoch import DirtyHint
from .layout import NEED_SPLIT, DashConfig, DashState


class TableFullError(RuntimeError):
    pass


class DirtyTracker:
    """Dirty-plane accounting for the copy-on-write publish: every mutating
    path notes the segments it routed writes to (the same per-key segment
    ids that feed ``route_lanes``) plus whether the directory changed. The
    segments are kept as per-segment counts on the table's device, so noting
    a batch costs no host transfer; ``drain`` reads them back."""

    def __init__(self, num_segments: int, device):
        self._hits = torch.zeros(num_segments, dtype=torch.int32, device=device)
        self.dir = False

    def note_segments(self, ids):
        ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids) else ids,
                              device=self._hits.device).reshape(-1).long()
        self._hits.index_add_(0, ids.clamp(min=0), (ids >= 0).to(torch.int32))

    def note_dir(self):
        self.dir = True

    @property
    def segments(self) -> set:
        return set(self._hits.nonzero()[:, 0].tolist())

    @property
    def any(self) -> bool:
        return self.dir or bool(self._hits.any())

    def drain(self) -> DirtyHint:
        hint = DirtyHint(self.segments, self.dir)
        self._hits.zero_()
        self.dir = False
        return hint


@dataclasses.dataclass
class InsertJob:
    """Resumable insert batch: the state of one ``insert`` retry loop, kept
    on the table's device."""
    hi: torch.Tensor
    lo: torch.Tensor
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
        self.dirty = DirtyTracker(cfg.max_segments, self.device)

    # -- key plumbing --------------------------------------------------------

    def _prep(self, keys):
        return hashing.split_keys(keys, self.device)

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
        self.state, recovered = recovery.lazy_recover_touched(
            self.cfg, self.mode, self.state, touched)
        self.recovered_segments += len(recovered)

    # -- public ops -----------------------------------------------------------

    def insert_begin(self, keys, values) -> InsertJob:
        """Start a resumable insert batch (see InsertJob)."""
        hi, lo = self._prep(keys)
        n = hi.shape[0]
        return InsertJob(
            hi=hi, lo=lo, vals=self._values(values),
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
            batching=batching, capacity=capacity)
        job.out[pending] = statuses
        job.pending = pending[statuses == NEED_SPLIT]
        job.first = False
        job.rounds += 1
        return bool(activated)

    def pressure_hints(self, job: InsertJob) -> np.ndarray:
        """Touched segments of the job's pending keys under the CURRENT
        directory."""
        seg = self._segments_of(job.hi[job.pending], job.lo[job.pending])
        return torch.unique(seg[seg >= 0]).cpu().numpy()

    def insert(self, keys, values, max_retries: int = 256):
        """Stop-the-world insert: pump the resumable job, splitting inline
        whenever a round reports pressure. Returns statuses (numpy)."""
        job = self.insert_begin(keys, values)
        for _ in range(max_retries):
            activated = self.insert_round(job)
            if activated:
                self._on_pressure(None)   # LH: stash-allocation split trigger
            if job.done:
                return job.out.cpu().numpy()
            self._on_pressure(self.pressure_hints(job))
        raise TableFullError("insert retry budget exhausted")

    def search(self, keys):
        """(found bool, values uint32) numpy arrays."""
        hi, lo = self._prep(keys)
        if self.lazy_recovery:
            self._ensure_recovered(self._segments_of(hi, lo))
        found, vals = engine.search_batch(self.cfg, self.mode, self.state, hi, lo,
                                          batching=self._search_plan(hi.shape[0]))
        return found.cpu().numpy(), vals.cpu().numpy().view(np.uint32)

    def delete(self, keys):
        hi, lo = self._prep(keys)
        seg = self._segments_of(hi, lo)
        self._ensure_recovered(seg)
        self.dirty.note_segments(seg)
        batching, capacity = self._write_plan(seg, seg.numel(), fused_ok=False)
        self.state, statuses = engine.delete_batch(
            self.cfg, self.mode, self.state, hi, lo,
            batching=batching, capacity=capacity)
        return statuses.cpu().numpy()

    def update(self, keys, values):
        hi, lo = self._prep(keys)
        seg = self._segments_of(hi, lo)
        self._ensure_recovered(seg)
        self.dirty.note_segments(seg)
        batching, capacity = self._write_plan(seg, seg.numel(), fused_ok=False)
        self.state, statuses = engine.update_batch(
            self.cfg, self.mode, self.state, hi, lo, self._values(values),
            batching=batching, capacity=capacity)
        return statuses.cpu().numpy()

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


class DashEH(DashTable):
    """Dash extendible hashing (paper Sec. 4)."""

    mode = "eh"

    def _check_depth(self, segs):
        """Shared depth-exhaustion guard of the bulk and scalar paths."""
        idx = torch.as_tensor(np.asarray(segs, np.int64), device=self.device)
        if bool((self.state.local_depth[idx] >= self.cfg.dir_depth_max).any()):
            raise TableFullError("directory depth exhausted")

    def make_smo_task(self, seg_hint):
        """Bulk EH pressure plan: allocate every new id up front off the
        pool watermark so all pressured segments split in one staged
        pipeline with one directory publish."""
        if seg_hint is None:
            return None                 # EH ignores stash-activation signals
        segs = [int(s) for s in np.asarray(seg_hint).reshape(-1)]
        self._check_depth(segs)
        wm = self.n_segments
        new_ids = list(range(wm, min(wm + len(segs), self.cfg.max_segments)))
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
        """Reference path: one scan-rehash SMO per segment."""
        wm = self.n_segments
        for seg in segs:
            if wm >= self.cfg.max_segments:
                raise TableFullError("segment pool exhausted")
            self.dirty.note_segments([seg, wm])
            self.dirty.note_dir()
            self.state, ok = dash_eh.split_segment(self.cfg, self.state, seg,
                                                   impl="scan")
            if not ok:
                raise AssertionError("split rehash failed to refit records")
            wm += 1

    @property
    def global_depth(self) -> int:
        return int(self.state.global_depth)
