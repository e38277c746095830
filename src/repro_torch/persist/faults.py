"""Deterministic fault injection for the emulated-PM pool.

Ported from ``repro.persist.faults``: the same numpy RNG calls run in the
same order, so one seed flips and tears the same bytes in either package.

The crash matrix only kills a flush at emulated-store boundaries — the
crash-only model. Real persistent memory also fails *inside* and *around*
stores ("Data Structure Primitives on Persistent Memory", PAPERS.md):

  torn persist   — at a scheduled fence, a seeded subset of the cachelines
                   written since the previous fence never reach media and
                   the process dies (``TornPersist``). Reopen sees a file
                   where individual 64-byte lines of a row are old while
                   neighbors are new — the failure the per-row checksum
                   region exists to catch.
  bit rot        — ``flip_bits`` flips seeded bits inside persisted
                   record-plane bytes (or, with ``flip_csum_frac``
                   probability, inside the stored checksum word itself —
                   both sides of the compare are untrusted media).
  transient EIO  — scheduled fences raise ``FlushError(errno.EIO)`` a
                   bounded number of times. Short bursts are absorbed by
                   the writeback's retry-with-backoff; longer ones trip the
                   DEGRADED path (serving continues volatile).
  ENOSPC         — pool create fails with ``ENOSPC``; the pool layer must
                   clean up the partial file and raise a diagnosable error.

A ``FaultPlan`` is seeded and fully deterministic: the same seed replays
the same faults, which is what makes the chaos matrix (``persist/chaos.py``)
debuggable. One plan may span several pool generations
(create → crash → reopen → …): ``fence_calls`` counts fences plan-globally,
so schedules are addressed in absolute fence time.

The plan is intrusive on purpose — it reverts bytes in the pool's mapping
using the pool's store journal (pre-images of every store since the last
fence, maintained while ``journal_needed()``) — but the pool never imports
this module: plans are attached by callers, keeping production paths free
of injection logic.
"""
from __future__ import annotations

import dataclasses
import errno
from typing import Dict, FrozenSet

import numpy as np

from repro_torch.core import layout
from .pool import FlushError
from .writeback import SimulatedCrash

LINE = layout.POOL_ALIGN               # torn-persist granularity (64 B)


class TornPersist(SimulatedCrash):
    """A fence tore: some cachelines of the pre-fence store window were
    reverted to their pre-images and the process 'died'. Like every
    SimulatedCrash the engine that observes it becomes dead; the harness
    reopens the pool file, which now holds the torn image."""


@dataclasses.dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule for one pool lineage.

    ``torn_fences`` / ``eio_fences`` are addressed by plan-global fence
    index (the value of ``fence_calls`` when the fence is attempted).
    An EIO entry is a burst: the fence at that index fails ``n`` times
    (retries included — the index does not advance on failure) before
    succeeding, so ``n <= retry_limit`` is transparent to callers and
    ``n > retry_limit`` forces the writeback into DEGRADED."""
    seed: int = 0
    torn_fences: FrozenSet[int] = frozenset()
    torn_line_frac: float = 0.5        # P(revert) per written cacheline
    eio_fences: Dict[int, int] = dataclasses.field(default_factory=dict)
    enospc_creates: int = 0            # next N creates fail with ENOSPC
    flip_csum_frac: float = 0.15       # P(a flip targets the checksum word)
    # -- counters (observability; not part of the schedule) --
    fence_calls: int = 0
    tears: int = 0
    eio_raised: int = 0
    flips: int = 0
    enospc_raised: int = 0
    torn_bytes: int = 0

    # -- hooks called by PmPool -------------------------------------------

    def journal_needed(self) -> bool:
        """True while a tear is still scheduled at or after the current
        fence index — the pool keeps store pre-images only when a future
        tear might need them."""
        return any(f >= self.fence_calls for f in self.torn_fences)

    def on_create(self, path: str, nbytes: int):
        if self.enospc_creates > 0:
            self.enospc_creates -= 1
            self.enospc_raised += 1
            raise OSError(errno.ENOSPC,
                          f"no space left on device (injected; {nbytes} "
                          f"bytes requested)", path)

    def on_fence(self, pool):
        idx = self.fence_calls
        burst = self.eio_fences.get(idx, 0)
        if burst > 0:
            # failed fences do not advance the index: a retry storms the
            # same schedule entry until its burst budget drains
            self.eio_fences[idx] = burst - 1
            self.eio_raised += 1
            raise FlushError(
                f"injected transient I/O error at fence {idx} "
                f"({burst - 1} left in burst)", err=errno.EIO)
        self.fence_calls += 1
        if idx in self.torn_fences:
            self._tear(pool, idx)

    # -- fault mechanics ---------------------------------------------------

    def _tear(self, pool, idx: int):
        """Revert a seeded subset of the cachelines written since the last
        successful fence (their pre-images live in the pool's journal),
        then die. Lines are independent: one store op can land partially —
        precisely the sub-store atomicity violation checksums detect."""
        rng = np.random.default_rng((self.seed << 16) ^ (0x7EA2 + idx))
        reverted = 0
        for off, old in pool._journal:
            n = len(old)
            if n == 0:
                continue
            first, last = off // LINE, (off + n - 1) // LINE
            drop = rng.random(last - first + 1) < self.torn_line_frac
            for j in np.flatnonzero(drop):
                ln = first + int(j)
                a = max(off, ln * LINE)
                b = min(off + n, (ln + 1) * LINE)
                pool._mm[a:b] = np.frombuffer(old[a - off:b - off],
                                              dtype=np.uint8)
                reverted += b - a
        self.tears += 1
        self.torn_bytes += reverted
        raise TornPersist(
            f"torn msync at fence {idx}: {reverted} bytes of "
            f"{len(pool._journal)} store extents reverted to pre-images")

    def flip_bits(self, pool, n: int = 1) -> int:
        """Flip ``n`` seeded bits in persisted record-plane bytes (media
        rot). With probability ``flip_csum_frac`` a flip lands in the
        stored checksum word instead of the row data — either way the
        row verifies bad, which is the property that matters (we never
        trust a row whose pair disagrees). The redo-log and superblock
        regions are deliberately out of scope: the superblock has its own
        CRC'd two-slot scheme (tested separately) and log loss is modeled
        at descriptor granularity (``PmPool.log_lost``)."""
        rng = np.random.default_rng((self.seed << 16) ^ (0xB17 + self.flips))
        names = list(layout.CSUM_PLANES)
        weights = np.array([pool.spec(nm).nbytes for nm in names], np.float64)
        weights /= weights.sum()
        for _ in range(n):
            nm = names[int(rng.choice(len(names), p=weights))]
            s = pool.spec(nm)
            row = int(rng.integers(s.rows))
            if rng.random() < self.flip_csum_frac:
                off = pool.csum.offset_of(nm) + 4 * row + \
                    int(rng.integers(4))
            else:
                off = s.offset + row * s.row_nbytes + \
                    int(rng.integers(s.row_nbytes))
            pool._mm[off] ^= np.uint8(1 << int(rng.integers(8)))
            self.flips += 1
        return n

    def stats(self) -> dict:
        return {"fence_calls": self.fence_calls, "tears": self.tears,
                "eio_raised": self.eio_raised, "flips": self.flips,
                "enospc_raised": self.enospc_raised,
                "torn_bytes": self.torn_bytes}
