#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Dash (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--keys N] [--lh-keys N] [--fe-keys N]

Phases, each printed on its own line and each able to fail the run:

  1. the card's name and power limit; build the four CUDA kernels from
     ``src/repro_torch/kernels/csrc`` with nvcc (one process per source);
  2. ``bulk_hash`` against its plain PyTorch version on 1M keys plus a
     ragged tail and the edge words;
  3. small op streams through the port on the card and on the CPU, each
     pair ending byte-identical in answers and planes: an EH stream; an LH
     stream (stride splits, both read plans, deletes, updates); crash
     streams (EH with an interrupted split, and LH: crash, restart, lazy
     recovery on reads, inserts of live keys answer EXISTS); a shrink
     stream (80 % deletes, shrink, refills that recycle freed ids); the
     CPU tests' mixed frontend stream through DashFrontend over DashEH and
     over DashLH, with fused and with routed reads (per-op outcomes,
     ``stats()`` apart from the seconds, and the tables equal); a
     pointer-mode stream (2-word keys in a key heap); durable streams whose
     pool files (under the git-ignored ``build/pools``) must also be
     byte-identical after every flush: ``persist.create`` for EH and for LH
     with inserts through splits, deletes and updates, one flush killed at
     a fixed store, ``reopen`` with lazy reads, ``crash()`` + ``flush()``
     and a second reopen; a seeded ``FaultPlan`` bit flip quarantined at
     reopen; one ``chaos.run_schedule`` seed (equal counters);
  3b. ``fused_probe`` and ``fingerprint_probe`` against their plain
     versions on seeded hostile inputs (``kernels/edges.py``): first-hit
     order, fingerprint collisions, the stash gate, out-of-range rows and
     segment ids, 1, 2 or 4 stash rows active, unaligned and ragged lanes;
  4. the main path at full size: a DashEH in the default geometry with
     ``max_segments=32768, dir_depth_max=17`` (~430 MB of planes on the
     card) loaded with 20M unique uniform 8-byte keys (batches grow with
     the table), searched in 1M-key batches of hits and of misses (the
     fingerprint-kernel plan), 1000 serving ticks of 256 mixed keys (the
     fused plan), 64k deletes and 64k updates, and every answer checked
     against a numpy ground truth. The kernel launch counters are set to 0
     just before and read just after;
  5. ``fingerprint_probe`` (direct lanes, and routed lanes with padding)
     and ``fused_probe`` (256-lane ticks with stash hits) against their
     plain versions on the filled table;
  6. each kernel's device time (from the profiler), its wrapper call's and
     its plain version's time, and its bound; ``fingerprint_probe`` also at
     4096 and 65,536 lanes and with its planes warm in L2; ``fused_probe``'s
     latency floor (an empty launch plus three dependent HBM loads, each
     timed by a one-thread pointer chase through 512 MiB) and its wrapper's
     host time per call; the card's busy share over one traced load batch
     and 50 traced ticks;
  7. recovery on the filled main-path table: a seeded crash (held locks,
     displacement duplicates, wiped overflow metadata), the host time of
     ``restart()``, the first 1M-key read batch with its lazy recovery,
     every answer against the ground truth until every segment has
     recovered, then a second crash recovered eagerly by ``recover_all``;
  7b. the serving frontend at full width: a fresh DashEH in the main
     path's geometry loaded with 4M keys (cut from 8M by the time limit),
     then a split storm of 262,144 fresh inserts, one read of a loaded key
     per insert, an update every third and 128 YCSB-A ops (zipfian 0.99)
     per 256 inserts, through DashFrontend (max_batch 256) and through
     StopTheWorldFrontend on a clone of the loaded state: every read pre-
     or post-update, the same write statuses and record multisets, every
     insert found, no hint miss, no snapshot plane on live storage,
     ``fused_probe`` exact on the pinned snapshot in the middle of a staged
     split; read sojourn p50/p99 of both frontends, publishes and their
     mean bytes against the state, the retried share, the busy share of
     50 traced ticks. Launch counters as on the main path;
  7c. the durable pool at full width, on the frontend's table after its
     storm: a fresh pool file (969 MB logical, 433 MB of planes) attached
     and checkpointed by a full flush; a split storm of 65,536 fresh
     inserts (the 7b stream's shape) through DashFrontend with
     flush-on-publish, the scrubber every tick and the flight recorder;
     the table dropped without ``close()``, reopened without and with
     checksum verification, the first 1M-key read recovering lazily and
     every acknowledged key checked; one flush carrying an SMO torn at its
     commit fence by a ``FaultPlan``, forensics on the dead pool naming
     exactly that flush's keys as in flight, and every acknowledged key
     found after a last reopen. Checkpoint seconds, flushes, flushed and
     staged bytes, flush seconds split into device staging and pool I/O,
     read sojourn with flush-on-publish, scrubbed rows, both reopen times,
     the first read, free disk and the busy share of 50 traced ticks.
     Launch counters as on the main path;
  8. the LH path: a DashLH in the paper's geometry (``max_segments=32768,
     num_stash=4``, ~445 MB of planes) loaded with unique uniform keys in
     batches sized to its stride growth, then the main path's reads,
     ticks, deletes and updates against a ground truth, its launch
     counters (set to 0 just before, read just after); then fresh keys
     that hash into one segment fill it until all 4 of its stash rows are
     active, and both read kernels are held to their plain versions on
     the filled LH table, on lanes and ticks that reach that segment;
     ``fingerprint_probe`` timed at 1M LH lanes;
  9. shrink: a DashEH in the main path's pool geometry loaded with 0.5M
     keys, 0.4M deleted, ``shrink()``, the survivors and the deleted keys
     checked, then 0.25M fresh keys inserted: the watermark may grow only
     once the freed ids are used up;
 10. baselines: ``level_scan`` exact against its plain version (the
     3000-key level-hashing stream's batches, full and masked, and a key
     that inserts by the move); then the same 1M unique uniform keys (cut
     from 2M by the time limit) loaded into Dash-EH, CCEH and Bucketized
     (32768 segments at most, in the main path's growing batches) and level hashing (``max_log2=20``,
     ~82 MB of planes, in Fig. 7's 4096-key batches) with the launch
     counters set to 0 just before and read just after: insert rates, the load factor after every 1/16 of the load
     (Fig. 12's curve), 1M positive and 1M negative searches, every key
     found with its value and no absent key found, the busy share of one
     traced level-hashing and one traced CCEH load batch; both read
     kernels exact on the Bucketized planes (no stash) and timed there;
     Fig. 13's optimistic and pessimistic search of 2048 keys on a clone
     of the Dash-EH table (equal answers, versions up 4 per touch);
     ``level_scan`` exact and timed at the load's 4096-key batch on the
     loaded table; the prefix cache (1000 prompts of 256 tokens from 64
     shared prefixes, cut from 2000 by the time limit; 4096 pages,
     evictions) and the dedup stream of
     ``examples/dedup_pipeline.py``. Phase 3 also streams level hashing
     (through 6 rehashes), CCEH, Bucketized, the pessimistic search (EH
     and LH), the prefix cache and the dedup filter on the card and on the
     CPU, byte-identical.

Each kernel's ``launches`` in the JSON line is the sum over the five
paths driven with counters (the EH main path, the frontend, the durable
path, the LH path and the baselines' load). The durable line also prints
the bytes that really crossed to the host a flush. The last three
lines are the card line, one JSON object describing every kernel, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside the tensor cores
SECTOR = 32                      # bytes per DRAM access sector
DEVICE = "cuda"                  # a CPU rehearsal of the phases sets "cpu"
#: Depths set by the run's time limit. The host drives every path, so a
#: run's time swings with the host: at LH 12M, frontend 6M and shrink 2M
#: one whole run took 1130 s of its 1200. The LH path is cut first: its
#: load is one insert round per ~3400 keys (LH splits only at Next). The
#: 32768-segment LH pool holds ~16M keys in any case: once the 16384 ->
#: 32768 burst ends, the next stash activation finds the LH directory
#: exhausted.
LH_KEYS = 4_000_000
#: the frontend phase: keys loaded, then fresh keys of its split storm
FE_KEYS = 4_000_000
FE_FRESH = 1 << 18
#: the shrink phase: keys loaded (80 % then deleted), then fresh keys
#: (cut from 1M when the baselines phase came: whole runs took 925-1250 s
#: of the 1200 with the host's speed)
SHRINK_KEYS = 500_000
#: the durable phase's storm: fresh inserts through flush-on-publish (cut
#: from 65,536 by the time limit: every flush fences the 969 MB mapping)
DURABLE_FRESH = 1 << 15
#: pool files (the emulated PM) live here, under the git-ignored build/
POOL_DIR = Path(__file__).resolve().parent / "build" / "pools"

KERNELS = {   # name: (source, TPU kernel it replaces)
    "bulk_hash": ("src/repro_torch/kernels/csrc/hashmix.cu",
                  "src/repro/kernels/hashmix.py:34"),
    "fingerprint_probe": ("src/repro_torch/kernels/csrc/probe.cu",
                          "src/repro/kernels/probe.py:69"),
    "fused_probe": ("src/repro_torch/kernels/csrc/fused.cu",
                    "src/repro/kernels/fused.py:279"),
    # no Pallas kernel: the reference's jitted lax.scan of level_insert_one
    "level_scan": ("src/repro_torch/kernels/csrc/level.cu",
                   "src/repro/core/baselines.py:192"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 30, flush_mb: int = 0, setup=None) -> float:
    """Median device time of one call (CUDA events around each call, after
    two warm-up calls); with ``flush_mb`` a buffer that size is rewritten
    before each call so the call finds the 50 MB L2 cold. ``setup`` runs
    before each call, outside the timed span."""
    flush = (torch.empty(flush_mb << 20, dtype=torch.uint8, device=DEVICE)
             if flush_mb else None)
    setup = setup or (lambda: None)
    for _ in range(2):
        setup()
        fn()
    times = []
    for _ in range(reps):
        setup()
        if flush is not None:
            flush.fill_(1)
        if DEVICE != "cuda":                   # CPU rehearsal: host clock
            s = time.perf_counter()
            fn()
            times.append((time.perf_counter() - s) * 1e3)
            continue
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_events(prof):
    return [e for e in prof.events() if str(e.device_type).endswith("CUDA")]


def kernel_ms(fn, kernel: str, reps: int = 30, flush_mb: int = 0, setup=None) -> float:
    """Median device time of one launch of ``kernel`` inside ``fn``, from the
    profiler's record of the card (the wrapper's host time excluded); event
    timing of the whole call where the profiler records no device time.
    ``setup`` runs before each call and is never timed."""
    if DEVICE != "cuda":
        return time_ms(fn, reps, flush_mb, setup)
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(flush_mb << 20, dtype=torch.uint8, device=DEVICE)
             if flush_mb else None)
    setup = setup or (lambda: None)
    setup()
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            setup()
            if flush is not None:
                flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _device_events(prof) if kernel in e.name]
    if not times:
        log(f"  profiler recorded no {kernel} launch: timing whole calls")
        return time_ms(fn, reps, flush_mb, setup)
    return float(np.median(times)) / 1e3


def busy_share(fn):
    """(wall s, device-busy s, top device ops, result) of one traced run of
    ``fn``: the card's idle share is 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    per = {}
    for e in dev:
        per[e.name[:60]] = per.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy, top, out


def distinct_keys(start: int, n: int) -> np.ndarray:
    """``n`` distinct uniform 64-bit keys: splitmix64 of a counter range
    (a bijection, so distinct ranges give disjoint key sets, no sort)."""
    z = np.arange(start, start + n, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def bound(nbytes: float, ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def sectors(byte_offsets) -> int:
    """Distinct 32-byte sectors holding the given byte offsets."""
    return int(torch.unique(byte_offsets // SECTOR).numel())


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"phase build: ok {time.perf_counter() - t0:.1f}s {path.name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas {line.strip()}")


def phase_bulk_hash(report, m: int = 1 << 20):
    from repro_torch.kernels import hashmix
    n = m + 777                                       # 1M keys + a ragged tail
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    words[0, :36] = np.repeat(edge, 6)
    words[1, :36] = np.tile(edge, 6)
    hi, lo = (torch.from_numpy(w.view(np.int32)).to(DEVICE) for w in words)
    got = hashmix.bulk_hash(hi, lo)
    want = hashmix.bulk_hash_plain(hi, lo)
    sync()
    err = max_abs_err(got, want)
    check(err == 0, f"bulk_hash differs from its plain version (max err {err})")
    check(bool((got[0] < 0).any()), "no h1 >= 2**31 among the test keys")
    h, l = hi[:m].contiguous(), lo[:m].contiguous()
    ms = kernel_ms(lambda: hashmix.bulk_hash(h, l), "bulk_hash_kernel", flush_mb=128)
    call_ms = time_ms(lambda: hashmix.bulk_hash(h, l), flush_mb=128)
    plain_ms = time_ms(lambda: hashmix.bulk_hash_plain(h, l), reps=10, flush_mb=128)
    # two hash_pair calls, ~22 integer ops each, plus the fp mask
    report["bulk_hash"] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                               plain_ms=plain_ms, shape=f"{m} keys",
                               bound=bound(m * (8 + 12), ops=m * 45.0))
    log(f"phase bulk_hash: ok exact on {n} keys")


def _stream_keys(seed: int, n: int):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2**63, n + n // 3, dtype=np.uint64))[:n]
    keys = rng.permutation(keys)
    return keys, rng.integers(0, 2**32, keys.size, dtype=np.uint64).astype(np.uint32)


def _op_stream(cfg, device, seed: int, table: str = "DashEH",
               cuts=(300, 1500, 5000, 12000)):
    """Inserts of every plan (fused / segment, with splits) in batches ending
    at ``cuts``, reads of both plans, deletes and updates; returns the table
    and every answer."""
    from repro_torch import core
    keys, vals = _stream_keys(seed, cuts[-1])
    t = getattr(core, table)(cfg, device=device)
    out = []
    for a, b in zip((0,) + cuts[:-1], cuts):
        out.append(t.insert(keys[a:b], vals[a:b]))
    out += list(t.search(keys[:cuts[-2]])) + list(t.search(keys[cuts[-2]:cuts[-2] + 300]))
    out.append(t.delete(keys[::9]))
    out.append(t.update(keys[1::7], vals[::7][:keys[1::7].size]))
    out += list(t.search(keys))
    return t, out


def _crash_stream(cfg, device, seed: int, table: str):
    """Fill, crash with every artifact class (an interrupted split on EH),
    restart, read (lazy recovery, the split continued), then re-insert
    live keys. Returns the table and every answer."""
    from repro_torch import core
    from repro_torch.core import layout
    keys, vals = _stream_keys(seed, 6000)
    t = getattr(core, table)(cfg, device=device)
    out = [t.insert(keys, vals)]
    t.crash(np.random.default_rng(seed), lock_frac=0.2, n_dups=8, wipe_overflow=True,
            interrupt_smo=table == "DashEH")
    out.append((t.state.seg_state == layout.SEG_SPLITTING).cpu().numpy())
    t.restart()
    out += list(t.search(keys[:300])) + list(t.search(keys))
    out.append(t.insert(keys[:500], vals[:500]))
    out.append(np.array([t.recovered_segments, t.n_items]))
    return t, out


def _shrink_stream(cfg, device, seed: int):
    """Fill, delete 80 %, shrink, refill with fresh keys (the splits take
    the freed ids). Returns the table and every answer."""
    from repro_torch.core import DashEH
    keys, vals = _stream_keys(seed, 11000)
    t = DashEH(cfg, device=device)
    out = [t.insert(keys[:8000], vals[:8000]), t.delete(keys[:6400])]
    out.append(np.array([t.n_segments, t.shrink(), len(t.free_segments)]))
    out += list(t.search(keys[:8000]))
    out.append(t.insert(keys[8000:], vals[8000:]))
    out.append(np.array([t.n_segments] + t.free_segments))
    return t, out


def _frontend_ops(seed: int, n_load: int = 400, n_fresh: int = 200):
    """The shape of the CPU tests' mixed stream: a load, then fresh inserts
    each followed by a read of a loaded key, an update every third. Ops as
    (kind, key, value) tuples."""
    from repro_torch.workloads import ycsb
    from repro_torch.serving import frontend as fe
    rng = np.random.default_rng(seed)
    keys = ycsb.load_keys(rng, n_load + n_fresh)
    loaded, fresh = keys[:n_load], keys[n_load:]
    load = [(fe.INSERT, int(k), ycsb.expected_value(int(k))) for k in loaded]
    storm = []
    ridx = rng.integers(0, n_load, n_fresh)
    for i, k in enumerate(fresh):
        group = [(fe.INSERT, int(k), ycsb.expected_value(int(k))),
                 (fe.READ, int(loaded[ridx[i]]), 0)]
        if i % 3 == 0:
            kk = int(loaded[ridx[i]])
            group.append((fe.UPDATE, kk, ycsb.updated_value(kk)))
        storm.append(group)
    return load, storm


def _frontend_stream(device, seed: int, fused_reads=None):
    """The mixed stream through a DashFrontend over DashEH and over DashLH
    at the CPU tests' config, one tick after every second group of the
    storm (so reads overlap staged splits). Returns the LH table and every answer:
    per-op outcomes, stats() without the seconds, the SMO counts."""
    from repro_torch.core import DashConfig, DashEH, DashLH
    from repro_torch.core.epoch import shared_planes
    from repro_torch.serving import frontend as fe
    cfg = DashConfig(max_segments=32, dir_depth_max=7, num_buckets=16, num_slots=8)
    load, storm = _frontend_ops(seed)
    out = []
    for cls in (DashEH, DashLH):
        f = fe.DashFrontend(cls(cfg, device=device), max_batch=128,
                            queue_depth=1 << 14, fused_reads=fused_reads)
        ops = [fe.Op(*o) for o in load]
        for op in ops:
            f.submit(op)
        f.drain()
        for i, group in enumerate(storm):
            for o in group:
                ops.append(fe.Op(*o))
                f.submit(ops[-1])
            if i % 2:
                f.step()
            check(not shared_planes(f.registry.current.state, f.table.state),
                  "a snapshot plane shares storage with a live plane")
        f.drain()
        stats = f.stats()
        stats.pop("publish_seconds")
        out.append(np.array([(op.status, op.found, op.result) for op in ops], np.int64))
        out.append(np.array([f.snapshot_reads, f.retried_reads, f.smo_stages,
                             f.smo_dispatches] + [stats[k] for k in sorted(stats)
                                                  if k != "health"]))
    return f.table, out


def _pointer_stream(device, seed: int):
    """Pointer mode (keys are 2-word rows in a key heap): inserts through
    splits, searches of hits and misses, deletes, updates, re-inserts."""
    from repro_torch.core import DashConfig, DashEH
    cfg = DashConfig(max_segments=64, dir_depth_max=8, num_buckets=16, num_slots=8,
                     pointer_mode=True, key_heap_size=4096, key_heap_words=2)
    rng = np.random.default_rng(seed)
    rows = np.unique(rng.integers(0, 2**32, (2600, 2), dtype=np.uint64).astype(np.uint32),
                     axis=0)
    rows = rows[rng.permutation(rows.shape[0])][:2500]
    keys, absent = rows[:2000], rows[2000:]
    vals = np.arange(2000, dtype=np.uint32) + 1
    t = DashEH(cfg, device=device)
    out = [t.insert(None, vals[a:b], keys[a:b])
           for a, b in ((0, 400), (400, 1200), (1200, 2000))]
    out += list(t.search(None, np.concatenate([keys, absent])))
    out.append(t.delete(None, keys[::4]))
    out.append(t.update(None, vals[1::4] + 7000, keys[1::4]))
    out.append(t.insert(None, vals[:400], keys[:400]))
    out += list(t.search(None, keys))
    out.append(np.array([t.n_segments, int(t.state.heap_top)]))
    return t, out


LEVEL_SMALL = dict(max_log2=10, init_log2=4)


def _level_batches(keys, vals, n_batches: int = 6, size: int = 500):
    """Batches of ``size`` fresh keys, each followed by 20 keys of the batch
    before (they answer EXISTS)."""
    for i in range(n_batches):
        a, b = i * size, (i + 1) * size
        yield (np.concatenate([keys[a:b], keys[max(0, a - 20):a]]),
               np.concatenate([vals[a:b], vals[max(0, a - 20):a]]))


def _level_stream(device, seed: int):
    """Level hashing, 3000 keys in 6 batches (through its rehashes): the
    statuses and the state after every batch, then searches of hits and
    misses."""
    from repro_torch import interop
    from repro_torch.core.baselines import LevelConfig, LevelHashing
    keys, vals = _stream_keys(seed, 3000)
    t = LevelHashing(LevelConfig(**LEVEL_SMALL), device=device)
    out = []
    for k, v in _level_batches(keys, vals):
        out.append(t.insert(k, v))
        out += [a.copy() for a in interop.level_state_to_numpy(t.state).values()]
    out += list(t.search(np.concatenate([keys, keys | np.uint64(1 << 63)])))
    out.append(np.array([int(t.state.k), int(t.state.n_rehashes), t.n_items]))
    return None, out


def _pessimistic_stream(device, seed: int):
    """Fig. 13's read-locking search on a clone of a loaded EH and LH table:
    answers and the version plane."""
    from repro_torch.core import DashConfig, DashEH, DashLH, DashState, engine, hashing
    keys, vals = _stream_keys(seed, 2000)
    probe = np.concatenate([keys[:200], keys[:56] | np.uint64(1 << 63)])
    out = []
    for cls, cfg in ((DashEH, DashConfig(max_segments=64, dir_depth_max=10)),
                     (DashLH, DashConfig(max_segments=256, num_stash=4))):
        t = cls(cfg, device=device)
        t.insert(keys, vals)
        st = DashState(*(x.clone() for x in t.state))
        hi, lo = hashing.split_keys(probe, device)
        st, f, v = engine.search_batch_pessimistic(cfg, t.mode, st, hi, lo)
        out += [f.cpu().numpy(), v.cpu().numpy(), st.version.cpu().numpy()]
    return None, out


def _prefix_stream(device, seed: int):
    """A prefix cache of 48 pages over 30 prompts from 4 shared prefixes:
    lookups, admissions, LRU evictions; every answer and the host state."""
    from repro_torch.serving.prefix_cache import BLOCK, DashPrefixCache
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, 32000, 48) for _ in range(4)]
    cache = DashPrefixCache(num_pages=48, device=device)
    out = []
    for i in range(30):
        tokens = np.concatenate([prefixes[i % 4], rng.integers(1, 32000, 16 * (1 + i % 3))])
        pages, n = cache.match_prefix(tokens)
        out.append(np.array(pages + [n]))
        out.append(np.array(cache.admit(tokens, n // BLOCK)))
    out += [np.array(cache.free), np.array(sorted(cache.lru.items())).ravel(),
            np.array(sorted(cache.page_owner.items()), np.uint64).ravel(),
            np.array(list(vars(cache.stats).values()))]
    return cache.table, out


def _dedup_stream(device, seed: int):
    """Packed batches through the Dash-LH dedup stage (25 % duplicates)."""
    from repro_torch.data import DedupFilter, PackedBatcher, PipelineConfig
    pc = PipelineConfig(vocab_size=32000, seq_len=256, batch_size=4, seed=seed,
                        dup_fraction=0.25, doc_len_min=32, doc_len_max=96)
    d = DedupFilter(device=device)
    b = PackedBatcher(pc, dedup=d)
    out = [b.next_batch()["tokens"] for _ in range(8)]
    out.append(np.array([b.docs_seen, b.docs_skipped, d.unique_docs]))
    return d.table, out


def _fixed_recorder():
    """A flight recorder whose clocks count calls: the same stream writes
    the same recorder windows, so pool files compare byte for byte."""
    from repro_torch.obs import FlightRecorder
    ticks = iter(range(1 << 40))
    return FlightRecorder(clock=lambda: float(next(ticks)), wall=lambda: 0.0)


def _pool_crc(path) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read())


def _durable_stream(cfg, mode, device, seed: int, path: str):
    """A durable table (``persist.create``, a recorder with fixed clocks):
    inserts through splits (rebuilt rows through the redo log), deletes and
    updates, each batch flushed; one flush killed at a fixed store; reopen
    and lazy reads; ``crash()`` + ``flush()``; a second reopen and reads.
    Every acknowledged key is checked after each reopen. Returns the last
    table and every answer, among them each flush's bytes and counters and
    the pool file's CRC after every flush; the last answer is (flushes,
    rows logged, segments recovered)."""
    from repro_torch import persist
    from repro_torch.persist import SimulatedCrash
    keys, vals = _stream_keys(seed, 6000)
    t = persist.create(path, cfg, mode=mode, device=device)
    t.writeback.attach_recorder(_fixed_recorder())
    out, logged, recovered = [], 0, 0

    def flush():
        nonlocal logged
        n = t.flush()
        wb = t.writeback
        logged = max(logged, wb.logged_rows)
        out.append(np.array([n, _pool_crc(path), wb.last_dirty_rows, wb.logged_rows,
                             wb.staged_bytes, wb.pool.sb.flush_seq]))

    for a, b in ((0, 300), (300, 1500), (1500, 4000)):
        out.append(t.insert(keys[a:b], vals[a:b]))
        flush()
    alive, truth = np.ones(4000, bool), vals[:4000].copy()
    alive[::9] = False
    truth[1::7] = vals[::7][:truth[1::7].size] ^ np.uint32(0x5A5A)
    out.append(t.delete(keys[:4000:9]))
    out.append(t.update(keys[1:4000:7], truth[1::7]))
    flush()
    out.append(t.insert(keys[4000:], vals[4000:]))
    t.writeback.inject_crash(7)                       # dies before its 8th store
    try:
        t.flush()
        torn = False
    except SimulatedCrash:
        torn = True
    check(torn, f"{mode} durable stream: the injected crash did not fire")
    for cut in ("torn flush", "crash"):
        del t
        t, info = persist.reopen(path, device=device)
        t.writeback.attach_recorder(_fixed_recorder())
        out.append(np.array([info[k] for k in sorted(info) if k != "seconds"], np.int64))
        found, got = t.search(keys)
        check((found[:4000] == alive).all() and (got[:4000][alive] == truth[alive]).all(),
              f"{mode} durable stream: an acknowledged key is wrong after the {cut}")
        out += [found, got]
        recovered += t.recovered_segments
        out.append(np.array([t.recovered_segments, t.n_items]))
        flush()
        if cut == "torn flush":
            t.crash(np.random.default_rng(seed), lock_frac=0.2, n_dups=8,
                    interrupt_smo=mode == "eh")
            flush()
    out.append(np.array([sum(o.size == 6 for o in out), logged, recovered]))
    return t, out


def _fault_stream(cfg, device, seed: int, path: str):
    """A closed pool rotted by a seeded ``FaultPlan`` (bit flips in rows and
    in checksum words), reopened with verification: the quarantine report,
    the reopen record and every read. Returns the table and the answers."""
    from repro_torch import persist
    from repro_torch.persist import FaultPlan, PmPool
    keys, vals = _stream_keys(seed, 3000)
    t = persist.create(path, cfg, device=device)
    out = [t.insert(keys, vals)]
    t.close()
    plan = FaultPlan(seed=seed, flip_csum_frac=0.3)
    pool = PmPool.open(path, faults=plan)
    plan.flip_bits(pool, n=8)
    pool.close()
    del t
    t, info = persist.reopen(path, device=device)
    out.append(np.array([info[k] for k in sorted(info) if k != "seconds"], np.int64))
    out.append(np.array([[r["seg"], r["bucket"], r["row"], r.get("lost_records", -1)]
                         for r in t.lost_report]))
    out += list(t.search(keys))
    t.close()
    out.append(np.array([_pool_crc(path)]))
    check(info["quarantined_bt"] + info["quarantined_nb"] > 0, "no row was quarantined")
    return t, out


def _chaos_stream(device, seed: int, path: str):
    """One seeded chaos schedule (tears, flips, EIO bursts, scrubs, clean
    restarts) on the durable table; its counters as the answer."""
    import dataclasses
    from repro_torch.persist import chaos
    os.makedirs(path, exist_ok=True)
    res = chaos.run_schedule(seed, path, min_tears=1, min_flips=1, device=device)
    check(res.wrong_reads == res.silent_lost == res.forensics_contradictions == 0,
          f"chaos seed {seed}: {res}")
    vals = [int(v) for k, v in dataclasses.asdict(res).items()]
    return None, [np.array(vals)]


def phase_cuda_vs_cpu():
    from repro_torch import interop
    from repro_torch.core import DashConfig
    from repro_torch.core.baselines import bucketized_config, cceh_config
    eh = DashConfig(max_segments=64, dir_depth_max=10, init_depth=3)
    lh = DashConfig(max_segments=256, num_stash=4)

    def pool(name, dev):   # the card's run and the CPU's run write apart
        return str(POOL_DIR / f"{name}-{'cpu' if dev == 'cpu' else 'card'}.pool")

    durable = {   # name: run(dev) -> (table, answers), pools at pool(name, dev)
        "durable eh": lambda dev: _durable_stream(eh, "eh", dev, 12, pool("durable eh", dev)),
        "durable lh": lambda dev: _durable_stream(lh, "lh", dev, 13, pool("durable lh", dev)),
        "fault plan": lambda dev: _fault_stream(eh, dev, 14, pool("fault plan", dev)),
        "chaos": lambda dev: _chaos_stream(dev, 1, pool("chaos", dev)),
    }
    shutil.rmtree(POOL_DIR, ignore_errors=True)
    POOL_DIR.mkdir(parents=True)
    streams = {
        "eh": lambda dev: _op_stream(eh, dev, 5),
        "lh": lambda dev: _op_stream(lh, dev, 6, "DashLH"),
        "eh crash": lambda dev: _crash_stream(eh, dev, 7, "DashEH"),
        "lh crash": lambda dev: _crash_stream(lh, dev, 8, "DashLH"),
        "shrink": lambda dev: _shrink_stream(eh, dev, 9),
        "frontend": lambda dev: _frontend_stream(dev, 10),
        "frontend routed reads": lambda dev: _frontend_stream(dev, 10, fused_reads=False),
        "pointer": lambda dev: _pointer_stream(dev, 11),
        **durable,
        "level": lambda dev: _level_stream(dev, 15),
        "cceh": lambda dev: _op_stream(cceh_config(64, 8), dev, 16,
                                       cuts=(300, 1500, 2200, 3000)),
        "bucketized": lambda dev: _op_stream(
            bucketized_config(max_segments=64, dir_depth_max=8), dev, 17,
            cuts=(300, 1500, 2200, 3000)),
        "pessimistic": lambda dev: _pessimistic_stream(dev, 18),
        "prefix cache": lambda dev: _prefix_stream(dev, 19),
        "dedup": lambda dev: _dedup_stream(dev, 20),
    }
    t0 = time.perf_counter()
    facts = {}
    for name, run in streams.items():
        t_gpu, out_gpu = run(DEVICE)
        t_cpu, out_cpu = run("cpu")
        check(len(out_gpu) == len(out_cpu), f"{name}: answer counts differ")
        for i, (a, b) in enumerate(zip(out_gpu, out_cpu)):
            check(np.array_equal(a, b), f"{name}: answer {i} differs between cuda and cpu")
        if t_gpu is not None:
            a, b = interop.state_to_numpy(t_gpu.state), interop.state_to_numpy(t_cpu.state)
            bad = [k for k in a if a[k].tobytes() != b[k].tobytes()]
            check(not bad, f"{name}: cuda and cpu states differ in {bad}")
        if name in durable and name != "chaos":
            with open(pool(name, DEVICE), "rb") as f, open(pool(name, "cpu"), "rb") as g:
                check(f.read() == g.read(), f"{name}: cuda and cpu pool files differ")
        facts[name] = (t_gpu, out_gpu)
    shutil.rmtree(POOL_DIR, ignore_errors=True)
    t_eh, t_lh = facts["eh"][0], facts["lh"][0]
    check(t_eh.n_segments > 8, "op stream made too few splits")
    check(t_lh.n_segments > 8, "LH stream made too few stride splits")
    for name, seed in (("eh crash", 7), ("lh crash", 8)):
        t, out = facts[name]
        check(out[-2].tolist() == [1] * 500, f"{name}: a live key was not EXISTS")
        check(out[4].all() and (out[5] == _stream_keys(seed, 6000)[1]).all(),
              f"{name}: a key was lost in the crash")
        check(t.recovered_segments > 0, f"{name}: nothing was recovered")
    check(facts["eh crash"][1][1].sum() == 1, "the EH crash interrupted no split")
    _, out = facts["shrink"]
    before, merges, freed = out[2]
    refill = out[-1]
    check(merges > 0 and refill[0] == before and len(refill) - 1 < freed,
          f"shrink stream: {merges} merges, watermark {before} -> {refill[0]}, "
          f"free {freed} -> {len(refill) - 1}")
    fe_counts = []
    for name in ("frontend", "frontend routed reads"):
        _, out = facts[name]
        for table, (res, counts) in (("eh", out[:2]), ("lh", out[2:])):
            check(counts[3] > 0, f"{name} {table}: no SMO ran staged")
            fe_counts.append(f"{table} {counts[2]} stages / {counts[1]} retried")
    check(np.array_equal(facts["frontend"][1][0], facts["frontend routed reads"][1][0]),
          "the fused-read and routed-read frontends answered differently")
    t_ptr, out = facts["pointer"]
    check(out[3][:2000].all() and not out[3][2000:].any() and out[-1][0] > 2,
          f"pointer stream: {int(out[3].sum())} of 2000 keys found, "
          f"{out[-1][0]} segments")
    durable_facts = []
    for name in ("durable eh", "durable lh"):
        n_flushes, logged, recovered = facts[name][1][-1]
        check(logged > 0, f"{name}: no rebuilt row went through the redo log")
        check(recovered > 0, f"{name}: nothing was recovered after a reopen")
        durable_facts.append(f"{name.split()[1]} {n_flushes} flushes, {logged} rows "
                             f"logged, {recovered} segments recovered")
    _, out = facts["fault plan"]
    durable_facts.append(f"bit rot: {len(out[2])} rows quarantined")
    durable_facts.append("chaos seed 1: " + ", ".join(
        f"{k} {v}" for k, v in zip(("ops", "flushes", "crashes"), facts["chaos"][1][0][1:4])))
    lvl = facts["level"][1][-1]
    check(lvl[1] > 0 and lvl[2] == 3000, f"level stream: k {lvl[0]}, {lvl[1]} rehashes, "
          f"{lvl[2]} items")
    _, out = facts["pessimistic"]
    for i, what in ((0, "eh"), (3, "lh")):
        check(out[i][:200].all() and not out[i][200:].any(), f"pessimistic {what}: wrong found")
    pc_stats = facts["prefix cache"][1][-1]
    check(pc_stats[4] > 0 and pc_stats[1] > 0, f"prefix cache stream: stats {pc_stats}")
    seen, skipped, unique = facts["dedup"][1][-1]
    check(skipped > 0 and unique == seen - skipped, f"dedup stream: {seen} {skipped} {unique}")
    baseline_facts = (
        f"level hashing k {lvl[0]} after {lvl[1]} rehashes; CCEH "
        f"{facts['cceh'][0].n_segments} segments, load factor "
        f"{facts['cceh'][0].load_factor:.3f}; bucketized {facts['bucketized'][0].n_segments} "
        f"segments, load factor {facts['bucketized'][0].load_factor:.3f}; pessimistic EH and "
        f"LH; prefix cache {pc_stats[4]} evictions; dedup {skipped} of {seen} docs skipped")
    log(f"phase cuda_vs_cpu: ok byte-identical states after 12000 inserts, "
        f"{t_eh.n_segments} segments, deletes/updates/searches; LH stream "
        f"{t_lh.n_segments} segments; crash streams (EH with an interrupted split, "
        f"LH) recovered {facts['eh crash'][0].recovered_segments} / "
        f"{facts['lh crash'][0].recovered_segments} segments lazily; shrink stream "
        f"{merges} merges, {freed - (len(refill) - 1)} freed ids recycled; "
        f"frontend streams (fused / routed reads; SMO stages / retried reads) "
        f"{', '.join(fe_counts)}; pointer stream {t_ptr.n_segments} segments, heap_top "
        f"{int(t_ptr.state.heap_top)}; durable streams with byte-identical pool files "
        f"after every flush ({'; '.join(durable_facts)}); baselines and apps "
        f"({baseline_facts}) ({time.perf_counter() - t0:.1f}s)")


def phase_edges():
    """Both read kernels against their plain versions on the seeded hostile
    inputs of ``kernels/edges.py``: 512 lanes for ns = 2 and 4 with
    fingerprints on and off, the same lanes tiled to 1M + 3 (2 lanes a
    thread, an odd count) and offset by one word."""
    from repro_torch.kernels import edges, fused, probe
    t0 = time.perf_counter()
    err_fused = err_fp = n_lanes = 0
    for ns in (2, 4):
        case = edges.read_kernel_edges(7 + ns, ns=ns)
        planes, lanes = edges.to_torch(case, DEVICE)
        big = tuple(x.repeat((1 << 20) // x.numel() + 1)[:(1 << 20) + 3].contiguous()
                    for x in lanes)
        for ls in (lanes, big, tuple(x[1:] for x in big)):
            for use_fp in (True, False):
                kw = dict(nb=case["nb"], ns=ns, use_fp=use_fp)
                err_fused = max(err_fused, max_abs_err(fused.fused_probe(*planes, *ls, **kw),
                                                       fused.fused_probe_plain(*planes, *ls, **kw)))
            args = planes[:2] + ls[:4]
            err_fp = max(err_fp, max_abs_err(probe.fingerprint_probe(*args),
                                             probe.fingerprint_probe_plain(*args)))
            n_lanes += ls[0].numel()
    sync()
    check(err_fused == 0, f"fused_probe differs from its plain version on hostile inputs "
          f"(max err {err_fused})")
    check(err_fp == 0, f"fingerprint_probe differs from its plain version on hostile inputs "
          f"(max err {err_fp})")
    log(f"phase edges: ok both read kernels exact on {n_lanes} hostile lanes "
        f"(ns 2 and 4, fingerprints on and off; {time.perf_counter() - t0:.1f}s)")


def eh_batch(t) -> int:
    """EH load batches grow with the table: ~64 new keys per segment."""
    return max(256, 64 * t.n_segments)


def lh_batch(t) -> int:
    """LH load batches: 8 keys per segment, capped at 8192 keys. LH splits
    only at Next, at most two strides of 8 segments per insert round (one
    on the stash-activation signal, one on pressure), so the table grows by
    at most ~16 x 610 keys of room a round; a bigger batch only piles up
    keys in segments that wait for Next."""
    return min(max(256, 8 * t.n_segments), 8192)


#: retry rounds an LH insert may take. A key whose segment filled before
#: Next reached it waits until Next gets there: up to round_size / 16
#: rounds (2 strides of 8 a round), i.e. more than the default 256 once a
#: round spans 4096 segments. The reference's LH has the same bound.
LH_RETRIES = 4096


def phase_main_path(cfg, n_keys: int, n_ticks: int, report, table: str = "DashEH",
                    name: str = "main", batch_keys=eh_batch, retries: int = 256):
    """Load, read, serve ticks, delete and update through ``table`` at full
    size, every answer against a numpy ground truth. The launch counters
    are set to 0 just before and read just after; they are added to each
    kernel's ``launches``. Returns (table, keys, misses, summary, truth)."""
    from repro_torch import core
    from repro_torch.core import engine
    from repro_torch.kernels import fused, hashmix, probe

    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    n_tick_keys = 64 * (n_ticks + 50)
    keys = distinct_keys(0, n_keys)                        # the live set
    tick_new = distinct_keys(n_keys, n_tick_keys)          # inserted by ticks
    misses = distinct_keys(n_keys + n_tick_keys, 1 << 20)  # never inserted
    vals = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    log(f"  {name}: {n_keys} keys generated in {time.perf_counter() - t0:.1f}s")

    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    t = getattr(core, table)(cfg, device=DEVICE)
    state_mb = sum(x.numel() * x.element_size() for x in t.state) / 2**20
    sync()

    # ---- load: batches grow with the table ----
    t0 = time.perf_counter()
    done, n_batches, load_trace = 0, 0, None
    while done < n_keys:
        n = min(batch_keys(t), n_keys - done)
        batch = (keys[done:done + n], vals[done:done + n])
        if load_trace is None and done >= n_keys // 2 and DEVICE == "cuda":
            # one traced batch: the card's busy share during the load
            *load_trace, st = busy_share(lambda: t.insert(*batch, max_retries=retries))
            load_trace.append(n)
        else:
            st = t.insert(*batch, max_retries=retries)
        check((st == 0).all(), f"load batch {n_batches}: statuses {np.bincount(st)}")
        done += n
        n_batches += 1
        if n_batches % (20 if batch_keys is eh_batch else 200) == 0:
            log(f"  {name}: load {done} keys, {t.n_segments} segments, "
                f"{time.perf_counter() - t0:.1f}s")
    sync()
    load_s = time.perf_counter() - t0
    log(f"  {name}: loaded {n_keys} keys in {n_batches} batches, {load_s:.1f}s "
        f"({n_keys / load_s / 1e6:.3f} Mops/s), {t.n_segments} segments, "
        f"{int(t.state.n_splits)} splits, {t.insert_rounds} insert rounds, state {state_mb:.0f} MB, "
        f"load factor {t.load_factor:.3f}")

    # ---- 1M-key searches: hits and misses (fingerprint-kernel plan) ----
    B = 1 << 20
    t0 = time.perf_counter()
    n_hit = 0
    for a in range(0, min(n_keys, 4 * B), B):
        f, v = t.search(keys[a:a + B])
        check(f.all() and (v == vals[a:a + B]).all(), f"search batch at {a} wrong")
        n_hit += f.size
    f, _ = t.search(misses)
    check(not f.any(), "a missing key was found")
    sync()
    search_s = time.perf_counter() - t0
    n_searched = n_hit + misses.size
    log(f"  {name}: searched {n_searched} keys in 1M batches, {search_s:.2f}s "
        f"({n_searched / search_s / 1e6:.3f} Mops/s)")

    # ---- serving ticks: 128 hits + 64 misses read, 64 new keys inserted ----
    live_extra = []
    lat = []
    t0 = time.perf_counter()
    for i in range(n_ticks):
        q = np.concatenate([keys[rng.integers(0, n_keys, 128)],
                            misses[rng.integers(0, misses.size, 64)]])
        new = tick_new[64 * i:64 * (i + 1)]
        new_vals = (np.arange(new.size, dtype=np.uint32) + 64 * i) ^ np.uint32(0xA5A5A5A5)
        s = time.perf_counter()
        f, v = t.search(q)
        st = t.insert(new, new_vals, max_retries=retries)
        lat.append(time.perf_counter() - s)
        check(f[:128].all() and not f[128:].any(), f"tick {i}: wrong found mask")
        check((st == 0).all(), f"tick {i}: insert statuses {np.bincount(st)}")
        live_extra.append((new, new_vals))
    ticks_s = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    log(f"  {name}: {n_ticks} ticks of 256 keys in {ticks_s:.1f}s: p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms, p99 {np.percentile(lat_ms, 99):.3f} ms")
    if DEVICE == "cuda":
        # 50 more ticks, traced: the card's busy share at serving time
        def traced_ticks():
            for i in range(n_ticks, n_ticks + 50):
                f, _ = t.search(np.concatenate([keys[rng.integers(0, n_keys, 128)],
                                                misses[rng.integers(0, misses.size, 64)]]))
                new = tick_new[64 * i:64 * (i + 1)]
                new_vals = np.arange(new.size, dtype=np.uint32)
                st = t.insert(new, new_vals, max_retries=retries)
                check(f[:128].all() and not f[128:].any() and (st == 0).all(),
                      f"traced tick {i} wrong")
                live_extra.append((new, new_vals))
        for what, (wall, busy, top) in (
                ("50 ticks", busy_share(traced_ticks)[:3]),
                (f"one load batch of {load_trace[3]} keys", load_trace[:3])):
            log(f"  trace {name} {what}: wall {wall * 1e3:.1f} ms, card busy {busy * 1e3:.1f} ms "
                f"(idle share {1 - busy / wall:.3f}); top: "
                + "; ".join(f"{k} {v:.2f} ms" for k, v in top))

    # ---- deletes and updates, then every answer against the ground truth ----
    n_mut = min(65536, n_keys // 4)
    pick = rng.permutation(n_keys)[:2 * n_mut]
    dele, upd = pick[:n_mut], pick[n_mut:]
    check((t.delete(keys[dele]) == 0).all(), "a delete missed")
    new_vals = vals[upd] ^ np.uint32(0x5A5A5A5A)
    check((t.update(keys[upd], new_vals) == 0).all(), "an update missed")
    truth = vals.copy()
    truth[upd] = new_vals
    alive = np.ones(n_keys, bool)
    alive[dele] = False
    t0 = time.perf_counter()
    for a in range(0, n_keys, B):
        f, v = t.search(keys[a:a + B])
        check((f == alive[a:a + B]).all(), f"verify batch at {a}: found mask wrong")
        check((v[f] == truth[a:a + B][f]).all(), f"verify batch at {a}: values wrong")
    extra_k = np.concatenate([k for k, _ in live_extra])
    extra_v = np.concatenate([v for _, v in live_extra])
    f, v = t.search(extra_k)
    check(f.all() and (v == extra_v).all(), "a key inserted during ticks is wrong")
    f, _ = t.search(misses)
    check(not f.any(), "a missing key was found after deletes")
    expect = int(alive.sum()) + extra_k.size
    recount = int(engine.recount_items(t.state))
    check(t.n_items == recount == expect,
          f"n_items {t.n_items} recount {recount} expected {expect}")
    sync()
    verify_s = time.perf_counter() - t0
    launches = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                "fused_probe": fused.LAUNCHES}
    for kernel, count in launches.items():
        check(count > 0 or DEVICE != "cuda", f"{kernel} was not launched on the {name} path")
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})[name] = count
        r["launches"] = sum(r["paths"].values())
    log(f"  {name}: deletes/updates applied, {expect} live keys verified in "
        f"{verify_s:.1f}s, n_items == recount_items == {expect}")
    log(f"phase {name}_path: ok launches {launches}")
    summary = dict(insert_mops=n_keys / load_s / 1e6,
                   search_mops=n_searched / search_s / 1e6,
                   tick_p50_ms=float(np.percentile(lat_ms, 50)),
                   tick_p99_ms=float(np.percentile(lat_ms, 99)),
                   keys=n_keys, segments=t.n_segments, state_mb=state_mb,
                   load_factor=t.load_factor)
    truth = dict(alive=alive, values=truth, extra_k=extra_k, extra_v=extra_v)
    return t, keys, misses, summary, truth


def _stash_keys(t, limit: int, seg=None):
    """(hi, lo) words of up to ``limit`` records living in stash rows (of
    segment ``seg`` only, if given)."""
    cfg, st = t.cfg, t.state
    NB = cfg.num_buckets
    rows = slice(None) if seg is None else slice(seg, seg + 1)
    alloc = (st.meta[rows, NB:].long() & 0x3FFF)
    bits = ((alloc[..., None] >> torch.arange(cfg.num_slots, device=alloc.device)) & 1) == 1
    hi, lo = st.key_hi[rows, NB:][bits], st.key_lo[rows, NB:][bits]
    return hi[:limit], lo[:limit]


def _fill_stash(t):
    """Insert fresh keys that hash into one LH segment, a few at a time,
    until all ``num_stash`` of its stash rows are active, so that both read
    kernels meet a full stash gate on the real table at any load depth.
    The segment is the one whose split lies furthest ahead of Next (Next's
    own split just before it, or the last of the round), so the splits its
    stash activations set off reach other segments. Every key is read back.
    Returns (segment, keys)."""
    from repro_torch.core import engine, hashing, layout
    from repro_torch.kernels import hashmix
    cfg = t.cfg
    level, nxt = (int(x) for x in layout.lh_level_next(t.state.lh_word))
    round_size = (1 << cfg.lh_base_log2) << level
    seg = int(t.state.lh_dir[(nxt - 1) % round_size])
    picked, start = [], 1 << 40            # counters no other key set uses
    while sum(k.size for k in picked) < 2048:
        cand = distinct_keys(start, 1 << 22)
        start += 1 << 22
        hi, lo = hashing.split_keys(cand, DEVICE)
        cseg, _ = engine.locate(cfg, t.mode, t.state, hashmix.bulk_hash(hi, lo)[0])
        picked.append(cand[(cseg == seg).cpu().numpy()])
    fill = np.concatenate(picked)
    done = 0
    while int(t.state.stash_active[seg]) < cfg.num_stash:
        check(done < fill.size, f"segment {seg}: {fill.size} keys did not activate "
              f"every stash row ({int(t.state.stash_active[seg])} active)")
        st = t.insert(fill[done:done + 8], np.arange(done, done + 8, dtype=np.uint32),
                      max_retries=LH_RETRIES)
        check((st == 0).all(), f"stash fill: statuses {np.bincount(st)}")
        done += 8
    f, v = t.search(fill[:done])
    check(f.all() and (v == np.arange(done, dtype=np.uint32)).all(),
          "a key of the stash fill is wrong")
    return seg, fill[:done]


def phase_probe_kernels(t, keys, misses, report, n: int = 1 << 20):
    """Both read kernels against their plain versions on the filled table
    ``t`` (EH or LH), then timed. On the LH table only ``fingerprint_probe``
    is timed (at 1M lanes, ns = 4), into ``report["fingerprint_probe"]["lh"]``."""
    from repro_torch.core import engine, hashing
    from repro_torch.kernels import fused, hashmix, ops, probe
    cfg, mode = t.cfg, t.mode
    NB, BT = cfg.num_buckets, cfg.buckets_total
    full_seg, fill = _fill_stash(t) if mode == "lh" else (None, keys[:0])
    st = t.state

    # -- fingerprint_probe: 1M direct lanes (half hits), the main-path shape --
    q = np.concatenate([keys[:n // 2 - fill.size], fill, misses[:n // 2]])
    hi, lo = hashing.split_keys(q, DEVICE)
    h1, _, fp = hashmix.bulk_hash(hi, lo)
    seg, b = engine.locate(cfg, mode, st, h1)
    lanes = (seg.int(), fp, b.int(), ((b + 1) & (NB - 1)).int())
    got = probe.fingerprint_probe(st.fp, st.meta, *lanes)
    want = probe.fingerprint_probe_plain(st.fp, st.meta, *lanes)
    err = max_abs_err(got, want)
    # -- routed lanes: (S, C) flattened with row = segment, mostly padding --
    nq = min(65536, 2 * cfg.max_segments)       # 8 lanes per segment: padding left
    qf, qb, qpb, _, _ = ops.route_queries(cfg, st, hi[:nq], lo[:nq], 8, mode)
    S, C = qf.shape
    rseg = torch.arange(S, dtype=torch.int32, device=DEVICE)[:, None].expand(S, C)
    rl = (rseg.reshape(-1).contiguous(), qf.reshape(-1), qb.reshape(-1), qpb.reshape(-1))
    check(bool((rl[2] < 0).any()), "routed lanes hold no padding lanes")
    err = max(err, max_abs_err(probe.fingerprint_probe(st.fp, st.meta, *rl),
                               probe.fingerprint_probe_plain(st.fp, st.meta, *rl)))
    sync()
    check(err == 0, f"fingerprint_probe differs from its plain version (max err {err})")
    check(bool((got[0] | got[1]).ne(0).any()), "no fingerprint hits")
    active = torch.bincount(st.stash_active[:t.n_segments], minlength=cfg.num_stash + 1)
    if mode == "lh":
        check(int(st.stash_active[full_seg]) == cfg.num_stash,
              f"segment {full_seg} has {int(st.stash_active[full_seg])} stash rows active")
        ms = kernel_ms(lambda: probe.fingerprint_probe(st.fp, st.meta, *lanes),
                       "fingerprint_probe_kernel", flush_mb=128)
        b_ms, b_by = bound(_probe_bytes(BT, lanes), ops=n * 60.0)
        report["fingerprint_probe"]["lh"] = dict(ms=ms, bound=(b_ms, b_by))
    else:
        _time_probe(st, lanes, report, n, BT, S * C)
    err_fused, n_stash_hits, ticks = _check_fused(t, keys, misses, full_seg)
    for kernel, e in (("fingerprint_probe", err), ("fused_probe", err_fused)):
        r = report[kernel]
        r["max_abs_err"] = max(r.get("max_abs_err", 0), e)
    log(f"phase {mode}_probe_kernels: ok fingerprint_probe exact on {n} direct + {S * C} "
        f"routed lanes, fused_probe exact on 16 ticks of 256 lanes with {n_stash_hits} "
        f"stash hits (segments by active stash rows 0..{cfg.num_stash}: {active.tolist()})"
        + (f"; {fill.size} fresh keys filled segment {full_seg}'s {cfg.num_stash} stash "
           f"rows, half of each tick's stash hits there" if mode == "lh" else "")
        + (f"; fingerprint_probe {ms * 1e3:.2f} us at {n} LH lanes, bound "
           f"{b_ms * 1e3:.3f} us by {b_by}" if mode == "lh" else ""))
    if mode == "eh":
        _time_fused(cfg, st, ticks, report, n_stash_hits)


def _time_probe(st, lanes, report, n, BT, n_routed):
    from repro_torch.kernels import probe
    ms = kernel_ms(lambda: probe.fingerprint_probe(st.fp, st.meta, *lanes),
                   "fingerprint_probe_kernel", flush_mb=128)
    call_ms = time_ms(lambda: probe.fingerprint_probe(st.fp, st.meta, *lanes), flush_mb=128)
    plain_ms = time_ms(lambda: probe.fingerprint_probe_plain(st.fp, st.meta, *lanes),
                       reps=10, flush_mb=128)
    warm_ms = kernel_ms(lambda: probe.fingerprint_probe(st.fp, st.meta, *lanes),
                        "fingerprint_probe_kernel")       # planes left in L2 by the last call
    nbytes = _probe_bytes(BT, lanes)
    report["fingerprint_probe"].update(
        ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound=bound(nbytes, ops=n * 60.0), shape=f"{n} direct lanes")
    log(f"phase fingerprint_probe: ok exact on {n} direct + {n_routed} routed lanes; "
        f"{nbytes / n:.0f} B/lane of HBM traffic needed; {ms * 1e3:.2f} us with L2 "
        f"flushed, {warm_ms * 1e3:.2f} us with the planes warm in L2")
    # the same kernel across the batch sizes the planner gives it (> 1024 keys)
    for m in [m for m in (4096, 65536) if m < n] + [n]:
        sub = tuple(torch.cat([x[:m // 2], x[n // 2:n // 2 + m // 2]]) for x in lanes)
        m_ms = ms if m == n else kernel_ms(
            lambda: probe.fingerprint_probe(st.fp, st.meta, *sub),
            "fingerprint_probe_kernel", flush_mb=128)
        b_ms, b_by = bound(_probe_bytes(BT, sub), ops=m * 60.0)
        log(f"  fingerprint_probe at {m} direct lanes: {m_ms * 1e3:.2f} us on the card, "
            f"bound {b_ms * 1e3:.3f} us by {b_by} ({b_ms / m_ms:.1%} of it)")


def _check_fused(t, keys, misses, full_seg=None):
    """fused_probe against its plain version on 16 ticks of 256 lanes: 128
    hits, 64 misses and 64 stash-resident keys, half of them from segment
    ``full_seg``'s stash if given. Returns (max err, stash hits, the ticks'
    arguments)."""
    from repro_torch.core import engine, hashing
    from repro_torch.kernels import fused, hashmix
    cfg, st = t.cfg, t.state
    NB = cfg.num_buckets
    s_hi, s_lo = _stash_keys(t, 4096)
    check(s_hi.numel() > 0, "no stash-resident record for the tick test")
    if full_seg is not None:      # picks alternate: any stash, then full_seg's
        f_hi, f_lo = _stash_keys(t, 4096, full_seg)
        s_hi = torch.stack([s_hi[:f_hi.numel()], f_hi[:s_hi.numel()]], 1).reshape(-1)
        s_lo = torch.stack([s_lo[:f_lo.numel()], f_lo[:s_lo.numel()]], 1).reshape(-1)
    err, n_stash_hits, ticks = 0, 0, []
    rng = np.random.default_rng(3)
    for i in range(16):
        k_hi, k_lo = hashing.split_keys(np.concatenate(
            [keys[rng.integers(0, keys.size, 128)], misses[rng.integers(0, misses.size, 64)]]),
            DEVICE)
        pick = rng.integers(0, s_hi.numel(), 64)
        if full_seg is not None:
            pick += np.arange(64) % 2 - pick % 2
        pick = torch.from_numpy(pick).to(DEVICE)
        q_hi = torch.cat([k_hi, s_hi[pick]]).contiguous()
        q_lo = torch.cat([k_lo, s_lo[pick]]).contiguous()
        h1, _, fpq = hashmix.bulk_hash(q_hi, q_lo)
        seg, b = engine.locate(cfg, t.mode, st, h1)
        args = (st.fp, st.meta, st.key_hi, st.key_lo, st.val, st.stash_active,
                seg.int(), fpq, b.int(), ((b + 1) & (NB - 1)).int(), q_hi, q_lo)
        kw = dict(nb=NB, ns=cfg.num_stash, use_fp=cfg.use_fingerprints)
        got = fused.fused_probe(*args, **kw)
        want = fused.fused_probe_plain(*args, **kw)
        err = max(err, max_abs_err(got, want))
        n_stash_hits += int(got[0][192:].sum())
        ticks.append((args, kw, got[0]))
    sync()
    check(err == 0, f"fused_probe differs from its plain version (max err {err})")
    check(n_stash_hits == 16 * 64, f"stash hits {n_stash_hits} of {16 * 64}")
    return err, n_stash_hits, ticks


def _time_fused(cfg, st, ticks, report, n_stash_hits):
    from repro_torch.kernels import fused
    args, kw, found = ticks[0]
    ms = kernel_ms(lambda: fused.fused_probe(*args, **kw), "fused_probe_kernel",
                   reps=200, flush_mb=128)
    call_ms = time_ms(lambda: fused.fused_probe(*args, **kw), reps=200)
    host_us = host_us_per_call(lambda: fused.fused_probe(*args, **kw))
    plain_ms = time_ms(lambda: fused.fused_probe_plain(*args, **kw), reps=50)
    empty_ms, load_ns = latency_floor() if DEVICE == "cuda" else (float("nan"),) * 2
    floor_ms = empty_ms + 3 * load_ns * 1e-6
    nbytes = _fused_bytes(cfg, st, args, found)
    report["fused_probe"].update(
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, floor_ms=floor_ms, load_ns=load_ns,
        bound=bound(nbytes, ops=256 * 200.0), shape="256-lane tick")
    log(f"phase fused_probe: ok exact on 16 ticks of 256 lanes, {n_stash_hits} stash "
        f"hits; {nbytes} B of HBM traffic needed; an empty launch takes "
        f"{empty_ms * 1e3:.2f} us and a dependent HBM load {load_ns:.1f} ns on the card, "
        f"so the latency floor (launch + 3 dependent loads) is {floor_ms * 1e3:.2f} us; "
        f"the wrapper costs {host_us:.2f} us of host time a call (1000 calls back to back)")



def _verify_all(t, keys, misses, truth, what: str, B: int = 1 << 20):
    """Every key of the main path against its ground truth, in 1M batches;
    no miss found; n_items == recount_items == the live count."""
    from repro_torch.core import engine
    alive, values = truth["alive"], truth["values"]
    for a in range(0, keys.size, B):
        f, v = t.search(keys[a:a + B])
        check((f == alive[a:a + B]).all(), f"{what}: found mask wrong at {a}")
        check((v[f] == values[a:a + B][f]).all(), f"{what}: values wrong at {a}")
    f, v = t.search(truth["extra_k"])
    check(f.all() and (v == truth["extra_v"]).all(), f"{what}: a tick key is wrong")
    check(not t.search(misses)[0].any(), f"{what}: a missing key was found")
    expect = int(alive.sum()) + truth["extra_k"].size
    recount = int(engine.recount_items(t.state))
    check(t.n_items == recount == expect,
          f"{what}: n_items {t.n_items} recount {recount} expected {expect}")
    return expect


def phase_recovery(t, keys, misses, truth, B: int = 1 << 20):
    """Crash the filled main-path table, restart it (O(1)), recover lazily
    through reads, then crash again and recover eagerly (recover_all)."""
    from repro_torch.core import engine, layout, recovery
    cfg = t.cfg
    wm = t.n_segments
    t0 = time.perf_counter()
    t.crash(np.random.default_rng(13), lock_frac=0.05, n_dups=64, wipe_overflow=True,
            interrupt_smo=True)
    sync()
    crash_s = time.perf_counter() - t0
    locks = int((t.state.version & 1).sum())
    dups = int(engine.recount_items(t.state)) - t.n_items
    fired = bool((t.state.seg_state == layout.SEG_SPLITTING).any())
    check(fired == (wm < cfg.max_segments), "interrupt_smo fired iff the pool has room")
    t0 = time.perf_counter()
    work = t.restart()
    restart_ms = (time.perf_counter() - t0) * 1e3
    check(not work["clean"], "the crash left a clean marker")
    t0 = time.perf_counter()
    f, v = t.search(keys[:B])
    sync()
    lazy_s = time.perf_counter() - t0
    first = t.recovered_segments
    check((f == truth["alive"][:B]).all() and (v[f] == truth["values"][:B][f]).all(),
          "the first read batch after the crash is wrong")
    t0 = time.perf_counter()
    n_live = _verify_all(t, keys, misses, truth, "after lazy recovery")
    sync()
    rest_s = time.perf_counter() - t0
    check(t.recovered_segments == wm == t.n_segments - fired,
          f"recovered {t.recovered_segments} segments of {t.n_segments}")
    check(not (t.state.seg_state != layout.SEG_NORMAL).any(), "an SMO was left in flight")
    check(int((t.state.version & 1).sum()) == 0, "a lock bit survived recovery")
    check(dups == 64, f"the crash left {dups} displacement duplicates, not 64")
    log(f"  recovery: crash surgery {crash_s:.2f}s left {locks} held locks, {dups} "
        f"displacement duplicates, wiped overflow metadata; "
        + ("an interrupted split, continued by the lazy recovery" if fired else
           f"interrupt_smo did not fire: all {wm} segments are in use (the reference's "
           f"limit too, recovery.py:412)"))
    # eager contrast: a second crash, every segment recovered at once
    t.crash(np.random.default_rng(14), lock_frac=0.05, n_dups=64, wipe_overflow=True)
    sync()
    t.restart()
    t0 = time.perf_counter()
    t.state = recovery.recover_all(cfg, t.mode, t.state)
    sync()
    eager_s = time.perf_counter() - t0
    rec0 = t.recovered_segments
    f, v = t.search(keys[:B])
    check(t.recovered_segments == rec0, "recover_all left a dirty segment")
    check((f == truth["alive"][:B]).all() and (v[f] == truth["values"][:B][f]).all(),
          "a read after recover_all is wrong")
    log(f"phase recovery: ok restart {restart_ms:.3f} ms of host time "
        f"({work['seconds'] * 1e3:.3f} ms inside instant_restart) at {n_live} keys; "
        f"the first 1M-key read took {lazy_s:.3f}s and recovered {first} segments lazily; "
        f"the rest of the {n_live} live keys verified in {rest_s:.1f}s, recovered "
        f"segments == {wm}, every segment of the crashed table; recover_all {eager_s:.3f}s for {wm} segments")
    return dict(restart_ms=restart_ms, lazy_s=lazy_s, lazy_segments=first,
                eager_s=eager_s)


def _expected_values(keys):
    """``ycsb.expected_value`` of every key, vectorized."""
    v = ((keys ^ (keys >> np.uint64(17))) & np.uint64(0x7FFFFFFF)).astype(np.uint32)
    v[v == 0] = 1
    return v


def _frontend_blocks(loaded, fresh, rng, block: int = 256, ycsb_per_block: int = 128):
    """The storm's op stream in blocks of ``block`` fresh keys, with the
    CPU tests' mixed-stream ratios: one read of a loaded key per fresh
    insert, an update of that key every third, plus ``ycsb_per_block``
    YCSB-A ops (50 % read, 50 % update, zipfian 0.99 over the loaded keys).
    A block is its inserts, then its reads, then its updates, so both
    frontends' write lanes (and the stop-the-world FIFO) form full batches.
    Yields lists of (kind, key, value)."""
    from repro_torch.serving import frontend as fe
    from repro_torch.workloads import ycsb
    n_blocks = fresh.size // block
    a_ops = ycsb.generate(ycsb.YCSBConfig(mix="A", n_ops=n_blocks * ycsb_per_block,
                                          seed=17), loaded)
    ridx = rng.integers(0, loaded.size, fresh.size)
    for j in range(n_blocks):
        ins, rds, upd = [], [], []
        for i in range(j * block, (j + 1) * block):
            k, kk = int(fresh[i]), int(loaded[ridx[i]])
            ins.append((fe.INSERT, k, ycsb.expected_value(k)))
            rds.append((fe.READ, kk, 0))
            if i % 3 == 0:
                upd.append((fe.UPDATE, kk, ycsb.updated_value(kk)))
        for op in a_ops[j * ycsb_per_block:(j + 1) * ycsb_per_block]:
            (upd if op.kind == fe.UPDATE else rds).append((op.kind, op.key, op.value))
        yield ins + rds + upd


class _Feeder:
    """Feeds a frontend block by block: a new block is submitted whenever
    the read lane is empty and fewer than ``backlog`` writes are queued, so
    the reads of one block are served while the writes and staged SMOs of
    the blocks before it are in flight."""

    def __init__(self, f, blocks, on_tick=None, backlog: int = 1024):
        from repro_torch.serving import frontend as fe
        self.f, self.blocks, self.on_tick, self.fe = f, iter(blocks), on_tick, fe
        self.backlog = backlog
        self.ops, self.ticks, self.submitted, self.exhausted = [], 0, 0, False

    def tick(self) -> bool:
        f = self.f
        if not len(f.reads) and len(f.writes) < self.backlog and not self.exhausted:
            block = next(self.blocks, None)
            if block is None:
                self.exhausted = True
            else:
                for o in block:
                    self.ops.append(self.fe.Op(*o))
                    check(f.submit(self.ops[-1]), "the admission queue rejected an op")
                self.submitted += 1
        if self.exhausted and not f.busy:
            return False
        f.step()
        self.ticks += 1
        if self.on_tick is not None:
            self.on_tick(f, self.ticks)
        return True

    def run(self, ticks=None, blocks=None):
        """Tick until ``ticks`` more ticks ran, ``blocks`` blocks were
        submitted, or everything is done."""
        t0 = self.ticks
        while ((ticks is None or self.ticks - t0 < ticks)
               and (blocks is None or self.submitted < blocks) and self.tick()):
            pass
        return self.ticks - t0


def phase_frontend(cfg, n_keys: int, n_fresh: int, report, card: str):
    """The online-resize serving frontend at full width: a DashEH loaded to
    ``n_keys`` through ``table.insert``, then a split storm of ``n_fresh``
    fresh inserts with reads, updates and YCSB-A ops through DashFrontend
    (max_batch 256), and the same stream through StopTheWorldFrontend on a
    clone of the loaded state. The launch counters are set to 0 just before
    the DashFrontend run and read just after. Returns (the phase's numbers,
    what the durable phase goes on from: the table after its storm, the
    loaded keys, the fresh keys it acknowledged, the keys it updated)."""
    from repro_torch.core import DashEH, engine, layout
    from repro_torch.core.epoch import shared_planes
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.serving import frontend as fe
    t_phase = time.perf_counter()
    keys = distinct_keys(2 << 40, n_keys + n_fresh)
    loaded, fresh = keys[:n_keys], keys[n_keys:]
    rng = np.random.default_rng(21)
    rng.shuffle(loaded)                              # rank r -> a random key
    vals = _expected_values(loaded)
    t = DashEH(cfg, device=DEVICE)
    t0 = time.perf_counter()
    done = 0
    while done < n_keys:
        n = min(eh_batch(t), n_keys - done)
        check((t.insert(loaded[done:done + n], vals[done:done + n]) == 0).all(),
              "frontend load failed")
        done += n
    sync()
    load_s = time.perf_counter() - t0
    clone = layout.DashState(*(x.clone() for x in t.state))
    whole = layout.state_nbytes(t.state)
    log(f"  frontend: loaded {n_keys} keys in {load_s:.1f}s, {t.n_segments} segments, "
        f"state {whole / 2**20:.0f} MB")

    # ---- DashFrontend: snapshot reads, staged splits, COW publishes ----
    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    memo0 = fused._checked_planes.cache_info()
    f = fe.DashFrontend(t, max_batch=256, queue_depth=1 << 16)
    state = dict(mid_split=None, shared=0, trace=None)

    def on_tick(f, ticks):
        if shared_planes(f.registry.current.state, f.table.state):
            state["shared"] += 1
        task = f._smo_task
        if state["mid_split"] is None and task is not None and task.stage == "commit" \
                and f.smo_dispatches > 0:
            state["mid_split"] = _check_snapshot_probe(f, loaded)

    blocks = list(_frontend_blocks(loaded, fresh, np.random.default_rng(22)))
    drv = _Feeder(f, blocks, on_tick)
    t0 = time.perf_counter()
    drv.run(blocks=len(blocks) // 2)
    if DEVICE == "cuda":
        # 50 ticks traced: the card's busy share while the storm is served
        wall, busy, top, ticks_t = busy_share(lambda: drv.run(ticks=50))
    else:
        ticks_t = drv.run(ticks=50)
    drv.run()
    sync()
    fe_s = time.perf_counter() - t0
    ops, ticks = drv.ops, drv.ticks
    launches = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                "fused_probe": fused.LAUNCHES}
    memo1 = fused._checked_planes.cache_info()
    st = f.stats()

    # ---- StopTheWorldFrontend on a clone of the loaded state ----
    t_stw = DashEH(cfg, device=DEVICE, state=clone)
    g = fe.StopTheWorldFrontend(t_stw, max_batch=256, queue_depth=1 << 16)
    t0 = time.perf_counter()
    drv_s = _Feeder(g, blocks)
    drv_s.run()
    ops_s, ticks_s = drv_s.ops, drv_s.ticks
    sync()
    stw_s = time.perf_counter() - t0

    kinds = np.array([op.kind for op in ops])
    rd = kinds == fe.READ
    rl = np.asarray(f.read_latencies) * 1e3
    sl = np.asarray(g.read_latencies) * 1e3
    n_reads = f.snapshot_reads + f.retried_reads
    hits = memo1.hits - memo0.hits
    misses = memo1.misses - memo0.misses
    mean_pub = st["publish_bytes"] / st["published"]
    out = dict(fe_p50=np.percentile(rl, 50), fe_p99=np.percentile(rl, 99),
               stw_p50=np.percentile(sl, 50), stw_p99=np.percentile(sl, 99),
               ticks=ticks, publishes=st["published"], mean_publish_bytes=mean_pub,
               state_bytes=whole, publish_seconds=st["publish_seconds"],
               retried_share=f.retried_reads / n_reads, seconds=0.0)
    log(f"  frontend [{card}]: {len(ops)} ops ({int(rd.sum())} reads) in {ticks} ticks, "
        f"{fe_s:.1f}s; {f.smo_dispatches} staged SMOs in {f.smo_stages} stages; "
        f"{st['published']} publishes, mean {mean_pub:.0f} B = {mean_pub / whole:.6f} of "
        f"the {whole} B state, publish_seconds {st['publish_seconds']:.2f}; "
        f"{f.retried_reads} of {n_reads} reads retried ({out['retried_share']:.5f}); "
        f"fused plane-set memo {hits} hits / {misses} misses "
        f"({hits / max(hits + misses, 1):.3f})")
    log(f"  frontend [{card}]: read sojourn p50 {out['fe_p50']:.3f} ms p99 "
        f"{out['fe_p99']:.3f} ms (DashFrontend) vs p50 {out['stw_p50']:.3f} ms p99 "
        f"{out['stw_p99']:.3f} ms (StopTheWorldFrontend, {ticks_s} ticks, {stw_s:.1f}s)")
    if DEVICE == "cuda":
        log(f"  trace frontend [{card}] {ticks_t} ticks: wall {wall * 1e3:.1f} ms, card busy "
            f"{busy * 1e3:.1f} ms (busy share {busy / wall:.3f}); top: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    # ---- checks ----
    check(np.array_equal(kinds, [op.kind for op in ops_s]), "the two streams differ")
    r_key = np.array([op.key for op, r in zip(ops, rd) if r], np.uint64)
    for name, stream in (("DashFrontend", ops), ("StopTheWorldFrontend", ops_s)):
        found = np.array([op.found for op, r in zip(stream, rd) if r])
        res = np.array([op.result for op, r in zip(stream, rd) if r], np.int64)
        pre = _expected_values(r_key).astype(np.int64)
        post = (pre + 0x9E37) & 0x7FFFFFFF
        post[post == 0] = 1
        check(found.all(), f"{name}: a read of a loaded key found nothing")
        check(((res == pre) | (res == post)).all(),
              f"{name}: a read returned a value from neither side of its update")
    w_fe = np.array([op.status for op, r in zip(ops, rd) if not r])
    w_stw = np.array([op.status for op, r in zip(ops_s, rd) if not r])
    check(np.array_equal(w_fe, w_stw), "the frontends' write statuses differ")
    check((w_fe == layout.INSERTED).all(), f"write statuses {np.bincount(w_fe)}")
    check(all(torch.equal(a, b) for a, b in zip(_records(t), _records(t_stw))),
          "the frontends left different record multisets")
    fresh_found, _ = t.search(fresh[:len(blocks) * 256])
    check(fresh_found.all(), "an acknowledged insert is missing after the drain")
    recount = int(engine.recount_items(t.state))
    check(t.n_items == recount == n_keys + len(blocks) * 256,
          f"n_items {t.n_items} recount {recount}")
    check(st["hint_misses"] == 0, f"{st['hint_misses']} dirty-hint misses")
    check(f.smo_dispatches > 0 and f.retried_reads > 0,
          f"{f.smo_dispatches} SMO dispatches, {f.retried_reads} retried reads")
    check(state["shared"] == 0, f"{state['shared']} ticks with a snapshot plane on live storage")
    check(state["mid_split"] is not None, "no tick caught a staged split")
    for kernel in ("bulk_hash", "fused_probe"):
        check(launches[kernel] > 0 or DEVICE != "cuda",
              f"{kernel} was not launched on the frontend path")
    for kernel, count in launches.items():
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})["frontend"] = count
        r["launches"] = sum(r["paths"].values())

    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase frontend: ok {n_keys} keys + {len(blocks) * 256} fresh; every read "
        f"pre- or post-update, the frontends agree on every write and on the records, "
        f"every acknowledged insert found, n_items == recount_items, hint_misses 0, "
        f"no snapshot plane on live storage; fused_probe exact on the pinned snapshot "
        f"mid-split ({state['mid_split']} lanes found); launches {launches} "
        f"({out['seconds']:.1f}s) [{card}]")
    # the durable phase goes on from the DashFrontend's table
    updated = np.array([op.key for op in ops if op.kind == fe.UPDATE], np.uint64)
    return out, dict(table=t, loaded=loaded, fresh=fresh[:len(blocks) * 256],
                     updated=updated)


def _check_snapshot_probe(f, loaded, n: int = 256):
    """``fused_probe`` on the pinned snapshot's planes against its plain
    version, while a staged split has rewritten the live planes. The
    launches made here are taken back out of the counters (a check, not
    the path). Returns the lanes found."""
    from repro_torch.core import engine, hashing
    from repro_torch.kernels import fused, hashmix
    saved = (hashmix.LAUNCHES, fused.LAUNCHES)
    cfg = f.cfg
    with f.registry.acquire() as snap:
        st = snap.state
        rng = np.random.default_rng(5)
        q_hi, q_lo = hashing.split_keys(loaded[rng.integers(0, loaded.size, n)], DEVICE)
        h1, _, fpq = hashmix.bulk_hash(q_hi, q_lo)
        seg, b = engine.locate(cfg, f.mode, st, h1)
        args = (st.fp, st.meta, st.key_hi, st.key_lo, st.val, st.stash_active,
                seg.int(), fpq, b.int(), ((b + 1) & (cfg.num_buckets - 1)).int(), q_hi, q_lo)
        kw = dict(nb=cfg.num_buckets, ns=cfg.num_stash, use_fp=cfg.use_fingerprints)
        got = fused.fused_probe(*args, **kw)
        want = fused.fused_probe_plain(*args, **kw)
        err = max_abs_err(got, want)
        n_found = int(got[0].sum())
    hashmix.LAUNCHES, fused.LAUNCHES = saved
    check(err == 0, f"fused_probe on the pinned snapshot differs from its plain version "
          f"(max err {err})")
    check(n_found == n, f"{n_found} of {n} loaded keys found on the snapshot")
    return n_found


def _records(t):
    """The table's records as (keys, values) int64 tensors on the card,
    sorted by key: equal for two tables iff their record multisets are."""
    from repro_torch.core import layout
    cfg, st = t.cfg, t.state
    bits = ((layout.meta_alloc(st.meta)[..., None]
             >> torch.arange(cfg.num_slots, device=st.meta.device)) & 1) == 1
    key = (layout.u32(st.key_hi[bits]) << 32) | layout.u32(st.key_lo[bits])
    key, order = torch.sort(key)
    return key, layout.u32(st.val[bits])[order]


def _acked_truth(carry, fresh2):
    """(keys, values) of every key the frontend phase and the durable storm
    acknowledged: loaded keys at their load value, or the updated value if
    any acknowledged update reached them, and the fresh inserts."""
    loaded = carry["loaded"]
    vals = _expected_values(loaded)
    upd = np.isin(loaded, carry["updated"])
    post = ((vals.astype(np.int64) + 0x9E37) & 0x7FFFFFFF).astype(np.uint32)
    post[post == 0] = 1
    vals[upd] = post[upd]
    fresh = np.concatenate([carry["fresh"], fresh2])
    return np.concatenate([loaded, fresh]), np.concatenate([vals, _expected_values(fresh)])


def _check_acked(t, keys, vals, what: str, B: int = 1 << 20):
    for a in range(0, keys.size, B):
        f, v = t.search(keys[a:a + B])
        check(f.all(), f"{what}: {int((~f).sum())} acknowledged keys missing at {a}")
        check((v == vals[a:a + B]).all(), f"{what}: a wrong value at {a}")


def _keys_into_fullest_segment(t, start: int, n: int):
    """``n`` fresh keys (from counter ``start`` on) that the EH directory
    routes to the segment holding the most records, picked on the host
    (no kernel launch): inserting them splits that segment."""
    from repro_torch.core import hashing, layout
    counts = layout.meta_count(t.state.meta).sum(1)[:t.n_segments]
    seg = int(torch.argmax(counts))
    dirv = t.state.dir.cpu().numpy()
    picked = []
    while sum(k.size for k in picked) < n:
        cand = distinct_keys(start, 1 << 22)
        start += 1 << 22
        h1 = hashing.np_hash1(*hashing.np_split_keys(cand))
        picked.append(cand[dirv[h1 >> np.uint32(32 - t.cfg.dir_depth_max)] == seg])
    return seg, int(counts[seg]), np.concatenate(picked)[:n]


def phase_durable(carry, report, card: str, n_fresh: int = DURABLE_FRESH):
    """The durable pool at full width, on the frontend phase's table after
    its storm (the main path's geometry, ~4.26M keys): a fresh pool file
    is attached and checkpointed by its first (full) flush; a storm of
    ``n_fresh`` fresh inserts with reads, updates and YCSB-A ops runs
    through DashFrontend with flush-on-publish, the scrubber (every tick)
    and the flight recorder; the table is dropped without ``close()`` and
    reopened without and with checksum verification, the first 1M-key read
    recovers lazily and every acknowledged key is checked; then fresh keys
    routed to the fullest segment are inserted 128 at a time, each batch
    flushed, until one splits it: that flush (it carries the SMO through
    the redo log) is torn at its commit fence by a ``FaultPlan``, the dead
    pool's forensics must name exactly its keys as in flight, and a reopen
    must find every acknowledged key. The launch counters are set to 0
    just before the storm and read after the last reopen."""
    import gc
    from repro_torch import persist
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.obs import FlightRecorder, forensics
    from repro_torch.persist import FaultPlan, PmPool, TornPersist, WritebackEngine
    from repro_torch.serving import frontend as fe
    t_phase = time.perf_counter()
    POOL_DIR.mkdir(parents=True, exist_ok=True)
    path = str(POOL_DIR / "durable.pool")
    if os.path.exists(path):
        os.unlink(path)
    t = carry.pop("table")
    cfg, mode = t.cfg, t.mode

    # ---- a fresh pool; its first flush is the checkpoint ----
    wb = WritebackEngine(PmPool.create(path, cfg, mode))
    t.state.clean.fill_(False)
    t.attach_writeback(wb)
    sync()
    t0 = time.perf_counter()
    ckpt_bytes = t.flush()
    ckpt_s = time.perf_counter() - t0
    ckpt_staged, ckpt_moved = wb.last_staged_bytes, wb.last_transferred_bytes
    plane_bytes = wb.pool.plane_bytes
    check(ckpt_bytes >= plane_bytes, f"the checkpoint wrote {ckpt_bytes} of {plane_bytes} B")

    # ---- the storm, flushed on every publish ----
    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    # the first two blocks' inserts go to the fullest segment: at least one
    # staged split commits through flush-on-publish (uniform inserts at
    # this load factor can fall between two split waves)
    seg, held, aimed = _keys_into_fullest_segment(t, 5 << 40, 512)
    fresh2 = np.concatenate([aimed, distinct_keys(3 << 40, n_fresh - aimed.size)])
    f = fe.DashFrontend(t, max_batch=256, queue_depth=1 << 16, scrub_interval=1,
                        scrub_rows=512)
    flush0 = wb.flushes
    per_flush = []

    def on_tick(f, ticks):
        if wb.flushes != flush0 + len(per_flush):
            per_flush.append((wb.last_flush_seconds, wb.last_stage_seconds,
                              wb.last_flush_bytes, wb.last_staged_bytes,
                              wb.last_transferred_bytes))

    blocks = list(_frontend_blocks(carry["loaded"], fresh2, np.random.default_rng(23)))
    drv = _Feeder(f, blocks, on_tick)
    t0 = time.perf_counter()
    drv.run(blocks=len(blocks) // 2)
    if DEVICE == "cuda":
        wall, busy, top, ticks_t = busy_share(lambda: drv.run(ticks=50))
    else:
        ticks_t = drv.run(ticks=50)
    drv.run()
    sync()
    storm_s = time.perf_counter() - t0
    st = f.stats()
    ops = drv.ops
    rd = np.array([op.kind == fe.READ for op in ops])
    r_key = np.array([op.key for op, r in zip(ops, rd) if r], np.uint64)
    res = np.array([op.result for op, r in zip(ops, rd) if r], np.int64)
    pre = _expected_values(r_key).astype(np.int64)
    post = (pre + 0x9E37) & 0x7FFFFFFF
    post[post == 0] = 1
    check(all(op.found for op, r in zip(ops, rd) if r) and ((res == pre) | (res == post)).all(),
          "durable storm: a read was not pre- or post-update")
    check(all(op.status == 0 for op, r in zip(ops, rd) if not r),
          "durable storm: a write failed")
    check(st["flush_hint_misses"] == 0 and st["hint_misses"] == 0,
          f"durable storm: {st['flush_hint_misses']} flush / {st['hint_misses']} "
          f"publish hint misses")
    check(st["flushes"] == st["published"] + 1 and st["degraded_events"] == 0,
          f"{st['flushes']} flushes for {st['published']} publishes")
    check(f.smo_dispatches > 0 and st["logged_rows"] > 0,
          f"durable storm: {f.smo_dispatches} SMOs, {st['logged_rows']} rows logged")
    check(len(per_flush) == wb.flushes - flush0, "a tick ran more than one flush")
    carry["updated"] = np.concatenate(
        [carry["updated"], np.array([op.key for op in ops if op.kind == fe.UPDATE], np.uint64)])
    keys, vals = _acked_truth(carry, fresh2[:len(blocks) * 256])
    pf = np.array(per_flush)
    rl = np.asarray(f.read_latencies) * 1e3
    n_ops = len(ops)
    out = dict(checkpoint_s=ckpt_s, flushes=len(pf), flush_share=pf[:, 2].mean() / plane_bytes,
               staged=pf[:, 3].mean(), moved=pf[:, 4].mean(), ckpt_moved=ckpt_moved,
               flush_ms=pf[:, 0].mean() * 1e3,
               flush_p99_ms=np.percentile(pf[:, 0], 99) * 1e3, stage_ms=pf[:, 1].mean() * 1e3,
               io_ms=(pf[:, 0] - pf[:, 1]).mean() * 1e3, p50=np.percentile(rl, 50),
               p99=np.percentile(rl, 99))
    log(f"  durable [{card}]: checkpoint {ckpt_s:.2f}s ({ckpt_bytes} B written, {ckpt_staged} B "
        f"staged, {ckpt_moved} B transferred to the host, planes {plane_bytes} B); storm {len(blocks) * 256} fresh inserts (the first "
        f"512 into segment {seg}, {held} records), {n_ops} ops "
        f"in {st['published']} publishes, {f.smo_dispatches} staged SMOs, {storm_s:.1f}s; "
        f"{len(pf)} flushes, mean {out['flush_share']:.6f} of the plane bytes flushed and "
        f"{out['staged']:.0f} B staged ({out['moved']:.0f} B transferred) a flush, "
        f"{st['logged_rows']} rows logged; flush "
        f"{out['flush_ms']:.2f} ms mean, p99 {out['flush_p99_ms']:.2f} ms (staging "
        f"{out['stage_ms']:.2f} ms + pool I/O and fences {out['io_ms']:.2f} ms); read sojourn "
        f"p50 {out['p50']:.3f} ms p99 {out['p99']:.3f} ms; scrub {st['scrub_scanned_rows']} rows "
        f"scanned, {st['scrub_repaired_rows']} repaired")
    if DEVICE == "cuda":
        log(f"  trace durable [{card}] {ticks_t} ticks: wall {wall * 1e3:.1f} ms, card busy "
            f"{busy * 1e3:.1f} ms (busy share {busy / wall:.3f}); top: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in top))

    # ---- the kill: the table is dropped, never closed ----
    del f, t, wb, drv, ops
    gc.collect()
    t0 = time.perf_counter()
    t2, info2 = persist.reopen(path, verify=False, device=DEVICE)
    sync()
    reopen_s = time.perf_counter() - t0
    check(not info2["clean"], "the killed pool reopened clean")
    del t2
    gc.collect()
    plan = FaultPlan(seed=31, torn_line_frac=1.0)
    t0 = time.perf_counter()
    t3, info3 = persist.reopen(path, verify=True, faults=plan, device=DEVICE)
    sync()
    verify_s = time.perf_counter() - t0
    check(info3["quarantined_bt"] == info3["quarantined_nb"] == 0 and not info3["log_lost"],
          f"verified reopen quarantined rows: {info3}")
    t0 = time.perf_counter()
    fnd, v = t3.search(keys[:1 << 20])
    sync()
    first_s = time.perf_counter() - t0
    first_segments = t3.recovered_segments
    check(fnd.all() and (v == vals[:1 << 20]).all(), "the first read after the kill is wrong")
    _check_acked(t3, keys, vals, "after the kill")
    log(f"  durable [{card}]: reopen {reopen_s:.3f}s without verify ({info2['seconds']:.3f}s "
        f"inside), {verify_s:.3f}s with verify; first 1M-key read {first_s:.3f}s, "
        f"{first_segments} segments recovered; {keys.size} acknowledged keys checked")

    # ---- a torn flush that carries an SMO ----
    wb3 = t3.writeback
    rec = wb3.attach_recorder(FlightRecorder())
    seg, held, extra = _keys_into_fullest_segment(t3, 4 << 40, 4096)
    acked_extra, torn_batch = [], None
    for a in range(0, extra.size, 128):
        batch = extra[a:a + 128]
        segs0 = t3.n_segments
        check((t3.insert(batch, _expected_values(batch)) == 0).all(), "a torn-phase insert failed")
        rec.record_ops(fe.INSERT, batch, await_seq=wb3.pool.sb.flush_seq + 1)
        if t3.n_segments == segs0:
            t3.flush()
            acked_extra.append(batch)
            continue
        logged0 = wb3.logged_rows
        # the flush's fences: data, publish, log + recorder window, commit
        plan.torn_fences = frozenset({plan.fence_calls + 3})
        try:
            t3.flush()
        except TornPersist:
            torn_batch = batch
        break
    check(torn_batch is not None, f"{extra.size} keys into segment {seg} ({held} records) "
          f"split nothing, or the tear missed")
    check(wb3.logged_rows > logged0, "the torn flush carried no redo log (no SMO)")
    rep = forensics.analyze_pool(path)
    in_flight = {int(k) for op in rep.get("in_flight_ops", ()) for k in op["keys"]}
    truth = {int(k) for k in torn_batch}
    contradictions = len(in_flight - truth)
    check(rep.get("ok") and rep["torn"]["present"] and in_flight == truth,
          f"forensics: torn {rep.get('torn')}, {len(in_flight)} in flight of {len(truth)}")
    check(contradictions == 0, f"forensics contradicts the truth on {contradictions} keys")
    del t3, wb3, rec
    gc.collect()
    t4, info4 = persist.reopen(path, verify=False, device=DEVICE)
    check(info4["flush_seq"] == rep["flush_seq"] + 1, "the torn commit became durable")
    if acked_extra:
        keys = np.concatenate([keys] + acked_extra)
        vals = np.concatenate([vals] + [_expected_values(b) for b in acked_extra])
    _check_acked(t4, keys, vals, "after the torn flush")
    f_t, v_t = t4.search(torn_batch)
    check((v_t[f_t] == _expected_values(torn_batch)[f_t]).all(),
          "an in-flight key of the torn flush has a wrong value")
    launches = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                "fused_probe": fused.LAUNCHES}
    for kernel, count in launches.items():
        check(count > 0 or DEVICE != "cuda", f"{kernel} was not launched on the durable path")
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})["durable"] = count
        r["launches"] = sum(r["paths"].values())
    free = shutil.disk_usage(POOL_DIR).free
    del t4
    os.unlink(path)
    out.update(reopen_s=reopen_s, verify_s=verify_s, first_s=first_s,
               first_segments=first_segments, seconds=time.perf_counter() - t_phase)
    log(f"  durable [{card}]: {len(acked_extra) * 128} keys into segment {seg} ({held} records) "
        f"acknowledged, then the 128-key batch that split it torn at its commit fence; "
        f"{keys.size} acknowledged keys found after the last reopen; free disk "
        f"{free / 2**30:.1f} GiB")
    log(f"phase durable: ok every read pre- or post-update, flush_hint_misses 0, every "
        f"acknowledged key found after the kill, both reopens and the torn flush; forensics "
        f"named the {len(truth)} in-flight keys of the torn SMO flush, 0 contradictions; "
        f"launches {launches} ({out['seconds']:.1f}s) [{card}]")
    return out


def phase_shrink(cfg, n_keys: int = SHRINK_KEYS, n_fresh: int = SHRINK_KEYS // 2):
    """Delete 80 % of a loaded EH table, shrink it, check every answer,
    then refill: the splits must take the freed ids before the watermark
    grows."""
    from repro_torch.core import DashEH
    B = 1 << 20
    keys = distinct_keys(1 << 40, n_keys + n_fresh)
    vals = (np.arange(keys.size, dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    fresh, keys = keys[n_keys:], keys[:n_keys]
    t = DashEH(cfg, device=DEVICE)
    t0 = time.perf_counter()
    done = 0
    while done < n_keys:
        n = min(eh_batch(t), n_keys - done)
        check((t.insert(keys[done:done + n], vals[done:done + n]) == 0).all(),
              "shrink load failed")
        done += n
    n_gone = n_keys * 4 // 5
    check((t.delete(keys[:n_gone]) == 0).all(), "a shrink-phase delete missed")
    before = t.n_segments
    t1 = time.perf_counter()
    merges = t.shrink()
    sync()
    shrink_s = time.perf_counter() - t1
    freed = len(t.free_segments)
    after = before - freed
    check(merges == freed > 0, f"{merges} merges freed {freed} ids")
    check(int(torch.unique(t.state.dir).numel()) == after, "directory owners != live segments")
    f, v = t.search(keys[n_gone:])
    check(f.all() and (v == vals[n_gone:n_keys]).all(), "a surviving key is wrong after shrink")
    for a in range(0, n_gone, B):
        check(not t.search(keys[a:min(a + B, n_gone)])[0].any(), "a deleted key was found")
    recycled, wm = 0, t.n_segments
    for a in range(0, n_fresh, 1 << 17):
        free0 = len(t.free_segments)
        check((t.insert(fresh[a:a + (1 << 17)], vals[n_keys + a:n_keys + a + (1 << 17)])
               == 0).all(), "a refill insert failed")
        recycled += free0 - len(t.free_segments)
        check(t.n_segments == wm or not t.free_segments,
              "the watermark grew while freed ids were left")
        wm = t.n_segments
    f, v = t.search(fresh)
    check(f.all() and (v == vals[n_keys:]).all(), "a refill key is wrong")
    check(recycled > 0, "the refill recycled no freed id")
    log(f"phase shrink: ok {n_keys} keys loaded, {n_gone} deleted (cut: {n_keys} keys of "
        f"20000000, forced by the time limit); shrink {shrink_s:.2f}s: {merges} merges, live "
        f"segments {before} before, {after} after; survivors found, deleted keys not; "
        f"{n_fresh} fresh keys recycled {recycled} freed ids, watermark {before} -> "
        f"{t.n_segments} ({time.perf_counter() - t0:.1f}s)")


#: the baselines phase: unique uniform keys loaded into each of its four
#: tables, cut from 2M by the run's time limit (see PREFIX_PROMPTS)
BASE_KEYS = 1_000_000
#: level hashing's load batches: Fig. 7's batch (benchmarks/single_op.py), and
#: the shape ``level_scan`` is held and timed at. Level hashing has no
#: segments for the Dash tables' growing batches (``eh_batch``) to follow.
LEVEL_BATCH = 4096
#: the Dash tables' pool (max_segments, dir_depth_max) and level hashing's
#: max_log2 in the baselines phase (a CPU rehearsal shrinks them)
BASE_POOL = (32768, 17)
LEVEL_MAX_LOG2 = 20


def _level_move_case(device):
    """A level-hashing state (``max_log2=6``, k = 3) in which one key inserts
    only by the move: its four candidate buckets are full, and slot 0 of
    its top-a bucket holds a record whose alternate top bucket is empty.
    Returns (cfg, state, hi, lo, vals, valid)."""
    from repro_torch import interop
    from repro_torch.core import hashing
    from repro_torch.core.baselines import LevelConfig, level_make_state
    cfg = LevelConfig(max_log2=6, init_log2=3)
    boff = 1 << cfg.max_log2

    def buckets(key):
        hi, lo = hashing.np_split_keys(np.array([key], np.uint64))
        h1, h2 = int(hashing.np_hash1(hi, lo)[0]), int(hashing.np_hash2(hi, lo)[0])
        return h1 & 7, h2 & 7, boff + (h1 & 3), boff + (h2 & 3)

    pool = distinct_keys(11 << 40, 400)
    key = pool[0]
    ta, tb, ba, bb = buckets(key)
    r = next(x for x in pool[1:] if ta in buckets(x)[:2]
             and (set(buckets(x)[:2]) - {ta}) - {tb})
    planes = {n: a.copy() for n, a in interop.level_state_to_numpy(
        level_make_state(cfg, "cpu")).items()}
    filler = iter(pool[-64:])
    for b in {ta, tb, ba, bb}:
        planes["alloc"][b] = 0xF
        for slot in range(4):
            hi, lo = hashing.np_split_keys(np.array([r if (b, slot) == (ta, 0)
                                                     else next(filler)], np.uint64))
            planes["key_hi"][b, slot], planes["key_lo"][b, slot] = hi[0], lo[0]
            planes["val"][b, slot] = 100 + slot
    state = interop.level_state_from_numpy(cfg, planes, device)
    hi, lo = hashing.split_keys(np.array([key], np.uint64), device)
    return (cfg, state, hi, lo, torch.full_like(hi, 7),
            torch.ones(1, dtype=torch.bool, device=device))


def _level_scan_exact(cfg, state, hi, lo, vals, valid):
    """``level_scan`` and ``level_scan_plain`` on two clones of ``state``:
    (the largest difference over statuses and planes, the kernel's
    statuses, the plain version's seconds on the host clock)."""
    from repro_torch.core.baselines import LevelState
    from repro_torch.kernels import level
    a, b = (LevelState(*(x.clone() for x in state)) for _ in range(2))
    got = level.level_scan(cfg, a, hi, lo, vals, valid)
    sync()
    t0 = time.perf_counter()
    want = level.level_scan_plain(cfg, b, hi, lo, vals, valid)
    sync()
    return max_abs_err([got, *a], [want, *b]), got, time.perf_counter() - t0


def _baseline_load(name, t, keys, vals, batch_keys, trace: bool):
    """Load ``keys`` in 16 equal parts (batches of ``batch_keys(t)`` inside
    each): (seconds, the load factor after every part, the busy-share trace
    of one batch in the ninth part or None, the batch count, the largest
    batch)."""
    curve, traced, done, n_batches, largest = [], None, 0, 0, 0
    n_keys = keys.size
    t0 = time.perf_counter()
    for part in range(16):
        end = (part + 1) * n_keys // 16
        while done < end:
            n = min(batch_keys(t), end - done)
            batch = (keys[done:done + n], vals[done:done + n])
            if (trace and part == 8 and DEVICE == "cuda"
                    and (traced is None or not any("kernel" in k for k, _ in traced[2]))):
                # the profiler records no kernel in some runs (at most
                # a copy): then the next batch is traced instead
                *traced, st = busy_share(lambda: t.insert(*batch))
                traced.append(n)
            else:
                st = t.insert(*batch)
            check((st == 0).all(), f"{name} load at {done}: statuses {np.bincount(st)}")
            done += n
            n_batches += 1
            largest = max(largest, n)
        curve.append(t.load_factor)
    sync()
    return time.perf_counter() - t0, curve, traced, n_batches, largest


def _bucketized_kernels(t, keys, misses, report, card: str):
    """Both read kernels against their plain versions on the loaded
    Bucketized table (no stash: ns = 0), then their device times."""
    from repro_torch.core import engine, hashing
    from repro_torch.kernels import fused, hashmix, probe
    cfg, st = t.cfg, t.state
    NB, B = cfg.num_buckets, 1 << 20

    def lanes_of(q):
        hi, lo = hashing.split_keys(q, DEVICE)
        h1, _, fp = hashmix.bulk_hash(hi, lo)
        seg, b = engine.locate(cfg, "eh", st, h1)
        return hi, lo, (seg.int(), fp, b.int(), ((b + 1) & (NB - 1)).int())

    _, _, lanes = lanes_of(np.concatenate([keys[:B // 2], misses[:B // 2]]))
    got = probe.fingerprint_probe(st.fp, st.meta, *lanes)
    err_fp = max_abs_err(got, probe.fingerprint_probe_plain(st.fp, st.meta, *lanes))
    check(bool((got[0] | got[1]).ne(0).any()), "bucketized: no fingerprint hits")
    rng = np.random.default_rng(12)
    kw = dict(nb=NB, ns=cfg.num_stash, use_fp=cfg.use_fingerprints)
    err_fused, ticks = 0, []
    for _ in range(16):
        q_hi, q_lo, (seg, fpq, b, pb) = lanes_of(np.concatenate(
            [keys[rng.integers(0, keys.size, 128)], misses[rng.integers(0, misses.size, 128)]]))
        args = (st.fp, st.meta, st.key_hi, st.key_lo, st.val, st.stash_active,
                seg, fpq, b, pb, q_hi, q_lo)
        found = fused.fused_probe(*args, **kw)
        err_fused = max(err_fused, max_abs_err(found, fused.fused_probe_plain(*args, **kw)))
        check(bool(found[0][:128].all()) and not bool(found[0][128:].any()),
              "bucketized: fused_probe found mask wrong")
        ticks.append(args)
    sync()
    check(err_fp == 0 and err_fused == 0, f"bucketized planes: fingerprint_probe err "
          f"{err_fp}, fused_probe err {err_fused}")
    fp_ms = kernel_ms(lambda: probe.fingerprint_probe(st.fp, st.meta, *lanes),
                      "fingerprint_probe_kernel", flush_mb=128)
    fused_ms = kernel_ms(lambda: fused.fused_probe(*ticks[0], **kw), "fused_probe_kernel",
                         reps=200, flush_mb=128)
    for kernel, e in (("fingerprint_probe", err_fp), ("fused_probe", err_fused)):
        r = report[kernel]
        r["max_abs_err"] = max(r.get("max_abs_err", 0), e)
    report["fingerprint_probe"]["bucketized_ms"] = fp_ms
    report["fused_probe"]["bucketized_ms"] = fused_ms
    log(f"  baselines [{card}]: on the Bucketized planes (ns 0) fingerprint_probe exact on "
        f"{B} direct lanes, {fp_ms * 1e3:.2f} us on the card; fused_probe exact on 16 ticks of "
        f"256 lanes, {fused_ms * 1e3:.2f} us a tick")


def _fig13(t, keys, misses, card: str):
    """Optimistic against pessimistic search of 2048 keys on a clone of the
    loaded Dash-EH table: equal answers, and every touched bucket's version
    up by exactly 4 per touch."""
    from repro_torch.core import DashState, engine, hashing, layout
    cfg = t.cfg
    st = DashState(*(x.clone() for x in t.state))
    q = np.concatenate([keys[:1536], misses[:512]])
    hi, lo = hashing.split_keys(q, DEVICE)
    seg, b = engine.locate(cfg, "eh", st, hashing.hash1(hi, lo))
    BT, NB = cfg.buckets_total, cfg.num_buckets
    rows = torch.cat([seg * BT + b, seg * BT + ((b + 1) & (NB - 1))])
    want = 4 * torch.bincount(rows, minlength=st.version.numel())
    before = layout.u32(st.version.reshape(-1))
    opt_ms = time_ms(lambda: engine.search_batch(cfg, "eh", st, hi, lo), reps=20)
    f_o, v_o = engine.search_batch(cfg, "eh", st, hi, lo)
    sync()
    t0 = time.perf_counter()
    st, f_p, v_p = engine.search_batch_pessimistic(cfg, "eh", st, hi, lo)
    sync()
    pess_ms = (time.perf_counter() - t0) * 1e3
    delta = (layout.u32(st.version.reshape(-1)) - before) & layout.MASK32
    check(torch.equal(f_o, f_p) and torch.equal(v_o, v_p), "fig13: answers differ")
    check(bool(f_p[:1536].all()) and not bool(f_p[1536:].any()), "fig13: wrong found mask")
    check(torch.equal(delta, want), "fig13: a version did not rise by 4 per touch")
    log(f"  baselines fig13 [{card}]: 2048 keys (1536 hits) on a clone of the Dash-EH table: "
        f"optimistic {opt_ms:.3f} ms (device events), pessimistic {pess_ms:.1f} ms (host-bound: "
        f"one Python step a key), answers equal, {int((want > 0).sum())} buckets' versions up "
        f"4 per touch")
    return opt_ms, pess_ms


#: prompts through the prefix cache, cut from 2000 by the run's time limit.
#: Each admitted block is a single-key insert, and each eviction a delete,
#: at ~8 ms of host time apiece on an NVIDIA H100 80GB HBM3 at 700 W: 2000
#: prompts took 92.8 s and 121.3 s in two whole runs that ended at 1019.5 s
#: and 1121.7 s of 1200, and a run with 1000 prompts took 1250 s on a slower
#: host, so the 2M-key load and the shrink phase were cut too. 1000 prompts
#: admit ~4800 blocks into 4096 pages.
PREFIX_PROMPTS = 1000


def _prefix_cache_app(card: str, n_prompts: int = PREFIX_PROMPTS, n_pages: int = 4096):
    """DashPrefixCache(num_pages=4096) over prompts of 256 tokens: a
    192-token prefix from 64 shared ones and 64 tokens of their own (16
    blocks, 12 shared), so admissions outrun the pages and LRU eviction
    runs. Every 50th prompt is matched again right after its admission and
    must hit all 16 blocks."""
    from repro_torch.serving.prefix_cache import BLOCK, DashPrefixCache
    rng = np.random.default_rng(30)
    prefixes = rng.integers(1, 32000, (64, 192))
    cache = DashPrefixCache(num_pages=n_pages, device=DEVICE)
    match_s, t0 = 0.0, time.perf_counter()
    for i in range(n_prompts):
        tokens = np.concatenate([prefixes[rng.integers(0, 64)], rng.integers(1, 32000, 64)])
        s = time.perf_counter()
        _, n = cache.match_prefix(tokens)
        match_s += time.perf_counter() - s
        cache.admit(tokens, n // BLOCK)
        if i % 50 == 49:
            check(cache.match_prefix(tokens)[1] == 256, f"prompt {i}: not cached after admit")
    total_s = time.perf_counter() - t0
    st = cache.stats
    check(st.evictions > 0, "prefix cache: no eviction ran")
    check(len(cache.free) + len(cache.lru) == cache.num_pages
          and cache.table.n_items == len(cache.page_owner),
          f"prefix cache: {len(cache.free)} free + {len(cache.lru)} used pages, "
          f"{cache.table.n_items} entries for {len(cache.page_owner)} owners")
    out = dict(hit_rate=st.hit_rate, evictions=st.evictions, lookups=st.lookups,
               match_us=match_s / n_prompts * 1e6, seconds=total_s)
    log(f"  baselines prefix cache [{card}]: {n_prompts} prompts of 256 tokens (cut from 2000 "
        f"by the time limit; 64 shared prefixes), {n_pages} pages: hit rate {st.hit_rate:.4f}, {st.insertions} insertions, "
        f"{st.evictions} evictions, {out['match_us']:.1f} us per match_prefix (host clock, "
        f"{n_prompts} timed of {st.lookups} lookups), {total_s:.1f}s")
    return out


def _dedup_app(card: str):
    """The dedup stream of examples/dedup_pipeline.py: 30 batches of 8 x 512
    tokens, 25 % synthetic duplicates, through DedupFilter's Dash-LH."""
    from repro_torch.data import DedupFilter, PackedBatcher, PipelineConfig
    pc = PipelineConfig(vocab_size=32000, seq_len=512, batch_size=8, dup_fraction=0.25,
                        doc_len_min=32, doc_len_max=96)
    d = DedupFilter(device=DEVICE)
    b = PackedBatcher(pc, dedup=d)
    t0 = time.perf_counter()
    for _ in range(30):
        b.next_batch()
    s = time.perf_counter() - t0
    check(b.docs_skipped > 0 and d.unique_docs == b.docs_seen - b.docs_skipped,
          f"dedup: {b.docs_seen} seen, {b.docs_skipped} skipped, {d.unique_docs} unique")
    out = dict(seen=b.docs_seen, skipped=b.docs_skipped, doc_us=s / b.docs_seen * 1e6)
    log(f"  baselines dedup [{card}]: 30 batches of 8 x 512 tokens, {b.docs_seen} docs seen, "
        f"{b.docs_skipped} skipped, {d.unique_docs} unique in {d.table.n_segments} LH "
        f"segments; {out['doc_us']:.1f} us per document (host clock), {s:.1f}s")
    return out


def phase_baselines(report, card: str, n_keys: int = BASE_KEYS):
    """The paper's baselines beside Dash on one card, and the Dash apps.

    ``level_scan`` is held exactly to its plain version (the 3000-key
    stream's batches, a padded batch, a move); then one load of ``n_keys``
    unique uniform keys goes into Dash-EH, CCEH, Bucketized (each 32768
    segments at most) and level hashing (``max_log2=20``), with the launch
    counters set to 0 just before and read just after: insert rates, the
    load-factor curve (after every 1/16), final load factors, 1M positive
    and 1M negative searches, every key found with its value and no absent
    key found. Then both read kernels on the Bucketized planes, Fig. 13's
    pair, ``level_scan`` at the load's batch shape on the full table, the
    prefix cache and the dedup stream."""
    from repro_torch.core import DashConfig, DashEH, INSERTED, hashing
    from repro_torch.core.baselines import (LevelConfig, LevelHashing, LevelState,
                                            bucketized_config, cceh_config)
    from repro_torch.kernels import fused, hashmix, level, probe
    t_phase = time.perf_counter()

    # ---- level_scan against its plain version at the CPU stream's size ----
    cfg = LevelConfig(**LEVEL_SMALL)
    t = LevelHashing(cfg, device=DEVICE)
    skeys, svals = _stream_keys(15, 3000)
    err, n_lanes = 0, 0
    for k, v in _level_batches(skeys, svals):
        hi, lo = hashing.split_keys(k, DEVICE)
        vv = torch.from_numpy(v.view(np.int32)).to(DEVICE)
        valid = torch.arange(k.size, device=DEVICE) % 5 != 4     # a masked batch ...
        for mask in (torch.ones_like(valid), valid):              # ... beside a full one
            err = max(err, _level_scan_exact(cfg, t.state, hi, lo, vv, mask)[0])
            n_lanes += k.size
        t.insert(k, v)
    e, st, _ = _level_scan_exact(*_level_move_case(DEVICE))
    check(err == 0 and e == 0 and int(st[0]) == INSERTED,
          f"level_scan differs from its plain version (max err {max(err, e)}, move status "
          f"{int(st[0])})")
    log(f"  baselines [{card}]: level_scan exact against level_scan_plain on {n_lanes} lanes of "
        f"the 3000-key stream (k {int(t.state.k)} after {int(t.state.n_rehashes)} rehashes; "
        f"full and masked batches) and on a key that inserts by the move")

    # ---- the four tables, one load of the same keys ----
    keys = distinct_keys(7 << 40, n_keys)
    vals = (np.arange(n_keys, dtype=np.uint64) * 2246822519 % 2**32).astype(np.uint32)
    misses = distinct_keys(8 << 40, 1 << 20)
    big = dict(max_segments=BASE_POOL[0], dir_depth_max=BASE_POOL[1])
    makers = {
        "Dash-EH": lambda: DashEH(DashConfig(**big), device=DEVICE),
        "CCEH": lambda: DashEH(cceh_config(**big), device=DEVICE),
        "Bucketized": lambda: DashEH(bucketized_config(**big), device=DEVICE),
        "level hashing": lambda: LevelHashing(LevelConfig(max_log2=LEVEL_MAX_LOG2, init_log2=8),
                                              device=DEVICE),
    }
    kernels = {"bulk_hash": hashmix, "fingerprint_probe": probe, "fused_probe": fused,
               "level_scan": level}
    for mod in kernels.values():
        mod.LAUNCHES = 0
    tables, rows, traces = {}, {}, {}
    B = 1 << 20
    for name, make in makers.items():
        t = make()
        lvl = name == "level hashing"
        state_mb = sum(x.numel() * x.element_size() for x in t.state) / 2**20
        batch_keys = (lambda t: LEVEL_BATCH) if lvl else eh_batch
        load_s, curve, traced, n_batches, largest = _baseline_load(
            name, t, keys, vals, batch_keys, trace=name in ("CCEH", "level hashing"))
        t0 = time.perf_counter()
        f, v = t.search(keys[:B])
        sync()
        pos_s = time.perf_counter() - t0
        n_pos = f.size
        check(f.all() and (v == vals[:B]).all(), f"{name}: a loaded key is wrong")
        for a in range(B, n_keys, B):
            f, v = t.search(keys[a:a + B])
            check(f.all() and (v == vals[a:a + B]).all(), f"{name}: a loaded key is wrong")
        t0 = time.perf_counter()
        f, _ = t.search(misses)
        sync()
        neg_s = time.perf_counter() - t0
        check(not f.any(), f"{name}: an absent key was found")
        shape = (f"k {int(t.state.k)}, {int(t.state.n_rehashes)} rehashes" if lvl else
                 f"{t.n_segments} segments, global depth {t.global_depth}, "
                 f"{t.insert_rounds} insert rounds")
        rows[name] = dict(insert_mops=n_keys / load_s / 1e6, pos_mops=n_pos / pos_s / 1e6,
                          neg_mops=misses.size / neg_s / 1e6, lf=t.load_factor,
                          curve=curve, shape=shape, state_mb=state_mb, load_s=load_s,
                          batches=n_batches, largest=largest)
        if traced is not None:
            traces[name] = traced
        policy = (f"{LEVEL_BATCH} keys each" if lvl else
                  f"64 keys a segment, at least 256, the largest {largest}")
        log(f"  baselines {name} [{card}]: {n_keys} keys (cut from 2000000 by the time limit) "
            f"in {n_batches} batches ({policy}), "
            f"{load_s:.1f}s "
            f"({n_keys / load_s / 1e6:.3f} Mops/s); search {n_pos} hits {n_pos / pos_s / 1e6:.3f} Mops/s, 1M misses "
            f"{misses.size / neg_s / 1e6:.3f} Mops/s; load factor {t.load_factor:.4f} ({shape}, "
            f"{state_mb:.0f} MB state); curve " + " ".join(f"{x:.3f}" for x in curve))
        tables[name] = t
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    check(launches["level_scan"] > 0 or DEVICE != "cuda", "level_scan was not launched")
    for kernel, count in launches.items():
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})["baselines"] = count
        r["launches"] = sum(r["paths"].values())
    for name, (wall, busy, top, n) in traces.items():
        log(f"  trace baselines {name} [{card}] one load batch of {n} keys: wall "
            f"{wall * 1e3:.1f} ms, card busy {busy * 1e3:.1f} ms (busy share {busy / wall:.3f}); "
            f"top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    del tables["CCEH"]

    # ---- kernels on the Bucketized planes, Fig. 13 ----
    _bucketized_kernels(tables.pop("Bucketized"), keys, misses, report, card)
    opt_ms, pess_ms = _fig13(tables.pop("Dash-EH"), keys, misses, card)

    # ---- level_scan at the load's batch shape on the loaded table ----
    t = tables.pop("level hashing")
    fresh = np.concatenate([distinct_keys(9 << 40, LEVEL_BATCH - 64), keys[:64]])
    hi, lo = hashing.split_keys(fresh, DEVICE)
    vv = torch.from_numpy(vals[:LEVEL_BATCH].view(np.int32)).to(DEVICE)
    valid = torch.ones(LEVEL_BATCH, dtype=torch.bool, device=DEVICE)
    err, st, plain_s = _level_scan_exact(t.cfg, t.state, hi, lo, vv, valid)
    counts = np.bincount(st.cpu().numpy(), minlength=5)
    check(err == 0 and counts[1] == 64, f"level_scan at full size: err {err}, statuses {counts}")
    base, work = t.state, LevelState(*(x.clone() for x in t.state))

    def reset():         # each launch finds the table as the load left it
        for w, b in zip(work, base):
            w.copy_(b)
    ms = kernel_ms(lambda: level.level_scan(t.cfg, work, hi, lo, vv, valid),
                   "level_scan_kernel", reps=10, setup=reset)
    # bytes: the batch in, statuses out, four candidate buckets read (alloc
    # word + 2 key rows) per key, one record + alloc word written per insert
    nbytes = LEVEL_BATCH * (13 + 4 + 4 * 36) + counts[0] * 16
    by_bytes = bound(nbytes, ops=LEVEL_BATCH * 100.0)
    # the operations that bound it: each key's step reads what the previous
    # one wrote, so its dependent loads form one chain, one round trip a key
    # and two where no candidate has room, at one per measured load latency
    load_ns = report.get("fused_probe", {}).get("load_ns", float("nan"))
    levels = LEVEL_BATCH + counts[2]
    chain_ms = levels * load_ns * 1e-6
    report["level_scan"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3, byte_bound=by_bytes,
        bound=(chain_ms, "operations") if chain_ms > by_bytes[0] else by_bytes,
        shape=f"{LEVEL_BATCH}-key batch", chain=(levels, load_ns))
    log(f"  baselines [{card}]: level_scan exact at the load's shape ({LEVEL_BATCH} keys into the "
        f"loaded table: {counts[0]} inserted, {counts[1]} exist, {counts[2]} need a rehash); "
        f"{ms * 1e3:.1f} us on the card ({ms / LEVEL_BATCH * 1e6:.1f} ns a key), plain "
        f"{plain_s * 1e3:.1f} ms; bound {chain_ms * 1e3:.1f} us by its chain of {levels} "
        f"dependent loads x {load_ns:.1f} ns (byte bound {by_bytes[0] * 1e3:.3f} us)")
    del t, base, work

    # ---- the apps ----
    pc = _prefix_cache_app(card)
    dd = _dedup_app(card)
    secs = time.perf_counter() - t_phase
    log(f"phase baselines: ok launches {launches} ({secs:.1f}s) [{card}]")
    return dict(rows=rows, fig13=(opt_ms, pess_ms), prefix=pc, dedup=dd, seconds=secs)


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` issued back to back (one sync at
    the end): what the wrapper costs the caller when its kernel is shorter."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def latency_floor(steps: int = 1 << 14, mib: int = 512):
    """(ms of an empty launch, ns per dependent HBM load): the second from
    one thread chasing ``steps`` loads through a random single-cycle
    permutation of ``mib`` MiB of u32 indices (10x the L2, flushed before
    each timed chase), empty launch subtracted."""
    from repro_torch.kernels import _build
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    empty_ms = kernel_ms(lambda: lib.dash_noop_launch(stream), "noop_kernel", reps=200)
    m = mib << 18
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    perm = torch.randperm(m, device=DEVICE, generator=gen)
    nxt = torch.empty(m, dtype=torch.int32, device=DEVICE)
    nxt[perm] = perm.roll(-1).int()                      # one cycle through all m
    del perm
    out = torch.empty(1, dtype=torch.int32, device=DEVICE)
    chase_ms = time_ms(lambda: _build.check(lib.dash_latency_chase(
        nxt.data_ptr(), steps, out.data_ptr(), stream), "latency_chase"), reps=5,
        flush_mb=128)                                   # the chain's lines leave L2
    return empty_ms, (chase_ms - empty_ms) * 1e6 / steps


def _probe_bytes(bt, lanes) -> int:
    """HBM bytes fingerprint_probe needs: lane words in and out, plus the
    32-byte sectors of every fp row and meta word the lanes touch."""
    n = lanes[0].numel()
    rows = torch.cat([lanes[0].long() * bt + lanes[2].long(),
                      lanes[0].long() * bt + lanes[3].long()])
    return n * 16 + n * 16 + SECTOR * (sectors(rows * 16) + sectors(rows * 4))


def _fused_bytes(cfg, st, args, found):
    """HBM bytes one tick needs: lane words in and out, plus the 32-byte
    sectors of every row the kernel visits (meta always; fp and key rows
    where the row has allocated slots; the value on a hit). Rows after a
    lane's hit are not visited."""
    NB, BT, SL, ns = cfg.num_buckets, cfg.buckets_total, cfg.num_slots, cfg.num_stash
    seg, b, pb = args[6].long(), args[8].long(), args[9].long()
    rows = [b, pb] + [torch.full_like(b, NB + s) for s in range(ns)]
    active = st.stash_active[seg].long()
    hit_row = torch.full_like(b, len(rows))          # index of the row holding the hit
    alloc_rows = []
    for i, r in enumerate(rows):
        alloc = st.meta[seg, r].long() & 0x3FFF
        keys_here = ((st.key_hi[seg, r] == args[10][:, None]) & (st.key_lo[seg, r] == args[11][:, None])
                     & (((alloc[:, None] >> torch.arange(SL, device=b.device)) & 1) == 1)).any(-1)
        hit_row = torch.where((hit_row == len(rows)) & keys_here & (found != 0), i, hit_row)
        alloc_rows.append(alloc != 0)
    meta_off, fp_off, key_off, val_off = [], [], [], []
    for i, r in enumerate(rows):
        visited = i <= hit_row
        if i >= 2:
            visited = visited & (i - 2 < active)
        flat = seg * BT + r
        meta_off.append((flat * 4)[visited])
        full = visited & alloc_rows[i]
        fp_off.append((flat * 16)[full])
        key_off += [(flat * SL * 4 + k)[full] for k in list(range(0, SL * 4, SECTOR)) + [SL * 4 - 1]]
        val_off.append((flat * SL * 4)[visited & (hit_row == i)])
    # planes live in separate allocations: count their sectors separately
    total = sum(sectors(torch.cat(x)) for x in (meta_off, fp_off, val_off))
    total += 2 * sectors(torch.cat(key_off))                      # key_hi, key_lo
    return 256 * 24 + 256 * 8 + SECTOR * total


def kernel_line(report):
    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = report[name]
        bound_ms, bound_by = r["bound"]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    return json.dumps({"kernels": rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=20_000_000,
                    help="keys loaded on the main path (default 20M, never below 4M)")
    ap.add_argument("--lh-keys", type=int, default=LH_KEYS,
                    help=f"keys loaded on the LH path (default {LH_KEYS}, never below 4M)")
    ap.add_argument("--fe-keys", type=int, default=FE_KEYS,
                    help=f"keys loaded before the frontend's split storm (default "
                         f"{FE_KEYS}, never below 4M)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import DashConfig   # fails outside a checkout of the repo
    if min(args.keys, args.lh_keys, args.fe_keys) < 4_000_000:
        print("chip_smoke: --keys, --lh-keys or --fe-keys below 4M is not the main path",
              file=sys.stderr)
        return 2
    card = gpu_line()
    log(f"card: {card}")
    if args.keys != 20_000_000:
        log(f"main path cut: {args.keys} keys of 20000000")
    if args.lh_keys != 20_000_000:
        log(f"lh path cut: {args.lh_keys} keys of 20000000")
    if args.fe_keys != 8_000_000:
        log(f"frontend cut: {args.fe_keys} keys of 8000000")
    report = {}
    t0 = time.perf_counter()
    try:
        phase_build()
        phase_bulk_hash(report)
        phase_cuda_vs_cpu()
        phase_edges()
        t, keys, misses, summary, truth = phase_main_path(
            DashConfig(max_segments=32768, dir_depth_max=17), args.keys, 1000, report)
        phase_probe_kernels(t, keys, misses, report)
        phase_recovery(t, keys, misses, truth)
        del t, truth
        fe, carry = phase_frontend(DashConfig(max_segments=32768, dir_depth_max=17),
                                   args.fe_keys, FE_FRESH, report, card)
        dur = phase_durable(carry, report, card)
        del carry
        t, keys, misses, lh, _ = phase_main_path(
            DashConfig(max_segments=32768, num_stash=4), args.lh_keys, 1000, report,
            "DashLH", "lh", lh_batch, LH_RETRIES)
        phase_probe_kernels(t, keys, misses, report)
        del t
        phase_shrink(DashConfig(max_segments=32768, dir_depth_max=17))
        base = phase_baselines(report, card)
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    for name in KERNELS:
        r = report[name]
        floor = (f"; latency floor {r['floor_ms'] * 1e3:.2f} us" if "floor_ms" in r else "")
        if "lh" in r:
            floor += (f"; {r['lh']['ms'] * 1e3:.2f} us at 1M LH lanes (ns 4), bound "
                      f"{r['lh']['bound'][0] * 1e3:.3f} us by {r['lh']['bound'][1]}")
        if "bucketized_ms" in r:
            floor += f"; {r['bucketized_ms'] * 1e3:.2f} us on the Bucketized planes (ns 0)"
        if "chain" in r:
            floor += (f": a chain of {r['chain'][0]} dependent loads x {r['chain'][1]:.1f} ns; "
                      f"byte bound {r['byte_bound'][0] * 1e3:.3f} us")
        call = f"{r['call_ms'] * 1e3:.2f} us per wrapper call; " if "call_ms" in r else ""
        log(f"kernel {name}: {r['ms'] * 1e3:.2f} us on the card per launch at "
            f"{r['shape']} ({call}plain {r['plain_ms'] * 1e3:.2f} us; bound "
            f"{r['bound'][0] * 1e3:.3f} us by {r['bound'][1]}{floor}), "
            + " + ".join(f"{n} launches on the {p} path" for p, n in r["paths"].items())
            + f" [{card}]")
    log(f"end to end [{card}]: insert {summary['insert_mops']:.3f} Mops/s, search "
        f"{summary['search_mops']:.3f} Mops/s, tick p50 {summary['tick_p50_ms']:.3f} ms "
        f"p99 {summary['tick_p99_ms']:.3f} ms ({summary['keys']} keys, "
        f"{summary['segments']} segments, {summary['state_mb']:.0f} MB state)")
    log(f"end to end LH [{card}]: insert {lh['insert_mops']:.3f} Mops/s, search "
        f"{lh['search_mops']:.3f} Mops/s, tick p50 {lh['tick_p50_ms']:.3f} ms "
        f"p99 {lh['tick_p99_ms']:.3f} ms ({lh['keys']} keys, {lh['segments']} segments, "
        f"load factor {lh['load_factor']:.3f}, {lh['state_mb']:.0f} MB state)")
    log(f"end to end frontend [{card}]: read sojourn p50 {fe['fe_p50']:.3f} ms p99 "
        f"{fe['fe_p99']:.3f} ms, stop-the-world p50 {fe['stw_p50']:.3f} ms p99 "
        f"{fe['stw_p99']:.3f} ms; {fe['ticks']} ticks, {fe['publishes']} publishes of "
        f"{fe['mean_publish_bytes'] / fe['state_bytes']:.6f} of the state on average, "
        f"publish_seconds {fe['publish_seconds']:.2f}, retried share "
        f"{fe['retried_share']:.5f}; phase {fe['seconds']:.0f}s")
    log(f"end to end durable [{card}]: checkpoint {dur['checkpoint_s']:.2f}s; {dur['flushes']} "
        f"flushes of {dur['flush_share']:.6f} of the planes, {dur['flush_ms']:.2f} ms mean "
        f"p99 {dur['flush_p99_ms']:.2f} ms; read sojourn with flush-on-publish p50 "
        f"{dur['p50']:.3f} ms p99 {dur['p99']:.3f} ms; reopen {dur['reopen_s']:.3f}s "
        f"(verified {dur['verify_s']:.3f}s), first 1M-key read {dur['first_s']:.3f}s "
        f"({dur['first_segments']} segments); {dur['moved']:.0f} B transferred to the host a "
        f"flush ({dur['staged']:.0f} B staged by the reference's measure), checkpoint "
        f"{dur['ckpt_moved']} B; phase {dur['seconds']:.0f}s")
    for name, r in base["rows"].items():
        log(f"end to end baselines {name} [{card}]: insert {r['insert_mops']:.3f} Mops/s "
            f"({r['batches']} batches, the largest {r['largest']} keys), search "
            f"hits {r['pos_mops']:.3f} / misses {r['neg_mops']:.3f} Mops/s, load factor "
            f"{r['lf']:.4f} ({r['shape']}, {r['state_mb']:.0f} MB state)")
    log(f"end to end apps [{card}]: fig13 2048 keys optimistic {base['fig13'][0]:.3f} ms, "
        f"pessimistic {base['fig13'][1]:.1f} ms (host-bound); prefix cache hit rate "
        f"{base['prefix']['hit_rate']:.4f}, {base['prefix']['evictions']} evictions, "
        f"{base['prefix']['match_us']:.1f} us per match_prefix; dedup {base['dedup']['skipped']} "
        f"of {base['dedup']['seen']} docs skipped, {base['dedup']['doc_us']:.1f} us per document; "
        f"phase {base['seconds']:.0f}s; total {time.perf_counter() - t0:.0f}s")
    log(card)
    log(kernel_line(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
