#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Dash (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--keys N] [--lh-keys N] [--fe-keys N]

Phases, each printed on its own line and each able to fail the run:

  1. the card's name and power limit; build the three CUDA kernels from
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
  9. shrink: a DashEH in the main path's pool geometry loaded with 1M keys,
     0.8M deleted, ``shrink()``, the survivors and the deleted keys
     checked, then 0.5M fresh keys inserted: the watermark may grow only
     once the freed ids are used up.

Each kernel's ``launches`` in the JSON line is the sum over the four
paths driven with counters (the EH main path, the frontend, the durable
path and the LH path). The last three
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
SHRINK_KEYS = 1_000_000
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


def time_ms(fn, reps: int = 30, flush_mb: int = 0) -> float:
    """Median device time of one call (CUDA events around each call, after
    two warm-up calls); with ``flush_mb`` a buffer that size is rewritten
    before each call so the call finds the 50 MB L2 cold."""
    flush = (torch.empty(flush_mb << 20, dtype=torch.uint8, device=DEVICE)
             if flush_mb else None)
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
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


def kernel_ms(fn, kernel: str, reps: int = 30, flush_mb: int = 0) -> float:
    """Median device time of one launch of ``kernel`` inside ``fn``, from the
    profiler's record of the card (the wrapper's host time excluded); event
    timing of the whole call where the profiler records no device time."""
    if DEVICE != "cuda":
        return time_ms(fn, reps, flush_mb)
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.empty(flush_mb << 20, dtype=torch.uint8, device=DEVICE)
             if flush_mb else None)
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _device_events(prof) if kernel in e.name]
    if not times:
        log(f"  profiler recorded no {kernel} launch: timing whole calls")
        return time_ms(fn, reps, flush_mb)
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


def _op_stream(cfg, device, seed: int, table: str = "DashEH"):
    """Inserts of every plan (fused / segment, with splits), reads of both
    plans, deletes and updates; returns the table and every answer."""
    from repro_torch import core
    keys, vals = _stream_keys(seed, 12000)
    t = getattr(core, table)(cfg, device=device)
    out = []
    for a, b in ((0, 300), (300, 1500), (1500, 5000), (5000, 12000)):
        out.append(t.insert(keys[a:b], vals[a:b]))
    out += list(t.search(keys[:5000])) + list(t.search(keys[5000:5300]))
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
    log(f"phase cuda_vs_cpu: ok byte-identical states after 12000 inserts, "
        f"{t_eh.n_segments} segments, deletes/updates/searches; LH stream "
        f"{t_lh.n_segments} segments; crash streams (EH with an interrupted split, "
        f"LH) recovered {facts['eh crash'][0].recovered_segments} / "
        f"{facts['lh crash'][0].recovered_segments} segments lazily; shrink stream "
        f"{merges} merges, {freed - (len(refill) - 1)} freed ids recycled; "
        f"frontend streams (fused / routed reads; SMO stages / retried reads) "
        f"{', '.join(fe_counts)}; pointer stream {t_ptr.n_segments} segments, heap_top "
        f"{int(t_ptr.state.heap_top)}; durable streams with byte-identical pool files "
        f"after every flush ({'; '.join(durable_facts)}) ({time.perf_counter() - t0:.1f}s)")


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
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, floor_ms=floor_ms,
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
    ckpt_staged = wb.last_staged_bytes
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
                              wb.last_flush_bytes, wb.last_staged_bytes))

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
               staged=pf[:, 3].mean(), flush_ms=pf[:, 0].mean() * 1e3,
               flush_p99_ms=np.percentile(pf[:, 0], 99) * 1e3, stage_ms=pf[:, 1].mean() * 1e3,
               io_ms=(pf[:, 0] - pf[:, 1]).mean() * 1e3, p50=np.percentile(rl, 50),
               p99=np.percentile(rl, 99))
    log(f"  durable [{card}]: checkpoint {ckpt_s:.2f}s ({ckpt_bytes} B written, {ckpt_staged} B "
        f"staged, planes {plane_bytes} B); storm {len(blocks) * 256} fresh inserts (the first "
        f"512 into segment {seg}, {held} records), {n_ops} ops "
        f"in {st['published']} publishes, {f.smo_dispatches} staged SMOs, {storm_s:.1f}s; "
        f"{len(pf)} flushes, mean {out['flush_share']:.6f} of the plane bytes flushed and "
        f"{out['staged']:.0f} B staged a flush, {st['logged_rows']} rows logged; flush "
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
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    for name in KERNELS:
        r = report[name]
        floor = (f"; latency floor {r['floor_ms'] * 1e3:.2f} us" if "floor_ms" in r else "")
        if "lh" in r:
            floor += (f"; {r['lh']['ms'] * 1e3:.2f} us at 1M LH lanes (ns 4), bound "
                      f"{r['lh']['bound'][0] * 1e3:.3f} us by {r['lh']['bound'][1]}")
        log(f"kernel {name}: {r['ms'] * 1e3:.2f} us on the card per launch at "
            f"{r['shape']} ({r['call_ms'] * 1e3:.2f} us per wrapper call; plain "
            f"{r['plain_ms'] * 1e3:.2f} us; bound {r['bound'][0] * 1e3:.3f} us by "
            f"{r['bound'][1]}{floor}), {r['paths']['main']} launches on the main path "
            f"+ {r['paths']['frontend']} on the frontend path + {r['paths']['durable']} on "
            f"the durable path + {r['paths']['lh']} on the LH path [{card}]")
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
        f"({dur['first_segments']} segments); phase {dur['seconds']:.0f}s; "
        f"total {time.perf_counter() - t0:.0f}s")
    log(card)
    log(kernel_line(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
