#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Dash (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--keys N] [--lh-keys N] [--fe-keys N]

Phases, each printed on its own line and each able to fail the run:

  1. the card's name and power limit; build the four CUDA kernels from
     ``src/repro_torch/kernels/csrc`` with nvcc (one process per source);
  2. ``bulk_hash`` against its plain PyTorch version on 1M keys plus a
     ragged tail and the edge words;
  3. small op streams through the port on the card and on the CPU, each
     pair ending byte-identical in answers and planes (the CPU halves run
     in a child process started with the run, two threads, while the card
     runs its halves; a child that fails or hangs fails the run): an EH
     stream; an LH
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
     path's geometry, started at 1024 segments (depth 10: the main path
     drives the growth from one segment), loaded with 4M keys (cut from 8M
     by the time limit),
     then a split storm of 131,072 fresh inserts (cut from 262,144 by the
     time limit), one read of a loaded key
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
     and checkpointed by a full flush; a split storm of 16,384 fresh
     inserts (cut from 65,536 by the time limit; the 7b stream's shape)
     through DashFrontend with
     flush-on-publish, the scrubber every tick and the flight recorder;
     the table dropped without ``close()``, reopened without and with
     checksum verification, the first 1M-key read recovering lazily and
     every acknowledged key checked (the kill is a child process on the
     card: it reopens the closed pool, acknowledges one more batch and
     dies by ``os._exit`` inside the next flush's ``pool.commit``;
     forensics must name that flush's keys as in flight); one flush
     carrying an SMO torn at its
     commit fence by a ``FaultPlan``, forensics on the dead pool naming
     exactly that flush's keys as in flight, and every acknowledged key
     found after a last reopen. Checkpoint seconds, flushes, flushed and
     staged bytes, flush seconds split into device staging and pool I/O,
     read sojourn with flush-on-publish, scrubbed rows, both reopen times,
     the first read, free disk and the busy share of 50 traced ticks.
     Launch counters as on the main path;
  8-10 run in a second process on the card (the side lane), started
     after phase 2, beside phases 3-7c, 12 and 13 of this one: the host
     drives every path, one core a process. Each process holds the card's
     lock while it times kernels or runs a model phase;
  8. the LH path: a DashLH in the paper's geometry (``max_segments=32768,
     num_stash=4``, ~445 MB of planes) loaded with unique uniform keys in
     batches sized to its stride growth, then the main path's reads,
     ticks, deletes and updates against a ground truth, its launch
     counters (set to 0 just before, read just after); then fresh keys
     that hash into one segment fill it until all 4 of its stash rows are
     active, and both read kernels are held to their plain versions on
     the filled LH table, on lanes and ticks that reach that segment;
     ``fingerprint_probe`` timed at 1M LH lanes;
  9. shrink: a DashEH in the main path's pool geometry, started at 128
     segments (depth 7), loaded with 0.25M keys (cut from 0.5M by the
     time limit), 0.2M deleted, ``shrink()``,
     the survivors and the deleted keys checked, then 0.125M fresh keys
     inserted: the watermark may grow only
     once the freed ids are used up;
 10. baselines: ``level_scan`` exact against its plain version (the
     3000-key level-hashing stream's batches, full and masked, and a key
     that inserts by the move); then the same 0.5M unique uniform keys (cut
     from 2M by the time limit) loaded into Dash-EH, CCEH and Bucketized
     (32768 segments at most, in the main path's growing batches) and level hashing (``max_log2=20``,
     ~82 MB of planes, in Fig. 7's 4096-key batches) with the launch
     counters set to 0 just before and read just after: insert rates, the load factor after every 1/16 of the load
     (Fig. 12's curve), 0.5M positive and 1M negative searches, every key
     found with its value and no absent key found, the busy share of one
     traced level-hashing and one traced CCEH load batch; both read
     kernels exact on the Bucketized planes (no stash) and timed there;
     Fig. 13's optimistic and pessimistic search of 2048 keys on a clone
     of the Dash-EH table (equal answers, versions up 4 per touch);
     ``level_scan`` exact and timed at the load's 4096-key batch on the
     loaded table; the prefix cache (400 prompts of 256 tokens from 64
     shared prefixes, cut from 2000 by the time limit; 2048 pages, cut from
     4096, evictions; halved past the run's budget) and the dedup stream of
     ``examples/dedup_pipeline.py`` (15 of its 30 batches; 8 past the
     budget). Phase 3 also
     streams level hashing
     (through 6 rehashes), CCEH, Bucketized, the pessimistic search (EH
     and LH), the prefix cache and the dedup filter on the card and on the
     CPU, byte-identical;
 11. the sharded DHT (``repro_torch.distributed``), one process per rank:
     a 4-rank stream (inserts through splits, searches, ShardFrontend in
     both verify modes over durable shard pools, the pools flushed, the
     table dropped, every shard reopened lazily and searched) on 4 gloo
     ranks on the card and 4 on the CPU, answers, every rank's planes
     after every stage and every shard pool file byte-identical; then on
     the card's 4 ranks (a gloo group sharing the one card: NCCL refuses
     two ranks on one device, and gloo stages each exchange through the
     host — not a multi-GPU scaling result) each shard in the main path's
     geometry, 1M unique uniform keys loaded in global batches growing to
     65,536, 1M hits and 1M misses searched in 65,536-key batches
     (``fingerprint_probe`` per shard), 200 read ticks of 1024 keys
     (``fused_probe`` per shard) and a ShardFrontend storm of 16,384
     inserts with a read each, every answer checked, insert and search
     rates, rounds and split calls per batch, the exchange's share of the
     wall time, read sojourn p50/p99, the busy share of a traced read
     batch; the kernels held to their plain versions on shard-local
     batches; the same path on a one-rank NCCL group at 65,536 keys. Past
     the run's budget (800 s, ``RUN_BUDGET_S``) the baselines' apps are
     halved, yi-6b's third round goes, and the DHT's key count is cut
     (each logged).
 12. LM serving at full width (run before 11, with 12b, so that the run's
     budget can still cut the DHT's keys): yi-6b at its published widths and
     depth (32 layers, d_model 4096, 32 heads, GQA 4, d_ff 11008, vocab
     64000, bf16: 6,060,769,280 weights, ~12.1 GB), random weights drawn
     on the card from a seed, served by ``ServingEngine`` with the Dash
     prefix cache as its KV-page directory (cache 1024 tokens, 1024 pages
     of 16 tokens, 4 lanes): 3 rounds of 4 requests, each a 512-token
     shared system prompt plus 128 fresh tokens, 32 new tokens each. The
     launch counters are set to 0 just before the rounds and read just
     after. Checks: 11 of 12 requests reuse 512 cached tokens and prefill
     128, no logit is non-finite, the prefix table's ``n_items`` equals its
     recount, and decode agrees with prefill at full width (64 tokens; the
     reference's tolerance, rtol 0.12 atol 0.6, and the same argmax).
     Prints weights, pool and peak HBM; prefill ms cold (640 tokens) and of
     a 128-token suffix against the FLOP bound; decode step p50/p99 and
     tokens/s against the byte bound (weights + KV); the hit rate, µs per
     ``match_prefix``, ms per ``admit``; the busy share of one traced
     decode step (with its top device ops) and one traced suffix prefill.
     Phase 3 also streams the LM engine on the card and on the CPU in
     float32 (reduced yi-6b, h2o-danube-3-4b and mixtral-8x7b whose
     windows roll their rings, recurrentgemma-9b and rwkv6-7b, whose
     100-token prompts take RWKV's ragged last chunk): tokens, counts,
     pages, the prefix cache's state and planes equal, every page-pool
     field within 1e-4; and ``forward_prefill`` plus 3 ``serve_step``s of
     the stub fronts (reduced llava-next-mistral-7b and musicgen-large):
     logits and states within 1e-4.
 12b. the other block kinds, served like yi-6b (2 rounds, 8 requests
     each), one model at a time, each freed before the next:
     recurrentgemma-9b at its published width and depth (38 layers: 26
     RG-LRU with a 2-layer tail, 12 local MQA layers of head_dim 256;
     10.44B weights, ~20.9 GB), rwkv6-7b (32 layers of 64 heads x 64;
     7.52B, ~15.0 GB; 128 pages: a page holds a 34.1 MB state snapshot)
     and mixtral-8x7b at its published width on 16 of its 32 layers
     (23.48B, ~47.0 GB: its 93.4 GB do not fit one card). The same checks
     and lines as phase 12, plus the weight count against the model's own
     leaves (``leaf_count``) and peak HBM; decode agrees with prefill at
     64 tokens in bf16 at full width, for mixtral in f32 on 2 of its
     layers (bf16 flips near-tied top-2 routes between the two paths).
 13. training at full width (run after 12b, before 11): yi-6b at its
     published widths on 4 of its 32 layers (1,216,385,024 weights: 32
     layers would need ~97 GB of card memory at ~16 B a weight, and each
     commit is 12 B a weight on disk), f32 masters drawn on the card from
     seed 0, bf16 working weights, the launcher's batches (4 x 256 tokens)
     through the Dash-LH dedup stage (``DedupFilter`` on the card, 5 %
     aliased documents) into the fault-tolerant ``Trainer``: 8 steps, an
     async commit every 4 (one kept, under the git-ignored ``build/train``,
     removed at the end), a fault injected at step 5 and restored from the
     step-4 commit, the final clean commit; then the dedup stage screens
     the stream on to its 256th document (~12 aliased). Snapshots go
     through one pinned host buffer the checkpoint manager reuses; files
     are written by 4 threads. The launch counters are set to 0 just
     before the run and read just after the screening. Checks: every loss
     finite, the last below the first, the restart restored step 4, every
     restored tensor equal to the commit's bytes (checked by the fault
     hook at the first step after the restart), some documents aliased and
     every one skipped, the dedup table's ``n_items`` equal to its
     recount. Prints peak HBM,
     the step p50 against the FLOP bound (6 x the matrices a token
     multiplies x tokens / 989 TFLOP/s) and AdamW's byte bound (28 B a
     weight / 3.35 TB/s), the busy share of 2 traced steps, each save's
     host-copy and write seconds and GB, the restore's manifest and tensor
     seconds, and the disk. Phase 3 also runs 3 ``Trainer`` steps in
     float32 on the card and on the CPU from one ``TrainState`` for
     reduced yi-6b, h2o-danube-3-4b (the SWA band), mixtral-8x7b (MoE),
     recurrentgemma-9b, rwkv6-7b and llava-next-mistral-7b (the vlm front),
     and 4 steps of ``python -m repro_torch.launch.train --dedup`` through
     its ``main``: losses, grad norms and the final states within
     ``LM_STREAM_TOL``.

 13b. training on a mesh (inside phase 11's 4 gloo card ranks, before
     their DHT work; the ranks are the DHT's, so the phase pays no spawn of
     its own): a 2 x 2 (data x model) ``DeviceMesh``, yi-6b at its
     published widths on 4 layers, drawn from seed 0 as phase 13's, 2
     steps on phase 13's first 2 batches under each preset of
     ``MESH_RUNS``: ``train_dp`` (ZeRO-3: masters, ``m`` and ``v`` sharded
     on each leaf's embed dim over both axes, one row a rank), then
     ``train`` (FSDP + TP + SP: two rows a data rank, half the sequence a
     model rank), every collective staged through pinned host buffers
     (gloo on one card: not a multi-GPU result). Checks, for each preset:
     the losses within one bf16 roundoff of phase 13's first 2 and equal
     on every rank, 16 embedding rows, layer 0's wq and the final norm
     within 2.1 x the steps' summed learning rates of phase 13's;
     ``compressed_psum`` over 'data' of three first-step gradient shards
     (under ``train_dp``) equal to its formula
     recomputed on the host; ``moe_apply_shardmap`` (reduced mixtral,
     train_dp) and ``moe_apply_ep_shardmap`` (reduced phi3.5, train_dp_ep)
     on each rank's row within 1e-5 of the same variant computed in one
     process; the elastic runbook at reduced yi-6b (a sharded commit in the
     reference's format, ``shrink_mesh`` to (1, 2), ranks 2 and 3 leave,
     the restore, the reshard, one step under ``train``, the default of
     ``relower_for_mesh``) within the CPU tests' bf16 bounds of the
     one-device step from the same commit. Prints, for each preset, the
     steps' times, peak HBM a rank, the bytes a step hands to each
     collective a rank, and the card's kernel busy share over the traced
     last step (the four ranks' kernel time summed) beside the host
     copies' time.

Each kernel's ``launches`` in the JSON line is the sum over the thirteen
paths driven with counters (the EH main path, the frontend, the durable
path, the LH path, the baselines' load, the 4-rank DHT summed over its
ranks, the one-rank NCCL DHT, the four LM serving paths, the train path
and the mesh path, which launches none: its batches are phase 13's,
already screened). The durable line also prints
the bytes that really crossed to the host a flush. The last three
lines are the card line, one JSON object describing every kernel, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
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
#: the frontend's table starts at this depth (1024 segments), so its load
#: skips the tiny first batches that the main path drives from one segment
#: (the main path reached 512 segments at 55.7 s of its load on a host where
#: the frontend's whole 4M-key load took 105.9 s); at 4M keys it splits to
#: ~8192 segments as before
FE_DEPTH = 10
FE_FRESH = 1 << 17
#: the shrink phase: keys loaded (80 % then deleted), then fresh keys
#: (cut from 1M when the baselines phase came: whole runs took 925-1250 s
#: of the 1200 with the host's speed; then to 0.5M and 0.25M). Its time is
#: its load's growing batches, not its keys: 72.0 s at 0.25M and 71.5 s at
#: 0.125M on two hosts
SHRINK_KEYS = 250_000
#: the shrink table starts at this depth (128 segments), so its load skips
#: the main path's tiny first batches (the phase tests the merges, not the
#: growth from one segment, which the main path drives): its growing-batch
#: load took 99.1 s of a whole run that ended at 1158 s on a slow host.
#: Merges still go below it (to depth 1)
SHRINK_DEPTH = 7
#: the durable phase's storm: fresh inserts through flush-on-publish (cut
#: from 65,536 by the time limit: every flush fences the 969 MB mapping)
DURABLE_FRESH = 1 << 14
# The LM phase came with these cuts: on a host where the same phases ran
# 30-40 % slower than PR 17's final run, the whole run reached 1259 s
# before its DHT phase. The frontend's storm was halved (from 262,144),
# shrink's keys (from 500,000), the durable storm (from 32,768), the
# baselines' load (from 1M), the prefix-cache prompts (from 1000, to 400)
# and the dedup stream's batches (from 30).
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


#: the run's start on the host's clock: each phase's line ends with the
#: seconds of the run spent when it is printed
_RUN_T0 = time.perf_counter()


#: what this process shares with the other across the card when the side
#: lane runs (``side_lane``; None without it): (the timing lock, the step
#: lock, the main process's wish for the step lock, whether the other
#: process is still alive, whether this process is the side lane). A
#: process holds the timing lock while it times kernels or runs a model
#: phase, so those never overlap each other; the side lane holds the step
#: lock around each step of its loops, and the main process takes it too
#: while it times kernels, so the side lane's card work stops meanwhile
_LANES = None


def _take(lock) -> None:
    while not lock.acquire(timeout=1.0):
        check(_LANES[3](), "the process across the card's locks died")


@contextlib.contextmanager
def quiet_card(pause_side: bool = False):
    """The timing lock for the block (when the side lane runs); with
    ``pause_side`` (the main process's timed kernels) the step lock too."""
    if _LANES is None:
        yield
        return
    timing, step, wanted, _, _ = _LANES
    _take(timing)
    try:
        if not pause_side:
            yield
            return
        wanted.set()
        try:
            _take(step)
        finally:
            wanted.clear()
        try:
            yield
        finally:
            step.release()
    finally:
        timing.release()


@contextlib.contextmanager
def side_step():
    """One step of a loop: in the side lane it holds the step lock, after
    waiting while the main process wants it; elsewhere it does nothing. No
    timing lock is taken inside a step."""
    if _LANES is None or not _LANES[4]:
        yield
        return
    while _LANES[2].is_set():
        time.sleep(0.002)
    _take(_LANES[1])
    try:
        yield
    finally:
        _LANES[1].release()


def log(msg: str) -> None:
    if msg.startswith("phase "):
        msg += f" (at {time.perf_counter() - _RUN_T0:.0f}s of the run)"
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


def busy_share(fn, split_copies: bool = False):
    """(wall s, device-busy s, top device ops, result) of one traced run of
    ``fn``: the card's idle share is 1 - busy / wall. With
    ``split_copies`` also (kernel s, memcpy and memset s)."""
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
    if split_copies:
        copies = sum(e.time_range.elapsed_us() for e in dev
                     if e.name.startswith(("Memcpy", "Memset"))) / 1e6
        return wall, busy, top, out, (busy - copies, copies)
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


#: the other block kinds' LM card-vs-CPU streams: (arch, seed) through the
#: engine, and through forward_prefill / serve_step for the stub fronts
LM_ENGINE_STREAMS = (("mixtral-8x7b", 23), ("recurrentgemma-9b", 24), ("rwkv6-7b", 25))
LM_FRONT_STREAMS = (("llava-next-mistral-7b", 26), ("musicgen-large", 27))
#: the LM card-vs-CPU streams: float answers (the page pool's K/V) within
#: this f32 tolerance (the CPU tests' summation-order tolerance); every
#: integer answer exact
LM_STREAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _lm_stream(arch: str, device, seed: int):
    """Two rounds of 4 requests (64 shared tokens + 36 fresh, 5 new tokens)
    through ``ServingEngine`` over the reduced ``arch`` in float32, weights
    drawn on the CPU from ``seed``: 16 pages, so the second round evicts.
    The 100-token cold prefill takes the window band with a ragged length
    and rolls the ring of h2o-danube-3-4b and mixtral-8x7b (window 64) and
    of recurrentgemma-9b's local layers, and rwkv6-7b's last, 36-token
    chunk. Every request's tokens and counts, every ``match_prefix`` and
    ``admit`` answer, the cache's host state, every page-pool field (float,
    within ``LM_STREAM_TOL``), then the stats."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServingEngine
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    eng = ServingEngine(cfg, init_params(cfg, seed, "cpu").to(device), cache_len=128,
                        num_pages=16, batch_size=4)
    out = []
    match, admit = eng.prefix.match_prefix, eng.prefix.admit

    def logged_match(tokens):
        pages, n = match(tokens)
        out.append(np.array(pages + [n], np.int64))
        return pages, n

    def logged_admit(tokens, first_new_block=0):
        pages = admit(tokens, first_new_block)
        out.append(np.array(pages, np.int64))
        return pages
    eng.prefix.match_prefix, eng.prefix.admit = logged_match, logged_admit
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, cfg.vocab_size, 64)
    for r in range(2):
        reqs = [Request(4 * r + i, np.concatenate([shared, rng.integers(1, cfg.vocab_size, 36)]),
                        max_new_tokens=5) for i in range(4)]
        eng.run(reqs)
        out += [np.array(q.generated + [q.cached_tokens, q.prefilled_tokens]) for q in reqs]
    c = eng.prefix
    out += [np.array(c.free, np.int64), np.array(sorted(c.lru.items()), np.int64).ravel()]
    out += [t.cpu().numpy() for leaves in eng.pool.storage.values() for t in leaves.values()]
    out.append(np.array(list(vars(c.stats).values()) + [eng.flops_saved_tokens]))
    return c.table, out


def _front_stream(arch: str, device, seed: int):
    """The stub fronts, which the engine refuses: ``forward_prefill`` of 2
    lanes (llava: 16 patch embeddings + 48 tokens; musicgen: 64 frame
    embeddings) and 3 ``serve_step``s of the reduced ``arch`` in float32,
    weights drawn on the CPU from ``seed``: every logit and the final state's
    leaves (float, within ``LM_STREAM_TOL``) and positions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward_prefill, init_params, serve_step
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    model = init_params(cfg, seed, "cpu").to(device)
    rng = np.random.default_rng(seed)

    def embeds(n):
        return torch.as_tensor(rng.normal(0, 1, (2, n, cfg.d_model)).astype(np.float32),
                               device=device)

    def tokens(*shape):
        return torch.as_tensor(rng.integers(1, cfg.vocab_size, shape).astype(np.int32),
                               device=device)
    if cfg.family == "audio":
        batch = {"frame_embeds": embeds(64)}
    else:
        batch = {"patch_embeds": embeds(cfg.num_patches),
                 "tokens": tokens(2, 64 - cfg.num_patches)}
    logits, st = forward_prefill(model, cfg, batch, 128)
    out = [logits.cpu().numpy()]
    for _ in range(3):
        inputs = ({"frame_embeds": embeds(1)} if cfg.family == "audio"
                  else {"token": tokens(2)})
        logits, st = serve_step(model, cfg, st, inputs)
        out.append(logits.cpu().numpy())
    out += [t.cpu().numpy() for k, leaves in st.items() if k != "pos" for t in leaves.values()]
    out.append(st["pos"].cpu().numpy())
    return None, out


#: the training card-vs-CPU streams: (arch, seed), one for each block kind and
#: the vlm front; and the launcher's stream. Their checkpoints go under
#: TRAIN_STREAM_DIR (git-ignored build/) and are removed after each stream
TRAIN_STREAMS = (("yi-6b", 28), ("h2o-danube-3-4b", 29), ("mixtral-8x7b", 30),
                 ("recurrentgemma-9b", 31), ("rwkv6-7b", 32), ("llava-next-mistral-7b", 33))
TRAIN_STREAM_DIR = Path(__file__).resolve().parent / "build" / "train_streams"


def _stream_dir(name: str, device) -> Path:
    d = TRAIN_STREAM_DIR / f"{name}-{'cpu' if str(device) == 'cpu' else 'card'}"
    shutil.rmtree(d, ignore_errors=True)
    return d


def _train_stream(arch: str, device, seed: int):
    """3 steps of the port's ``Trainer`` over the reduced ``arch`` in
    float32 from the same ``TrainState`` (weights drawn on the CPU from
    ``seed``, then moved), batches of 2 x 64 tokens (vlm: after its 16
    patches): every loss and grad norm, then the final commit's params,
    ``m``, ``v``, count and step (floats within ``LM_STREAM_TOL``)."""
    import dataclasses
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_iter
    from repro_torch.train.trainer import Trainer, TrainerConfig, init_state
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    d = _stream_dir(arch, device)
    t = Trainer(cfg, TrainerConfig(total_steps=3, checkpoint_every=100, checkpoint_dir=str(d),
                                   async_checkpoint=False),
                batch_iter(cfg, 2, 64, dedup=False), device=device,
                state=init_state(cfg, seed, "cpu"))
    log_ = t.run()["log"]
    out = [np.array([m["loss"] for m in log_]), np.array([m["grad_norm"] for m in log_])]
    out += list(interop.train_state_to_numpy(t.state).values())
    shutil.rmtree(d, ignore_errors=True)
    return None, out


def _train_launcher_stream(device, seed: int):
    """``python -m repro_torch.launch.train --dedup --resume`` (reduced
    yi-6b, 4 steps of 2 x 64 tokens, a commit every 2) through its
    ``main``, with the launcher's ``get_config`` giving the config in
    float32, resuming from a step-0 commit of weights drawn on the CPU from
    ``seed`` (the launcher draws its own on its device, and the card's
    generator is not the CPU's): every loss and grad norm, the commits'
    facts, and the final commit's tensors."""
    import contextlib
    import dataclasses
    import io
    from unittest import mock
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.train.trainer import init_state
    d = _stream_dir("launcher", device)
    cfg = dataclasses.replace(get_config("yi-6b", reduced=True), dtype="float32")
    CheckpointManager(str(d)).save(0, init_state(cfg, seed, "cpu"))
    with contextlib.redirect_stdout(io.StringIO()), \
            mock.patch.object(launcher, "get_config", lambda arch, reduced: cfg):
        res = launcher.main(["--steps", "4", "--batch", "2", "--seq", "64", "--dedup",
                             "--ckpt-every", "2", "--ckpt-dir", str(d), "--resume",
                             "--device", str(device)])
    mgr = CheckpointManager(str(d))
    manifest, lazy, _ = mgr.restore_manifest()
    out = [np.array([m["loss"] for m in res["log"]]),
           np.array([m["grad_norm"] for m in res["log"]]),
           np.array([res["final_step"], manifest["step"], int(manifest["clean"])])]
    out += [np.array(v.get()) for v in lazy.values()]
    shutil.rmtree(d, ignore_errors=True)
    return None, out


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


def _pool(name, dev) -> str:
    """Pool file of a card-vs-CPU stream: the card's run and the CPU's
    write apart."""
    return str(POOL_DIR / f"{name}-{'cpu' if dev == 'cpu' else 'card'}.pool")


def _stream_table():
    """(streams, durable): every card-vs-CPU stream as name -> run(dev) ->
    (table, answers), and the names of those that write a pool file."""
    from repro_torch.core import DashConfig
    from repro_torch.core.baselines import bucketized_config, cceh_config
    eh = DashConfig(max_segments=64, dir_depth_max=10, init_depth=3)
    lh = DashConfig(max_segments=256, num_stash=4)
    durable = {   # name: run(dev) -> (table, answers), pools at _pool(name, dev)
        "durable eh": lambda dev: _durable_stream(eh, "eh", dev, 12, _pool("durable eh", dev)),
        "durable lh": lambda dev: _durable_stream(lh, "lh", dev, 13, _pool("durable lh", dev)),
        "fault plan": lambda dev: _fault_stream(eh, dev, 14, _pool("fault plan", dev)),
        "chaos": lambda dev: _chaos_stream(dev, 1, _pool("chaos", dev)),
    }
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
        "lm yi-6b": lambda dev: _lm_stream("yi-6b", dev, 21),
        "lm h2o-danube-3-4b": lambda dev: _lm_stream("h2o-danube-3-4b", dev, 22),
        **{f"lm {arch}": (lambda dev, arch=arch, seed=seed: _lm_stream(arch, dev, seed))
           for arch, seed in LM_ENGINE_STREAMS},
        **{f"lm {arch}": (lambda dev, arch=arch, seed=seed: _front_stream(arch, dev, seed))
           for arch, seed in LM_FRONT_STREAMS},
        **{f"train {arch}": (lambda dev, arch=arch, seed=seed: _train_stream(arch, dev, seed))
           for arch, seed in TRAIN_STREAMS},
        "train launcher": lambda dev: _train_launcher_stream(dev, 34),
    }
    return streams, set(durable)


#: the CPU halves' child caps its threads, so the card's host work keeps cores
CPU_THREADS = 2
#: the CPU halves took ~47 s beside nothing; each child gets this long
HALVES_TIMEOUT = 600.0
HALVES = Path(__file__).resolve().parent / "build" / "halves"
#: card streams run by three more processes on the card, beside this one's
#: (their facts come from their answers and final planes, none from a table
#: object); the third came with the training streams, when this process's
#: halves took 78.8 s on a slow host (shrink 21.8 s, the two frontend
#: streams ~22 s) and the pointer group's 66 s came next
CARD_CHILD_GROUPS = (("durable eh", "durable lh", "fault plan", "chaos", "level",
                      "pessimistic", "prefix cache", "dedup"),
                     ("pointer", "eh", "lm yi-6b", "lm h2o-danube-3-4b",
                      *(f"lm {arch}" for arch, _ in LM_ENGINE_STREAMS)),
                     ("shrink", "frontend", "frontend routed reads", "lh"))


def _child_setup(threads: int) -> None:
    """A spawned child of this script: the checkout's ``src`` on its path,
    its threads capped."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(threads)


def _run_halves(names, device: str, path: str) -> None:
    """One side of the card-vs-CPU streams in a child process: every named
    stream's answers, final planes and seconds, pickled to ``path``; pool
    files land under ``_pool(name, device)``."""
    import pickle
    global DEVICE
    DEVICE = device if device.startswith("cpu") else "cuda"
    _child_setup(CPU_THREADS if device == "cpu" else 4)
    from repro_torch import interop
    streams, _ = _stream_table()
    out = {}
    for name in names:
        t0 = time.perf_counter()
        t, answers = streams[name](device)
        out[name] = (answers, None if t is None else interop.state_to_numpy(t.state),
                     time.perf_counter() - t0)
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _start_halves(names, device: str, tag: str):
    """Run ``_run_halves`` for ``names`` in a spawned child."""
    return _spawn_child(_run_halves, (tuple(names), device, str(HALVES / f"{tag}.pkl")),
                        f"{tag}-halves")


def start_cpu_halves():
    """Start the CPU halves' child at the beginning of the run (spawned:
    no CUDA state is shared)."""
    for d in (POOL_DIR, HALVES):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    streams, _ = _stream_table()
    return _start_halves(list(streams), "cpu", "cpu")


def _join(child, timeout: float, what: str) -> None:
    """Wait for a child; one that fails or outlives ``timeout`` fails the
    phase."""
    child.join(timeout)
    if child.is_alive():
        child.kill()
        child.join()
        raise PhaseError(f"{what}: the child outlived {timeout:.0f}s")
    check(child.exitcode == 0, f"{what}: the child exited with {child.exitcode}")


def _spawn_child(target, args, name: str):
    """Start ``target(*args)`` in a spawned child process of this script."""
    import multiprocessing
    child = multiprocessing.get_context("spawn").Process(target=target, args=args,
                                                          name=name)
    child.start()
    return child


def _killed_writer(path: str, acked, in_flight, device: str) -> None:
    """A writer process on the card killed inside a flush: reopen the pool,
    insert and flush ``acked`` (acknowledged), insert ``in_flight``, stamp
    its intent in the flight recorder and die inside that flush's
    ``pool.commit`` — after the data, log and recorder window, before the
    superblock advanced. Exits 0 only from inside the commit."""
    _child_setup(4)
    from repro_torch import persist
    from repro_torch.obs import FlightRecorder
    t, _ = persist.reopen(path, verify=False, device=device)
    rec = t.writeback.attach_recorder(FlightRecorder())
    for batch in (acked, in_flight):
        if not (t.insert(batch, _expected_values(batch)) == 0).all():
            os._exit(3)
        rec.record_ops("insert", batch, await_seq=t.writeback.pool.sb.flush_seq + 1)
        if batch is in_flight:
            t.writeback.pool.commit = lambda *a, **kw: os._exit(0)
        t.flush()
    os._exit(4)


class _Shadow:
    """What the checks read of a table another process ran: its segment
    count and planes."""

    def __init__(self, planes):
        self.state = type("Planes", (), planes)
        self.n_segments = int(planes["watermark"])


def phase_cuda_vs_cpu(cpu_child):
    """Every stream on the card — the ``CARD_CHILD_GROUPS`` in three more
    processes on the card started here, the rest in this one — while
    ``cpu_child`` (``start_cpu_halves``) runs all of them on the CPU; then
    answers, planes and pool bytes are compared."""
    import pickle
    from repro_torch import interop
    streams, durable = _stream_table()
    t0 = time.perf_counter()
    children = [_start_halves(group, DEVICE, f"card{i}")
                for i, group in enumerate(CARD_CHILD_GROUPS)]
    in_children = {name for group in CARD_CHILD_GROUPS for name in group}
    facts, seconds = {}, {}
    for name, run in streams.items():
        if name not in in_children:
            t1 = time.perf_counter()
            facts[name] = run(DEVICE)
            seconds[name] = time.perf_counter() - t1
    card_s = time.perf_counter() - t0
    for i, child in enumerate(children):
        _join(child, HALVES_TIMEOUT, f"card process {i}")
    _join(cpu_child, HALVES_TIMEOUT, "the CPU halves")
    wait_s = time.perf_counter() - t0 - card_s
    child_card, child_s = {}, []
    for i in range(len(children)):
        with open(HALVES / f"card{i}.pkl", "rb") as f:
            got = pickle.load(f)
        child_card.update(got)
        child_s.append(sum(v[2] for v in got.values()))
    with open(HALVES / "cpu.pkl", "rb") as f:
        cpu = pickle.load(f)
    for name, (answers, planes, secs) in child_card.items():
        facts[name] = (None if planes is None else _Shadow(planes), answers)
        seconds[name] = secs
    for name, (t_gpu, out_gpu) in facts.items():
        out_cpu, planes_cpu, _ = cpu[name]
        check(len(out_gpu) == len(out_cpu), f"{name}: answer counts differ")
        for i, (a, b) in enumerate(zip(out_gpu, out_cpu)):
            same = (a.shape == b.shape and np.allclose(a, b, **LM_STREAM_TOL)
                    if name.startswith(("lm ", "train ")) and a.dtype.kind == "f"
                    else np.array_equal(a, b))
            check(same, f"{name}: answer {i} differs between cuda and cpu")
        a = (child_card[name][1] if name in child_card
             else None if t_gpu is None else interop.state_to_numpy(t_gpu.state))
        if a is not None:
            bad = [k for k in a if a[k].tobytes() != planes_cpu[k].tobytes()]
            check(not bad, f"{name}: cuda and cpu states differ in {bad}")
        if name in durable and name != "chaos":
            with open(_pool(name, DEVICE), "rb") as f, open(_pool(name, "cpu"), "rb") as g:
                check(f.read() == g.read(), f"{name}: cuda and cpu pool files differ")
    shutil.rmtree(POOL_DIR, ignore_errors=True)
    slowest = sorted(seconds.items(), key=lambda kv: -kv[1])[:6]
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
    lm_facts = []
    for name in ["lm yi-6b", "lm h2o-danube-3-4b"] + [f"lm {a}" for a, _ in LM_ENGINE_STREAMS]:
        _, hits, _, _, evictions, saved = facts[name][1][-1]
        check(evictions > 0 and saved == 7 * 64, f"{name}: {evictions} evictions, "
              f"{saved} prefill tokens saved")
        lm_facts.append(f"{name[3:]} {hits} hit blocks, {evictions} evictions")
    for arch, _ in LM_FRONT_STREAMS:
        check(facts[f"lm {arch}"][1][-1].tolist() == [67, 67], f"lm {arch}: positions "
              f"{facts[f'lm {arch}'][1][-1]}")
        lm_facts.append(f"{arch} prefill + 3 steps")
    train_facts = []
    for name in [f"train {a}" for a, _ in TRAIN_STREAMS] + ["train launcher"]:
        losses = facts[name][1][0]
        check(np.isfinite(losses).all(), f"{name}: losses {losses}")
        gap = max(float(np.abs(a - b).max()) for a, b in zip(facts[name][1], cpu[name][0])
                  if a.dtype.kind == "f" and a.size)
        train_facts.append(f"{name[6:]} loss {losses[0]:.4f} -> {losses[-1]:.4f}, max gap "
                           f"{gap:.2e}")
    steps, committed, clean = facts["train launcher"][1][2]
    check(steps == 4 and committed == 4 and clean == 1,
          f"train launcher: {steps} steps, last commit {committed}, clean {clean}")
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
        f"({baseline_facts}); LM serving streams in float32 with equal tokens, pages "
        f"and prefix planes, the page pool within {LM_STREAM_TOL['atol']} "
        f"({'; '.join(lm_facts)}); training streams in float32 (3 Trainer steps from one "
        f"TrainState; the launcher 4 steps with --dedup), losses, grad norms and final "
        f"states within {LM_STREAM_TOL['atol']} ({'; '.join(train_facts)}) "
        f"({time.perf_counter() - t0:.1f}s: this process's card "
        f"halves {card_s:.1f}s, then {wait_s:.1f}s waiting on the other card processes ("
        + ", ".join(f"{x:.1f}s" for x in child_s) + ") and the CPU child (its streams "
        f"{sum(v[2] for v in cpu.values()):.1f}s, started with the run); slowest streams on "
        f"the card "
        + ", ".join(f"{k} {v:.1f}s" for k, v in slowest) + ")")


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
        with side_step():
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
    with side_step():
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
        with side_step():
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
        with side_step():
            ticks_trace = busy_share(traced_ticks)[:3]
        for what, (wall, busy, top) in (
                ("50 ticks", ticks_trace),
                (f"one load batch of {load_trace[3]} keys", load_trace[:3])):
            log(f"  trace {name} {what}: wall {wall * 1e3:.1f} ms, card busy {busy * 1e3:.1f} ms "
                f"(idle share {1 - busy / wall:.3f}); top: "
                + "; ".join(f"{k} {v:.2f} ms" for k, v in top))

    # ---- deletes and updates, then every answer against the ground truth ----
    n_mut = min(65536, n_keys // 4)
    pick = rng.permutation(n_keys)[:2 * n_mut]
    dele, upd = pick[:n_mut], pick[n_mut:]
    new_vals = vals[upd] ^ np.uint32(0x5A5A5A5A)
    with side_step():
        check((t.delete(keys[dele]) == 0).all(), "a delete missed")
        check((t.update(keys[upd], new_vals) == 0).all(), "an update missed")
    truth = vals.copy()
    truth[upd] = new_vals
    alive = np.ones(n_keys, bool)
    alive[dele] = False
    t0 = time.perf_counter()
    for a in range(0, n_keys, B):
        with side_step():
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

    # ---- the kill: the storm's table is closed and a child process on the
    # card reopens the pool, acknowledges one more batch and dies inside
    # the next flush's commit (os._exit: no destructor, no close) ----
    t.close()
    del f, t, wb, drv, ops
    gc.collect()
    acked, in_flight = distinct_keys(6 << 40, 256), distinct_keys(7 << 40, 256)
    t0 = time.perf_counter()
    child = _spawn_child(_killed_writer, (path, acked, in_flight, DEVICE), "killed-writer")
    _join(child, 300.0, "the writer killed inside a flush")
    kill_s = time.perf_counter() - t0
    rep = forensics.analyze_pool(path)
    in_flight_named = {int(k) for op in rep.get("in_flight_ops", ()) for k in op["keys"]}
    check(rep.get("ok") and rep["torn"]["present"]
          and in_flight_named == {int(k) for k in in_flight},
          f"forensics of the killed writer: torn {rep.get('torn')}, "
          f"{len(in_flight_named)} keys in flight of {in_flight.size}")
    keys = np.concatenate([keys, acked])
    vals = np.concatenate([vals, _expected_values(acked)])
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
    log(f"  durable [{card}]: a child process reopened the closed pool, acknowledged "
        f"{acked.size} more keys and died inside the next flush's commit ({kill_s:.1f}s); "
        f"forensics named its {in_flight.size} in-flight keys; reopen {reopen_s:.3f}s "
        f"without verify ({info2['seconds']:.3f}s inside), {verify_s:.3f}s with verify; "
        f"first 1M-key read {first_s:.3f}s, {first_segments} segments recovered; "
        f"{keys.size} acknowledged keys checked")

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
        with side_step():
            st = t.insert(keys[done:done + n], vals[done:done + n])
        check((st == 0).all(), "shrink load failed")
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
        with side_step():
            st = t.insert(fresh[a:a + (1 << 17)], vals[n_keys + a:n_keys + a + (1 << 17)])
        check((st == 0).all(), "a refill insert failed")
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
#: tables, cut from 2M by the run's time limit (see PREFIX_PROMPTS). Like
#: shrink's, its loads cost batches, not keys: Dash-EH's 0.25M keys took
#: 58.5 s on a host where 0.5M had taken 51.6 s on another
BASE_KEYS = 500_000
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
            with side_step():
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
#: admit ~4800 blocks into 4096 pages; 400 (the LM phase's cut) admit
#: ~2400 blocks, so the pool was cut to 2048 pages and eviction still runs.
PREFIX_PROMPTS = 400
PREFIX_PAGES = 2048
#: batches of the dedup stream (the example's 30, halved by the time limit)
DEDUP_BATCHES = 15
#: past the run's budget (see RUN_BUDGET_S) the apps are halved: 200
#: prompts (~1550 blocks) into 1024 pages, 8 dedup batches. Together they
#: took 32.7 s (prefix 22.2 s, dedup 7.4 s, halved) and 57.4 s to 60.1 s
#: (whole) on NVIDIA H100 80GB HBM3, 700.00 W
APPS_CUT = (200, 1024, 8)
APPS_CUT_SAVES_S = 25.0


def _prefix_cache_app(card: str, n_prompts: int = PREFIX_PROMPTS,
                      n_pages: int = PREFIX_PAGES):
    """DashPrefixCache(num_pages=n_pages) over prompts of 256 tokens: a
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
        with side_step():
            s = time.perf_counter()
            _, n = cache.match_prefix(tokens)
            match_s += time.perf_counter() - s
            cache.admit(tokens, n // BLOCK)
            again = cache.match_prefix(tokens)[1] if i % 50 == 49 else 256
        check(again == 256, f"prompt {i}: not cached after admit")
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


def _dedup_app(card: str, n_batches: int = DEDUP_BATCHES):
    """The dedup stream of examples/dedup_pipeline.py: ``n_batches``
    batches of 8 x 512 tokens, 25 % synthetic duplicates, through
    DedupFilter's Dash-LH."""
    from repro_torch.data import DedupFilter, PackedBatcher, PipelineConfig
    pc = PipelineConfig(vocab_size=32000, seq_len=512, batch_size=8, dup_fraction=0.25,
                        doc_len_min=32, doc_len_max=96)
    d = DedupFilter(device=DEVICE)
    b = PackedBatcher(pc, dedup=d)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        with side_step():
            b.next_batch()
    s = time.perf_counter() - t0
    check(b.docs_skipped > 0 and d.unique_docs == b.docs_seen - b.docs_skipped,
          f"dedup: {b.docs_seen} seen, {b.docs_skipped} skipped, {d.unique_docs} unique")
    out = dict(seen=b.docs_seen, skipped=b.docs_skipped, doc_us=s / b.docs_seen * 1e6)
    log(f"  baselines dedup [{card}]: {n_batches} batches of 8 x 512 tokens, {b.docs_seen} "
        f"docs seen, "
        f"{b.docs_skipped} skipped, {d.unique_docs} unique in {d.table.n_segments} LH "
        f"segments; {out['doc_us']:.1f} us per document (host clock), {s:.1f}s")
    return out


def phase_baselines(report, card: str, n_keys: int = BASE_KEYS, cut_apps: bool = False):
    """The paper's baselines beside Dash on one card, and the Dash apps.

    ``level_scan`` is held exactly to its plain version (the 3000-key
    stream's batches, a padded batch, a move); then one load of ``n_keys``
    unique uniform keys goes into Dash-EH, CCEH, Bucketized (each 32768
    segments at most) and level hashing (``max_log2=20``), with the launch
    counters set to 0 just before and read just after: insert rates, the
    load-factor curve (after every 1/16), final load factors, up to 1M
    positive and 1M negative searches, every key found with its value and no absent
    key found. Then both read kernels on the Bucketized planes, Fig. 13's
    pair, ``level_scan`` at the load's batch shape on the full table, the
    prefix cache and the dedup stream (at ``APPS_CUT``'s sizes with
    ``cut_apps``)."""
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
        with side_step():
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

    # ---- under the card's lock: both read kernels on the Bucketized planes, ----
    # ---- Fig. 13, level_scan at the load's batch shape on the loaded table ----
    with quiet_card():
        _bucketized_kernels(tables.pop("Bucketized"), keys, misses, report, card)
        opt_ms, pess_ms = _fig13(tables.pop("Dash-EH"), keys, misses, card)

        t = tables.pop("level hashing")
        fresh = np.concatenate([distinct_keys(9 << 40, LEVEL_BATCH - 64), keys[:64]])
        hi, lo = hashing.split_keys(fresh, DEVICE)
        vv = torch.from_numpy(vals[:LEVEL_BATCH].view(np.int32)).to(DEVICE)
        valid = torch.ones(LEVEL_BATCH, dtype=torch.bool, device=DEVICE)
        err, st, plain_s = _level_scan_exact(t.cfg, t.state, hi, lo, vv, valid)
        counts = np.bincount(st.cpu().numpy(), minlength=5)
        check(err == 0 and counts[1] == 64,
              f"level_scan at full size: err {err}, statuses {counts}")
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
        log(f"  baselines [{card}]: level_scan exact at the load's shape ({LEVEL_BATCH} keys "
            f"into the loaded table: {counts[0]} inserted, {counts[1]} exist, {counts[2]} need "
            f"a rehash); "
            f"{ms * 1e3:.1f} us on the card ({ms / LEVEL_BATCH * 1e6:.1f} ns a key), plain "
            f"{plain_s * 1e3:.1f} ms; bound {chain_ms * 1e3:.1f} us by its chain of {levels} "
            f"dependent loads x {load_ns:.1f} ns (byte bound {by_bytes[0] * 1e3:.3f} us)")
    del t, base, work

    # ---- the apps ----
    prompts, pages, batches = APPS_CUT if cut_apps else (PREFIX_PROMPTS, PREFIX_PAGES,
                                                         DEDUP_BATCHES)
    pc = _prefix_cache_app(card, prompts, pages)
    dd = _dedup_app(card, batches)
    secs = time.perf_counter() - t_phase
    log(f"phase baselines: ok launches {launches} ({secs:.1f}s) [{card}]")
    return dict(rows=rows, fig13=(opt_ms, pess_ms), prefix=pc, dedup=dd, seconds=secs)


#: phase 12, LM serving at full width: the model, the engine's geometry and
#: the traffic (rounds of 4 requests: a shared system prompt + fresh tokens)
LM_ARCH = "yi-6b"
LM_CACHE_LEN, LM_PAGES, LM_BATCH = 1024, 1024, 4
LM_SHARED, LM_FRESH, LM_NEW, LM_ROUNDS = 512, 128, 32, 3
#: phase 12b, the other block kinds at full width, served like yi-6b in
#: LM_KIND_ROUNDS rounds: (arch, layers kept or None for all, pages).
#: rwkv6-7b's page holds a 34.1 MB state snapshot (1024 pages would be 34.9
#: GB; 8 requests admit 96); mixtral-8x7b's 46.7B bf16 weights (93.4 GB) do
#: not fit one 80 GB card, so it keeps 16 of its 32 layers at full width
LM_KINDS = (("recurrentgemma-9b", None, 1024), ("rwkv6-7b", None, 128),
            ("mixtral-8x7b", 16, 1024))
LM_KIND_ROUNDS = 2
#: phases 12 and 12b together, measured on NVIDIA H100 80GB HBM3, 700.00 W
#: (12.1 + 16.1 + 11.8 + 9.5 s): past the run's budget yi-6b loses a round
LM_PHASES_S = 50.0
#: mixtral's decode-vs-prefill check runs in f32 on this many of its layers:
#: in bf16 the two paths round differently and flip near-tied top-2 routes
LM_F32_LAYERS = 2
#: decode agrees with prefill at this many tokens
LM_DP_TOKENS = 64
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate (data sheet)


def _timed(fn, times, after=None):
    """``fn`` with each call's wall time (the card synced around it) added
    to ``times``; ``after(result)`` sees every result."""
    def call(*a, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        times.append(time.perf_counter() - t0)
        if after is not None:
            after(out)
        return out
    return call


def leaf_count(cfg) -> int:
    """Weights of a model by the shapes the reference's ``init_params``
    gives each kind's leaves (``param_count()`` is not this count: it gives
    rwkv a 3-matrix channel mix where the block holds 2, and leaves out
    RG-LRU's conv and lam and every norm)."""
    d, ff, hd, H, G = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    r = cfg.d_rnn or d
    attn = d * H * hd * 2 + d * G * hd * 2
    per = {"dense": attn + 3 * d * ff, "local": attn + 3 * d * ff,
           "moe": attn + d * cfg.n_experts + 3 * cfg.n_experts * d * ff,
           "rglru": 3 * d * r + cfg.conv_width * r + 2 * r * r + r + 3 * d * ff,
           "rwkv": 6 * d * d + 4 * d + 2 * d * ff}
    kinds = list(cfg.pattern) * cfg.n_blocks + list(cfg.tail)
    total = sum(per[k] + 2 * d for k in kinds)                    # + the block's norms
    embed = 0 if cfg.family == "audio" else cfg.vocab_size * d
    return total + embed + d * cfg.vocab_size + d


def _matmul_weights(model, cfg) -> float:
    """Weights a token multiplies in a forward pass: every matrix but the
    embedding table (a gather), the MoE expert stacks at top_k of n_experts."""
    total = 0.0
    for name, p in model.named_parameters():
        if p.dim() < 2 or name.startswith("embed."):
            continue
        expert = ".moe.w_" in name
        total += p.numel() * (cfg.top_k / cfg.n_experts if expert else 1.0)
    return total


def _step_weight_bytes(model, cfg) -> float:
    """Weight bytes one decode step reads: all but the embedding table (a
    step gathers 4 rows of it); of each MoE layer's experts only those its
    last call (the traced step) routed a lane to."""
    total = 0.0
    for name, p in model.named_parameters():
        if name.startswith("embed."):
            continue
        total += p.numel() * p.element_size()
    for _, _, blk in model.layers():
        moe = getattr(blk, "moe", None)
        if moe is not None and moe.routed is not None:
            unused = cfg.n_experts - int(torch.unique(moe.routed).numel())
            total -= unused * sum(w[0].numel() * w.element_size()
                                  for w in (moe.w_gate, moe.w_up, moe.w_down))
    return total


def _decode_vs_prefill(model, cfg, toks):
    """(max abs error, largest share of the tolerance used) of prefill
    logits at the last of ``toks`` against the logits after feeding them
    one by one; fails the phase outside the reference's tolerance (rtol
    0.12, atol 0.6) or on another argmax."""
    from repro_torch.models import decode_state_init, forward_prefill, serve_step
    plog, _ = forward_prefill(model, cfg, {"tokens": toks}, LM_CACHE_LEN)
    st = decode_state_init(cfg, 1, LM_CACHE_LEN, DEVICE)
    for t in range(toks.shape[1]):
        dlog, st = serve_step(model, cfg, st, {"token": toks[:, t]})
    a, b = dlog[0].float().cpu().numpy(), plog[0, -1].cpu().numpy()
    err = float(np.abs(a - b).max())
    share = float((np.abs(a - b) / (0.6 + 0.12 * np.abs(b))).max())
    check(np.isfinite(a).all() and np.allclose(a, b, rtol=0.12, atol=0.6),
          f"{cfg.name}: decode and prefill logits differ by up to {err}")
    check(int(a.argmax()) == int(b.argmax()),
          f"{cfg.name}: decode argmax {int(a.argmax())} != prefill argmax {int(b.argmax())}")
    return err, share


def phase_lm(report, card: str, arch: str = LM_ARCH, rounds: int = LM_ROUNDS,
             n_layers=None, pages: int = LM_PAGES):
    """The LM serving path at full width: ``arch`` at its published widths
    (and depth, unless ``n_layers`` keeps fewer layers), random weights
    drawn on the card from seed 0, served by ``ServingEngine`` (the Dash
    prefix cache as the KV-page directory, ``pages`` pages): ``rounds``
    rounds of ``LM_BATCH`` requests, each a shared ``LM_SHARED``-token
    system prompt plus ``LM_FRESH`` fresh tokens, decoding ``LM_NEW``
    tokens. The launch counters are set to 0 just before the rounds and
    read just after. Checks: every request after the first reuses the whole
    system prompt and prefills only its own tokens, no logit is
    non-finite, the prefix table's ``n_items`` equals its recount, the
    weight count is the model's own leaves' (``leaf_count``), and decode
    agrees with prefill at ``LM_DP_TOKENS`` tokens (the reference's
    tolerance, rtol 0.12 atol 0.6, and the same argmax): in bf16 at full
    width, for MoE in f32 on ``LM_F32_LAYERS`` layers. Then prefill and
    decode-step times against their bounds and the busy share of one traced
    decode step (4 lanes after a batched prefill of the last round's
    prompts) and one traced suffix prefill. The model is freed before the
    phase returns."""
    import dataclasses
    import gc
    from repro_torch.core import engine as dash_engine
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.models import forward_prefill, init_params, serve_step
    from repro_torch.serving import Request, ServingEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    path = "lm" if arch == LM_ARCH else f"lm {arch}"
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0, device=DEVICE)
    n_weights = sum(p.numel() for p in model.parameters())
    check(n_weights == leaf_count(cfg), f"{arch}: {n_weights} weights for the leaves' "
          f"{leaf_count(cfg)}")
    if set(cfg.pattern) == {"dense"}:
        check(n_weights == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model,
              f"{n_weights} weights for {cfg.param_count()} (+ the norms')")
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServingEngine(cfg, model, cache_len=LM_CACHE_LEN, num_pages=pages,
                        batch_size=LM_BATCH)
    pool_bytes = sum(t.numel() * t.element_size() for st in eng.pool.storage.values()
                     for t in st.values())
    sync()
    init_s = time.perf_counter() - t_phase

    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)

    def count_bad(out):
        bad.add_((~torch.isfinite(out[0])).sum())
    step_s, prefill_s, match_s, admit_s = [], [], [], []
    eng._decode = _timed(eng._decode, step_s, count_bad)
    eng._prefill = _timed(eng._prefill, prefill_s, count_bad)
    eng.prefix.match_prefix = _timed(eng.prefix.match_prefix, match_s)
    eng.prefix.admit = _timed(eng.prefix.admit, admit_s)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, LM_SHARED)
    done = []
    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    for r in range(rounds):
        reqs = [Request(LM_BATCH * r + i,
                        np.concatenate([shared, rng.integers(1, cfg.vocab_size, LM_FRESH)]),
                        max_new_tokens=LM_NEW) for i in range(LM_BATCH)]
        done += eng.run(reqs)
    sync()
    serve_s = time.perf_counter() - t0
    launches = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                "fused_probe": fused.LAUNCHES}
    for kernel in ("bulk_hash", "fused_probe"):
        check(launches[kernel] > 0 or DEVICE != "cuda",
              f"{kernel} was not launched on the {path} path")
    for kernel, count in launches.items():
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})[path] = count
        r["launches"] = sum(r["paths"].values())
    counts = [(q.cached_tokens, q.prefilled_tokens) for q in done]
    check(counts == [(0, LM_SHARED + LM_FRESH)] + [(LM_SHARED, LM_FRESH)] * (len(done) - 1),
          f"{arch}: cached/prefilled tokens {counts}")
    check(all(len(q.generated) == LM_NEW for q in done), f"{arch}: a request was cut short")
    check(int(bad) == 0, f"{arch}: {int(bad)} non-finite logits")
    table = eng.prefix.table
    recount = int(dash_engine.recount_items(table.state))
    check(table.n_items == recount, f"{arch}: prefix table n_items {table.n_items} recount "
          f"{recount}")

    # ---- decode agrees with prefill at full width (MoE: f32, see below) ----
    dp_toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, LM_DP_TOKENS))
                              .astype(np.int32), device=DEVICE)
    dp = None if "moe" in cfg.pattern else _decode_vs_prefill(model, cfg, dp_toks)

    # ---- times against their bounds ----
    cold = torch.as_tensor(done[0].prompt.astype(np.int32), device=DEVICE)[None]
    suffix = cold[:, LM_SHARED:]
    cold_ms = time_ms(lambda: forward_prefill(model, cfg, {"tokens": cold}, LM_CACHE_LEN),
                      reps=5)
    suffix_ms = time_ms(lambda: forward_prefill(model, cfg, {"tokens": suffix},
                                                LM_CACHE_LEN), reps=10)
    mm = _matmul_weights(model, cfg)
    flop_bound = [2 * mm * n / BF16_OPS_PER_S * 1e3 for n in (cold.shape[1], suffix.shape[1])]
    # a step of 4 lanes after a batched prefill of the last round's prompts
    prompts = torch.as_tensor(np.stack([q.prompt for q in done[-LM_BATCH:]]).astype(np.int32),
                              device=DEVICE)
    logits, st = forward_prefill(model, cfg, {"tokens": prompts}, LM_CACHE_LEN)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits
    state_bytes = sum(t.numel() * t.element_size() for k, leaves in st.items() if k != "pos"
                      for t in leaves.values())
    rec_bytes = sum(t.numel() * t.element_size() for k, leaves in st.items() if k != "pos"
                    for f, t in leaves.items() if f not in ("k", "v"))
    serve_step(model, cfg, st, {"token": tok})
    out = {}
    if DEVICE == "cuda":
        wall, busy, top, _ = busy_share(lambda: serve_step(model, cfg, st, {"token": tok}))
        out["decode_trace"] = (wall, busy, top)
    else:
        serve_step(model, cfg, st, {"token": tok})
    # the traced step's bytes: the weights it read (MoE: the experts its
    # lanes routed to), the state read, the recurrent state written
    step_w_bytes = _step_weight_bytes(model, cfg)
    byte_bound = (step_w_bytes + state_bytes + rec_bytes) / HBM_BYTES_PER_S * 1e3
    del st
    if DEVICE == "cuda":
        pwall, pbusy, ptop, _ = busy_share(
            lambda: forward_prefill(model, cfg, {"tokens": suffix}, LM_CACHE_LEN))
        out["prefill_trace"] = (pwall, pbusy, ptop)
    steps_ms = np.array(step_s) * 1e3
    out.update(arch=arch, name=cfg.name, layers=cfg.n_layers, rounds=rounds, pages=pages,
               weights=n_weights, w_gb=w_bytes / 1e9, pool_gb=pool_bytes / 1e9,
               state_gb=state_bytes / 1e9, step_w_gb=step_w_bytes / 1e9,
               init_s=init_s, serve_s=serve_s, cold_ms=cold_ms, suffix_ms=suffix_ms,
               flop_bound=flop_bound, step_p50=float(np.percentile(steps_ms, 50)),
               step_p99=float(np.percentile(steps_ms, 99)), steps=len(step_s),
               byte_bound=byte_bound, hit_rate=eng.prefix.stats.hit_rate,
               match_us=float(np.mean(match_s)) * 1e6, admit_ms=float(np.mean(admit_s)) * 1e3,
               engine_prefill_ms=[float(x) * 1e3 for x in prefill_s],
               launches=launches, saved=eng.flops_saved_tokens, requests=len(done))
    out["tok_s"] = LM_BATCH / (out["step_p50"] / 1e3)
    del model, eng, done
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    if dp is None:
        # MoE: decode vs prefill in f32 on LM_F32_LAYERS layers at full width
        small = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS, dtype="float32")
        model = init_params(small, seed=1, device=DEVICE)
        dp = _decode_vs_prefill(model, small, dp_toks)
        del model
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    out["dp_err"], out["dp_share"] = dp
    dp_what = (f"f32 on {LM_F32_LAYERS} layers" if "moe" in cfg.pattern
               else f"{cfg.dtype} at full width")
    cut = f" (cut to {cfg.n_layers} layers)" if n_layers is not None else ""
    log(f"  {path} [{card}]: {cfg.name}{cut} {n_weights} weights ({out['w_gb']:.2f} GB), pool "
        f"{out['pool_gb']:.2f} GB ({pages} pages), decode state {out['state_gb']:.3f} GB; "
        f"made in {init_s:.1f}s; {out['requests']} requests in {serve_s:.2f}s, hit rate "
        f"{out['hit_rate']:.4f}, {out['saved']} prefill tokens saved; decode vs prefill at "
        f"{LM_DP_TOKENS} tokens ({dp_what}) max abs {dp[0]:.4f} ({dp[1]:.3f} of the "
        f"tolerance), same argmax")
    if DEVICE == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        (wall, busy, top), (pwall, pbusy, ptop) = out["decode_trace"], out["prefill_trace"]
        log(f"  trace {path} [{card}] one decode step of {LM_BATCH} lanes: wall "
            f"{wall * 1e3:.2f} ms, card busy {busy * 1e3:.2f} ms (busy share "
            f"{busy / wall:.3f}); top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
        log(f"  trace {path} [{card}] one {suffix.shape[1]}-token suffix prefill: wall "
            f"{pwall * 1e3:.2f} ms, card busy {pbusy * 1e3:.2f} ms (busy share "
            f"{pbusy / pwall:.3f}); top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in ptop))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase {path}: ok launches {launches} ({out['seconds']:.1f}s) [{card}]")
    return out


def lm_line(lm, card: str) -> str:
    """The end-to-end line of one LM serving phase."""
    pt, dt_ = lm["prefill_trace"], lm["decode_trace"]
    cut = f", {lm['layers']} layers" if lm["arch"] == "mixtral-8x7b" else ""
    return (f"end to end {'lm' if lm['arch'] == LM_ARCH else 'lm ' + lm['arch']} [{card}]: "
            f"{lm['arch']} at full width{cut} ({lm['weights']} weights, {lm['w_gb']:.2f} GB; "
            f"pool {lm['pool_gb']:.2f} GB; decode state {lm['state_gb']:.3f} GB; peak HBM "
            f"{lm['peak_gb']:.2f} GB): {lm['requests']} requests in {lm['rounds']} rounds; "
            f"prefill cold {LM_SHARED + LM_FRESH} tokens {lm['cold_ms']:.2f} ms (FLOP bound "
            f"{lm['flop_bound'][0]:.2f} ms), {LM_FRESH}-token suffix after a hit "
            f"{lm['suffix_ms']:.2f} ms (bound {lm['flop_bound'][1]:.2f} ms); decode step p50 "
            f"{lm['step_p50']:.2f} ms p99 {lm['step_p99']:.2f} ms over {lm['steps']} steps of "
            f"{LM_BATCH} lanes, {lm['tok_s']:.1f} tokens/s (byte bound {lm['byte_bound']:.2f} "
            f"ms: {lm['step_w_gb']:.2f} GB of weights read + the state); hit rate "
            f"{lm['hit_rate']:.4f}, {lm['match_us']:.1f} us per match_prefix, "
            f"{lm['admit_ms']:.2f} ms per admit; busy share decode step {dt_[1] / dt_[0]:.3f}, "
            f"suffix prefill {pt[1] / pt[0]:.3f}; phase {lm['seconds']:.0f}s")


#: phase 13: training at yi-6b's published widths on TRAIN_LAYERS of its 32
#: layers (1.216B weights at 4: 173.0M a layer + 524.3M of embedding and
#: head; at ~16 B a weight on the card the 32 layers' 6.06B would need ~97
#: GB, and each f32 commit is 12 B a weight on disk: 14.6 GB at 4 layers,
#: 73 GB at 32). The launcher's batch (TRAIN_BATCH x TRAIN_SEQ tokens,
#: --dedup), TRAIN_STEPS steps, a commit every TRAIN_EVERY steps, one
#: injected fault at step TRAIN_FAULT; TRAIN_KEEP commits kept
TRAIN_ARCH, TRAIN_LAYERS = "yi-6b", 4
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAULT, TRAIN_KEEP = 8, 4, 5, 1
#: steps traced for the busy share, after the run
TRAIN_TRACE_STEPS = 2
#: after the run the dedup stage screens the launcher's stream on to this
#: document (the batches the trainer would take next): the run's 8 steps
#: see ~14 documents, and the stream aliases a document past the 10th with
#: probability 0.05, so ~12 of these are aliased
TRAIN_DEDUP_DOCS = 256
#: the phase's share of the run's budget (40.5 and 41.3 s in two runs on
#: NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_PHASE_S = 45.0
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train"


def _same_as_commit(state, ckpt) -> int:
    """Bytes of ``state`` checked equal to the latest commit of ``ckpt``,
    tensor by tensor (each file copied to the state's device and compared
    there); fails the phase on the first difference. The files' maps are
    dropped before it returns."""
    import warnings
    from repro_torch.checkpoint.manager import flatten
    _, lazy, _ = ckpt.restore_manifest()
    flat, n = flatten(state), 0
    check(set(flat) == set(lazy), f"train: the commit holds {len(lazy)} tensors for "
          f"{len(flat)}")
    for key, t in flat.items():
        with warnings.catch_warnings():          # a read-only map, only read
            warnings.simplefilter("ignore", UserWarning)
            src = torch.from_numpy(lazy[key].get()).to(t.device)
        check(torch.equal(t, src), f"train: {key} differs from the commit after the restore")
        n += src.numel() * src.element_size()
    return n


def phase_train(report, card: str, n_layers: int = TRAIN_LAYERS, steps: int = TRAIN_STEPS):
    """Training at full width: ``TRAIN_ARCH`` at its published widths on
    ``n_layers`` layers, weights drawn from seed 0 (f32 masters), through
    the launcher's batches with the Dash-LH dedup stage on the card and the
    fault-tolerant ``Trainer``: ``steps`` steps, an async commit every
    ``TRAIN_EVERY``, one fault injected at step ``TRAIN_FAULT`` (restored
    from the last commit), the final clean commit; then the dedup stage
    screens the stream on to ``TRAIN_DEDUP_DOCS`` documents. The launch
    counters are set to 0 just before the run and read just after the
    screening. Checks: every loss finite, the last below the first, the
    restart restored the commit's step, every restored tensor equals the
    commit's bytes (read by the fault hook at the first step after the
    restart, whose logged time leaves the check out), some documents were
    aliased and the dedup stage skipped every one, its table's ``n_items``
    equals the recount. Prints peak HBM, the step p50 against the FLOP bound
    (6 x the matrices a token multiplies x tokens) and AdamW's byte bound
    (28 B a weight), the busy share of ``TRAIN_TRACE_STEPS`` traced steps,
    each save's and the restore's seconds and GB, and the disk. The
    checkpoint directory is removed at the end."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import engine as dash_engine
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.launch.train import batch_iter, make_batcher
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=n_layers)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    disk0 = shutil.disk_usage(TRAIN_DIR)
    commit_gb = 12 * leaf_count(cfg) / 1e9
    check(disk0.free / 1e9 > 2.2 * commit_gb, f"train: {disk0.free / 1e9:.1f} GB free under "
          f"{TRAIN_DIR} for two {commit_gb:.1f} GB commits")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    batcher = make_batcher(cfg, TRAIN_BATCH, TRAIN_SEQ, dedup=True, device=DEVICE)
    record = {"batches": [], "samples": None}

    def recorded(batches):
        """The launcher's batches, the first ``MESH_STEPS`` kept on the host
        for the mesh phase."""
        for b in batches:
            if len(record["batches"]) < MESH_STEPS:
                record["batches"].append({k: (v.cpu().numpy() if torch.is_tensor(v)
                                              else np.array(v)) for k, v in b.items()})
            yield b
    it = recorded(batch_iter(cfg, TRAIN_BATCH, TRAIN_SEQ, True, DEVICE, batcher))
    fired, verified = [], {}

    def fault(step):
        """The injected fault, then at the first step after the restart
        (the state is the restored commit) the check against its files.
        Before step ``MESH_STEPS`` it keeps the mesh phase's samples."""
        if step == MESH_STEPS and record["samples"] is None:
            record["samples"] = {k: v.detach().cpu().numpy().copy()
                                 for k, v in _mesh_samples(trainer.state.params).items()}
        if step == TRAIN_FAULT and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")
        if fired and not verified:
            t0 = time.perf_counter()
            verified.update(step=step, bytes=_same_as_commit(trainer.state, trainer.ckpt))
            verified["seconds"] = time.perf_counter() - t0
    tcfg = TrainerConfig(total_steps=steps, checkpoint_every=TRAIN_EVERY,
                         checkpoint_dir=str(TRAIN_DIR), keep_checkpoints=TRAIN_KEEP)
    trainer = Trainer(cfg, tcfg, it, fault_hook=fault, seed=0, device=DEVICE)
    n_weights = sum(t.numel() for t in leaves(trainer.state.params))
    check(n_weights == leaf_count(cfg), f"train: {n_weights} weights for the leaves' "
          f"{leaf_count(cfg)}")
    sync()
    init_s = time.perf_counter() - t_phase

    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    res = trainer.run()
    sync()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    while batcher.docs_seen < TRAIN_DEDUP_DOCS:
        next(it)
    sync()
    screen_s = time.perf_counter() - t0
    launches = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                "fused_probe": fused.LAUNCHES}
    check(launches["bulk_hash"] > 0 or DEVICE != "cuda", "bulk_hash was not launched on the "
          "train path")
    for kernel, count in launches.items():
        r = report.setdefault(kernel, {})
        r.setdefault("paths", {})["train"] = count
        r["launches"] = sum(r["paths"].values())

    events = [m for m in res["log"] if m.get("event") == "restart"]
    log_ = [m for m in res["log"] if "loss" in m]
    losses = [m["loss"] for m in log_]
    check(all(np.isfinite(losses)), f"train: losses {losses}")
    check(losses[-1] < losses[0], f"train: the last loss {losses[-1]} is not below the first "
          f"{losses[0]}")
    check(res["final_step"] == steps and len(events) == 1
          and events[0]["restored_step"] == TRAIN_EVERY * (TRAIN_FAULT // TRAIN_EVERY),
          f"train: final step {res['final_step']}, restarts {events}")
    check(verified.get("step") == events[0]["restored_step"] and verified["bytes"] > 0,
          f"train: the restore was not checked ({verified})")
    saves = trainer.ckpt.saves
    check([s["step"] for s in saves] == [TRAIN_EVERY * k for k in range(1, steps // TRAIN_EVERY + 1)]
          + [steps], f"train: saves at {[s['step'] for s in saves]}")
    corpus = batcher.corpus
    aliased = sum(corpus._dedup_index(i) != i for i in range(batcher.cursor))
    table = batcher.dedup.table
    recount = int(dash_engine.recount_items(table.state))
    check(aliased > 0 and batcher.docs_skipped == aliased and table.n_items == recount
          and table.n_items == batcher.docs_seen - batcher.docs_skipped,
          f"train: {batcher.docs_seen} docs seen, {batcher.docs_skipped} skipped for {aliased} "
          f"aliased; n_items {table.n_items}, recount {recount}")

    # ---- the busy share of traced steps, after the run ----
    out = {}
    batch = {k: torch.as_tensor(np.asarray(v), device=DEVICE) for k, v in next(it).items()}
    trainer.step_fn(trainer.state, batch)

    def traced():
        for _ in range(TRAIN_TRACE_STEPS):
            _, m = trainer.step_fn(trainer.state, batch)
        return float(m["loss"])
    if DEVICE == "cuda":
        out["trace"] = busy_share(traced)[:3]
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the first step after the restart ran the restore's check in its hook
    after = res["log"].index(events[0]) + 1
    step_ms = np.array([m["seconds"] - (verified["seconds"] if i == after else 0.0)
                        for i, m in enumerate(res["log"]) if "loss" in m]) * 1e3
    mm = _matmul_weights(Transformer(cfg, "meta"), cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    disk1 = shutil.disk_usage(TRAIN_DIR)
    out.update(arch=TRAIN_ARCH, layers=n_layers, weights=n_weights, init_s=init_s, run_s=run_s,
               losses=losses, steps=len(log_), step_ms=step_ms.tolist(),
               step_p50=float(np.percentile(step_ms, 50)),
               step_max=float(step_ms.max()), flop_bound=6 * mm * tokens / BF16_OPS_PER_S * 1e3,
               adamw_bound=28 * n_weights / HBM_BYTES_PER_S * 1e3, saves=saves,
               event=events[0], restore=dict(trainer.ckpt.last_restore), verified=verified,
               seen=batcher.docs_seen, skipped=batcher.docs_skipped, aliased=aliased,
               screen_s=screen_s, launches=launches,
               disk_free_gb=(disk0.free / 1e9, disk1.free / 1e9), commit_gb=commit_gb)
    record["losses"] = losses[:MESH_STEPS]
    check(record["samples"] is not None and len(record["batches"]) == MESH_STEPS,
          "train: the mesh phase's record is incomplete")
    out["mesh_record"] = record
    del trainer, res, batch
    gc.collect()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase train: ok launches {launches} ({out['seconds']:.1f}s) [{card}]")
    return out


def train_line(tr, card: str) -> str:
    """The end-to-end line of the training phase."""
    saves = "; ".join(f"step {s['step']} {s['bytes'] / 1e9:.2f} GB: host copy "
                      f"{s['copy_s']:.2f}s, write {s.get('write_s', float('nan')):.2f}s"
                      for s in tr["saves"])
    ev, rs = tr["event"], tr["restore"]
    trace = (f"; busy share {tr['trace'][1] / tr['trace'][0]:.3f} over {TRAIN_TRACE_STEPS} "
             f"traced steps ({tr['trace'][0] * 1e3:.1f} ms wall; top: "
             + "; ".join(f"{k} {v:.2f} ms" for k, v in tr["trace"][2]) + ")"
             if "trace" in tr else "")
    peak = f"peak HBM {tr['peak_gb']:.2f} GB; " if "peak_gb" in tr else ""
    return (f"end to end train [{card}]: {tr['arch']} at full width on {tr['layers']} of its 32 "
            f"layers (cut: 32 layers need ~97 GB at 16 B a weight) ({tr['weights']} weights; "
            f"{peak}{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, --dedup): {tr['steps']} steps "
            f"logged, step p50 {tr['step_p50']:.2f} ms (max {tr['step_max']:.2f}) against a "
            f"FLOP bound of {tr['flop_bound']:.2f} ms and AdamW's byte bound of "
            f"{tr['adamw_bound']:.2f} ms{trace}; steps ms "
            f"[{', '.join(f'{x:.1f}' for x in tr['step_ms'])}]; loss {tr['losses'][0]:.4f} -> "
            f"{tr['losses'][-1]:.4f}; saves: {saves}; fault at step {ev['step']} restored step "
            f"{ev['restored_step']}: manifest {ev['manifest_restore_s'] * 1e3:.2f} ms, tensors "
            f"{rs['bytes'] / 1e9:.2f} GB in {ev['restore_s']:.2f}s (then checked equal to the "
            f"commit in {tr['verified']['seconds']:.2f}s, left out of that step's time); dedup "
            f"{tr['skipped']} of {tr['seen']} docs skipped, {tr['aliased']} aliased (the "
            f"stream screened on to its {TRAIN_DEDUP_DOCS}th in {tr['screen_s']:.2f}s); disk free {tr['disk_free_gb'][0]:.1f} -> {tr['disk_free_gb'][1]:.1f} "
            f"GB (a commit {tr['commit_gb']:.2f} GB); made in {tr['init_s']:.1f}s, run "
            f"{tr['run_s']:.1f}s; phase {tr['seconds']:.0f}s")


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


# ---------------------------------------------------------------------------
# the sharded DHT: one process per rank (torch.distributed)
# ---------------------------------------------------------------------------

#: ranks of the full-width DHT, all on the one card: NCCL refuses two ranks
#: on one device, so they form a gloo group (gloo stages CUDA tensors
#: through the host itself). Not a multi-GPU scaling result.
DHT_RANKS = 4
#: keys loaded into the full-width DHT (cut only by the run's time limit)
DHT_KEYS = 1_000_000
#: the global batch of the load's later batches and of the searches
DHT_BATCH = 1 << 16
DHT_TICKS, DHT_TICK = 200, 1024
#: fresh inserts of the ShardFrontend storm (one read of a loaded key each)
DHT_FRESH = 1 << 14
#: keys of the one-rank NCCL path
DHT_NCCL_KEYS = 1 << 16
#: each shard in the main path's geometry (max_segments, dir_depth_max)
DHT_GEOMETRY = (32768, 17)
#: distinct segments a shard may split in one split call
DHT_SPLIT_LANES = 1024
DHT_TIMEOUT = 300.0
#: the run's own budget (its limit is 1200 s). A cut is taken only when
#: the time spent and what is left at full size would pass it: the
#: baselines' apps (``APPS_CUT``, decided by the side lane), yi-6b's third
#: serving round, then the DHT's key count. What is left is reckoned from
#: the phases' costs on NVIDIA H100 80GB HBM3, 700.00 W (``BASE_PHASE_S``,
#: ``LM_PHASES_S``, ``TRAIN_PHASE_S``, and the DHT's below), whose host
#: speed swings the whole run by a third or more: one run that ended at
#: 1014 s with everything in one process ran past 1200 s on a slower host,
#: so the budget leaves a third of the limit for such a host
RUN_BUDGET_S = 800.0
#: the baselines phase with its apps whole (149.0 s in a run that ended at
#: 1003 s, 175.8 s in one that ended at 1130 s)
BASE_PHASE_S = 150.0
#: the DHT phase: 79.1-89.8 s at its 65,536-key minimum in four runs; at
#: 1M keys 99.2 s and 123.2 s in two more (its load 73.7 s there against
#: 32.7 s at the minimum): ~85 s whatever the key count (spawns, the
#: stream, the load's first growing batches) and up to ~40 s more for 1M
DHT_FIXED_S = 85.0
DHT_S_PER_MKEY = 40.0
DHT_DIR = Path(__file__).resolve().parent / "build" / "dht"


# ---------------------------------------------------------------------------
# training on a mesh: run inside the DHT's card ranks, before their DHT work
# ---------------------------------------------------------------------------

#: the mesh phase: yi-6b at its published widths on MESH_LAYERS layers, a
#: 2 x 2 (data x model) mesh of the DHT's 4 gloo ranks on the one card,
#: phase 13's first MESH_STEPS batches (4 x 256 tokens) under each preset of
#: MESH_RUNS: ZeRO-3 (one row a rank), then FSDP + TP + SP (two rows a data
#: rank, half the sequence a model rank)
MESH_LAYERS = TRAIN_LAYERS
MESH_STEPS = 2
MESH_RUNS = ("train_dp", "train")
#: gradient leaves whose first-step shards go through compressed_psum
MESH_CP_LEAVES = (("norm_f", "scale"), ("blocks_0", "attn", "wq"), ("blocks_0", "mlp", "w_down"))
#: the phase's share of the run's budget, inside the DHT phase's wall time
#: (on NVIDIA H100 80GB HBM3, 700.00 W: 29.9 and 31.6 s in the ranks in two
#: whole runs with 3 train_dp steps; 32.9 s with 2 train_dp and 2 train
#: steps, whose steps run ~20 % slower on a slow host; the serving presets
#: 12.5 s more in the mesh phase run alone)
MESH_PHASE_S = 50.0
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh"
MESH_MOE = (("shardmap", "mixtral-8x7b", "train_dp"), ("ep", "phi3.5-moe-42b-a6.6b", "train_dp_ep"))
#: the serving presets after the train steps: (preset, lanes), the
#: weights phase 13's seed-0 masters rounded to bf16, a ring of
#: MESH_SERVE_CACHE slots (split 512 a model rank under decode, over 'data'
#: under decode_b1); MESH_SERVE_PROMPT prompt tokens fed one step at a time,
#: then MESH_SERVE_NEW greedy steps, the tokens rank 0's one-device run's
MESH_SERVES = (("decode", 4), ("decode_b1", 1))
MESH_SERVE_CACHE = 1024
MESH_SERVE_PROMPT, MESH_SERVE_NEW = 16, 8
#: the serve runs start from a seeded random ring with ``pos`` here, 12
#: slots before the pieces' split: the 24 steps write slots 500-523, in
#: both pieces, and every softmax combines two pieces that hold valid slots
MESH_SERVE_START = MESH_SERVE_CACHE // 2 - 12
#: each step's logits within this many bf16 roundoffs of the one-device
#: step's largest (the CPU tests' LOGITS_K, tests/test_torch_mesh_tp.py);
#: the final cache pieces likewise of the cache's largest magnitude
MESH_SERVE_K = 4.0
#: decode_32k's shape for mesh_on_cards: (lanes, cache length), and the
#: steps it times after its first
DECODE_32K = (128, 32768)
DECODE_32K_STEPS = 8
#: lanes a rank of decode_32k's first layer whose attention is held to a
#: plain f32 softmax over the whole ring (the pieces gathered for them)
DECODE_32K_CHECKED = 2


#: the master leaves phase 13 and the mesh phase are compared on: (path,
#: rows of its first dim: the first chunk's, where the dim is sharded)
MESH_SAMPLES = {"embed": (("embed", "table"), slice(0, 16)),
                "wq": (("blocks_0", "attn", "wq"), slice(0, 1)),
                "norm": (("norm_f", "scale"), slice(None))}


def _mesh_samples(params) -> dict:
    """16 embedding rows, layer 0's wq and the final norm of a master tree
    (full leaves or this rank's shards)."""
    out = {}
    for k, (path, rows) in MESH_SAMPLES.items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        out[k] = leaf[rows]
    return out


def _gathered_samples(params, layout, mesh) -> dict:
    """``_mesh_samples`` of a sharded master tree, whole on the mesh's
    first rank: every sampled dim gathered but a row slice's, whose rows lie
    in the first rank's chunk (collective)."""
    from repro_torch.train import steps as TS
    flat = dict(TS.layout_leaves(layout))
    return {k: TS.gather_leaf(v, flat[MESH_SAMPLES[k][0]], mesh,
                              () if MESH_SAMPLES[k][1] == slice(None) else (0,))
            for k, v in _mesh_samples(params).items()}


def _moe_inputs(arch: str):
    """Seeded f32 MoE weights (the reduced ``arch``'s widths) and a (4, 64,
    d) input, as numpy: the same on every rank and in the parent."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(31)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.normal(0, d ** -0.5, (d, E)), "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_up": rng.normal(0, d ** -0.5, (E, d, ff)),
         "w_down": rng.normal(0, ff ** -0.5, (E, ff, d))}
    return cfg, {k: v.astype(np.float32) for k, v in w.items()}, \
        rng.normal(0, 1, (4, 64, d)).astype(np.float32)


def _int8_gathered(w, n: int, axis: int):
    """``fsdp_gather_int8``'s forward computed in one process: ``w`` cut
    into ``n`` shards on ``axis``, each quantized with its per-channel
    scales and dequantized (f32)."""
    from repro_torch.parallel.compression import INV_127
    parts = []
    for c in w.chunk(n, axis):
        scale = torch.clamp(torch.amax(torch.abs(c), dim=axis, keepdim=True) * INV_127, min=1e-12)
        parts.append(torch.clamp(torch.round(c / scale), -127, 127) * scale)
    return torch.cat(parts, axis)


def _mesh_compressed(step, mesh) -> dict:
    """``compressed_psum`` over 'data' of this rank's first-step gradient
    shards of ``MESH_CP_LEAVES`` (zero residuals), against the same formula
    recomputed on the host from the data ranks' gathered shards: the
    largest differences of the means and the residuals."""
    from repro_torch.parallel.collectives import gather, group_for
    from repro_torch.parallel.compression import INV_127, compressed_psum, init_residuals
    from repro_torch.train.steps import layout_leaves
    data = group_for(mesh, ("data",))
    paths = [p for p, _ in layout_leaves(step.layout)]
    grads = {"/".join(p): g for p, g in zip(paths, step.held["grads"]) if p in MESH_CP_LEAVES}
    mean, res = compressed_psum(grads, init_residuals(grads), data)
    inv = np.float32(INV_127)
    errs = {}
    for k, g in grads.items():
        e = gather(g.float()[None], data, 0).cpu().numpy()
        scale = max(np.float32(max(np.abs(x).max(), np.float32(1e-12))) * inv for x in e)
        q = np.clip(np.round(e / scale), -127, 127)
        want = q.astype(np.int32).sum(0).astype(np.float32) * scale / np.float32(data.size)
        want = torch.from_numpy(want).to(g.dtype).float().numpy()
        own = data.index
        want_r = (e[own].astype(np.float64) - q[own] * np.float64(scale)).astype(np.float32)
        errs[k] = (float(np.abs(mean[k].float().cpu().numpy() - want).max()),
                   float(np.abs(res[k].cpu().numpy() - want_r).max()), g.numel())
    return errs


def _mesh_run(rank: int, preset: str, step, state, mesh, batches, device) -> dict:
    """``MESH_STEPS`` steps of ``step`` (made under ``preset``) from
    ``state`` on phase 13's batches, the last traced: each step's ms and
    bytes into each collective, the losses and lrs, peak HBM, the gathered
    samples (rank 0) and, under train_dp, ``compressed_psum`` on the first
    step's gradient shards."""
    from repro_torch.parallel import collectives
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    out = dict(losses=[], lrs=[], step_ms=[], bytes=[])
    for i, b in enumerate(batches):
        batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}

        def one():
            return step(state, batch)[1]
        collectives.reset_bytes()
        t1 = time.perf_counter()
        if i == len(batches) - 1 and cuda:
            wall, _, top, m, (busy, copies) = busy_share(one, split_copies=True)
            out["trace"] = (wall, busy, top, copies)
        else:
            m = one()
        loss = float(m["loss"])
        sync()
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        out["bytes"].append(dict(collectives.BYTES))
        out["losses"].append(loss)
        out["lrs"].append(float(m["lr"]))
        if i == 0 and preset == "train_dp":
            out["cp"] = _mesh_compressed(step, mesh)
    samples = _gathered_samples(state.params, step.layout, mesh)
    if rank == 0:
        out["samples"] = {k: v.cpu().numpy() for k, v in samples.items()}
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out["main_s"] = time.perf_counter() - t0
    if rank == 0:
        log(f"  mesh rank 0 {preset}: steps ms {out['step_ms']}, losses {out['losses']}, peak "
            f"HBM {out.get('peak_gb', 0.0):.2f} GB, {out['main_s']:.1f}s")
    return out


def _mesh_rank(rank: int, world: int, device, cfg, batches, commit_dir: str,
               serves=MESH_SERVES) -> dict:
    """The mesh phase on one of the DHT's card ranks: a 2 x 2 mesh over the
    4 ranks; ``cfg`` (yi-6b at its published widths) from seed 0 (one f32
    draw, sharded under each preset of ``MESH_RUNS``; the later presets'
    shards wait on the host), ``MESH_STEPS`` steps on phase 13's batches
    under each (``_mesh_run``); the serving presets on the same draw
    rounded to bf16 (``_mesh_serve_prepare``, ``_mesh_serve_run``); then
    both MoE shard_map variants on this
    rank's row and the elastic runbook at reduced yi-6b (a sharded commit,
    the shrink to (1, 2), ranks 2 and 3 leave the mesh, the restore, the
    reshard, one step under the default preset, ``train``). Returns what
    the parent checks; rank 0 also the gathered samples."""
    import dataclasses
    import gc
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.launch import elastic
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import param_specs
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train import steps as TS
    t0 = time.perf_counter()
    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    out = {"layers": cfg.n_layers, "runs": {}}
    mesh = make_test_mesh(2, 2, device)
    cuda = torch.device(device).type == "cuda"
    model = init_params(dataclasses.replace(cfg, dtype="float32"), 0, device)
    steps, shards = {}, {}
    for i, preset in enumerate(MESH_RUNS):
        with sharding.use(mesh, preset):
            steps[preset] = TS.make_train_step(cfg)
        shards[preset] = TS.mesh_shards(model, steps[preset].layout,
                                        device if i == 0 else "cpu")
    t1 = time.perf_counter()
    serve = _mesh_serve_prepare(rank, mesh, cfg, model, device, serves) if serves else None
    serve_s = time.perf_counter() - t1
    del model
    gc.collect()
    sync()
    out["init_s"] = time.perf_counter() - t0
    for preset in MESH_RUNS:
        state = TS.train_state_init(sharding.tree_map(lambda t: t.to(device), shards.pop(preset)))
        out["runs"][preset] = _mesh_run(rank, preset, steps[preset], state, mesh, batches, device)
        del state
        steps.pop(preset)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out["main_s"] = time.perf_counter() - t0

    # ---- the serving presets (decode, decode_b1) on the same weights ----
    out["serve"] = None
    if serves:
        t1 = time.perf_counter()
        out["serve"] = _mesh_serve_run(rank, mesh, cfg, serve, device)
        out["serve"]["seconds"] = serve_s + time.perf_counter() - t1
        if rank == 0:
            log("  mesh rank 0 serve: " + "; ".join(
                f"{p} steps ms p50 {np.percentile(r['step_ms'], 50):.1f}"
                for p, r in out["serve"]["runs"].items()) + f", {out['serve']['seconds']:.1f}s")

    # ---- the MoE shard_map variants on this rank's row (reduced, f32) ----
    for key, arch, rules in MESH_MOE:
        mcfg, w, x = _moe_inputs(arch)
        with sharding.use(mesh, rules):
            variant = M.mesh_variant(mcfg.moe_cfg(), mcfg.d_model, 1)
            specs = {k: v[1:] for k, v in param_specs(mcfg)["blocks_0"]["moe"].items()}
            layout = sharding.tree_shardings(specs, mesh, shape_tree=w)
            local = {k: torch.from_numpy(np.ascontiguousarray(
                layout[k].take(torch.from_numpy(v)).numpy())).to(device) for k, v in w.items()}
            idx = collectives.group_for(mesh, ("data", "model")).index
            rows = torch.from_numpy(x[idx:idx + 1]).to(device)
            if variant[0] == "ep":
                y, aux = M.moe_apply_ep_shardmap(local, mcfg.moe_cfg(), rows, mesh, variant[1],
                                                 "model", variant[2])
            else:
                y, aux = M.moe_apply_shardmap(local, mcfg.moe_cfg(), rows, mesh, variant[1],
                                              variant[2])
        out[f"moe_{key}"] = (variant[0], idx, y.cpu().numpy(), float(aux))

    # ---- the elastic runbook (reduced yi-6b) ----
    ycfg = get_config("yi-6b", reduced=True)
    rng = np.random.default_rng(41)
    eb = [{"tokens": rng.integers(1, ycfg.vocab_size, (4, 64)).astype(np.int32),
           "labels": rng.integers(0, ycfg.vocab_size, (4, 64)).astype(np.int32)}
          for _ in range(2)]
    with sharding.use(mesh, "train_dp"):
        estep = TS.make_train_step(ycfg)
        est = TS.init_mesh_state(ycfg, 0, mesh, device, estep.layout)
    est, _ = estep(est, {k: torch.as_tensor(v, device=device) for k, v in eb[0].items()})
    ckpt = CheckpointManager(commit_dir)
    ckpt.save_sharded(int(est.step), est, estep.layout, mesh)
    small = elastic.shrink_mesh(mesh, "data", 1, device)
    if sharding.coordinate(small) is None:
        out["elastic"] = {"left": True}
    else:
        _, lazy, _ = ckpt.restore_manifest()
        st = interop.train_state_to_mesh(ycfg, lazy, small, "train", device)
        step = elastic.relower_for_mesh(ycfg, small)
        st, m = step(st, {k: torch.as_tensor(v, device=device) for k, v in eb[1].items()})
        full = TS.gather_tree(st.params, step.layout, small)
        out["elastic"] = {"metrics": {k: float(v) for k, v in m.items()}, "batch": eb[1],
                          "params": interop.train_state_to_numpy(TS.TrainState(
                              full, st.opt, st.step)) if rank == 0 else None}
    sharding.set_active(None)
    out["launches"] = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                       "fused_probe": fused.LAUNCHES}
    del est, estep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_checks(report, card: str, ranks: list, record: dict, commit_dir: str) -> dict:
    """The parent's checks of the mesh phase (``_mesh_rank``'s results):
    every rank's losses equal, and held to phase 13's first steps (the loss
    within one bf16 roundoff; the sampled masters after ``MESH_STEPS`` steps
    within 2.1 x the steps' summed learning rates, as the CPU tests hold a
    bf16 step); ``compressed_psum`` equal to its host formula; each MoE
    variant within f32 roundoff of the same variant computed in this process
    (``_int8_gathered`` weights, ``_moe_math`` on each row, the aux averaged);
    the elastic step within the CPU tests' bf16 bounds of the one-device step
    from the same commit."""
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _moe_math, moe_capacity
    from repro_torch.train import steps as TS
    r0 = ranks[0]
    bf16 = 2.0 ** -8
    errs = {}
    for preset, run in r0["runs"].items():
        losses = [r["runs"][preset]["losses"] for r in ranks]
        check(all(x == run["losses"] for x in losses) and np.isfinite(run["losses"]).all(),
              f"mesh {preset}: the ranks' losses {losses}")
        lr_sum = sum(run["lrs"])
        if record is not None:
            for got, want in zip(run["losses"], record["losses"]):
                check(abs(got - want) <= bf16 * abs(want),
                      f"mesh {preset}: losses {run['losses']} against phase 13's "
                      f"{record['losses']}")
            errs[preset] = {k: float(np.abs(run["samples"][k] - v).max())
                            for k, v in record["samples"].items()}
            check(lr_sum > 0 and all(e <= 2.1 * lr_sum for e in errs[preset].values()),
                  f"mesh {preset}: sampled masters {errs[preset]} above 2.1 x {lr_sum}")
    cps = [r["runs"]["train_dp"]["cp"] for r in ranks]
    cp = {k: max(c[k][:2] for c in cps) for k in cps[0]}
    check(all(max(v) == 0.0 for v in cp.values()), f"mesh: compressed_psum off its formula {cp}")
    moe = {}
    for key, arch, _ in MESH_MOE:
        mcfg, w, x = _moe_inputs(arch)
        mc = mcfg.moe_cfg()
        w = {k: torch.from_numpy(v).to(DEVICE) for k, v in w.items()}
        n = 4 if key == "shardmap" else 2
        wg, wu = _int8_gathered(w["w_gate"], n, 1), _int8_gathered(w["w_up"], n, 1)
        wd = _int8_gathered(w["w_down"], n, 2)
        worst, auxes = 0.0, []
        for r in ranks:
            variant, idx, y, aux = r[f"moe_{key}"]
            check(variant == key, f"mesh: moe_apply chose {variant} for {key}")
            want, a, _ = _moe_math(mc, torch.from_numpy(x[idx:idx + 1]).to(DEVICE), w["router"],
                                   wg, wu, wd, moe_capacity(mc, x.shape[1]))
            worst = max(worst, float(np.abs(y - want.cpu().numpy()).max()))
            auxes.append(float(a))
        aux_err = abs(r0[f"moe_{key}"][3] - float(np.mean(auxes)))
        moe[key] = (worst, aux_err)
        check(worst <= 1e-5 and aux_err <= 1e-6, f"mesh: moe {key} off its plain computation "
              f"({worst}, aux {aux_err})")
    el = r0["elastic"]
    check(not el.get("left") and [bool(r["elastic"].get("left")) for r in ranks]
          == [False, False, True, True], "mesh: the shrink kept the wrong ranks")
    _, lazy, _ = CheckpointManager(commit_dir).restore_manifest()
    ycfg = get_config("yi-6b", reduced=True)
    st = interop.train_state_from_jax(ycfg, {k: v.get() for k, v in lazy.items()}, DEVICE)
    st, m = TS.make_train_step(ycfg)(st, {k: torch.as_tensor(v, device=DEVICE)
                                         for k, v in el["batch"].items()})
    for k in ("loss", "ce"):
        check(abs(el["metrics"][k] - float(m[k])) <= bf16 * abs(float(m[k])),
              f"mesh: elastic {k} {el['metrics'][k]} against {float(m[k])}")
    check(abs(el["metrics"]["grad_norm"] - float(m["grad_norm"]))
          <= 2.0 ** -11 * float(m["grad_norm"]), "mesh: elastic grad norm")
    one = interop.train_state_to_numpy(st)
    el_err = max(float(np.abs(el["params"][k] - v).max()) for k, v in one.items()
                 if k.startswith(".params"))
    check(el_err <= 2.1 * float(m["lr"]), f"mesh: elastic masters {el_err} above 2.1 x lr")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    for kernel, count in launches.items():
        rr = report.setdefault(kernel, {})
        rr.setdefault("paths", {})["mesh"] = count
        rr["launches"] = sum(rr["paths"].values())
    serve = mesh_serve_checks([r["serve"] for r in ranks]) if r0["serve"] else {}
    out = dict(ranks=ranks, errs=errs, cp=cp, moe=moe, el_err=el_err, launches=launches,
               serve=serve, seconds=max(r["seconds"] for r in ranks))
    lr_sum = sum(r0["runs"]["train_dp"]["lrs"])
    held = "; ".join(
        f"{p} losses {run['losses']}"
        + (f", sampled masters within {max(errs[p].values()):.3g} of phase 13's"
           if record is not None else "") for p, run in r0["runs"].items())
    held += (f" (phase 13: {record['losses']}; bound {2.1 * lr_sum:.3g})"
             if record is not None else " (no one-device run to hold them to)")
    log(f"phase mesh: ok {held}; compressed_psum exact on "
        f"{sum(v[2] for v in cps[0].values())} gradient elements; "
        f"moe shardmap / ep within {moe['shardmap'][0]:.3g} / {moe['ep'][0]:.3g} of their "
        f"plain computation; elastic step within {el_err:.3g} of the one-device step; serve "
        + "; ".join(f"{p} logits / cache within {v['logits_k']:.3f} / {v['cache_k']:.3f} bf16 "
                    f"roundoffs of the one-device step" for p, v in serve.items())
        + f"; launches {launches} ({out['seconds']:.1f}s in the ranks) [{card}]")
    return out


def _serve_tokens(rng, lanes: int, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, (lanes, MESH_SERVE_PROMPT)).astype(np.int32)


def _serve_state(cfg, lanes: int, seed: int) -> dict:
    """A serve run's starting decode state, whole on the host: a ring of
    ``MESH_SERVE_CACHE`` slots filled with seeded random K/V in the cache's
    dtype, ``pos`` at ``MESH_SERVE_START`` in every lane (the slots from
    there on masked until written)."""
    from repro_torch.models import decode_state_init
    state = decode_state_init(cfg, lanes, MESH_SERVE_CACHE, "cpu")
    gen = torch.Generator().manual_seed(seed)
    for leaf in state["blocks_0"].values():
        leaf.normal_(generator=gen)
    state["pos"].fill_(MESH_SERVE_START)
    return state


@torch.no_grad()
def _one_device_serve(cfg, model, device, serves) -> dict:
    """Rank 0's one-device reference of the mesh's serve runs: ``model``
    (f32) rounded to a bf16 ``Transformer`` on ``device``; for each
    (preset, lanes) of ``serves``, from its seeded state (``_serve_state``),
    a seeded prompt fed one step at a time, then greedy steps. {preset:
    tokens fed (T, lanes), logits a step, final k / v of every layer (f32
    numpy)}."""
    from repro_torch.models import Transformer, serve_step
    from repro_torch.optim.adamw import map_tree
    from repro_torch.train.steps import param_paths
    one = Transformer(cfg, device)
    src = {(path, index): p for path, index, p in param_paths(model)}
    for path, index, p in param_paths(one):
        p.copy_(src[(path, index)])
    out = {}
    for i, (preset, lanes) in enumerate(serves):
        fed = list(_serve_tokens(np.random.default_rng(61 + i), lanes, cfg.vocab_size).T)
        state = map_tree(lambda t: t.to(device), _serve_state(cfg, lanes, 81 + i))
        logits = []
        for t in range(MESH_SERVE_PROMPT + MESH_SERVE_NEW):
            lg, state = serve_step(one, cfg, state, {"token": torch.from_numpy(fed[t]).to(device)})
            logits.append(lg.cpu().numpy())
            if t + 1 >= MESH_SERVE_PROMPT and len(fed) < MESH_SERVE_PROMPT + MESH_SERVE_NEW:
                fed.append(lg.argmax(-1).to(torch.int32).cpu().numpy())
        out[preset] = {"tokens": np.stack(fed), "logits": logits,
                       "cache": {f: state["blocks_0"][f].float().cpu().numpy() for f in "kv"}}
        del state
    del one
    return out


def _mesh_serve_prepare(rank: int, mesh, cfg, model, device, serves=MESH_SERVES) -> dict:
    """Before the train runs, while the seed-0 f32 ``model`` is whole on
    every rank: rank 0's one-device reference (``_one_device_serve``), its
    tokens broadcast to every rank, and this rank's bf16 serving weights
    for each preset, parked on the host until the serve runs."""
    import torch.distributed as dist
    from repro_torch.train import steps as TS
    one = _one_device_serve(cfg, model, device, serves) if rank == 0 else None
    box = [None if one is None else {p: r["tokens"] for p, r in one.items()}]
    dist.broadcast_object_list(box, src=0)
    params = {p: TS.mesh_serve_params(cfg, mesh, p, model, "cpu") for p, _ in serves}
    return {"one": one, "tokens": box[0], "params": params}


def _mesh_serve_run(rank: int, mesh, cfg, prep: dict, device) -> dict:
    """The serve runs on the mesh, a preset of ``MESH_SERVES`` at a time:
    this rank's weight slices moved to ``device``, its piece of the seeded
    starting state (``decode_state_piece`` of ``_serve_state``, whole on
    the host only), the broadcast tokens fed step by step (the last step
    traced on the card): each step's ms, bytes into each collective and
    logits block, the final k / v pieces of the first layer, peak HBM and
    the cache's GB."""
    import gc
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train import steps as TS
    cuda = torch.device(device).type == "cuda"
    out = {"coord": sharding.coordinate(mesh), "one": prep["one"], "runs": {},
           "layers": cfg.n_layers}
    for i, (preset, tokens) in enumerate(prep["tokens"].items()):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        params = prep["params"].pop(preset).to(device)
        state = TS.decode_state_piece(cfg, _serve_state(cfg, tokens.shape[1], 81 + i), mesh,
                                      preset, device)
        with sharding.use(mesh, preset):
            step = TS.make_serve_step(cfg)
        run = {"step_ms": [], "bytes": [], "logits": []}
        for t, tok in enumerate(tokens):
            x = {"token": torch.from_numpy(tok).to(device)}

            def one(x=x):
                return step(params, state, x)
            collectives.reset_bytes()
            t1 = time.perf_counter()
            traced = t == len(tokens) - 1 and cuda
            if traced:
                wall, busy, top, (lg, state), _ = busy_share(one, split_copies=True)
                run["trace"] = (wall, busy, top)
            else:
                lg, state = one()
            sync()
            ms = (time.perf_counter() - t1) * 1e3
            if t == 0:
                run["first_ms"] = ms
            elif not traced:
                run["step_ms"].append(ms)
            run["bytes"].append(dict(collectives.BYTES))
            run["logits"].append(lg.cpu().numpy())
        run["cache"] = {f: state["blocks_0"][f].float().cpu().numpy() for f in "kv"}
        run["cache_gb"] = sum(t.numel() * t.element_size() for k, leaf in state.items()
                              if k != "pos" for t in leaf.values()) / 1e9
        if cuda:
            run["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        out["runs"][preset] = run
        del params, state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def mesh_serve_checks(ranks: list) -> dict:
    """The parent's checks of the serve runs: every rank's logits finite;
    each step's logits, put together from the ranks' ("batch", "vocab")
    blocks, within ``MESH_SERVE_K`` bf16 roundoffs of rank 0's one-device
    step, with the same argmax wherever the one-device top two are further
    apart than twice that; each rank's final k / v pieces of the first
    layer within the same bound of the one-device cache's slices. Returns
    the readings a preset."""
    one = ranks[0]["one"]
    eps = 2.0 ** -8
    out = {}
    for preset, want in one.items():
        runs = [(r["coord"], r["runs"][preset]) for r in ranks]
        T = len(want["logits"])
        B, V = want["logits"][0].shape
        worst = flips = 0
        checked = 0
        for t in range(T):
            got = np.zeros((B, V), np.float32)
            for coord, run in runs:
                blk = run["logits"][t]
                check(np.isfinite(blk).all(), f"mesh serve {preset}: a non-finite logit")
                nb, nv = blk.shape
                i = coord["data"] if nb < B else 0
                got[i * nb:(i + 1) * nb, coord["model"] * nv:(coord["model"] + 1) * nv] = blk
            w = want["logits"][t]
            scale = eps * float(np.abs(w).max())
            worst = max(worst, float(np.abs(got - w).max()) / scale)
            top2 = np.sort(w, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 2 * MESH_SERVE_K * scale
            checked += int(clear.sum())
            flips += int((got.argmax(-1) != w.argmax(-1))[clear].sum())
        cache = 0.0
        for coord, run in runs:
            for f in "kv":
                full, piece = want["cache"][f], run["cache"][f]
                Cl, nb = piece.shape[3], piece.shape[1]
                c0 = (coord["model"] if preset == "decode" else coord["data"]) * Cl
                i = coord["data"] if nb < full.shape[1] else 0
                ref = full[:, i * nb:(i + 1) * nb, :, c0:c0 + Cl]
                cache = max(cache, float(np.abs(piece - ref).max())
                            / (eps * float(np.abs(full).max())))
        check(worst <= MESH_SERVE_K and cache <= MESH_SERVE_K and flips == 0,
              f"mesh serve {preset}: logits {worst:.3f} / cache {cache:.3f} roundoffs from the "
              f"one-device step (bound {MESH_SERVE_K}), {flips} argmax flips")
        out[preset] = {"logits_k": worst, "cache_k": cache, "argmax_checked": checked}
    return out


def serve_line(serve, ranks: list, card: str, cards: int = 1) -> str:
    """The mesh-serve lines, one a preset."""
    lines = []
    for preset, rd in serve.items():
        runs = [r["runs"][preset] for r in ranks]
        run = runs[0]
        per = {k: np.mean([b[k] for b in run["bytes"]]) / 1e6 for k in run["bytes"][0]}
        trace = ""
        if "trace" in run:
            wall = run["trace"][0]
            busy = sum(r["trace"][1] for r in runs)
            trace = (f"; {'the card' if cards == 1 else 'a card on average'}'s kernels busy "
                     f"{busy / cards / wall:.3f} of rank 0's traced step ({wall * 1e3:.1f} ms; "
                     f"rank 0's top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in run["trace"][2])
                     + ")")
        peak = [r.get("peak_gb") for r in runs]
        lines.append(
            f"end to end mesh serve [{card}]: yi-6b at full width on {ranks[0]['layers']} layers, "
            f"{preset} on a 2 x 2 mesh of "
            + ("4 gloo ranks sharing the card" if cards == 1 else f"{cards} NCCL ranks, one a card")
            + f", {run['logits'][0].shape[0]} lanes a rank, a {MESH_SERVE_CACHE}-slot ring: "
            f"step ms p50 {np.percentile(run['step_ms'], 50):.2f} p99 "
            f"{np.percentile(run['step_ms'], 99):.2f} ({len(run['step_ms'])} steps, not the "
            f"first, {run['first_ms']:.1f}, nor the traced); peak HBM a "
            f"rank [{', '.join(f'{x:.2f}' for x in peak if x is not None)}] GB, cache "
            f"{run['cache_gb']:.4f} GB a rank; MB a step a rank into "
            + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
            + f"; logits within {rd['logits_k']:.3f} bf16 roundoffs of the one-device step, "
            f"{rd['argmax_checked']} clear argmaxes equal, cache pieces within "
            f"{rd['cache_k']:.3f}" + trace)
    return "\n".join(lines)


def _mesh_card_rank(rank: int, world: int, device, **kw) -> dict:
    """``_mesh_rank`` with this rank on its own card, warmed first."""
    _warm_card(f"cuda:{rank}")
    return _mesh_rank(rank, world, f"cuda:{rank}", **kw)


@torch.no_grad()
def _plain_decode_attention(w, cfg, x, k, v, pos):
    """One token's attention of whole weights ``w`` against a whole ring
    ``k`` / ``v`` (B, G, C, hd), written as the reference writes it: the
    new K/V at slot ``pos % C``, one f32 product over every slot, a
    softmax, its weights rounded to the cache's dtype, one f32 product with
    V. Returns the (B, 1, d) output."""
    from repro_torch.models.layers import apply_rope
    B, C = x.shape[0], k.shape[2]
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def proj(wt, n):
        return (x @ wt).reshape(B, 1, n, hd).transpose(1, 2)
    at = pos[:, None, None]
    q = apply_rope(proj(w["wq"], H), at, cfg.rope_theta, w["freqs"])
    lanes = torch.arange(B, device=x.device)
    slot = torch.remainder(pos, C).long()
    k[lanes, :, slot] = apply_rope(proj(w["wk"], G), at, cfg.rope_theta, w["freqs"])[:, :, 0]
    v[lanes, :, slot] = proj(w["wv"], G)[:, :, 0]
    q5 = (q / math.sqrt(hd)).to(k.dtype).reshape(B, G, H // G, hd).float()
    s = torch.matmul(q5, k.float().transpose(-1, -2))
    valid = torch.arange(C, device=x.device)[None, :] < torch.clamp(pos + 1, max=C)[:, None]
    p = torch.softmax(torch.where(valid[:, None, None, :], s, -1e30), dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(x.dtype)
    return out.reshape(B, 1, H * hd) @ w["wo"]


@torch.no_grad()
def _decode_32k_attention(rank: int, mesh, cfg, params, state, device) -> float:
    """The first layer's attention under ``decode`` for ``DECODE_32K_CHECKED``
    lanes of this rank's piece (a seeded token's normed input; a copy of
    the cache pieces: 2 x 16,384 slots a rank, read in
    ``DECODE_CHUNK``-slot chunks and combined over 'model') against
    ``_plain_decode_attention`` on the whole weights and the whole ring,
    both gathered over 'model' for these lanes alone. Returns the largest
    difference in bf16 roundoffs of the plain output's largest
    magnitude."""
    from repro_torch.parallel import collectives, sharding
    n = DECODE_32K_CHECKED
    attn = params.blocks[0][0].attn
    gen = torch.Generator(device=device).manual_seed(89)
    x = torch.randn(n, 1, cfg.d_model, generator=gen, device=device).to(attn.wq.dtype)
    pos = state["pos"][:n].clone()
    k, v = (state["blocks_0"][f][0, :n].clone() for f in "kv")
    with sharding.use(mesh, "decode"):
        got = attn.decode(x, k, v, pos)[0]
        tp = collectives.tp_group()
        heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads}
        whole = {f: t if t.shape[1] == n * cfg.head_dim else collectives.gather(t, tp, 1)
                 for f, n in heads.items() for t in [getattr(attn, f).detach()]}
        whole["wo"] = collectives.gather(attn.wo.detach(), tp, 0)
        whole["freqs"] = attn.freqs
        ring = [collectives.gather(state["blocks_0"][f][0, :n], tp, 2) for f in "kv"]
    want = _plain_decode_attention(whole, attn.cfg, x, *ring, pos)
    scale = 2.0 ** -8 * float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale


@torch.no_grad()
def _decode_32k(rank: int, mesh, device, n_layers: int) -> dict:
    """``decode`` at decode_32k's shape (``DECODE_32K``: 128 lanes, a
    32,768-slot ring; 64 lanes x 16,384 slots a card): yi-6b at its
    published widths on ``n_layers`` layers (random bf16 weights from seed
    7, this rank's slices), the cache pieces filled with seeded random bf16
    on the card and ``pos`` near the ring's end (no 4.2M-token prefill);
    the first layer's attention held to a plain softmax over the whole
    ring (``_decode_32k_attention``), then ``DECODE_32K_STEPS`` steps after
    a first one timed apart, then one traced. Returns each step's ms and
    bytes into each collective, the weights' and cache's GB a card, the
    byte bound ((weights + cache) / the card's memory rate), peak HBM, the
    attention check's roundoffs and the count of non-finite logits."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import decode_state_init, init_params
    from repro_torch.parallel import collectives, sharding
    from repro_torch.train import steps as TS
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=n_layers)
    lanes, C = DECODE_32K
    cuda = torch.device(device).type == "cuda"
    model = init_params(cfg, 7, device)
    params = TS.mesh_serve_params(cfg, mesh, "decode", model, device)
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state = TS.decode_state_piece(cfg, decode_state_init(cfg, lanes, C, device="meta"), mesh,
                                  "decode", device)
    gen = torch.Generator(device=device).manual_seed(97 + rank)
    for leaf in state["blocks_0"].values():
        for layer in leaf:
            layer.normal_(generator=gen)
    steps = DECODE_32K_STEPS
    state["pos"].fill_(C - steps - 3)
    attn_k = _decode_32k_attention(rank, mesh, cfg, params, state, device)
    with sharding.use(mesh, "decode"):
        step = TS.make_serve_step(cfg)
    toks = np.random.default_rng(71).integers(1, cfg.vocab_size, (steps + 2, lanes)).astype(
        np.int32)
    out = {"step_ms": [], "bytes": [], "bad": 0,
           "weights_gb": sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9,
           "cache_gb": sum(t.numel() * t.element_size() for t in state["blocks_0"].values())
           / 1e9, "layers": n_layers, "attn_k": attn_k}
    for t in range(steps + 2):
        x = {"token": torch.from_numpy(toks[t]).to(device)}

        def one(x=x):
            return step(params, state, x)
        collectives.reset_bytes()
        sync()
        t1 = time.perf_counter()
        traced = t == steps + 1 and cuda
        if traced:
            wall, busy, top, (lg, state) = busy_share(one)
            out["trace"] = (wall, busy, top)
        else:
            lg, state = one()
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        if t == 0:
            out["first_ms"] = ms
        elif not traced:
            out["step_ms"].append(ms)
        out["bytes"].append(dict(collectives.BYTES))
        out["bad"] += int((~torch.isfinite(lg)).sum())
    out["bound_ms"] = (out["weights_gb"] + out["cache_gb"]) * 1e9 / HBM_BYTES_PER_S * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else 0.0
    return out


def _mesh_serve_card_rank(rank: int, world: int, device, n_layers: int) -> dict:
    """``mesh_on_cards``'s serving part, one rank a card: the small case
    (yi-6b at full width on ``MESH_LAYERS`` layers, ``decode``, 4 lanes, a
    ``MESH_SERVE_CACHE``-slot ring, held to rank 0's one-device step), then
    ``_decode_32k``."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    device = f"cuda:{rank}"
    _warm_card(device)
    mesh = make_test_mesh(2, 2, device)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS)
    model = init_params(dataclasses.replace(cfg, dtype="float32"), 0, device)
    prep = _mesh_serve_prepare(rank, mesh, cfg, model, device, (("decode", 4),))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serve = _mesh_serve_run(rank, mesh, cfg, prep, device)
    serve["seconds"] = time.perf_counter() - t0
    return {"serve": serve, "big": _decode_32k(rank, mesh, device, n_layers)}


def decode_32k_line(ranks: list, card: str, cards: int) -> str:
    big = [r["big"] for r in ranks]
    b0 = big[0]
    per = {k: np.mean([b[k] for b in b0["bytes"]]) / 1e6 for k in b0["bytes"][0]}
    p50 = np.percentile(b0["step_ms"], 50)
    wall, _, top = b0.get("trace", (1.0, 0.0, []))
    busy = sum(b.get("trace", (0, 0.0))[1] for b in big)
    return (f"end to end decode_32k [{card}]: yi-6b at full width on {b0['layers']} layers, "
            f"decode on {cards} NCCL ranks (2 x 2), one a card, {DECODE_32K[0]} lanes x "
            f"{DECODE_32K[1]} slots ({DECODE_32K[0] // 2} x {DECODE_32K[1] // 2} a card): step ms "
            f"[{', '.join(f'{x:.2f}' for x in b0['step_ms'])}] p50 {p50:.2f} (first "
            f"{b0['first_ms']:.1f}, traced {wall * 1e3:.1f}) against the byte bound {b0['bound_ms']:.2f} ms ((weights "
            f"{b0['weights_gb']:.3f} + cache {b0['cache_gb']:.3f} GB a card) / "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {b0['bound_ms'] / p50:.3f} of it; peak HBM "
            f"[{', '.join(f'{b['peak_gb']:.2f}' for b in big)}] GB; MB a step a rank into "
            + ", ".join(f"{k} {v:.4f}" for k, v in per.items())
            + f"; kernels busy {busy / cards / wall:.3f} of rank 0's traced step "
            f"({wall * 1e3:.1f} ms; rank 0's top: "
            + "; ".join(f"{k} {v:.2f} ms" for k, v in top)
            + f"); non-finite logits {sum(b['bad'] for b in big)}; the first layer's attention "
            f"of {DECODE_32K_CHECKED} lanes a rank within "
            f"{max(b['attn_k'] for b in big):.3f} bf16 roundoffs of a plain f32 softmax over the "
            f"whole ring")


def mesh_on_cards(n_layers: int = 32, world: int = 4, steps: int = 6,
                  parts=("train", "serve")) -> int:
    """The mesh phase's rank function one rank a card over NCCL, on a
    machine with ``world`` cards, at yi-6b's published widths on
    ``n_layers`` layers (its full depth by default), ``steps`` steps of
    seeded random batches of 4 x 256 tokens (the last traced) under each
    preset of ``MESH_RUNS``, each rank warmed first. There is no one-device run to hold
    the losses and masters to (32 layers do not fit one card); every other
    check of ``mesh_checks`` is made. Then (``"serve"`` in ``parts``) the
    serving part (``_mesh_serve_card_rank``): the small ``decode`` case
    held to rank 0's one-device step, and ``decode`` at decode_32k's shape
    on ``n_layers`` layers, its first layer's attention held to a plain
    softmax over the whole ring and ``DECODE_32K_STEPS`` steps against its
    byte bound.
    Prints every card's line, the mesh lines and the checks' line. Run it as
    ``python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.mesh_on_cards())'``
    (``mesh_on_cards(parts=("serve",))`` for the serving part alone)."""
    global DEVICE
    if torch.cuda.device_count() < world:
        print(f"chip_smoke: {world} cards needed, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import dataclasses
    from repro_torch.configs import get_config
    DEVICE = "cuda"
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    for line in cards.splitlines():
        log(f"card: {line}")
    card = cards.splitlines()[0]
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=n_layers)
    rng = np.random.default_rng(53)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 256)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (4, 256)).astype(np.int32)}
               for _ in range(steps)]
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    commit = str(MESH_DIR / "commit")
    report = {}
    try:
        if "train" in parts:
            ranks = _wait_ranks(_spawn_ranks(_mesh_card_rank, world, "nccl", "cards",
                                             device="cuda", cfg=cfg, batches=batches,
                                             commit_dir=commit, serves=()),
                                DHT_TIMEOUT, "the mesh's card ranks")
            log(mesh_line(mesh_checks(report, card, ranks, None, commit), card, cards=world))
        if "serve" in parts:
            ranks = _wait_ranks(_spawn_ranks(_mesh_serve_card_rank, world, "nccl", "serve",
                                             device="cuda", n_layers=n_layers),
                                DHT_TIMEOUT, "the mesh's serving card ranks")
            serve = mesh_serve_checks([r["serve"] for r in ranks])
            log(serve_line(serve, [r["serve"] for r in ranks], card, cards=world))
            big = [r["big"] for r in ranks]
            check(sum(b["bad"] for b in big) == 0, "decode_32k: non-finite logits")
            attn_k = max(b["attn_k"] for b in big)
            check(attn_k <= MESH_SERVE_K, f"decode_32k: the first layer's attention {attn_k:.3f} "
                  f"bf16 roundoffs from a plain softmax over the whole ring (bound "
                  f"{MESH_SERVE_K})")
            log(decode_32k_line(ranks, card, world))
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    return 0


def mesh_line(mesh, card: str, cards: int = 1) -> str:
    """The end-to-end lines of the mesh phase, one a preset (its ranks on
    ``cards`` cards)."""
    r0 = mesh["ranks"][0]
    gb = 1e9
    lines = []
    for preset, run in r0["runs"].items():
        runs = [r["runs"][preset] for r in mesh["ranks"]]
        per = {k: np.mean([b[k] for b in run["bytes"]]) / gb for k in run["bytes"][0]}
        peak = [r.get("peak_gb") for r in runs]
        trace = ""
        if "trace" in run:
            wall = run["trace"][0]
            busy = sum(r["trace"][1] for r in runs)
            copies = sum(r["trace"][3] for r in runs)
            trace = (f"; {'the card' if cards == 1 else 'a card on average'}'s kernels busy "
                     f"{busy / cards / wall:.3f} of rank 0's traced step ({wall * 1e3:.1f} ms "
                     f"wall; the ranks' kernel time summed, {busy * 1e3:.1f} ms; their copies "
                     f"to and from the host {copies * 1e3:.1f} ms more; rank 0's top: "
                     + "; ".join(f"{k} {v:.2f} ms" for k, v in run["trace"][2]) + ")")
        lines.append(
            f"end to end mesh [{card}]: yi-6b at full width on {r0['layers']} layers, {preset} "
            f"on a 2 x 2 mesh of " + ("4 gloo ranks sharing the card (collectives through the "
                                      "host; not a multi-GPU result)" if cards == 1 else
                                      f"{cards} NCCL ranks, one a card")
            + f": steps ms [{', '.join(f'{x:.1f}' for x in run['step_ms'])}], "
            f"p50 {np.percentile(run['step_ms'], 50):.1f}; peak HBM a rank "
            f"[{', '.join(f'{x:.2f}' for x in peak if x is not None)}] GB; GB a step a rank "
            f"into " + ", ".join(f"{k} {v:.3f}" for k, v in per.items()) + trace
            + f"; the run {run['main_s']:.1f}s")
    lines[-1] += f"; init {r0['init_s']:.1f}s; phase {mesh['seconds']:.1f}s"
    if mesh["serve"]:
        lines.append(serve_line(mesh["serve"], [r["serve"] for r in mesh["ranks"]], card, cards)
                     + f"; {r0['serve']['seconds']:.1f}s in rank 0")
    return "\n".join(lines)


def _rank_entry(target, rank: int, world: int, init: str, backend: str, result: str,
                kw: dict) -> None:
    """One rank of a spawned group: join the group (file init), run
    ``target(rank, world, **kw)`` and pickle its result to ``result``. A
    rank that raises exits 1 at once (its peers would wait in their next
    collective; the parent kills them)."""
    import pickle
    import traceback
    global DEVICE
    if kw["device"] == "cpu":
        DEVICE = "cpu"
    _child_setup(1 if kw["device"] == "cpu" else 2)
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        out = target(rank, world, **kw)
        with open(result, "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _spawn_ranks(target, world: int, backend: str, tag: str, **kw):
    """Start ``world`` spawned rank processes of ``target``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    DHT_DIR.mkdir(parents=True, exist_ok=True)
    init = DHT_DIR / f"pg-{tag}"
    init.unlink(missing_ok=True)
    results = [DHT_DIR / f"{tag}-{r}.pkl" for r in range(world)]
    procs = []
    for r in range(world):
        results[r].unlink(missing_ok=True)
        procs.append(ctx.Process(target=_rank_entry, name=f"{tag}-{r}", args=(
            target, r, world, str(init), backend, str(results[r]), kw)))
        procs[-1].start()
    return procs, results


def _wait_ranks(group, timeout: float, what: str) -> list:
    """Wait for every rank of ``group``; a rank that fails, or a group that
    outlives ``timeout``, fails the phase (the other ranks are killed).
    Returns the ranks' results."""
    import pickle
    procs, results = group
    deadline = time.perf_counter() + timeout
    try:
        while any(p.is_alive() for p in procs):
            bad = [p.name for p in procs if p.exitcode not in (None, 0)]
            check(not bad, f"{what}: rank {bad} failed")
            check(time.perf_counter() < deadline, f"{what}: outlived {timeout:.0f}s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    bad = [p.name for p in procs if p.exitcode != 0]
    check(not bad, f"{what}: rank {bad} failed")
    out = []
    for r in results:
        with open(r, "rb") as f:
            out.append(pickle.load(f))
    return out


def _dht_stream(rank: int, world: int, device, pool_dir: str):
    """The card-vs-CPU DHT stream on one rank: inserts through splits,
    searches, ShardFrontend in both verify modes over durable shard pools
    (flush-on-publish, recorders with counting clocks), the pools flushed,
    the table dropped unclosed, each shard reopened lazily and searched.
    Returns every answer and this rank's planes after each stage."""
    from repro_torch import interop, persist
    from repro_torch.core import DashConfig
    from repro_torch.distributed import DistributedDash, ShardFrontend
    from repro_torch.serving import frontend as fe
    cfg = DashConfig(max_segments=32, dir_depth_max=8, init_depth=1, num_buckets=16,
                     num_slots=8)
    keys, vals = _stream_keys(21, 3200)
    d = DistributedDash(cfg, capacity=256, device=device)
    wbs = persist.create_shard_pools(pool_dir, cfg, world, shards=[rank])
    for wb in wbs:
        wb.attach_recorder(_fixed_recorder())
    d.attach_pools(wbs)

    def planes():
        return {k: v.copy() for k, v in interop.state_to_numpy(d.state).items()}

    out = [d.insert(keys[:1500], vals[:1500]), *d.search(keys[:2000])]
    shots = [planes()]
    for mode, (a, b) in (("device", (1500, 2300)), ("host", (2300, 3100))):
        f = ShardFrontend(d, max_batch=128, verify_mode=mode)
        ops = []
        for k, v in zip(keys[a:b], vals[a:b]):
            ops += [fe.Op(fe.INSERT, int(k), int(v)), fe.Op(fe.READ, int(keys[int(k) % a]))]
        for op in ops:
            check(f.submit(op), "the shard frontend refused an op")
        f.drain()
        out.append(np.array([[op.status, int(bool(op.found)), op.result or 0] for op in ops],
                            np.int64))
        st = f.stats()
        out.append(np.array([st[k] for k in ("snapshot_reads", "retried_reads", "published",
                                              "flushes", "flushed_bytes")], np.int64))
        shots.append(planes())
    out.append(np.array([d.flush_pools(), d.n_items]))
    del f, d, wbs                                  # dropped, never closed
    states, wbs, info = persist.reopen_shards(pool_dir, shards=[rank], stack=False,
                                              device=device)
    d = DistributedDash(cfg, capacity=256, device=device, state=states[0])
    d.attach_pools(wbs)
    found, got = d.search(keys[:3100])
    out += [found, got, np.array([d.recovered_segments, d.n_items, info["dirty_shards"]])]
    shots.append(planes())
    d.close_pools()
    return dict(answers=out, planes=shots)


def _timed_exchange(device):
    """Time every ``all_to_all_single`` of this rank (the card synced on
    both sides) until the returned ``restore()``; ``spent[0]`` holds the
    seconds. Returns (spent, restore)."""
    import torch.distributed as dist
    spent, orig = [0.0], dist.all_to_all_single

    def timed(*a, **kw):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(*a, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0

    def restore():
        dist.all_to_all_single = orig
    dist.all_to_all_single = timed
    return spent, restore


def _dht_load(d, keys, vals, batch_cap: int, counts):
    """Load ``keys`` in global batches that grow with the table (64 keys a
    segment, at least 256 a rank, at most ``batch_cap``): the main path's
    rule, so no shard-local batch piles thousands of lanes on a few
    segments. Returns per-batch (keys, seconds, rounds, splits)."""
    segs, done, rows = 2 ** d.cfg.init_depth * d.n_shards, 0, []
    while done < keys.size:
        b = min(batch_cap, max(256 * d.n_shards, 64 * segs), keys.size - done)
        r0, s0 = counts["rounds"], counts["splits"]
        t0 = time.perf_counter()
        st = d.insert(keys[done:done + b], vals[done:done + b], max_rounds=64)
        sync()
        rows.append((b, time.perf_counter() - t0, counts["rounds"] - r0, counts["splits"] - s0))
        check((st == 0).all(), f"dht load: {int((st != 0).sum())} keys not INSERTED")
        done += b
        segs = int(d._sum([int(d.state.watermark)])[0])
    return rows


def _count_calls(d, counts):
    """Count the DHT's insert rounds and split calls."""
    for name, key in (("insert_round_fn", "rounds"), ("split_fn", "splits")):
        fn = getattr(d, name)

        def call(*a, fn=fn, key=key):
            counts[key] += 1
            return fn(*a)
        setattr(d, name, call)


def _dht_full(rank: int, world: int, device, n_keys: int, ticks: int, fresh: int,
              geometry=None):
    """The DHT at full width on one rank: a shard in the main path's
    geometry; ``n_keys`` unique uniform keys loaded, searched as hits and as
    misses in ``DHT_BATCH`` global batches (``fingerprint_probe`` per
    shard), ``ticks`` read ticks of ``DHT_TICK`` global keys (``fused_probe``
    per shard), and a ShardFrontend storm of ``fresh`` inserts with a read
    of a loaded key each; every answer against the ground truth. The
    kernels' launch counters are set to 0 just before the load and read
    after the storm; then both read kernels and ``bulk_hash`` are held to
    their plain versions on this rank's shard-local batches."""
    import torch.distributed as dist
    from repro_torch.core import DashConfig, DashState, engine
    from repro_torch.distributed import DistributedDash, ShardFrontend, np_owner_of
    from repro_torch.kernels import fused, hashmix, probe
    from repro_torch.serving import frontend as fe
    S, depth = geometry or DHT_GEOMETRY
    cfg = DashConfig(max_segments=S, dir_depth_max=depth)
    d = DistributedDash(cfg, device=device, q_local_hint=DHT_BATCH // world,
                        split_lanes=DHT_SPLIT_LANES)
    # a serving-sized handle on the same shard: its exchange buffers fit a tick
    t = DistributedDash(cfg, device=device, q_local_hint=DHT_TICK // world,
                        split_lanes=DHT_SPLIT_LANES, state=d.state)
    counts = {"rounds": 0, "splits": 0}
    _count_calls(d, counts)
    _count_calls(t, counts)
    spent, restore = _timed_exchange(device)
    keys = distinct_keys(1 << 44, n_keys)
    vals = _expected_values(keys)
    misses = distinct_keys(2 << 44, n_keys)
    for mod in (hashmix, probe, fused):
        mod.LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    rows = _dht_load(d, keys, vals, DHT_BATCH, counts)
    load_s = time.perf_counter() - t0
    load_a2a = spent[0]
    out = dict(load_s=load_s, batches=rows, exchange_load=load_a2a)
    t0 = time.perf_counter()
    for what, ks in (("hits", keys), ("misses", misses)):
        t1 = time.perf_counter()
        for a in range(0, ks.size, DHT_BATCH):
            f, v = d.search(ks[a:a + DHT_BATCH])
            if what == "hits":
                check(f.all() and (v == vals[a:a + DHT_BATCH]).all(), "dht search: a hit is wrong")
            else:
                check(not f.any(), "dht search: an absent key was found")
        sync()
        out[f"search_{what}_s"] = time.perf_counter() - t1
    out["exchange_search"] = spent[0] - load_a2a
    out["search_s"] = time.perf_counter() - t0
    batch = keys[:DHT_BATCH]
    if rank == 0 and device != "cpu":
        wall, busy, top, _ = busy_share(lambda: d.search(batch))
        out["trace"] = (wall, busy, top)
    else:
        d.search(batch)
    rng = np.random.default_rng(41)               # the same ticks on every rank
    tick_ms = []
    for _ in range(ticks):
        hit = rng.random(DHT_TICK) < 0.5
        ks = np.where(hit, keys[rng.integers(0, n_keys, DHT_TICK)],
                      misses[rng.integers(0, n_keys, DHT_TICK)])
        t1 = time.perf_counter()
        f, v = t.search(ks)
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        check((f == hit).all() and (v[hit] == _expected_values(ks[hit])).all(),
              "dht tick: a read is wrong")
    out["tick_ms"] = np.asarray(tick_ms)
    # the ShardFrontend storm: fresh inserts with a read of a loaded key each
    new = distinct_keys(3 << 44, fresh)
    f = ShardFrontend(t, max_batch=256, queue_depth=1 << 16)
    ops = []
    r0, s0 = counts["rounds"], counts["splits"]
    t1 = time.perf_counter()
    for a in range(0, fresh, 256):
        block = []
        for k in new[a:a + 256]:
            block += [fe.Op(fe.INSERT, int(k), int(_expected_values(np.array([k]))[0])),
                      fe.Op(fe.READ, int(keys[int(k) % n_keys]))]
        for op in block:
            check(f.submit(op), "the shard frontend refused an op")
        ops += block
        f.step()
    f.drain()
    out["storm_s"] = time.perf_counter() - t1
    out["storm_rounds"], out["storm_splits"] = counts["rounds"] - r0, counts["splits"] - s0
    rd = [op for op in ops if op.kind == fe.READ]
    check(all(op.status == 0 for op in ops if op.kind == fe.INSERT),
          "dht storm: an insert did not land")
    check(all(op.found and op.result == int(_expected_values(np.array([op.key], np.uint64))[0])
              for op in rd), "dht storm: a read is wrong")
    out["sojourn_ms"] = np.asarray(f.read_latencies) * 1e3
    st = f.stats()
    out["storm_stats"] = {k: st[k] for k in ("published", "snapshot_reads", "retried_reads")}
    n_items = d.n_items
    check(n_items == n_keys + fresh, f"dht n_items {n_items} != {n_keys + fresh}")
    out["launches"] = {"bulk_hash": hashmix.LAUNCHES, "fingerprint_probe": probe.LAUNCHES,
                       "fused_probe": fused.LAUNCHES}
    out["segments"] = int(d._sum([int(d.state.watermark)])[0])
    out["state_mb"] = sum(x.numel() * x.element_size() for x in d.state) / 2**20
    # both read kernels and bulk_hash against their plain versions on this
    # rank's shard-local batches (the card's shard and a CPU copy of it)
    mine = keys[np_owner_of(keys, world) == rank]
    host = DashState(*(x.cpu() for x in d.state))
    from repro_torch.core import hashing
    errs = {}
    for plan, n in (("pallas", DHT_BATCH // world), ("fused", DHT_TICK // world)):
        probe_keys = np.concatenate([mine[:n // 2], misses[:n - n // 2]])
        hi, lo = hashing.split_keys(probe_keys, device)
        got = engine.search_batch(cfg, "eh", d.state, hi, lo, batching=plan)
        want = engine.search_batch(cfg, "eh", host, hi.cpu(), lo.cpu(), batching=plan)
        errs[plan] = max_abs_err([g.cpu() for g in got], want)
    h_got = hashmix.bulk_hash(hi, lo)
    h_want = hashmix.bulk_hash_plain(hi.cpu(), lo.cpu())
    errs["bulk_hash"] = max_abs_err([g.cpu() for g in h_got], h_want)
    out["errs"] = errs
    restore()
    return out


def _warm_card(device) -> None:
    """One forward and backward of yi-6b at its published widths on one
    layer: the process's first matrix products and backward pay the
    libraries' start (seconds a process) here, not in a timed step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params, loss_fn
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=1)
    model = init_params(cfg, 0, device)
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = torch.zeros((1, TRAIN_SEQ), dtype=torch.int32, device=device)
    loss_fn(model, cfg, {"tokens": tokens, "labels": tokens})[0].backward()
    torch.cuda.synchronize(device)
    del model
    torch.cuda.empty_cache()


def _await_go(go: str, timeout: float = 3000.0) -> dict:
    """The keyword arguments the parent writes to ``go`` when the phase
    starts; gives up when the parent is gone or after ``timeout``."""
    import pickle
    parent, deadline = os.getppid(), time.perf_counter() + timeout
    while not os.path.exists(go):
        if os.getppid() != parent or time.perf_counter() > deadline:
            raise RuntimeError("no go from the parent")
        time.sleep(0.2)
    with open(go, "rb") as f:
        return pickle.load(f)


def _dht_card_rank(rank: int, world: int, device, pool_dir: str, go: str):
    """A card rank, started with the run: it warms the card's libraries,
    waits for ``phase_dht``'s arguments (``go``), then runs the mesh phase
    when they hold its arguments (cfg, batches, commit dir), the
    card-vs-CPU stream and the full-width DHT."""
    if torch.device(device).type == "cuda":
        _warm_card(device)
    full = _await_go(go)
    mesh = full.pop("mesh")
    out = {"mesh": _mesh_rank(rank, world, device, *mesh) if mesh is not None else None}
    t0 = time.perf_counter()
    stream = _dht_stream(rank, world, device, pool_dir)
    return dict(out, stream=stream, stream_s=time.perf_counter() - t0,
                full=_dht_full(rank, world, device, **full))


def start_dht_cards():
    """Start the DHT's 4 card ranks (a gloo group sharing the card) with
    the run, so their imports, CUDA contexts and warm-up overlap earlier
    phases; ``phase_dht`` sends them their arguments. Returns (the group,
    its go file)."""
    dev = "cuda:0" if DEVICE == "cuda" else "cpu"
    DHT_DIR.mkdir(parents=True, exist_ok=True)
    go = DHT_DIR / "go-card.pkl"
    go.unlink(missing_ok=True)
    return _spawn_ranks(_dht_card_rank, DHT_RANKS, "gloo", "card", device=dev,
                        pool_dir=str(DHT_DIR / "pools-card"), go=str(go)), go


def start_dht_nccl(nccl_keys: int = DHT_NCCL_KEYS, geometry=None):
    """Start the one-rank NCCL group of the DHT path (``_dht_full`` at
    ``nccl_keys``). The run starts it beside the card-vs-CPU streams, which
    time nothing; ``phase_dht`` reads its result."""
    dev = "cuda:0" if DEVICE == "cuda" else "cpu"
    return _spawn_ranks(_dht_full, 1, "nccl" if DEVICE == "cuda" else "gloo", "nccl",
                        device=dev, n_keys=nccl_keys, ticks=20, fresh=1024,
                        geometry=geometry or DHT_GEOMETRY)


def phase_dht(report, card: str, nccl, n_keys: int = DHT_KEYS, geometry=None,
              ticks: int = DHT_TICKS, fresh: int = DHT_FRESH, mesh=None, cards=None):
    """The sharded DHT (``repro_torch.distributed``), one process per rank:
    the card-vs-CPU stream on 4 gloo ranks on the card and 4 on the CPU
    (answers, every rank's planes after every stage and every shard pool
    file byte-identical); then, on the card ranks, the full-width DHT
    (``_dht_full``). ``nccl`` is the result of the same path on the
    one-rank NCCL group (``start_dht_nccl``, waited on by the caller). The
    launch counters of both full-width runs are summed over the ranks. A
    CPU rehearsal passes a smaller ``geometry`` (max_segments,
    dir_depth_max) and counts. ``mesh``: phase 13's record (``phase_train``'s
    ``mesh_record``) and the mesh's config; the card ranks run the mesh
    phase first and ``mesh_checks`` holds it (the result's ``"mesh"``).
    ``cards``: the card ranks ``start_dht_cards`` started with the run
    (started here when None)."""
    import pickle
    geometry = geometry or DHT_GEOMETRY
    t_phase = time.perf_counter()
    group, go = cards or start_dht_cards()
    pools = {dev: str(DHT_DIR / f"pools-{dev}") for dev in ("cpu", "card")}
    for path in pools.values():
        shutil.rmtree(path, ignore_errors=True)
    cpu = _spawn_ranks(_dht_stream, DHT_RANKS, "gloo", "cpu", device="cpu",
                       pool_dir=pools["cpu"])
    mesh_args = None
    if mesh is not None:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
        mesh_args = (mesh["cfg"], mesh["record"]["batches"], str(MESH_DIR / "commit"))
    tmp = go.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(dict(n_keys=n_keys, ticks=ticks, fresh=fresh, geometry=geometry,
                         mesh=mesh_args), f)
    os.replace(tmp, go)
    ranks = _wait_ranks(group, DHT_TIMEOUT, "the card's DHT ranks")
    mesh_out = None
    if mesh is not None:
        mesh_out = mesh_checks(report, card, [r["mesh"] for r in ranks], mesh["record"],
                               str(MESH_DIR / "commit"))
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    cpu_ranks = _wait_ranks(cpu, DHT_TIMEOUT, "the CPU's DHT ranks")
    for r, (mine, theirs) in enumerate(zip(ranks, cpu_ranks)):
        a, b = mine["stream"], theirs
        check(len(a["answers"]) == len(b["answers"]), "dht stream: answer counts differ")
        for i, (x, y) in enumerate(zip(a["answers"], b["answers"])):
            check(np.array_equal(x, y), f"dht stream: rank {r} answer {i} differs between "
                  f"cuda and cpu")
        for i, (x, y) in enumerate(zip(a["planes"], b["planes"])):
            bad = [k for k in x if x[k].tobytes() != y[k].tobytes()]
            check(not bad, f"dht stream: rank {r} planes after stage {i} differ in {bad}")
    for i in range(DHT_RANKS):
        name = f"shard_{i:04d}.pool"
        with open(os.path.join(pools["card"], name), "rb") as f, \
                open(os.path.join(pools["cpu"], name), "rb") as g:
            check(f.read() == g.read(), f"dht stream: shard {i}'s pool files differ")
    stream = ranks[0]["stream"]["answers"]
    dirty = [r["stream"]["answers"][-1][2] for r in ranks]     # each reopened its own
    recovered = stream[-1][0]
    check(recovered > 0 and dirty == [1] * DHT_RANKS, f"dht stream: dirty shards {dirty}, "
          f"{recovered} segments recovered")
    full = [r["full"] for r in ranks]
    for path, runs in (("dht", full), ("dht nccl", [nccl])):
        for kernel in ("bulk_hash", "fingerprint_probe", "fused_probe"):
            count = sum(x["launches"][kernel] for x in runs)
            check(count > 0 or DEVICE != "cuda", f"{kernel} was not launched on the {path} path")
            r = report.setdefault(kernel, {})
            r.setdefault("paths", {})[path] = count
            r["launches"] = sum(r["paths"].values())
        errs = {k: max(x["errs"][k] for x in runs) for k in runs[0]["errs"]}
        check(not any(errs.values()), f"{path}: a kernel disagrees with its plain version "
              f"on shard-local batches: {errs}")
    f0 = full[0]
    rows = np.array(f0["batches"], np.float64)
    big = rows[rows[:, 0] == DHT_BATCH]
    sj, tk = f0["sojourn_ms"], f0["tick_ms"]
    out = dict(insert_mops=n_keys / f0["load_s"] / 1e6,
               search_mops=2 * n_keys / f0["search_s"] / 1e6,
               exchange_share=f0["exchange_load"] / f0["load_s"],
               exchange_search=f0["exchange_search"] / f0["search_s"],
               p50=np.percentile(sj, 50), p99=np.percentile(sj, 99),
               tick_p50=np.percentile(tk, 50), tick_p99=np.percentile(tk, 99),
               keys=n_keys, segments=f0["segments"], nccl=nccl, mesh=mesh_out)
    launches = {k: report[k]["paths"]["dht"] for k in ("bulk_hash", "fingerprint_probe",
                                                        "fused_probe")}
    log(f"  dht [{card}]: {DHT_RANKS} ranks in a gloo group sharing one card (not a "
        f"multi-GPU scaling result; gloo stages each exchange through the host); each "
        f"shard DashConfig(max_segments={geometry[0]}, dir_depth_max={geometry[1]}), "
        f"{f0['state_mb']:.0f} MB "
        f"of planes a shard; {n_keys} keys loaded in {len(rows)} global batches "
        f"({rows[:, 0].min():.0f} to {rows[:, 0].max():.0f} keys, growing with the table), "
        f"{f0['load_s']:.1f}s, {out['insert_mops']:.3f} Mops/s; rounds per batch "
        f"{rows[:, 2].mean():.2f}, split calls per batch {rows[:, 3].mean():.2f} (at "
        f"{DHT_BATCH} keys: {big[:, 2].mean() if big.size else 0:.2f} / "
        f"{big[:, 3].mean() if big.size else 0:.2f}); the exchange "
        f"{out['exchange_share']:.3f} of the load's wall time; {f0['segments']} segments")
    log(f"  dht [{card}]: search {n_keys} hits {f0['search_hits_s']:.2f}s and {n_keys} "
        f"misses {f0['search_misses_s']:.2f}s in {DHT_BATCH}-key batches, "
        f"{out['search_mops']:.3f} Mops/s, the exchange {out['exchange_search']:.3f} of it; "
        f"{len(tk)} ticks of {DHT_TICK} keys p50 {out['tick_p50']:.3f} ms p99 "
        f"{out['tick_p99']:.3f} ms; ShardFrontend storm {fresh} inserts + {fresh} "
        f"reads in {f0['storm_s']:.1f}s ({f0['storm_rounds']} rounds, {f0['storm_splits']} "
        f"split calls, {f0['storm_stats']}), read sojourn p50 {out['p50']:.3f} ms p99 "
        f"{out['p99']:.3f} ms")
    if "trace" in f0:
        wall, busy, top = f0["trace"]
        log(f"  trace dht [{card}] one {DHT_BATCH}-key read batch on rank 0: wall "
            f"{wall * 1e3:.1f} ms, its process busy on the card {busy * 1e3:.1f} ms (busy "
            f"share {busy / wall:.3f}); top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    n_nccl = sum(b[0] for b in nccl["batches"])
    log(f"  dht [{card}]: the card-vs-CPU stream took {ranks[0]['stream_s']:.1f}s on the "
        f"card ranks")
    log(f"  dht nccl [{card}]: one rank, {n_nccl} keys in {nccl['load_s']:.2f}s, search "
        f"{2 * n_nccl / nccl['search_s'] / 1e6:.3f} Mops/s (beside the card-vs-CPU "
        f"streams), every answer checked; launches "
        f"{nccl['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase dht: ok card and CPU streams byte-identical (answers, planes after every "
        f"stage, {DHT_RANKS} shard pool files); every full-width answer checked; kernels "
        f"exact on shard-local batches; launches {launches} ({out['seconds']:.1f}s) [{card}]")
    return out



# ---------------------------------------------------------------------------
# the side lane: the LH path, shrink and the baselines in a second process
# ---------------------------------------------------------------------------

#: the longest the main process waits for the side lane once its own model
#: phases are done, and the longest the side lane waits for the main
#: process's load latency
SIDE_TIMEOUT = 600.0
SIDE_DIR = Path(__file__).resolve().parent / "build" / "side"


def side_lane(run_t0: float, locks, load_ns, ns_ready, card: str, lh_keys: int,
              result: str, device: str) -> None:
    """Phases 8-10 in a spawned process on the card, beside the main
    process's phases 4-7c, 12 and 13 (the host drives every path, one core
    a process): the LH path and its probe kernels, shrink, then the
    baselines. Each path's launch counters are this process's own, set to 0
    just before it and read just after. ``locks`` are the timing lock, the
    step lock and the main process's wish for it (``_LANES``);
    ``level_scan``'s bound waits for the main process's
    dependent-load latency (``load_ns``, once ``ns_ready`` is set). Pickles
    its report entries, the LH summary and the baselines' result to
    ``result``; a failed phase exits 1. ``device`` is ``DEVICE`` in the
    parent (a CPU rehearsal sets "cpu")."""
    import pickle
    global _RUN_T0, _LANES, DEVICE
    DEVICE = device
    parent = os.getppid()
    _RUN_T0, _LANES = run_t0, (*locks, lambda: os.getppid() == parent, True)
    _child_setup(2)
    from repro_torch.core import DashConfig
    report = {}
    try:
        t, keys, misses, lh, _ = phase_main_path(
            DashConfig(max_segments=32768, num_stash=4), lh_keys, 1000, report,
            "DashLH", "lh", lh_batch, LH_RETRIES)
        with quiet_card():
            phase_probe_kernels(t, keys, misses, report)
        del t
        phase_shrink(DashConfig(max_segments=32768, dir_depth_max=17,
                                init_depth=SHRINK_DEPTH))
        elapsed = time.perf_counter() - run_t0
        cut_apps = elapsed + BASE_PHASE_S + MESH_PHASE_S + DHT_FIXED_S > RUN_BUDGET_S
        if cut_apps:
            log(f"apps cut: the prefix cache {APPS_CUT[0]} prompts in {APPS_CUT[1]} pages, "
                f"the dedup stream {APPS_CUT[2]} batches ({elapsed:.0f}s of the run spent)")
        check(ns_ready.wait(SIDE_TIMEOUT), "no load latency from the main process")
        report["fused_probe"]["load_ns"] = load_ns.value
        base = phase_baselines(report, card, cut_apps=cut_apps)
    except PhaseError as e:
        log(f"FAILED in the side lane: {e}")
        os._exit(1)
    with open(result, "wb") as f:
        pickle.dump(dict(report=report, lh=lh, base=base), f)


def start_side_lane(card: str, lh_keys: int):
    """Spawn ``side_lane`` and share the card's locks with it (``_LANES``).
    Returns (the child, its shared load latency and event, its result)."""
    import multiprocessing
    global _LANES
    ctx = multiprocessing.get_context("spawn")
    shutil.rmtree(SIDE_DIR, ignore_errors=True)
    SIDE_DIR.mkdir(parents=True)
    result = SIDE_DIR / "side.pkl"
    locks = (ctx.Lock(), ctx.Lock(), ctx.Event())
    load_ns, ns_ready = ctx.Value("d", float("nan")), ctx.Event()
    child = ctx.Process(target=side_lane, name="side-lane", args=(
        _RUN_T0, locks, load_ns, ns_ready, card, lh_keys, str(result), DEVICE))
    child.start()
    _LANES = (*locks, lambda: child.exitcode in (None, 0), False)
    return child, load_ns, ns_ready, result


def join_side_lane(side, report) -> dict:
    """Wait for the side lane; merge its report entries into ``report``
    (its paths' launches, its largest errors, the entries only it
    measures). Returns its LH summary and baselines' result."""
    import pickle
    child, _, _, result = side
    _join(child, SIDE_TIMEOUT, "the side lane")
    with open(result, "rb") as f:
        out = pickle.load(f)
    for kernel, part in out["report"].items():
        r = report.setdefault(kernel, {})
        for k, v in part.items():
            if k == "paths":
                r.setdefault("paths", {}).update(v)
            elif k == "max_abs_err":
                r[k] = max(r.get(k, 0), v)
            else:
                r.setdefault(k, v)
        r["launches"] = sum(r["paths"].values())
    return out


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
    import dataclasses
    from repro_torch.configs import get_config
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
    cpu_child, cards, side = start_cpu_halves(), None, None
    try:
        phase_build()
        phase_bulk_hash(report)
        nccl = start_dht_nccl()           # beside the streams, which time nothing
        cards = start_dht_cards()         # they wait for phase_dht
        side = start_side_lane(card, args.lh_keys)    # phases 8-10, from here on
        phase_cuda_vs_cpu(cpu_child)
        nccl = _wait_ranks(nccl, DHT_TIMEOUT, "the DHT's NCCL rank")[0]
        phase_edges()
        t, keys, misses, summary, truth = phase_main_path(
            DashConfig(max_segments=32768, dir_depth_max=17), args.keys, 1000, report)
        with quiet_card(pause_side=True):
            phase_probe_kernels(t, keys, misses, report)
        side[1].value = report["fused_probe"]["load_ns"]
        side[2].set()
        phase_recovery(t, keys, misses, truth)
        del t, truth
        fe, carry = phase_frontend(
            DashConfig(max_segments=32768, dir_depth_max=17, init_depth=FE_DEPTH),
            args.fe_keys, FE_FRESH, report, card)
        dur = phase_durable(carry, report, card)
        del carry
        # past the run's budget yi-6b loses its third round (the side lane
        # halves its apps by the same budget), then the DHT its keys
        rest = LM_PHASES_S + TRAIN_PHASE_S + MESH_PHASE_S + DHT_FIXED_S + DHT_S_PER_MKEY
        rounds, elapsed = LM_ROUNDS, time.perf_counter() - t0
        if elapsed + rest > RUN_BUDGET_S:
            rounds = 2
            log(f"lm cut: {LM_ARCH} {rounds} rounds of {LM_ROUNDS} ({elapsed:.0f}s of the run "
                f"spent)")
        with quiet_card():
            lm = [phase_lm(report, card, LM_ARCH, rounds)]
        for arch, n_layers, pages in LM_KINDS:
            with quiet_card():
                lm.append(phase_lm(report, card, arch, LM_KIND_ROUNDS, n_layers, pages))
        with quiet_card():
            train = phase_train(report, card)
        side_out = join_side_lane(side, report)
        lh, base = side_out["lh"], side_out["base"]
        n_dht, elapsed = DHT_KEYS, time.perf_counter() - t0
        if elapsed + MESH_PHASE_S + DHT_FIXED_S + DHT_S_PER_MKEY > RUN_BUDGET_S:
            left = max(RUN_BUDGET_S - elapsed - MESH_PHASE_S - DHT_FIXED_S,
                       0.0) / DHT_S_PER_MKEY
            n_dht = max(DHT_BATCH, int(DHT_KEYS * left) // DHT_BATCH * DHT_BATCH)
            log(f"dht cut: {n_dht} keys of {DHT_KEYS} ({elapsed:.0f}s of the run spent)")
        mesh_cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MESH_LAYERS)
        dht = phase_dht(report, card, nccl, n_dht,
                        mesh={"cfg": mesh_cfg, "record": train.pop("mesh_record")}, cards=cards)
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        for child in (cpu_child, side[0] if side is not None else None):
            if child is not None and child.is_alive():
                child.kill()
                child.join()
        for p in (cards[0][0] if cards is not None else ()):
            if p.is_alive():
                p.kill()
                p.join()
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
        f"phase {base['seconds']:.0f}s")
    for one in lm:
        log(lm_line(one, card))
    log(train_line(train, card))
    log(mesh_line(dht["mesh"], card))
    log(f"end to end dht [{card}]: {DHT_RANKS} ranks sharing the card through gloo (not a "
        f"multi-GPU scaling result): insert {dht['insert_mops']:.3f} Mops/s, search "
        f"{dht['search_mops']:.3f} Mops/s (the exchange {dht['exchange_share']:.3f} of the "
        f"load, {dht['exchange_search']:.3f} of the searches), tick p50 "
        f"{dht['tick_p50']:.3f} ms p99 {dht['tick_p99']:.3f} ms, ShardFrontend read sojourn "
        f"p50 {dht['p50']:.3f} ms p99 {dht['p99']:.3f} ms ({dht['keys']} keys, "
        f"{dht['segments']} segments); phase {dht['seconds']:.0f}s; total "
        f"{time.perf_counter() - t0:.0f}s")
    log(card)
    log(kernel_line(report))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
