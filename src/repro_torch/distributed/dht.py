"""Distributed Dash on ``torch.distributed``: one shard per rank.

Ported from ``repro.distributed.dht``. Every rank owns an independent
Dash-EH table (a shard) on its device. The top log2(n_shards) bits of the
addressing hash pick a key's owner — the distributed extension of the MSB
directory. Every rank takes the same global batch and keeps its row of the
``(n_shards, q_local)`` query layout (``_shape_queries``); it routes that
row to the owners through the shared sort-based dispatcher
(``kernels/ops.route_lanes``) into a packed ``(n_shards, capacity, W)``
int32 word buffer, one ``dist.all_to_all_single`` carries it, owners run
the ordinary shard-local Dash paths, and a second ``all_to_all_single``
carries the answers back. Answers and statuses are then gathered, so every
rank returns the same global vectors as the reference.

Shard-local work is the single table's:

* reads take the table planner's rule: ``fused_probe`` (one launch) at or
  under 1024 live lanes (the table's default ``fused_threshold``),
  ``fingerprint_probe`` above it; only lanes that carry a query are probed
  (the routing's padding lanes are not), and the answers equal the
  reference's per-key path;
* inserts take the segment-parallel engine over the live lanes, with the
  exact lane capacity, which gives the reference's sequential scan's
  planes and statuses;
* splits are planned and committed on the shard's device
  (``core/smo.plan_local_splits`` + ``split_segments_local``); a split
  never moves keys across shards (owner bits and shard-local directory
  bits are disjoint).

Every host decision the reference takes from a whole-mesh array is reduced
over the group (``all_reduce``/``all_gather``), so it is the same on every
rank and every rank runs the same sequence of collectives: the round flags,
the split flags (a raise such as "shard segment pool exhausted" happens on
every rank after the reduce), the dirty-shard set and ``n_items``.
Per-access lazy recovery works as in the reference: owner-side probes flag
(reads) or bounce (writes) lanes whose segment's ``seg_version`` lags the
recovery generation, and ``ensure_recovered`` repairs exactly the touched
segments on the owning rank.

The host-mirror verify and the host split loop are kept
(``ShardFrontend(verify_mode="host")``, ``DistributedDash._split_for_host``)
as the differential references.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import dash_eh, engine, hashing, layout, recovery, smo
from repro_torch.core.layout import (DROPPED, NEED_SPLIT, SEG_NEW, SEG_SPLITTING,
                                     DashConfig, DashState, u32, word)
from repro_torch.core.table import DashTable, search_plan
from repro_torch.kernels import ops
from repro_torch.kernels.hashmix import bulk_hash
from repro_torch.serving import engine as serving_engine
from repro_torch.serving import frontend


def make_sharded_state(cfg: DashConfig, n_shards: int, device=None) -> DashState:
    """``n_shards`` fresh shard states stacked on a leading axis (the
    reference's layout; a process that holds every shard, e.g. a tool)."""
    one = layout.make_state(cfg, "eh", device)
    return DashState(*(x.unsqueeze(0).repeat((n_shards,) + (1,) * x.dim())
                       for x in one))


def _owner_shift(n_shards: int) -> int:
    return 32 - int(np.log2(n_shards))


def owner_of(keys_hi, keys_lo, n_shards: int):
    """Owner shard (int64) from the TOP bits of h1 — the distributed MSB
    directory. Shard-local directories consume the next dir_depth_max
    bits, so probing inside the owner uses the unchanged 32-bit hash."""
    h1, _, _ = bulk_hash(keys_hi, keys_lo)
    return u32(h1) >> _owner_shift(n_shards)


def np_owner_of(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Host mirror of ``owner_of`` over raw uint64 keys (routing is pure
    hashing: the host attributes keys to shards without a device plane)."""
    hi, lo = hashing.np_split_keys(np.asarray(keys, np.uint64))
    return hashing.np_hash1(hi, lo).astype(np.int64) >> _owner_shift(n_shards)


def _local_dispatch(hi, lo, v, n_shards: int, capacity: int, owner_mask=None):
    """Route this rank's queries into (n_shards, capacity) buffers through
    the shared dispatcher (the router the engine groups segments with,
    here grouping by owner shard). ``owner_mask=False`` lanes route to
    owner -1 (dropped). Returns buffers + src map (-1 = empty lane) + kept
    mask."""
    owner = owner_of(hi, lo, n_shards)
    if owner_mask is not None:
        owner = torch.where(owner_mask, owner, -1)
    (b_hi, b_lo, b_v), b_src, keep = ops.route_lanes(
        owner, (hi, lo, v), n_shards, capacity, (0, 0, 0))
    return b_hi, b_lo, b_v, b_src, keep


def auto_capacity(q_local: int, n_shards: int, slack: float = 4.0) -> int:
    """Routing lanes per (src, dst): expected q_local/n_shards with slack."""
    want = int(np.ceil(q_local / n_shards * slack))
    return max(8, 1 << int(np.ceil(np.log2(want))))


def _reduce_max(flags, group):
    """Element-wise max over the group: the same host decision everywhere."""
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
    return flags.cpu().numpy()


def build_dht_programs(cfg: DashConfig, group=None, capacity: int | None = None,
                       q_local_hint: int = 1024, split_lanes: int = 8):
    """The five per-rank programs over this rank's shard.

    Each takes this rank's shard state (updated in place) and its row of
    the global query layout, and runs the reference's shard program: route
    the row to the owners, one ``all_to_all_single`` of the packed
    ``(n_shards, capacity, W)`` words, the shard-local step, one
    ``all_to_all_single`` back, and a max-scatter to the row's lanes. The
    round and split flags come back reduced over the group, (3,) on every
    rank. ``split_lanes`` bounds the distinct segments a shard splits per
    ``split_fn`` call; surplus pressured segments stay NEED_SPLIT and are
    planned the next round."""
    n_shards = dist.get_world_size(group)
    if capacity is None:
        capacity = auto_capacity(q_local_hint, n_shards)

    def a2a(words):
        """One exchange of the packed (n_shards, capacity, W) word buffer."""
        words = words.contiguous()
        out = torch.empty_like(words)
        dist.all_to_all_single(out, words, group=group)
        return out

    def stale_lanes(local, h1):
        """Per-access lazy-recovery hook: a lane whose segment's
        seg_version lags the recovery generation may observe a crash-wiped
        probe structure."""
        seg = local.dir[layout.dir_index(cfg, h1)].long()
        return local.seg_version[seg] != local.gver

    def route(hi, lo, v=None, mask=None):
        """Route this rank's lanes to their owners (``mask=False`` lanes
        route nowhere) and exchange the packed words [hi, lo, (v,) live].
        Returns the received (n_shards*capacity, W) lanes, the indices of
        the live ones, the src map and the kept mask."""
        b_hi, b_lo, b_v, b_src, keep = _local_dispatch(
            hi, lo, torch.zeros_like(hi) if v is None else v, n_shards, capacity,
            owner_mask=mask)
        cols = [b_hi, b_lo] + ([] if v is None else [b_v]) + [(b_src >= 0).int()]
        flat = a2a(torch.stack(cols, -1)).reshape(-1, len(cols))
        return flat, (flat[:, -1] != 0).nonzero()[:, 0], b_src, keep

    def keys_of(flat, idx):
        return flat[idx, 0].contiguous(), flat[idx, 1].contiguous()

    def scatter_back(b_src, resp, flags, n_local: int):
        """Undo the routing: the (n_shards, capacity, W) answer words back
        to this rank's lanes (-1 src = padding, dropped); word columns by
        max over their uint32 values, the ``flags`` columns by any."""
        resp = resp.reshape(-1, resp.shape[-1])
        src = b_src.reshape(-1)
        safe = src.clamp(min=0)
        live = src >= 0
        outs = []
        for j in range(resp.shape[1]):
            col = resp[:, j]
            val = ((col != 0) & live).long() if j in flags else torch.where(live, u32(col), 0)
            out = torch.zeros(n_local, dtype=torch.int64, device=col.device)
            out.scatter_reduce_(0, safe, val, "amax")
            outs.append(out.bool() if j in flags else word(out))
        return outs

    def read_answers(old, new, flat, idx):
        """(n_shards, capacity, W) answer words of the live lanes: found,
        value, then the verify mask against ``new`` (snapshot reads only)
        and the stale flag."""
        hi, lo = keys_of(flat, idx)
        found, vals = engine.search_batch(cfg, "eh", old, hi, lo,
                                          batching=search_plan(cfg, hi.numel()))
        h1, _, _ = bulk_hash(hi, lo)
        cols = [found.to(torch.int32), vals]
        if new is not old:
            cols.append(serving_engine.buckets_changed_local(
                cfg, "eh", old, new, hi, lo).to(torch.int32))
        cols.append(stale_lanes(new, h1).to(torch.int32))
        resp = torch.zeros((flat.shape[0], len(cols)), dtype=torch.int32, device=flat.device)
        resp[idx] = torch.stack(cols, -1)
        return a2a(resp.reshape(n_shards, capacity, len(cols)))

    def search_inner(st, hi, lo):
        flat, idx, b_src, keep = route(hi, lo)
        f, v, s = scatter_back(b_src, read_answers(st, st, flat, idx), (0, 2), hi.shape[0])
        return f, v, s, keep

    def snap_search_inner(old_st, new_st, hi, lo):
        """One exchange pair for the whole optimistic read tick: probe the
        pinned snapshot, verify each routed query against the live version
        planes, check the live recovery generation, route the answers
        back. No plane leaves the device."""
        flat, idx, b_src, keep = route(hi, lo)
        f, v, c, s = scatter_back(b_src, read_answers(old_st, new_st, flat, idx), (0, 2, 3),
                                  hi.shape[0])
        return f, v, c, s, keep

    def local_insert(st, flat, idx):
        """Segment-parallel insert of the ``idx`` lanes, in lane order, with
        the exact lane capacity; the other lanes come back DROPPED."""
        out = torch.full((flat.shape[0],), DROPPED, dtype=torch.int32, device=flat.device)
        if idx.numel():
            hi, lo = keys_of(flat, idx)
            h1, _, _ = bulk_hash(hi, lo)
            seg = st.dir[layout.dir_index(cfg, h1)].long()
            cap = DashTable._lane_quantum(DashTable._max_per_segment(seg))
            _, statuses, _ = engine.insert_batch(cfg, "eh", st, hi, lo, flat[idx, 2],
                                                 None, batching="segment", capacity=cap)
            out[idx] = statuses
        return out

    def statuses_back(b_src, statuses, n_local: int):
        s_back = a2a(statuses.reshape(n_shards, capacity, 1)).reshape(-1).long()
        src = b_src.reshape(-1)
        res = torch.full((n_local,), -1, dtype=torch.int64, device=s_back.device)
        res.scatter_reduce_(0, src.clamp(min=0), torch.where(src >= 0, s_back, -1), "amax")
        return torch.where(res < 0, DROPPED, res).to(torch.int32)   # overflow lanes

    def insert_inner(st, hi, lo, v, valid):
        # padded lanes (the host pads the batch to n_shards*q_local) route
        # nowhere: the dispatcher never grants them a lane, so padding can
        # never insert the zero key
        flat, idx, b_src, keep = route(hi, lo, v, valid)
        return statuses_back(b_src, local_insert(st, flat, idx), hi.shape[0]), keep

    def insert_round_inner(st, hi, lo, v, pending, out):
        """One insert retry round: only the pending lanes route, owners
        bounce lanes that land on an unrecovered segment (a write must not
        land in a crash-dirty segment: its wiped overflow metadata could
        hide a duplicate in the stash), and the round's (3,) flags —
        any-retry / any-need-split / any-stale — come back reduced."""
        flat, idx, b_src, _ = route(hi, lo, v, pending)
        h1, _, _ = bulk_hash(*keys_of(flat, idx))
        stale = stale_lanes(st, h1)
        statuses = local_insert(st, flat, idx[~stale])    # stale lanes: DROPPED
        res = statuses_back(b_src, statuses, hi.shape[0])
        out = torch.where(pending, res, out)
        need = pending & (out == NEED_SPLIT)
        pending = need | (pending & (out == DROPPED))
        flags = torch.stack([pending.any(), need.any(), stale.any()]).int()
        return out, pending, need, _reduce_max(flags, group)

    def split_inner(st, hi, lo, want):
        """Shard-local bulk SMOs in one call: route the pressured keys to
        their owners, plan the distinct segments to split on the device,
        and run phase 1 + phase 2 on the shard. A resource-exhausted shard
        commits NOTHING and raises through the flags on every rank."""
        flat, idx, _, _ = route(hi, lo, mask=want)
        h1, _, _ = bulk_hash(*keys_of(flat, idx))
        old, new, valid, depth_bad, pool_bad = smo.plan_local_splits(
            cfg, st, h1, torch.ones_like(idx, dtype=torch.bool), split_lanes)
        k = int(valid.sum())           # the plan's lanes are a prefix: skip the padding
        commit = valid[:k] & ~(depth_bad | pool_bad)
        _, ok = smo.split_segments_local(cfg, st, old[:k], new[:k], commit)
        flags = torch.stack([depth_bad, pool_bad, (commit & ~ok).any()]).int()
        return _reduce_max(flags, group)

    return dict(n_shards=n_shards, capacity=capacity, search_fn=search_inner,
                snap_search_fn=snap_search_inner, insert_fn=insert_inner,
                insert_round_fn=insert_round_inner, split_fn=split_inner)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` if given, else the card of this rank's local index
    (``LOCAL_RANK`` when the launcher sets it). Raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card of its own "
                           f"({torch.cuda.device_count()} present); pass device=")
    return torch.device("cuda", local)


class DistributedDash:
    """One rank of a sharded Dash: this rank's shard plus the host logic of
    the reference's ``DistributedDash``, run identically on every rank of
    ``group`` (default: the world). The shard lives on ``device`` (the
    rank's card unless given; ``device="cpu"`` for CPU runs).

    Every method that takes keys is collective: each rank passes the same
    global batch and gets the same global answers. ``state`` restores this
    rank's shard, e.g. from ``persist.reopen_shards(..., shards=[rank],
    stack=False)``; ``attach_pools`` binds this rank's
    durable shard pool, flushed independently, so a dirty shard restart
    recovers shard-locally.

    A restored state may be crash-dirty: construction detects lagging
    shards from the small planes only (seg_version, watermark, gver), and
    every access lazily recovers exactly the segments it touches
    (``ensure_recovered``), with the programs' stale mask as the audit.
    ``lazy_recovery=False`` keeps the detection but expects the caller to
    recover eagerly."""

    def __init__(self, cfg: DashConfig, group=None, device=None,
                 capacity: int | None = None, q_local_hint: int = 1024,
                 state: DashState | None = None, lazy_recovery: bool = True,
                 split_lanes: int = 8):
        if not dist.is_initialized():
            raise RuntimeError("DistributedDash needs an initialized process group")
        self.cfg = cfg
        self.group = group
        self.rank = dist.get_rank(group)
        self.device = _rank_device(device, self.rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        progs = build_dht_programs(cfg, group, capacity, q_local_hint, split_lanes)
        self.n_shards = progs["n_shards"]
        self.capacity = progs["capacity"]
        self.search_fn = progs["search_fn"]
        self.snap_search_fn = progs["snap_search_fn"]
        self.insert_fn = progs["insert_fn"]
        self.insert_round_fn = progs["insert_round_fn"]
        self.split_fn = progs["split_fn"]
        self._device_smo = smo.rebuild_eligible(cfg)
        restored = state is not None
        if state is None:
            state = layout.make_state(cfg, "eh", self.device)
        else:
            if state.version.dim() != 2:                  # (S, BT): one shard
                raise ValueError("state= takes this rank's own shard state")
            state = DashState(*(x.to(self.device).contiguous() for x in state))
        self.state = state
        self.writebacks = None        # this rank's durable shard pool (persist/)
        self.lazy_recovery = lazy_recovery
        self.recovered_segments = 0   # fleet-wide, the same on every rank
        self._dirty_shards: set = self._detect_dirty_shards() if restored else set()

    # -- collectives ---------------------------------------------------------

    def _gather_rows(self, row):
        """(n_shards * q_local, ...) host array of every rank's row."""
        parts = [torch.empty_like(row) for _ in range(self.n_shards)]
        dist.all_gather(parts, row.contiguous(), group=self.group)
        return torch.cat(parts).cpu().numpy()

    def _sum(self, values) -> np.ndarray:
        t = torch.as_tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, group=self.group)
        return t.cpu().numpy()

    def _any(self, flag) -> bool:
        t = torch.as_tensor([bool(flag)], dtype=torch.int32, device=self.device)
        return bool(_reduce_max(t, self.group)[0])

    # -- durable pools ------------------------------------------------------

    def attach_pools(self, writebacks):
        """Bind this rank's durable shard pool (``[engine]``, e.g. from
        ``persist.create_shard_pools(..., shards=[rank])``) and mark the
        serving period dirty (the clean markers go durable only via
        ``close_pools``). Fresh pools get the current state flushed
        immediately, so a crash before the first ``flush_pools`` reopens to
        a valid table. Collective."""
        if len(writebacks) != 1:
            raise ValueError("a rank attaches its own shard's pool, and only that")
        self.writebacks = list(writebacks)
        self.state.clean.fill_(False)
        if self._any(any(wb.pool.sb.flush_seq == 0 for wb in self.writebacks)):
            self.flush_pools()

    def flush_pools(self) -> int:
        """Flush every shard into its own pool; returns the fleet's bytes.
        Fault isolation: a shard whose pool degrades is skipped — the other
        shards still flush — and keeps serving from device state until
        ``recover_pools`` brings its pool back. Collective."""
        from repro_torch import persist
        assert self.writebacks is not None, "no pools attached"
        return int(self._sum([persist.flush_shards(self.state, self.writebacks)])[0])

    def recover_pools(self) -> int:
        """Probe every degraded shard pool and force-resync the ones that
        answer. Returns the shards recovered, fleet-wide. Collective."""
        from repro_torch import persist
        assert self.writebacks is not None, "no pools attached"
        return int(self._sum([persist.recover_shards(self.state, self.writebacks)])[0])

    def degraded_shards(self) -> list:
        """Indices of the shards whose pools are degraded. Collective."""
        if self.writebacks is None:
            return []
        mine = torch.zeros(self.n_shards, dtype=torch.int64, device=self.device)
        mine[self.rank] = int(any(wb.degraded for wb in self.writebacks))
        return np.flatnonzero(self._sum(mine)).tolist()

    def close_pools(self):
        """Durable clean shutdown of every shard pool. Collective."""
        assert self.writebacks is not None, "no pools attached"
        self.state.clean.fill_(True)
        self.flush_pools()
        for wb in self.writebacks:
            wb.pool.close()

    # -- lazy crash recovery ------------------------------------------------

    def _shard_dirty(self) -> bool:
        wm = int(self.state.watermark)
        return bool((self.state.seg_version[:wm] != self.state.gver).any())

    def _detect_dirty_shards(self) -> set:
        """Shards whose recovery generation lags — each rank scans the small
        planes of its own shard (seg_version, watermark, gver; never the
        record planes) and the flags are gathered. Collective."""
        mine = torch.zeros(self.n_shards, dtype=torch.int64, device=self.device)
        mine[self.rank] = int(self._shard_dirty())
        return set(np.flatnonzero(self._sum(mine)).tolist())

    def ensure_recovered(self, keys=None) -> int:
        """Per-access lazy recovery: the owner of each dirty shard the keys
        route to recovers exactly the touched segments
        (``core/recovery.lazy_recover_touched``); ``keys=None`` recovers
        every dirty shard fully. Returns the segments recovered
        fleet-wide. Collective whenever a shard is dirty."""
        if not self._dirty_shards:
            return 0
        recovered = []
        if self.rank in self._dirty_shards:
            st = self.state
            if keys is None:
                touched = torch.arange(int(st.watermark), device=self.device)
            else:
                keys = np.asarray(keys, np.uint64)
                khi, klo = hashing.np_split_keys(keys)
                h1 = hashing.np_hash1(khi, klo)
                mine = np_owner_of(keys, self.n_shards) == self.rank
                d = torch.from_numpy((h1[mine] >> np.uint32(32 - self.cfg.dir_depth_max))
                                     .astype(np.int64)).to(self.device)
                touched = st.dir[d]
            self.state, recovered = recovery.lazy_recover_touched(self.cfg, "eh", st, touched)
        n_rec = np.zeros(self.n_shards, np.int64)
        dirty = np.zeros(self.n_shards, np.int64)
        n_rec[self.rank] = len(recovered)
        dirty[self.rank] = int(self.rank in self._dirty_shards and self._shard_dirty())
        both = self._sum(np.concatenate([n_rec, dirty]))
        total = int(both[:self.n_shards].sum())
        self.recovered_segments += total
        self._dirty_shards -= set(np.flatnonzero(both[self.n_shards:] == 0).tolist())
        return total

    # -- batch API ----------------------------------------------------------

    def _shape_queries(self, keys):
        """This rank's row of the global ``(n_shards, q_local)`` layout, the
        tail padded with key 0: (hi, lo, n, lanes) with ``lanes`` the row's
        global positions."""
        keys = np.asarray(keys, np.uint64)
        q_local = -(-keys.size // self.n_shards)
        lanes = np.arange(self.rank * q_local, (self.rank + 1) * q_local)
        row = np.zeros(q_local, np.uint64)
        mine = lanes < keys.size
        row[mine] = keys[lanes[mine]]
        hi, lo = hashing.split_keys(row, self.device)
        return hi, lo, keys.size, lanes

    def _row_values(self, vals, lanes):
        vals = np.asarray(vals, np.uint32)
        row = np.zeros(lanes.size, np.uint32)
        mine = lanes < vals.size
        row[mine] = vals[lanes[mine]]
        return torch.from_numpy(row.view(np.int32)).to(self.device)

    def _row_mask(self, lanes, n: int):
        return torch.from_numpy(lanes < n).to(self.device)

    def insert_once(self, keys, vals):
        """ONE sharded insert round — no SMOs, no retries. Returns the
        per-key statuses; NEED_SPLIT/DROPPED lanes are the caller's to
        retry. The host-sync reference round."""
        keys = np.asarray(keys, np.uint64)
        hi, lo, n, lanes = self._shape_queries(keys)
        if n == 0:
            return np.zeros(0, np.int32)
        statuses, _ = self.insert_fn(self.state, hi, lo, self._row_values(vals, lanes),
                                     self._row_mask(lanes, n))
        return self._gather_rows(statuses)[:n]

    def insert(self, keys, vals, max_rounds: int = 8):
        """Batch insert with shard-local SMO retries, statuses resident on
        the device across rounds: each round syncs only the reduced (3,)
        flags; the per-key statuses are gathered once when the batch
        completes. Capacity-DROPPED lanes retry too (the smaller retry
        subset routes without overflow)."""
        keys = np.asarray(keys, np.uint64)
        if self.lazy_recovery and self._dirty_shards:
            self.ensure_recovered(keys)
        hi, lo, n, lanes = self._shape_queries(keys)
        if n == 0:
            return np.zeros(0, np.int32)
        v = self._row_values(vals, lanes)
        pending = self._row_mask(lanes, n)
        out = torch.full(hi.shape, DROPPED, dtype=torch.int32, device=self.device)
        for _ in range(max_rounds):
            out, pending, need, fl = self.insert_round_fn(self.state, hi, lo, v,
                                                          pending, out)
            if fl[2]:
                # an owner saw a crash-dirty segment: recover it, lane retries
                self._dirty_shards |= self._detect_dirty_shards()
                self.ensure_recovered(keys)
            if fl[1]:
                self._dispatch_splits(hi, lo, need, keys)
            if not fl[0]:
                return self._gather_rows(out)[:n]
        raise RuntimeError("dht insert retry budget exhausted")

    # -- shard-local SMOs ----------------------------------------------------

    def _check_split_flags(self, fl):
        if fl[0]:
            raise RuntimeError("shard directory depth exhausted")
        if fl[1]:
            raise RuntimeError("shard segment pool exhausted")
        if fl[2]:
            self._repair_splits()

    def _dispatch_splits(self, hi, lo, want, keys):
        """Device bulk splits for the wanted lanes; configs the one-pass
        rebuild does not cover take the host loop (the want mask is
        gathered once — O(batch) bools — only on that path)."""
        if not self._device_smo:
            need = self._gather_rows(want.to(torch.int32))[:keys.size] != 0
            return self._split_for_host(keys[need])
        self._check_split_flags(self.split_fn(self.state, hi, lo, want))

    def split_for(self, keys):
        """Shard-local splits on the owners of the given keys: every
        pressured segment of every pressured shard splits in ONE call,
        planned and committed on the shards' devices."""
        keys = np.asarray(keys, np.uint64)
        if not self._device_smo:
            return self._split_for_host(keys)
        hi, lo, n, lanes = self._shape_queries(keys)
        self._check_split_flags(self.split_fn(self.state, hi, lo,
                                              self._row_mask(lanes, n)))

    def _split_for_host(self, keys):
        """The host-driven split loop (differential reference and ablation
        path): each owner plans its pressured segments on the host and
        bulk-splits them. The resource checks are reduced first, so a
        raise happens on every rank and no shard splits in that call."""
        keys = np.asarray(keys, np.uint64)
        mine = np_owner_of(keys, self.n_shards) == self.rank
        hi, lo = hashing.np_split_keys(keys[mine])
        h1 = hashing.np_hash1(hi, lo)
        st = self.state
        segs = np.unique(st.dir.cpu().numpy()[h1 >> np.uint32(32 - self.cfg.dir_depth_max)])
        wm = int(st.watermark)
        depth_bad = bool((st.local_depth.cpu().numpy()[segs] >= self.cfg.dir_depth_max).any())
        pool_bad = wm + segs.size > self.cfg.max_segments
        fl = _reduce_max(torch.tensor([depth_bad, pool_bad], dtype=torch.int32,
                                      device=self.device), self.group)
        if fl[0]:
            raise RuntimeError("shard directory depth exhausted")
        if fl[1]:
            raise RuntimeError("shard segment pool exhausted")
        if not segs.size:
            return
        if self._device_smo:
            self.state, _ = smo.bulk_split(self.cfg, st, segs, wm + np.arange(segs.size))
        else:
            for seg in segs:
                self.state, ok = dash_eh.split_segment(self.cfg, self.state, int(seg))
                assert bool(ok)

    def _repair_splits(self):
        """Scan-rehash fallback for a shard whose one-pass rebuild could not
        fit a segment: finish each in-flight split as BulkSplitTask's
        commit stage does (the source is still SPLITTING with its SEG_NEW
        neighbor side-linked). Each rank repairs its own shard."""
        ss = self.state.seg_state.cpu().numpy()
        side = self.state.side_link.cpu().numpy()
        for seg in np.nonzero(ss == SEG_SPLITTING)[0]:
            nbr = int(side[seg])
            assert nbr >= 0 and ss[nbr] == SEG_NEW, "un-repairable split leftover"
            self.state, fit = dash_eh.split_phase2_scan(self.cfg, self.state, int(seg),
                                                        nbr, False)
            if not bool(fit):
                raise AssertionError("split rehash failed to refit records")

    # -- reads ---------------------------------------------------------------

    def _answers(self, cols, n: int):
        """Gather (found, value[, ...]) rows; flags come back bool, values
        uint32."""
        both = self._gather_rows(torch.stack([c.to(torch.int32) for c in cols], -1))[:n]
        return [np.ascontiguousarray(both[:, i]).view(np.uint32) if i == 1
                else both[:, i] != 0 for i in range(both.shape[1])]

    def search_on(self, state, keys):
        """Search against a caller-supplied shard state on this rank (e.g.
        an epoch-pinned snapshot); ``search`` is the live-state shorthand.
        The program only reads ``state``."""
        hi, lo, n, _ = self._shape_queries(keys)
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, np.uint32)
        f, v, _, _ = self.search_fn(state, hi, lo)
        return tuple(self._answers([f, v], n))

    def search(self, keys):
        """Live-state search with the per-access recovery hook closed on
        the host: dirty shards the keys route to are recovered BEFORE the
        probe; the in-program stale mask is the audit (it re-probes iff
        something re-dirtied behind the host's back)."""
        if self.lazy_recovery and self._dirty_shards:
            self.ensure_recovered(keys)
        hi, lo, n, lanes = self._shape_queries(keys)
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, np.uint32)
        f, v, stale, _ = self.search_fn(self.state, hi, lo)
        if self._any(stale[self._row_mask(lanes, n)].any()):
            self._dirty_shards |= self._detect_dirty_shards()
            self.ensure_recovered(keys)
            f, v, stale, _ = self.search_fn(self.state, hi, lo)
        return tuple(self._answers([f, v], n))

    def snap_search_on(self, snap_state, keys):
        """Snapshot probe + in-program verify + recovery audit in one
        exchange pair: (found, vals, changed, stale) host arrays — O(batch)
        answer words, no plane bytes."""
        hi, lo, n, _ = self._shape_queries(keys)
        if n == 0:
            return np.zeros(0, bool), np.zeros(0, np.uint32), np.zeros(0, bool), np.zeros(0, bool)
        f, v, c, s, _ = self.snap_search_fn(snap_state, self.state, hi, lo)
        return tuple(self._answers([f, v, c, s], n))

    @property
    def n_items(self) -> int:
        """Records stored fleet-wide. Collective."""
        return int(self._sum([int(self.state.n_items)])[0])


class ShardFrontend(frontend.FrontendBase):
    """The online-resize frontend over ``DistributedDash``: epoch-guarded
    snapshot reads plus deferred shard SMOs, with the admission lanes,
    batch forming, read-priority scheduler and latency/retry accounting of
    the shared ``FrontendBase``. The scheduler reads no clock, so every
    rank runs the same frontend over the same submitted ops, and its ticks
    are collective; each rank's registry pins a snapshot of its own shard.

    ``verify_mode`` selects the read-tick machinery:

    * ``"device"`` (default) — one exchange pair per read batch: snapshot
      probe, version-plane verify and the lazy-recovery check all run on
      the owners (``snap_search_fn``); only O(batch) answer words reach
      the host. Write ticks run the device-resident retry round with
      shard-local bulk splits deferred to their own ticks.
    * ``"host"`` — the host-mirror baseline: probe, then each owner diffs
      its shard's dir/version planes on the host per query
      (``_changed_mask``, the host mirror of ``serving.engine.
      buckets_changed``), then a retry; insert rounds gather O(batch)
      statuses per round (``insert_once``). Every plane byte copied is
      metered into the ``frontend.host_plane_bytes`` counter.

    Insert + read lanes (the DHT serving surface). Reads also attribute
    their sojourn to the owner shard's registry (``shard_registries``).
    ``stats``, ``obs_snapshot``, ``forensics_report`` and ``try_recover``
    are collective too.
    """

    def __init__(self, dht: DistributedDash, *, max_batch: int = 256,
                 queue_depth: int = 4096, obs=None, verify_mode: str = "device"):
        from repro_torch.obs import Registry
        assert verify_mode in ("device", "host")
        super().__init__(max_batch=max_batch, queue_depth=queue_depth, obs=obs)
        self.dht = dht
        self.verify_mode = verify_mode
        self._dirty = True
        # host-plane-transfer meter: every byte of dir/version plane this
        # rank's verify copies to the host (the device path copies none)
        self._host_plane_bytes = self.obs.registry.scope("frontend").counter(
            "host_plane_bytes")
        # per-shard registries: read-sojourn histograms recorded by owner
        # (host routing, the same on every rank); this rank's pool counters
        # are mirrored into its own shard's registry on export
        self._shard_regs = [Registry() for _ in range(dht.n_shards)]
        self._shard_read_hists = [r.scope("shard").histogram("read_sojourn_s")
                                  for r in self._shard_regs]
        self.shard_degraded_transitions = 0
        self._degraded_prev: set = set()
        self._publish()
        self._pending = None          # in-flight insert batch host state
        self._split_keys = None       # host mode: keys owing a bulk split
        self._split_want = None       # device mode: want mask owing splits

    def _publish(self):
        """Copy-on-write publish of this rank's shard (the version-plane
        diff drives the O(dirty) scatter). With pools attached, every
        publish also flushes each shard into its own pool (flush-on-publish:
        acknowledged DHT ops are durable)."""
        tr = self.obs.tracer
        with tr.span("publish", "epoch") as psp:
            self.registry.publish_cow(self.dht.cfg, self.dht.state)
            self._publishes.inc()
            self._publish_bytes.inc(self.registry.last_publish_bytes)
            if self.dht.writebacks is not None:
                for wb in self.dht.writebacks:
                    if wb.obs is None:
                        wb.attach_obs(self.obs)      # flush spans nest here
                    if wb.recorder is None:
                        # one durable flight recorder per shard pool, fed
                        # by that shard's registry; the span story rides
                        # shard 0's windows (a tracer mirrors into one sink)
                        from repro_torch.obs import FlightRecorder
                        rec = FlightRecorder()
                        rec.attach(tracer=self.obs.tracer if self.dht.rank == 0 else None,
                                   registry=self._shard_regs[self.dht.rank])
                        wb.recorder = rec
                        wb.pool.recorder = rec
                before = sum(w.flushed_bytes for w in self.dht.writebacks)
                self.dht.flush_pools()
                self._flush_bytes.inc(sum(w.flushed_bytes for w in self.dht.writebacks)
                                      - before)
                degraded = set(self.dht.degraded_shards())
                self.shard_degraded_transitions += len(degraded - self._degraded_prev)
                self._degraded_prev = degraded
                if degraded:
                    if self.health == frontend.HEALTHY:
                        self._set_health(frontend.DEGRADED)
                    self.unflushed_publishes += 1
                elif self.health == frontend.DEGRADED:
                    self._set_health(frontend.HEALTHY)
            if psp is not None:
                psp.args["bytes"] = self.registry.last_publish_bytes
        self._dirty = False

    def submit(self, op) -> bool:
        """Reject kinds outside the DHT serving surface at admission time
        (an admitted op must never strand mid-drain)."""
        if op.kind not in (frontend.READ, frontend.INSERT):
            self.writes.rejected += 1
            return False
        return super().submit(op)

    _FLEET_COUNTERS = ("flushes", "flushed_bytes", "flush_io_errors", "degraded_flushes")

    def stats(self) -> dict:
        """``FrontendBase.stats`` (this rank's publishes) plus the fleet's
        shard counters, summed over the ranks. Collective."""
        out = super().stats()
        out["shard_degraded_transitions"] = self.shard_degraded_transitions
        out["recovered_segments"] = self.dht.recovered_segments
        wbs = self.dht.writebacks or []
        local = [self._host_plane_bytes.value]
        local += [sum(getattr(w, k) for w in wbs) for k in self._FLEET_COUNTERS]
        local += [sum(w.pool.plane_bytes for w in wbs),
                  sum(w.pool.sb.lost_records for w in wbs),
                  sum(len(w.pool.sb.lost_bt) for w in wbs),
                  sum(len(w.pool.sb.lost_nb) for w in wbs)]
        fleet = [int(x) for x in self.dht._sum(local)]
        out["host_plane_bytes"] = fleet[0]
        if self.dht.writebacks is not None:
            out.update(zip(self._FLEET_COUNTERS, fleet[1:5]))
            out["pool_bytes"], out["lost_records"] = fleet[5], fleet[6]
            out["quarantined_bt"], out["quarantined_nb"] = fleet[7], fleet[8]
            degraded = self.dht.degraded_shards()
            out["shards_degraded"] = degraded
            out["health"] = frontend.DEGRADED if degraded else frontend.HEALTHY
        return out

    def shard_registries(self) -> list:
        """One ``Registry`` per shard: the per-shard read-sojourn histograms
        plus, for this rank's shard, its pool's cumulative counters."""
        if self.dht.writebacks is not None:
            for wb in self.dht.writebacks:
                self._shard_regs[self.dht.rank].ingest(wb.stats(), prefix="wb.",
                                                       counters=True)
        return list(self._shard_regs)

    def obs_snapshot(self) -> dict:
        from repro_torch.obs import Registry
        self.obs.registry.ingest(self.stats(), prefix="stats.")
        out = self.obs.snapshot()
        regs = self.shard_registries()
        out["shards"] = Registry.aggregate(regs).snapshot()
        out["per_shard"] = [r.snapshot() for r in regs]
        return out

    def _set_health(self, new: str):
        # fleet health transitions stamp every shard's durable recorder
        if new != self.health and self.dht.writebacks is not None:
            for wb in self.dht.writebacks:
                if wb.recorder is not None:
                    wb.recorder.record_health(self.health, new)
        super()._set_health(new)

    # -- durable intent/ack stamps, per owner shard -----------------------

    def _record_shard_intents(self, ops):
        """Stamp this rank's shard recorder with its slice of the batch
        BEFORE flush-on-publish (one await_seq per shard pool)."""
        wbs = self.dht.writebacks
        if wbs is None or all(wb.recorder is None for wb in wbs):
            return None
        keys = np.asarray([op.key for op in ops], np.uint64)
        mine = keys[np_owner_of(keys, self.dht.n_shards) == self.dht.rank]
        wb = wbs[0]
        if wb.recorder is None or not mine.size:
            return []
        aw = wb.pool.sb.flush_seq + 1
        wb.recorder.record_ops(frontend.INSERT, mine, await_seq=aw, shard=self.dht.rank)
        return [(aw, len(mine))]

    def _record_shard_acks(self, stamps):
        for aw, n in stamps or ():
            wb = self.dht.writebacks[0]
            seq = wb.pool.sb.flush_seq
            wb.recorder.record_ack(seq, frontend.INSERT, n, durable=seq >= aw)

    def forensics_report(self) -> dict:
        """Fleet-merged crash forensics over every shard pool
        (obs/forensics.py): raw file reads only. Collective."""
        from repro_torch.obs import forensics
        assert self.dht.writebacks is not None, "no pools attached"
        paths = [None] * self.dht.n_shards
        dist.all_gather_object(paths, self.dht.writebacks[0].pool.path, group=self.dht.group)
        return forensics.merge_reports([forensics.analyze_pool(p) for p in paths])

    def try_recover(self) -> bool:
        """Re-probe degraded shard pools; True when every shard is back
        HEALTHY. Recovery is strictly per shard. Collective."""
        if self.dht.writebacks is None:
            return True
        if self.dht.degraded_shards():
            self.dht.recover_pools()
        ok = not self.dht.degraded_shards()
        if ok:
            self._degraded_prev = set()
            self._set_health(frontend.HEALTHY)
        return ok

    def _write_pending(self) -> bool:
        return (self._pending is not None or self._split_keys is not None
                or self._split_want is not None)

    def _finish_reads(self, ops, found, vals, n_changed: int):
        super()._finish_reads(ops, found, vals, n_changed)
        keys = np.asarray([op.key for op in ops], np.uint64)
        owner = np_owner_of(keys, self.dht.n_shards)
        lats = np.asarray([op.latency for op in ops], np.float64)
        for shard in np.unique(owner):
            self._shard_read_hists[int(shard)].observe_many(lats[owner == shard])

    # -- read path -----------------------------------------------------------

    def _changed_mask(self, snap_state, keys) -> np.ndarray:
        """HOST-MIRROR verify (the ``verify_mode="host"`` baseline and the
        differential reference for the device mask): each owner copies its
        shard's dir + version planes to the host and diffs them per query
        it owns — the contract of serving.engine.buckets_changed — and the
        masks are combined over the group. Every plane byte copied is
        metered into ``host_plane_bytes``. Collective."""
        cfg = self.dht.cfg
        keys = np.asarray(keys, np.uint64)
        hi, lo = hashing.np_split_keys(keys)
        h1 = hashing.np_hash1(hi, lo)
        mine = np_owner_of(keys, self.dht.n_shards) == self.dht.rank
        d = (h1 >> np.uint32(32 - cfg.dir_depth_max)).astype(np.int64)[mine]
        old_dir, new_dir = snap_state.dir.cpu().numpy(), self.dht.state.dir.cpu().numpy()
        oldv = snap_state.version.cpu().numpy()
        newv = self.dht.state.version.cpu().numpy()
        self._host_plane_bytes.inc(old_dir.nbytes + new_dir.nbytes + oldv.nbytes
                                   + newv.nbytes)
        seg = old_dir[d].astype(np.int64)
        changed = seg != new_dir[d]
        NB = cfg.num_buckets
        b = (h1[mine] & np.uint32(NB - 1)).astype(np.int64)
        for w in range(cfg.probe_window):
            bw = (b + w) & (NB - 1)
            changed |= oldv[seg, bw] != newv[seg, bw]
        for s in range(cfg.num_stash):
            changed |= oldv[seg, NB + s] != newv[seg, NB + s]
        fleet = np.zeros(keys.size, np.int64)
        fleet[mine] = changed
        return self.dht._sum(fleet) > 0

    def _serve_reads(self, ops):
        keys = np.asarray([op.key for op in ops], np.uint64)
        if self.dht.lazy_recovery and self.dht._dirty_shards:
            # per-access recovery BEFORE pinning: recovered segments bump
            # their version words, so the verify below redirects any query
            # that probes them to the (recovered) live state
            if self.dht.ensure_recovered(keys):
                self._dirty = True
        if self.verify_mode == "host":
            with self.registry.acquire() as snap:
                found, vals = self.dht.search_on(snap.state, keys)
                n_changed = 0
                if self._dirty:
                    changed = self._changed_mask(snap.state, keys)
                    n_changed = int(changed.sum())
                if n_changed:
                    f2, v2 = self.dht.search(keys)
                    found = np.where(changed, f2, found)
                    vals = np.where(changed, v2, vals)
            self._finish_reads(ops, found, vals, n_changed)
            return
        with self.registry.acquire() as snap:
            found, vals, changed, stale = self.dht.snap_search_on(snap.state, keys)
            changed = changed | stale
            n_changed = int(changed.sum())
            if n_changed:
                f2, v2 = self.dht.search(keys)
                found = np.where(changed, f2, found)
                vals = np.where(changed, v2, vals)
        self._finish_reads(ops, found, vals, n_changed)

    # -- write path ----------------------------------------------------------

    def _pump_write(self) -> bool:
        if self.verify_mode == "host":
            return self._pump_write_host()
        if self._split_want is not None and self._pending is not None:
            # the deferred storm: every pressured owner splits all its
            # pressured segments in one bulk call
            ops, keys, vals, hi, lo, v, pend, out, rounds = self._pending
            self.dht._dispatch_splits(hi, lo, self._split_want, keys)
            self._split_want = None
            self._dirty = True
            self._publish()
            return True
        if self._pending is not None:
            ops, keys, vals, hi, lo, v, pend, out, rounds = self._pending
            if rounds > 32:
                raise RuntimeError("dht insert retry budget exhausted")
            out, pend, need, fl = self.dht.insert_round_fn(self.dht.state, hi, lo, v,
                                                           pend, out)
            self._dirty = True
            if fl[2]:
                self.dht._dirty_shards |= self.dht._detect_dirty_shards()
                self.dht.ensure_recovered(keys)
            if fl[1]:
                self._split_want = need
            if not fl[0]:
                aw = self._record_shard_intents(ops)
                self._finish_writes(ops, self.dht._gather_rows(out)[:keys.size])
                self._pending = None
                self._split_want = None
                self._publish()
                self._record_shard_acks(aw)
            else:
                self._pending = (ops, keys, vals, hi, lo, v, pend, out, rounds + 1)
            return True
        ops = self.former.form(self.writes)
        if not ops:
            return False
        assert ops[0].kind == frontend.INSERT, "shard frontend lanes cover read + insert"
        keys = np.asarray([op.key for op in ops], np.uint64)
        vals = np.asarray([op.value for op in ops], np.uint32)
        if self.dht.lazy_recovery and self.dht._dirty_shards:
            if self.dht.ensure_recovered(keys):
                self._dirty = True
        hi, lo, n, lanes = self.dht._shape_queries(keys)
        v = self.dht._row_values(vals, lanes)
        pend = self.dht._row_mask(lanes, n)
        out = torch.full(hi.shape, DROPPED, dtype=torch.int32, device=self.dht.device)
        self._pending = (ops, keys, vals, hi, lo, v, pend, out, 0)
        return self._pump_write()

    def _pump_write_host(self) -> bool:
        """The host-sync write tick (``verify_mode="host"``): one
        ``insert_once`` per round with O(batch) statuses gathered, and
        pressured shards split through the host loop. (The split plan is
        the device path's, so both modes land bit-identical states.)"""
        if self._split_keys is not None:
            self.dht._split_for_host(self._split_keys)
            self._split_keys = None
            self._dirty = True
            self._publish()
            return True
        if self._pending is not None:
            keys, vals, out, pending, ops, rounds = self._pending
            if rounds > 32:
                raise RuntimeError("dht insert retry budget exhausted")
            statuses = self.dht.insert_once(keys[pending], vals[pending])
            self._dirty = True
            out[pending] = statuses
            need = statuses == NEED_SPLIT
            retry = need | (statuses == DROPPED)
            if not retry.any():
                aw = self._record_shard_intents(ops)
                self._finish_writes(ops, out)
                self._pending = None
                self._publish()
                self._record_shard_acks(aw)
            else:
                if need.any():
                    self._split_keys = keys[pending[need]]
                self._pending = (keys, vals, out, pending[retry], ops, rounds + 1)
            return True
        ops = self.former.form(self.writes)
        if not ops:
            return False
        assert ops[0].kind == frontend.INSERT, "shard frontend lanes cover read + insert"
        keys = np.asarray([op.key for op in ops], np.uint64)
        vals = np.asarray([op.value for op in ops], np.uint32)
        if self.dht.lazy_recovery and self.dht._dirty_shards:
            if self.dht.ensure_recovered(keys):
                self._dirty = True
        self._pending = (keys, vals, np.full(keys.size, DROPPED, np.int32),
                         np.arange(keys.size), ops, 0)
        return self._pump_write_host()
