"""Device-parallel SMO engine: vectorized segment rebuild + bulk SMOs.

Ported from ``repro.core.smo``. A splitting segment's records are
extracted once, partitioned by move-bit, and placed in one pass: target
buckets and intra-bucket ranks come from the shared sort-based dispatcher
(``kernels/ops.group_ranks``), balanced-insert capacity is solved by a
carry recurrence over the bucket ring (the EDF schedule of the two-choice
b/b+1 placement), and the leftover goes to the stash with overflow metadata
rebuilt as one more rank/scatter. A rebuild that does not fit is not
committed; the caller falls back to the scan rehash for that segment.

The reference ``vmap``s the rebuild over the K splits of one pressure
round; here the K splits are a leading batch axis and every group id is
offset by its split, so one sort ranks all of them. All K splits publish
one directory update, computed from an (S,) old-segment -> split lookup
rather than a (K, dir_size) mask. The same rebuild serves EH splits
(``bulk_split``), LH stride expansion (``bulk_split_next``), buddy merges
(``bulk_merge``, directory published from an (S,) victim -> keep lookup)
and the crash-recovery redo (``check_unique=True``). Planes are updated
IN PLACE.
"""
from __future__ import annotations

import numpy as np
import torch

from . import engine, hashing, layout
from .layout import (SEG_NEW, SEG_NORMAL, SEG_SPLITTING, DashConfig,
                     DashState, u32, word)


def rebuild_eligible(cfg: DashConfig) -> bool:
    """Configs the one-pass rebuild covers exactly: the balanced b/(b+1)
    two-choice layout, or probe windows the single-spill schedule spans."""
    return cfg.use_balanced or cfg.probe_len <= 2


def _ranks(gid, groups: int):
    """Per-split ranks of (K, N) group ids in [0, groups)."""
    from repro_torch.kernels import ops
    K, N = gid.shape
    off = torch.arange(K, device=gid.device)[:, None] * groups
    return ops.group_ranks((gid + off).reshape(-1)).reshape(K, N)


def _counts(gid, groups: int):
    """(K, groups) histogram of (K, N) group ids."""
    out = torch.zeros((gid.shape[0], groups), dtype=torch.int64, device=gid.device)
    return out.scatter_add_(1, gid, torch.ones_like(gid))


def _scatter(idx, x, size: int, dtype, reduce_add: bool = False):
    """(K, size) buffer with ``x`` stored (or summed) at per-split ``idx``;
    column ``size - 1`` is the trash the callers drop. A store sends each
    trashed item to a trash column of its own, so no two items store to one
    element (duplicate stores are nondeterministic on CUDA)."""
    K, N = idx.shape
    if reduce_add:
        buf = torch.zeros((K, size), dtype=dtype, device=idx.device)
        return buf.scatter_add_(1, idx, x.to(dtype))
    buf = torch.zeros((K, size - 1 + N), dtype=dtype, device=idx.device)
    own = size - 1 + torch.arange(N, device=idx.device)
    buf.scatter_(1, torch.where(idx >= size - 1, own, idx), x.to(dtype))
    return buf[:, :size]


def dedupe_records(hi, lo, valid):
    """Drop all-but-first copies of duplicate (hi, lo) keys in each row of
    (K, N) records (recovery redo). Lex sort by (valid desc, hi, lo);
    duplicates are adjacent. Returns the pruned valid mask."""
    order = torch.argsort(lo, dim=-1, stable=True)
    order = order.gather(-1, torch.argsort(hi.gather(-1, order), dim=-1, stable=True))
    order = order.gather(-1, torch.argsort(
        (~valid.gather(-1, order)).to(torch.uint8), dim=-1, stable=True))
    hi_s, lo_s, v_s = hi.gather(-1, order), lo.gather(-1, order), valid.gather(-1, order)
    dup = torch.zeros_like(v_s)
    dup[:, 1:] = ((hi_s[:, 1:] == hi_s[:, :-1]) & (lo_s[:, 1:] == lo_s[:, :-1])
                  & v_s[:, 1:] & v_s[:, :-1])
    return torch.zeros_like(valid).scatter_(-1, order, v_s & ~dup)


def rebuild_records(cfg: DashConfig, T: int, stash_base: int,
                    hi, lo, val, valid, fpv, b, tgt):
    """Place the (K, N) records of K splits into K x T fresh segment images.

    ``b`` is each record's home bucket, ``tgt`` its target image in [0, T).
    Placement = EDF over the two-choice (b, b+1) ring; the remainder ranks
    into the stash, and overflow metadata is rebuilt by one more grouped
    rank. Returns (planes, stash_active (K, T), ok (K,)); ``ok`` is False iff
    some record of that split did not fit (its planes must not commit)."""
    NB, SL, BT, NS = (cfg.num_buckets, cfg.num_slots, cfg.buckets_total,
                      cfg.num_stash)
    K = hi.shape[0]
    spill = cfg.probe_window >= 2
    dev = hi.device

    valid = valid & (tgt >= 0) & (tgt < T)
    tgt_c = tgt.clamp(0, T - 1)
    gid = torch.where(valid, tgt_c * NB + b, T * NB)
    r = _ranks(gid, T * NB + 1)
    cnt = _counts(gid, T * NB + 1)[:, :-1].reshape(K, T, NB)

    # carry recurrence around the bucket ring: o' = max(0, cnt - SL + min(o, SL)).
    # Two laps resolve the cyclic wrap; a non-converged carry only leaves
    # alloc-bitmap holes / extra stash spill — never a wrong placement.
    if spill:
        def lap(o):
            seen = []
            for i in range(NB):
                seen.append(o)
                o = (cnt[..., i] - SL + o.clamp(max=SL)).clamp(min=0)
            return o, torch.stack(seen, -1)
        o_wrap, _ = lap(torch.zeros((K, T), dtype=torch.int64, device=dev))
        _, o_in = lap(o_wrap)
        s_in = o_in.clamp(max=SL)                # (K, T, NB) spill-in allotment
    else:
        s_in = torch.zeros((K, T, NB), dtype=torch.int64, device=dev)
    h = torch.minimum(cnt, SL - s_in)            # home placements per bucket

    def at(x, bucket):                           # x[k, tgt_c, bucket] per record
        return x.reshape(K, T * NB).gather(1, tgt_c * NB + bucket)

    pb = (b + 1) & (NB - 1)
    h_b = at(h, b)
    in_home = valid & (r < h_b)
    in_spill = (valid & ~in_home & (r - h_b < at(s_in, pb))) if spill \
        else torch.zeros_like(valid)
    # home records sit after the spill-in block: slots [s_in[b], s_in[b]+h[b])
    dst_b = torch.where(in_home, b, pb)
    dst_s = torch.where(in_home, at(s_in, b) + r, r - h_b)
    placed = in_home | in_spill

    rest = valid & ~placed
    if NS > 0:
        sgid = torch.where(rest, tgt_c, T)
        sr = _ranks(sgid, T + 1)
        in_stash = rest & (sr < NS * SL)
        dst_b = torch.where(in_stash, NB + sr // SL, dst_b)
        dst_s = torch.where(in_stash, sr % SL, dst_s)
        placed = placed | in_stash
        stash_tot = _counts(sgid, T + 1)[:, :-1]
    else:
        in_stash = torch.zeros_like(valid)
        sr = torch.zeros_like(r)
        stash_tot = torch.zeros((K, T), dtype=torch.int64, device=dev)
    ok = ~(valid & ~placed).any(1)

    # ---- scatter the record planes -----------------------------------------
    TBS = T * BT * SL
    flat = torch.where(placed, (tgt_c * BT + dst_b) * SL + dst_s, TBS)

    def scat(x, dtype):
        return _scatter(flat, x, TBS + 1, dtype)[:, :-1].reshape(K, T, BT, SL)

    p_hi, p_lo, p_val = (scat(x, torch.int32) for x in (hi, lo, val))
    p_fp = torch.zeros((K, T, BT, 16), dtype=torch.uint8, device=dev)
    p_fp[..., :SL] = scat(fpv, torch.uint8)

    bgid = torch.where(placed, tgt_c * BT + dst_b, T * BT)
    slot_bit = torch.ones_like(dst_s) << dst_s.clamp(0, SL - 1)
    member = in_spill if cfg.use_balanced else torch.zeros_like(in_spill)

    def per_bucket(x, idx=bgid):
        return _scatter(idx, x, T * BT + 1, torch.int64, True)[:, :-1]

    alloc = per_bucket(slot_bit)
    memb = per_bucket(slot_bit, torch.where(member, bgid, T * BT))
    count = per_bucket(torch.ones_like(bgid))
    p_meta = layout.meta_pack(alloc, memb, count).reshape(K, T, BT)

    # ---- overflow metadata (Sec. 4.3): home-bucket ofp slots first, the
    # remainder is carried by the overflow counter (search's scan-all path)
    if NS > 0 and cfg.num_ofp > 0 and cfg.use_overflow_meta:
        TNB = T * NB
        ogid = torch.where(in_stash, tgt_c * NB + b, TNB)
        orank = _ranks(ogid, TNB + 1)
        ocnt = _counts(ogid, TNB + 1)[:, :-1]
        in_ofp = in_stash & (orank < cfg.num_ofp)
        oidx = torch.where(in_ofp, (tgt_c * NB + b) * 4 + orank, TNB * 4)
        p_ofp = _scatter(oidx, fpv, TNB * 4 + 1, torch.uint8)[:, :-1].reshape(K, T, NB, 4)
        ofp_alloc = (torch.ones_like(ocnt) << ocnt.clamp(max=cfg.num_ofp)) - 1
        sidx = (sr // SL) & 0x3
        shift = layout.SIDX_SHIFT + 2 * orank.clamp(0, 3)
        sbits = _scatter(torch.where(in_ofp, tgt_c * NB + b, TNB), sidx << shift,
                         TNB + 1, torch.int64, True)[:, :-1]
        extra = (ocnt - cfg.num_ofp).clamp(min=0)
        p_ometa = word((ofp_alloc << layout.OFPA_SHIFT) | sbits
                       | ((extra & 0x7F) << layout.OVFC_SHIFT)
                       | ((ocnt > 0).long() << layout.OVFB_SHIFT)).reshape(K, T, NB)
    else:
        p_ofp = torch.zeros((K, T, NB, 4), dtype=torch.uint8, device=dev)
        p_ometa = torch.zeros((K, T, NB), dtype=torch.int32, device=dev)

    active = torch.clamp((stash_tot + SL - 1) // SL, min=stash_base)
    planes = dict(key_hi=p_hi, key_lo=p_lo, val=p_val, fp=p_fp,
                  meta=p_meta, ometa=p_ometa, ofp=p_ofp)
    return planes, active, ok


def _extract(cfg: DashConfig, state: DashState, segs):
    """Records of each segment in ``segs`` (K,): (hi, lo, val, valid), each
    (K, BT*SL) — the batched twin of engine.segment_records."""
    sc = segs.long().clamp(0, cfg.max_segments - 1)
    K = sc.shape[0]
    alloc = layout.meta_alloc(state.meta[sc])
    slot_ids = torch.arange(cfg.num_slots, device=sc.device)
    valid = (((alloc[..., None] >> slot_ids) & 1) == 1).reshape(K, -1)
    return (state.key_hi[sc].reshape(K, -1), state.key_lo[sc].reshape(K, -1),
            state.val[sc].reshape(K, -1), valid)


_RECORD_PLANES = ("key_hi", "key_lo", "val", "fp", "meta", "ometa", "ofp")


def _scatter_planes(cfg: DashConfig, state: DashState, dst, planes):
    """Write rebuilt (M, ...) segment images at segment ids ``dst`` (M,) in
    place and bump every rebuilt row's version; ids outside [0, S) (masked-
    out SMOs) are dropped."""
    keep = ((dst >= 0) & (dst < cfg.max_segments)).nonzero()[:, 0]
    d = dst[keep].long()
    for name in _RECORD_PLANES:
        getattr(state, name)[d] = planes[name][keep]
    state.version[d] = word(u32(state.version[d]) + 2)


def _set_where(plane, idx, value, mask):
    """``plane[idx[mask]] = value[mask]`` (dropped scatter of the reference)."""
    keep = mask.nonzero()[:, 0]
    plane[idx[keep].long()] = (value[keep] if torch.is_tensor(value)
                               and value.dim() else value)


# ---------------------------------------------------------------------------
# bulk EH split (phase 1 + phase 2, K segments per dispatch)
# ---------------------------------------------------------------------------

def bulk_split_phase1(cfg: DashConfig, state: DashState, old, new, valid):
    """Allocate + initialize + link all K new segments (paper Sec. 4.7 step
    1, vectorized), in place. ``valid`` masks padding lanes."""
    S = cfg.max_segments
    oc = old.long().clamp(0, S - 1)
    ld = state.local_depth[oc].clone()
    side_old = state.side_link[oc].clone()
    _set_where(state.seg_state, old, SEG_SPLITTING, valid)
    _set_where(state.seg_state, new, SEG_NEW, valid)
    _set_where(state.side_link, new, side_old, valid)
    _set_where(state.side_link, old, new.to(torch.int32), valid)
    _set_where(state.local_depth, old, ld + 1, valid)
    _set_where(state.local_depth, new, ld + 1, valid)
    _set_where(state.seg_version, new, state.gver.expand(new.shape), valid)
    _set_where(state.stash_active, new, cfg.num_stash, valid)
    top = torch.where(valid, new.long(), -1).max() + 1 if new.numel() else -1
    state.watermark.copy_(torch.maximum(state.watermark, torch.as_tensor(
        top, dtype=torch.int32, device=state.watermark.device)))
    return state


def bulk_split_phase2(cfg: DashConfig, state: DashState, old, new, valid,
                      check_unique: bool = False):
    """Rebuild + single directory publish for K splits, in place. With
    ``check_unique=True`` (recovery redo) both halves are extracted and
    deduped first. Returns (state, ok (K,)); a False lane was NOT committed
    (its source segment is untouched, still SPLITTING — the host falls back
    to the scan rehash for it)."""
    S = cfg.max_segments
    K = old.shape[0]
    if K == 0:
        return state, valid
    oc = old.long().clamp(0, S - 1)
    ld_new = state.local_depth[oc].long()

    hi, lo, val, vmask = _extract(cfg, state, old)
    if check_unique:
        more = _extract(cfg, state, new)
        hi, lo, val, vmask = (torch.cat([x, y], 1)
                              for x, y in zip((hi, lo, val, vmask), more))
        vmask = dedupe_records(hi, lo, vmask)

    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    tgt = (u32(h1) >> (32 - ld_new[:, None])) & 1
    b = layout.bucket_index(cfg, h1)
    fpv = hashing.fingerprint(h2)
    planes, active, ok = rebuild_records(cfg, 2, cfg.num_stash, hi, lo, val,
                                         vmask, fpv, b, tgt)

    commit = valid & ok
    dst = torch.where(commit[:, None], torch.stack([old, new], 1).long(), S).reshape(-1)
    _scatter_planes(cfg, state, dst,
                    {k: v.reshape((2 * K,) + v.shape[2:]) for k, v in planes.items()})

    # single directory publish: among entries owned by old[k], the half whose
    # (ld+1)-th MSB is 1 now points at new[k]. split_of[seg] is the first
    # committed lane splitting seg (K = none).
    split_of = torch.full((S + 1,), K, dtype=torch.int64, device=oc.device)
    split_of.scatter_reduce_(0, torch.where(commit, oc, S),
                             torch.arange(K, device=oc.device), "amin")
    k = split_of[state.dir.long()]
    kc = k.clamp(max=K - 1)
    idx = torch.arange(cfg.dir_size, device=oc.device)
    bit = (idx >> (cfg.dir_depth_max - ld_new[kc])) & 1
    state.dir.copy_(torch.where((k < K) & (bit == 1), new[kc].to(torch.int32),
                                state.dir))

    gd = state.global_depth
    mx = torch.where(commit, ld_new, 0).max().to(torch.int32)
    state.n_doublings.add_((mx - gd).clamp(min=0))
    state.global_depth.copy_(torch.maximum(gd, mx))
    state.n_splits.add_(commit.sum().to(torch.int32))
    _set_where(state.seg_state, old, SEG_NORMAL, commit)
    _set_where(state.seg_state, new, SEG_NORMAL, commit)
    live = (dst < S).nonzero()[:, 0]
    state.seg_version[dst[live]] = state.gver
    state.stash_active[dst[live]] = active.reshape(-1)[live].to(torch.int32)
    return state, ok | ~valid


#: the reference's names of the unjitted bodies its DHT runs per shard: the
#: two phases here already are those bodies
bulk_split_phase1_local = bulk_split_phase1
bulk_split_phase2_local = bulk_split_phase2


# ---------------------------------------------------------------------------
# shard-local split planning (the DHT's split program)
# ---------------------------------------------------------------------------

def plan_local_splits(cfg: DashConfig, state: DashState, h1, want, k_max: int):
    """Plan up to ``k_max`` segment splits from pressured keys on the
    state's device, without a host sync: ``h1`` (N,) are the hash1 words
    of this shard's keys, ``want`` (N,) the lanes demanding a split. Their
    directory targets are deduped to unique segment ids (ascending), fresh
    ids are assigned off the watermark, and resource exhaustion comes back
    as flags instead of a partial plan. Returns ``(old, new, valid,
    depth_bad, pool_bad)``, the first three (k_max,); surplus pressured
    segments stay NEED_SPLIT and are planned next round."""
    S = cfg.max_segments
    dev = h1.device
    seg = torch.where(want, state.dir[layout.dir_index(cfg, h1)].long(), S)
    seg_sorted = torch.sort(seg).values
    first = torch.ones_like(seg_sorted, dtype=torch.bool)
    first[1:] = seg_sorted[1:] != seg_sorted[:-1]
    uniq = first & (seg_sorted < S)
    pos = torch.cumsum(uniq.long(), 0) - 1
    take = uniq & (pos < k_max)
    old = torch.full((k_max + seg_sorted.numel(),), -1, dtype=torch.int64, device=dev)
    # a lane outside the plan stores into a trash slot of its own
    trash = k_max + torch.arange(seg_sorted.numel(), device=dev)
    old[torch.where(take, pos, trash)] = seg_sorted
    old = old[:k_max]
    valid = old >= 0
    k = valid.sum()
    new = torch.where(valid, state.watermark.long() + torch.cumsum(valid.long(), 0) - 1, -1)
    depth_bad = (valid & (state.local_depth[old.clamp(0, S - 1)] >= cfg.dir_depth_max)).any()
    pool_bad = state.watermark.long() + k > S
    return old.int(), new.int(), valid, depth_bad, pool_bad


def split_segments_local(cfg: DashConfig, state: DashState, old, new, valid):
    """Phase 1 + phase 2 of a bulk split on one shard's state, in place, as
    the DHT's split program runs them. Returns ``(state, ok (K,))`` with
    phase 2's semantics for False lanes (source still SPLITTING; the host
    repairs it by the scan rehash)."""
    state = bulk_split_phase1(cfg, state, old, new, valid)
    return bulk_split_phase2(cfg, state, old, new, valid, False)


class BulkSplitTask:
    """Staged EH bulk split: PHASE1 -> PHASE2 -> COMMIT, one stage per
    ``pump`` call. Run to completion it is exactly ``bulk_split``. Only the
    COMMIT stage reads device results (the ok mask -> scan-rehash fallback
    for infeasible packings).

    ``shortfall`` records how many pressured segments the caller could not
    allocate ids for (pool exhausted); the caller raises after commit so the
    feasible splits still land."""

    def __init__(self, cfg: DashConfig, old_ids, new_ids, device,
                 check_unique: bool = False, shortfall: int = 0):
        self.cfg = cfg
        self.old_np = np.asarray(old_ids, np.int32).reshape(-1)
        self.new_np = np.asarray(new_ids, np.int32).reshape(-1)
        self.old = torch.from_numpy(self.old_np).to(device)
        self.new = torch.from_numpy(self.new_np).to(device)
        self.valid = torch.ones(self.old_np.size, dtype=torch.bool, device=device)
        self.check_unique = check_unique
        self.shortfall = shortfall
        self.n_committed = self.old_np.size
        self._ok = None
        self.stage = "phase1"

    def describe(self) -> dict:
        """Span args of the serving frontend's ``smo`` span: what this SMO
        does, sized."""
        return {"kind": "eh_bulk_split", "segments": int(self.old_np.size),
                "shortfall": int(self.shortfall)}

    @property
    def touched(self) -> np.ndarray:
        """Segment ids this task rebuilds (source + target of every lane)."""
        return np.concatenate([self.old_np, self.new_np])

    def pump(self, state: DashState):
        """Advance one stage. Returns (state, done)."""
        from . import dash_eh
        if self.stage == "phase1":
            state = bulk_split_phase1(self.cfg, state, self.old, self.new,
                                      self.valid)
            self.stage = "phase2"
            return state, False
        if self.stage == "phase2":
            state, self._ok = bulk_split_phase2(
                self.cfg, state, self.old, self.new, self.valid,
                self.check_unique)
            self.stage = "commit"
            return state, False
        if self.stage != "commit":
            raise RuntimeError(f"task already {self.stage}")
        fail = np.nonzero(~self._ok.cpu().numpy())[0]
        if fail.size:
            state, fit = dash_eh.split_phase2_scan_many(
                self.cfg, state, self.old_np[fail], self.new_np[fail],
                self.check_unique)
            if not fit:
                raise AssertionError("split rehash failed to refit records")
        self.stage = "done"
        return state, True


def bulk_split(cfg: DashConfig, state: DashState, old_ids, new_ids,
               check_unique: bool = False):
    """Phase 1 + phase 2 for K splits, with scan-rehash fallback for any
    lane the rebuild could not fit. Returns (state, n_committed)."""
    task = BulkSplitTask(cfg, old_ids, new_ids, state.dir.device,
                         check_unique=check_unique)
    done = False
    while not done:
        state, done = task.pump(state)
    return state, task.n_committed


# ---------------------------------------------------------------------------
# bulk LH round expansion (hybrid-expansion stride, Sec. 5.2/5.3)
# ---------------------------------------------------------------------------

class BulkSplitNextTask:
    """Staged LH stride expansion: DISPATCH (``bulk_split_next``) -> COMMIT
    (ok read + scan-rehash fallbacks). ``R`` must respect the round and
    pool bounds (``DashLH.make_smo_task`` plans it); ``touched`` is the
    dirty footprint (the split sources and the new physical ids)."""

    def __init__(self, cfg: DashConfig, R: int, touched=None):
        self.cfg = cfg
        self.R = R
        self.shortfall = 0       # the plan never falls short: R fits the pool
        self._ok = None
        self._old_phys = None
        self.stage = "dispatch"
        self.touched = np.zeros(0, np.int32) if touched is None \
            else np.asarray(touched, np.int32).reshape(-1)

    def describe(self) -> dict:
        """Span args of the serving frontend's ``smo`` span."""
        return {"kind": "lh_split_next", "stride": int(self.R)}

    def pump(self, state: DashState):
        """Advance one stage. Returns (state, done)."""
        from . import dash_lh
        if self.stage == "dispatch":
            state, self._ok, self._old_phys = bulk_split_next(self.cfg, state, self.R)
            self.stage = "commit"
            return state, False
        if self.stage != "commit":
            raise RuntimeError(f"task already {self.stage}")
        ok = self._ok.cpu().numpy()
        if not ok.all():
            old_phys = self._old_phys.cpu().numpy()
            for i in np.nonzero(~ok)[0]:
                state, ok1 = dash_lh.rehash_segment_scan(self.cfg, state, int(old_phys[i]))
                if not ok1:
                    raise AssertionError("LH split rehash failed to refit records")
        self.stage = "done"
        return state, True


def bulk_split_next(cfg: DashConfig, state: DashState, R: int):
    """Split the R segments at Next..Next+R-1 at once and advance the packed
    (level, Next) word once, in place — the hybrid-expansion analog of
    allocating a whole segment-array stride. The caller guarantees R does
    not cross a round boundary and the pool holds R new segments. Returns
    (state, ok (R,), old_phys (R,)); a False lane was not rebuilt (the
    caller rehashes it by scan)."""
    S = cfg.max_segments
    dev = state.dir.device
    level, nxt = (int(x) for x in layout.lh_level_next(state.lh_word))
    round_size = (1 << cfg.lh_base_log2) << level
    lanes = torch.arange(R, device=dev)
    old_phys = state.lh_dir[nxt + lanes]
    new_phys = state.watermark + lanes
    base = min(cfg.num_stash, cfg.lh_base_stash)

    # advance the packed word FIRST (the atomic publish of Sec. 5.3); the
    # stash base reset is unconditional, matching split_next_scan — a failed
    # lane must not keep its elevated stash_active (the scan fallback
    # re-activates as it rehashes)
    wrap = nxt + R >= round_size
    state.lh_word.copy_(layout.lh_pack(torch.tensor(level + wrap),
                                       torch.tensor(0 if wrap else nxt + R)))
    state.lh_dir[round_size + nxt + lanes] = new_phys.to(torch.int32)
    state.watermark.add_(R)
    state.seg_version[new_phys] = state.gver
    state.stash_active[old_phys.long()] = base
    state.stash_active[new_phys] = base

    hi, lo, val, vmask = _extract(cfg, state, old_phys)
    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    tgt = (u32(h1) >> (cfg.lh_base_log2 + level)) & 1
    b = layout.lh_bucket_index(cfg, h1)
    fpv = hashing.fingerprint(h2)
    planes, active, ok = rebuild_records(cfg, 2, base, hi, lo, val, vmask, fpv, b, tgt)

    dst = torch.where(ok[:, None], torch.stack([old_phys.long(), new_phys], 1),
                      S).reshape(-1)
    _scatter_planes(cfg, state, dst,
                    {k: v.reshape((2 * R,) + v.shape[2:]) for k, v in planes.items()})
    live = (dst < S).nonzero()[:, 0]
    state.stash_active[dst[live]] = active.reshape(-1)[live].to(torch.int32)
    state.n_splits.add_(R)
    return state, ok, old_phys


# ---------------------------------------------------------------------------
# bulk buddy merge (shrink SMO of Sec. 4.7)
# ---------------------------------------------------------------------------

def bulk_merge(cfg: DashConfig, state: DashState, keep, victim, valid):
    """Merge K disjoint buddy pairs at once, in place: both segments'
    records rebuild into ``keep``, the victim planes are cleared, and all
    directory updates publish together. Returns (state, ok (K,)); a False
    lane was not committed (the caller falls back to the scan merge)."""
    S = cfg.max_segments
    K = keep.shape[0]
    if K == 0:
        return state, valid
    kc, vc = keep.long().clamp(0, S - 1), victim.long().clamp(0, S - 1)
    hi, lo, val, vmask = (torch.cat([x, y], 1) for x, y in
                          zip(_extract(cfg, state, keep), _extract(cfg, state, victim)))
    h1, h2 = engine.record_hashes(cfg, state, hi, lo)
    planes, active, ok = rebuild_records(
        cfg, 1, cfg.num_stash, hi, lo, val, vmask, hashing.fingerprint(h2),
        layout.bucket_index(cfg, h1), torch.zeros_like(h1, dtype=torch.int64))

    commit = valid & ok
    dk = torch.where(commit, kc, S)
    dv = torch.where(commit, vc, S)
    _scatter_planes(cfg, state, dk, {k: v[:, 0] for k, v in planes.items()})
    _scatter_planes(cfg, state, dv, {
        name: torch.zeros((K,) + getattr(state, name).shape[1:],
                          dtype=getattr(state, name).dtype, device=kc.device)
        for name in _RECORD_PLANES})

    ld = state.local_depth[kc] - 1
    side_v = state.side_link[vc].clone()
    # single directory publish: lane_of[victim] is the first committed lane
    # merging that victim (K = none)
    lane_of = torch.full((S + 1,), K, dtype=torch.int64, device=kc.device)
    lane_of.scatter_reduce_(0, dv, torch.arange(K, device=kc.device), "amin")
    k = lane_of[state.dir.long()]
    state.dir.copy_(torch.where(k < K, keep[k.clamp(max=K - 1)].to(torch.int32),
                                state.dir))
    _set_where(state.local_depth, kc, ld, commit)
    _set_where(state.side_link, kc, side_v, commit)
    _set_where(state.seg_state, vc, SEG_NORMAL, commit)
    _set_where(state.stash_active, kc, active[:, 0].to(torch.int32), commit)
    return state, ok | ~valid


def segment_record_set(cfg: DashConfig, state: DashState, seg: int):
    """Sorted (hi, lo, val) uint32 tuples of one segment's live records —
    the SMO engine's logical-equivalence contract (slot layout may differ
    between the rebuild and the scan; the record set must not)."""
    hi, lo, val, valid = engine.segment_records(cfg, state, seg)
    cols = [u32(x[valid]).tolist() for x in (hi, lo, val)]
    return sorted(zip(*cols))


# ---------------------------------------------------------------------------
# host-side planning: vectorized buddy-pair scan
# ---------------------------------------------------------------------------

def find_buddy_pairs(cfg: DashConfig, dirv: np.ndarray, depths: np.ndarray):
    """All mergeable buddy pairs in one vectorized pass over the directory
    (numpy). A segment's buddy owns the sibling prefix at the same local
    depth; under MSB indexing both ranges are adjacent, so one
    ``np.unique`` over the directory + one gather finds every pair. Pairs
    are disjoint. Returns an (M, 2) int array of [seg, buddy], seg < buddy.
    """
    segs, first_idx = np.unique(dirv, return_index=True)
    ld = depths[segs]
    shift = cfg.dir_depth_max - ld
    prefix = first_idx >> shift
    sib_first = (prefix ^ 1) << shift
    buddy = dirv[np.clip(sib_first, 0, dirv.size - 1)]
    good = (ld > 0) & (buddy != segs) & (depths[buddy] == ld)
    pairs = np.stack([segs[good], buddy[good]], axis=1)
    return pairs[pairs[:, 0] < pairs[:, 1]]        # dedupe symmetric pairs
