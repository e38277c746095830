"""Per-key Dash operations and the segment-parallel batched engine (PyTorch).

The paper's Algorithm 1 (insert with bucket load balancing), Algorithm 3
(search) and the delete procedure (Sec. 4.6), ported from
``repro.core.engine``. Every operation here works on (L,) lane vectors:

  - **reads** (``probe_in_segment``, the ``vmap`` search) take any lanes;
  - **writes** (``_insert_core``, ``delete_in_segment``,
    ``update_in_segment``) take at most one lane per segment and update
    the state's planes IN PLACE. Each insert computes its decision code
    (exists > plain > displace A > displace B > stash > split) for all
    lanes first, then applies each branch of Alg. 1 as masked
    single-element scatters — the reference's ``lax.switch`` branches,
    without copying a plane per lane.

Batching and parallelism follow the reference: a segment is the unit of
parallelism and a batch the unit of consistency. ``batching="segment"``
routes a write batch by segment (``kernels/ops.route_writes``) and steps
through the lanes of every segment together, one lane per segment per step
(``_segment_parallel``); the routing sort is stable, so the result equals
the sequential ``batching="scan"`` engine, which runs one key per step and
is the CPU oracle. Reads default to the fingerprint kernel path
(``kernels/ops.probe_direct``); ``"vmap"`` is the per-key path.

The entry points return ``(state, ...)`` like the reference; the returned
state is the one passed in, updated in place.
"""
from __future__ import annotations

import torch

from . import bucket as bk
from . import hashing, layout
from .layout import (DROPPED, EXISTS, INSERTED, NEED_SPLIT, NOT_FOUND,
                     DashConfig, DashState, word)


def _bulk_hash(keys_hi, keys_lo):
    from repro_torch.kernels import hashmix
    return hashmix.bulk_hash(keys_hi, keys_lo)


def _zeros(like, dtype=torch.int64):
    return torch.zeros(like.shape, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# addressing
# ---------------------------------------------------------------------------

def locate(cfg: DashConfig, mode: str, state: DashState, h1):
    """(seg, b) int64 for hashes under EH (MSB directory) or LH (level/next)."""
    if mode == "eh":
        seg = state.dir[layout.dir_index(cfg, h1)].long()
        b = layout.bucket_index(cfg, h1)
    else:
        seg = state.lh_dir[layout.lh_logical_segment(cfg, h1, state.lh_word)].long()
        b = layout.lh_bucket_index(cfg, h1)
    return seg, b


def _wrap(cfg: DashConfig, b):
    return b & (cfg.num_buckets - 1)


# ---------------------------------------------------------------------------
# segment-scope probe (search + uniqueness check)
# ---------------------------------------------------------------------------

def probe_in_segment(cfg: DashConfig, state: DashState, seg, b, h2, q_hi, q_lo,
                     q_words=None):
    """Full lookup inside each lane's segment: window buckets, then stash
    via overflow metadata (Alg. 3). Returns (found, value). ``q_words``
    (L, W) are the lanes' key words in pointer mode."""
    fpv = hashing.fingerprint(h2)
    NB, NS = cfg.num_buckets, cfg.num_stash
    found = _zeros(seg, torch.bool)
    value = _zeros(seg, torch.int32)

    def visit(bx, gate=None):
        nonlocal found, value
        f, _, v = bk.bucket_probe(cfg, state, seg, bx, fpv, q_hi, q_lo, q_words)
        if gate is not None:
            f = f & gate
        value = torch.where(f & ~found, v, value)
        found = found | f

    for w in range(cfg.probe_window):
        visit(_wrap(cfg, b + w))
    if NS == 0:
        return found, value

    active = state.stash_active[seg]
    if not cfg.use_overflow_meta:
        # ablation (Fig. 10 baseline): no metadata => always scan the stash
        for s in range(NS):
            visit(NB + s, s < active)
        return found, value

    pb = _wrap(cfg, b + 1)
    om_home, om_prob = state.ometa[seg, b], state.ometa[seg, pb]
    if not bool((((om_home | om_prob) != 0) & (active > 0)).any()):
        return found, value       # no overflow metadata: no stash row to visit
    m_home = bk.ofp_matches(cfg, state, seg, b, fpv, want_member=False)
    m_prob = bk.ofp_matches(cfg, state, seg, pb, fpv, want_member=True)
    scan_all = layout.ometa_ovf_count(om_home) > 0
    # which stash buckets are indicated by matching overflow fingerprints
    indicated = [_zeros(seg, torch.bool) for _ in range(NS)]
    for j in range(cfg.num_ofp):
        sj_h = layout.ometa_stash_idx(om_home, j)
        sj_p = layout.ometa_stash_idx(om_prob, j)
        for s in range(NS):
            indicated[s] = indicated[s] | (m_home[:, j] & (sj_h == s)) | (
                m_prob[:, j] & (sj_p == s))
    for s in range(NS):
        visit(NB + s, (indicated[s] | scan_all) & (s < active))
    return found, value


# ---------------------------------------------------------------------------
# insert (Algorithm 1 + Algorithm 2)
# ---------------------------------------------------------------------------

def _insert_core(cfg: DashConfig, state: DashState, seg, b, h2, q_hi, q_lo, v,
                 valid=None, check_unique: bool = True, exists=None,
                 q_words=None, heap_append: bool = True):
    """Insert one key per lane into a known segment (the public insert and
    the split rehash both come here, bypassing the directory like the
    paper). Lanes must be in distinct segments. ``exists`` overrides the
    uniqueness probe (the fused path passes its dense probe). Updates the
    planes and ``n_items`` in place; returns (status int32, stash-activated
    bool) per lane; a lane with ``valid`` False is DROPPED untouched.

    Pointer mode: ``q_words`` (L, W) are the keys' words; with
    ``heap_append`` every placed key appends its words to the key heap and
    its record stores the heap handle in ``key_lo`` (SMO rehashes move
    records with their handles and pass ``heap_append=False``)."""
    fpv = hashing.fingerprint(h2)
    NB, SL, NS = cfg.num_buckets, cfg.num_slots, cfg.num_stash
    pb = _wrap(cfg, b + 1)
    false = _zeros(seg, torch.bool)
    if valid is None:
        valid = ~false
    if exists is None:
        exists = (probe_in_segment(cfg, state, seg, b, h2, q_hi, q_lo, q_words)[0]
                  if check_unique else false)

    # ---- candidate computation (cheap packed-word reads) ----
    if cfg.use_balanced:
        cb, cp = bk.bucket_count(state, seg, b), bk.bucket_count(state, seg, pb)
        pick_pb = ((cp < cb) & (cp < SL)) | ((cb >= SL) & (cp < SL))
        can_plain = (cb < SL) | (cp < SL)
        ins_b = torch.where(pick_pb, pb, b)
        ins_member = pick_pb
    else:
        # linear-probing window (CCEH style / Fig. 11 '+Probing'); member unused
        counts = torch.stack([bk.bucket_count(state, seg, _wrap(cfg, b + w))
                              for w in range(max(cfg.probe_len, 1))], -1)
        can_plain, woff = bk.first_true(counts < SL)
        ins_b = _wrap(cfg, b + woff)
        ins_member = false

    # the displacement and stash candidates matter only to lanes that can
    # neither report EXISTS nor insert plainly; one read skips them if none
    okA = okB = ok_stash_or_new = stash_activates = false
    crowded = bool((valid & ~exists & ~can_plain).any())

    # displacement candidates (Alg. 2) — only meaningful in balanced mode
    if crowded and cfg.use_balanced and cfg.use_displacement:
        pb2, bm1 = _wrap(cfg, b + 2), _wrap(cfg, b - 1)
        okA_slot, slotA = bk.find_movable_slot(cfg, state, seg, pb, False)
        okA = okA_slot & (bk.bucket_count(state, seg, pb2) < SL)
        okB_slot, slotB = bk.find_movable_slot(cfg, state, seg, b, True)
        okB = okB_slot & (bk.bucket_count(state, seg, bm1) < SL)

    # stash candidate: first active stash bucket with a free slot
    if crowded and NS > 0:
        active = state.stash_active[seg].long()
        stash_free = torch.stack([(bk.bucket_count(state, seg, NB + s) < SL)
                                  & (s < active) for s in range(NS)], -1)
        ok_stash, st_j = bk.first_true(stash_free)
        can_activate = active < NS          # activation analog for LH chaining
        ok_stash_or_new = ok_stash | can_activate
        st_j = torch.where(ok_stash, st_j, active)
        stash_activates = ~ok_stash & can_activate

    # ---- decision (priority: exists > plain > dispA > dispB > stash > split) ----
    code = torch.where(exists, 0, torch.where(
        can_plain, 1, torch.where(okA, 2, torch.where(
            okB, 3, torch.where(ok_stash_or_new, 4, 5)))))
    status = torch.where(~valid, DROPPED, torch.where(
        code == 0, EXISTS, torch.where(code == 5, NEED_SPLIT, INSERTED))).to(torch.int32)

    # ---- each branch as masked writes, in the branch's own store order;
    # one read of the codes skips the branches no lane takes ----
    taken = torch.bincount(torch.where(valid, code, 0), minlength=6).tolist()
    if cfg.pointer_mode and heap_append and any(taken[1:5]):
        q_lo = _heap_append(cfg, state, valid & (code >= 1) & (code <= 4),
                            q_words, q_lo)
    if taken[1]:                             # plain insert
        m = valid & (code == 1)
        _, slot = bk.first_free_slot(cfg, state, seg, ins_b)
        bk.bucket_write(cfg, state, seg, ins_b, slot, q_hi, q_lo, v, fpv,
                        ins_member, m)
    if taken[2]:
        # A: move a target=pb record from pb to its probing bucket pb2
        m = valid & (code == 2)
        mk = bk.read_slot(state, seg, pb, slotA)
        _, fs = bk.first_free_slot(cfg, state, seg, pb2)
        bk.bucket_write(cfg, state, seg, pb2, fs, *mk, member=True, mask=m)
        bk.bucket_clear_slot(cfg, state, seg, pb, slotA, m)
        bk.bucket_write(cfg, state, seg, pb, slotA, q_hi, q_lo, v, fpv, True, m)
    if taken[3]:
        # B: move a target=b-1 record (in b with membership set) home to b-1
        m = valid & (code == 3)
        mk = bk.read_slot(state, seg, b, slotB)
        _, fs = bk.first_free_slot(cfg, state, seg, bm1)
        bk.bucket_write(cfg, state, seg, bm1, fs, *mk, member=False, mask=m)
        bk.bucket_clear_slot(cfg, state, seg, b, slotB, m)
        bk.bucket_write(cfg, state, seg, b, slotB, q_hi, q_lo, v, fpv, False, m)
    if taken[4]:
        m = valid & (code == 4)               # stash (activating one if needed)
        cur = state.stash_active[seg]
        state.stash_active[seg] = torch.where(
            m, torch.maximum(cur, (st_j + 1).to(cur.dtype)), cur)
        sb = NB + st_j.clamp(max=NS - 1)      # masked-out lanes may hold NS
        _, slot = bk.first_free_slot(cfg, state, seg, sb)
        bk.bucket_write(cfg, state, seg, sb, slot, q_hi, q_lo, v, fpv, False, m)
        if cfg.use_overflow_meta:
            # overflow metadata: home bucket first, then probing bucket (Sec. 4.3)
            ok1 = bk.ofp_try_set(cfg, state, seg, b, fpv, st_j, False, m)
            m = m & ~ok1
            ok2 = bk.ofp_try_set(cfg, state, seg, pb, fpv, st_j, True, m)
            bk.ovf_count_add(state, seg, b, 1, m & ~ok2)

    inserted = status == INSERTED
    state.n_items.add_(inserted.sum().to(torch.int32))
    return status, stash_activates & inserted & (code == 4)


def _heap_append(cfg: DashConfig, state: DashState, placed, q_words, q_lo):
    """Pointer mode: bump-allocate one key-heap row per placed lane (in lane
    order) and store its words there. Returns the ``key_lo`` each lane's
    record stores: its heap handle where placed, else ``q_lo``. A handle
    past the heap's end writes the last row, as the reference's clamped
    slice update does."""
    order = torch.cumsum(placed.long(), 0) - placed.long()
    handle = state.heap_top.long() + order
    rows = handle.clamp(max=state.key_heap.shape[0] - 1)
    sel = placed.nonzero()[:, 0]
    state.key_heap[rows[sel]] = q_words[sel].to(torch.int32)
    state.heap_top.add_(placed.sum().to(torch.int32))
    return torch.where(placed, word(handle), q_lo)


# ---------------------------------------------------------------------------
# delete (Sec. 4.6) and update
# ---------------------------------------------------------------------------

def delete_in_segment(cfg: DashConfig, state: DashState, seg, b, h2,
                      q_hi, q_lo, valid=None, q_words=None):
    """Delete one key per lane (distinct segments), in place. Returns
    status INSERTED (deleted) / NOT_FOUND, DROPPED for invalid lanes."""
    fpv = hashing.fingerprint(h2)
    NB, NS = cfg.num_buckets, cfg.num_stash
    if valid is None:
        valid = torch.ones_like(seg, dtype=torch.bool)

    # locate in window buckets
    found_w, w_b, w_slot = _zeros(seg, torch.bool), _zeros(seg), _zeros(seg)
    for w in range(cfg.probe_window):
        bw = _wrap(cfg, b + w)
        f, slot, _ = bk.bucket_probe(cfg, state, seg, bw, fpv, q_hi, q_lo, q_words)
        take = f & ~found_w
        w_b = torch.where(take, bw, w_b)
        w_slot = torch.where(take, slot, w_slot)
        found_w = found_w | f

    # locate in stash
    found_s, s_j, s_slot = _zeros(seg, torch.bool), _zeros(seg), _zeros(seg)
    if NS > 0:
        active = state.stash_active[seg]
        for s in range(NS):
            f, slot, _ = bk.bucket_probe(cfg, state, seg, NB + s, fpv, q_hi, q_lo,
                                         q_words)
            f = f & (s < active)
            take = f & ~found_s
            s_j = torch.where(take, s, s_j)
            s_slot = torch.where(take, slot, s_slot)
            found_s = found_s | f

    in_window = valid & found_w
    bk.bucket_clear_slot(cfg, state, seg, w_b, w_slot, in_window)
    in_stash = valid & ~found_w & found_s
    if NS > 0:
        bk.bucket_clear_slot(cfg, state, seg, NB + s_j, s_slot, in_stash)
        if cfg.use_overflow_meta:
            # clear the matching overflow fingerprint (home first, then
            # probing), else decrement the overflow counter (Sec. 4.6 delete)
            pb = _wrap(cfg, b + 1)
            m_home = bk.ofp_matches(cfg, state, seg, b, fpv, want_member=False)
            m_prob = bk.ofp_matches(cfg, state, seg, pb, fpv, want_member=True)
            om_h, om_p = state.ometa[seg, b], state.ometa[seg, pb]
            j_ids = torch.arange(cfg.num_ofp, device=seg.device)
            idx_h = layout.ometa_stash_idx(om_h[:, None], j_ids)
            idx_p = layout.ometa_stash_idx(om_p[:, None], j_ids)
            has_h, j_h = bk.first_true(m_home & (idx_h == s_j[:, None]))
            has_p, j_p = bk.first_true(m_prob & (idx_p == s_j[:, None]))
            bk.ofp_clear(cfg, state, seg, b, j_h, in_stash & has_h)
            bk.ofp_clear(cfg, state, seg, pb, j_p, in_stash & ~has_h & has_p)
            bk.ovf_count_add(state, seg, b, -1, in_stash & ~has_h & ~has_p)
    deleted = in_window | in_stash
    state.n_items.sub_(deleted.sum().to(torch.int32))
    return torch.where(~valid, DROPPED, torch.where(
        deleted, INSERTED, NOT_FOUND)).to(torch.int32)


def update_in_segment(cfg: DashConfig, state: DashState, seg, b, h2,
                      q_hi, q_lo, v, valid=None, q_words=None):
    """Set the payload of an existing key per lane (distinct segments), in
    place. The touched bucket's version word is bumped like every other
    write, so the optimistic snapshot-verify path sees the change."""
    fpv = hashing.fingerprint(h2)
    NB = cfg.num_buckets
    if valid is None:
        valid = torch.ones_like(seg, dtype=torch.bool)
    status = torch.full(seg.shape, NOT_FOUND, dtype=torch.int32, device=seg.device)

    def visit(bx, gate=None):
        nonlocal status
        f, slot, _ = bk.bucket_probe(cfg, state, seg, bx, fpv, q_hi, q_lo, q_words)
        do = f & (status == NOT_FOUND) & valid
        if gate is not None:
            do = do & gate
        bk.masked_set(state.val, (seg, bx, slot), v, do)
        bk.bump_version(state, seg, bx, do)
        status = torch.where(do, INSERTED, status)

    for w in range(cfg.probe_window):
        visit(_wrap(cfg, b + w))
    for s in range(cfg.num_stash):
        visit(NB + s, s < state.stash_active[seg])
    return torch.where(valid, status, DROPPED).to(torch.int32)


# ---------------------------------------------------------------------------
# batched APIs
# ---------------------------------------------------------------------------

def _pow2_at_least(n: int, floor: int = 8) -> int:
    n = max(int(n), 1)
    return max(floor, 1 << (n - 1).bit_length())


def pallas_search_eligible(cfg: DashConfig) -> bool:
    """Configs the fingerprint-kernel read path covers exactly: inline keys,
    fingerprints on, and a probe window of at most 2 buckets. (The
    reference also requires buckets_total <= 128, its TPU tile height; the
    kernel here reads the natural planes and has no such limit.)"""
    return (cfg.use_fingerprints and not cfg.pointer_mode
            and (cfg.use_balanced or cfg.probe_len <= 2))


def _key_words(cfg: DashConfig, keys_hi, words):
    """The batch's (n, W) key words: all-zero rows if none are given, as in
    the reference."""
    if words is not None:
        return words
    return torch.zeros((keys_hi.shape[0], cfg.key_heap_words), dtype=torch.int32,
                       device=keys_hi.device)


def _query_parts(cfg: DashConfig, keys_hi, keys_lo, words):
    """(hi, lo, words, h1, h2) of a batch. Pointer mode folds the full key
    words into the identity pair."""
    words = _key_words(cfg, keys_hi, words)
    if cfg.pointer_mode:
        keys_hi, keys_lo = hashing.key_identity_from_words(words)
    h1, h2, _ = _bulk_hash(keys_hi, keys_lo)
    return keys_hi, keys_lo, words, h1, h2


def _default_valid(keys_hi, valid):
    if valid is None:
        return torch.ones(keys_hi.shape, dtype=torch.bool, device=keys_hi.device)
    return valid


def _per_key(n: int, step):
    """The sequential reference engines: one key per step, in batch order."""
    outs = [step(slice(i, i + 1)) for i in range(n)]
    if not outs:
        return None
    return [torch.cat(col) for col in zip(*outs)]


def _insert_batch_scan(cfg: DashConfig, mode: str, state: DashState,
                       keys_hi, keys_lo, vals, valid, words):
    """Sequential reference engine (the CPU oracle; one Python step per key).
    Also serves pointer mode, whose key heap is a global append log."""
    keys_hi, keys_lo, words, h1, h2 = _query_parts(cfg, keys_hi, keys_lo, words)
    seg, b = locate(cfg, mode, state, h1)
    res = _per_key(keys_hi.shape[0], lambda i: _insert_core(
        cfg, state, seg[i], b[i], h2[i], keys_hi[i], keys_lo[i], vals[i],
        valid[i], q_words=words[i]))
    if res is None:
        return state, _zeros(keys_hi, torch.int32), torch.tensor(False)
    return state, res[0], res[1].any()


def _segment_parallel(state: DashState, lanes, body, fills):
    """Run ``body(state, lane)`` over routed (G, C) lanes: step c applies lane
    c of every segment at once — Dash's per-segment locking granularity as
    a compute schedule. ``lanes["seg"]`` names each row's segment, so the
    lanes of one step address distinct segments. Steps after the last one
    holding a valid lane are skipped (their outputs are ``fills``, which is
    what ``body`` returns for invalid lanes). Returns the stacked (G, C)
    outputs."""
    valid = lanes["valid"]
    cols = valid.any(0).nonzero()
    steps = int(cols[-1]) + 1 if cols.numel() else 0
    outs = [torch.full(valid.shape, f, device=valid.device) for f in fills]
    for c in range(steps):
        res = body(state, {k: t[:, c] for k, t in lanes.items()})
        for o, r in zip(outs, res):
            o[:, c] = r
    return outs


def _scatter_statuses(statuses, src, n: int):
    """(G, C) lane statuses -> (n,) batch statuses; lanes that never got a
    slot (capacity overflow) come back DROPPED."""
    flat = statuses.reshape(-1).long()
    src = src.reshape(-1)
    out = torch.full((n,), -1, dtype=torch.int64, device=flat.device)
    out.scatter_reduce_(0, src.clamp(min=0), torch.where(src >= 0, flat, -1), "amax")
    return torch.where(out < 0, DROPPED, out).to(torch.int32)


def _routed(cfg, mode, state, payload, capacity, body, fills):
    """Route a write batch by segment and run ``body`` segment-parallel."""
    from repro_torch.kernels import ops
    lanes, src, _ = ops.route_writes(cfg, mode, state, payload, capacity)
    outs = _segment_parallel(state, lanes, body, fills)
    return _scatter_statuses(outs[0], src, payload[0].shape[0]), outs[1:]


def insert_batch(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, vals, valid=None,
                 batching: str = "segment", capacity: int | None = None,
                 words=None):
    """Sequentially-consistent batch insert, in place. Returns (state,
    statuses, any_stash_activation).

    ``batching="segment"`` (default) routes by segment and runs all
    segments in parallel; ``"scan"`` is the sequential reference; ``"fused"``
    is the merged-commit path (kernels/fused.py) the planner picks for small
    batches. All give identical planes and statuses when ``capacity`` covers
    the largest per-segment lane count (the default covers any skew).
    ``valid`` masks out lanes. Pointer mode takes the keys' (n, W) ``words``
    and always runs the scan engine."""
    n = keys_hi.shape[0]
    valid = _default_valid(keys_hi, valid)
    if batching == "scan" or cfg.pointer_mode:
        return _insert_batch_scan(cfg, mode, state, keys_hi, keys_lo, vals, valid,
                                  words)
    if batching == "fused":
        from repro_torch.kernels import fused
        return fused.fused_insert(cfg, mode, state, keys_hi, keys_lo, vals,
                                  valid, capacity)
    if batching != "segment":
        raise ValueError(f"unknown batching {batching!r}")
    cap = min(capacity or _pow2_at_least(n), _pow2_at_least(n))
    statuses, (acts,) = _routed(
        cfg, mode, state, (keys_hi, keys_lo, vals, valid), cap,
        lambda st, ln: _insert_core(cfg, st, ln["seg"], ln["b"], ln["h2"],
                                    ln["hi"], ln["lo"], ln["val"], ln["valid"]),
        (DROPPED, False))
    return state, statuses, acts.any()


def _search_batch_vmap(cfg: DashConfig, mode: str, state: DashState,
                       keys_hi, keys_lo, words=None):
    keys_hi, keys_lo, words, h1, h2 = _query_parts(cfg, keys_hi, keys_lo, words)
    seg, b = locate(cfg, mode, state, h1)
    return probe_in_segment(cfg, state, seg, b, h2, keys_hi, keys_lo, words)


def search_batch(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, batching: str = "auto", words=None):
    """Lock-free batched lookup — pure reads. Returns (found bool, values
    as int32 words).

    ``"pallas"`` (the default where eligible) is the fingerprint-kernel path
    over direct-addressed lanes (``kernels/ops.probe_direct``); ``"vmap"`` is
    the per-key path, used for configs the kernel does not cover; ``"fused"``
    is the one-kernel latency path (kernels/fused.py) the planner picks for
    small batches. Pointer mode takes the keys' (n, W) ``words``."""
    if batching == "fused":
        from repro_torch.kernels import fused
        if cfg.pointer_mode:
            words = _key_words(cfg, keys_hi, words)
        return fused.fused_search(cfg, mode, state, keys_hi, keys_lo, words)
    if batching in ("pallas", "auto"):
        batching = "pallas" if pallas_search_eligible(cfg) else "vmap"
    if batching == "vmap":
        return _search_batch_vmap(cfg, mode, state, keys_hi, keys_lo, words)
    if batching == "pallas":
        from repro_torch.kernels import ops
        return ops.probe_direct(cfg, state, keys_hi, keys_lo, mode)
    raise ValueError(f"unknown batching {batching!r}")


def search_batch_pessimistic(cfg: DashConfig, mode: str, state: DashState,
                             keys_hi, keys_lo, words=None):
    """Fig. 13 baseline: read-locking searches, in place. Every probe
    'acquires' and 'releases' a read lock — two version-word writes per
    touched bucket each — which also serializes the batch: one key per
    step, in batch order, as the reference's scan. (The bumps commute, so
    one scatter-add would end in the same planes; the serial batch is what
    the figure measures.) Returns (state, found, values)."""
    keys_hi, keys_lo, words, h1, h2 = _query_parts(cfg, keys_hi, keys_lo, words)

    def step(i):
        seg, b = locate(cfg, mode, state, h1[i])
        pb = _wrap(cfg, b + 1)
        bk.bump_version(state, seg, b)        # acquire
        bk.bump_version(state, seg, pb)
        found, val = probe_in_segment(cfg, state, seg, b, h2[i], keys_hi[i],
                                      keys_lo[i], words[i])
        bk.bump_version(state, seg, b)        # release
        bk.bump_version(state, seg, pb)
        return found, val

    res = _per_key(keys_hi.shape[0], step)
    if res is None:
        return state, _zeros(keys_hi, torch.bool), _zeros(keys_hi, torch.int32)
    return state, res[0], res[1]


def _scan_each(cfg: DashConfig, mode: str, state: DashState, keys_hi, keys_lo,
               words, op):
    """Run ``op(seg, b, h2, hi, lo, words, i)`` for one key per step, in
    batch order. Returns the (n,) statuses."""
    keys_hi, keys_lo, words, h1, h2 = _query_parts(cfg, keys_hi, keys_lo, words)
    seg, b = locate(cfg, mode, state, h1)
    res = _per_key(keys_hi.shape[0], lambda i: (op(
        seg[i], b[i], h2[i], keys_hi[i], keys_lo[i], words[i], i),))
    return res[0] if res else _zeros(keys_hi, torch.int32)


def delete_batch(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, valid=None,
                 batching: str = "segment", capacity: int | None = None,
                 words=None):
    """Batch delete, in place. Returns (state, statuses). Pointer mode takes
    the keys' (n, W) ``words`` and runs the scan engine."""
    n = keys_hi.shape[0]
    valid = _default_valid(keys_hi, valid)
    if batching == "scan" or cfg.pointer_mode:
        return state, _scan_each(
            cfg, mode, state, keys_hi, keys_lo, words,
            lambda seg, b, h2, hi, lo, w, i: delete_in_segment(
                cfg, state, seg, b, h2, hi, lo, valid[i], w))
    if batching != "segment":
        raise ValueError(f"unknown batching {batching!r}")
    cap = min(capacity or _pow2_at_least(n), _pow2_at_least(n))
    statuses, _ = _routed(
        cfg, mode, state, (keys_hi, keys_lo, torch.zeros_like(keys_hi), valid),
        cap, lambda st, ln: (delete_in_segment(
            cfg, st, ln["seg"], ln["b"], ln["h2"], ln["hi"], ln["lo"],
            ln["valid"]),), (DROPPED,))
    return state, statuses


def update_batch(cfg: DashConfig, mode: str, state: DashState,
                 keys_hi, keys_lo, vals, valid=None,
                 batching: str = "segment", capacity: int | None = None,
                 words=None):
    """Set payload for existing keys, in place. Returns (state, statuses).
    Pointer mode takes the keys' (n, W) ``words`` and runs the scan engine."""
    n = keys_hi.shape[0]
    valid = _default_valid(keys_hi, valid)
    if batching == "scan" or cfg.pointer_mode:
        return state, _scan_each(
            cfg, mode, state, keys_hi, keys_lo, words,
            lambda seg, b, h2, hi, lo, w, i: update_in_segment(
                cfg, state, seg, b, h2, hi, lo, vals[i], valid[i], w))
    if batching != "segment":
        raise ValueError(f"unknown batching {batching!r}")
    cap = min(capacity or _pow2_at_least(n), _pow2_at_least(n))
    statuses, _ = _routed(
        cfg, mode, state, (keys_hi, keys_lo, vals, valid), cap,
        lambda st, ln: (update_in_segment(
            cfg, st, ln["seg"], ln["b"], ln["h2"], ln["hi"], ln["lo"],
            ln["val"], ln["valid"]),), (DROPPED,))
    return state, statuses


# ---------------------------------------------------------------------------
# segment record extraction (split rehash + recovery)
# ---------------------------------------------------------------------------

def segment_records(cfg: DashConfig, state: DashState, seg):
    """All records of a segment: (hi, lo, val, valid), each (BT*SLOTS,); of
    K segments (a tensor of ids), each (K*BT*SLOTS,) in id order."""
    alloc = layout.meta_alloc(state.meta[seg])
    slot_ids = torch.arange(cfg.num_slots, device=alloc.device)
    valid = (((alloc[..., None] >> slot_ids) & 1) == 1).reshape(-1)
    return (state.key_hi[seg].reshape(-1), state.key_lo[seg].reshape(-1),
            state.val[seg].reshape(-1), valid)


def recount_items(state: DashState):
    """Exact global record count from the packed per-bucket counters — the
    audit ``n_items`` (maintained incrementally) is checked against."""
    return layout.meta_count(state.meta).sum()


def changed_rows(prev_version, live_version):
    """Flattened per-bucket-row dirty mask between two version planes."""
    return (prev_version != live_version).reshape(-1)


def record_hashes(cfg: DashConfig, state: DashState, hi, lo):
    """(h1, h2) for stored records of any shape (hashed on the card). In
    pointer mode ``lo`` is a heap handle: the identity pair is re-folded
    from the heap row (the 'dereference on rehash' cost of Sec. 4.5)."""
    if cfg.pointer_mode:
        hi, lo = hashing.key_identity_from_words(bk.heap_rows(cfg, state, lo))
    h1, h2, _ = _bulk_hash(hi.reshape(-1).contiguous(), lo.reshape(-1).contiguous())
    return h1.reshape(hi.shape), h2.reshape(hi.shape)
