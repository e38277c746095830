"""Optimistic snapshot search (paper Sec. 4.4 at system level).

Lookups run against a pinned *snapshot* of the table while writers build
the next version; the verify step compares the bucket version words each
query may read and retries only the queries whose buckets changed. Ported
from the Dash half of ``repro.serving.engine`` (the LM serving engine there
is not ported).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine as dash_engine
from repro_torch.core import layout


def buckets_changed_local(cfg, mode, old_state, new_state, keys_hi, keys_lo):
    """Per-query bool mask: could this query observe different records on
    ``new_state`` than on the ``old_state`` snapshot?

    A query is 'changed' iff its addressing moved (directory entry / LH
    word remap) or any bucket it may probe — the probe window AND the
    segment's stash buckets, whose version words are the only trace a
    stash insert leaves for this home bucket — carries a different version
    word. False negatives would be torn reads; false positives only cost a
    retry, so the stash compare is segment-wide."""
    from repro_torch.kernels import hashmix
    h1, _, _ = hashmix.bulk_hash(keys_hi, keys_lo)
    if mode == "eh":
        d = layout.dir_index(cfg, h1)
        seg = old_state.dir[d].long()
        b = layout.bucket_index(cfg, h1)
        changed = old_state.dir[d] != new_state.dir[d]
    else:
        seg = old_state.lh_dir[
            layout.lh_logical_segment(cfg, h1, old_state.lh_word)].long()
        b = layout.lh_bucket_index(cfg, h1)
        new_seg = new_state.lh_dir[
            layout.lh_logical_segment(cfg, h1, new_state.lh_word)]
        changed = seg != new_seg
    rows = [(b + w) & (cfg.num_buckets - 1) for w in range(cfg.probe_window)]
    rows += [torch.full_like(b, cfg.num_buckets + s) for s in range(cfg.num_stash)]
    for bw in rows:
        changed = changed | (old_state.version[seg, bw] != new_state.version[seg, bw])
    return changed


def buckets_changed(cfg, mode, old_state, new_state, keys_hi, keys_lo):
    """The single-table verify the serving frontends call."""
    return buckets_changed_local(cfg, mode, old_state, new_state,
                                 keys_hi, keys_lo)


def snapshot_search(cfg, old_state, new_state, keys_hi, keys_lo,
                    batching: str = "auto", mode: str = "eh"):
    """Search against a snapshot while writers published ``new_state``;
    verify per-touched-bucket versions (``buckets_changed``) and retry
    changed queries on the new version. Returns (found, values, n_retried).
    The serving frontend uses the lazy variant (retry only when the mask is
    non-empty) through ``buckets_changed`` directly."""
    found, vals = dash_engine.search_batch(cfg, mode, old_state, keys_hi,
                                           keys_lo, batching=batching)
    changed = buckets_changed(cfg, mode, old_state, new_state,
                              keys_hi, keys_lo)
    f2, v2 = dash_engine.search_batch(cfg, mode, new_state, keys_hi, keys_lo,
                                      batching=batching)
    found = torch.where(changed, f2, found)
    vals = torch.where(changed, v2, vals)
    return found, vals, changed.sum()
