"""Batched LM serving with Dash prefix-cache reuse, and the optimistic
snapshot search — the port of ``repro.serving.engine``.

Request flow (``ServingEngine.run``):
  1. ``match_prefix`` (a Dash probe batch: ``bulk_hash`` + ``fused_probe``)
     finds the longest cached token-block chain; those pages are gathered
     into the request's decode-state lane, and prefill runs only on the
     uncached suffix — the compute saved is counted per request.
  2. The suffix prefill's K/V (or, for the recurrent kinds, its final
     state snapshot) is admitted back into the pool under chained block
     hashes (Dash inserts).
  3. Greedy decode proceeds with the shared ``serve_step``.

The engine mirrors the reference step for step, its quirk included: after
a prefix hit the suffix's own prefill state (positions 0..; for the
recurrent kinds the state from a zero start) replaces the gathered lane
whole, while ``pos`` is set to the prompt's length, so a decode after a hit
is not what a full prefill would give (ROADMAP Queue 3). The vlm and audio
fronts are refused, as in the reference: they are served through
``forward_prefill`` and ``serve_step``.

Optimistic-concurrency composition (paper Sec. 4.4 at system level):
lookups run against a pinned *snapshot* of the table while writers build
the next version; the verify step compares the bucket version words each
query may read and retries only the queries whose buckets changed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import engine as dash_engine
from repro_torch.core import layout
from repro_torch.core.epoch import EpochManager
from repro_torch.models.transformer import (ModelConfig, Transformer, decode_state_init,
                                            forward_prefill, serve_step)
from .kv_cache import PagePool, PagePoolConfig
from .prefix_cache import BLOCK, DashPrefixCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    generated: Optional[List[int]] = None
    cached_tokens: int = 0
    prefilled_tokens: int = 0


class ServingEngine:
    """Prefix reuse + batched greedy decode of ``params`` (a ``Transformer``)
    on its device; the prefix table and the page pool live there too."""

    def __init__(self, cfg: ModelConfig, params: Transformer, *, cache_len: int = 512,
                 num_pages: int = 1024, batch_size: int = 4):
        if cfg.family in ("vlm", "audio"):
            raise ValueError(f"ServingEngine serves token-in architectures; the {cfg.family} "
                             f"front ({cfg.name}) is served through forward_prefill and "
                             f"serve_step")
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.cache_len = cache_len
        self.batch = batch_size
        self.prefix = DashPrefixCache(num_pages, device=self.device)
        self.pool = PagePool(PagePoolConfig(num_pages, cfg), device=self.device)
        # epoch-based reclamation (paper Sec. 4.4): lookups pin an epoch;
        # superseded directory snapshots retire 2 epochs later
        self.epochs = EpochManager()
        self._prefill = lambda p, b: forward_prefill(p, cfg, b, cache_len)
        self._decode = lambda p, s, i: serve_step(p, cfg, s, i)
        self.flops_saved_tokens = 0

    @torch.no_grad()
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a batch of requests (prefix reuse + batched greedy decode),
        with gradients off."""
        B = self.batch
        if len(requests) > B:
            raise ValueError(f"{len(requests)} requests for {B} lanes")
        state = decode_state_init(self.cfg, B, self.cache_len, self.device)

        # 1) prefix match + suffix prefill per request (lookup under an
        # epoch pin — admissions below retire superseded snapshots safely)
        for bi, req in enumerate(requests):
            with self.epochs.pin():
                pages, n_cached = self.prefix.match_prefix(req.prompt)
            n_cached = min(n_cached, len(req.prompt) - 1)   # always prefill >= 1
            n_cached = (n_cached // BLOCK) * BLOCK
            req.cached_tokens = n_cached
            self.flops_saved_tokens += n_cached

            # gather cached pages into this request's lane
            for pi, kind in enumerate(self.cfg.pattern):
                state[f"blocks_{pi}"] = self.pool.gather_into_cache(
                    pages[: n_cached // BLOCK], pi, kind, state[f"blocks_{pi}"], bi)

            # prefill the uncached suffix (the dominant cost without the cache)
            suffix = req.prompt[n_cached:]
            req.prefilled_tokens = len(suffix)
            sb = {"tokens": torch.as_tensor(np.asarray(suffix, np.int32),
                                            device=self.device)[None, :]}
            logits, pstate = self._prefill(self.params, sb)

            # the suffix's state replaces lane bi whole, every leaf of every
            # layer (the reference's merge: exact only when n_cached == 0)
            for pi in range(len(self.cfg.pattern)):
                for f, t in pstate[f"blocks_{pi}"].items():
                    state[f"blocks_{pi}"][f][:, bi] = t[:, 0]
            for ti in range(len(self.cfg.tail)):
                for f, t in pstate[f"tail_{ti}"].items():
                    state[f"tail_{ti}"][f][bi] = t[0]
            state["pos"][bi] = len(req.prompt)

            # 3) admit the new blocks back into the pool; the pre-admission
            # directory version is retired through the epoch manager
            old_state = self.prefix.table.state
            new_pages = self.prefix.admit(req.prompt, first_new_block=n_cached // BLOCK)
            self.epochs.retire(old_state)
            for pi, kind in enumerate(self.cfg.pattern):
                self.pool.store_request(new_pages, pstate[f"blocks_{pi}"], pi, kind, 0,
                                        len(req.prompt))
            req.generated = [int(torch.argmax(logits[0, -1]))]

        # 2) batched greedy decode; padding lanes are fed token 0
        max_new = max(r.max_new_tokens for r in requests)
        tokens = torch.tensor([r.generated[0] for r in requests] + [0] * (B - len(requests)),
                              dtype=torch.int32, device=self.device)
        for _ in range(max_new - 1):
            logits, state = self._decode(self.params, state, {"token": tokens})
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            host = tokens.tolist()
            for bi, req in enumerate(requests):
                if len(req.generated) < req.max_new_tokens:
                    req.generated.append(host[bi])
        return requests


# ---------------------------------------------------------------------------
# optimistic snapshot search (system-level Sec. 4.4)
# ---------------------------------------------------------------------------

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
