"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>`` —
batched requests through the Dash prefix-cache engine (reduced config), on
the card unless ``--device`` names another. Twin of
``python -m repro.launch.serve``. Every token architecture serves here
(dense, SWA, MoE, RG-LRU hybrid, RWKV6; ``--arch rwkv6-7b`` too at its
default 96-token prompts, where the reference's RWKV chunking raises); the
vlm and audio stub fronts are refused, as in the reference."""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--shared-prefix", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("serve demo targets token archs; use examples/")
    params = init_params(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, cache_len=256, num_pages=256, batch_size=4)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, args.shared_prefix)
    reqs = []
    for i in range(args.requests):
        tail = rng.integers(1, cfg.vocab_size, args.prompt_len - args.shared_prefix)
        reqs.append(Request(rid=i, prompt=np.concatenate([shared, tail]),
                            max_new_tokens=args.new_tokens))

    done = []
    for i in range(0, len(reqs), 4):
        done += engine.run(reqs[i:i + 4])
    stats = engine.prefix.stats
    print(f"[serve] {args.arch}: {len(done)} requests, "
          f"prefix hit rate {stats.hit_rate:.2%}, "
          f"prefill tokens saved {engine.flops_saved_tokens}, "
          f"dash load factor {engine.prefix.load_factor:.2f}")
    for r in done[:3]:
        print(f"  req {r.rid}: cached {r.cached_tokens} "
              f"prefilled {r.prefilled_tokens} -> {r.generated[:6]}...")
    return done


if __name__ == "__main__":
    main()
