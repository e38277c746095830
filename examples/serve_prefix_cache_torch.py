"""End-to-end serving on PyTorch (the port, ``repro_torch``): batched
requests with Dash prefix-cache reuse (the paper's hash table as the
serving KV-page directory).

    PYTHONPATH=src python examples/serve_prefix_cache_torch.py [--arch yi-6b]
    PYTHONPATH=src python examples/serve_prefix_cache_torch.py --device cpu

Twin of ``examples/serve_prefix_cache.py``; runs on the card unless
``--device`` names another. ``--arch`` takes every token architecture
(``mixtral-8x7b``, ``recurrentgemma-9b``, ``rwkv6-7b``, ...); the recurrent
kinds keep state snapshots in the page pool instead of K/V.
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, cache_len=256, num_pages=256,
                           batch_size=4)
    rng = np.random.default_rng(0)
    system_prompt = rng.integers(1, cfg.vocab_size, 64)   # shared prefix

    rid = 0
    for round_i in range(args.rounds):
        reqs = []
        for _ in range(4):
            user = rng.integers(1, cfg.vocab_size, 32)
            reqs.append(Request(rid, np.concatenate([system_prompt, user]),
                                max_new_tokens=8))
            rid += 1
        engine.run(reqs)
        s = engine.prefix.stats
        print(f"round {round_i}: hit-rate {s.hit_rate:.1%}, "
              f"prefill tokens saved so far {engine.flops_saved_tokens}, "
              f"dash directory load factor {engine.prefix.load_factor:.3f}")
    print("done — the shared system prompt is prefilled once, then every "
          "request reuses its pages via Dash probes")


if __name__ == "__main__":
    main()
