"""Quickstart: Dash hash tables on PyTorch (the port, ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # on the CPU

Twin of ``examples/quickstart.py``; ``--keys`` sizes the first table.
"""
import argparse

import numpy as np

from repro_torch.core import DashConfig, DashEH, DashLH, INSERTED

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="torch device (default: the card)")
ap.add_argument("--keys", type=int, default=20_000, help="keys in the first table")
args = ap.parse_args()
n = args.keys

# 1. build a Dash extendible-hashing table (fingerprints + balanced insert +
#    displacement + stashing all on, as in the paper)
table = DashEH(DashConfig(max_segments=128, dir_depth_max=10, num_stash=2),
               device=args.device)

rng = np.random.default_rng(0)
keys = np.unique(rng.integers(1, 2**63, n + n // 2, dtype=np.uint64))[:n]
values = np.arange(n, dtype=np.uint32)

statuses = table.insert(keys, values)
assert (statuses == INSERTED).all()
print(f"inserted {table.n_items} records into {table.n_segments} segments "
      f"(load factor {table.load_factor:.2f}, global depth {table.global_depth})")

found, vals = table.search(keys[:1000])
assert found.all() and (vals == values[:1000]).all()
print("positive search: all found")

# 2. crash it, restart instantly, keep serving (Sec. 4.8)
table.crash(np.random.default_rng(1), n_dups=4)
work = table.restart()
print(f"instant restart took {work['seconds']*1e3:.1f} ms (constant in size)")
found, _ = table.search(keys)
print(f"after lazy recovery: {found.sum()}/{len(keys)} found, "
      f"{table.recovered_segments} segments recovered on access")

# 3. variable-length keys (pointer mode, Sec. 4.5)
var = DashEH(DashConfig(max_segments=64, dir_depth_max=9, pointer_mode=True,
                        key_heap_size=8192, key_heap_words=4), device=args.device)
words = rng.integers(0, 2**32, (1000, 4), dtype=np.uint64).astype(np.uint32)
var.insert(values=np.arange(1000, dtype=np.uint32), words=words)
f, v = var.search(words=words[:10])
print(f"variable-length keys: {f.sum()}/10 found")

# 4. linear hashing variant (Sec. 5)
lh = DashLH(DashConfig(max_segments=128, num_stash=4), device=args.device)
lh.insert(keys[:n // 4], values[:n // 4])
print(f"Dash-LH: {lh.n_items} items across {lh.active_segments} segments")
