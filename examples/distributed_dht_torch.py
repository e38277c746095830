"""Distributed Dash on PyTorch: one shard per rank, keys routed to their
owners by ``all_to_all_single`` (the port, ``repro_torch``).

    PYTHONPATH=src python examples/distributed_dht_torch.py                # one rank per card (NCCL)
    PYTHONPATH=src python examples/distributed_dht_torch.py --device cpu   # 8 ranks on the CPU (gloo)

Twin of ``examples/distributed_dht.py``. Launches ``--ranks`` processes
with ``torch.multiprocessing`` (default: one per card, or 8 on the CPU);
``--keys`` sizes the table.
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank: int, world: int, init: str, device, n: int):
    from repro_torch.core import DashConfig
    from repro_torch.distributed import DistributedDash
    backend = "gloo" if device == "cpu" else "nccl"
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world)
    d = DistributedDash(DashConfig(max_segments=64, dir_depth_max=9),
                        device=None if device is None else device)
    rng = np.random.default_rng(0)        # every rank takes the same global batch
    keys = np.unique(rng.integers(1, 2**63, n * 5 // 2, dtype=np.uint64))[:n]
    d.insert(keys, np.arange(n, dtype=np.uint32))
    f, v = d.search(keys[:4096])
    n_items = d.n_items
    if not (f.all() and (v == np.arange(f.size)).all()):
        raise SystemExit(f"rank {rank}: a search answer is wrong")
    if rank == 0:
        print(f"ranks: {world}; shards: {d.n_shards} on {d.device.type}")
        print(f"inserted {n_items} across {d.n_shards} shards; search hit "
              f"{int(f.sum())}/{f.size} with 2 all_to_alls per batch")
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=[None, "cpu"],
                    help="cpu for gloo ranks on the CPU (default: one rank per card)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: the cards present, or 8 on the CPU)")
    ap.add_argument("--keys", type=int, default=16_000, help="keys inserted")
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    world = args.ranks or (8 if args.device == "cpu" else torch.cuda.device_count())
    if args.device is None:
        from repro_torch.kernels import _build
        _build.build()                # once, before the ranks start
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(world, os.path.join(tmp, "pg"), args.device,
                                            args.keys),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
