"""Rank program of the port's tensor- and sequence-parallel mesh tests: one
process per rank in a gloo group of 4 on the CPU, a 2 x 2 (data x model)
mesh, run by ``torch_mesh_ranks.launch`` (``tests/test_torch_mesh_tp.py``).

    python tests/torch_mesh_tp_ranks.py RANK WORLD INIT_FILE IN_DIR OUT_DIR

Reads the seeded inputs ``IN_DIR/inputs.pkl``: the (arch, preset) train
cases, each a reduced bf16 model's state and batches, and the (arch,
preset, dtype) prefill cases. Writes to ``OUT_DIR/rank{RANK}.pkl`` every case's
metrics a step and (rank 0) the gathered state after the last step, each
prefill's logits block with this rank's mesh coordinate, and commits the
first case's state sharded to ``inputs["commit_dir"]``. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path


def run(rank: int, inputs: dict, out: dict) -> None:
    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import sharding
    from repro_torch.train import steps as TS

    torch.set_num_threads(1)
    mesh = make_test_mesh(2, 2, device="cpu")
    coord = sharding.coordinate(mesh)
    out["coord"] = (coord["data"], coord["model"])

    def config(arch):
        return dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")

    for i, (arch, preset) in enumerate(inputs["cases"]):
        cfg = config(arch)
        with sharding.use(mesh, preset):
            step = TS.make_train_step(cfg)
            state = interop.train_state_to_mesh(cfg, inputs[f"{arch}_state"], mesh,
                                                device="cpu")
        metrics = []
        for b in inputs[f"{arch}_batches"]:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"train_{arch}_{preset}"] = metrics
        full = [TS.gather_tree(t, step.layout, mesh)
                for t in (state.params, state.opt.m, state.opt.v)]
        full = TS.TrainState(full[0], TS.adamw.AdamWState(full[1], full[2], state.opt.count),
                             state.step)
        if rank == 0:
            out[f"state_{arch}_{preset}"] = {k: v.numpy().copy()
                                             for k, v in flatten(full).items()}
        if i == 0:
            CheckpointManager(inputs["commit_dir"]).save_sharded(int(state.step), state,
                                                                 step.layout, mesh)

    for arch, preset, dtype in inputs["prefills"]:
        cfg = dataclasses.replace(config(arch), dtype=dtype)
        with sharding.use(mesh, preset):
            prefill = TS.make_prefill_step(cfg)
            params = interop.train_state_to_mesh(cfg, inputs[f"{arch}_state"], mesh,
                                                 device="cpu").params
        b = inputs[f"{arch}_batches"][0]
        logits = prefill(params, {"tokens": torch.from_numpy(b["tokens"])})
        out[f"prefill_{arch}_{preset}"] = logits.numpy().copy()
    sharding.set_active(None)


if __name__ == "__main__":
    rank, world, init, in_dir, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    inputs = pickle.loads((Path(in_dir) / "inputs.pkl").read_bytes())
    result: dict = {}
    run(rank, inputs, result)
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    dist.destroy_process_group()
