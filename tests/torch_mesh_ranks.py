"""Rank program of the port's mesh tests: one process per rank in a gloo
group of 4 on the CPU, a 2 x 2 (data x model) mesh, run by ``launch``
(``tests/test_torch_mesh.py``).

    python tests/torch_mesh_ranks.py RANK WORLD INIT_FILE IN_DIR OUT_DIR

Reads the seeded inputs ``IN_DIR/inputs.pkl`` and writes what the parity
test compares to ``OUT_DIR/rank{RANK}.pkl``: this rank's state shards,
``compressed_psum`` over 'data' for 3 steps, ``fsdp_gather_int8``'s forward
and backward, both MoE shard_map variants on this rank's rows, 3 mesh train
steps of yi-6b and mixtral-8x7b (reduced, bf16) and the elastic runbook
(a sharded commit, the shrink to (1, 2), the restore and one step, under
``train_dp`` and under ``train``).
Imports no JAX.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def launch(world: int, in_dir, out_dir, timeout: float = 300.0, script=None):
    """Start ``world`` gloo ranks of ``script`` (default: this one; file
    init under ``out_dir``); returns a function that waits for them, fails
    if a rank fails or the group outlives ``timeout``, and returns every
    rank's pickled result."""
    out_dir = Path(out_dir)
    init = out_dir / "pg"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(script or __file__).resolve()), str(r), str(world), str(init),
         str(in_dir), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for r in range(world)]
    start = time.monotonic()

    def wait():
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(start + timeout - time.monotonic(), 1.0))
                logs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        assert not bad, "\n".join(f"--- rank {r}\n{logs[r][-4000:]}" for r in bad)
        return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes()) for r in range(world)]
    return wait


def run(rank: int, world: int, inputs: dict, out: dict) -> None:
    import dataclasses

    import torch

    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import elastic
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import param_specs
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import group_for
    from repro_torch.parallel.compression import (compressed_psum, fsdp_gather_int8,
                                                  init_residuals)
    from repro_torch.train import steps as TS

    torch.set_num_threads(1)
    for name, fn in (("production", make_production_mesh),
                     ("no_card", lambda: make_test_mesh(2, 2))):
        try:
            fn()
        except (RuntimeError, ValueError) as e:
            out[f"refused_{name}"] = str(e)
    mesh = make_test_mesh(2, 2, device="cpu")
    coord = sharding.coordinate(mesh)
    out["coord"] = (coord["data"], coord["model"])

    # ---- state shards under train_dp ----
    yi = dataclasses.replace(get_config("yi-6b", reduced=True), dtype="bfloat16")
    with sharding.use(mesh, "train_dp"):
        st = interop.train_state_to_mesh(yi, inputs["yi_state"], mesh, device="cpu")
    out["shards"] = {k: v.numpy().copy() for k, v in flatten(st).items()}

    # ---- compressed_psum over 'data', 3 steps with residuals ----
    data = group_for(mesh, ("data",))
    grads = {"w": torch.from_numpy(inputs["cp_g"][0, rank])}
    res = init_residuals(grads)
    out["cp"] = []
    for s in range(inputs["cp_g"].shape[0]):
        grads = {"w": torch.from_numpy(inputs["cp_g"][s, rank])}
        mean, res = compressed_psum(grads, res, data)
        out["cp"].append((mean["w"].numpy().copy(), res["w"].numpy().copy()))

    # ---- fsdp_gather_int8 forward and backward over (data, model) ----
    both = group_for(mesh, ("data", "model"))
    w = torch.from_numpy(inputs["fg_w"])
    n = w.shape[1] // 4
    shard = w[:, both.index * n:(both.index + 1) * n].clone().requires_grad_(True)
    full = fsdp_gather_int8(shard, both, 1, torch.bfloat16)
    full.backward(torch.from_numpy(inputs["fg_ct"][rank]).to(torch.bfloat16))
    out["fg"] = (full.detach().float().numpy(), shard.grad.numpy().copy())

    # ---- the MoE variants on this rank's rows (f32) ----
    x = torch.from_numpy(inputs["moe_x"])
    rows = x[both.index:both.index + 1]
    for key, arch, rules in (("shardmap", "mixtral-8x7b", "train_dp"),
                             ("ep", "phi3.5-moe-42b-a6.6b", "train_dp_ep")):
        cfg = get_config(arch, reduced=True)
        params = {k: torch.from_numpy(v) for k, v in inputs[f"moe_{key}"].items()}
        with sharding.use(mesh, rules):
            specs = param_specs(cfg)["blocks_0"]["moe"]
            layout = sharding.tree_shardings({k: v[1:] for k, v in specs.items()}, mesh,
                                             shape_tree=params)
            local = {k: layout[k].take(v).clone() for k, v in params.items()}
            variant = M.mesh_variant(cfg.moe_cfg(), cfg.d_model, rows.shape[0])
            out[f"variant_{key}"] = variant[0]
            if key == "ep":
                y, aux = M.moe_apply_ep_shardmap(local, cfg.moe_cfg(), rows, mesh, variant[1],
                                                 "model", variant[2])
            else:
                y, aux = M.moe_apply_shardmap(local, cfg.moe_cfg(), rows, mesh, variant[1],
                                              variant[2])
        out[f"moe_{key}"] = (y.numpy().copy(), float(aux))

    # ---- 3 mesh train steps: yi-6b and mixtral-8x7b (reduced, bf16) ----
    for arch in ("yi-6b", "mixtral-8x7b"):
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="bfloat16")
        with sharding.use(mesh, "train_dp"):
            step = TS.make_train_step(cfg)
            state = interop.train_state_to_mesh(cfg, inputs[f"{arch}_state"], mesh,
                                                device="cpu")
        metrics = []
        for b in inputs[f"{arch}_batches"]:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"train_{arch}"] = metrics
        full = TS.gather_tree(state.params, step.layout, mesh)
        fm = TS.gather_tree(state.opt.m, step.layout, mesh)
        fv = TS.gather_tree(state.opt.v, step.layout, mesh)
        out[f"state_{arch}"] = {k: v.numpy().copy() for k, v in flatten(
            TS.TrainState(full, TS.adamw.AdamWState(fm, fv, state.opt.count),
                          state.step)).items()}
        if arch == "yi-6b":
            ckpt = CheckpointManager(inputs["commit_dir"])
            ckpt.save_sharded(int(state.step), state, step.layout, mesh)
    for preset in ("no_such_preset",):
        try:
            TS.make_mesh_train_step(yi, mesh, preset)
        except ValueError as e:
            out[f"refused_{preset}"] = str(e)

    # ---- elastic: shrink to (1, 2), restore, reshard, one step ----
    small = elastic.shrink_mesh(mesh, "data", 1, device="cpu")
    if sharding.coordinate(small) is None:
        out["left"] = True
        return
    _, lazy, _ = CheckpointManager(inputs["fixed_dir"]).restore_manifest()
    st = interop.train_state_to_mesh(yi, lazy, small, "train_dp", device="cpu")
    out["reshard"] = {k: v.numpy().copy() for k, v in flatten(st).items()}
    params: dict = {}
    for key, leaf in lazy.items():
        if key.startswith(".params/"):
            node = params
            *path, name = key.split("/")[1:]
            for k in path:
                node = node.setdefault(k, {})
            node[name] = leaf
    shards = elastic.reshard_tree(params, small, param_specs(yi), "train_dp", device="cpu")
    out["reshard_tree"] = {k: v.numpy().copy() for k, v in flatten({"params": shards}).items()}
    step = elastic.relower_for_mesh(yi, small, "train_dp")
    _, lazy, _ = CheckpointManager(inputs["commit_dir"]).restore_manifest()
    st = interop.train_state_to_mesh(yi, lazy, small, "train_dp", device="cpu")
    st, m = step(st, {k: torch.from_numpy(v) for k, v in inputs["elastic_batch"].items()})
    out["elastic_metrics"] = {k: float(v) for k, v in m.items()}
    full = TS.gather_tree(st.params, step.layout, small)
    out["elastic_params"] = {k: v.numpy().copy() for k, v in flatten({"p": full}).items()}

    # ---- the same under the reference's default preset, train ----
    _, lazy, _ = CheckpointManager(inputs["fixed_dir"]).restore_manifest()
    st = interop.train_state_to_mesh(yi, lazy, small, "train", device="cpu")
    out["reshard_train"] = {k: v.numpy().copy() for k, v in flatten(st).items()}
    step = elastic.relower_for_mesh(yi, small)
    _, lazy, _ = CheckpointManager(inputs["commit_dir"]).restore_manifest()
    st = interop.train_state_to_mesh(yi, lazy, small, device="cpu")
    st, m = step(st, {k: torch.from_numpy(v) for k, v in inputs["elastic_batch"].items()})
    out["elastic_train_metrics"] = {k: float(v) for k, v in m.items()}
    full = [TS.gather_tree(t, step.layout, small) for t in (st.params, st.opt.m, st.opt.v)]
    out["elastic_train_state"] = {k: v.numpy().copy() for k, v in flatten(TS.TrainState(
        full[0], TS.adamw.AdamWState(full[1], full[2], st.opt.count), st.step)).items()}
    sharding.set_active(None)


if __name__ == "__main__":
    rank, world, init, in_dir, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    inputs = pickle.loads((Path(in_dir) / "inputs.pkl").read_bytes())
    result: dict = {}
    run(rank, world, inputs, result)
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    dist.destroy_process_group()
