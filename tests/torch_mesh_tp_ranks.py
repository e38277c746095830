"""Rank program of the port's tensor- and sequence-parallel mesh tests: one
process per rank in a gloo group of 4 on the CPU, a 2 x 2 (data x model)
mesh, run by ``torch_mesh_ranks.launch`` (``tests/test_torch_mesh_tp.py``).

    python tests/torch_mesh_tp_ranks.py RANK WORLD INIT_FILE IN_DIR OUT_DIR

Reads the seeded inputs ``IN_DIR/inputs.pkl``: the (arch, preset) train
cases, each a reduced bf16 model's state and batches, the (arch, preset,
dtype) prefill cases and the (arch, preset, dtype) serving cases. Writes to
``OUT_DIR/rank{RANK}.pkl`` every case's metrics a step and (rank 0) the
gathered state after the last step, each prefill's logits block with this
rank's mesh coordinate, each serving case's logits blocks a step and final
state piece (from the reference's one-device prefill, which its subprocess
writes to ``IN_DIR/serve_prefill.pkl`` first), and commits the first
case's state sharded to ``inputs["commit_dir"]``; then yi-6b's train steps
under ``decode`` and the bytes a ``decode`` step hands each collective at
two cache lengths. Imports no JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import sys
import time
from pathlib import Path


def serve_config(inputs: dict, arch: str, dtype: str):
    """A serving case's config: the reduced ``arch`` in ``dtype`` with the
    inputs' overrides (a shorter SWA ring that the steps wrap)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                               **inputs["serve_over"].get(arch, {}))


@contextlib.contextmanager
def decode_chunk(slots: int):
    """Decode attention's products ``slots`` cache slots a chunk
    (``models/layers.py`` ``DECODE_CHUNK``) while the block runs."""
    from repro_torch.models import layers
    was, layers.DECODE_CHUNK = layers.DECODE_CHUNK, slots
    try:
        yield
    finally:
        layers.DECODE_CHUNK = was


def wait_prefill(in_dir, alive=lambda: True, timeout: float = 600.0) -> dict:
    """The reference's one-device prefill states, once its subprocess has
    written them (``serve_prefill.pkl``, renamed into place whole)."""
    path = Path(in_dir) / "serve_prefill.pkl"
    deadline = time.monotonic() + timeout
    while not path.exists():
        if not alive() or time.monotonic() > deadline:
            raise RuntimeError("the reference wrote no prefill states")
        time.sleep(0.05)
    return pickle.loads(path.read_bytes())


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

    # ---- the serving presets: the reference's prefill, then decode steps ----
    prefilled = wait_prefill(inputs["serve_dir"]) if inputs["serves"] else {}
    for i, (arch, preset, dtype) in enumerate(inputs["serves"]):
        key = f"{arch}_{preset}_{dtype}"
        cfg = serve_config(inputs, arch, dtype)
        flat = inputs[f"{arch}_state"]
        masters = interop.train_state_from_jax(cfg, flat, "cpu").params
        whole = interop.model_params_from_jax(cfg, TS.adamw.map_tree(lambda t: t.numpy(),
                                                                     masters), "cpu")
        params = TS.mesh_serve_params(cfg, mesh, preset, whole, "cpu")
        if i == 0:
            # ... and the same slices gathered from this rank's master shards
            shards = interop.train_state_to_mesh(cfg, flat, mesh, preset, device="cpu").params
            gathered = TS.mesh_serve_params(cfg, mesh, preset, shards, "cpu")
            out["serve_weights_equal"] = all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(params.parameters(), gathered.parameters()))
        state = interop.decode_state_from_numpy(cfg, prefilled[key], "cpu", mesh, preset)
        with sharding.use(mesh, preset):
            step = TS.make_serve_step(cfg)
        logits = []
        with decode_chunk(inputs["decode_chunk"]):
            for x in inputs[f"serve_{key}"]["steps"]:
                lg, state = step(params, state, {k: torch.from_numpy(v) for k, v in x.items()})
                logits.append(lg.numpy().copy())
        out[f"serve_{key}"] = (logits, interop.decode_state_to_numpy(state))

    # ---- every preset trains: yi-6b under decode (train_tp_nosp's layout) ----
    for arch, preset in inputs["train_under"]:
        cfg = config(arch)
        with sharding.use(mesh, preset):
            step = TS.make_train_step(cfg)
            state = interop.train_state_to_mesh(cfg, inputs[f"{arch}_state"], mesh,
                                                device="cpu")
        out[f"train_{arch}_{preset}"] = [
            {k: float(v) for k, v in step(state, {k: torch.from_numpy(v)
                                                  for k, v in b.items()})[1].items()}
            for b in inputs[f"{arch}_batches"]]

    # ---- no cache gathered: a decode step's collectives at two lengths ----
    from repro_torch.models.transformer import decode_state_init
    from repro_torch.parallel import collectives
    cfg = config("yi-6b")
    if inputs["bytes_lengths"]:
        params = TS.mesh_serve_params(cfg, mesh, "decode", interop.train_state_to_mesh(
            cfg, inputs["yi-6b_state"], mesh, "decode", device="cpu").params, "cpu")
        with sharding.use(mesh, "decode"):
            step = TS.make_serve_step(cfg)
    for C in inputs["bytes_lengths"]:
        state = TS.decode_state_piece(cfg, decode_state_init(cfg, 4, C, device="meta"), mesh,
                                      "decode", "cpu")
        steps = []
        for t in range(2):
            collectives.reset_bytes()
            _, state = step(params, state, {"token": torch.arange(4, dtype=torch.int32) + t})
            steps.append(dict(collectives.BYTES))
        out[f"bytes_{C}"] = (steps, tuple(state["blocks_0"]["k"].shape))
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
