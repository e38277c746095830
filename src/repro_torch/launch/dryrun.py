"""Multi-pod dry run — the port of ``repro.launch.dryrun``: every (architecture
x input-shape) cell's step built for one rank of the production mesh and run
once on the meta device, with what that rank multiplies, holds and sends.

The reference lowers and compiles one SPMD program over 256 or 512 fake CPU
devices and reads the partitioned HLO. The port has no SPMD program: each
rank runs its own eager step and calls the collectives of
``parallel.collectives`` itself. So its dry run is rank 0 of a fake world of
256 or 512 ranks (``torch.distributed``'s "fake" backend: a collective
returns at once and moves nothing) on the production mesh
(``launch.mesh.make_production_mesh``). For each cell:

  1. ``lower_cell``: the step and its arguments on the meta device (shapes
     and dtypes, no storage): a train step over this rank's f32 master
     shards and zero moments, a prefill over the same shards, a serve step
     over this rank's bf16 weight slices and its piece of the decode state;
     the inputs are ``input_specs``'s global batch;
  2. ``count_step``: one call of the step under ``FlopCounterMode`` with the
     collectives' counter reset: the matmul FLOPs of the rank (forward,
     backward and the blocks' recompute) and the bytes it handed each kind
     of collective, by the size of the group (``collectives.CALLS``), turned
     into wire bytes with the reference's ring factors (``wire_bytes``);
  3. the bytes the rank holds: ``static_bytes_per_device`` by the
     reference's definition (the f32 parameter shards x 3 for a train step,
     the bf16 shards for a prefill, the bf16 shards and the decode state's
     for a serve step), from the port's placements; and in
     ``memory_analysis`` the port's own tensors (``argument_bytes``: the
     step's arguments and what it keeps between calls, ``kept``).

``repro.launch.hlo_analysis`` has no twin: it parses HLO text and multiplies
``while`` bodies by their trip counts, and an eager step has neither —
FlopCounterMode sees every iteration of every loop and the counter every
collective. Nor has ``--save-hlo``: there is no HLO to save.

Rank 0 stands for every rank: every rank runs the same program on shards of
equal shapes (a placement splits a dim only into equal pieces), and on the
meta device no branch depends on data (an MoE's experts are counted at
capacity, ``models/moe.py``), so the counts are the same at every
coordinate of the mesh.

Records land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json, never
in the reference's experiments/dryrun. No card is needed:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.moe import mesh_variant
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import leaves
from repro_torch.parallel import collectives, sharding
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.train import steps

#: the collectives' kinds under the reference's spellings
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

#: the ring algorithm's wire bytes of one call over a group of n that was
#: handed b bytes (hlo_analysis's factors, which it applies to the result's
#: size: an all-gather's result is n * b, a reduce-scatter's b / n)
_RING = {"all_reduce": lambda b, n: 2 * b * (n - 1) / n,
         "all_gather": lambda b, n: b * (n - 1),
         "reduce_scatter": lambda b, n: b * (n - 1) / n,
         "all_to_all": lambda b, n: b * (n - 1) / n}

SKIP_REASON = "long_500k needs sub-quadratic attention (full-attention arch; DESIGN.md SS5)"
NO_HLO = ("an eager step has no HLO: flops_raw, bytes_raw and hlo_bytes have no counterpart "
          "in the port")
NO_TEMP = ("the meta device allocates nothing, so a step's transient peak is not measured; "
           "argument_bytes is what the rank holds between calls")

_WORLD = {"fake": None}


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks with this process as rank 0,
    unless a group of ``n`` ranks is up already. One of another size that
    this module started is replaced (its cached axis groups dropped);
    another's raises."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if _WORLD["fake"] is None:
            raise ValueError(f"a process group of {dist.get_world_size()} ranks is up; the dry "
                             f"run needs {n}")
        dist.destroy_process_group()
        collectives.clear_groups()
    # the fake backend registers itself on this import
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    _WORLD["fake"] = n


def _meta_shards(layout) -> dict:
    """f32 tensors on the meta device of this rank's shard shapes."""
    return sharding.tree_map(
        lambda pl: torch.empty(pl.local_shape, dtype=torch.float32, device="meta"), layout)


def _placed_bytes(layout, like=None, itemsize: int = 0) -> int:
    """This rank's bytes of every leaf of ``layout``: a placement's local
    elements times ``itemsize``, or the matching leaf's of ``like``."""
    sizes = sharding.tree_map(
        lambda pl, *t: math.prod(pl.local_shape) * (t[0].element_size() if t else itemsize),
        layout, *(() if like is None else (like,)))
    return sum(leaves(sizes))


def _moe_experts(cfg, case, mesh, rules) -> str | None:
    """How an MoE cell's experts are counted: ``"dense"`` where the rules
    run every expert on every token, else ``"capacity"`` (``cap`` rows an
    expert and a batch row, the reference's buffer)."""
    if cfg.n_experts == 0:
        return None
    with sharding.use(mesh, rules):
        B = case.global_batch
        rows = B // math.prod(mesh_shape(mesh)[a] for a in sharding.batch_axes(B))
        return "dense" if mesh_variant(cfg.moe_cfg(), cfg.d_model, rows) == "dense" else "capacity"


def lower_cell(arch: str, shape: str, mesh, rules: str | None = None):
    """(step, its arguments on the meta device, aux) of one cell on
    ``mesh``, this process's rank; ``aux``: ``static_bytes_per_device``,
    ``rules`` and ``moe_experts``. The rules default as the reference's do."""
    cfg = get_config(arch)
    case = SHAPES[shape]
    spec = input_specs(cfg, shape)

    if case.kind == "train":
        # the reference's choice: pure DP (ZeRO-3) with the shard_map MoE on
        # one pod; TP + SP on the multi-pod mesh, whose global batch (256)
        # is smaller than its 512 ranks
        multi = "pod" in mesh.mesh_dim_names
        if rules is None:
            if multi:
                rules = "train_multi_moe" if cfg.family == "moe" else "train"
            elif cfg.family == "moe" and cfg.n_experts % 16 == 0:
                rules = "train_dp_ep"
            else:
                rules = "train_dp"
        step = steps.make_mesh_train_step(cfg, mesh, rules)
        args = (steps.train_state_init(_meta_shards(step.layout)), spec["batch"])
        static = _placed_bytes(step.layout, itemsize=4) * 3     # params + m + v
    elif case.kind == "prefill":
        rules = rules or ("prefill_moe" if cfg.family == "moe" else "train")
        step = steps.make_mesh_prefill_step(cfg, mesh, rules)
        args = (_meta_shards(step.layout), spec["batch"])
        static = _placed_bytes(step.layout, itemsize=2)          # the bf16 shards
    else:
        rules = rules or ("decode_b1" if case.global_batch == 1 else "decode")
        step = steps.make_mesh_serve_step(cfg, mesh, rules)
        params = steps.mesh_serve_params(cfg, mesh, rules, Transformer(cfg, "meta"), "meta")
        state = steps.decode_state_piece(cfg, spec["state"], mesh, rules, "meta")
        args = (params, state, spec["inputs"])
        with sharding.use(mesh, rules):
            layout = steps.mesh_layout(cfg, mesh)
        static = (_placed_bytes(layout, itemsize=2)
                  + _placed_bytes(steps.decode_layout(cfg, spec["state"], mesh, rules),
                                  spec["state"]))
    return step, args, {"static_bytes_per_device": static, "rules": rules,
                        "moe_experts": _moe_experts(cfg, case, mesh, rules)}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def held_bytes(*objs) -> int:
    """The bytes of the distinct storages of every tensor under ``objs``
    (tensors, modules' parameters and buffers, dicts, lists, tuples), each
    counted once, views included (on the meta device too, where no storage
    has an address)."""
    seen, total = set(), 0
    for t in _tensors(objs):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def kept(step) -> list:
    """What a mesh step keeps between calls beside its arguments: the
    working model a train or prefill step binds (``held["bound"]``, its
    gathered bf16 buffers) and a train step's last gradient shards
    (``held["grads"]``)."""
    held = getattr(step, "held", {})
    bound = held.get("bound")
    return [None if bound is None else bound.model, held.get("grads")]


def wire_bytes(calls) -> tuple:
    """({kind: wire bytes}, {kind: calls}) under the reference's spellings
    from ``collectives.CALLS``, with the ring factors for a group of n and b
    bytes handed in: all-reduce 2b(n-1)/n, all-gather of a b-byte shard
    b(n-1), reduce-scatter of a b-byte input b(n-1)/n, all-to-all b(n-1)/n."""
    wire, counts = {}, {}
    for (kind, n), (k, b) in sorted(calls.items()):
        name = KINDS[kind]
        wire[name] = wire.get(name, 0.0) + _RING[kind](b, n)
        counts[name] = counts.get(name, 0) + k
    return wire, counts


def count_step(step, args) -> dict:
    """One call of ``step(*args)`` under ``FlopCounterMode`` with the
    collectives' counter reset: ``dot_flops_per_device``, the wire bytes and
    calls a kind (``wire_bytes``), the bytes handed in a kind
    (``collective_input_bytes``, ``collectives.BYTES``),
    ``memory_analysis`` and ``compile_s`` (the call's seconds)."""
    from torch.utils.flop_counter import FlopCounterMode
    collectives.reset_bytes()
    t0 = time.time()
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    seconds = time.time() - t0
    wire, counts = wire_bytes(collectives.CALLS)
    return {"dot_flops_per_device": fc.get_total_flops(),
            "collective_wire_bytes": wire, "collective_counts": counts,
            "collective_input_bytes": {KINDS[k]: v for k, v in collectives.BYTES.items() if v},
            "memory_analysis": {"argument_bytes": held_bytes(args, kept(step)),
                                "output_bytes": held_bytes(out), "temp_bytes": None,
                                "generated_code_bytes": None, "temp_bytes_why": NO_TEMP},
            "compile_s": seconds}


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path, rules: str | None = None):
    """One cell on the production mesh (a fake world of 256 or 512 ranks,
    started here unless one of that size is up), written to
    ``out_dir/<mesh>/<arch>__<shape>.json``. ``lower_s``: the seconds to
    build the mesh, the step and its meta arguments; ``compile_s``: the
    seconds of the step's one call on meta (the port compiles nothing; the
    counts come from this call)."""
    mesh_name = "multipod" if multi_pod else "pod"
    cfg = get_config(arch)
    if not shape_applicable(cfg, shape):
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "skipped",
               "reason": SKIP_REASON}
        _write(out_dir, mesh_name, arch, shape, rec)
        print(f"[dryrun] {arch} x {shape} x {mesh_name}: SKIP (full attention)")
        return rec

    n_dev = 512 if multi_pod else 256
    fake_world(n_dev)
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    step, args, aux = lower_cell(arch, shape, mesh, rules)
    t_lower = time.time() - t0
    res = count_step(step, args)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok",
        "rules": aux["rules"], "n_devices": n_dev,
        "flops_raw": None, "bytes_raw": None,
        "dot_flops_per_device": res["dot_flops_per_device"],
        "memory_analysis": res["memory_analysis"],
        "static_bytes_per_device": aux["static_bytes_per_device"],
        "collective_wire_bytes": res["collective_wire_bytes"],
        "collective_counts": res["collective_counts"],
        "collective_input_bytes": res["collective_input_bytes"],
        "moe_experts": aux["moe_experts"],
        "lower_s": round(t_lower, 1), "compile_s": round(res["compile_s"], 1),
        "hlo_bytes": None, "no_hlo": NO_HLO,
    }
    _write(out_dir, mesh_name, arch, shape, rec)
    print(f"[dryrun] {arch} x {shape} x {mesh_name}: OK "
          f"dotflops={rec['dot_flops_per_device']:.3e} "
          f"colls={sum(rec['collective_counts'].values()):.0f} "
          f"static={aux['static_bytes_per_device'] / 2**30:.2f}GiB/dev "
          f"args={rec['memory_analysis']['argument_bytes'] / 2**30:.2f}GiB/dev "
          f"(lower {t_lower:.0f}s run {res['compile_s']:.0f}s)")
    return rec


def _write(out_dir: Path, mesh_name: str, arch: str, shape: str, rec: dict):
    d = Path(out_dir) / mesh_name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{arch}__{shape}.json").write_text(json.dumps(rec, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--rules", default=None)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()
    out = Path(args.out)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multipod"]

    failures = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                tag = f"{a}__{s}.json"
                if args.skip_existing and (out / ("multipod" if mp else "pod") / tag).exists():
                    continue
                try:
                    run_cell(a, s, mp, out, args.rules)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((a, s, mp, str(e)))
                    _write(out, "multipod" if mp else "pod", a, s,
                           {"arch": a, "shape": s, "status": "error", "error": str(e)})
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
