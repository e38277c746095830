"""The dry-run readings ``tests/test_torch_dryrun.py`` compares, each in the
process it needs (a process holds one process group, and the reference
fixes its device count when JAX starts):

    python tests/torch_dryrun_cells.py reference OUT
        the JAX package on 512 fake CPU devices: ``static_bytes_per_device``
        of every cell on both production meshes (its ``_sharded_bytes``
        formula, placements only), the compiled dot FLOPs and wire bytes of
        ``CELLS`` on a 2 x 2 Auto-axis mesh and of ``POD_CELLS`` on the pod
        mesh, the ring factors on one collective of each kind, and the
        record of a skipped cell;
    python tests/torch_dryrun_cells.py port WORLD RANK OUT
        the port as rank RANK of a fake world of WORLD ranks: on 256 or 512
        the static bytes of every cell from ``lower_cell`` (no step run), on
        4 ``count_step`` of every cell of ``CELLS`` on a 2 x 2 mesh, and of
        each reduced one again on zeros on the CPU.

Cells named after OUT (``arch/shape[/rules]``) replace ``CELLS``.

    python tests/torch_dryrun_cells.py reference-sweep OUT pod|multipod
        the reference's ``run_cell`` on every cell of one production mesh
        (Auto axes), its records under OUT/<mesh> (the comparison in
        PERF.md; never the reference's experiments/dryrun);
    python tests/torch_dryrun_cells.py table PORT_DIR REF_DIR
        PERF.md's table: the port's sweep beside the reference's, each gap
        split into the named terms (``flop_terms``).

Each writes one JSON file to OUT. ``SHAPES`` and ``CONFIGS`` hold the
shortened shapes and reduced configs; both packages take them into their own
registries inside the process (no file of either changes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

#: shortened shapes: name -> (seq_len, global_batch, kind)
SHAPES = {"prefill_256": (256, 4, "prefill"), "train_128": (128, 4, "train"),
          "decode_256": (256, 4, "decode"), "decode_b1_256": (256, 1, "decode")}
#: reduced configs: name -> (arch, fields replaced in its REDUCED config)
CONFIGS = {"yi-smoke": ("yi-6b", {}),
           "yi-smoke-dots": ("yi-6b", {"remat": "dots"}),
           "yi-smoke-kv1": ("yi-6b", {"n_kv_heads": 1}),
           "mixtral-smoke": ("mixtral-8x7b", {}),
           "phi-smoke": ("phi3.5-moe-42b-a6.6b", {}),
           "rwkv-smoke": ("rwkv6-7b", {}),
           "rg-smoke": ("recurrentgemma-9b", {})}
#: (arch or reduced config, shape, rules or None) on the 2 x 2 mesh
CELLS = (("yi-6b", "decode_32k", None),
         ("yi-smoke", "prefill_256", None),
         ("yi-smoke", "decode_b1_256", None),
         ("mixtral-smoke", "train_128", None),
         ("mixtral-smoke", "prefill_256", None),
         ("phi-smoke", "train_128", "train_dp_ep"),
         ("yi-smoke-dots", "train_128", None),
         ("yi-smoke-kv1", "decode_256", None),
         ("rg-smoke", "decode_256", None),
         ("rg-smoke", "decode_b1_256", None),
         ("rwkv-smoke", "prefill_256", None))
#: cells compiled on the reference's pod mesh
POD_CELLS = (("yi-6b", "decode_32k"),)
#: the collectives of the ring-factor probe, each on one f32 (8, 16) shard
#: over 'model' (2 ranks) and over ('data', 'model') (4)
KINDS_ORDER = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
RING_PROBE = tuple((k, axes, (8, 16)) for k in KINDS_ORDER
                   for axes in (("model",), ("data", "model")))


def cell_key(arch, shape, rules=None) -> str:
    return "/".join(x for x in (arch, shape, rules) if x)


def _install(shapes_mod, dryrun_mod, get_config, case_cls) -> None:
    """The shortened shapes into ``shapes_mod.SHAPES`` (the dict both the
    shapes and the dry-run module read) and the reduced configs into the dry
    run's ``get_config``."""
    for name, (seq, batch, kind) in SHAPES.items():
        shapes_mod.SHAPES[name] = case_cls(name, seq, batch, kind)
    cfgs = {name: dataclasses.replace(get_config(arch, reduced=True), **over)
            for name, (arch, over) in CONFIGS.items()}
    dryrun_mod.get_config = lambda a: cfgs[a] if a in cfgs else get_config(a)


def reference(out: str, cells=CELLS) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import ARCH_IDS, get_config, input_specs, shape_applicable
    from repro.configs import shapes as S
    from repro.launch import dryrun as D
    from repro.launch import hlo_analysis
    from repro.models.transformer import abstract_params, decode_state_specs
    from repro.parallel import sharding

    t0 = time.time()
    devs = np.array(jax.devices())
    # Auto-axis meshes: make_production_mesh's jax.make_mesh gives Explicit
    # axes on this jax, which the reference's logical_constraint refuses
    meshes = {"pod": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
              "multipod": Mesh(devs[:512].reshape(2, 16, 16), ("pod", "data", "model"))}
    res = {"static": {}, "flops": {}, "wire": {}, "pod_flops": {}, "ring": {}}

    # static_bytes_per_device: dryrun.py's formula, no lowering
    for mname, mesh in meshes.items():
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            pshapes, pspecs = abstract_params(cfg)
            for shape, case in list(S.SHAPES.items()):
                if not shape_applicable(cfg, shape):
                    continue
                if case.kind == "train":
                    multi = "pod" in mesh.axis_names
                    if multi:
                        rules = "train_multi_moe" if cfg.family == "moe" else "train"
                    elif cfg.family == "moe" and cfg.n_experts % 16 == 0:
                        rules = "train_dp_ep"
                    else:
                        rules = "train_dp"
                    with sharding.use(mesh, rules):
                        p_sh = sharding.tree_shardings(pspecs, mesh, shape_tree=pshapes)
                        static = D._sharded_bytes(pshapes, p_sh, mesh) * 3
                elif case.kind == "prefill":
                    rules = "prefill_moe" if cfg.family == "moe" else "train"
                    with sharding.use(mesh, rules):
                        p_abs = D._bf16_params(pshapes)
                        p_sh = sharding.tree_shardings(pspecs, mesh, shape_tree=p_abs)
                        static = D._sharded_bytes(p_abs, p_sh, mesh)
                else:
                    rules = "decode_b1" if case.global_batch == 1 else "decode"
                    spec = input_specs(cfg, shape)
                    with sharding.use(mesh, rules):
                        p_abs = D._bf16_params(pshapes)
                        p_sh = sharding.tree_shardings(pspecs, mesh, shape_tree=p_abs)
                        s_sh = sharding.tree_shardings(decode_state_specs(cfg), mesh,
                                                       shape_tree=spec["state"])
                        static = (D._sharded_bytes(p_abs, p_sh, mesh)
                                  + D._sharded_bytes(spec["state"], s_sh, mesh))
                res["static"][f"{mname}/{arch}/{shape}"] = [static, rules]
    res["static_s"] = time.time() - t0

    # compiled dot FLOPs and wire bytes, as run_cell reads them
    _install(S, D, get_config, S.ShapeCase)

    def compiled(arch, shape, mesh, rules=None):
        with mesh:
            lowered, aux = D.lower_cell(arch, shape, mesh, rules)
            got = hlo_analysis.analyze(lowered.compile().as_text())
        return int(got["dot_flops"]), got["collectives"], [aux["static_bytes_per_device"],
                                                           aux["rules"]]

    small = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    for arch, shape, rules in cells:
        flops, wire, static = compiled(arch, shape, small, rules)
        res["flops"][cell_key(arch, shape, rules)] = flops
        res["wire"][cell_key(arch, shape, rules)] = wire
        res["static"][f"2x2/{cell_key(arch, shape, rules)}"] = static
    for arch, shape in POD_CELLS:
        res["pod_flops"][cell_key(arch, shape)] = compiled(arch, shape, meshes["pod"])[0]

    # the ring factors on one collective of each kind (f32 shards)
    from jax.experimental.shard_map import shard_map
    for kind, axes, shard in RING_PROBE:
        n = int(np.prod([dict(zip(small.axis_names, small.devices.shape))[a] for a in axes]))
        ax = axes if len(axes) > 1 else axes[0]
        fn = {"all_reduce": lambda x: jax.lax.psum(x, ax),
              "all_gather": lambda x: jax.lax.all_gather(x, ax, axis=0, tiled=True),
              "reduce_scatter": lambda x: jax.lax.psum_scatter(x, ax, scatter_dimension=0,
                                                               tiled=True),
              "all_to_all": lambda x: jax.lax.all_to_all(x, ax, 0, 0, tiled=True)}[kind]
        sm = shard_map(fn, mesh=small, in_specs=P(("data", "model")),
                       out_specs=P(("data", "model")), check_rep=False)
        full = jax.ShapeDtypeStruct((shard[0] * 4,) + shard[1:], np.float32)
        text = jax.jit(sm, in_shardings=NamedSharding(small, P(("data", "model")))).lower(
            full).compile().as_text()
        res["ring"][f"{kind}/{n}"] = hlo_analysis.analyze(text)["collectives"]

    # a skipped cell's record
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        res["skip"] = D.run_cell("yi-6b", "long_500k", False, Path(d))
    res["seconds"] = time.time() - t0
    Path(out).write_text(json.dumps(res))


def _on_cpu(obj):
    """A step's meta arguments as zeros on the CPU (a module's parameters
    and buffers made in place)."""
    import torch
    if isinstance(obj, torch.nn.Module):
        return obj.to_empty(device="cpu")
    if isinstance(obj, torch.Tensor):
        return torch.zeros(obj.shape, dtype=obj.dtype)
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_on_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def port(world: int, rank: int, out: str, cells=CELLS) -> None:
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.set_num_threads(1)
    dist.init_process_group("fake", rank=rank, world_size=world, store=FakeStore())
    from pathlib import Path
    from repro_torch.configs import ARCH_IDS, get_config, shape_applicable
    from repro_torch.configs import shapes as S
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    t0 = time.time()
    res = {"static": {}, "cells": {}, "cpu": {}}
    if world in (256, 512):
        mname = "pod" if world == 256 else "multipod"
        mesh = make_production_mesh(multi_pod=world == 512, device="cpu")
        for arch in ARCH_IDS:
            for shape in S.SHAPES:
                if shape_applicable(get_config(arch), shape):
                    _, _, aux = D.lower_cell(arch, shape, mesh)
                    res["static"][f"{mname}/{arch}/{shape}"] = [aux["static_bytes_per_device"],
                                                                 aux["rules"]]
    else:
        _install(S, D, get_config, S.ShapeCase)
        mesh = make_test_mesh(2, 2, device="cpu")
        for arch, shape, rules in cells:
            key = cell_key(arch, shape, rules)
            step, args, aux = D.lower_cell(arch, shape, mesh, rules)
            got = D.count_step(step, args)
            got.pop("compile_s")
            res["cells"][key] = {**aux, **got}
            if arch in CONFIGS:
                # the same step on zeros on the CPU (the fake group's
                # collectives leave their outputs unwritten; only shapes count)
                step, args, _ = D.lower_cell(arch, shape, mesh, rules)
                got = D.count_step(step, _on_cpu(args))
                got.pop("compile_s")
                res["cpu"][key] = got
    res["seconds"] = time.time() - t0
    Path(out).write_text(json.dumps(res))


def reference_sweep(out: str, mesh_name: str) -> None:
    """The reference's own ``run_cell`` on every cell of one production mesh
    (Auto axes), its records written under ``out/<mesh>``; a cell that
    raises gets an ``error`` record."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import traceback
    from pathlib import Path
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import ARCH_IDS, SHAPES as REF_SHAPES
    from repro.launch import dryrun as D
    devs = np.array(jax.devices())
    D.make_production_mesh = lambda multi_pod=False: (
        Mesh(devs[:512].reshape(2, 16, 16), ("pod", "data", "model")) if multi_pod
        else Mesh(devs[:256].reshape(16, 16), ("data", "model")))
    for arch in ARCH_IDS:
        for shape in REF_SHAPES:
            try:
                D.run_cell(arch, shape, mesh_name == "multipod", Path(out))
            except Exception as e:          # recorded, as the reference's main does
                traceback.print_exc()
                D._write(Path(out), mesh_name, arch, shape,
                         {"arch": arch, "shape": shape, "status": "error", "error": str(e)})


# ---------------------------------------------------------------------------
# the named differences between the port's dot FLOPs a rank and the
# reference's compiled count (PERF.md's table; the 2 x 2 tests)
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh's names and shape, enough for the port's rules."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names, self.shape = tuple(sizes), tuple(sizes.values())


MESH_SIZES = {"pod": {"data": 16, "model": 16},
              "multipod": {"pod": 2, "data": 16, "model": 16},
              "2x2": {"data": 2, "model": 2}}


def _geometry(cfg, case, mesh_name: str, rules: str) -> dict:
    """Tokens a rank's blocks see, and each weight's local width, under
    ``rules``: whole under ZeRO-3 (the batch split over 'model' too), this
    rank's slice over 'model' under the TP and serving presets where the
    unit splits (``steps.use_keep``)."""
    import math
    from repro_torch.parallel import sharding
    sizes = MESH_SIZES[mesh_name]
    m = sizes["model"]
    with sharding.use(_Mesh(sizes), rules):
        bx = sharding.batch_axes(case.global_batch)
    rows = case.global_batch // math.prod(sizes[a] for a in bx)
    tp = "model" not in bx
    H, G = cfg.n_heads, cfg.n_kv_heads
    heads = tp and H % m == 0
    kv_split = heads and G % m == 0

    def cut(n, ok=True):
        return n // m if tp and ok and n % m == 0 else n
    return {"m": m, "data": sizes["data"], "tp": tp, "kv_whole": tp and not kv_split,
            "tokens": rows * (1 if case.kind == "decode" else case.seq_len),
            "rows": rows, "H": cut(H, heads), "G": cut(G, kv_split), "ff": cut(cfg.d_ff),
            "rnn": cut(cfg.d_rnn or 0), "rwkv": cut(cfg.d_model, (cfg.d_model // 64) % m == 0)}


def _kinds(cfg) -> list:
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def kv_replicated(cfg, geo: dict, passes: int = 1) -> int:
    """The K and V projections a rank computes whole where its kv heads do
    not split over 'model' (``use_keep``) and XLA splits the product:
    (m - 1) / m of 2 x tokens x d x 2 G hd in every attention layer, a pass
    each (a train step: the forward and the two products of the
    backward)."""
    if not geo["kv_whole"]:
        return 0
    n = sum(k not in ("rglru", "rwkv") for k in _kinds(cfg))
    whole = 2 * geo["tokens"] * cfg.d_model * 2 * cfg.n_kv_heads * cfg.head_dim
    return passes * n * whole * (geo["m"] - 1) // geo["m"]


def remat_recompute(cfg, geo: dict, dense_moe: bool) -> int:
    """The weight products of the scanned blocks that the port's whole-block
    checkpoint recomputes in the backward and the reference's
    ``checkpoint_dots_with_no_batch_dims`` saves (a product with no batch
    dim: a weight's, at this rank's widths), less the block's last product,
    whose output no backward reads (the non-reentrant checkpoint stops once
    the tensors the backward needs are back). Both recompute the products
    with batch dims: attention's scores and values, the shard_map experts'
    einsums, RWKV's chunk products."""
    if cfg.remat == "none":
        return 0
    d, hd, g = cfg.d_model, cfg.head_dim, geo
    attn = d * g["H"] * hd * 2 + d * g["G"] * hd * 2
    mlp_in = 2 * d * g["ff"]
    per = {"dense": attn + mlp_in, "local": attn + mlp_in,
           "moe": attn + d * cfg.n_experts + (2 * d * cfg.n_experts * g["ff"]
                                              if dense_moe else 0),
           "rglru": 2 * d * g["rnn"] + 2 * cfg.d_rnn * g["rnn"] + g["rnn"] * d + mlp_in,
           "rwkv": 5 * d * g["rwkv"] + g["rwkv"] * d + d * g["ff"]}
    scanned = _kinds(cfg)[:len(cfg.pattern) * (cfg.n_layers // len(cfg.pattern))]
    return sum(2 * g["tokens"] * per[k] for k in scanned)


def rwkv_bonus(cfg, geo: dict, passes: int = 1) -> int:
    """RWKV's bonus r . (u * k), a token and head, over a sequence: an
    einsum the reference's HLO counts as a dot, a multiply-and-sum (no
    matmul) in the port; a pass each (a train step: the forward, the
    recompute and three products of its backward). A decode step folds it
    into a product both count."""
    if "rwkv" not in cfg.pattern:
        return 0
    heads = geo["rwkv"] // 64
    return passes * cfg.n_layers * 2 * geo["tokens"] * heads * 64


def router_split(cfg, geo: dict) -> int:
    """A dense MoE train step on 16 'model' ranks: the router's product and
    the two of its backward, which the port computes whole on every
    'model' rank and the reference's XLA splits over them at this size (on
    a 2 x 2 mesh it computes them whole too): (m - 1) / m of 3 x 2 x tokens
    x d x E an MoE layer."""
    if geo["m"] < 16 or not geo["tp"]:
        return 0
    n = sum(k == "moe" for k in _kinds(cfg))
    return n * 3 * 2 * geo["tokens"] * cfg.d_model * cfg.n_experts * (geo["m"] - 1) // geo["m"]


def rglru_data_split(cfg, geo: dict) -> int:
    """A ``decode_b1`` step (the batch whole on every rank): two of each
    RG-LRU layer's d x rnn-slice input products, which the port computes
    whole on every 'data' rank and XLA splits over 'data': (n - 1) / n of 2
    x 2 x lanes x d x rnn_slice an RG-LRU layer."""
    n = geo["data"]
    layers = sum(k == "rglru" for k in _kinds(cfg))
    return layers * 2 * 2 * geo["tokens"] * cfg.d_model * geo["rnn"] * (n - 1) // n


def flop_terms(cfg, case, mesh_name: str, rules: str) -> dict:
    """{term: the port's dot FLOPs a rank less the reference's} of one cell
    (PERF.md: the sweep; tests/test_torch_dryrun.py: the 2 x 2 cells)."""
    geo = _geometry(cfg, case, mesh_name, rules)
    train = case.kind == "train"
    from repro_torch.parallel import sharding
    dense_moe = bool(sharding.presets()[rules].get("_moe_dense"))
    terms = {"kv": kv_replicated(cfg, geo, 3 if train else 1),
             "remat": remat_recompute(cfg, geo, dense_moe) if train else 0,
             "bonus": -rwkv_bonus(cfg, geo, {"train": 5, "prefill": 1}.get(case.kind, 0)),
             "router": router_split(cfg, geo) if train and dense_moe else 0,
             "rglru": rglru_data_split(cfg, geo) if rules == "decode_b1" else 0}
    return {k: v for k, v in terms.items() if v}


def table(port_dir: str, ref_dir: str) -> None:
    """PERF.md's table of the sweep, a row a cell, the pod mesh before the
    multi-pod one in each column: the port's records under
    ``port_dir/<mesh>`` beside the reference's under ``ref_dir/<mesh>``;
    each FLOP gap split into ``flop_terms`` (a remainder is printed as
    ``rest``)."""
    from pathlib import Path
    from repro_torch.configs import ARCH_IDS, SHAPES as CASES, get_config

    def load(root, mesh, arch, shape):
        p = Path(root) / mesh / f"{arch}__{shape}.json"
        return json.loads(p.read_text()) if p.exists() else None

    def gb(x):
        return f"{x / 1e9:.3f}"
    print("| cell | rules | dot FLOPs a device: port / reference (gap) | named terms | "
          "static / argument GB | wire GB: port / reference |")
    print("|---|---|---|---|---|---|")
    skipped = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in CASES:
            cols = [[] for _ in range(5)]
            names, rests = set(), []
            for mesh in ("pod", "multipod"):
                r, ref = load(port_dir, mesh, arch, shape), load(ref_dir, mesh, arch, shape)
                if r is None or r["status"] != "ok":
                    cols[0].append(str(r and r["status"]))
                    continue
                ours = r["dot_flops_per_device"]
                theirs = ref["dot_flops_per_device"] if ref and ref["status"] == "ok" else None
                terms = flop_terms(cfg, CASES[shape], mesh, r["rules"])
                names.update(terms)
                cols[0].append(r["rules"])
                if theirs is None:
                    cols[1].append(f"{ours:.4e} / —")
                else:
                    cols[1].append(f"{ours:.4e} / {theirs:.4e} ({(ours - theirs) / theirs:+.2%})")
                    if ours - theirs - sum(terms.values()):
                        rests.append(f"{mesh} rest {ours - theirs - sum(terms.values()):+.4g}")
                cols[2].append(f"{gb(r['static_bytes_per_device'])} / "
                               f"{gb(r['memory_analysis']['argument_bytes'])}")
                theirs_w = sum(ref["collective_wire_bytes"].values()) if theirs else None
                cols[3].append(f"{gb(sum(r['collective_wire_bytes'].values()))} / "
                               + (gb(theirs_w) if theirs_w is not None else "—"))
            if not cols[1]:
                skipped.append(f"{arch} × {shape} ({'; '.join(cols[0])})")
                continue
            terms = " + ".join(sorted(names)) or "none"
            print(f"| {arch} × {shape} | {'; '.join(cols[0])} | {'; '.join(cols[1])} | "
                  f"{', '.join([terms] + rests)} | {'; '.join(cols[2])} | {'; '.join(cols[3])} |")
    print(f"\nNot run: {', '.join(skipped)}.")


def _cells(argv) -> tuple:
    """``CELLS``, or the cells named (``arch/shape[/rules]``) after the
    output path."""
    if not argv:
        return CELLS
    return tuple(tuple((k.split("/") + [None])[:3]) for k in argv)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2], _cells(sys.argv[3:]))
    elif sys.argv[1] == "reference-sweep":
        reference_sweep(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "table":
        table(sys.argv[2], sys.argv[3])
    else:
        port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], _cells(sys.argv[5:]))
