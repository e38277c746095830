"""One run of one cell: set-up, the timed window, the check, the result.

Everything a cell is made of is found by name. ``BENCHMARK.json`` names the
cell's configuration (``configs[].file``) and traffic mix; the mix is
``bench/traffic/<traffic>.json``, the cell's own settings (the table's
start, the record count, the traced batches) are
``bench/workloads/<cell>.json``, and every metric, end to end or per
layer, is read by ``bench/metrics/<metric>.py`` from the run's record
(``Record``). A reader that finds nothing to read returns None and its
metric is left out.

The system under test is the port's table API (``repro_torch.core.DashEH``
/ ``DashLH``: ``insert`` and ``search``), driven by ``Program``. The check
holds what it produced against ``bench/reference.py`` after the window.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from bench import generator, reference, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: keys read back through the table's search per call after a fill
READBACK = 1 << 20


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack or the JAX package."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # bench/configs/<config>.json
    traffic: dict      # bench/traffic/<traffic>.json
    setup: dict        # bench/workloads/<cell>.json
    metrics: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files. ``overrides``
    (tests only) update the config, traffic and setup dicts key by key."""
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    parts = {"config": _json(ROOT / conf["file"]),
             "traffic": _json(BENCH / "traffic" / f"{w['traffic']}.json"),
             "setup": _json(BENCH / "workloads" / f"{name}.json")}
    for key, extra in (overrides or {}).items():
        parts[key].update(extra)
    return Cell(name=name, chips=w["chips"],
                metrics=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
                **parts)


def reader(metric: str):
    """``read(record)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class Program:
    """The port's table class at a cell's configuration, on ``device``."""

    def __init__(self, config: dict, device: str):
        import torch
        from repro_torch import core
        self.torch = torch
        self.device = torch.device(device)
        names = {f.name for f in dataclasses.fields(core.DashConfig)}
        self.fields = {k: v for k, v in config.items() if k in names}
        self.make_config = core.DashConfig
        self.cls = {"DashEH": core.DashEH, "DashLH": core.DashLH}[config["table"]]

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def prepare(self) -> None:
        """Build the CUDA kernels, or load them from the checkout's cache."""
        if self.cuda:
            from repro_torch.kernels import _build
            _build.load()

    def table(self, **start):
        return self.cls(self.make_config(**self.fields, **start), device=self.device)

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def counters(self, t) -> dict:
        return {"insert_rounds": t.insert_rounds, "n_splits": int(t.state.n_splits),
                "load_factor": t.load_factor}

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        return profile(activities=acts)

    def span(self, label: str):
        return self.torch.profiler.record_function(label)


class Tracer:
    """The traced sub-window of a ``--trace 1`` run: a fixed range of batch
    indices, the cell's ``trace`` (``first``, ``count``), so that every run
    and every seed traces the same work, whatever the host's speed. A load
    mix counts the batches of its first fill, a read mix those of its
    window; the range closes early where the fill ends first."""

    def __init__(self, system, enabled: bool, first: int, count: int):
        self.system, self.enabled = system, enabled
        self.first, self.count = first, count
        self.prof = self.span = None
        self.summary = None
        self.batches, self.ops, self.batch_ids = 0, 0, []

    @property
    def active(self) -> bool:
        return self.prof is not None

    def maybe_start(self, index: int) -> None:
        if not self.enabled or self.active or self.summary is not None:
            return
        if index != self.first:
            return
        self.prof = self.system.profiler()
        self.prof.__enter__()
        self.system.sync()
        self.span = self.system.span(trace.WINDOW_SPAN)
        self.span.__enter__()

    def call(self, label: str, fn, *args, **kw):
        """``fn(*args, **kw)``, in a span named ``label`` while tracing: the
        harness's own span around its call into the table API."""
        if not self.active:
            return fn(*args, **kw)
        with self.system.span(label):
            return fn(*args, **kw)

    def after_batch(self, ops: int, batch_id=None) -> None:
        if not self.active:
            return
        self.batches += 1
        self.ops += ops
        self.batch_ids.append(batch_id)
        if self.batches >= self.count:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        self.system.sync()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.summary = trace.from_profiler(self.prof)
        self.summary.update(batches=self.batches, ops=self.ops)
        self.prof = None


# ---------------------------------------------------------------------------
# the run's record: what the metric readers read
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    op: str                    # "insert" or "search"
    setup_s: float
    seconds: float = 0.0       # the window's length
    batches: int = 0
    attempted: int = 0         # operations sent in the window
    acked: int = 0             # inserts acknowledged INSERTED / lookups answered
    counters: dict = dataclasses.field(default_factory=dict)  # deltas over the window
    trace: dict | None = None  # Tracer.summary
    traced_keys: list = dataclasses.field(default_factory=list)  # key batches traced
    batch_ends: list = dataclasses.field(default_factory=list)   # window seconds, load mixes


def _add_deltas(total: dict, before: dict, after: dict) -> None:
    for k in ("insert_rounds", "n_splits"):
        total[k] = total.get(k, 0) + after[k] - before[k]
    total["load_factor"] = after["load_factor"]


# ---------------------------------------------------------------------------
# the load mix: fresh keys inserted in batches while the table grows
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Fill:
    """One table's worth of the load: the keys ``[0, done)`` of the traffic,
    the statuses of each batch, and what the table read back at its end.
    ``counters`` are the table's program counters when the fill began
    (traced runs)."""
    counters: dict
    done: int = 0
    statuses: list = dataclasses.field(default_factory=list)
    readback: tuple | None = None
    n_items: int = 0


def next_batch(cell: Cell, start: dict, done: int) -> int:
    """Keys in a fill's next batch, by the configuration's batch rule."""
    c = cell.config
    segments = 1 << start.get("init_depth", start.get("lh_base_log2"))
    return generator.batch_size(c["batch"], (c["num_buckets"] + c["num_stash"]) * c["num_slots"],
                                segments, done)


def insert_batches(cell: Cell, start: dict, t, keys, values, budget: int):
    """Insert ``keys[:budget]`` into a table made at ``start``, in batches."""
    done = 0
    out = []
    while done < budget:
        n = min(next_batch(cell, start, done), budget - done)
        out.append(t.insert(keys[done:done + n], values[done:done + n],
                            max_retries=cell.config["max_retries"]))
        done += n
    return out


def readback(t, keys):
    """(found, values) of every key in ``keys``, searched through the table."""
    parts = [t.search(keys[a:a + READBACK]) for a in range(0, keys.size, READBACK)]
    if not parts:
        return np.zeros(0, bool), np.zeros(0, np.uint32)
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def warm_up_load(cell: Cell, system, data) -> None:
    """Every path the window takes, on throwaway tables: the window's first
    batch at the cell's start, then a few thousand warm-up keys into a
    table of a few segments, which splits and doubles its directory."""
    start = cell.setup["start"]
    t = system.table(**start)
    insert_batches(cell, start, t, data.keys, data.values, next_batch(cell, start, 0))
    del t
    keys, start = data.warmup_keys, cell.setup["warmup"]["start"]
    t = system.table(**start)
    insert_batches(cell, start, t, keys, generator.expected_value(keys), keys.size)
    system.sync()


def load_window(cell: Cell, system, data, seconds: float, tracer: Tracer, rec: Record):
    """Whole fills for at least ``seconds``: each fill makes a fresh table
    at the cell's start and inserts the traffic's first ``records`` keys in
    rule-sized batches. The window closes at the end of the first fill that
    ends after ``seconds``, so every run times the same phases of the
    table's growth. Each fill's table is read back with the clock stopped."""
    records, retries = cell.setup["records"], cell.config["max_retries"]
    start = cell.setup["start"]
    fills = []
    paused = 0.0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 - paused < seconds:
        t = system.table(**start)
        fill = Fill(system.counters(t) if tracer.enabled else {})
        fills.append(fill)
        while fill.done < records:
            if len(fills) == 1:
                tracer.maybe_start(len(fill.statuses))
            n = min(next_batch(cell, start, fill.done), records - fill.done)
            lo = fill.done
            fill.statuses.append(tracer.call("table.insert", t.insert, data.keys[lo:lo + n],
                                             data.values[lo:lo + n], max_retries=retries))
            fill.done += n
            rec.batches += 1
            rec.batch_ends.append(time.perf_counter() - t0 - paused)
            tracer.after_batch(n)
        system.sync()
        elapsed = time.perf_counter() - t0 - paused
        tracer.stop()
        p = time.perf_counter()
        close_fill(system, t, fill, data, rec, tracer.enabled)
        del t
        paused += time.perf_counter() - p
        rec.seconds = elapsed
    return fills


def close_fill(system, t, fill: Fill, data, rec: Record, counted: bool) -> None:
    """What a fill's table produced, kept for the check: its item count and
    every acknowledged key read back."""
    if counted:
        _add_deltas(rec.counters, fill.counters, system.counters(t))
    fill.n_items = t.n_items
    fill.readback = readback(t, data.keys[:fill.done])


def check_load(fills, data) -> dict:
    """Each fill against the reference: every status, every key read back,
    the item count. Every fill inserts the same keys in the same batches,
    so one reference answers for all of them."""
    status = back = items = 0
    ref, want, found = None, None, None
    for fill in fills:
        if ref is None:
            ref = reference.Reference()
            want = ref.insert(data.keys[:fill.done], data.values[:fill.done])
            found = ref.search(data.keys[:fill.done])
        status += int(np.count_nonzero(np.concatenate(fill.statuses) != want))
        back += reference.mismatches(*fill.readback, *found)
        items += abs(fill.n_items - ref.n_items)
    return {"status_mismatch": status, "readback_mismatch": back, "items_mismatch": items}


# ---------------------------------------------------------------------------
# the read mix: lookups of loaded keys on a loaded table
# ---------------------------------------------------------------------------

def read_window(cell: Cell, data, t, seconds: float, tracer: Tracer, rec: Record):
    """Search the traffic's distinct batches in turn for ``seconds``. Answers
    of the first pass and of a seeded sample of later batches are kept."""
    share, most = cell.traffic["check_share"], cell.traffic["check_batches_max"]
    batches, kept, i = data.batches, [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        tracer.maybe_start(i)
        b = i % len(batches)
        found, values = tracer.call("table.search", t.search, batches[b])
        rec.acked += found.size
        rec.attempted += found.size
        rec.counters["not_found"] = (rec.counters.get("not_found", 0)
                                     + found.size - int(np.count_nonzero(found)))
        if len(kept) < most and (i < len(batches)
                                 or data.sample[i % data.sample.size] < share):
            kept.append((b, found, values))
        tracer.after_batch(found.size, b)
        i += 1
    rec.seconds = time.perf_counter() - t0
    rec.batches = i
    tracer.stop()
    return kept


def check_read(kept, preload, data) -> tuple:
    """The preload's statuses and the kept answers against the reference."""
    ref = reference.Reference()
    want = ref.insert(data.keys, data.values)
    status = int(np.count_nonzero(np.concatenate(preload) != want)) if preload else 0
    expected = {}
    wrong = compared = 0
    for b, found, values in kept:
        if b not in expected:
            expected[b] = ref.search(data.batches[b])
        wrong += reference.mismatches(found, values, *expected[b])
        compared += found.size
    return {"preload_status_mismatch": status, "answer_mismatch": wrong}, compared


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, system=None, overrides=None) -> dict:
    """Run cell ``name`` once and return its result line (a dict).
    ``system`` replaces the program (the control, or a planted fault)."""
    t_start = time.perf_counter() if t_start is None else t_start
    parts, mark = {}, [t_start]

    def part(label):
        now = time.perf_counter()
        parts[label] = now - mark[0]
        mark[0] = now

    cell = find_cell(name, overrides)
    system = system or Program(cell.config, device)
    part("import")
    system.prepare()
    part("kernels")
    data = generator.make(cell.traffic, cell.setup["records"], seed,
                          cell.setup.get("warmup", {}).get("keys", 0))
    part("traffic")
    op = cell.traffic["op"]
    preload = []
    if op == "insert":
        warm_up_load(cell, system, data)
        part("warmup")
    else:
        t = system.table(**cell.setup["start"])
        system.sync()
        part("table")
        preload = insert_batches(cell, cell.setup["start"], t, data.keys, data.values,
                                 data.keys.size)
        system.sync()
        part("preload")
        for batch in data.batches:
            t.search(batch)
        system.sync()
        part("warmup")
    if traced:
        with system.profiler():     # the profiler's first start takes seconds
            system.sync()
    rec = Record(op=op, setup_s=time.perf_counter() - t_start)
    tracer = Tracer(system, traced, cell.setup["trace"]["first"], cell.setup["trace"]["count"])

    if op == "insert":
        fills = load_window(cell, system, data, seconds, tracer, rec)
        memory_peak = system.memory_peak()
        st = np.concatenate([s for f in fills for s in f.statuses])
        rec.attempted = int(st.size)
        rec.acked = int(np.count_nonzero(st == reference.INSERTED))
        failed = rec.attempted - rec.acked
        checks = check_load(fills, data)
        compared = sum(f.done for f in fills)
    else:
        kept = read_window(cell, data, t, seconds, tracer, rec)
        memory_peak = system.memory_peak()
        rec.traced_keys = [data.batches[b] for b in tracer.batch_ids]
        del t
        failed = rec.counters.get("not_found", 0)
        checks, compared = check_read(kept, preload, data)
    rec.trace = tracer.summary
    log(f"window: {rec.batches} batches, {rec.attempted} operations in {rec.seconds:.3f} s"
        + (f", {len(fills)} fill(s)" if op == "insert" else ""))
    if rec.batch_ends:
        log("batch ends (s): " + " ".join(f"{x:.3f}" for x in rec.batch_ends))

    metrics = {}
    for m in (cell.per_layer if traced else cell.metrics):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.setup["limits"]
    correct = bool(compared > 0 and rec.attempted > 0
                   and all(checks[k] <= limits[k] for k in checks))
    result = {"correct": correct, "attempted": rec.attempted, "failed": int(failed),
              "metrics": metrics, "device": device_record(system, cell, memory_peak, rec),
              "setup_parts": parts, "compared": compared}
    if traced and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def device_record(system, cell: Cell, memory_peak: int, rec: Record) -> dict:
    cuda = getattr(system, "cuda", False)
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": system.torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if rec.trace is not None:
        out["busy_s"] = rec.trace["busy_s"]
        out["window_s"] = rec.trace["window_s"]
    return out
