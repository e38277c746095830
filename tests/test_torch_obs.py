"""Port parity: the observability layer (``repro_torch.obs``, the port's own
copy of ``repro.obs``), on the cases of ``test_obs.py``.

Each scenario runs once against the reference module and once against the
port's, on the same observations and an injected clock, and returns what
it saw: registry snapshots, histogram counts and quantiles, span graphs,
Chrome-trace documents and SLO snapshots with their rule firings. The two
must be equal. The port's frontend is then checked to feed the registry
and the SLO monitor from its one clock.
"""
import json
import math

import numpy as np
import pytest

from repro import obs as r_obs
from repro_torch import obs as t_obs
from repro_torch.core import DashConfig, DashEH
from repro_torch.serving import frontend as tfe
from tests.conftest import unique_keys

CFG = DashConfig(max_segments=32, dir_depth_max=7, num_buckets=16,
                 num_slots=8)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _nan_safe(x):
    """JSON-comparable: NaN -> 'nan', numpy scalars -> python."""
    return json.loads(json.dumps(x, default=lambda o: o.item() if hasattr(
        o, "item") else str(o)).replace("NaN", '"nan"'))


def _hist(obs, dist):
    rng = np.random.default_rng({"lognormal": 1, "uniform": 2, "bimodal": 3}[dist])
    if dist == "lognormal":
        vs = rng.lognormal(-9.0, 1.5, 20_000)
    elif dist == "uniform":
        vs = rng.uniform(1e-6, 1e-2, 20_000)
    else:
        vs = np.abs(np.concatenate([rng.normal(50e-6, 5e-6, 12_000),
                                    rng.normal(5e-3, 5e-4, 8_000)])) + 1e-9
    h = obs.Histogram("t")
    h.observe_many(vs)
    one = obs.Histogram("s")
    for v in vs[:500]:
        one.observe(float(v))
    e, a, b = obs.Histogram("e"), obs.Histogram("a"), obs.Histogram("b")
    a.observe_many([1e-5] * 10)
    b.observe_many([1e-3] * 10)
    a.merge(b)
    return {"counts": h.counts.tolist(), "snap": h.snapshot(),
            "q": [h.percentile(q) for q in (50, 90, 99, 100)],
            "scalar": one.counts.tolist(), "empty": e.percentile(50),
            "merged": [a.n, a.percentile(50), a.percentile(99)]}


def _registry(obs):
    r = obs.Registry()
    s = r.scope("frontend")
    s.counter("acks").inc(5)
    s.gauge("depth").set(3)
    s.histogram("lat").observe_many([1e-4, 2e-4, 3e-3])
    r.ingest({"published": 7, "degraded": False, "name": "x"}, prefix="stats.")
    shards = []
    for i in range(3):
        sr = obs.Registry()
        sr.ingest({"flushed_bytes": 100 * (i + 1)}, prefix="wb.", counters=True)
        shards.append(sr)
    try:
        r.gauge("frontend.acks")
        collision = False
    except AssertionError:
        collision = True
    return {"snap": r.snapshot(), "names": sorted(r.names()),
            "agg": obs.Registry.aggregate(shards).snapshot(),
            "collision": collision}


def _spans(tr):
    return [(s.sid, s.parent, s.name, s.cat, s.t0, s.t1, s.tid, s.args,
             sorted(s.links)) for s in tr.spans()]


def _tracer(obs):
    ring = obs.Tracer(enabled=True, capacity=64, clock=Clock())
    for i in range(300):
        ring.end(ring.begin("op", "t", i=i))
    off = obs.Tracer(enabled=False, clock=Clock())
    sp = off.begin("x")
    off.end(sp)
    off.instant("y")
    with off.span("z"):
        cur = off.current()
    tr = obs.Tracer(enabled=True, clock=Clock())
    with tr.span("outer", "t") as out:
        with tr.span("inner", "t"):
            pass
        det = tr.begin("detached", "t")
        tr.end(det)
    ack = tr.begin("ack", "t", parent=None)
    obs.Tracer.link(ack, out, None, det.sid)
    tr.end(ack)
    tr.instant("mark", "cat", note=1)
    return {"ring": _spans(ring), "ring_stats": ring.stats(),
            "off": [sp, cur, off.spans(), off.recorded],
            "tree": _spans(tr), "chrome": obs.export_chrome_trace(tr)}


def _slo(obs):
    clk = [0.0]
    reg = obs.Registry()
    mon = obs.SloMonitor(
        reg, rules=[obs.SloRule("p99_read", "read_sojourn.p99_s", max=1e-3),
                    obs.SloRule("flush_rate", "rates.fb_per_s", min=1.0)],
        eval_interval=4, clock=lambda: clk[0])
    h = reg.histogram("frontend.read_sojourn_s")
    c = reg.counter("frontend.flush_bytes")
    mon.watch_histogram("read_sojourn", h)
    mon.watch_rate("fb_per_s", c)
    snaps = []
    for obs_v, inc in (([50e-6] * 100, 1000), ([5e-3] * 100, 0)):
        h.observe_many(obs_v)
        c.inc(inc)
        for _ in range(4):
            clk[0] += 0.25
            mon.tick()
        snaps.append(mon.snapshot())
    calls = []
    for _ in range(4):
        clk[0] += 0.25
        mon.tick(lambda: calls.append(1) or {"queue_depth": 9})
    snaps.append(mon.snapshot())
    dwell = obs.SloMonitor(reg, eval_interval=1, clock=lambda: clk[0])
    dwell.note_health(0)
    clk[0] += 2.0
    dwell.note_health(1)
    clk[0] += 1.0
    dwell.tick({"health": 1})
    r = obs.SloRule("x", "a.b.c", max=1.0)
    rules = [r.check({}), r.check({"a": {"b": {"c": float("nan")}}}),
             r.check({"a": {"b": {"c": 2.0}}})]
    tel = [obs.TELEMETRY_SLO_RULES[i].check(obs.telemetry_slo_extra())
           for i in range(2)]
    return {"snaps": snaps, "calls": len(calls), "dwell": dwell.snapshot(),
            "rules": rules, "telemetry": tel}


SCENARIOS = {
    "hist_lognormal": lambda o: _hist(o, "lognormal"),
    "hist_uniform": lambda o: _hist(o, "uniform"),
    "hist_bimodal": lambda o: _hist(o, "bimodal"),
    "registry": _registry,
    "tracer": _tracer,
    "slo": _slo,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_obs_scenario_matches_reference(name):
    want = _nan_safe(SCENARIOS[name](r_obs))
    got = _nan_safe(SCENARIOS[name](t_obs))
    assert got == want
    if name == "slo":
        assert {v["rule"] for v in got["snaps"][1]["violations"]} == \
            {"p99_read", "flush_rate"}
    if name == "tracer":
        assert got["ring_stats"]["trace_dropped"] == 300 - 64
    if name.startswith("hist"):
        assert math.isnan(SCENARIOS[name](t_obs)["empty"])


def test_frontend_feeds_obs_from_one_clock():
    """Every completed op is stamped through ``obs.now()``; the registry
    histograms hold exactly the latency lists' samples, and an SLO
    evaluation on every tick carries the frontend's extra facts."""
    f = tfe.DashFrontend(DashEH(CFG, device="cpu"),
                         obs=t_obs.Observability(slo_interval=1))
    keys = unique_keys(np.random.default_rng(5), 500)
    for k in keys:
        f.submit(tfe.Op(tfe.INSERT, int(k), int(k & 0x7FFFFFFF)))
    for k in keys[:200]:
        f.submit(tfe.Op(tfe.READ, int(k)))
    f.drain()
    rh = f.obs.registry.get("frontend.read_sojourn_s")
    wh = f.obs.registry.get("frontend.write_sojourn_s")
    assert rh.n == len(f.read_latencies) == 200
    assert wh.n == len(f.write_latencies) == 500
    assert rh.total == pytest.approx(sum(f.read_latencies))
    assert wh.vmax == max(f.write_latencies)
    snap = f.obs_snapshot()
    assert snap["metrics"]["stats.published"] == f.stats()["published"]
    assert snap["metrics"]["table.smo_tasks"] == f.smo_dispatches > 0
    assert snap["slo"]["health"] == tfe.HEALTHY
    assert "limbo_depth" in snap["slo"] and "queue_depth" in snap["slo"]
    assert snap["slo"]["violations"] == []
