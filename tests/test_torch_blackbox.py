"""Port parity: the durable flight recorder and crash forensics (the cases
of ``test_blackbox.py``, each held to the reference).

Window frames, the recorder's bounded ring and its snapshots are the
reference's bytes (with the same clocks); the committed window rides the
flush commit into the same pool bytes; a torn flush leaves a story from
which the port's ``analyze_pool`` and the reference's reconstruct the same
report — in-flight ops, open spans, descriptors; the crash timeline export
and the fleet merge work on the port's reports; and on the port's chaos
schedules forensics never contradicts the ground truth.
"""
import os
import time

import numpy as np
import pytest

from repro import persist as rp
from repro.core.layout import DashConfig
from repro.obs import FlightRecorder as RRecorder
from repro.obs import blackbox as rbb
from repro.obs import forensics as rforensics
from repro_torch import persist as tp
from repro_torch.obs import (FlightRecorder, Observability, Registry, SloMonitor,
                             TELEMETRY_SLO_RULES, Tracer, forensics,
                             telemetry_slo_extra)
from repro_torch.obs import blackbox
from repro_torch.persist import chaos
from repro_torch.persist.writeback import SimulatedCrash
from tests.torch_parity import counter_clock, port_cfg

SMALL = DashConfig(max_segments=16, dir_depth_max=8, num_buckets=16, num_slots=8)
WALL = 1.7e9


def _mk(tmp_path, name="bb.pool"):
    path = str(tmp_path / name)
    table = tp.create(path, port_cfg(SMALL), mode="eh", device="cpu")
    rec = table.writeback.attach_recorder(FlightRecorder(clock=counter_clock(),
                                                         wall=lambda: WALL))
    return path, table, rec


def _insert(table, lo, n=32):
    keys = np.arange(lo, lo + n, dtype=np.uint64)
    table.insert(keys, (np.arange(n) % 100 + 1).astype(np.uint32))
    return keys


def _stamp(table, rec, keys):
    rec.record_ops("insert", keys, await_seq=table.writeback.pool.sb.flush_seq + 1)


def _crash_at_commit(table):
    """Die exactly at the commit boundary: the window write + its fence
    ran, the commit record never landed — the canonical torn flush."""
    def boom(*a, **kw):
        raise SimulatedCrash("crash at commit")
    orig, table.writeback.pool.commit = table.writeback.pool.commit, boom
    with pytest.raises(SimulatedCrash):
        table.flush()
    table.writeback.pool.commit = orig


# -- window framing -----------------------------------------------------------

@pytest.mark.parametrize("raw", [
    b'{"t":"health","frm":"a","to":"b"}\n{"t":"ops","n":1}\n',
    b'not json at all\n{"t":"ok"}\n', b"",
])
def test_frames_and_decodes_match_reference(raw):
    framed = blackbox.frame_window(7, raw)
    assert framed == rbb.frame_window(7, raw)
    torn = bytearray(framed)
    if raw:
        torn[-2] ^= 0x40
    for case in (framed + b"\x00" * 64, framed[:-4], bytes(torn), b"",
                 b"NOTMAGIC" + framed[8:]):
        assert blackbox.decode_window(case) == rbb.decode_window(case)
    assert blackbox.decode_window(framed)["seq"] == 7


# -- the recorder ring --------------------------------------------------------

def test_recorder_ring_snapshot_matches_reference(monkeypatch):
    """A bounded ring that evicts: the same entries, counters and snapshot
    bytes as the reference's, the newest entries kept."""
    monkeypatch.setattr(time, "time", lambda: WALL)    # the reference's wall clock
    recs = [RRecorder(capacity_bytes=8192, clock=counter_clock()),
            FlightRecorder(capacity_bytes=8192, clock=counter_clock(), wall=lambda: WALL)]
    snaps = []
    for rec in recs:
        for i in range(2000):
            rec.record("noise", i=i, pad="x" * 40)
        rec.record_health("healthy", "degraded")
        rec.record_ops(3, np.arange(600, dtype=np.uint64), await_seq=4)
        rec.record_ack(4, "insert", 600, durable=False)
        snaps.append(rec.snapshot(flush_seq=5))
    assert snaps[0] == snaps[1]
    assert recs[0].stats() == recs[1].stats()
    rec = recs[1]
    assert rec.evicted > 0 and rec._bytes <= rec._ring_budget
    assert len(snaps[1]) <= rec.capacity
    w = blackbox.decode_window(blackbox.frame_window(5, snaps[1]))
    assert w["entries"][0]["t"] == "window"
    assert w["entries"][-1]["t"] == "ack" and w["entries"][-2]["truncated"] == 88


def test_recorder_loss_counters_mirror_registry():
    reg = Registry()
    rec = FlightRecorder(capacity_bytes=8192)
    rec.attach(registry=reg)
    for i in range(2000):
        rec.record("noise", i=i, pad="y" * 40)
    rec.note_write_failure()
    snap = reg.snapshot()
    assert snap["blackbox.recorded"] == rec.recorded
    assert snap["blackbox.evicted"] == rec.evicted > 0
    assert snap["blackbox.write_failures"] == 1


# -- the committed window rides the commit -----------------------------------

def test_flush_persists_window_like_reference(tmp_path, monkeypatch):
    """Two flushes with recorder windows: the descriptor names the slot
    the committed superblock did not, the window decodes with its ops
    acked, and both packages leave the same pool bytes."""
    monkeypatch.setattr(time, "time", lambda: WALL)
    a = str(tmp_path / "ref.pool")
    ref = rp.create(a, SMALL)
    rrec = ref.writeback.attach_recorder(RRecorder(clock=counter_clock()))
    path, table, rec = _mk(tmp_path)
    slots = []
    for t, r in ((ref, rrec), (table, rec)):
        keys = _insert(t, 1)
        _stamp(t, r, keys)
        t.flush()
        sb = t.writeback.pool.sb
        first = sb.bb_slot
        _insert(t, 500)
        t.flush()
        slots.append((first, t.writeback.pool.sb.bb_slot))
    assert slots[0] == slots[1] and slots[1][1] == 1 - slots[1][0]
    with open(a, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    sb = table.writeback.pool.sb
    w = blackbox.decode_window(table.writeback.pool.read_blackbox_slot(sb.bb_slot))
    assert w is not None and w["crc"] == sb.bb_crc and w["seq"] <= sb.flush_seq
    ops = [e for e in w["entries"] if e["t"] == "ops"]
    assert ops and ops[0]["await_seq"] <= sb.flush_seq        # acked, not lost
    rep = forensics.analyze_pool(path)
    assert rep["ok"] and rep["window"]["status"] == "ok"
    assert not rep["torn"]["present"] and rep["in_flight_ops"] == []
    table.close()


# -- torn-flush forensics -----------------------------------------------------

def _torn_pool(tmp_path, name="bb.pool"):
    path, table, rec = _mk(tmp_path, name)
    keys = _insert(table, 1)
    _stamp(table, rec, keys)
    table.flush()
    k2 = _insert(table, 1000)
    _stamp(table, rec, k2)
    rec.note_open(Tracer(enabled=True, clock=counter_clock()).begin("smo", "smo"))
    _crash_at_commit(table)
    return path, table, keys, k2


def test_torn_flush_reconstruction_matches_reference(tmp_path):
    """The port's torn pool tells its story: exactly the torn batch is in
    flight, the acked batch is history — and the reference's
    ``analyze_pool`` reads the same report from the same file."""
    path, table, keys, k2 = _torn_pool(tmp_path)
    committed_seq = table.writeback.pool.sb.flush_seq
    rep = forensics.analyze_pool(path)
    assert rep == rforensics.analyze_pool(path)
    assert rep["ok"] and rep["flush_seq"] == committed_seq
    assert rep["torn"]["present"] and rep["torn"]["seq"] == committed_seq + 1
    got = {int(k) for op in rep["in_flight_ops"] for k in op["keys"]}
    assert got == {int(k) for k in k2}
    assert not ({int(k) for k in keys} & got)
    assert [e["name"] for e in rep["open_spans"]] == ["smo"]

    # chrome-trace across the crash boundary
    tl_path = str(tmp_path / "TRACE_crash.json")
    table2, _ = tp.reopen(path, device="cpu")
    post = forensics.analyze_pool(path)
    tl = forensics.export_crash_timeline(rep, tl_path, post_report=post)
    assert os.path.exists(tl_path)
    assert tl == rforensics.export_crash_timeline(rep, post_report=post)
    assert tl["metadata"]["in_flight_ops"] == 1
    assert tl["metadata"]["crash_flows"] >= 1
    assert {"s", "f"} <= {e["ph"] for e in tl["traceEvents"]}
    table2.close()


def test_torn_window_never_scribbles_committed_story(tmp_path):
    path, table, rec = _mk(tmp_path)
    _insert(table, 1)
    table.flush()
    sb = table.writeback.pool.sb
    before = bytes(table.writeback.pool.read_blackbox_slot(sb.bb_slot))
    _insert(table, 1000)
    _crash_at_commit(table)
    assert before == bytes(table.writeback.pool.read_blackbox_slot(sb.bb_slot))


def test_fleet_merge_reports_match_reference(tmp_path):
    reports = []
    for i in range(2):
        if i == 1:                                # shard 1 dies mid-flush
            reports.append(forensics.analyze_pool(_torn_pool(tmp_path, "s1.pool")[0]))
            continue
        path, table, rec = _mk(tmp_path, "s0.pool")
        _stamp(table, rec, _insert(table, 1))
        table.flush()
        reports.append(forensics.analyze_pool(path))
    fleet = forensics.merge_reports(reports)
    assert fleet == rforensics.merge_reports(reports)
    assert fleet["shards_ok"] == 2 and len(fleet["torn_shards"]) == 1
    assert fleet["in_flight_ops"] and all(op["shard"] == 1 for op in fleet["in_flight_ops"])


def test_chaos_forensics_never_contradicts_truth(tmp_path):
    agg = chaos.run_many(range(40, 44), str(tmp_path), min_tears=1, device="cpu")
    assert agg["forensics_checks"] > 0
    assert agg["forensics_contradictions"] == 0


# -- telemetry loss is itself observable --------------------------------------

def test_trace_drops_and_write_failures_fire_slo():
    obs = Observability(trace=True, trace_capacity=4)
    for i in range(10):
        obs.tracer.end(obs.tracer.begin(f"s{i}"))
    assert obs.registry.snapshot()["trace.dropped"] == obs.tracer.dropped > 0
    mon = SloMonitor(obs.registry, rules=list(TELEMETRY_SLO_RULES), eval_interval=1)
    rec = FlightRecorder(capacity_bytes=8192)
    rec.note_write_failure()
    fired = {v["rule"] for v in mon.evaluate(telemetry_slo_extra(obs.tracer, rec))["violations"]}
    assert fired == {"trace-loss", "blackbox-write-loss"}
    quiet = mon.evaluate(telemetry_slo_extra(Tracer(enabled=False),
                                             FlightRecorder(capacity_bytes=8192)))
    assert quiet["violations"] == []
