"""Crash forensics: reconstruct what a pool was doing when it died.

Ported from ``repro.obs.forensics``: pools are the reference's file format,
so either package's ``analyze_pool`` reads a pool either package wrote.

Given a crashed (or merely closed) pool file, ``analyze_pool`` rebuilds the
story from durable evidence alone — the two superblock slots and the two
flight-recorder windows (``obs/blackbox.py``) — using plain ``open``/
``read`` on the file. It deliberately does NOT go through ``PmPool.open``
(whose constructor re-applies a committed redo log) or ``persist.reopen``
(whose healing flush advances ``flush_seq``): forensics on a crime scene
must not disturb the scene. The report answers, without the process that
crashed:

  * the last committed ``flush_seq`` and whether the pool closed clean;
  * which blackbox window that commit references and whether it survived
    (descriptor CRC cross-check — a degraded-mode divergence can cost the
    committed window; that is reported as ``"lost"``, never guessed at);
  * whether the OTHER slot holds the torn flush's own story (its embedded
    seq reads ``committed_seq + 1`` — written before the pre-commit fence
    of a flush whose commit never landed);
  * ops acked-but-in-flight in that torn flush: ``"ops"`` intent entries
    whose ``await_seq`` exceeds the committed ``flush_seq``. The serving
    layer applied (and possibly acked) them, the flush meant to make them
    durable tore — the torn window is their only surviving evidence;
  * spans open at the crash, the recent health timeline, degraded/
    quarantine/recovery instants, per-flush metric deltas;
  * quarantined (lost) rows correlated back to the SMO/flush spans that
    last touched them.

``persist/chaos.py`` cross-checks every reported in-flight op against its
committed-vs-live ground-truth model on every seeded schedule: the
reconstruction must never contradict the truth (soundness — a torn flush
that died before its window write legitimately leaves no story, so the
check is "never wrong", not "always complete").

``export_crash_timeline`` renders one report (plus optional post-restart
events from the reopened pool's recorder) as a single Chrome-trace JSON:
pre-crash spans on their own process row, post-restart recovery on
another, flow arrows across the crash boundary. Timelines align via each
window header's paired wall/monotonic clocks.
"""
from __future__ import annotations

import json
from typing import Optional

from . import blackbox

__all__ = ["analyze_pool", "merge_reports", "export_crash_timeline"]

_US = 1e6      # seconds -> Chrome-trace microseconds


def _read_evidence(path: str) -> dict:
    """Raw durable evidence: both superblock slots decoded, the winning
    superblock, both blackbox slots' bytes. Pure file reads."""
    from repro_torch.persist import pool as pool_mod
    from repro_torch.core import layout
    from repro_torch.core.layout import DashConfig

    with open(path, "rb") as f:
        head = f.read(2 * pool_mod.SLOT_BYTES)
        slots = [pool_mod.Superblock.decode(
            head[i * pool_mod.SLOT_BYTES:(i + 1) * pool_mod.SLOT_BYTES])
            for i in (0, 1)]
        valid = [s for s in slots if s is not None]
        if not valid:
            return {"sb": None, "sb_slots": slots, "bb_raw": (b"", b"")}
        sb = max(valid, key=lambda s: s.flush_seq)
        _, _, bbox, _, _ = layout.pool_plane_specs(
            DashConfig(**sb.cfg), sb.mode)
        f.seek(bbox.offset)
        region = f.read(bbox.nbytes)
    half = bbox.slot_nbytes
    return {"sb": sb, "sb_slots": slots,
            "bb_raw": (region[:half], region[half:2 * half])}


def _entries_of(win: Optional[dict]) -> list:
    return win["entries"] if win else []


def _correlate_lost(lost_bt, lost_nb, entries) -> list:
    """Tie quarantined row indices back to the recent spans/instants that
    plausibly produced or last rewrote them: quarantine instants carry the
    loss event itself; SMO/flush spans are the writers of record rows."""
    if not (lost_bt or lost_nb):
        return []
    suspects = []
    for e in entries:
        t = e.get("t")
        if t == "quarantine":
            suspects.append(e)
        elif t == "span" and e.get("cat") in ("smo", "flush"):
            suspects.append(e)
    return suspects[-16:]


def analyze_pool(path: str) -> dict:
    """Reconstruct one pool's crash story from durable evidence (see
    module docstring). Never mutates the file."""
    try:
        ev = _read_evidence(path)
    except (OSError, ValueError) as e:
        return {"path": path, "ok": False, "error": str(e)}
    sb = ev["sb"]
    if sb is None:
        return {"path": path, "ok": False,
                "error": "no valid superblock slot"}

    wins = [blackbox.decode_window(raw) for raw in ev["bb_raw"]]
    report = {
        "path": path, "ok": True, "mode": sb.mode,
        "flush_seq": sb.flush_seq, "gver": sb.gver, "clean": sb.clean,
        # a surviving log descriptor marks a crash inside the tiny
        # commit->apply->commit window (the data is safe: redo at open)
        "log_pending": bool(sb.log_bt or sb.log_nb or sb.log_routing),
        "lost_rows": {"bt": list(sb.lost_bt), "nb": list(sb.lost_nb),
                      "records": sb.lost_records,
                      "overflow": bool(sb.lost_overflow)},
    }

    # -- committed window: exactly as durable as the commit it rode -------
    committed = None
    if sb.bb_slot in (0, 1):
        w = wins[sb.bb_slot]
        if w is not None and w["crc"] == sb.bb_crc and \
                w["nbytes"] == sb.bb_nbytes:
            committed = w
            report["window"] = {"status": "ok", "slot": sb.bb_slot,
                                "seq": w["seq"], "entries": len(w["entries"])}
        else:
            # descriptor committed but the referenced frame no longer
            # checks out — degraded-mode divergence or media rot ate it
            report["window"] = {"status": "lost", "slot": sb.bb_slot,
                                "seq": None, "entries": 0}
    else:
        report["window"] = {"status": "absent", "slot": -1, "seq": None,
                            "entries": 0}

    # -- torn window: the flush that never committed told its own story --
    torn = None
    for i, w in enumerate(wins):
        if w is not None and i != sb.bb_slot and \
                w["seq"] == sb.flush_seq + 1:
            torn = w
            break
    report["torn"] = ({"present": True, "slot": i, "seq": torn["seq"],
                       "entries": len(torn["entries"])}
                      if torn else {"present": False})

    # the freshest surviving story (torn beats committed: it is a strict
    # superset of recent history, minus ring eviction)
    story = _entries_of(torn) or _entries_of(committed)

    # -- acked-but-in-flight ops -----------------------------------------
    in_flight, acked = [], 0
    for e in _entries_of(torn):
        if e.get("t") != "ops":
            continue
        if e.get("await_seq", 0) > sb.flush_seq:
            in_flight.append({k: e[k] for k in
                              ("kind", "n", "await_seq", "keys")
                              if k in e} | (
                                  {"truncated": e["truncated"]}
                                  if "truncated" in e else {}))
        else:
            acked += 1
    report["in_flight_ops"] = in_flight
    report["acked_ops_in_torn_window"] = acked

    # -- spans open at the crash, health timeline, notable instants ------
    report["open_spans"] = [e for e in story if e.get("t") == "open"]
    report["health"] = [e for e in story if e.get("t") == "health"]
    report["events"] = [e for e in story if e.get("t") in
                        ("degraded", "quarantine", "recovery")]
    report["metric_deltas"] = [e for e in story if e.get("t") == "metrics"]
    report["garbled_entries"] = sum(1 for e in story
                                    if e.get("t") == "garbled")
    report["lost_correlation"] = _correlate_lost(
        sb.lost_bt, sb.lost_nb, story)

    # clock anchors for cross-restart timeline alignment
    hdr = next((e for e in story if e.get("t") == "window"), None)
    if hdr is not None:
        report["wall"] = hdr.get("wall")
        report["mono"] = hdr.get("mono")
    report["story_entries"] = len(story)
    # full entry lists for the timeline exporter (underscore keys are
    # stripped from the CLI's printed JSON — they are evidence, not
    # summary)
    report["_story"] = story
    report["_torn_entries"] = _entries_of(torn)
    return report


def merge_reports(reports: list) -> dict:
    """Fleet view over per-shard reports (one pool per DHT shard): shard
    reports ride along verbatim; the summary aggregates what an operator
    asks first — is anything in flight anywhere, and how far apart are the
    shards' committed ``flush_seq``s."""
    shards = list(reports)
    ok = [r for r in shards if r.get("ok")]
    seqs = [r["flush_seq"] for r in ok]
    in_flight = []
    for i, r in enumerate(ok):
        for op in r.get("in_flight_ops", ()):
            in_flight.append({"shard": i, "path": r["path"], **op})
    return {
        "fleet": True,
        "shards_total": len(shards),
        "shards_ok": len(ok),
        "flush_seq_min": min(seqs) if seqs else None,
        "flush_seq_max": max(seqs) if seqs else None,
        "torn_shards": [r["path"] for r in ok
                        if r.get("torn", {}).get("present")],
        "in_flight_ops": in_flight,
        "lost_records": sum(r["lost_rows"]["records"] for r in ok),
        "reports": shards,
    }


def _wall_us(report: dict, mono_t: float) -> float:
    """Map a monotonic stamp from this report's process into wall-clock
    microseconds via the window header's paired clocks."""
    wall = report.get("wall")
    mono = report.get("mono")
    if wall is None or mono is None:
        return mono_t * _US
    return (wall + (mono_t - mono)) * _US


def export_crash_timeline(report: dict, path: Optional[str] = None,
                          post_report: Optional[dict] = None,
                          pid: int = 0) -> dict:
    """One Chrome-trace JSON across the crash boundary.

    Pre-crash evidence (the report's story) renders on process ``pid``;
    post-restart evidence (``post_report`` — ``analyze_pool`` run again
    after ``persist.reopen``, whose healing flush commits the recovery
    events into a fresh window) renders on ``pid + 1``. Each in-flight op
    gets a flow arrow from its pre-crash intent instant to the first
    post-restart recovery/window event, so Perfetto draws the hand-off
    across the crash. Wall-clock alignment comes from each window header's
    paired wall/monotonic stamps — the two processes' ``perf_counter``
    epochs are unrelated; their ``time.time`` is the shared axis."""
    events = []
    flow_id = 0

    def emit_story(rep, row_pid, label):
        nonlocal flow_id
        story = []
        events.append({"name": "process_name", "ph": "M", "pid": row_pid,
                       "args": {"name": label}})
        src = rep.get("_story")
        if src is None:       # re-derive from the analyze report fields
            src = (rep.get("open_spans", []) + rep.get("health", [])
                   + rep.get("events", []) + rep.get("metric_deltas", []))
        crash_us = _wall_us(rep, rep.get("mono") or 0.0)
        for e in src:
            t = e.get("t")
            ts = _wall_us(rep, e.get("ts", e.get("t0", rep.get("mono")
                                                  or 0.0)))
            if t == "span":
                t0 = _wall_us(rep, e["t0"])
                dur = max(_wall_us(rep, e["t1"]) - t0, 0.0)
                ev = {"name": e["name"], "cat": e.get("cat") or "span",
                      "pid": row_pid, "tid": e.get("tid", 0), "ts": t0,
                      "args": {k: e[k] for k in
                               ("sid", "par", "links", "args") if k in e}}
                events.append({**ev, "ph": "i", "s": "t"} if dur == 0.0
                              else {**ev, "ph": "X", "dur": dur})
            elif t == "open":
                t0 = _wall_us(rep, e["t0"])
                events.append({"name": e["name"] + " (open at crash)",
                               "cat": e.get("cat") or "span",
                               "pid": row_pid, "tid": e.get("tid", 0),
                               "ts": t0, "ph": "X",
                               "dur": max(crash_us - t0, 1.0),
                               "args": {"sid": e.get("sid"),
                                        "open_at_crash": True}})
            else:
                args = {k: v for k, v in e.items()
                        if k not in ("t", "ts") and
                        isinstance(v, (int, float, bool, str))}
                events.append({"name": t or "event", "cat": "recorder",
                               "pid": row_pid, "tid": 0, "ts": ts,
                               "ph": "i", "s": "p", "args": args})
            story.append((t, ts, e))
        return story

    pre = emit_story(report, pid, f"pre-crash {report.get('path', '')}")

    # in-flight op intents: instants + (if post evidence) flows across
    torn_entries = report.get("_torn_entries", ())
    intents = []
    for op in report.get("in_flight_ops", ()):
        ts = None
        for e in torn_entries:
            if e.get("t") == "ops" and \
                    e.get("await_seq") == op.get("await_seq") and \
                    e.get("keys") == op.get("keys"):
                ts = _wall_us(report, e.get("ts", 0.0))
                break
        if ts is None:
            ts = _wall_us(report, report.get("mono") or 0.0)
        events.append({"name": "in-flight op", "cat": "forensics",
                       "pid": pid, "tid": 0, "ts": ts, "ph": "i",
                       "s": "g", "args": dict(op)})
        intents.append(ts)

    if post_report is not None:
        post = emit_story(post_report, pid + 1,
                          f"post-restart {post_report.get('path', '')}")
        # the hand-off arrows: every in-flight intent flows to the first
        # post-restart recovery evidence (or the restart window itself)
        target = next(((t, ts) for t, ts, _ in post
                       if t in ("recovery", "window", "health")),
                      post[0][:2] if post else None)
        if target is None:
            target = ("window", _wall_us(post_report,
                                         post_report.get("mono") or 0.0))
        for ts in intents:
            flow_id += 1
            events.append({"name": "crash-boundary", "cat": "flow",
                           "ph": "s", "id": flow_id, "pid": pid,
                           "tid": 0, "ts": ts})
            events.append({"name": "crash-boundary", "cat": "flow",
                           "ph": "f", "bp": "e", "id": flow_id,
                           "pid": pid + 1, "tid": 0, "ts": target[1]})

    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": {"flush_seq": report.get("flush_seq"),
                        "torn": report.get("torn", {}).get("present",
                                                           False),
                        "in_flight_ops": len(
                            report.get("in_flight_ops", ())),
                        "crash_flows": flow_id}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out
