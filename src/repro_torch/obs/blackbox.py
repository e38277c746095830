"""Telemetry-loss SLO rules of the flight recorder.

The durable flight recorder itself (``FlightRecorder``) comes with the
durable pool; the serving frontend's SLO tick already evaluates the
telemetry-loss facts, with no recorder attached.
"""
from __future__ import annotations

from .slo import SloRule

#: declarative "silent telemetry loss is itself observable" rules: fed by
#: ``telemetry_slo_extra`` through the SLO monitor's extra facts
TELEMETRY_SLO_RULES = (
    SloRule("trace-loss", "telemetry.trace_dropped", max=0),
    SloRule("blackbox-write-loss", "telemetry.blackbox_write_failures",
            max=0),
)


def telemetry_slo_extra(tracer=None, recorder=None) -> dict:
    """The ``telemetry`` section ``TELEMETRY_SLO_RULES`` evaluates against
    — feed it through the SLO monitor's ``extra`` (see ``DashFrontend``)."""
    return {"telemetry": {
        "trace_dropped": 0 if tracer is None else tracer.dropped,
        "blackbox_write_failures":
            0 if recorder is None else recorder.write_failures,
    }}
