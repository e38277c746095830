#!/usr/bin/env python
"""Crash-forensics CLI of the PyTorch port (``repro_torch``): reconstruct
what a pool (or a shard fleet) was doing when it died, from durable
evidence alone. The twin of ``scripts/forensics.py``; pool files are the
same bytes in both packages, so either script reads either's pools.

    scripts/forensics_torch.py POOL [POOL ...] [--trace OUT.json]
                         [--post POOL] [--full]

One POOL prints that pool's report; several print a fleet-merged report
(one pool per DHT shard). The report is the JSON from
``repro_torch.obs.forensics.analyze_pool`` / ``merge_reports``: last committed
``flush_seq``, committed/torn flight-recorder windows, ops
acked-but-in-flight in the torn flush, spans open at the crash, health
timeline, quarantined-row correlation.

``--trace OUT.json`` additionally writes a Chrome-trace crash timeline
(drop into Perfetto). With ``--post POOL`` — typically the SAME path,
analyzed again after ``persist.reopen`` committed its healing flush — the
timeline spans the crash boundary: pre-crash evidence on one process row,
post-restart recovery on another, flow arrows from each in-flight op
across the boundary.

Never opens the pool through ``PmPool`` — raw file reads only, so running
forensics cannot disturb the evidence. Exit status: 0 = report produced,
2 = a pool could not be read at all.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.obs import forensics  # noqa: E402


def _strip(rep):
    """Drop the underscore evidence keys from printed JSON (kept for the
    timeline exporter; too bulky for the operator summary)."""
    if isinstance(rep, dict):
        return {k: _strip(v) for k, v in rep.items()
                if not k.startswith("_")}
    if isinstance(rep, list):
        return [_strip(v) for v in rep]
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pools", nargs="+", help="pool file(s); several = "
                    "one DHT shard fleet, merged report")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome-trace crash timeline "
                    "(single-pool reports only)")
    ap.add_argument("--post", metavar="POOL", default=None,
                    help="pool to analyze as the post-restart side of the "
                    "--trace timeline (usually the same path, after "
                    "reopen)")
    ap.add_argument("--full", action="store_true",
                    help="include raw evidence entries in the printed "
                    "JSON")
    args = ap.parse_args(argv)

    reports = [forensics.analyze_pool(p) for p in args.pools]
    report = reports[0] if len(reports) == 1 else \
        forensics.merge_reports(reports)

    if args.trace is not None:
        if len(reports) != 1:
            print("--trace needs exactly one pool", file=sys.stderr)
            return 2
        post = forensics.analyze_pool(args.post) if args.post else None
        forensics.export_crash_timeline(reports[0], args.trace,
                                        post_report=post)
        print(f"wrote crash timeline: {args.trace}", file=sys.stderr)

    json.dump(report if args.full else _strip(report), sys.stdout,
              indent=2, default=str)
    print()
    bad = [r for r in reports if not r.get("ok")]
    return 2 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
