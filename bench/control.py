"""The control: the plain reference in the program's place, one precision
below the configurations' 8-byte keys.

``ControlTable`` answers the table API (``insert``, ``search``,
``n_items``) from ``bench/reference.py`` with keys compared
on their low 32 bits, the step a later change might take to halve the key
bytes a probe reads. Keys that agree in those bits collide: the second is
acknowledged ``EXISTS`` and reads the first one's value. A run with it in
the program's place has to come out not correct; the benchmark's own runs
never run it.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

runs the control through a whole run of the cell at the cell's own size
(no card is used) and prints each seed's checks.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import harness, reference  # noqa: E402

#: key bits the control compares (the configurations state 64)
KEY_BITS = 32


class ControlTable(reference.Reference):
    """The reference behind the table API."""

    def __init__(self):
        super().__init__(KEY_BITS)

    def insert(self, keys, values, max_retries=None):
        return super().insert(keys, values)


class Control:
    """A system for ``harness.run_cell``: control tables, no card."""

    def prepare(self) -> None:
        pass

    def table(self, **start):
        return ControlTable()

    def sync(self) -> None:
        pass

    def memory_peak(self) -> int:
        return 0

    def counters(self, t) -> dict:
        return {}


def run(cell: str, seed: int, seconds: float, overrides=None) -> dict:
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            system=Control(), overrides=overrides)


def main() -> int:
    ap = argparse.ArgumentParser(description="the control of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = run(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "compared": r["compared"],
                          "seconds": time.perf_counter() - t0, "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
