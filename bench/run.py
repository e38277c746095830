"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Exits non-zero with no result when CUDA or
the cell's cards are missing, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def report(result: dict) -> None:
    """Print a run's numbers on standard error, each compared number beside
    its limit last, then its result line on standard output."""
    import json
    from bench.harness import log
    log(f"setup parts (s): {json.dumps(result['setup_parts'])}")
    for name, m in result["metrics"].items():
        log(f"metric {name} {m['value']} {m['unit']}")
    log(f"correct {result['correct']}: attempted {result['attempted']}, "
        f"failed {result['failed']}, compared {result['compared']}")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)


def main() -> int:
    # kernel caches at fixed paths inside the checkout: only a checkout's
    # first run builds (the port's CUDA library keys itself under build/)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from bench import harness, roofline

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"no result: {args.workload} needs {cell.chips} CUDA device(s), "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(1)
    harness.log(f"card: {roofline.card_line()}")
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"no result: the run loaded {found}")
        return 4
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
