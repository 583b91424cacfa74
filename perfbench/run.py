"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m perfbench.run ...``) from the root of a checkout. Needs a
CUDA card: without one, or with fewer than the cell asks for, it exits 1
and prints no result. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; last, ``checks``: each number the check
compared beside its limit, also printed as the last lines of standard
error). The program's kernel builds and caches stay inside the checkout
(``m3d_torch/_build/``, ``.perfbench_cache/``), so only a cell's first run
in a checkout builds them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # One host thread for PyTorch's CPU ops: the measured path is the card
    # and the host thread that feeds it, and idle pool threads spinning on
    # the shared cores only add noise.
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from perfbench import harness

    spec = harness.Cell(ROOT, args.workload).spec
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec["chips"]):
        print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              "the port alone", file=sys.stderr)
        return 1
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
