"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 -m sfmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted` (frames offered), `failed` (frames
left out of the main model), `metrics` (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `checks`, every number compared with its limit;
the checks are also the last lines of standard error. Exits non-zero with
no result line where the program or the cell's files are missing, where
there is no CUDA card, or where a module of JAX or of the JAX package was
loaded.
"""

import argparse
import importlib
import json
import math
import os
import sys
import time

T_PROCESS = time.perf_counter()


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m sfmbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="cell name (sfmbench/workloads/<name>.json)")
    p.add_argument("--seed", required=True, type=int,
                   help="orders the workload's fixed flights and seeds the chained driver's RANSAC")
    p.add_argument("--seconds", required=True, type=float,
                   help="window: another whole map starts only while the mean map still fits")
    p.add_argument("--trace", required=True, type=int, choices=(0, 1),
                   help="1: per-layer metrics from a profiled window")
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def _finite(obj):
    """The result with every non-finite number (a map too broken to
    judge) as null, so that the line stays JSON."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def main(argv=None):
    args = parse_args(argv)
    # The port loads no JAX; keep any library that would from doing so.
    os.environ.setdefault("USE_FLAX", "0")
    from .core import PROGRAM, execute, load_cell

    cell = load_cell(args.workload)
    try:
        importlib.import_module(PROGRAM)
    except ModuleNotFoundError as e:
        print(f"sfmbench: the program under test is missing: {e}", file=sys.stderr)
        return 2
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sfmbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines, found = execute(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", 0), t_process=T_PROCESS)
    if found:
        print(f"sfmbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(_finite(result)), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    # Load from one process with few threads: the port's host work is one
    # Python thread, so the libraries' thread pools are kept to one.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.exit(main())
