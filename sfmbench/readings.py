"""Readings that the limits of a cell's checks are set from: the program
on many seeds, and the control, in one process on the card.

    python3 -m sfmbench.readings --workload <cell> --seeds 1,2,3 [--out FILE]

Set-up (kernels, warm-up) runs once; then every seed's first map (the
flight the seed puts first and, for the chained driver, its RANSAC seed)
is mapped at the cell's own size and judged as a run judges it (`program`),
and the same map is judged once more with its poses, points and
intrinsics held in bfloat16 (`control_bf16`, the control: the precision
below the configurations' float32). One JSON line per reading. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time


def _seeds(text):
    return [int(s) for s in text.split(",") if s.strip()]


def _values(records, inputs):
    from .core import judge_values

    return judge_values(records, inputs.scene, [[kp for kp, _ in inputs.feats[0]]])[0]


def read_seed(cell, seed, device, spans):
    """Map seed's first map on `device`; returns its readings: the
    program's, and the bfloat16 control's of the same map."""
    from dataclasses import replace

    from .core import make_inputs
    from .reference.judge import bfloat16_state

    inputs = make_inputs(cell.workload, seed, 1, cell.config)
    ctx = cell.driver.prepare(cell, inputs, seed, device)
    rec = cell.driver.map_once(ctx, 0, spans)
    base = {"cell": cell.name, "seed": seed, "wall_s": rec.wall_s, "registered": rec.registered}
    return [dict(base, mode="program", **_values([rec], inputs)),
            dict(base, mode="control_bf16",
                 **_values([replace(rec, state=bfloat16_state(rec.state))], inputs))]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m sfmbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=_seeds)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    from .core import Spans, load_cell, make_inputs

    if not torch.cuda.is_available():
        print("sfmbench.readings: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from mavmap_tpu_torch import native
    from mavmap_tpu_torch.ops.cuda import build

    build.library()
    native.load_mapstore_lib()
    cell = load_cell(args.workload)
    spans = Spans()
    t0 = time.perf_counter()
    warm = make_inputs(cell.workload, args.seeds[0], 0, cell.config)
    cell.driver.warmup(cell.driver.prepare(cell, warm, args.seeds[0], dev), spans)
    print(f"warm-up {time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    out = open(args.out, "a") if args.out else None
    try:
        for s in args.seeds:
            for reading in read_seed(cell, s, dev, spans):
                line = json.dumps(reading)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
