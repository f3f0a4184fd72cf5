#!/usr/bin/env python3
"""Times kernel K2's two paths against the longest segment, on one CUDA GPU.

    python3 benchmarks/torch_k2_paths.py      (from the repo root)

K2 (mavmap_tpu_torch/ops/cuda/ba_accum.py seg_accum_full) sums a plan's
segments in one pass (one thread per (segment, column), the rows gathered
through the plan's order) when its longest segment has at most
one_pass_limit(S) rows, else in two passes (pieces, then each segment's
pieces). This script forces each path on the same plans and times both
under chip_smoke's CUDA-graph timer, with index_add_ beside them:

  uniform  R = 32768 rows in segments of exactly L rows, in random row
           order, for L = 1 .. 1024;
  mixed    the same rows, one segment of L rows and the rest of 4 (one long
           track among short ones, which sets the one-pass thread's
           latency alone);
  sparse   R rows in segments of L rows, each followed by 3 empty segments
           (as in the dense steps' per-(point, block) plans), where one pass
           zeroes the output and sums the filled segments alone (the plan's
           `sparse`); it is also timed with a thread per (segment, column)
           of every segment, as on a plan of few empty segments;

at K = 9, 54 and 81 columns. Every sum is checked: the one-pass path bit for
bit against the planned plain version run on a CPU copy, the two passes at
1e-5 of the per-segment sum of |contrib|. Prints one line per plan, the
card line from nvidia-smi, and a JSON line of all times (device µs per
call).
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 32768
LENGTHS = (1, 4, 16, 32, 64, 128, 256, 512, 1024)
COLUMNS = (9, 54, 81)


def _ids(rng, kind, L):
    import numpy as np

    if kind == "uniform":
        lens = np.full(ROWS // L, L)
    elif kind == "sparse":
        lens = np.zeros(4 * (ROWS // L), np.int64)
        lens[::4] = L
    else:
        lens = np.concatenate([[L], np.full((ROWS - L) // 4, 4)])
    return rng.permutation(np.repeat(np.arange(len(lens)), lens)).astype(np.int32), len(lens)


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import _time_ms
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka
    from mavmap_tpu_torch.ops.cuda import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_paths.py: needs a CUDA device")
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    out = []
    for kind in ("uniform", "mixed", "sparse"):
        for L in LENGTHS if kind != "sparse" else (1, 4, 16):
            ids, S = _ids(rng, kind, L)
            host = ka.make_plan(ids, S)
            for K in COLUMNS:
                c = torch.as_tensor(rng.normal(size=(len(ids), K)).astype(np.float32),
                                    device=dev)
                ref = ka.seg_accum_planned_plain(c.cpu(), host.to(cpu))
                scale = ka.seg_accum_planned_plain(c.abs().cpu(), host.to(cpu))
                row = dict(kind=kind, longest=L, K=K, S=S, default=(
                    "one_pass" if host.one_pass else "two_pass"))
                for path, one in (("one_pass", True), ("two_pass", False)):
                    plan = host._replace(one_pass=one).to(dev)
                    got = ka.seg_accum_full(c, None, S, plan).cpu()
                    if one and not torch.equal(got, ref):
                        raise AssertionError(f"{kind} L={L} K={K}: one pass differs from "
                                             f"the CPU's planned plain version")
                    if not bool(((got - ref).abs() <= 1e-5 * scale + 1e-6).all()):
                        raise AssertionError(f"{kind} L={L} K={K}: {path} off by "
                                             f"{float((got - ref).abs().max())}")
                    row[path + "_us"] = 1000 * _time_ms(
                        lambda: ka.seg_accum_full(c, None, S, plan))[0]
                if kind == "sparse":
                    plan = host.to(dev)
                    lib = build.library()

                    def every_segment():
                        out = torch.empty((S, K), device=dev)
                        build.check(lib.mavmap_seg_accum_one_pass(
                            c.data_ptr(), plan.order.data_ptr(), plan.seg_offsets.data_ptr(),
                            None, 0, S, S, K, out.data_ptr(), build.stream_ptr(dev)),
                            "one pass")
                        return out

                    if not torch.equal(every_segment().cpu(), ref):
                        raise AssertionError(f"sparse L={L} K={K}: every segment's threads "
                                             f"differ")
                    row["one_pass_every_segment_us"] = 1000 * _time_ms(every_segment)[0]
                ids_d = torch.as_tensor(ids, device=dev).long()
                row["index_add_us"] = 1000 * _time_ms(
                    lambda: torch.zeros((S, K), device=dev).index_add_(0, ids_d, c))[0]
                one = (f" (a thread per column of every segment "
                       f"{row['one_pass_every_segment_us']:.2f} µs)"
                       if "one_pass_every_segment_us" in row else "")
                print(f"{kind:7s} longest {L:5d} K {K:2d} S {S:6d}: one pass "
                      f"{row['one_pass_us']:8.2f} µs{one}, two passes "
                      f"{row['two_pass_us']:8.2f} µs, index_add_ {row['index_add_us']:8.2f} µs "
                      f"(make_plan: {row['default']})", flush=True)
                out.append(row)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"k2_paths": out}))


if __name__ == "__main__":
    main()
