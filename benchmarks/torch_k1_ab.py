"""Single-pair K1 (mavmap_tpu_torch/csrc/match.cu) of one checkout, timed on the GPU.

    python3 benchmarks/torch_k1_ab.py CHECKOUT_DIR

Imports mavmap_tpu_torch from CHECKOUT_DIR (its kernels build into that
checkout's own _build/), and times the single-pair matcher at
1024 x 1024 x 128 with the prefilter, on chip_smoke.py's inputs and under
chip_smoke.py's device timer (this tree's), five times, beside the launch
floor; each time comes with the host µs per call of the wrapper (call_us,
the host clock around 50 direct calls). Run it in one call for two checkouts in turns (A, B, B, A) to compare
two versions of the kernel on one card. Prints one JSON line.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    from mavmap_tpu_torch.ops.cuda import match as km

    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not km.__file__.startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"imported {km.__file__}, not the checkout's")
    dev = torch.device("cuda", 0)
    (d1, d2, m1, m2, kp1, kp2), maxd = cs._match_inputs(torch, np.random.default_rng(0), dev,
                                                        1024, 1024)
    args = km.padded_operands(d1, d2, m1, m2, kp1, kp2, maxd)
    single = [cs._time_ms(lambda: km._match_raw_cuda(*args)) for _ in range(5)]
    floor = cs._time_ms(lambda: torch.cuda._sleep(1))[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"checkout": checkout, "single_us": [1000 * t for t, _ in single],
                      "call_us": [c for _, c in single],
                      "launch_floor_us": 1000 * floor, "card": smi}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
