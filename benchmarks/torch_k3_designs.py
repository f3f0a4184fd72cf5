#!/usr/bin/env python3
"""Times designs of the sorted segment sum (kernel K3) on one CUDA GPU.

    python3 benchmarks/torch_k3_designs.py      (from the repo root)

Builds benchmarks/torch_k3_designs.cu with nvcc and times, at K3's shapes
in chip_smoke.py ((8192, 12) -> 2048 and (20480, 3) -> 5120, tracks made as
there) and at a survey-like (151552, 3) -> 49152 (48399 tracks of 2-16
rows, mean 3.1), under chip_smoke's CUDA-graph timer:

  shipped      mavmap_tpu_torch's K3 (csrc/ba_accum.cu seg_rows_kernel);
  loop         one dependent load per row (the K3 before it);
  grouped      whole segments grouped into at most 256 rows, staged in shared
               memory, added from there, 256 threads, offsets stored before
               the rows' loads;
  grouped_lf   the same with 128-row groups, every load started before any
               store, threads sized to a group's (segment, column) count;
  empty_1      an empty kernel on one block: the launch floor;
  empty_grid   an empty kernel on the per-(segment, column) grid;
  stream       the rows read once, coalesced, with no dependent load.

Every summing design is checked bit for bit against the plain version run
on a CPU copy. Prints one line per shape and design, the card line from
nvidia-smi, and a JSON line of all times (device µs per call).
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = {"loop": 0, "grouped": 1, "grouped_lf": 2, "empty_1": 3, "empty_grid": 4,
           "stream": 5}


def _library(out_dir):
    nvcc = "/usr/local/cuda/bin/nvcc"
    so = os.path.join(out_dir, "libk3_designs.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", so,
                    os.path.join(ROOT, "benchmarks", "torch_k3_designs.cu")], check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k3_design.argtypes = [I, P, P, P, P, I, I, I, I, P, P]
    lib.k3_design.restype = I
    return lib


def _groups(off, R):
    """Consecutive whole segments in groups of at most R rows and R
    segments, a longer segment alone: (segment starts, row starts)."""
    import numpy as np

    S = len(off) - 1
    starts = [0]
    while starts[-1] < S:
        s = starts[-1]
        e = int(np.searchsorted(off, off[s] + R, side="right")) - 1
        starts.append(min(max(e, s + 1), s + R, S))
    starts = np.asarray(starts)
    return starts.astype(np.int32), off[starts].astype(np.int32)


def _shapes():
    import numpy as np

    rng = np.random.default_rng(2)  # chip_smoke.check_seg_sorted's tracks
    for O, K in ((8192, 12), (20480, 3)):
        lens = []
        while sum(lens) < int(O * 0.8):
            lens.append(int(min(2 + rng.geometric(0.35) - 1, 12)))
        S = -(-len(lens) // 1024) * 1024
        off = np.zeros(S + 1, np.int64)
        off[1:len(lens) + 1] = np.cumsum(lens)
        off[len(lens) + 1:] = off[len(lens)]
        yield O, K, off, rng.normal(size=(O, K)).astype(np.float32)
    rng = np.random.default_rng(7)
    lens = np.minimum(rng.geometric(0.48, size=48868) + 1, 30)
    lens = lens[np.cumsum(lens) <= 149490]
    off = np.zeros(49153, np.int64)
    off[1:len(lens) + 1] = np.cumsum(lens)
    off[len(lens) + 1:] = off[len(lens)]
    yield 151552, 3, off, rng.normal(size=(151552, 3)).astype(np.float32)


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from mavmap_tpu_torch.ops.cuda import ba_accum as ka

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times kernels on a GPU")
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(ROOT, "mavmap_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = _library(out_dir)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    results = []
    for O, K, off, c in _shapes():
        S = len(off) - 1
        n_rows = int(off[-1])
        ct = torch.as_tensor(c, device=dev)
        ot = torch.as_tensor(off.astype(np.int32), device=dev)
        ref = ka.seg_accum_sorted_plain(torch.as_tensor(c), torch.as_tensor(off.astype(np.int32)),
                                        S)
        plans = {R: tuple(torch.as_tensor(a, device=dev) for a in _groups(off, R))
                 for R in (128, 256)}
        n_out = -(-S * K // 256) * 256  # the stream grid writes one float per thread
        row = {"shape": [O, K, S], "tracks": int((np.diff(off) > 0).sum()),
               "max_track": int(np.diff(off).max())}
        print(f"({O},{K})->{S}: {row['tracks']} tracks of at most {row['max_track']} rows",
              flush=True)

        def shipped():
            return ka.seg_accum_sorted(ct, ot, S)

        designs = [("shipped", shipped)]
        for name, code in DESIGNS.items():
            gs, gr = plans[128 if name == "grouped_lf" else 256]

            def call(code=code, gs=gs, gr=gr, name=name):
                # A new output per call, as the package's wrapper allocates.
                out = torch.empty(n_out, device=dev)
                err = lib.k3_design(code, ct.data_ptr(), ot.data_ptr(), gs.data_ptr(),
                                    gr.data_ptr(), gs.shape[0] - 1, n_rows, S, K,
                                    out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out[:S * K].view(S, K)
            designs.append((name, call))
        for name, fn in designs:
            got = fn()
            torch.cuda.synchronize()
            bitwise = None
            if name in ("shipped", "loop", "grouped", "grouped_lf"):
                bitwise = bool(torch.equal(got.cpu(), ref))
                if not bitwise:
                    raise AssertionError(f"{name} at ({O},{K})->{S} differs from the CPU's sums")
            ms, _ = chip_smoke._time_ms(fn)
            row[name] = 1000 * ms
            print(f"  {name:11s} {1000 * ms:7.3f} µs" + (
                "" if bitwise is None else "  (equal bit for bit to the CPU's plain version)"),
                flush=True)
        results.append(row)
    print(smi)
    print(json.dumps({"k3_designs_us": results, "card": smi}))


if __name__ == "__main__":
    main()
