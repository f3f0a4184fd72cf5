"""The JAX package's CLI over chip_smoke.py's cli phase, on the CPU.

    JAX_PLATFORMS=cpu python benchmarks/jax_cli_yardstick.py [WORKDIR]

Writes the cli phase's files exactly as chip_smoke.py writes them
(chip_smoke.write_cli_dataset: 40 rendered PNG images with imagedata.txt
holding noisy IMU roll/pitch/yaw, 6 control points with 4 fixed, and a
vocabulary tree trained on the port's detections of every 10th image, here
made on the CPU), then runs `mavmap_tpu.cli.main` on them with the phase's
flags (chip_smoke.cli_args: detection from pixels, loop detection every 20
frames, IMU priors at weight 20, control points, the filter at
chip_smoke.CLI_FILTER_MAX_ERROR px). Prints one JSON line with the numbers
chip_smoke.py holds the port to (chip_smoke.cli_metrics, read from the
CLI's own output files: registered count, absolute camera-centre RMSE in
the control points' frame, rotations against the priors, each free control
point's error) and the wall seconds. The JAX_CPU_CLI_* constants of
chip_smoke.py come from this line. WORKDIR (default: a new temporary
directory) keeps the files.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mavmap_tpu.cli import main as jax_cli_main  # noqa: E402


def main(work):
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    scene, priors, cps = chip_smoke.write_cli_dataset(work, torch.device("cpu"))
    write_s = time.perf_counter() - t0
    out = os.path.join(work, "out_jax")
    t0 = time.perf_counter()
    rc = jax_cli_main(chip_smoke.cli_args(work, out))
    wall = time.perf_counter() - t0
    m = chip_smoke.cli_metrics(out, scene, priors, cps) if rc == 0 else {}
    m.pop("centers", None)
    print(json.dumps({"rc": rc, **m, "wall_s": wall, "write_s": write_s, "workdir": work}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="jax_cli_"))
