"""The JAX package's CLI over chip_smoke.py's photo phase, on the CPU.

    JAX_PLATFORMS=cpu python benchmarks/jax_photo_yardstick.py [WORKDIR] [--port]

Writes the photo phase's files exactly as chip_smoke.py writes them
(chip_smoke.write_photo_dataset: the 40-image real-photograph survey
rendered by the port's render_photo_survey on the CPU over the committed
photographs, imagedata.txt, and a vocabulary tree trained on the port's
detections of every 10th image, here made on the CPU), then runs
`mavmap_tpu.cli.main` on them with the phase's flags (chip_smoke.photo_args:
tests/test_pipeline.py's real-photograph settings plus loop detection every
20 frames over 10 candidates). Prints one JSON line with the numbers
chip_smoke.py holds the port to (chip_smoke.photo_metrics, read from the
CLI's own output files: registered count, ATE after a similarity fit) and
the wall seconds. The JAX_CPU_PHOTO_* constants of chip_smoke.py come from
this line. With --port, the port's CLI runs on the same files on the CPU
too (--device cpu) and prints a second line. WORKDIR (default: a new
temporary directory) keeps the files.
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


def _run(name, main, work, extra=()):
    out = os.path.join(work, f"out_{name}")
    t0 = time.perf_counter()
    rc = main(chip_smoke.photo_args(work, out, list(extra)))
    wall = time.perf_counter() - t0
    m = chip_smoke.photo_metrics(out, chip_smoke.photo_scene()) if rc == 0 else {}
    return {"cli": name, "rc": rc, **m, "wall_s": wall}


def main(work, port):
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    _, _, render_s = chip_smoke.write_photo_dataset(work, torch.device("cpu"))
    write_s = time.perf_counter() - t0
    print(json.dumps({**_run("jax", jax_cli_main, work), "write_s": write_s,
                      "render_s": render_s, "workdir": work}), flush=True)
    if port:
        from mavmap_tpu_torch.cli import main as port_cli_main

        print(json.dumps(_run("port", port_cli_main, work, ["--device", "cpu"])), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--port"]
    main(args[0] if args else tempfile.mkdtemp(prefix="jax_photo_"), "--port" in sys.argv)
