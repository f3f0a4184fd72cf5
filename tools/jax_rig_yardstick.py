"""The JAX package's CLI over chip_smoke.py's rig phase, on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_rig_yardstick.py [WORKDIR] [--port]

Writes the rig phase's files as chip_smoke.py writes them
(chip_smoke.write_rig_dataset: bench.py's 30-image scene as a two-camera rig,
imagedata.txt with two camera definitions and CAM_IDX-only lines, each
frame's features as reference-format dumps, and a vocabulary tree trained
by the port on every 10th frame, here on the CPU), then runs
`mavmap_tpu.cli.main` on them with the phase's flags (chip_smoke.rig_args:
--reference-cache-path, capacity 1024, loop detection every 10 frames, the
CLI's default self-calibration). The JAX package reads a descriptor dump's
rows and cols as 8-byte ints where the reference writes 4-byte ones, so its
dumps are written in its own layout from the same arrays. Prints one JSON
line with the numbers chip_smoke.py holds the port to (chip_smoke.rig_metrics,
read from the CLI's own output files: registered count, ATE after a
similarity fit) and the wall seconds; JAX_CPU_RIG_* in chip_smoke.py come
from this line. --port also runs the port's CLI with --device cpu on the
reference-layout files and prints its line. WORKDIR (default: a new
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


def _run(name, main, work, out, extra=()):
    scene = chip_smoke.rig_scene()[0]
    t0 = time.perf_counter()
    rc = main(chip_smoke.rig_args(work, out, extra))
    wall = time.perf_counter() - t0
    m = chip_smoke.rig_metrics(out, scene) if rc == 0 else {}
    print(json.dumps({"cli": name, "rc": rc, **m, "wall_s": wall, "workdir": work}),
          flush=True)


def main(work, port):
    from mavmap_tpu.cli import main as jax_cli_main

    cpu = torch.device("cpu")
    jax_work, port_work = os.path.join(work, "jax"), os.path.join(work, "port")
    for d in (jax_work, port_work):
        os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    chip_smoke.write_rig_dataset(jax_work, cpu, header_int_bytes=8)
    print(f"files written in {time.perf_counter() - t0:.2f} s", flush=True)
    _run("jax", jax_cli_main, jax_work, os.path.join(jax_work, "out"))
    if port:
        from mavmap_tpu_torch.cli import main as port_cli_main

        chip_smoke.write_rig_dataset(port_work, cpu)
        _run("port", port_cli_main, port_work, os.path.join(port_work, "out"),
             ["--device", "cpu"])


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--port"]
    main(args[0] if args else tempfile.mkdtemp(prefix="jax_rig_"), "--port" in sys.argv[1:])
