"""The command-line mapper: `mavmap_tpu_torch.cli.run`, the product's
entry point, over a flight written as its user's files (imagedata.txt
with each frame's camera and mavmap's feature dumps,
`reference/mavmap_files.py`), with the configuration's `cli` flags and a
vocabulary tree; every other option is the CLI's default.

Set-up writes the warm-up flight's files and those of each flight of the
window under one temporary directory, and trains the tree on the card as
the pipeline driver does (`tree.rows` descriptors of every `tree.every`-th
warm-up frame), saved as tree.npz for --voc-tree-path.

A map is one `cli.run` into a fresh output directory, timed from the call
to after a synchronize on its return: the time the CLI's user waits,
input parsing, dump reads and output writes included. A non-zero return
code raises. The CLI's standard output goes to standard error, so that the
harness's result line stays last. `run_pipeline` seeds its mappers
itself: the run's `--seed` orders the flights and changes nothing else.

Spans: `cli` around the call, and inside it the post-pass stages
(`stage_spans` of the pipeline driver); time inside no stage is the
CLI's inputs, the sequential loop and its outputs.
"""

import contextlib
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from ..core import MapRecord, map_state
from ..reference import mavmap_files
from .pipeline import stage_spans


@dataclass
class Context:
    cell: object
    inputs: object
    device: object
    tmp: object
    tree_path: str


def flight_dir(ctx, k):
    return os.path.join(ctx.tmp.name, "warmup" if k == -1 else f"map{k}")


def prepare(cell, inputs, seed, device):
    from mavmap_tpu_torch.loop import train_voc_tree

    tmp = tempfile.TemporaryDirectory(prefix="sfmbench_cli_")
    ctx = Context(cell=cell, inputs=inputs, device=device, tmp=tmp,
                  tree_path=os.path.join(tmp.name, "tree.npz"))
    for k, feats in inputs.feats.items():
        mavmap_files.write_flight(flight_dir(ctx, k), inputs.scene, feats)
    t = cell.config["tree"]
    desc = np.concatenate([d for _, d in inputs.feats[-1][:: t["every"]]])
    rows = desc[np.random.default_rng(t["seed"]).permutation(len(desc))[: t["rows"]]]
    train_voc_tree(rows, branching=t["branching"], depth=t["depth"], iters=t["iters"],
                   device=device).save(ctx.tree_path)
    return ctx


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(ctx, k, spans, extra=()):
    """One cli.run over flight k's files (-1: the warm-up's) with the
    configuration's flags and `extra`; returns (CliRun, wall seconds)."""
    from mavmap_tpu_torch import cli

    root = flight_dir(ctx, k)
    out = tempfile.mkdtemp(prefix="out", dir=ctx.tmp.name)
    argv = ["--input-path", os.path.join(root, "data"), "--output-path", out,
            "--reference-cache-path", os.path.join(root, "ref"),
            "--voc-tree-path", ctx.tree_path, "--device", str(ctx.device),
            *ctx.cell.config["cli"], *extra]
    try:
        _sync(ctx.device)
        t0 = time.perf_counter()
        with spans("cli"), stage_spans(spans), contextlib.redirect_stdout(sys.stderr):
            r = cli.run(argv)
            _sync(ctx.device)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if r.rc != 0:
        raise RuntimeError(f"mavmap_tpu_torch.cli returned {r.rc} on flight {k}")
    return r, wall


def warmup(ctx, spans):
    """The warm-up flight's first `warmup_frames` frames through the CLI:
    chains on both cameras, window solves with two camera blocks, a loop
    query, the global BA, a closure sweep and the writers each run once."""
    run(ctx, -1, spans, ["--end-image-idx", str(ctx.cell.workload["warmup_frames"] - 1)])


def record(ctx, r, wall):
    """The map record of one CLI run: counters summed over its mappers, the
    pipeline's stage timings with the CLI's own (none from a CLI that has
    no spans), the judged main map."""
    res = r.result
    counters = {}
    for m in res.mappers:
        for name, v in m.counters.items():
            counters[name] = counters.get(name, 0) + v
    timings = dict(res.timings)
    timings.update(getattr(r, "timings", {}))
    main = res.main_mapper
    closures = counters.get("loop_closures", 0) + counters.get("sweep_closures", 0)
    return MapRecord(wall_s=wall, offered=ctx.inputs.scene.num_images,
                     registered=main.num_proc_images, counters=counters, timings=timings,
                     stats={"maps": len(res.mappers)},
                     state=map_state(main, len(res.mappers), closures))


def map_once(ctx, k, spans):
    return record(ctx, *run(ctx, k, spans))
