"""The full mapping run: `mavmap_tpu_torch.sfm.pipeline.run_pipeline` in
sequential mode with a vocabulary tree (loop detection every
`loop_detection_period` frames, batched closure registration, the
post-pass's back-fill, global BA, merge and closure sweeps), options from
the configuration's `pipeline` block.

Set-up trains the tree on the card (`train_voc_tree`) from the warm-up's
features: `tree.rows` descriptors drawn from every `tree.every`-th frame.

`run_pipeline` seeds its mappers itself, so the run's `--seed` changes
nothing here: a workload of one flight maps the same flight on every seed.

Spans: `sequential_loop` around the call, and around the post-pass stages
the harness wraps from outside (`backfill`, `global_ba`, `merge`,
`closure_sweeps`, by the names the pipeline module looks them up by);
time inside no stage is the sequential loop.
"""

import contextlib
import time
from dataclasses import dataclass

import numpy as np

from ..core import MapRecord, map_state

STAGES = {"process_remaining_images": "backfill", "_global_ba": "global_ba",
          "merge_mappers": "merge", "_final_closure_sweeps": "closure_sweeps"}


@dataclass
class Context:
    cell: object
    inputs: object
    device: object
    opts: object
    tree: object
    capacity: int
    camera_model: int


def prepare(cell, inputs, seed, device):
    from mavmap_tpu_torch.loop import train_voc_tree
    from mavmap_tpu_torch.models import camera
    from mavmap_tpu_torch.sfm.pipeline import PipelineOptions

    cfg = cell.config
    t = cfg["tree"]
    desc = np.concatenate([d for _, d in inputs.feats[-1][:: t["every"]]])
    rows = desc[np.random.default_rng(t["seed"]).permutation(len(desc))[: t["rows"]]]
    tree = train_voc_tree(rows, branching=t["branching"], depth=t["depth"], iters=t["iters"],
                          device=device)
    return Context(cell=cell, inputs=inputs, device=device,
                   opts=PipelineOptions(**cfg["pipeline"]), tree=tree,
                   capacity=cell.workload["capacity"],
                   camera_model=getattr(camera, cfg["camera_model"]))


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_spans(spans):
    """Wrap the pipeline module's post-pass stages in spans while the
    context is open."""
    from mavmap_tpu_torch.sfm import pipeline

    orig = {name: getattr(pipeline, name) for name in STAGES}

    def wrap(name, fn):
        def staged(*a, **kw):
            with spans(STAGES[name]):
                return fn(*a, **kw)
        return staged

    for name, fn in orig.items():
        setattr(pipeline, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(pipeline, name, fn)


def run(ctx, feats, spans, end=-1):
    """One run_pipeline over the flight's first `end` + 1 frames (all with
    -1); returns (result, wall seconds)."""
    from dataclasses import replace

    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.sfm.pipeline import run_pipeline

    scene = ctx.inputs.scene
    prov = ArrayFeatureProvider(feats, capacity=ctx.capacity)
    opts = replace(ctx.opts, end_image_idx=end)
    _sync(ctx.device)
    t0 = time.perf_counter()
    # Time outside every post-pass stage span is the sequential loop.
    with spans("sequential_loop"), stage_spans(spans):
        res = run_pipeline([0] * scene.num_images, [ctx.camera_model], scene.cam_params, prov,
                           opts, voc_tree=ctx.tree, device=ctx.device)
        _sync(ctx.device)
    return res, time.perf_counter() - t0


def warmup(ctx, spans):
    """The cell's own flight's first `warmup_frames` frames under the
    warm-up's noise: chains, window solves, a loop query, batched closure
    registration, the global BA and a closure sweep each run once."""
    run(ctx, ctx.inputs.feats[-1], spans, end=ctx.cell.workload["warmup_frames"] - 1)


def map_once(ctx, k, spans):
    res, wall = run(ctx, ctx.inputs.feats[k], spans)
    counters = {}
    for m in res.mappers:
        for name, v in m.counters.items():
            counters[name] = counters.get(name, 0) + v
    main = res.main_mapper
    closures = counters.get("loop_closures", 0) + counters.get("sweep_closures", 0)
    return MapRecord(wall_s=wall, offered=ctx.inputs.scene.num_images,
                     registered=main.num_proc_images, counters=counters,
                     timings=dict(res.timings), stats={"maps": len(res.mappers)},
                     state=map_state(main, len(res.mappers), closures))
