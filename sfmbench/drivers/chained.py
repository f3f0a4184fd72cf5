"""The embedded mapper's product loop: `SequentialMapper` driven chain by
chain (`process_chain_k`, a `process` where a chain cannot run), one
deferred asynchronous window bundle adjustment per commit, `flush_ba`,
then one global self-calibrating bundle adjustment. A copy of the JAX
package's bench.py loop as the port's smoke test drives it (not
pipelined); the configuration's `mapper` block gives its options.

Spans: `register` around every registration call (each ended by a
synchronize, as the loop it copies does), `window_ba` around each window
dispatch, `global_ba` around the flush and the global solve.
"""

import time
from dataclasses import dataclass

from ..core import MapRecord, map_state
from ..reference.scene import mapper_seed


@dataclass
class Context:
    cell: object
    inputs: object
    seed: int
    device: object
    opts: object
    init_opts: object
    window_ba: object
    global_ba: object
    chain: int
    window: int
    capacity: int
    camera_model: int


def prepare(cell, inputs, seed, device):
    from mavmap_tpu_torch.ba import BAOptions
    from mavmap_tpu_torch.models import camera
    from mavmap_tpu_torch.sfm import SequentialMapperOptions

    m = cell.config["mapper"]
    opts = SequentialMapperOptions(**m["options"])
    init_opts = SequentialMapperOptions(**dict(m["options"], **m["initial_options"]))
    return Context(cell=cell, inputs=inputs, seed=seed, device=device, opts=opts,
                   init_opts=init_opts, window_ba=BAOptions(**m["window_ba"]),
                   global_ba=BAOptions(**m["global_ba"]), chain=m["chain"],
                   window=m["window_images"], capacity=cell.workload["capacity"],
                   camera_model=getattr(camera, cell.config["camera_model"]))


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run_loop(ctx, feats, ransac_seed, spans, n_images):
    """One map of the first `n_images` frames; returns (mapper, stats)."""
    from mavmap_tpu_torch.features import ArrayFeatureProvider
    from mavmap_tpu_torch.sfm import SequentialMapper

    scene = ctx.inputs.scene
    prov = ArrayFeatureProvider(feats, capacity=ctx.capacity)
    m = SequentialMapper([0] * scene.num_images, [ctx.camera_model], scene.cam_params, prov,
                         device=ctx.device, seed=ransac_seed)
    st = {"register_s": 0.0, "window_ba_s": 0.0, "global_ba_s": 0.0}
    dev, opts, chain = ctx.device, ctx.opts, ctx.chain

    def solve_s():
        return m.counters.get("ba_solve_s", 0.0)

    def register(fn, *a, **kw):
        # Deferred window solves run inside the register step that
        # dispatches them: their time goes to the window BA.
        s0, t0 = solve_s(), time.perf_counter()
        with spans("register"):
            out = fn(*a, **kw)
            _sync(dev)
        ds = solve_s() - s0
        st["register_s"] += time.perf_counter() - t0 - ds
        st["window_ba_s"] += ds
        return out

    def local_ba():
        window = sorted(m.image_idx_to_id)[-ctx.window:]
        if len(window) > 2:
            t0 = time.perf_counter()
            with spans("window_ba"):
                m.adjust_bundle(window[2:], window[:2], ba_options=ctx.window_ba, async_=True,
                                defer=True)
            st["window_ba_s"] += time.perf_counter() - t0

    _sync(dev)
    t_start = time.perf_counter()
    if register(m.process_initial, 0, 1, ctx.init_opts):
        last, i, per_frame = 1, 2, False
        while i < n_images:
            run = [j for j in range(i, min(i + chain, n_images)) if not m.is_image_processed(j)]
            if not per_frame and len(run) >= 2 and run == list(range(run[0], run[-1] + 1)):
                committed = sum(register(m.process_chain_k, run, last, opts, pad_to=chain))
                if committed:
                    last = run[committed - 1]
                    local_ba()
                    i = last + 1
                    continue
            if register(m.process, i, last, opts):
                last = i
                local_ba()
            i, per_frame = i + 1, False
        t0 = time.perf_counter()
        with spans("global_ba"):
            m.flush_ba()
            m.adjust_global_bundle(ctx.global_ba)
            _sync(dev)
        st["global_ba_s"] = time.perf_counter() - t0
    st["wall_s"] = time.perf_counter() - t_start
    return m, st


def warmup(ctx, spans):
    """A short prefix of the cell's own flight under the warm-up's noise:
    every path of the window (two-view start, chains, window and global
    solves) runs once."""
    run_loop(ctx, ctx.inputs.feats[-1], mapper_seed(ctx.seed, -1), spans,
             ctx.cell.workload["warmup_frames"])


def map_once(ctx, k, spans):
    n = ctx.inputs.scene.num_images
    m, st = run_loop(ctx, ctx.inputs.feats[k], mapper_seed(ctx.seed, k), spans, n)
    return MapRecord(wall_s=st.pop("wall_s"), offered=n, registered=m.num_proc_images,
                     counters=dict(m.counters), timings={}, stats=st,
                     state=map_state(m, 1, 0))
