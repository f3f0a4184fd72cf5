"""The idle time of one benchmark cell's traced window, by the program's
own spans.

    python3 tools/idle_by_span.py --workload uav30-chained --seed 7 [--seconds 51]
    python3 tools/idle_by_span.py --workload uav30-chained --seed 7 --no-profile [--maps 6]

from the root of a checkout, on a CUDA card. The cell runs as
`python3 -m sfmbench.run --trace 1` runs it, through the benchmark's own
files (its workload, configuration and driver, the warm-up, the
whole-map window under torch.profiler), with
mavmap_tpu_torch.utils.timer.recording() open over the window. The
program's span records go under the harness's spans, each one level
deeper than any harness span (so the innermost span at a gap is the
program's where one is open), and sfmbench.core.reduce_trace labels the
device's idle gaps as it does for the benchmark.

Prints JSON lines: the idle seconds by innermost span, with the harness's
spans alone and with the program's merged under them; for each harness
label, the share of its idle seconds inside a program span (`covered`)
and inside one below the pipeline's stage spans (`covered_below_stages`);
host syncs by program span; and `outside`, the program spans that end
after the harness span open at their start, or start inside none (0 where
every program span nests in the harness's).

--no-profile: no profiler. The maps of the window alternate recording off
and on (off first), and the cost of one span is timed on the host: with a
counter while nothing records, without one (one check), and recording.
--out FILE also writes the lines to FILE.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def merged_spans(core, harness, records):
    """A core.Spans holding the harness's spans and the program's records,
    each record `1 + max harness depth + its own depth` deep."""
    out = core.Spans()
    top = max((d for *_, d in harness), default=-1) + 1
    out.done = list(harness) + [(name, t0, t1, top + depth)
                                for name, t0, t1, depth, _, _ in records]
    return out


def outside(harness, records):
    """Program spans that start inside no harness span, or end after the
    innermost harness span open at their start."""
    n = 0
    for _, t0, t1, *_ in records:
        open_at = [(d, e) for _, s, e, d in harness if s <= t0 <= e]
        if not open_at or t1 > max(open_at)[1]:
            n += 1
    return n


def coverage(idle_harness, idle_merged, names):
    """Per harness label: the share of its idle seconds that the merged
    labelling gives to a span not in `names` (the harness's own labels)."""
    out = {}
    for label, total in idle_harness.items():
        if total > 0:
            out[label] = 1.0 - idle_merged.get(label, 0.0) / total
    return {k: v for k, v in out.items() if k in names}


def syncs_by_span(records):
    by = {}
    for name, *_, syncs in records:
        by[name] = by.get(name, 0) + syncs
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def per_frame(window):
    """The registration, BA and sync counters of the window's maps per
    frame offered (seconds as ms)."""
    offered = sum(r.offered for r in window)
    out = {}
    for k in ("reg_prepare_s", "reg_dispatch_s", "reg_pose_lm_s", "reg_wait_s",
              "reg_commit_s", "ba_apply_s", "ba_solve_s", "ba_selfcal_s", "host_syncs",
              "ba_host_syncs"):
        v = sum(r.counters.get(k, 0) for r in window) / offered
        out[k[:-2] + "_ms" if k.endswith("_s") else k] = 1000.0 * v if k.endswith("_s") else v
    out["register_ms"] = 1000.0 * sum(r.stats.get("register_s", 0.0)
                                      for r in window) / offered
    return out


def span_cost_ns(timer, n=100_000):
    """Host ns per span: (with a counter, recording off), (no counter, off),
    (with a counter, recording)."""
    class Owner:
        counters = {}

    o = Owner()

    def loop(counter):
        with timer.span("outer", None, o):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with timer.span("inner", counter):
                    pass
            return (time.perf_counter_ns() - t0) / n

    off, bare = loop("inner_s"), loop(None)
    with timer.recording():
        on = loop("inner_s")
    return {"counter_off_ns": off, "no_counter_off_ns": bare, "counter_recording_ns": on}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 tools/idle_by_span.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--no-profile", action="store_true",
                   help="no profiler: maps alternate recording off / on")
    p.add_argument("--maps", type=int, default=6, help="with --no-profile: maps to time")
    p.add_argument("--out", default=None, help="also write the lines to this file")
    args = p.parse_args(argv)

    import torch

    from mavmap_tpu_torch import native
    from mavmap_tpu_torch.ops.cuda import build
    from mavmap_tpu_torch.utils import timer
    from sfmbench import core

    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    build.library()
    native.load_mapstore_lib()
    cell = core.load_cell(args.workload)
    wl = cell.workload
    maps = args.maps if args.no_profile else wl["maps"]
    inputs = core.make_inputs(wl, args.seed, wl["maps"], cell.config)
    ctx = cell.driver.prepare(cell, inputs, args.seed, dev)
    spans = core.Spans()
    cell.driver.warmup(ctx, spans)
    torch.cuda.synchronize()
    spans.done.clear()
    lines = [{"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(dev)}]

    if args.no_profile:
        walls = {"off": [], "on": []}
        for k in range(maps):
            mode = "on" if k % 2 else "off"
            with (timer.recording() if mode == "on" else contextlib.nullcontext()):
                rec = cell.driver.map_once(ctx, k % wl["maps"], spans)
            walls[mode].append(rec.registered / rec.wall_s)
        lines.append({"frames_per_s": walls, "median": {
            m: statistics.median(v) for m, v in walls.items() if v}})
        lines.append({"span_cost": span_cost_ns(timer)})
    else:
        tstate = {}
        with timer.recording() as records, core._traced(torch, tstate):
            window = core.run_window(lambda k: cell.driver.map_once(ctx, k, spans),
                                     args.seconds, maps)
        harness = list(spans.done)
        red_h = core.reduce_trace(tstate["events"], tstate["open"], tstate["close"], spans,
                                  tstate["kernel_log"], top=1000)
        merged = merged_spans(core, harness, records)
        red_m = core.reduce_trace(tstate["events"], tstate["open"], tstate["close"], merged,
                                  tstate["kernel_log"], top=1000)
        below = merged_spans(core, harness,
                             [r for r in records if not r[0].startswith("pipeline.")])
        red_b = core.reduce_trace(tstate["events"], tstate["open"], tstate["close"], below,
                                  tstate["kernel_log"], top=1000)
        idle_h, idle_m, idle_b = (dict(r["idle_gaps"]) for r in (red_h, red_m, red_b))
        names = {n for n, *_ in harness} | {"none"}
        lines += [
            {"maps": len(window), "frames": sum(r.registered for r in window),
             "window_s": red_h["window_s"], "busy_s": red_h["busy_s"]},
            {"idle_s_by_harness_span": idle_h},
            {"idle_s_by_innermost_span": idle_m},
            {"covered": coverage(idle_h, idle_m, names),
             "covered_below_stages": coverage(idle_h, idle_b, names)},
            {"host_syncs_by_span": syncs_by_span(records)},
            {"counters_per_frame": per_frame(window)},
            {"program_spans": len(records), "outside": outside(harness, records)},
        ]
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
