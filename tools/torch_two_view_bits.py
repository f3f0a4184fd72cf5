"""The two-view step on the card: which operations give a slot bits that
depend on B, and host ms per step.

    python3 tools/torch_two_view_bits.py probe [TREE ...]     (default: .)
    python3 tools/torch_two_view_bits.py time TREE [TREE ...]

`probe TREE` (a checkout; one worker process per tree imports its
mavmap_tpu_torch and chip_smoke.py): on chip_smoke.py's survey (image 0 against images
1..B, the mapper's options, injected RANSAC samples),
  1. two_view_init_batch at B = 8 and 32 against each slot alone (B = 1):
     how many slots give the same bits (rows and scalars);
  2. every call of the step's stages and of the torch reductions and
     linear-algebra routines it makes, recorded while each of 32 slots
     runs alone, then replayed once on the 32 slots' inputs joined along
     the leading axis: how many slots of that joined call give the bits of
     the call alone (one JSON line per function, naming the calls that
     differ and their shapes);
  3. the per-slot linear-algebra routines (one matrix per slot) at a fixed
     batch count: a slot's matrix among 32 against the slot's matrix padded
     with identities to 32, and to 2.

`time TREE ...`: for each TREE (a checkout; repeat trees to run them in
turns, e.g. `_archive/parent . . _archive/parent`), one worker process
imports that tree's mavmap_tpu_torch and times one two_view_init_batch step
at B = 1, 8 and 32 (host ms from the call to its outputs on the host,
median of 5 after a warm-up) and counts its host syncs. One JSON line per
(tree, B).

Needs a CUDA card; prints the card's name and power limit with every line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = (1, 8, 32)
RUNS = 5


def _load(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _inputs(smoke, dev, B):
    """two_view_init_batch's inputs: image 0 against images 1..B."""
    scene, feats, gt = smoke._survey_scene()
    args = smoke.geometry_inputs(torch, dev, scene, feats, gt, B)
    return [a[0] for a in args[:4]], args[4:8], args[17]


def worker(tree):
    """Time the step of the tree at sys.path[0] (see the module docstring)."""
    from mavmap_tpu_torch.sfm.kernels import two_view_init_batch

    smoke = _load("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    count_syncs = _load("timer", os.path.join(tree, "mavmap_tpu_torch/utils/timer.py")).count_syncs
    dev = torch.device("cuda", 0)
    card = _card()
    first, cands, nts = _inputs(smoke, dev, max(SLOTS))
    for B in SLOTS:
        sub = [c[:B] for c in cands]
        gen = torch.Generator(device=dev)
        gen.manual_seed(B)

        def call():
            return two_view_init_batch(gen, *first, *sub, 0.9, 1e9, nts[:B], essential_trials=512)

        def step():
            rows, scalars = call()
            return rows.cpu().numpy(), scalars.cpu().numpy()

        step()  # warm-up
        walls = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
        syncs, _ = count_syncs(call)
        wall = statistics.median(walls)
        print(json.dumps({"tree": tree, "B": B, "host_ms_per_step": 1000 * wall,
                          "host_ms_per_slot": 1000 * wall / B,
                          "host_ms_runs": [1000 * w for w in walls], "syncs": syncs,
                          "card": card}), flush=True)


# ----------------------------------------------------------------- probe


def _same(a, b):
    """Bit equality of two tensors, NaN payloads included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))
    return torch.equal(a, b)


def _tensors(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _slot_equal(joined, alone, b):
    """Whether slot b of a joined call's outputs has the bits of the call
    alone (each output sliced by its own leading size)."""
    for j, a in zip(_tensors(joined), _tensors(alone)):
        if a.dim() == 0:
            continue
        n = a.shape[0]
        if not _same(j[b * n:(b + 1) * n], a):
            return False
    return True


def _join(per_slot):
    """One call's arguments from each slot's: tensors that differ by slot
    joined along the leading axis, the rest (tables, callables, numbers)
    as slot 0 has them."""
    first = per_slot[0]
    if torch.is_tensor(first):
        if all(p is first for p in per_slot) or first.dim() == 0:
            return first
        return torch.cat(per_slot)
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_join([p[i] for p in per_slot]) for i in range(len(first)))
    return first


REDUCTIONS = ("torch.sum", "torch.prod", "torch.sort", "torch.linalg.norm",
              "torch.linalg.vector_norm")


def _reduces_leading(name, args, kwargs):
    """A call that reduces over (or sorts along) the leading axis, which
    joining the slots would change."""
    if name not in REDUCTIONS or not args or not torch.is_tensor(args[0]):
        return False
    positional = len(args) > 1 and name in REDUCTIONS[:3]
    dim = kwargs.get("dim", args[1] if positional else None)
    if dim is None:
        return True
    dims = dim if isinstance(dim, (tuple, list)) else (dim,)
    return any(d % args[0].dim() == 0 for d in dims)


class Recorder:
    """Wraps functions to record their arguments while `on`."""

    def __init__(self, targets):
        self.targets = targets
        self.saved = []
        self.calls = []
        self.on = False

    def __enter__(self):
        for mod, attr, name in self.targets:
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                if self.on:
                    self.calls.append((_name, _fn, a, kw))
                return _fn(*a, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


def _stage_targets():
    import mavmap_tpu_torch.sfm.kernels as km
    from mavmap_tpu_torch.ops import essential, homography, polynomial, projection, triangulation

    targets = [(km, "ransac", "ransac"),
               (km.matching, "median_feature_disparity", "median_feature_disparity"),
               (km, "rvec_from_rotmat", "rvec_from_rotmat"),
               (projection, "invert_proj_matrix", "invert_proj_matrix"),
               (triangulation, "triangulate_points", "triangulate_points"),
               (triangulation, "calc_tri_angles", "calc_tri_angles"),
               (projection, "calc_depth", "calc_depth"),
               (homography, "solve_homography", "solve_homography"),
               (homography, "homography_residuals", "homography_residuals"),
               (polynomial, "roots_durand_kerner", "roots_durand_kerner")]
    for name in ("solve_essential_5pt", "solve_essential_8pt", "pose_from_essential_matrix",
                 "decompose_essential_matrix", "sampson_residuals", "_epipolar_design",
                 "_build_constraints", "_polish_xyz", "_svd_or_nan", "solve_or_nan"):
        if hasattr(essential, name):
            targets.append((essential, name, name))
    for name in ("sum", "einsum", "sort", "matmul", "bmm", "prod"):
        targets.append((torch, name, "torch." + name))
    for name in ("svd", "solve_ex", "eigh", "norm", "vector_norm", "det", "inv_ex"):
        targets.append((torch.linalg, name, "torch.linalg." + name))
    return targets


def _replay(per_slot_calls, B):
    """For each recorded call index, the slots whose joined call gives the
    call alone's bits."""
    report = {}
    n_calls = len(per_slot_calls[0])
    for i in range(n_calls):
        name, fn, a0, kw0 = per_slot_calls[0][i]
        if any(len(c) != n_calls or c[i][0] != name for c in per_slot_calls):
            report.setdefault(name, []).append({"call": i, "skipped": "control flow"})
            continue
        if _reduces_leading(name, a0, kw0):
            continue
        args = [_join([c[i][2][k] for c in per_slot_calls]) for k in range(len(a0))]
        kw = {k: _join([c[i][3][k] for c in per_slot_calls]) for k in kw0}
        try:
            joined = fn(*args, **kw)
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            report.setdefault(name, []).append({"call": i, "skipped": type(e).__name__})
            continue
        equal = sum(int(_slot_equal(joined, fn(*c[i][2], **c[i][3]), b))
                    for b, c in enumerate(per_slot_calls))
        shapes = [list(t.shape) for t in _tensors(list(a0) + list(kw0.values()))][:3]
        report.setdefault(name, []).append({"call": i, "equal": equal, "shapes": shapes})
    return report


def _step_equal(km, first, cands, nts, samples, B):
    rows, scalars = km.two_view_init_batch(None, *first, *[c[:B] for c in cands], 0.9, 1e9,
                                           nts[:B], essential_trials=512,
                                           samples=tuple(s[:B] for s in samples))
    same = 0
    for b in range(B):
        r, s = km.two_view_init_batch(None, *first, *[c[b:b + 1] for c in cands], 0.9, 1e9,
                                      nts[b:b + 1], essential_trials=512,
                                      samples=tuple(s[b:b + 1] for s in samples))
        same += int(_same(rows[b], r[0]) and _same(scalars[b], s[0]))
    return same, bool(torch.isfinite(rows).all())


def _padded_linalg(card, dev):
    """Per-slot routines at a fixed batch count (see the module docstring)."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    B = 32

    def rand(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    m9 = rand(B, 20, 9, dtype=torch.float64)
    cases = {
        "linalg.eigh (9, 9) f64": (lambda a: torch.linalg.eigh(a)[1],
                                   m9.transpose(-1, -2) @ m9),
        "linalg.svd (3, 3) f64": (lambda a: torch.linalg.svd(a)[0],
                                  rand(B, 3, 3, dtype=torch.float64)),
        "linalg.svd (3, 3) f32": (lambda a: torch.linalg.svd(a)[0],
                                  rand(B, 3, 3, dtype=torch.float32)),
        "linalg.det (3, 3) f32": (torch.linalg.det, rand(B, 3, 3, dtype=torch.float32)),
    }
    for name, (fn, x) in cases.items():
        full = fn(x)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=dev)
        alone = at_b = at_0 = pair = 0
        for b in range(B):
            alone += int(_same(full[b], fn(x[b:b + 1])[0]))
            pad = eye.expand(B, -1, -1).clone()
            pad[b] = x[b]
            at_b += int(_same(full[b], fn(pad)[b]))
            pad = eye.expand(B, -1, -1).clone()
            pad[0] = x[b]
            at_0 += int(_same(full[b], fn(pad)[0]))
            pair += int(_same(full[b], fn(torch.stack([x[b], eye]))[0]))
        print(json.dumps({"probe": "per-slot routine", "op": name, "B": B,
                          "alone_equal": alone, "padded_32_same_position_equal": at_b,
                          "padded_32_position_0_equal": at_0, "padded_2_equal": pair,
                          "card": card}), flush=True)


def probe(tree):
    """The probe of the tree at sys.path[0] (see the module docstring)."""
    import mavmap_tpu_torch.sfm.kernels as km
    from mavmap_tpu_torch.ops.ransac import draw_samples

    smoke = _load("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    dev = torch.device("cuda", 0)
    card = f"{_card()}; tree {tree}"
    B = 32
    first, cands, nts = _inputs(smoke, dev, B)
    _, valid = km.matching.match_features_batched(
        first[1], cands[1], first[2], cands[2], first[0], cands[0], ratio=0.9, max_distance=1e9)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    samples = draw_samples(gen, [(128, 4, valid), (512, 5, valid)])

    for b_step in (8, 32):
        same, finite = _step_equal(km, first, cands, nts, samples, b_step)
        print(json.dumps({"probe": "two_view_init_batch slots", "B": b_step,
                          "slots_equal_at_B1": same, "rows_finite": finite, "card": card}),
              flush=True)

    with Recorder(_stage_targets()) as rec:
        per_slot = []
        for b in range(B):
            rec.calls = []
            rec.on = True
            km.two_view_init_batch(None, *first, *[c[b:b + 1] for c in cands], 0.9, 1e9,
                                   nts[b:b + 1], essential_trials=512,
                                   samples=tuple(s[b:b + 1] for s in samples))
            rec.on = False
            per_slot.append(rec.calls)
        report = _replay(per_slot, B)
    for name, calls in report.items():
        differ = [c for c in calls if c.get("equal", B) < B]
        print(json.dumps({"probe": "call", "fn": name, "B": B, "calls": len(calls),
                          "calls_with_B_dependent_slots": len(differ), "differ": differ[:12],
                          "card": card}), flush=True)
    _padded_linalg(card, dev)


def main(argv):
    if not torch.cuda.is_available():
        raise RuntimeError("torch_two_view_bits.py runs on a CUDA card")
    modes = {"probe": ("--probe", argv[1:] or ["."]), "time": ("--worker", argv[1:])}
    if argv[:1] == [] or argv[0] not in modes or not modes[argv[0]][1]:
        raise SystemExit(__doc__)
    flag, trees = modes[argv[0]]
    for tree in trees:
        path = os.path.abspath(os.path.join(ROOT, tree))
        subprocess.run([sys.executable, os.path.abspath(__file__), flag, path], check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--worker", "--probe"):
        sys.path.insert(0, sys.argv[2])
        (worker if sys.argv[1] == "--worker" else probe)(sys.argv[2])
    else:
        main(sys.argv[1:])
