"""The batched registration step on the card: host time per slot, the pose
LM's stop rules, and which operations give a slot bits that depend on B.

    python3 benchmarks/torch_batched_geometry.py [TREE ...]   (default: .)

For each TREE (a checkout of the repository; the same tree may repeat, so
that `_archive/parent . . _archive/parent` runs two trees in turns), in the
order given, one worker process imports that tree's mavmap_tpu_torch and
times one register_view_pairs step on chip_smoke.py's survey (consecutive
pairs, ground-truth track states, the mapper's options) at B = 1, 8 and 32:
host ms from the call to its outputs on the host, median after a warm-up,
and the host syncs of one step (CUDA's sync debug mode) with the source
line of each. A tree whose pose LM runs from the host with a stop flag
(ba.core._lm_stop_rule: "lagged", a flag copied without waiting) is timed
with it and with two stand-ins defined here: "sync" reads the flag every
iteration, "fixed" runs max_iters iterations; each of 6 rounds runs every
rule once, the order turned by one each round. A tree without it (the pose
LM in one launch of kernel K4) is timed 6 times alone. One JSON line per
(tree, rule, B).

Then, in this checkout, the B-dependence probe: a 32-slot
register_view_pairs and two_view_init_batch step and each of its slots
alone (B = 1) with the same injected RANSAC samples, compared stage by
stage (the values each stage of the geometry returns, slot by slot, bit for
bit), and single operations of the path at its shapes, each slot of a
32-slot batch against the slot alone. One JSON line each.

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


# The pose LM's stop rules compared: the port's own, and two stand-ins.
STOP_RULES = {
    "lagged": None,
    "sync": lambda device: lambda active: not bool(active.any()),
    "fixed": lambda device: lambda active: False,
}
ROUNDS = 6


def _load(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    return _load("chip_smoke", "chip_smoke.py")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def worker(tree):
    """Time the step of the tree at sys.path[0] (see the module docstring)."""
    from mavmap_tpu_torch.ba import core as ba_core
    from mavmap_tpu_torch.sfm.kernels import register_view_pairs

    smoke = _smoke()
    count_syncs = _load("timer", "mavmap_tpu_torch/utils/timer.py").count_syncs
    dev = torch.device("cuda", 0)
    scene, feats, gt = smoke._survey_scene()
    own = getattr(ba_core, "_lm_stop_rule", None)
    rules = list(STOP_RULES) if own is not None else [None]

    def use(rule):
        if rule is not None:
            ba_core._lm_stop_rule = STOP_RULES[rule] or own

    card = _card()
    results = {}
    for B in SLOTS:
        args = smoke.geometry_inputs(torch, dev, scene, feats, gt, B)
        gen = torch.Generator(device=dev)
        gen.manual_seed(B)

        def step():
            rows, scalars = register_view_pairs(gen, *args, p3p_trials=512)
            return rows.cpu().numpy(), scalars.cpu().numpy()

        step()  # warm-up
        for k in range(ROUNDS):
            for rule in rules[k % len(rules):] + rules[:k % len(rules)]:
                use(rule)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                results.setdefault((rule, B), []).append(time.perf_counter() - t0)
        for rule in rules:
            use(rule)
            sites = []
            syncs, _ = count_syncs(lambda: register_view_pairs(gen, *args, p3p_trials=512),
                                   sites)
            walls = results[(rule, B)]
            print(json.dumps({"tree": tree, "lm_stop": rule, "B": B,
                              "host_ms_per_step": 1000 * statistics.median(walls),
                              "host_ms_per_slot": 1000 * statistics.median(walls) / B,
                              "host_ms_runs": [1000 * w for w in walls], "syncs": syncs,
                              "sync_sites": {k: sites.count(k) for k in sorted(set(sites))},
                              "card": card}), flush=True)


def _same_slots(big, small, b):
    """Whether slot b of a batched stage output equals the B = 1 output."""
    if isinstance(big, (tuple, list)):
        return all(_same_slots(x, y, b) for x, y in zip(big, small)
                   if isinstance(x, (tuple, list)) or (torch.is_tensor(x) and x.dim() > 0))
    if not torch.is_tensor(big) or big.dim() == 0:
        return True
    return torch.equal(big[b], small[0])


def _stage_probe(stages, big_call, small_call, B):
    """How many of B slots give each stage's output the bits it has at
    B = 1: big_call() runs the B-slot step, small_call(b) slot b alone;
    every (module, name) in stages is wrapped to record its outputs."""
    record = {}
    saved = []
    for mod, name in stages:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            record.setdefault(_name, []).append(out)
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        big = big_call()
        big_rec = {k: list(v) for k, v in record.items()}
        same = {k: [0] * len(v) for k, v in big_rec.items()}
        same_out = 0
        for b in range(B):
            record.clear()
            small = small_call(b)
            same_out += int(torch.equal(big[0][b], small[0][0])
                            and torch.equal(big[1][b], small[1][0]))
            for k, calls in big_rec.items():
                for i, out in enumerate(calls):
                    same[k][i] += int(_same_slots(out, record[k][i], b))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return same, same_out


def probe():
    """Stage by stage and op by op: which give a slot bits that depend on B."""
    import mavmap_tpu_torch.sfm.kernels as km
    from mavmap_tpu_torch.ops.ransac import draw_samples
    from mavmap_tpu_torch.ops import essential
    from mavmap_tpu_torch.ops.reduce import matmul_ordered, sum_pairwise

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    card = _card()
    scene, feats, gt = smoke._survey_scene()
    B = 32
    args = smoke.geometry_inputs(torch, dev, scene, feats, gt, B)
    common = [(km, "ransac"), (km.matching, "median_feature_disparity"),
              (km, "rvec_from_rotmat"), (km.triangulation, "triangulate_points"),
              (km.triangulation, "calc_tri_angles"), (km.projection, "calc_depth")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    # register_view_pairs on the survey's consecutive pairs.
    matches, valid = km.matching.match_features_batched(
        args[1], args[5], args[2], args[6], args[0], args[4], ratio=0.9, max_distance=1e9)
    samples = draw_samples(gen, [(128, 4, valid), (512, 4, valid & args[10] & args[9])])

    def reg_one(b):
        one = [a[b:b + 1] for a in args[:14]] + [args[14][b:b + 1], args[15], args[16],
                                                 args[17][b:b + 1]]
        return km.register_view_pairs(None, *one, p3p_trials=512,
                                      samples=tuple(s[b:b + 1] for s in samples))

    reg_stages = common + [(km, "_pose_refine_loop"), (km.projection, "compose_proj_matrix"),
                           (km.projection, "calc_reproj_errors")]
    same, out = _stage_probe(
        reg_stages,
        lambda: km.register_view_pairs(None, *args, p3p_trials=512, samples=samples),
        reg_one, B)
    print(json.dumps({"probe": "register_view_pairs stages", "B": B,
                      "slots_equal_at_B1": same, "outputs_equal": out, "card": card}),
          flush=True)

    # register_view_batch: image B + 1 against images 1..B (the current
    # image, its camera and threshold shared).
    curr = [a[B - 1] for a in args[4:8]]
    prevs = args[4:8]
    state = args[8:13]
    matches, valid = km.matching.match_features_batched(
        prevs[1], curr[1], prevs[2], curr[2], prevs[0], curr[0], ratio=0.9, max_distance=1e9)
    samples_b = draw_samples(gen, [(128, 4, valid), (512, 4, valid & state[2] & state[1])])
    shared = [args[13][0], 1, 0.9, 1e9, args[17][0]]

    def batch_one(b):
        return km.register_view_batch(None, *[a[b:b + 1] for a in prevs], *curr,
                                      *[a[b:b + 1] for a in state], *shared, p3p_trials=512,
                                      samples=tuple(s[b:b + 1] for s in samples_b))

    same, out = _stage_probe(
        reg_stages,
        lambda: km.register_view_batch(None, *prevs, *curr, *state, *shared, p3p_trials=512,
                                       samples=samples_b),
        batch_one, B)
    print(json.dumps({"probe": "register_view_batch stages", "B": B,
                      "slots_equal_at_B1": same, "outputs_equal": out, "card": card}),
          flush=True)

    # two_view_init_batch: image 0 against images 1..B.
    first = [a[0] for a in args[:4]]
    cands = args[4:8]
    nts = args[17]
    matches, valid = km.matching.match_features_batched(
        first[1], cands[1], first[2], cands[2], first[0], cands[0], ratio=0.9,
        max_distance=1e9)
    samples = draw_samples(gen, [(128, 4, valid), (512, 5, valid)])

    def tv_one(b):
        return km.two_view_init_batch(None, *first, *[c[b:b + 1] for c in cands], 0.9, 1e9,
                                      nts[b:b + 1], essential_trials=512,
                                      samples=tuple(s[b:b + 1] for s in samples))

    same, out = _stage_probe(
        common + [(km.essential, "solve_essential_8pt"),
                  (km.essential, "pose_from_essential_matrix"),
                  (km.projection, "invert_proj_matrix")],
        lambda: km.two_view_init_batch(None, *first, *cands, 0.9, 1e9, nts,
                                       essential_trials=512, samples=samples),
        tv_one, B)
    print(json.dumps({"probe": "two_view_init_batch stages", "B": B,
                      "slots_equal_at_B1": same, "outputs_equal": out, "card": card}),
          flush=True)

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    N = 1024
    spd = rand(B, 6, 6)
    spd = spd @ spd.transpose(-1, -2) + torch.eye(6, device=dev)
    nine = rand(B, 9, 9, dtype=torch.float64)
    ops = {
        "sum (B, N) f32 over N": (lambda x: x.sum(-1), [rand(B, N)]),
        "sum_pairwise (B, N) f32 over N": (sum_pairwise, [rand(B, N)]),
        "sum (B, T*M, N) f32 over N": (lambda x: x.sum(-1), [rand(B, 640, N)]),
        "einsum boki,bokj->bij (LM normal matrix)":
            (lambda j: torch.einsum("boki,bokj->bij", j, j), [rand(B, N, 2, 6)]),
        "linalg.solve_ex (B, 6, 6)": (lambda a, b: torch.linalg.solve_ex(a, b)[0],
                                      [spd, rand(B, 6, 1)]),
        "linalg.eigh (B, 9, 9) f64": (lambda a: torch.linalg.eigh(a @ a.transpose(-1, -2))[1],
                                      [nine]),
        "linalg.svd (B, 3, 3) f64": (lambda a: torch.linalg.svd(a)[0],
                                     [rand(B, 3, 3, dtype=torch.float64)]),
        "linalg.det (B, 3, 3)": (torch.linalg.det, [rand(B, 3, 3)]),
        "matmul (B, 3, 3) @ (B, 3, 3)": (lambda a, b: a @ b, [rand(B, 3, 3), rand(B, 3, 3)]),
        "matmul_ordered (B, 3, 3) @ (B, 3, 3)": (matmul_ordered, [rand(B, 3, 3), rand(B, 3, 3)]),
        "matmul (B, N, 3) @ (B, 3, 3)": (lambda a, r: a @ r, [rand(B, N, 3), rand(B, 3, 3)]),
        "matmul (B, 9, N) @ (B, N, 9) f64": (lambda d: d.transpose(-1, -2) @ d,
                                             [rand(B, N, 9, dtype=torch.float64)]),
        "matmul (B, 512, 3) @ (B, 3, 3)": (lambda a, r: a @ r, [rand(B, 512, 3), rand(B, 3, 3)]),
        "matmul (B, 256, 3) @ (B, 3, 3)": (lambda a, r: a @ r, [rand(B, 256, 3), rand(B, 3, 3)]),
        "solve_essential_5pt (B x 64 trials)":
            (lambda a, b: essential.solve_essential_5pt(a.flatten(0, 1), b.flatten(0, 1))[0]
             .unflatten(0, (a.shape[0], -1)), [0.3 * rand(B, 64, 5, 2), 0.3 * rand(B, 64, 5, 2)]),
        "einsum ti,tj,ijm->tm (B x 512 rows)":
            (lambda a, b, t: torch.einsum("ti,tj,ijm->tm", a.flatten(0, 1), b.flatten(0, 1), t[0])
             .unflatten(0, (a.shape[0], -1)),
             [rand(B, 512, 4), rand(B, 512, 4), rand(1, 4, 4, 10)[0].expand(B, 4, 4, 10)]),
        "matmul (B, 512, 10, 20) @ (B, 512, 20, 1)":
            (lambda a, b: a @ b, [rand(B, 512, 10, 20), rand(B, 512, 20, 1)]),
        "abs_sampson_residuals (B, 1, N, 2) x (B, 640, 3, 3)":
            (lambda x, y, e: essential.abs_sampson_residuals(x[:, None], y[:, None], e),
             [rand(B, N, 2), rand(B, N, 2), rand(B, 640, 3, 3)]),
        "sort (B, N)": (lambda x: torch.sort(x, dim=-1).values, [rand(B, N)]),
        "atan2/sin/cos (B,)": (lambda x: torch.atan2(torch.sin(x), torch.cos(x)), [rand(B)]),
    }
    for name, (fn, xs) in ops.items():
        full = fn(*xs)
        equal = sum(int(torch.equal(full[b], fn(*[x[b:b + 1] for x in xs])[0])) for b in range(B))
        print(json.dumps({"probe": "op", "op": name, "B": B, "slots_equal_at_B1": equal,
                          "card": card}), flush=True)


def main(trees):
    if not torch.cuda.is_available():
        raise RuntimeError("torch_batched_geometry.py runs on a CUDA card")
    for tree in trees:
        path = os.path.abspath(os.path.join(ROOT, tree))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", path], check=True)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--probe", ROOT], check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--worker", "--probe"):
        sys.path.insert(0, sys.argv[2])
        worker(sys.argv[2]) if sys.argv[1] == "--worker" else probe()
    else:
        main(sys.argv[1:] or ["."])
