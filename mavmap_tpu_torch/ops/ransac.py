"""Batched RANSAC harness — all hypotheses solved and scored at once.

Port of mavmap_tpu/ops/ransac.py (reference src/util/estimation.{h,cc}): a
fixed trial count T where every minimal solve, every residual and the
best-model selection are one batched computation:

    sample  -> (T, S) indices via per-trial top-S of masked uniforms
    solve   -> batched over trials, each yielding M candidate models + mask
    score   -> residual matrix (T*M, N) in one shot, threshold, count
    select  -> argmax over (num_inliers, -inlier_residual_sum) lexicographic

`ransac` also takes leading slot dims on its points, masks, thresholds and
samples (the JAX package vmaps it): the slots' trials go through the
minimal solver as one batch and are scored per slot.

Randomness comes from an explicit torch.Generator. Its numbers differ from
jax.random's, so `ransac` also accepts the (T, S) sample indices directly.

An estimator is a pair of functions, both batched over leading axes:
  solve_fn(sx (T, S, dx), sy (T, S, dy)) -> (models (T, M, ...), mask (T, M))
  residual_fn(x (..., 1, N, dx), y (..., 1, N, dy), models (..., K, ...))
      -> (..., K, N) residuals
"""

from typing import Callable, NamedTuple

import torch


class RansacResult(NamedTuple):
    model: torch.Tensor          # best model parameters
    inlier_mask: torch.Tensor    # (N,) bool
    num_inliers: torch.Tensor    # scalar int32
    success: torch.Tensor        # scalar bool
    best_trial: torch.Tensor     # scalar (flat trial*M + candidate index)
    residuals: torch.Tensor      # (N,) residuals of the best model


def _top_valid(u, sample_size, valid_mask=None):
    """Per trial, the indices of the sample_size largest uniforms among the
    valid entries (invalid ones at -inf)."""
    if valid_mask is not None:
        u = torch.where(valid_mask[None, :], u, torch.full_like(u, -float("inf")))
    return torch.topk(u, sample_size, dim=1).indices


def sample_indices(generator, num_trials, sample_size, num_points,
                   valid_mask=None, device=None):
    """(T, S) indices sampled without replacement per trial, valid-only:
    per-trial top-S of iid uniforms with invalid entries at -inf."""
    u = torch.rand((num_trials, num_points), generator=generator, device=device)
    return _top_valid(u, sample_size, valid_mask)


def draw_samples(generator, draws, block=None):
    """Sample indices of a batch of slots' RANSAC runs. draws: one
    (num_trials, sample_size, valid_mask (B, N)) per run of a slot; returns
    one (B, T, S) tensor per run. The draws go slot by slot and, within a
    slot, in the order of `draws`: the order in which the single-slot step
    draws, so slot b draws what that step draws from a generator seeded
    alike.

    block=(lo, n): the B slots are slots lo .. lo + B - 1 of a step of n
    slots sharded over ranks (parallel/dist_register.py). The generator
    then draws the uniforms of all n slots in slot order, as the unsharded
    step does, and keeps this block's: every rank's generator advances as
    one rank's would. A uniform does not depend on the valid mask, which
    only this block's slots need."""
    B = draws[0][2].shape[0]
    lo, n = (0, B) if block is None else block
    out = [[] for _ in draws]
    for b in range(n):
        for k, (trials, size, valid) in enumerate(draws):
            u = torch.rand((trials, valid.shape[-1]), generator=generator, device=valid.device)
            if lo <= b < lo + B:
                out[k].append(_top_valid(u, size, valid[b - lo]))
    return [torch.stack(o) if o else
            torch.zeros((0, trials, size), dtype=torch.int64, device=valid.device)
            for o, (trials, size, valid) in zip(out, draws)]


def ransac(generator, x, y, solve_fn: Callable, residual_fn: Callable,
           sample_size: int, num_trials: int, threshold, min_inliers: int = 0,
           valid_mask=None, samples=None):
    """Run batched RANSAC.

    x: (..., N, dx); y: (..., N, dy); threshold: float or tensor of the
    leading shape, in residual_fn's units; valid_mask: optional (..., N)
    bool of real rows; samples: optional (..., T, S) int sample indices used
    instead of drawing from `generator` (required with leading dims: see
    `draw_samples`). The results carry the leading dims.
    """
    lead, N = x.shape[:-2], x.shape[-2]
    if samples is None:
        if lead:
            raise ValueError("ransac: slots need their samples drawn (draw_samples)")
        idx = sample_indices(generator, num_trials, sample_size, N, valid_mask,
                             device=x.device)
    else:
        idx = torch.as_tensor(samples, device=x.device).long()
    xb = x.reshape((-1,) + tuple(x.shape[-2:]))
    yb = y.reshape((-1,) + tuple(y.shape[-2:]))
    idx = idx.reshape((xb.shape[0],) + tuple(idx.shape[-2:]))
    B, T = idx.shape[:2]
    slot = torch.arange(B, device=x.device)[:, None, None]
    sx, sy = xb[slot, idx], yb[slot, idx]  # (B, T, S, d)
    models, model_mask = solve_fn(sx.reshape((B * T,) + tuple(sx.shape[2:])),
                                  sy.reshape((B * T,) + tuple(sy.shape[2:])))
    M = model_mask.shape[1]
    flat_models = models.reshape((B, T * M) + tuple(models.shape[2:]))
    flat_mask = model_mask.reshape(B, T * M)

    res = residual_fn(xb[:, None], yb[:, None], flat_models)  # (B, T*M, N)
    res = torch.nan_to_num(res, nan=float("inf"), posinf=float("inf"),
                           neginf=float("inf"))

    thr = torch.as_tensor(threshold, dtype=res.dtype, device=x.device).reshape(-1, 1)
    thr = thr.expand(B, 1)
    point_valid = torch.ones((B, N), dtype=torch.bool, device=x.device) \
        if valid_mask is None else valid_mask.reshape(B, N)
    inlier = (res <= thr[..., None]) & point_valid[:, None, :] & flat_mask[..., None]
    num_in = torch.sum(inlier, dim=-1)
    # Lexicographic (num_inliers desc, inlier residual sum asc) — the
    # reference's best-model rule (estimation.cc:120-128).
    res_sum = torch.sum(torch.where(inlier, res, torch.zeros_like(res)), dim=-1)
    norm_sum = res_sum / torch.clamp(num_in, min=1) / torch.clamp(thr, min=1e-20)
    score = num_in.float() - torch.clamp(norm_sum, 0.0, 0.999)
    score = torch.where(flat_mask, score, torch.full_like(score, -float("inf")))

    best = torch.argmax(score, dim=-1)  # (B,)
    rows = torch.arange(B, device=x.device)
    best_num = num_in[rows, best]
    ok = flat_mask[rows, best] & (best_num >= max(min_inliers, sample_size))

    def out(t):
        return t.reshape(tuple(lead) + tuple(t.shape[1:]))

    return RansacResult(
        model=out(flat_models[rows, best]),
        inlier_mask=out(inlier[rows, best]),
        num_inliers=out(best_num.to(torch.int32)),
        success=out(ok),
        best_trial=out(best),
        residuals=out(res[rows, best]),
    )
