"""Batched RANSAC harness — all hypotheses solved and scored at once.

Port of mavmap_tpu/ops/ransac.py (reference src/util/estimation.{h,cc}): a
fixed trial count T where every minimal solve, every residual and the
best-model selection are one batched computation:

    sample  -> (T, S) indices via per-trial top-S of masked uniforms
    solve   -> batched over trials, each yielding M candidate models + mask
    score   -> residual matrix (T*M, N) in one shot, threshold, count
    select  -> argmax over (num_inliers, -inlier_residual_sum) lexicographic

Randomness comes from an explicit torch.Generator. Its numbers differ from
jax.random's, so `ransac` also accepts the (T, S) sample indices directly.

An estimator is a pair of functions, both batched over a leading trial axis:
  solve_fn(sx (T, S, dx), sy (T, S, dy)) -> (models (T, M, ...), mask (T, M))
  residual_fn(x (N, dx), y (N, dy), models (B, ...)) -> (B, N) residuals
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


def sample_indices(generator, num_trials, sample_size, num_points,
                   valid_mask=None, device=None):
    """(T, S) indices sampled without replacement per trial, valid-only:
    per-trial top-S of iid uniforms with invalid entries at -inf."""
    u = torch.rand((num_trials, num_points), generator=generator, device=device)
    if valid_mask is not None:
        u = torch.where(valid_mask[None, :], u, torch.full_like(u, -float("inf")))
    return torch.topk(u, sample_size, dim=1).indices


def ransac(generator, x, y, solve_fn: Callable, residual_fn: Callable,
           sample_size: int, num_trials: int, threshold, min_inliers: int = 0,
           valid_mask=None, samples=None):
    """Run batched RANSAC.

    x: (N, dx); y: (N, dy); threshold: scalar in residual_fn's units;
    valid_mask: optional (N,) bool of real rows; samples: optional (T, S)
    int sample indices used instead of drawing from `generator`.
    """
    N = x.shape[0]
    if samples is None:
        idx = sample_indices(generator, num_trials, sample_size, N, valid_mask,
                             device=x.device)
    else:
        idx = torch.as_tensor(samples, device=x.device).long()
        num_trials = idx.shape[0]
    models, model_mask = solve_fn(x[idx], y[idx])  # (T, M, ...), (T, M)
    M = model_mask.shape[1]
    flat_models = models.reshape((num_trials * M,) + tuple(models.shape[2:]))
    flat_mask = model_mask.reshape(num_trials * M)

    res = residual_fn(x, y, flat_models)  # (T*M, N)
    res = torch.nan_to_num(res, nan=float("inf"), posinf=float("inf"),
                           neginf=float("inf"))

    point_valid = torch.ones(N, dtype=torch.bool, device=x.device) \
        if valid_mask is None else valid_mask
    inlier = (res <= threshold) & point_valid[None, :] & flat_mask[:, None]
    num_in = torch.sum(inlier, dim=1)
    # Lexicographic (num_inliers desc, inlier residual sum asc) — the
    # reference's best-model rule (estimation.cc:120-128).
    res_sum = torch.sum(torch.where(inlier, res, torch.zeros_like(res)), dim=1)
    norm_sum = res_sum / torch.clamp(num_in, min=1) / max(float(threshold), 1e-20)
    score = num_in.float() - torch.clamp(norm_sum, 0.0, 0.999)
    score = torch.where(flat_mask, score, torch.full_like(score, -float("inf")))

    best = torch.argmax(score)
    best_num = num_in[best]
    ok = flat_mask[best] & (best_num >= max(min_inliers, sample_size))
    return RansacResult(
        model=flat_models[best],
        inlier_mask=inlier[best],
        num_inliers=best_num.to(torch.int32),
        success=ok,
        best_trial=best,
        residuals=res[best],
    )
