"""Convert state of the JAX package (as numpy arrays) into this package's.

Inputs are duck-typed: anything with the right attributes or shape, read
with numpy, so nothing here imports jax or mavmap_tpu.
"""

import numpy as np
import torch

from .ba.core import BAProblem
from .ops.cuda.ba_accum import offsets_from_sorted_ids


def problem_from_jax(prob) -> BAProblem:
    """A host BAProblem of the JAX package (`build_problem(host=True)`)
    -> this package's host BAProblem.

    The JAX problem's pair fields and by-image sort are dropped; the CSR
    offsets of the dense point ids are rebuilt from `obs_point_dense` over
    the real (masked-in) observations, which come first."""
    a = {k: np.asarray(getattr(prob, k)) for k in (
        "poses", "points", "cam_params", "cam_models", "obs_image", "obs_point",
        "obs_cam", "obs_uv", "obs_mask", "pose_free", "point_free", "rot_prior",
        "rot_prior_weight", "obs_point_dense", "point_rows", "point_free_dense")}
    n_real = int(a["obs_mask"].sum())
    Pd = len(a["point_rows"])
    return BAProblem(
        poses=a["poses"].astype(np.float32),
        points=a["points"].astype(np.float32),
        cam_params=a["cam_params"].astype(np.float32),
        cam_models=a["cam_models"].astype(np.int32),
        obs_image=a["obs_image"].astype(np.int32),
        obs_point=a["obs_point"].astype(np.int32),
        obs_cam=a["obs_cam"].astype(np.int32),
        obs_uv=a["obs_uv"].astype(np.float32),
        obs_mask=a["obs_mask"].astype(bool),
        pose_free=a["pose_free"].astype(np.float32),
        point_free=a["point_free"].astype(np.float32),
        rot_prior=a["rot_prior"].astype(np.float32),
        rot_prior_weight=a["rot_prior_weight"].astype(np.float32),
        obs_point_dense=a["obs_point_dense"].astype(np.int32),
        point_rows=a["point_rows"].astype(np.int32),
        point_free_dense=a["point_free_dense"].astype(np.float32),
        pt_offsets=offsets_from_sorted_ids(a["obs_point_dense"], Pd, num_rows=n_real),
    )


def features_to_device(features, device):
    """A Features-like (keypoints, descriptors, mask) -> tensors on device."""
    return tuple(torch.as_tensor(np.asarray(x), device=device) for x in (
        features.keypoints, features.descriptors, features.mask))


def cameras_to_device(cam_params, cam_models, device):
    """Padded camera arrays (C, 9) / (C,) -> float32 / int32 tensors."""
    return (torch.as_tensor(np.asarray(cam_params, np.float32), device=device),
            torch.as_tensor(np.asarray(cam_models, np.int32), device=device))
