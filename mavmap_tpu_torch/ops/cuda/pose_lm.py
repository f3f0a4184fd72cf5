"""The robust pose LM in one launch: CUDA kernel K4 (csrc/pose_lm.cu) and
its wrapper.

  pose_lm — the registration step's pose refinement over a slot axis, every
            LM iteration of every slot in one launch: one block per slot,
            which leaves the loop when its slot stops. It replaces no TPU
            kernel (the JAX package leaves the loop to XLA); on the card it
            takes the place of ba.core._pose_refine_plain, which dispatches
            a few hundred small launches per iteration from the host.

ba.core._pose_refine_loop calls it for CUDA tensors and runs the plain
version for CPU tensors. On an H100 neither bytes nor operations bound it:
a chain of block-wide reductions and one 6x6 solve per iteration does.
"""

import torch

from ...models import camera as cam
from . import build


def pose_lm(pose, points, uv, mask, kparams, model_codes, scale, max_iters, code_ids=None):
    """K4: _pose_refine_plain's robust pose LM on the card. pose (B, 6),
    points (B, N, 3), uv (B, N, 2), kparams (B, 9) float32, mask (B, N)
    bool, all contiguous on one CUDA device; model_codes: the B slots'
    camera codes on the host. Where they mix models, code_ids (B,) int32
    holds the same codes on the device (the host list is not uploaded: that
    would be a blocking copy). Returns (poses (B, 6), costs (B,),
    iterations run (B,) int32); launches on the current stream and never
    waits for the device."""
    dev = pose.device
    f32 = torch.float32
    build.require(pose, "pose", f32, 2, dev)
    build.require(points, "points", f32, 3, dev)
    build.require(uv, "uv", f32, 3, dev)
    build.require(mask, "mask", torch.bool, 2, dev)
    build.require(kparams, "kparams", f32, 2, dev)
    B, N = points.shape[:2]
    for name, t, shape in (("pose", pose, (B, 6)), ("points", points, (B, N, 3)),
                           ("uv", uv, (B, N, 2)), ("mask", mask, (B, N)),
                           ("kparams", kparams, (B, cam.MAX_CAM_PARAMS))):
        if tuple(t.shape) != shape:
            raise ValueError(f"pose_lm: {name} of shape {tuple(t.shape)}, expected {shape}")
    codes = [int(c) for c in model_codes]
    if len(codes) != B:
        raise ValueError(f"pose_lm: {len(codes)} camera codes for {B} slots")
    unknown = sorted(set(codes) - set(cam.CAMERA_MODEL_NAMES))
    if unknown:
        raise ValueError(f"pose_lm: unknown camera model codes {unknown}")
    mixed = len(set(codes)) > 1
    if mixed:
        if code_ids is None:
            raise ValueError("pose_lm: slots of several camera models need their codes on "
                             "the device (code_ids)")
        build.require(code_ids, "code_ids", torch.int32, 1, dev)
        if code_ids.shape[0] != B:
            raise ValueError(f"pose_lm: {code_ids.shape[0]} code_ids for {B} slots")
    out = torch.empty((B, 6), dtype=f32, device=dev)
    cost = torch.empty((B,), dtype=f32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out, cost, iters
    build.check(build.library().mavmap_pose_lm(
        pose.data_ptr(), points.data_ptr(), uv.data_ptr(), mask.data_ptr(),
        kparams.data_ptr(), code_ids.data_ptr() if mixed else None,
        codes[0], B, N, float(scale) * float(scale), int(max_iters), out.data_ptr(),
        cost.data_ptr(), iters.data_ptr(), build.stream_ptr(dev)), "mavmap_pose_lm")
    build.launches["pose_lm"] += 1
    return out, cost, iters
