"""The device an entry point runs on."""

import torch


def resolve_device(device="cuda", what="mavmap_tpu_torch"):
    """torch.device(device). The port's entry points run on the CUDA card
    unless the caller names another device; a CUDA device where there is
    no card raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (pass device='cpu' to run on the CPU)")
    return device
