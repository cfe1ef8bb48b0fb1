"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU; a
missing card is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def pin_fp32(dev: torch.device) -> None:
    """Full fp32 matmuls and convolutions on the card (the JAX package's
    tests run at "highest" matmul precision): TF32 would keep about three
    decimal digits."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
