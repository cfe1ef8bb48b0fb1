"""Seeded initialisation streams (counterpart of bigdl_tpu/utils/random.py).

The JAX package draws every initial weight from one global numpy stream.
Here each layer takes an explicit ``torch.Generator``; ``None`` means
PyTorch's own default generator (``torch.manual_seed``).  The two
packages give different numbers from the same seed — tests carry weights
across with ``nn.module.load_jax_params`` instead.
"""
from __future__ import annotations

import torch


def generator(seed: int) -> torch.Generator:
    """A CPU generator at ``seed``: initialisers draw on the CPU and the
    module moves the result to its device, so one seed gives the same
    weights whatever the device."""
    return torch.Generator().manual_seed(int(seed))

