"""Seeded random streams (counterpart of bigdl_tpu/utils/random.py).

The JAX package draws every initial weight from one global numpy stream.
Here each layer takes an explicit ``torch.Generator`` (:func:`generator`);
``None`` means PyTorch's own default generator (``torch.manual_seed``).
The two packages give different numbers from the same seed — tests carry
weights across with ``nn.module.load_jax_params`` instead.

Randomness drawn while a model runs (dropout masks) comes from the
package stream ``RNG``, as the JAX package draws it from its ``RNG``
key stream: ``RNG.set_seed(s)`` (or :func:`set_seed`) gives one
trajectory per seed, and PyTorch's global generator plays no part.
``RNG`` holds one ``torch.Generator`` per device, each seeded from the
package seed when first asked for, so a run on the card and a run on the
CPU are each reproducible (their masks differ: the generators do).
"""
from __future__ import annotations

import torch


def generator(seed: int) -> torch.Generator:
    """A CPU generator at ``seed``: initialisers draw on the CPU and the
    module moves the result to its device, so one seed gives the same
    weights whatever the device."""
    return torch.Generator().manual_seed(int(seed))


class RandomGenerator:
    """The package seed stream; ``RNG`` below is the process-wide one."""

    def __init__(self, seed: int = 1):
        self.set_seed(seed)

    def set_seed(self, seed: int) -> "RandomGenerator":
        """Restart every device's stream from ``seed``."""
        self._seed = int(seed)
        self._gens: dict = {}
        return self

    def get_seed(self) -> int:
        return self._seed

    def generator(self, device) -> torch.Generator:
        """The stream's generator on ``device``, created at the package
        seed on first use."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        g = self._gens.get(dev)
        if g is None:
            g = self._gens[dev] = torch.Generator(device=dev).manual_seed(
                self._seed)
        return g


RNG = RandomGenerator(seed=1)


def set_seed(seed: int) -> RandomGenerator:
    return RNG.set_seed(seed)
