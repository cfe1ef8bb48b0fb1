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
In a data-parallel run each rank folds its index into the seed
(:meth:`RandomGenerator.fold_rank`, the JAX step's ``fold_in(key,
axis_index)``), so two ranks never drop the same units; rank 0 keeps
the package seed itself.

A run's host draws (shuffles, crops, flips) come from the stream of its
``DataSet.array`` (an ``np.random.RandomState``), so a checkpoint's
random payload, :meth:`RandomGenerator.snapshot`, holds that stream's
state beside every generator's.  While a prefetch producer draws from a
dataset's stream it owns it (:meth:`RandomGenerator.own_stream`, the
counterpart of the JAX ``own_seed_stream``): a draw from any other thread
raises.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


def generator(seed: int) -> torch.Generator:
    """A CPU generator at ``seed``: initialisers draw on the CPU and the
    module moves the result to its device, so one seed gives the same
    weights whatever the device."""
    return torch.Generator().manual_seed(int(seed))


class RandomGenerator:
    """The package seed stream; ``RNG`` below is the process-wide one."""

    def __init__(self, seed: int = 1):
        self._rank = 0
        self.set_seed(seed)

    def set_seed(self, seed: int) -> "RandomGenerator":
        """Restart every device's stream from ``seed`` (folded with the
        rank, :meth:`fold_rank`)."""
        self._seed = int(seed)
        self._gens: dict = {}
        return self

    def get_seed(self) -> int:
        return self._seed

    def fold_rank(self, rank: int) -> "RandomGenerator":
        """Draw as rank ``rank`` of a data-parallel run: the generators
        restart from the seed folded with the rank (rank 0's are the
        package seed's, and stay as they are)."""
        rank = int(rank)
        if rank != self._rank:
            self._rank = rank
            self._gens = {}
        return self

    def _stream_seed(self) -> int:
        if self._rank == 0:
            return self._seed
        # an odd multiplier is a bijection modulo 2**63: distinct ranks,
        # distinct seeds
        return (self._seed ^ (self._rank * 0x9E3779B97F4A7C15)) % 2**63

    def derived_seed(self, *keys) -> int:
        """A seed of its own for each tuple of non-negative ``keys``,
        derived from the stream's (the JAX ``fold_in`` chain, here a
        splitmix64 step a key): a pipeline stage seeds its dropout from
        (step, microbatch, stage), so a schedule that runs a stage twice,
        or in another order, draws the same masks."""
        h = self._stream_seed()
        for k in keys:
            h = (h ^ (int(k) + 0x9E3779B97F4A7C15)) & (2**64 - 1)
            h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
            h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
            h ^= h >> 31
        return h % 2**63

    def generator(self, device) -> torch.Generator:
        """The stream's generator on ``device``, created at the package
        seed on first use."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        g = self._gens.get(dev)
        if g is None:
            g = self._gens[dev] = torch.Generator(device=dev).manual_seed(
                self._stream_seed())
        return g

    # -- checkpoint payload ------------------------------------------------
    def snapshot(self, stream: np.random.RandomState = None) -> dict:
        """The package seed and every generator's state, and, when given,
        the host stream's state (``np_state``, as the JAX payload names
        the state of its host stream)."""
        snap = {"seed": self._seed,
                "generators": {str(dev): g.get_state().numpy().copy()
                               for dev, g in self._gens.items()}}
        if stream is not None:
            snap["np_state"] = stream.get_state()
        return snap

    def restore(self, snap: dict, stream: np.random.RandomState = None):
        """The inverse of :meth:`snapshot`.  A payload of the JAX package
        (no ``generators``) restores the host stream alone: its device
        keys have no counterpart here."""
        if "generators" in snap:
            self.set_seed(snap["seed"])
            for name, state in snap["generators"].items():
                self.generator(name).set_state(
                    torch.from_numpy(np.asarray(state, np.uint8)))
        if stream is not None and snap.get("np_state") is not None:
            st = snap["np_state"]
            stream.set_state((st[0], np.asarray(st[1], np.uint32))
                             + tuple(st[2:]))
        return self

    # -- host streams owned by one thread ----------------------------------
    def own_stream(self, stream: np.random.RandomState):
        """Make the calling thread the only one that may draw from
        ``stream`` until :meth:`release_stream`."""
        with _owners_lock:
            _owners[id(stream)] = threading.get_ident()
        return self

    def release_stream(self, stream: np.random.RandomState):
        with _owners_lock:
            _owners.pop(id(stream), None)
        return self

    def stream_owner(self, stream: np.random.RandomState):
        """The ident of the thread that owns ``stream``, or None."""
        return _owners.get(id(stream))


#: id(stream) -> the ident of the thread that owns it
_owners: dict = {}
_owners_lock = threading.Lock()


def check_stream(stream: np.random.RandomState):
    """Raise unless the calling thread may draw from ``stream`` (no thread
    owns it, or this one does)."""
    owner = _owners.get(id(stream))
    if owner is not None and owner != threading.get_ident():
        raise RuntimeError(
            f"a draw from a host stream that thread {owner} owns: while a "
            f"prefetch producer runs, only it draws from its dataset's "
            f"stream")


RNG = RandomGenerator(seed=1)


def set_seed(seed: int) -> RandomGenerator:
    return RNG.set_seed(seed)
