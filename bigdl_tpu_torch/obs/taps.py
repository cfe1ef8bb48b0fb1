"""Training-health taps computed by the train step itself (counterpart of
bigdl_tpu/obs/taps.py).

The reference surfaces loss and wall-clock only; a gradient explosion or
a saturating update shows up steps later, or never.  The taps — the
gradient's global norm, the parameters' norm, the update / parameter
ratio and the count of non-finite gradient elements — come out of the
same step as its loss:

- on the SGD path they are sums the update kernel accumulates while it
  holds p, g and p' in registers (``ops.fused_sgd(..., taps=)``: the
  kernel's taps form), so they cost no pass of their own; another
  OptimMethod takes :func:`sums`, a plain pass over the leaves and a
  pre-step copy of the parameters kept only while taps are on;
- they stay on the device as four sums (:data:`SUMS`) until the host
  reads them, with the loss, in the loop's cadence window: between
  cadence boundaries they add no host sync.

Gating: ``BIGDL_OBS_TAPS`` (default on), cadence
``BIGDL_OBS_TAPS_CADENCE`` (default 10); ``LocalOptimizer.set_taps``
overrides both for a run.
"""
from __future__ import annotations

import math
import os
from collections import deque

import numpy as np
import torch

ENV_TAPS = "BIGDL_OBS_TAPS"
ENV_CADENCE = "BIGDL_OBS_TAPS_CADENCE"

#: keys of the dict ``compute`` returns, in a fixed order so event
#: consumers and the report tool can rely on the names
TAP_NAMES = ("grad_norm", "param_norm", "update_ratio", "nonfinite_grads")

#: the four sums a step's taps are kept as on the device, in this order
#: (float64): sum g^2, sum p^2, sum (p' - p)^2, count of non-finite g
SUMS = ("g2", "p2", "d2", "bad")


def enabled(override: bool | None = None) -> bool:
    if override is not None:
        return bool(override)
    return os.environ.get(ENV_TAPS, "1") != "0"


def cadence(override: int | None = None) -> int:
    if override is not None:
        return max(1, int(override))
    return max(1, int(os.environ.get(ENV_CADENCE, "10")))


def new_sums(device) -> torch.Tensor:
    """A zeroed (4,) float64 buffer the step's taps accumulate into."""
    return torch.zeros(len(SUMS), dtype=torch.float64, device=device)


def leaf_sums(g, p, p_new) -> torch.Tensor:
    """One leaf's four sums (float64, on the leaf's device): each
    reduction in float32, as the JAX taps (bf16 squares overflow near
    256)."""
    with torch.no_grad():
        gf, pf = g.float(), p.float()
        return torch.stack([gf.square().sum(), pf.square().sum(),
                            (p_new.float() - pf).square().sum(),
                            (~torch.isfinite(gf)).sum().float()]).double()


def sums(grads, params, new_params, out: torch.Tensor | None = None):
    """The plain version: the four sums over lists of leaves, each leaf's
    in float32 and the leaves' added in float64.  ``new_params`` are the
    values after the step's skip (equal to ``params`` on a skipped step,
    so the update ratio reads 0).  Adds into ``out`` when given."""
    if out is None:
        out = new_sums(grads[0].device if len(grads) else "cpu")
    for g, p, q in zip(grads, params, new_params):
        out += leaf_sums(g, p, q).to(out.device)
    return out


def finish(s) -> dict:
    """The tap dict from one step's four sums (a tensor or an array of
    4, or of (n, 4) for a chunk: its last step), as floats."""
    s = np.asarray(s.detach().cpu() if isinstance(s, torch.Tensor) else s,
                   np.float64).reshape(-1, len(SUMS))[-1]
    pnorm = math.sqrt(s[1])
    # the keys in sorted order, as the JAX step's dict comes out
    return {"grad_norm": float(math.sqrt(s[0])),
            "nonfinite_grads": float(s[3]),
            "param_norm": float(pnorm),
            "update_ratio": float(math.sqrt(s[2]) / (pnorm + 1e-12))}


def compute(grads, params, new_params) -> dict:
    """The tap dict on the device (0-d float32 tensors under
    :data:`TAP_NAMES`), the JAX ``compute``'s values."""
    s = sums(grads, params, new_params)
    pnorm = s[1].sqrt()
    return {"grad_norm": s[0].sqrt().float(),
            "param_norm": pnorm.float(),
            "update_ratio": (s[2].sqrt() / (pnorm + 1e-12)).float(),
            "nonfinite_grads": s[3].float()}


class TapsMonitor:
    """Host-side cadence gate for the step's taps.

    ``push(step, taps)`` keeps the latest value (the four sums of
    :data:`SUMS`, (4,) or (n, 4) for a chunk) and turns it into the tap
    dict of floats only once at least ``cadence`` iterations have passed
    since the previous materialization; ``flush()`` materializes a
    pending tail (end of run, so a 4-step run with cadence 10 still logs
    one sample).  ``materialized_steps`` is the audit trail: taps become
    host values at cadence boundaries, nowhere else.

    The gate is elapsed iterations, not ``step % cadence == 0``: under
    ``iters_per_dispatch = n`` the pushed step numbers advance by n, and
    for most (n, cadence) pairs an exact-multiple test would never fire
    (neval 1, 9, 17, ... never lands on a multiple of 10).
    """

    def __init__(self, cadence_override: int | None = None,
                 enabled_override: bool | None = None):
        self.enabled = enabled(enabled_override)
        self.cadence = cadence(cadence_override)
        # bounded: the durable record is the event stream, this is the
        # live window
        self.history = deque(maxlen=1024)  # (step, {name: float})
        self.materialized_steps = deque(maxlen=1024)
        self._pending = None
        self._last_materialized = 0

    def push(self, step: int, taps) -> dict | None:
        """The materialized {name: float} dict at cadence boundaries,
        None otherwise (and when taps are off)."""
        if taps is None:
            return None
        self._pending = (int(step), taps)
        if step - self._last_materialized >= self.cadence:
            return self._materialize()
        return None

    def flush(self) -> dict | None:
        if self._pending is None:
            return None
        return self._materialize()

    def _materialize(self) -> dict:
        step, taps = self._pending
        self._pending = None
        self._last_materialized = step
        # a chunk's (n, 4): its LAST step, as state['loss']
        vals = finish(taps)
        self.materialized_steps.append(step)
        self.history.append((step, vals))
        return vals

    def last(self) -> dict | None:
        return self.history[-1][1] if self.history else None
