"""Recurrence (counterpart of bigdl_tpu/nn/recurrent.py; ref
Recurrent.scala:27, TimeDistributed.scala).

``Recurrent().add(LSTMCell(...))`` maps batch-first (N, T, D) to
(N, T, H); ``BiRecurrent`` runs a forward and a reverse ``Recurrent``
over the same input and merges them.  The time loop is the hand-written
recurrence kernel (``ops.bilstm_recurrence``) over the input projection,
which is hoisted out of the loop as one large product: a single
direction is the kernel's D = 1 case, and a ``BiRecurrent`` of two equal
``LSTMCell``s without truncation runs both directions in one D = 2 call.
The JAX package's ``lax.scan`` route exists for backends without its
kernels and is not ported, so cells other than ``LSTMCell`` and
truncated BPTT inside the sequence raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.ops import bilstm_recurrence

_LATER = ("is not ported yet: it comes with the {} kernel in the next part "
          "of the recurrence slice (ROADMAP, slice 5)")


class Cell(Module):
    """A recurrent cell: its parameters and ``hidden_size``; the time loop
    is ``Recurrent``'s."""

    hidden_size: int


class LSTMCell(Cell):
    """Standard LSTM cell with ``w`` (4H, D+H) over [x, h] and ``bias``
    (4H), both U(-1/sqrt(H), 1/sqrt(H)); gates i, f, g, o.  On the card
    the recurrence kernels take H up to ``ops.bilstm.MAX_HIDDEN`` (558):
    a larger H raises ``NotImplementedError`` at the first forward."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        stdv = 1.0 / math.sqrt(hidden_size)
        h, d = hidden_size, input_size
        self._add_param("w", init_.uniform((4 * h, d + h), -stdv, stdv,
                                           generator), device)
        self._add_param("bias", init_.uniform((4 * h,), -stdv, stdv,
                                              generator), device)


class RnnCell(Cell):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("RnnCell "
                                  + _LATER.format("rnn_recurrence"))


class GRUCell(Cell):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("GRUCell "
                                  + _LATER.format("gru_recurrence"))


def _split(cell: LSTMCell):
    """(input weight (D, 4H), recurrent weight (H, 4H)) of ``cell``."""
    d = cell.input_size
    return cell.w[:, :d].t(), cell.w[:, d:].t()


class Recurrent(Container):
    """Time-loop container (ref Recurrent.scala:27): ``Recurrent().add(
    cell)`` maps (N, T, D) to (N, T, H); ``reverse=True`` runs right to
    left.  ``bptt_truncate`` of 0 or at least T is the full backward
    through time; a truncation inside the sequence is not ported."""

    def __init__(self, bptt_truncate: int = 0, reverse: bool = False):
        super().__init__()
        self.bptt_truncate = int(bptt_truncate)
        self.reverse = reverse

    @property
    def cell(self) -> Cell:
        return self.get(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cell = self.cell
        if type(cell) is not LSTMCell:
            # exact type, as the JAX kernel route: a subclass's own step
            # would be bypassed by the kernel
            raise NotImplementedError(
                f"Recurrent({type(cell).__name__}): only LSTMCell runs in "
                f"this port")
        if 0 < self.bptt_truncate < x.shape[1]:
            raise NotImplementedError(
                f"Recurrent: truncated BPTT inside the sequence "
                f"(bptt_truncate={self.bptt_truncate} < T={x.shape[1]}) is "
                f"not ported yet: it comes with the kernels' chunked runs "
                f"in the next part of the recurrence slice (ROADMAP, slice "
                f"5)")
        wx, wh = _split(cell)
        xs = x.transpose(0, 1)                          # (T, N, D)
        if self.reverse:
            xs = xs.flip(0)
        zx = torch.matmul(xs, wx) + cell.bias           # (T, N, 4H)
        outs = bilstm_recurrence(zx[:, None], wh[None].contiguous())[:, 0]
        if self.reverse:
            outs = outs.flip(0)
        return outs.transpose(0, 1)


class BiRecurrent(Container):
    """A forward and a reverse ``Recurrent`` over the same input, merged
    by ``merge``: "concat" on the feature dim, anything else adds."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Cell, merge: str = "concat",
                 bptt_truncate: int = 0):
        super().__init__()
        self.merge = merge
        self.add(Recurrent(bptt_truncate).add(cell_fwd))
        self.add(Recurrent(bptt_truncate, reverse=True).add(cell_bwd))

    def _fused_lstm_eligible(self) -> bool:
        """Both children hold exactly ``LSTMCell``s of equal sizes and no
        truncation: both directions go through one D = 2 kernel call."""
        cf, cb = self.get(1).cell, self.get(2).cell
        return (type(cf) is LSTMCell and type(cb) is LSTMCell
                and cf.input_size == cb.input_size
                and cf.hidden_size == cb.hidden_size
                and self.get(1).bptt_truncate <= 0
                and self.get(2).bptt_truncate <= 0)

    def _merge(self, yf, yb):
        return torch.cat([yf, yb], dim=-1) if self.merge == "concat" \
            else yf + yb

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._fused_lstm_eligible():
            return self._merge(self.get(1)(x), self.get(2)(x))
        cf, cb = self.get(1).cell, self.get(2).cell
        (wxf, whf), (wxb, whb) = _split(cf), _split(cb)
        xs = x.transpose(0, 1)                          # (T, N, D)
        # the input projection of every step, both directions, the
        # backward one over the flipped sequence
        zx = torch.stack([torch.matmul(xs, wxf) + cf.bias,
                          torch.matmul(xs.flip(0), wxb) + cb.bias], dim=1)
        outs = bilstm_recurrence(zx, torch.stack([whf, whb]))  # (T, 2, N, H)
        return self._merge(outs[:, 0].transpose(0, 1),
                           outs[:, 1].flip(0).transpose(0, 1))


class TimeDistributed(Container):
    """Apply a module at every timestep of (N, T, ...) by folding T into
    the batch: one (N*T, ...) call instead of T small ones."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t = x.shape[0], x.shape[1]
        y = self.get(1)(x.reshape((n * t,) + tuple(x.shape[2:])))
        return y.reshape((n, t) + tuple(y.shape[1:]))
