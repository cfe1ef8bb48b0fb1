"""Recurrence (counterpart of bigdl_tpu/nn/recurrent.py; ref
Recurrent.scala:27, RNN.scala:28, TimeDistributed.scala).

``Recurrent().add(cell)`` maps batch-first (N, T, D) to (N, T, H);
``BiRecurrent`` runs a forward and a reverse ``Recurrent`` over the same
input and merges them.  The time loop is a hand-written recurrence
kernel over the input projection, which is hoisted out of the loop as
one large product: ``ops.bilstm_recurrence`` for ``LSTMCell``,
``ops.gru_recurrence`` for ``GRUCell`` and ``ops.rnn_recurrence`` for
``RnnCell`` with its default ``Tanh``, each a kernel's D = 1 case; a
``BiRecurrent`` of two equal ``LSTMCell``s or two equal ``GRUCell``s
without truncation runs both directions in one D = 2 call.

A ``Recurrent(LSTMCell)`` forward that takes no gradient (grad mode off,
or neither the projection nor the recurrent weight requires grad:
validation and inference) runs ``ops.lstm_scan`` from zero state instead,
the forward-only kernel the JAX package wrote for it; so do the reverse
direction and the two children of a ``BiRecurrent`` that cannot share a
call.  A forward that takes a gradient keeps ``bilstm_recurrence`` at
D = 1, and the fused D = 2 call is the same with or without one.

Truncated BPTT (``bptt_truncate`` of k, 0 < k < T) runs for ``RnnCell``:
chunks of k steps, each one kernel call from the previous chunk's last h,
detached, which is the JAX package's chunked ``lax.scan`` with the carry
stop-gradiented at chunk boundaries (a forward that needs no gradient
takes the whole sequence in one call: the same function).  The JAX
package's ``lax.scan`` route for other cells is not ported, so
``LSTMCell``/``GRUCell`` truncation inside the sequence and an
``RnnCell`` with another activation raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.activations import Tanh
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.ops import (bilstm_recurrence, gru_recurrence,
                                 lstm_scan, rnn_recurrence)

_TRUNCATION = ("truncated BPTT inside the sequence (bptt_truncate={} < "
               "T={}) of {} is not ported yet: the kernels' chunked runs "
               "from a carried state come in ROADMAP slice 5, next item 2")


class Cell(Module):
    """A recurrent cell: its parameters and ``hidden_size``; the time loop
    is ``Recurrent``'s."""

    hidden_size: int

    def _uniform(self, shapes, device, generator):
        """Each (name, shape) parameter U(-1/sqrt(H), 1/sqrt(H)), drawn in
        order, as the JAX cells draw them."""
        stdv = 1.0 / math.sqrt(self.hidden_size)
        for name, shape in shapes:
            self._add_param(name, init_.uniform(shape, -stdv, stdv,
                                                generator), device)


class LSTMCell(Cell):
    """Standard LSTM cell with ``w`` (4H, D+H) over [x, h] and ``bias``
    (4H), both U(-1/sqrt(H), 1/sqrt(H)); gates i, f, g, o.  On the card
    the recurrence kernels take H up to ``ops.bilstm.MAX_HIDDEN`` (6,197):
    a larger H raises ``NotImplementedError`` at the first forward."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        h, d = hidden_size, input_size
        self._uniform((("w", (4 * h, d + h)), ("bias", (4 * h,))), device,
                      generator)


class RnnCell(Cell):
    """Vanilla RNN: h' = act(W_i x + b_i + W_h h + b_h) (ref RNN.scala:28),
    with ``i2h`` (H, D), ``h2h`` (H, H), ``bias_i`` and ``bias_h`` (H),
    each U(-1/sqrt(H), 1/sqrt(H)).  ``activation`` defaults to ``Tanh``,
    the one the kernel runs; it is a setting of the cell, not a child
    module (the JAX parameter tree has no entry for it).  On the card H
    goes up to ``ops.rnn.MAX_HIDDEN``."""

    def __init__(self, input_size: int, hidden_size: int, activation=None,
                 device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        object.__setattr__(self, "activation",
                           activation if activation is not None else Tanh())
        h, d = hidden_size, input_size
        self._uniform((("i2h", (h, d)), ("h2h", (h, h)), ("bias_i", (h,)),
                       ("bias_h", (h,))), device, generator)


class GRUCell(Cell):
    """GRU cell with ``w_rz`` (2H, D+H) and ``b_rz`` (2H) for the r and z
    gates over [x, h], ``w_h`` (H, D+H) and ``b_h`` (H) for the candidate
    over [x, r o h], each U(-1/sqrt(H), 1/sqrt(H)).  On the card H goes
    up to ``ops.gru.MAX_HIDDEN``."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        h, d = hidden_size, input_size
        self._uniform((("w_rz", (2 * h, d + h)), ("b_rz", (2 * h,)),
                       ("w_h", (h, d + h)), ("b_h", (h,))), device,
                      generator)


def _recurrent_t(w, d):
    """The recurrent half of a [x, h] weight (J, D+H) as (H, J)."""
    return w[:, d:].t()


def _lstm_inputs(cell: LSTMCell, xs):
    """((zx (T, N, 4H),), (wht (H, 4H),)) of one direction."""
    d = cell.input_size
    return ((torch.matmul(xs, cell.w[:, :d].t()) + cell.bias,),
            (_recurrent_t(cell.w, d),))


def _gru_inputs(cell: GRUCell, xs):
    """((zrz (T, N, 2H), zn (T, N, H)), (wrz (H, 2H), wh (H, H))) of one
    direction."""
    d = cell.input_size
    return ((torch.matmul(xs, cell.w_rz[:, :d].t()) + cell.b_rz,
             torch.matmul(xs, cell.w_h[:, :d].t()) + cell.b_h),
            (_recurrent_t(cell.w_rz, d), _recurrent_t(cell.w_h, d)))


def _kernel_of(kind):
    """(input builder, recurrence kernel) of an LSTM or GRU cell type."""
    if kind is LSTMCell:
        return _lstm_inputs, bilstm_recurrence
    return _gru_inputs, gru_recurrence


def _takes_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _one_direction(cell, xs):
    """The h stack (T, N, H) of an LSTM or GRU cell: the kernel's D = 1
    case, or for an LSTM that takes no gradient ``lstm_scan`` from zero
    state."""
    inputs, run = _kernel_of(type(cell))
    zs, ws = inputs(cell, xs)
    if type(cell) is LSTMCell and not _takes_grad(*zs, *ws):
        h0 = zs[0].new_zeros(zs[0].shape[1], cell.hidden_size)
        return lstm_scan(zs[0], ws[0].contiguous(), h0, h0)
    return run(*[z[:, None] for z in zs],
               *[w[None].contiguous() for w in ws])[:, 0]


def _rnn(cell: RnnCell, xs, k):
    """The h stack (T, N, H); with 0 < k < T and a gradient to take, in
    chunks of k steps, each from the last h of the one before, detached."""
    zx = (torch.matmul(xs, cell.i2h.t()) + cell.bias_i
          + cell.bias_h)[:, None]                             # (T, 1, N, H)
    wh = cell.h2h.t()[None].contiguous()
    t = zx.shape[0]
    if not (_takes_grad(zx, wh) and 0 < k < t):
        return rnn_recurrence(zx, wh)[:, 0]
    outs, h = [], None
    for start in range(0, t, k):
        out = rnn_recurrence(zx[start:start + k], wh, h)
        h = out[-1].detach()
        outs.append(out)
    return torch.cat(outs)[:, 0]


class Recurrent(Container):
    """Time-loop container (ref Recurrent.scala:27): ``Recurrent().add(
    cell)`` maps (N, T, D) to (N, T, H); ``reverse=True`` runs right to
    left.  ``bptt_truncate`` of 0 or at least T is the full backward
    through time; a truncation inside the sequence runs for ``RnnCell``
    only."""

    def __init__(self, bptt_truncate: int = 0, reverse: bool = False):
        super().__init__()
        self.bptt_truncate = int(bptt_truncate)
        self.reverse = reverse

    @property
    def cell(self) -> Cell:
        return self.get(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cell, t, k = self.cell, x.shape[1], self.bptt_truncate
        # exact types, as the JAX kernel route: a subclass's own step
        # would be bypassed by the kernel
        kind = type(cell)
        if kind not in (LSTMCell, GRUCell, RnnCell):
            raise NotImplementedError(
                f"Recurrent({kind.__name__}): only LSTMCell, GRUCell and "
                f"RnnCell run in this port")
        if kind is RnnCell and type(cell.activation) is not Tanh:
            raise NotImplementedError(
                f"RnnCell with {type(cell.activation).__name__}: only Tanh "
                f"runs in this port (the kernel's); other activations take "
                f"the JAX package's lax.scan route, ROADMAP slice 5, next "
                f"item 3")
        if kind is not RnnCell and 0 < k < t:
            raise NotImplementedError(_TRUNCATION.format(k, t, kind.__name__))
        xs = x.transpose(0, 1)                          # (T, N, D)
        if self.reverse:
            xs = xs.flip(0)
        outs = (_rnn(cell, xs, k) if kind is RnnCell
                else _one_direction(cell, xs))
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

    def _cells_eligible(self, cell_type) -> bool:
        """Both children hold exactly ``cell_type`` of equal sizes and no
        truncation: both directions go through one D = 2 kernel call."""
        cf, cb = self.get(1).cell, self.get(2).cell
        return (type(cf) is cell_type and type(cb) is cell_type
                and cf.input_size == cb.input_size
                and cf.hidden_size == cb.hidden_size
                and self.get(1).bptt_truncate <= 0
                and self.get(2).bptt_truncate <= 0)

    def _fused_lstm_eligible(self) -> bool:
        return self._cells_eligible(LSTMCell)

    def _fused_gru_eligible(self) -> bool:
        return self._cells_eligible(GRUCell)

    def _merge(self, yf, yb):
        return torch.cat([yf, yb], dim=-1) if self.merge == "concat" \
            else yf + yb

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind = next((k for k in (LSTMCell, GRUCell)
                     if self._cells_eligible(k)), None)
        if kind is None:
            return self._merge(self.get(1)(x), self.get(2)(x))
        # both directions in one kernel call, the backward one over the
        # flipped sequence: projections (T, 2, N, J), weights (2, H, J)
        inputs, run = _kernel_of(kind)
        xs = x.transpose(0, 1)                          # (T, N, D)
        (zf, wf) = inputs(self.get(1).cell, xs)
        (zb, wb) = inputs(self.get(2).cell, xs.flip(0))
        outs = run(*[torch.stack(p, dim=1) for p in zip(zf, zb)],
                   *[torch.stack(p) for p in zip(wf, wb)])  # (T, 2, N, H)
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
