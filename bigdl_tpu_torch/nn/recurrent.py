"""Recurrence (counterpart of bigdl_tpu/nn/recurrent.py; ref
Recurrent.scala:27, RNN.scala:28, TimeDistributed.scala).

``Recurrent().add(cell)`` maps batch-first (N, T, D) to (N, T, H);
``BiRecurrent`` runs a forward and a reverse ``Recurrent`` over the same
input and merges them.  Which route a ``Recurrent`` takes is decided from
its cell's exact type (and an ``RnnCell``'s activation's) before any
launch.

The kernel route: the time loop is a hand-written recurrence kernel over
the input projection, which is hoisted out of the loop as one large
product: ``ops.bilstm_recurrence`` for ``LSTMCell``,
``ops.gru_recurrence`` for ``GRUCell`` and ``ops.rnn_recurrence`` for
``RnnCell`` with any element-wise activation (the twenty kinds of
``ops.Act``: every activation class but the row-wise soft-maxes, PReLU,
RReLU and GradientReversal), each a kernel's D = 1 case; a
``BiRecurrent`` of two equal ``LSTMCell``s or two equal ``GRUCell``s
without truncation runs both directions in one D = 2 call.  A
``Recurrent(LSTMCell)`` forward that takes no gradient (grad mode off, or
neither the projection nor the recurrent weight requires grad:
validation and inference) runs ``ops.lstm_scan`` from zero state instead,
the forward-only kernel the JAX package wrote for it; so do the reverse
direction and the two children of a ``BiRecurrent`` that cannot share a
call.

Truncated BPTT (``bptt_truncate`` of k, 0 < k < T) where a gradient is
taken: chunks of k steps, each one D = 1 kernel call from the previous
chunk's last state (h, and the LSTM's c), detached: the JAX package's
chunked ``lax.scan`` with the carry stop-gradiented at chunk boundaries.
A forward that takes no gradient runs the whole sequence in one call (one
``lstm_scan``, ``gru_forward`` or ``rnn_forward``): the same function.

The step route: a cell of any other type (a subclass of the three
included: the kernel would bypass its own ``step``) and an ``RnnCell``
whose activation no kernel runs (``SoftMax``, ``SoftMin`` and
``LogSoftMax`` normalise over the H units, across the kernel's blocks)
walk ``cell.step`` in a Python loop over T, chunked and detached at chunk
boundaries exactly as the JAX scan: the counterpart of the JAX
``lax.scan`` route, which has no kernel either.  ``step_route_calls``
counts the forwards that took it.

A cell's step protocol is the JAX ``Cell``'s: ``init_hidden(batch)`` (a
tuple (h, c) for the LSTM), ``step(x_t, hidden) -> (out, hidden)`` in
plain PyTorch, and ``cell.forward([x, h])`` (or ``Table(x, h)``) -> out,
the JAX ``Cell._forward`` of a standalone cell.
"""
from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn import activations as act_
from bigdl_tpu_torch.nn import init as init_
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.ops import (bilstm_recurrence, gru_recurrence,
                                 lstm_scan, rnn_recurrence)
from bigdl_tpu_torch.utils.table import Table

#: forwards of a ``Recurrent`` that took the step route
step_route_calls = 0

#: the activation classes whose ``act()`` the RNN kernel applies (exact
#: types: a subclass's own forward would be bypassed)
KERNEL_ACTIVATIONS = (
    act_.ReLU, act_.ReLU6, act_.Tanh, act_.TanhShrink, act_.Sigmoid,
    act_.LogSigmoid, act_.SoftPlus, act_.SoftSign, act_.SoftShrink,
    act_.HardShrink, act_.HardTanh, act_.Clamp, act_.Threshold,
    act_.LeakyReLU, act_.ELU, act_.Abs, act_.Sqrt, act_.Square, act_.Power,
    act_.Exp, act_.Log)


class Cell(Module):
    """A recurrent cell: its parameters, ``hidden_size`` and its step."""

    hidden_size: int

    def _uniform(self, shapes, device, generator):
        """Each (name, shape) parameter U(-1/sqrt(H), 1/sqrt(H)), drawn in
        order, as the JAX cells draw them."""
        stdv = 1.0 / math.sqrt(self.hidden_size)
        for name, shape in shapes:
            self._add_param(name, init_.uniform(shape, -stdv, stdv,
                                                generator), device)

    def init_hidden(self, batch: int):
        """Zeros (batch, H) on the parameters' device and dtype."""
        return next(self.parameters()).new_zeros(batch, self.hidden_size)

    def step(self, x, hidden):
        """(out, hidden') of one step from x (N, D) and ``hidden``."""
        raise NotImplementedError

    def forward(self, inputs):
        """Standalone use: [x, h] (or ``Table(x, h)``) -> the step's out."""
        x, h = ((inputs[1], inputs[2]) if isinstance(inputs, Table)
                else inputs)
        return self.step(x, h)[0]


class LSTMCell(Cell):
    """Standard LSTM cell with ``w`` (4H, D+H) over [x, h] and ``bias``
    (4H), both U(-1/sqrt(H), 1/sqrt(H)); gates i, f, g, o; hidden (h, c).
    On the card the recurrence kernels take H up to
    ``ops.bilstm.MAX_HIDDEN`` (6,197): a larger H raises
    ``NotImplementedError`` at the first forward."""

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        h, d = hidden_size, input_size
        self._uniform((("w", (4 * h, d + h)), ("bias", (4 * h,))), device,
                      generator)

    def init_hidden(self, batch: int):
        z = super().init_hidden(batch)
        return (z, z)

    def step(self, x, hidden):
        h, c = hidden
        z = torch.matmul(torch.cat([x, h], dim=-1), self.w.t()) + self.bias
        return self._gates(z, c)

    @staticmethod
    def _gates(z, c):
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class RnnCell(Cell):
    """Vanilla RNN: h' = act(W_i x + b_i + W_h h + b_h) (ref RNN.scala:28),
    with ``i2h`` (H, D), ``h2h`` (H, H), ``bias_i`` and ``bias_h`` (H),
    each U(-1/sqrt(H), 1/sqrt(H)).  ``activation`` defaults to ``Tanh``;
    it is a setting of the cell, not a child module (the JAX parameter
    tree has no entry for it).  On the card H goes up to
    ``ops.rnn.MAX_HIDDEN``."""

    def __init__(self, input_size: int, hidden_size: int, activation=None,
                 device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        object.__setattr__(self, "activation", activation
                           if activation is not None else act_.Tanh())
        h, d = hidden_size, input_size
        self._uniform((("i2h", (h, d)), ("h2h", (h, h)), ("bias_i", (h,)),
                       ("bias_h", (h,))), device, generator)

    def step(self, x, h):
        pre = (torch.matmul(x, self.i2h.t()) + self.bias_i
               + torch.matmul(h, self.h2h.t()) + self.bias_h)
        h_new = self.activation(pre)
        return h_new, h_new


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

    def step(self, x, h):
        xh = torch.cat([x, h], dim=-1)
        r, z = torch.chunk(torch.sigmoid(torch.matmul(xh, self.w_rz.t())
                                         + self.b_rz), 2, dim=-1)
        xrh = torch.cat([x, r * h], dim=-1)
        n = torch.tanh(torch.matmul(xrh, self.w_h.t()) + self.b_h)
        h_new = (1 - z) * n + z * h
        return h_new, h_new


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


def kernel_act(activation):
    """The ``ops.Act`` the RNN kernel applies for ``activation``, or None
    where no kernel runs it."""
    return (activation.act() if type(activation) in KERNEL_ACTIVATIONS
            else None)


def _in_chunks(run, zs, k):
    """The h stack (T, 1, N, H) of ``run(chunk inputs, state) -> (out,
    state)`` over chunks of k steps of the (T, 1, N, J) inputs ``zs``, the
    first from zeros (state None), each later one from the last state of
    the one before, detached by ``run``."""
    outs, state = [], None
    for start in range(0, zs[0].shape[0], k):
        out, state = run([z[start:start + k] for z in zs], state)
        outs.append(out)
    return torch.cat(outs)


def _one_direction(cell, xs, k):
    """The h stack (T, N, H) of an LSTM or GRU cell: the kernel's D = 1
    case, in chunks of k steps where 0 < k < T and a gradient is taken;
    for an LSTM that takes no gradient ``lstm_scan`` from zero state."""
    inputs, run = _kernel_of(type(cell))
    zs, ws = inputs(cell, xs)
    grad = _takes_grad(*zs, *ws)
    if type(cell) is LSTMCell and not grad:
        h0 = zs[0].new_zeros(zs[0].shape[1], cell.hidden_size)
        return lstm_scan(zs[0], ws[0].contiguous(), h0, h0)
    zs = [z[:, None] for z in zs]
    ws = [w[None].contiguous() for w in ws]
    if not (grad and 0 < k < xs.shape[0]):
        return run(*zs, *ws)[:, 0]
    if run is bilstm_recurrence:
        def chunk(z, state):
            h, c = state if state is not None else (None, None)
            out, c = bilstm_recurrence(*z, *ws, h, c, with_last_c=True)
            return out, (out[-1].detach(), c)
    else:
        def chunk(z, h):
            out = gru_recurrence(*z, *ws, h)
            return out, out[-1].detach()
    return _in_chunks(chunk, zs, k)[:, 0]


def _rnn(cell: RnnCell, xs, k, act):
    """The h stack (T, N, H) under ``act``; with 0 < k < T and a gradient
    to take, in chunks of k steps, each from the last h of the one before,
    detached."""
    zx = (torch.matmul(xs, cell.i2h.t()) + cell.bias_i
          + cell.bias_h)[:, None]                             # (T, 1, N, H)
    wh = cell.h2h.t()[None].contiguous()
    if not (_takes_grad(zx, wh) and 0 < k < zx.shape[0]):
        return rnn_recurrence(zx, wh, act=act)[:, 0]

    def chunk(z, h):
        out = rnn_recurrence(z[0], wh, h, act=act)
        return out, out[-1].detach()
    return _in_chunks(chunk, [zx], k)[:, 0]


def _detach(hidden):
    if isinstance(hidden, tuple):
        return tuple(h.detach() for h in hidden)
    return hidden.detach()


def _steps(cell: Cell, xs, k):
    """The outputs (T, N, ...) of ``cell.step`` walked over T from
    ``init_hidden``; with 0 < k < T the hidden state is detached after
    every k steps."""
    global step_route_calls
    step_route_calls += 1
    t = xs.shape[0]
    hidden, outs = cell.init_hidden(xs.shape[1]), []
    k = k if 0 < k < t else t
    for start in range(0, t, k):
        for x in xs[start:start + k]:
            out, hidden = cell.step(x, hidden)
            outs.append(out)
        hidden = _detach(hidden)
    return (torch.stack(outs) if outs
            else xs.new_zeros(0, xs.shape[1], cell.hidden_size))


class Recurrent(Container):
    """Time-loop container (ref Recurrent.scala:27): ``Recurrent().add(
    cell)`` maps (N, T, D) to (N, T, H); ``reverse=True`` runs right to
    left.  ``bptt_truncate`` of 0 or at least T is the full backward
    through time; k inside the sequence cuts the gradient every k
    steps."""

    def __init__(self, bptt_truncate: int = 0, reverse: bool = False):
        super().__init__()
        self.bptt_truncate = int(bptt_truncate)
        self.reverse = reverse

    @property
    def cell(self) -> Cell:
        return self.get(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cell, k = self.cell, self.bptt_truncate
        xs = x.transpose(0, 1)                          # (T, N, D)
        if self.reverse:
            xs = xs.flip(0)
        # exact types, as the JAX kernel route: a subclass's own step
        # would be bypassed by a kernel
        kind = type(cell)
        act = kernel_act(cell.activation) if kind is RnnCell else None
        if kind in (LSTMCell, GRUCell):
            outs = _one_direction(cell, xs, k)
        elif act is not None:
            outs = _rnn(cell, xs, k, act)
        else:
            outs = _steps(cell, xs, k)
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
