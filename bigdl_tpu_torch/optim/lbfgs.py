"""L-BFGS with a Wolfe line search (counterpart of bigdl_tpu/optim/
lbfgs.py; ref optim/LBFGS.scala:39, LineSearch.scala:44 lswolfe).

It works over one flat vector: the leaves of ``x`` (a tensor, a list of
tensors or a nested dict of them, the JAX tree layout) concatenated, and
split back into that layout for each ``feval`` (the JAX package's
``ravel_pytree``).  The two-loop recursion and the line search are
host-driven, as there: each ``float()`` of a dot product is a host read,
and ``feval`` may run on the card.  Only the functional face exists, as
in the JAX package.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.optim.optim_method import (OptimMethod, tree_leaves,
                                                tree_map)
from bigdl_tpu_torch.utils.table import T, Table


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _unflatten(like):
    """The function that splits a flat vector back into ``like``'s
    layout (each leaf a view of its part)."""
    leaves = tree_leaves(like)
    sizes = [t.numel() for t in leaves]
    shapes = [t.shape for t in leaves]

    def unflat(flat):
        parts = iter([p.view(s) for p, s in zip(flat.split(sizes), shapes)])
        return tree_map(lambda _: next(parts), like)
    return unflat


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def ls_wolfe(feval, x, t, d, f, g, gtd, c1=1e-4, c2=0.9, tolX=1e-9,
             max_iter=20):
    """Wolfe line search (bracket, then zoom), ref LineSearch.lswolfe
    (LineSearch.scala:44).  ``feval(x)`` returns ``(float loss, flat
    gradient)``.  Returns ``(f_new, g_new, x_new, t, n_feval)``."""
    d_norm = float(d.abs().max())
    g = g.clone()
    f_new, g_new = feval(x + t * d)
    ls_func_evals = 1
    gtd_new = _dot(g_new, d)

    t_prev, f_prev, g_prev, gtd_prev = 0.0, f, g, gtd
    done = False
    ls_iter = 0
    bracket = None

    while ls_iter < max_iter:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket = [(t_prev, f_prev, g_prev, gtd_prev),
                       (t, f_new, g_new, gtd_new)]
            break
        if abs(gtd_new) <= -c2 * gtd:
            done = True
            bracket = [(t, f_new, g_new, gtd_new)] * 2
            break
        if gtd_new >= 0:
            bracket = [(t_prev, f_prev, g_prev, gtd_prev),
                       (t, f_new, g_new, gtd_new)]
            break
        # extrapolate
        tmp = t
        t = min(10 * t, t + (t - t_prev) * 10)
        t_prev, f_prev, g_prev, gtd_prev = tmp, f_new, g_new, gtd_new
        f_new, g_new = feval(x + t * d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        ls_iter += 1

    if bracket is None:
        bracket = [(0.0, f, g, gtd), (t, f_new, g_new, gtd_new)]

    # zoom
    while not done and ls_iter < max_iter:
        (t_lo, f_lo, g_lo, gtd_lo), (t_hi, f_hi, g_hi, gtd_hi) = bracket
        if abs(t_hi - t_lo) * d_norm < tolX:
            break
        t = (t_lo + t_hi) / 2.0
        f_new, g_new = feval(x + t * d)
        ls_func_evals += 1
        gtd_new = _dot(g_new, d)
        if f_new > (f + c1 * t * gtd) or f_new >= f_lo:
            bracket = [(t_lo, f_lo, g_lo, gtd_lo), (t, f_new, g_new, gtd_new)]
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
                bracket = [(t, f_new, g_new, gtd_new)] * 2
            elif gtd_new * (t_hi - t_lo) >= 0:
                bracket = [(t, f_new, g_new, gtd_new),
                           (t_lo, f_lo, g_lo, gtd_lo)]
            else:
                bracket = [(t, f_new, g_new, gtd_new),
                           (t_hi, f_hi, g_hi, gtd_hi)]
        ls_iter += 1

    t_res, f_res, g_res, _ = min(bracket, key=lambda b: b[1])
    return f_res, g_res, x + t_res * d, t_res, ls_func_evals


class LBFGS(OptimMethod):
    """(ref LBFGS.scala:39) The config keys ``maxIter``, ``maxEval``,
    ``tolFun``, ``tolX``, ``nCorrection``, ``learningRate`` and
    ``lineSearch`` (True: Wolfe; False: fixed steps); the state keys
    ``old_dirs``, ``old_stps``, ``g_prev``, ``d``, ``H_diag`` and
    ``funcEval``.  ``optimize`` returns ``(new x, f_hist)``."""

    def optimize(self, feval, x, config: Table = None, state: Table = None):
        config = config if config is not None else T()
        state = state if state is not None else config
        max_iter = config.get("maxIter", 20)
        max_eval = config.get("maxEval", int(max_iter * 1.25))
        tol_fun = config.get("tolFun", 1e-5)
        tol_x = config.get("tolX", 1e-9)
        n_correction = config.get("nCorrection", 100)
        lr = config.get("learningRate", 1.0)
        use_wolfe = config.get("lineSearch", True)

        unflat = _unflatten(x)
        x_flat = _flat(x).detach()

        def feval_flat(xf):
            loss, grad = feval(unflat(xf))
            return float(loss), _flat(grad).detach()

        f, g = feval_flat(x_flat)
        f_hist = [f]
        current_f_evals = 1
        state["funcEval"] = state.get("funcEval", 0) + 1

        if float(g.abs().sum()) <= 1e-12 * g.numel():
            return unflat(x_flat), f_hist

        old_dirs = state.get("old_dirs", [])
        old_stps = state.get("old_stps", [])
        g_prev = state.get("g_prev", None)
        d = state.get("d", None)
        t = 1.0
        H_diag = state.get("H_diag", 1.0)

        n_iter = 0
        while n_iter < max_iter:
            n_iter += 1
            if g_prev is None:
                d = -g
            else:
                y = g - g_prev
                s = d * t
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(old_dirs) == n_correction:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                    old_dirs.append(s)
                    old_stps.append(y)
                    H_diag = ys / _dot(y, y)
                # the two-loop recursion
                k = len(old_dirs)
                ro = [1.0 / _dot(old_stps[i], old_dirs[i]) for i in range(k)]
                al = [0.0] * k
                q = -g
                for i in range(k - 1, -1, -1):
                    al[i] = _dot(old_dirs[i], q) * ro[i]
                    q = q - al[i] * old_stps[i]
                d = q * H_diag
                for i in range(k):
                    be = _dot(old_stps[i], d) * ro[i]
                    d = d + old_dirs[i] * (al[i] - be)
            g_prev = g

            gtd = _dot(g, d)
            if gtd > -tol_x:
                break
            t = (min(1.0, 1.0 / float(g.abs().sum())) if n_iter == 1
                 else lr)

            if use_wolfe:
                f, g, x_flat, t, ls_evals = ls_wolfe(feval_flat, x_flat, t,
                                                     d, f, g, gtd)
                current_f_evals += ls_evals
            else:
                x_flat = x_flat + t * d
                f, g = feval_flat(x_flat)
                current_f_evals += 1
            f_hist.append(f)
            state["funcEval"] = state.get("funcEval", 0) + 1

            if current_f_evals >= max_eval:
                break
            if float(g.abs().sum()) <= 1e-12 * g.numel():
                break
            if float((t * d).abs().sum()) <= tol_x:
                break
            if len(f_hist) > 1 and abs(f_hist[-1] - f_hist[-2]) < tol_fun:
                break

        state["old_dirs"] = old_dirs
        state["old_stps"] = old_stps
        state["g_prev"] = g_prev
        state["d"] = d
        state["H_diag"] = H_diag
        return unflat(x_flat), f_hist

    def clear_history(self, state: Table):
        for k in ("old_dirs", "old_stps", "g_prev", "d", "H_diag",
                  "funcEval"):
            if k in state:
                del state[k]
        return state
