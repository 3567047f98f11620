"""Variable-coefficient, variable-order Adams–Bashforth–Moulton (VCABM),
method ``'adams'``.

Counterpart of `tfdiffeq_tpu/solvers/adams.py`: adaptive order (1..12) and
adaptive step size through divided-difference phi arrays, the g-coefficient
recurrence, and order adaptation from the error estimates at orders
k - 2 .. k + 1 (Shampine–Gordon). The reference runs one `lax.while_loop`
over fixed-size masked buffers; here the accept/reject loop is an eager
host loop over the same [K, ...] buffers (K = MAX_ORDER + 2), with the
same masked recurrences in the same order:

- ``prev_t`` holds the accepted times newest first, its unfilled slots the
  sentinels t0 - 1 - slot, so no masked divide ever sees 0 / 0;
- the g / beta / c recurrences run over the static MAX_ORDER bound with
  each entry masked by the live order, and every divide by a zero
  denominator divides by 1 instead (its result is masked);
- the corrector index is max(order - 1, 1): the reference's fix of the
  lineage's order-1 double count;
- the 4-step / order-3 startup, "keep dt when raising the order", the
  clamped controller at order k + 1 on accept and k on reject, and the
  output written when an accepted step lands on the next requested time.

Times, g and the controller live on the host in the time dtype; the state
and the phi stacks on the state's device. Each attempt brings the error
ratio and the finiteness flag to the host, and an accepted one its three
order-adaptation ratios.
"""

from __future__ import annotations

from fractions import Fraction as Fr

import numpy as np
import torch

from ..ops.norms import error_ratio, rms_norm, select_initial_step
from .adaptive import default_dt_min
from .base import CanonicalProblem, SolveResult, SolverStats, Status
from .fixed_adams import MAX_ORDER, check_max_order

Tensor = torch.Tensor

_K = MAX_ORDER + 2          # phi slots: indices 0 .. order + 1 used
_INT32_MAX = 2 ** 31 - 1


def _gamma_star_table() -> np.ndarray:
    """gamma*_m from the exact recurrence sum_{j=0}^m gamma*_j / (m+1-j) = 0
    (m >= 1), gamma*_0 = 1 (Hairer–Nørsett–Wanner III.1), as the reference
    derives it."""
    gs = [Fr(1)]
    for m in range(1, _K + 1):
        gs.append(-sum(gs[j] / (m + 1 - j) for j in range(m)))
    return np.array([float(g) for g in gs], dtype=np.float64)


GAMMA_STAR = _gamma_star_table()


def _safe_div(num: Tensor, den: Tensor) -> Tensor:
    """num / den with den == 0 replaced by 1 before the divide (the caller
    masks the result)."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _g_and_explicit_phi(prev_t: Tensor, next_t: Tensor, phi: Tensor,
                        order: int):
    """Adams g-coefficients and explicit divided differences for one step.

    prev_t: [_K] host times, newest first; phi: [_K, ...] divided
    differences at the current point; order in [1, MAX_ORDER]. Returns
    (g [_K] host, explicit_phi [_K, ...]); entries past the live order are
    zero. The c vector shrinks by one valid entry each iteration; a
    fixed-size roll stands in, its tail finite and never read.
    """
    rdt = prev_t.dtype
    curr_t = prev_t[0]
    dt = next_t - curr_t
    g = torch.zeros(_K, dtype=rdt)
    g[0] = 1.0
    c = 1.0 / torch.arange(1, _K + 2, dtype=rdt)
    explicit_phi = torch.zeros_like(phi)
    explicit_phi[0] = phi[0]
    beta = torch.tensor(1.0, dtype=rdt)
    for j in range(1, MAX_ORDER + 1):
        # At j == 1 the factor is exactly 1: the reference's special case.
        if j <= order:
            factor = _safe_div(dt, next_t - prev_t[j - 1])
            c = c - torch.roll(c, -1) * factor
            g[j] = c[0]
        if j < order:
            beta = beta * _safe_div(next_t - prev_t[j - 1],
                                    curr_t - prev_t[j])
            explicit_phi[j] = phi[j] * beta.to(phi.dtype).to(phi.device)
    return g, explicit_phi


def _compute_implicit_phi(explicit_phi: Tensor, f_next: Tensor,
                          k: int) -> Tensor:
    """implicit_phi[0] = f_next; implicit_phi[j] = implicit_phi[j - 1] -
    explicit_phi[j - 1], kept in the first k rows (one cumsum, as the
    reference)."""
    csum = torch.cumsum(explicit_phi[:-1], dim=0)
    shifted = torch.cat([torch.zeros_like(csum[:1]), csum])
    phi = f_next[None] - shifted
    phi[k:] = 0.0
    return phi


def _optimal_dt(dt: Tensor, ratio: Tensor, order: int, safety: float,
                ifactor: float, dfactor: float, accepted: bool) -> Tensor:
    """The reference's `_optimal_dt`: safety * ratio ** (-1/order) clipped
    to [1, ifactor] on accept (an accepted step never shrinks) and
    [dfactor, 1] on reject; ifactor when the ratio is 0."""
    rdt = dt.dtype
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt)
    r = torch.maximum(ratio.to(rdt), tiny)
    k = torch.tensor(float(max(order, 1)), dtype=rdt)
    factor = safety * r ** (-1.0 / k)
    lo, hi = (1.0, ifactor) if accepted else (dfactor, 1.0)
    if bool(ratio <= 0.0):
        factor = torch.tensor(ifactor, dtype=rdt)
    else:
        factor = torch.clamp(factor, lo, hi)
    return dt * factor


def _host(*xs: Tensor):
    """Device 0-d tensors to host floats in one transfer."""
    return torch.stack([x.to(torch.float64) for x in xs]).cpu().tolist()


def solve_vcabm(prob: CanonicalProblem, options: dict, rtol, atol
                ) -> SolveResult:
    y0, tau = prob.y0, prob.tau
    dtype, dev = prob.dtype, y0.device
    rdt = torch.empty((), dtype=prob.time_dtype).real.dtype
    T = tau.shape[0]

    max_order = check_max_order(options.get("max_order", MAX_ORDER))
    safety = float(options.get("safety", 0.9))
    ifactor = float(options.get("ifactor", 10.0))
    dfactor = float(options.get("dfactor", 0.2))
    max_num_steps = int(options.get("max_num_steps", _INT32_MAX))
    norm = options.get("norm") or rms_norm
    if not callable(norm):
        raise ValueError(f"options['norm'] of 'adams' must be a callable, "
                         f"got {norm!r}")

    ydt = torch.empty((), dtype=dtype).real.dtype
    rtol = torch.as_tensor(rtol, dtype=ydt).to(dev)
    atol = torch.as_tensor(atol, dtype=ydt).to(dev)
    if T == 1:
        return SolveResult(y0[None].clone(), SolverStats(0, 0, 0, 0))

    func = prob.func
    gamma_star = torch.tensor(GAMMA_STAR, dtype=dtype, device=dev)
    dt_min = default_dt_min(tau).to(rdt)

    t0 = tau[0]
    f0 = func(t0, y0)
    first_step = options.get("first_step")
    if first_step is None:
        dt0 = select_initial_step(func, t0, y0, f0, 1, rtol, atol, norm)
        dt0 = dt0.detach().cpu().to(rdt)
        nfe = 2
    else:
        # Clamp to dt_min: dt = 0 would be accepted forever without progress.
        dt0 = torch.maximum(torch.abs(torch.as_tensor(first_step, dtype=rdt)),
                            dt_min)
        nfe = 1

    y = y0
    phi = torch.zeros((_K,) + tuple(y0.shape), dtype=dtype, device=dev)
    phi[0] = f0
    # Unfilled slots hold distinct sentinels t0 - 1 - slot.
    prev_t = t0 - 1.0 - torch.arange(_K, dtype=rdt)
    prev_t[0] = t0
    next_t = t0 + dt0
    order = 1
    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    oi, n_acc, n_rej = 1, 0, 0
    status = Status.OK
    big = torch.tensor(2.0 ** 20, dtype=ydt)

    while oi < T and status == Status.OK:
        final_t = tau[min(oi, T - 1)]
        next_t = torch.minimum(next_t, final_t)
        dt = next_t - prev_t[0]
        dt_y = dt.to(dtype).to(dev)

        g, explicit_phi = _g_and_explicit_phi(prev_t, next_t, phi, order)
        g_y = g.to(dtype).to(dev)

        # Explicit predictor over the first max(1, order - 1) phi terms.
        n_pred = max(order - 1, 1)
        wmask = (torch.arange(_K, device=dev) < n_pred).to(dtype)
        p_next = y + dt_y * torch.tensordot(g_y * wmask, explicit_phi,
                                            dims=1)

        # Implicit correction at index max(order - 1, 1) (see the module
        # docstring).
        f_pred = func(next_t, p_next)
        implicit_phi_p = _compute_implicit_phi(explicit_phi, f_pred,
                                               order + 1)
        om1 = max(order - 1, 0)
        cidx = max(order - 1, 1)
        y_next = p_next + dt_y * g_y[cidx] * implicit_phi_p[cidx]

        # Error at order k; accept iff ratio <= 1.
        err_k_vec = dt_y * (g_y[order] - g_y[om1]) * implicit_phi_p[order]
        error_k_d = error_ratio(err_k_vec, rtol, atol, y, y_next, norm)
        ek, fin = _host(error_k_d, torch.all(torch.isfinite(y_next))
                        & torch.isfinite(error_k_d))
        error_k = torch.tensor(ek, dtype=ydt)
        finite = bool(fin)
        accept = bool(error_k <= 1.0) and finite
        error_ctrl = error_k if finite else big

        if accept:
            # The second evaluation and the order adaptation run only for
            # accepted steps: one evaluation a rejected attempt.
            f_next = func(next_t, y_next)
            implicit_phi = _compute_implicit_phi(explicit_phi, f_next,
                                                 order + 2)
            om2 = max(order - 2, 0)
            om3 = max(order - 3, 0)
            tol_scale = atol + rtol * torch.maximum(torch.abs(y),
                                                    torch.abs(y_next))

            def ratio_of(vec):
                return norm(vec / tol_scale)

            e_km1, e_km2, e_kp1 = _host(
                ratio_of(dt_y * (g_y[om1] - g_y[om2]) * implicit_phi_p[om1]),
                ratio_of(dt_y * (g_y[om2] - g_y[om3]) * implicit_phi_p[om2]),
                ratio_of(dt_y * gamma_star[order] * implicit_phi[order]))
            ek_h = float(error_k)
            if n_acc + 1 <= 4 or order < 3:
                next_order = min(order + 1, 3, max_order)
            elif min(e_km1, e_km2) < ek_h:
                next_order = order - 1
            elif order < min(max_order, n_acc + 1) and e_kp1 < ek_h:
                next_order = order + 1
            else:
                next_order = order
            next_order = min(max(next_order, 1), max_order)
            # Keep dt when raising the order, else the controller at order
            # k + 1.
            dt_acc = dt if next_order > order else _optimal_dt(
                dt, error_ctrl, order + 1, safety, ifactor, dfactor, True)
            n_evals = 2
        else:
            n_evals = 1
        dt_rej = _optimal_dt(dt, error_ctrl, order, safety, ifactor, dfactor,
                             False)

        # Output write: an accepted step landing on final_t.
        hit = accept and bool(next_t >= final_t)
        if hit:
            out[oi] = y_next
        oi += int(hit)

        n_att = n_acc + n_rej + 1
        if not accept and bool(dt_rej < dt_min) and status == Status.OK:
            status = Status.DT_UNDERFLOW
        if n_att >= max_num_steps and oi < T and status == Status.OK:
            status = Status.MAX_STEPS_REACHED

        if accept:
            y, phi = y_next, implicit_phi
            prev_t = torch.cat([next_t[None], prev_t[:-1]])
            next_t = next_t + dt_acc
            order = next_order
            n_acc += 1
        else:
            next_t = prev_t[0] + dt_rej
            n_rej += 1
        nfe += n_evals

    return SolveResult(out, SolverStats(nfe, n_acc, n_rej, int(status)))


def _adams(prob, options, rtol, atol):
    return solve_vcabm(prob, options, rtol, atol)


from ..odeint import register_solver  # noqa: E402

register_solver("adams", "custom", _adams,
                allowed={"max_order", "first_step", "safety", "ifactor",
                         "dfactor", "max_num_steps", "norm", "fuse"})
