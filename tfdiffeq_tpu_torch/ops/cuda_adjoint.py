"""K3: the fused adjoint backward sweep for MLP neural ODEs — wrapper,
launch counter and plain PyTorch version.

Counterpart of `tfdiffeq_tpu/ops/pallas_adjoint.py` for the training path:
`mlp_adjoint_solve` runs the ENTIRE continuous-adjoint backward pass of
`fast.odeint_adjoint_mlp` as one launch of the CUDA kernel in
`csrc/adjoint_kernel.cu` (replacing `_make_adjoint_kernel`,
pallas_adjoint.py:430, with its RHS `_make_aug_eval` :107): the loop over
observation intervals in reverse with stored-state resets and cotangent
injections, every adaptive RK attempt on (y, a_y) in sigma = -tau, the MLP
forward and hand-written VJP in each stage, the parameter and a_t
quadratures, the error norm and the shared controller.

The wrapper takes the plain version (`mlp_adjoint_solve_plain`) only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. The plain
version mirrors the kernel attempt for attempt, with one host
synchronisation per attempt, and takes every batch sum in the kernel's
fixed order (`_lane_sums`, `cuda_kernels._owned_sums`, `_tree_sum`), so
the two take the same steps in float64.

The kernel takes the routes of `cuda_kernels._route`: narrow (the weights,
the parameter accumulator and the stage cotangents in shared memory) or wide
(layers up to MAX_WIDTH, all of those in global memory). The sweep is always
float32-accurate: the reference's dot-precision tiers reach the forward
solves only (`fast.odeint_adjoint_mlp`).

Not ported: `rhs='cnf'` (K7, ROADMAP queue 2), and the TPU machinery of the
reference (`pack` sublane packing, `n_blocks` grid blocks, `stream_io`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .cuda_kernels import (ROUTE_WIDE, _ACT_CODES, _ACTIVATION_GRADS,
                           _ACTIVATIONS, _check_activations, _check_float,
                           _check_mlp,
                           _controller_factor, _device_kind, _dims_arg,
                           _owned_sums, _ptr, _route, _solve_setup, _stream,
                           _tableau_args, _tree_sum, _unpack)
from .tableaus import TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: Threads of K3's one block (at most csrc/adjoint_kernel.cu kAdjThreads).
ADJOINT_THREADS = 512
#: Lanes of a batch sum: lane j adds samples j, j + 32, ... (one warp).
LANES = 32

mlp_adjoint_solve_launches = 0


def reset_launch_counts() -> None:
    global mlp_adjoint_solve_launches
    mlp_adjoint_solve_launches = 0


def _lane_sums(x: Tensor) -> Tensor:
    """Sums of x [B, R] over the batch in K3's order: lane j adds rows
    j, j + 32, j + 64, ... in turn from 0, then the 32 lane sums meet in
    `_tree_sum`'s tree. Returns [R]."""
    B, R = x.shape
    K = -(-B // LANES)
    x = torch.nn.functional.pad(x, (0, 0, 0, K * LANES - B)).view(
        K, LANES, R)
    acc = torch.zeros(LANES, R, dtype=x.dtype, device=x.device)
    for k in range(K):
        acc = acc + x[k]
    return _tree_sum(acc.t())


def _aug_eval_plain(packed: Tensor, dims, activation: str,
                    final_activation: str, input_power: int,
                    time_input: bool):
    """pallas_adjoint.py:_make_aug_eval on [B, D], in the kernel's order:
    each pre-activation sums its inputs in order (the time column last),
    each input cotangent sums over the layer's outputs in order.

    Returns F(t, y, a_y) -> (f, v_y, per-sample parameter cotangents
    [B, n_w] in `pack_mlp_weights`' layout, v_t [B] or None); t is one time
    (0-d) or one a sample ([B])."""
    layers = _unpack(packed, dims)
    L = len(dims)
    acts = [activation] * (L - 1) + [final_activation]

    def aug(t, y, ay):
        B = y.shape[0]
        h = y
        for _ in range(input_power - 1):
            h = h * y
        if time_input:
            h = torch.cat([h, t.reshape(-1, 1).expand(B, 1)], dim=1)
        hs, zs = [], []
        for l, (wT, b) in enumerate(layers):
            hs.append(h)
            acc = None
            for i in range(wT.shape[1]):
                term = wT[:, i] * h[:, i:i + 1]              # [B, dout]
                acc = term if acc is None else acc + term
            zs.append(acc + b)
            h = _ACTIVATIONS[acts[l]](zs[-1])
        f = h
        dz = ay * _ACTIVATION_GRADS[acts[-1]](zs[-1], f)
        dzs = [None] * L
        for l in range(L - 1, -1, -1):
            dzs[l] = dz
            wT = layers[l][0]
            dh = None
            for o in range(wT.shape[0]):
                term = wT[o] * dz[:, o:o + 1]                # [B, din]
                dh = term if dh is None else dh + term
            dz = (dh * _ACTIVATION_GRADS[acts[l - 1]](zs[l - 1], hs[l])
                  if l > 0 else dh)
        D = y.shape[1]
        v_t = dz[:, D] if time_input else None
        v_y = dz[:, :D]
        if input_power > 1:
            yp = y
            for _ in range(input_power - 2):
                yp = yp * y
            v_y = v_y * (float(input_power) * yp)
        parts = []
        for l in range(L):
            parts.append((dzs[l][:, :, None] * hs[l][:, None, :])
                         .reshape(B, -1))                     # W^T layout
            parts.append(dzs[l])
        return f, v_y, torch.cat(parts, dim=1), v_t

    return aug


def _combine(dth: Tensor, ks, coeffs):
    """sum_j (dth * c_j) * k_j over the nonzero c_j, in stage order."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            term = (dth * c) * k
            acc = term if acc is None else acc + term
    return acc


def _sq_scaled(e: Tensor, v0: Tensor, v1: Tensor, rtol, atol) -> Tensor:
    esc = e / (atol + rtol * torch.maximum(torch.abs(v0), torch.abs(v1)))
    return esc * esc


def mlp_adjoint_solve_plain(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                            tau: Tensor, dt0, rtol, atol, sign, *,
                            activation: str = "tanh",
                            final_activation: str = "identity",
                            input_power: int = 1, time_input: bool = False,
                            seminorm: bool = False, method: str = "dopri5",
                            safety: float = 0.9, ifactor: float = 10.0,
                            dfactor: float = 0.2,
                            max_steps: int = 2 ** 31 - 1
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K3: a host loop of attempts that mirrors
    `csrc/adjoint_kernel.cu` line for line. Same contract as
    `mlp_adjoint_solve`."""
    tab = TABLEAUS_BY_NAME[method]
    dev, dtype = ys.device, ys.dtype
    T, B, D = ys.shape
    S = tab.stages
    tau_h, dt_min, dt0, _ = _solve_setup(tau, dt0, dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    rtol, atol, sf = on(rtol), on(atol), on(sign)
    sigma = on(-tau_h)
    aug = _aug_eval_plain(warrays, dims, activation, final_activation,
                          input_power, time_input)
    n_w = warrays.shape[0]
    n_el = 2 * D * B if seminorm else 2 * D * B + n_w + int(time_input)
    denom = torch.tensor(float(n_el), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    ay = torch.zeros((B, D), dtype=dtype, device=dev)
    aw = torch.zeros(n_w, dtype=dtype, device=dev)
    at = zero
    dt, dt_min = on(dt0), on(dt_min)
    nfe = nacc = nrej = status = 0
    for i in range(T - 1, 0, -1):
        y = ys[i]
        ay = ay + g[i]
        cy = torch.zeros_like(y)
        cay = torch.zeros_like(y)
        s, s_end = sigma[i], sigma[i - 1]
        s_h, s_end_h = -float(tau_h[i]), -float(tau_h[i - 1])
        while s_h < s_end_h and status == 0:
            rem = s_end - s
            s1 = torch.where(dt >= rem, s_end, s + torch.minimum(dt, rem))
            dth = s1 - s
            ky, kay, kw = [], [], []
            for st in range(S):
                yi, ayi = y, ay
                if st > 0:
                    for aij, kyj, kayj in zip(tab.a[st - 1], ky, kay):
                        if aij != 0.0:
                            yi = yi + (dth * aij) * kyj
                            ayi = ayi + (dth * aij) * kayj
                f, v_y, xw, v_t = aug((-sf) * (s + tab.c[st] * dth), yi,
                                      ayi)
                ky.append((-sf) * f)
                kay.append(sf * v_y)
                if time_input:
                    xw = torch.cat([xw, v_t[:, None]], dim=1)
                kw.append(sf * _lane_sums(xw))
            dy = _combine(dth, ky, tab.b_sol)
            day = _combine(dth, kay, tab.b_sol)
            y1, ay1 = y + dy, ay + day
            sq = torch.cat([
                _sq_scaled(_combine(dth, ky, tab.b_err), y, y1, rtol,
                           atol),
                _sq_scaled(_combine(dth, kay, tab.b_err), ay, ay1,
                           rtol, atol)], dim=1)
            ss = _owned_sums(sq, ADJOINT_THREADS)
            dw = _combine(dth, [k[:n_w] for k in kw], tab.b_sol)
            if not seminorm:
                ew = _combine(dth, [k[:n_w] for k in kw], tab.b_err)
                ss = _owned_sums(_sq_scaled(ew, aw, aw + dw, rtol,
                                            atol)[:, None],
                                 ADJOINT_THREADS, ss)
            total = _tree_sum(ss)
            d_at = zero
            if time_input:
                d_at = _combine(dth, [k[n_w] for k in kw], tab.b_sol)
                if not seminorm:
                    e_at = _combine(dth, [k[n_w] for k in kw],
                                    tab.b_err)
                    total = total + _sq_scaled(e_at, at, at + d_at, rtol,
                                               atol)
            ratio = torch.sqrt(total / denom)
            fin = (torch.isfinite(total) & torch.all(torch.isfinite(y1))
                   & torch.all(torch.isfinite(ay1)))
            # The attempt's one synchronisation.
            acc_h, fin_h, s1_h = torch.stack([
                ((ratio <= 1.0) & fin).to(torch.float64),
                fin.to(torch.float64), s1.to(torch.float64)]).tolist()
            accept, finite = bool(acc_h), bool(fin_h)
            fac = _controller_factor(ratio, finite, accept, safety, ifactor,
                                     dfactor, tab.order)
            dt_next = dth * fac
            if accept:
                adj = dy - cy
                y_new = y + adj
                cy = (y_new - y) - adj
                y = y_new
                adj = day - cay
                ay_new = ay + adj
                cay = (ay_new - ay) - adj
                ay = ay_new
                aw = aw + dw
                at = at + d_at
                s, s_h = s1, s1_h
            n_att = nacc + nrej + 1
            if status == 0 and not accept and bool(dt_next < dt_min):
                status = 2
            if status == 0 and n_att >= max_steps and s1_h < s_end_h:
                status = 1
            dt = dt_next
            nfe += S
            nacc += int(accept)
            nrej += int(not accept)
    stats = torch.tensor([nfe, nacc, nrej, status], dtype=torch.int32,
                         device=dev)
    return ay + g[0], aw, at, stats


def _work_size(dims, S: int, B: int, D: int) -> int:
    """csrc/adjoint_kernel.cu adjoint_work_size: state, compensation and
    increments of (y, a_y), S stage derivatives of each, and the per-stage
    reduction rows (layer inputs, pre-activations, their cotangents, v_t)."""
    rows = 1 + sum(din + 2 * dout for din, dout in dims)
    return (6 + 2 * S) * B * D + rows * B


def _shared_values(dims, S: int, time_input: bool) -> int:
    """Shared memory K3's narrow route needs, in values: the weights, the
    parameter accumulator and its increment, every stage's cotangents and
    the block-sum scratch."""
    n_w = sum(din * dout + dout for din, dout in dims)
    return (3 + S) * n_w + S * int(time_input) + ADJOINT_THREADS


def _wide_work_size(n_w: int, S: int, time_input: bool) -> int:
    """csrc/adjoint_kernel.cu adjoint_pwork_size: the wide route's parameter
    accumulator, its increment and the stage cotangents."""
    return 2 * n_w + S * (n_w + int(time_input))


def mlp_adjoint_solve(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                      tau: Tensor, dt0, rtol, atol, sign, *,
                      activation: str = "tanh",
                      final_activation: str = "identity",
                      input_power: int = 1, time_input: bool = False,
                      seminorm: bool = False, method: str = "dopri5",
                      safety: float = 0.9, ifactor: float = 10.0,
                      dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused adjoint backward sweep of an MLP neural ODE, one launch.

    warrays/dims: from `pack_mlp_weights`. ys, g: [T, B, D] forward
    trajectory and output cotangents at the observation times tau ([T],
    increasing canonical times; sign as in `mlp_solve`). dt0: first
    backward step (in sigma = -tau), clamped to the span-scaled minimum.
    seminorm: leave the parameter and time quadratures out of the step
    control. time_input: the first layer's last input is t, and the sweep
    also integrates the a_t quadrature. `method`: one of the five adaptive
    tableaus; every attempt evaluates all its stages.

    Returns (ay0 [B, D] = dL/dy0, aw [n_w] = dL/dweights in
    `pack_mlp_weights`' layout (W^T then b per layer), at (0-d, the
    integrated a_t quadrature; 0 when autonomous), stats [4] int32: nfe,
    accepted, rejected, status (0 OK, 1 MAX_STEPS_REACHED, 2 DT_UNDERFLOW)).
    """
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    _check_activations(activation, final_activation)
    if ys.ndim != 3 or g.shape != ys.shape:
        raise ValueError(f"ys and g must both be [T, B, D], got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input,
              seminorm=seminorm, method=method, safety=safety,
              ifactor=ifactor, dfactor=dfactor, max_steps=max_steps)
    if _device_kind(ys, g, warrays) == "cpu":
        return mlp_adjoint_solve_plain(warrays, dims, ys, g, tau, dt0, rtol,
                                       atol, sign, **kw)

    global mlp_adjoint_solve_launches
    dtype = ys.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_adjoint_solve takes float32 or float64, got "
                        f"{dtype}")
    T, B, D = ys.shape
    n_w = _check_mlp("mlp_adjoint_solve", warrays, dims, D, time_input)
    S = TABLEAUS_BY_NAME[method].stages
    route = _route("mlp_adjoint_solve", dims,
                   _shared_values(dims, S, time_input), ys.element_size())
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    for name, x in (("ys", ys), ("g", g), ("warrays", warrays)):
        _check_float(name, x, dtype)

    tau_h, dt_min, dt0, _ = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(ys.device)
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    c, a, b_sol, b_err = _tableau_args(tab)
    ay0 = torch.empty((B, D), dtype=dtype, device=ys.device)
    aw = torch.empty(n_w, dtype=dtype, device=ys.device)
    at = torch.empty((), dtype=dtype, device=ys.device)
    stats = torch.empty(4, dtype=torch.int32, device=ys.device)
    n_work = _work_size(dims, S, B, D)
    work = torch.empty(n_work, dtype=dtype, device=ys.device)
    n_pwork = (_wide_work_size(n_w, S, time_input) if route == ROUTE_WIDE
               else 0)
    pwork = torch.empty(n_pwork, dtype=dtype, device=ys.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_adjoint_f32 if dtype == torch.float32
          else lib.tfd_mlp_adjoint_f64)
    with torch.cuda.device(ys.device):
        err = fn(_ptr(tau_d), _ptr(ys), _ptr(g), _ptr(warrays), _ptr(ay0),
                 _ptr(aw), _ptr(at), _ptr(stats), _ptr(work), n_work, T, B,
                 D, ADJOINT_THREADS, float(dt0), float(rtol), float(atol),
                 float(dt_min), float(sign), float(safety), float(ifactor),
                 float(dfactor), int(min(max_steps, 2 ** 31 - 1)),
                 int(seminorm), len(dims), _dims_arg(dims),
                 _ACT_CODES[activation], _ACT_CODES[final_activation],
                 int(input_power), int(time_input), S, tab.order, c, a,
                 b_sol, b_err, route, _ptr(pwork), n_pwork,
                 _stream(ys.device))
    _build.check(err, "mlp_adjoint_solve launch")
    mlp_adjoint_solve_launches += 1
    return ay0, aw, at, stats
