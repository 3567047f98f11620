"""The per-sample tier's kernels: wrappers, launch counters and plain
PyTorch versions.

Counterpart of the per-lane kernels of `tfdiffeq_tpu/ops/pallas_kernels.py`
and `pallas_adjoint.py` (sources in `tfdiffeq_tpu_torch/csrc/`, built by
`_build.py`):

- K5 `mlp_solve_perlane` (csrc/perlane_solve_kernel.cu) replaces
  `_make_perlane_kernel` (pallas_kernels.py:929): a whole adaptive RK solve
  of a general MLP neural ODE in one launch, every sample under its own
  step controller.
- K6 `mlp_perlane_adjoint_solve` (csrc/perlane_adjoint_kernel.cu) replaces
  `_make_perlane_adjoint_kernel` (pallas_adjoint.py:681): the whole adjoint
  backward sweep, every sample under its own controller on (y, a_y).

No sample waits for another, so on the MLP routes K5 gives each sample a
group of threads under its own controller (PERLANE_GROUP on the narrow
route, 32 samples a block of PERLANE_SOLVE_THREADS; K8's wide group on the
wide one), and K6 a group of PERLANE_GROUP threads, 32 samples a block of
PERLANE_ADJOINT_THREADS. The wrappers take the plain versions only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. The plain versions step every sample together, each masked by its
own state (a host loop of attempts until no sample is active), with each
sample's arithmetic in its kernel thread's order: a float64 kernel run
takes every sample's steps exactly as its plain version does.

`mlp_solve_perlane_launches` and `mlp_perlane_adjoint_solve_launches` count
wrapper calls that launched their kernel; `reset_launch_counts()` zeroes
them. Both take the narrow or wide route of `cuda_kernels._route`; with a
reduced dot-precision tier K5 takes its tile engine (`mlp_solve_perlane`).
Not ported: `rhs='cnf'` (K7) and the TPU machinery of the reference (lane
padding, `n_blocks` grid blocks).
"""

from __future__ import annotations

import bisect
import ctypes
from typing import Tuple

import torch

from . import _build
from .cuda_adjoint import _aug_eval_plain, _combine, _sq_scaled
from . import cuda_fixed
from .cuda_fixed import (FIXED_GROUP_THREADS, _block_sums, _group_work_size,
                         _mlp_walk_values, _solve_work_size, _widest,
                         _wt_values)
from . import cuda_kernels
from .cuda_kernels import (ROUTE_BATCH, ROUTE_NARROW, _ACT_CODES,
                           _check_activations, _check_float, _check_mlp,
                           _controller_factor, _device_kind, _dims_arg,
                           _net_plain, _ptr, _rk_stages, _route,
                           _solve_setup, _stream, _tableau_args,
                           _tier_work_bytes, _tiers_arg)
from .rk import interp_fit_cubic_hermite, interp_fit_quartic
from .tableaus import TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: The samples of a K6 block, whose quadrature sums take a tree over them
#: (a power of two), and the threads per block of K14 in K5
#: (ops/cuda_plan.py: one sample a thread).
PERLANE_THREADS = 32
#: K6 (csrc/lane_group.h): the threads of a sample's group, and of a block
#: of PERLANE_THREADS groups (128 blocks of 16 warps at B = 4096).
PERLANE_GROUP = 16
PERLANE_ADJOINT_THREADS = PERLANE_GROUP * PERLANE_THREADS
#: K5's MLP routes (csrc/lane_group.h kGroupBlock): a block of
#: PERLANE_SOLVE_THREADS threads, a group of PERLANE_GROUP threads a sample
#: on the narrow route (32 samples a block: 128 blocks of 16 warps at
#: B = 4096) and of K8's wide group on the wide route (`perlane_group`).
PERLANE_SOLVE_THREADS = FIXED_GROUP_THREADS

#: K5's tile engine (csrc/rk_perlane.cuh kTileRows, kTileThreads): a block
#: of TILE_THREADS threads runs TILE_ROWS samples in lockstep, the route of
#: K4's tiers (the MLP's and a tiled plan's).
TILE_ROWS = 16
TILE_THREADS = 256

mlp_solve_perlane_launches = 0
mlp_perlane_adjoint_solve_launches = 0


def reset_launch_counts() -> None:
    global mlp_solve_perlane_launches, mlp_perlane_adjoint_solve_launches
    mlp_solve_perlane_launches = 0
    mlp_perlane_adjoint_solve_launches = 0


def _tableau(method: str):
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    return TABLEAUS_BY_NAME[method]


def _lane_setup(tau: Tensor, dt0, B: int, dtype, device):
    """perlane_solve_call's prologue (pallas_kernels.py:1130-1143): the
    host times, the span-scaled dt_min (a host 0-d tensor), each sample's
    first step clamped to it ([B] on `device`) and whether tau increases
    strictly."""
    tau_h, dt_min, _, valid = _solve_setup(tau, 0.0, dtype)
    # Straight to `dtype`: a Python float must not pass through float32.
    dt0 = torch.abs(torch.as_tensor(dt0, dtype=dtype, device=device)
                    .detach())
    if dt0.numel() not in (1, B):
        raise ValueError(f"dt0 must be one step or one a sample ({B}), got "
                         f"shape {tuple(dt0.shape)}")
    dt0 = torch.maximum(dt0.reshape(-1), dt_min.to(device)).expand(B)
    return tau_h, dt_min, dt0.contiguous(), valid


def _row_sums(sq: Tensor) -> Tensor:
    """Each sample's sum of sq [B, D] over its features, in order from the
    first (a kernel thread's order)."""
    ss = sq[:, 0]
    for d in range(1, sq.shape[1]):
        ss = ss + sq[:, d]
    return ss


def _stats(nfe, nacc, nrej, status) -> Tuple[Tensor, Tensor]:
    """(stats [4]: the sums of the counts and the largest status, lane_stats
    [4, B]), int32."""
    lane = torch.stack([nfe, nacc, nrej, status]).to(torch.int32)
    stats = torch.cat([lane[:3].sum(dim=1), lane[3].max()[None]])
    return stats.to(torch.int32), lane


# ---------------------------------------------------------------------------
# K5: the whole per-sample adaptive solve (pallas_kernels.py:929)
# ---------------------------------------------------------------------------

def perlane_group(route: int) -> int:
    """Threads a sample of K5 on an MLP route: PERLANE_GROUP on the narrow
    route, K8's `cuda_fixed.FIXED_WIDE_GROUP` on the wide one."""
    return (PERLANE_GROUP if route == ROUTE_NARROW
            else cuda_fixed.FIXED_WIDE_GROUP)


def _perlane_slot_values(S: int, D: int, dims) -> int:
    """csrc/lane_group.h perlane_solve_slot_values: K5's slot (state, FSAL
    derivative, compensation, increment, midpoint, end derivative, squared
    scaled errors, the S - 1 later stages, then the walk's two layer
    vectors)."""
    return (S + 6) * D + 2 * _widest(dims)


def mlp_solve_perlane_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                            dt0, rtol, atol, sign, *, f0: Tensor,
                            activation: str = "tanh",
                            final_activation: str = "identity",
                            input_power: int = 1, time_input: bool = False,
                            method: str = "dopri5", safety: float = 0.9,
                            ifactor: float = 10.0, dfactor: float = 0.2,
                            max_steps: int = 2 ** 31 - 1, tiers=None
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K5: a host loop of attempts in which every
    active sample takes its own attempt, the others masked out (one
    synchronisation an attempt), each layer at its tier (`_net_plain`).
    Same contract as `mlp_solve_perlane`, except that f0 is required."""
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    raw_f = _net_plain(warrays, dims, activation, final_activation,
                       input_power, time_input, tiers)

    def f(s, y):
        # Canonical dynamics g(tau, y) = sign * f(sign * tau, y); s is a
        # [B, 1] column of each sample's time.
        return sgn * raw_f(sgn * s, y)

    return perlane_solve_plain(f, y0, f0, tau, dt0, rtol, atol,
                               _tableau(method), safety=safety,
                               ifactor=ifactor, dfactor=dfactor,
                               max_steps=max_steps)


def perlane_solve_plain(f, y0: Tensor, f0: Tensor, tau: Tensor, dt0, rtol,
                        atol, tab, *, safety: float, ifactor: float,
                        dfactor: float, max_steps: int
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """K5's engine (`_make_perlane_kernel`) as a host loop of attempts in
    which every active sample takes its own attempt, the others masked
    out: f(s, y) is the canonical (signed) right-hand side on y0's [B, D]
    layout at the samples' times s, a [B, 1] column. Returns (out
    [T, B, D], stats [4], lane_stats [4, B])."""
    dev, dtype = y0.device, y0.dtype
    B, D = y0.shape
    T = tau.shape[0]
    tau_h, dt_min, dt, valid = _lane_setup(tau, dt0, B, dtype, dev)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    tau_d = on(tau_h)
    rtol, atol = on(rtol), on(atol)

    tau_list = tau_h.tolist()
    out = torch.zeros((T, B, D), dtype=dtype, device=dev)
    out[0] = y0
    t_end = tau_d[T - 1]
    t = tau_d[0].expand(B, 1).clone()
    dt = dt[:, None]
    y, fy, comp = y0, f0, torch.zeros_like(y0)
    denom, dt_min = on(float(D)), on(dt_min)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    nfe, nacc, nrej = zeros, zeros, zeros
    ok = float(tau_h[-1]) > float(tau_h[0]) and valid
    status = zeros if ok else zeros + 3
    while True:
        active = (t[:, 0] < t_end) & (status == 0)
        if not bool(active.any()):
            break
        act = active[:, None]
        rem = t_end - t
        t1 = torch.where(dt >= rem, t_end, t + torch.minimum(dt, rem))
        # Inactive samples step with a dummy dt of 1 so that their masked
        # arithmetic stays finite (pallas_kernels.py:1012-1015).
        dth = torch.where(act, t1 - t, torch.ones_like(t))

        k, delta, err, y_mid = _rk_stages(tab, f, y, fy, dth, t0=t)
        y1 = y + delta
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        esc = err / scale
        ss = _row_sums(esc * esc)
        ratio = torch.sqrt(ss / denom)
        finite = torch.isfinite(ss) & torch.isfinite(y1).all(dim=1)
        acc_raw = (ratio <= 1.0) & finite
        accept = acc_raw & active
        fac = _controller_factor(ratio, finite, acc_raw, safety, ifactor,
                                  dfactor, tab.order)
        dt_next = torch.where(act, dth * fac[:, None], dt)

        acc = accept[:, None]
        f1 = k[-1] if tab.fsal else f(t1, y1)
        if y_mid is not None:
            ca, cb, cc, df0, _ = interp_fit_quartic(y, y1, y_mid, k[0], f1,
                                                    dth)
        else:
            ca, cb, cc, df0, _ = interp_fit_cubic_hermite(y, y1, k[0], f1,
                                                          dth)
        adj = delta - comp
        y_new = y + adj
        comp = torch.where(acc, (y_new - y) - adj, comp)
        # Drain every requested time in an accepting sample's (t, t1],
        # exactly y_new at t1: rows past the earliest accepting t, up to
        # the latest accepted t1.
        inf = torch.full_like(ss, float("inf"))
        t_lo, t_hi = torch.stack([
            torch.where(accept, t[:, 0], inf).min(),
            torch.where(accept, t1[:, 0], -inf).max()]).tolist()
        for o in range(max(1, bisect.bisect_right(tau_list, t_lo)),
                       bisect.bisect_right(tau_list, t_hi)):
            tj = tau_d[o]
            m = acc & (tj > t) & (tj <= t1)
            x = (tj - t) / dth
            val = (((ca * x + cb) * x + cc) * x + df0) * x + y
            val = torch.where(tj == t1, y_new, val)
            out[o] = torch.where(m, val, out[o])
        y = torch.where(acc, y_new, y)
        fy = torch.where(acc, f1, fy)
        t = torch.where(acc, t1, t)

        nfe = nfe + tab.evals_per_step * active
        nacc = nacc + accept
        nrej = nrej + (active & ~accept)
        status = torch.where(active & ~acc_raw & (dt_next[:, 0] < dt_min)
                             & (status == 0), 2, status)
        status = torch.where((nacc + nrej >= max_steps) & (t[:, 0] < t_end)
                             & (status == 0), 1, status)
        dt = dt_next
    stats, lane = _stats(nfe, nacc, nrej, status)
    return out, stats, lane


def mlp_solve_perlane(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0,
                      rtol, atol, sign, *, f0: Tensor = None,
                      activation: str = "tanh",
                      final_activation: str = "identity",
                      input_power: int = 1, time_input: bool = False,
                      method: str = "dopri5", safety: float = 0.9,
                      ifactor: float = 10.0, dfactor: float = 0.2,
                      max_steps: int = 2 ** 31 - 1, tiers=None
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Whole-solve fused adaptive RK for a general MLP neural ODE with a
    step controller per sample, one kernel launch: each sample's stages,
    error norm (the RMS over its D features), controller decisions,
    counters, status and dense-output writes.

    tiers: each layer's dot precision (`cuda_kernels.layer_tiers`); with a
    reduced one K5 takes its tile route (csrc/rk_perlane.cuh
    rk_perlane_tile_kernel: TILE_ROWS samples a block in lockstep, each
    under its own controller, every stage evaluated for the block's tile
    by K4, the tier layers on the tensor cores in float32), two launches
    (the bf16 weight pack and the solve) that `mlp_solve_perlane_launches`
    and `cuda_kernels.dot_tier_launches` count once each.

    warrays/dims: from `pack_mlp_weights`; the network, `method` and the
    controller constants as in `cuda_kernels.mlp_solve`. y0: [B, D]; tau:
    [T] increasing canonical times (tau = sign * t); sign: +1 or -1; dt0:
    each sample's first step ([B]) or one for all, clamped to the
    span-scaled minimum; f0: the signed derivative at (tau[0], y0),
    computed here when None.

    Returns (out [T, B, D], stats [4] int32: nfe, accepted and rejected
    summed over the samples, and the largest status; lane_stats [4, B]
    int32: each sample's nfe, accepted, rejected and status), all on y0's
    device. A sample's status: 0 OK, 1 MAX_STEPS_REACHED (its own attempts
    reached max_steps), 2 DT_UNDERFLOW; 3 INVALID_TIMES on every sample
    when tau does not increase strictly. The rows a sample never reaches
    stay zero.
    """
    tab = _tableau(method)
    _check_activations(activation, final_activation)
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [B, D], got {tuple(y0.shape)}")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    dtype = y0.dtype
    if f0 is None:
        sgn = torch.as_tensor(sign, dtype=dtype).to(y0.device)
        tau0 = torch.as_tensor(tau[0], dtype=dtype).to(y0.device)
        f0 = sgn * _net_plain(warrays, dims, activation, final_activation,
                              input_power, time_input)(sgn * tau0, y0)
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input, method=method,
              safety=safety, ifactor=ifactor, dfactor=dfactor,
              max_steps=max_steps, tiers=tiers)
    if _device_kind(y0, f0, warrays) == "cpu":
        return mlp_solve_perlane_plain(warrays, dims, y0, tau, dt0, rtol,
                                       atol, sign, f0=f0, **kw)

    global mlp_solve_perlane_launches
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_solve_perlane takes float32 or float64, got "
                        f"{dtype}")
    B, D = y0.shape
    T = tau.shape[0]
    n_w = _check_mlp("mlp_solve_perlane", warrays, dims, D, time_input,
                     tiers)
    route = _route("mlp_solve_perlane", dims, n_w, y0.element_size(), tiers,
                   input_values=T)
    for name, x in (("y0", y0), ("f0", f0), ("warrays", warrays)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")

    # Named, so that they live until the launch has read them.
    tau_h, dt_min, dt0_d, valid = _lane_setup(tau, dt0, B, dtype, y0.device)
    tau_d = tau_h.to(y0.device)
    S = tab.stages
    c, a, b_sol, b_err = _tableau_args(tab)
    c_mid = (None if tab.c_mid is None
             else (ctypes.c_double * S)(*tab.c_mid))
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    lane = torch.empty((4, B), dtype=torch.int32, device=y0.device)
    tile = route == ROUTE_BATCH
    batch_work = None
    if tile:
        group, threads = 0, TILE_THREADS
        n_work = (S + 6) * B * D
        batch_work = torch.empty(
            _tier_work_bytes(dims, -(-B // TILE_ROWS) * TILE_ROWS,
                             y0.element_size()),
            dtype=torch.uint8, device=y0.device)
    else:
        group, threads = perlane_group(route), PERLANE_SOLVE_THREADS
        n_work = _solve_work_size(_perlane_slot_values(S, D, dims), B, group,
                                  _wt_values(route, n_w))
    work = torch.empty(n_work, dtype=dtype, device=y0.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_perlane_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_perlane_f64)
    with torch.cuda.device(y0.device):
        err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(dt0_d), _ptr(warrays),
                 _ptr(out), _ptr(lane), _ptr(stats), _ptr(work), n_work, T,
                 B, D, threads, group, float(rtol),
                 float(atol), float(dt_min),
                 float(sign), float(safety), float(ifactor), float(dfactor),
                 int(min(max_steps, 2 ** 31 - 1)), int(valid), len(dims),
                 _dims_arg(dims), _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), S, tab.order, int(tab.fsal), c, a, b_sol,
                 b_err, c_mid, route, _tiers_arg(tiers),
                 _ptr(batch_work) if tile else None,
                 batch_work.numel() if tile else 0, _stream(y0.device))
    _build.check(err, "mlp_solve_perlane launch")
    mlp_solve_perlane_launches += 1
    cuda_kernels.dot_tier_launches += tile
    return out, stats, lane


# ---------------------------------------------------------------------------
# K6: the whole per-sample adjoint sweep (pallas_adjoint.py:681)
# ---------------------------------------------------------------------------

def mlp_perlane_adjoint_solve_plain(warrays: Tensor, dims, ys: Tensor,
                                    g: Tensor, tau: Tensor, dt0, rtol, atol,
                                    sign, *, activation: str = "tanh",
                                    final_activation: str = "identity",
                                    input_power: int = 1,
                                    time_input: bool = False,
                                    method: str = "dopri5",
                                    safety: float = 0.9,
                                    ifactor: float = 10.0,
                                    dfactor: float = 0.2,
                                    max_steps: int = 2 ** 31 - 1):
    """Plain PyTorch version of K6, in the kernel's arithmetic order. Same
    contract as `mlp_perlane_adjoint_solve`.

    Order of the quadratures: each sample gathers its trial's weighted
    stage terms, (dt b_j) (sign x_j) over the stages in order, into its
    STEP row, and adds STEP to its running sum only when it accepts; the
    per-sample sums meet over the batch once, at the end, in
    `cuda_fixed._block_sums`' order. (The reference sums each stage over
    the batch first, so the two agree to roundoff.)
    """
    aug = _aug_eval_plain(warrays, dims, activation, final_activation,
                          input_power, time_input)
    ay0, aw, at, _, stats, lane = perlane_adjoint_plain(
        lambda t, y, ay: aug(t, y, ay) + (None,), warrays.shape[0],
        time_input, 0, ys, g, tau, dt0, rtol, atol, sign, method=method,
        safety=safety, ifactor=ifactor, dfactor=dfactor,
        max_steps=max_steps)
    return ay0, aw, at, stats, lane


def perlane_adjoint_plain(aug, n_w: int, time_input: bool, n_ps: int,
                          ys: Tensor, g: Tensor, tau: Tensor, dt0, rtol,
                          atol, sign, *, method: str = "dopri5",
                          safety: float = 0.9, ifactor: float = 10.0,
                          dfactor: float = 0.2,
                          max_steps: int = 2 ** 31 - 1):
    """K6's engine in plain PyTorch, on a right-hand side `aug(t, y, a_y)`
    -> (f, v_y, xw [B, n_w], v_t [B] or None, xs [B, n_ps] or None), as
    `cuda_adjoint.adjoint_sweep_plain`'s. A sample's STEP row holds its
    shared quadratures (v_t's last) and then its per-sample ones; only the
    shared ones meet over the batch at the end.

    Returns (ay0, aw [n_w], at, aps [B, n_ps], stats, lane_stats)."""
    tab = _tableau(method)
    dev, dtype = ys.device, ys.dtype
    T, B, D = ys.shape
    S = tab.stages
    tau_h, dt_min, dt, _ = _lane_setup(tau, dt0, B, dtype, dev)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    rtol, atol, sf = on(rtol), on(atol), on(sign)
    sigma = on(-tau_h)
    denom, dt_min = on(float(2 * D)), on(dt_min)
    R = n_w + int(time_input)

    ay = torch.zeros((B, D), dtype=dtype, device=dev)
    acc = torch.zeros((B, R + n_ps), dtype=dtype, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    nfe, nacc, nrej, status = zeros, zeros, zeros, zeros
    for i in range(T - 1, 0, -1):
        y = ys[i]
        ay = ay + g[i]
        cy = torch.zeros_like(y)
        cay = torch.zeros_like(y)
        s_end = sigma[i - 1]
        s = sigma[i].expand(B).clone()
        while True:
            active = (s < s_end) & (status == 0)
            if not bool(active.any()):
                break
            rem = s_end - s
            s1 = torch.where(dt >= rem, s_end, s + torch.minimum(dt, rem))
            dth = torch.where(active, s1 - s, torch.ones_like(s))
            h = dth[:, None]
            ky, kay, step = [], [], None
            for st in range(S):
                yi, ayi = y, ay
                if st > 0:
                    for aij, kyj, kayj in zip(tab.a[st - 1], ky, kay):
                        if aij != 0.0:
                            yi = yi + (h * aij) * kyj
                            ayi = ayi + (h * aij) * kayj
                f, v_y, xw, v_t, xs = aug((-sf) * (s + tab.c[st] * dth),
                                          yi, ayi)
                ky.append((-sf) * f)
                kay.append(sf * v_y)
                if tab.b_sol[st] != 0.0:
                    xw = torch.cat([xw] + ([v_t[:, None]] if time_input
                                           else [])
                                   + ([xs] if n_ps else []), dim=1)
                    term = (h * tab.b_sol[st]) * (sf * xw)
                    step = term if step is None else step + term
            dy = _combine(h, ky, tab.b_sol)
            day = _combine(h, kay, tab.b_sol)
            y1, ay1 = y + dy, ay + day
            ss = (_row_sums(_sq_scaled(_combine(h, ky, tab.b_err), y, y1,
                                       rtol, atol))
                  + _row_sums(_sq_scaled(_combine(h, kay, tab.b_err), ay,
                                         ay1, rtol, atol)))
            ratio = torch.sqrt(ss / denom)
            finite = (torch.isfinite(ss) & torch.isfinite(y1).all(dim=1)
                      & torch.isfinite(ay1).all(dim=1))
            acc_raw = (ratio <= 1.0) & finite
            accept = acc_raw & active
            fac = _controller_factor(ratio, finite, acc_raw, safety,
                                      ifactor, dfactor, tab.order)
            dt_next = torch.where(active, dth * fac, dt)

            a2 = accept[:, None]
            adj = dy - cy
            y_new = y + adj
            cy = torch.where(a2, (y_new - y) - adj, cy)
            y = torch.where(a2, y_new, y)
            adj = day - cay
            ay_new = ay + adj
            cay = torch.where(a2, (ay_new - ay) - adj, cay)
            ay = torch.where(a2, ay_new, ay)
            # Only an accepted trial's quadrature joins the running sums.
            acc = torch.where(a2, acc + step, acc)
            s = torch.where(accept, s1, s)

            nfe = nfe + S * active
            nacc = nacc + accept
            nrej = nrej + (active & ~accept)
            status = torch.where(active & ~acc_raw & (dt_next < dt_min)
                                 & (status == 0), 2, status)
            status = torch.where((nacc + nrej >= max_steps) & (s < s_end)
                                 & (status == 0), 1, status)
            dt = dt_next
    total = _block_sums(acc[:, :R], PERLANE_THREADS)
    at = total[n_w] if time_input else torch.zeros((), dtype=dtype,
                                                    device=dev)
    stats, lane = _stats(nfe, nacc, nrej, status)
    return ay + g[0], total[:n_w], at, acc[:, R:], stats, lane


def _adjoint_work_size(dims, S: int, B: int, D: int,
                       time_input: bool) -> int:
    """The MLP routes' workspace of K6 (`_group_work_size` with the
    parameter and a_t quadratures and the MLP walk's values)."""
    R = sum(din * dout + dout for din, dout in dims) + int(time_input)
    return _group_work_size(S, B, D, R, _mlp_walk_values(dims, D))


def mlp_perlane_adjoint_solve(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                              tau: Tensor, dt0, rtol, atol, sign, *,
                              activation: str = "tanh",
                              final_activation: str = "identity",
                              input_power: int = 1, time_input: bool = False,
                              method: str = "dopri5", safety: float = 0.9,
                              ifactor: float = 10.0, dfactor: float = 0.2,
                              max_steps: int = 2 ** 31 - 1):
    """Fused adjoint backward sweep of an MLP neural ODE with a step
    controller per sample, one launch.

    For each observation interval in reverse, y is reset to ys[i] and g[i]
    joins a_y; then every sample takes its own adaptive steps on (y, a_y)
    in sigma = -tau, with the MLP forward and its VJP in every stage, under
    the (y, a_y) seminorm (always: the parameter quadrature is shared by
    the batch and cannot drive a sample's control); its dt carries over
    from one interval to the next. Each sample adds the parameter (and,
    with `time_input`, the a_t) quadrature of its accepted steps only; the
    batch sums come at the end in a fixed order (the same bits on every
    run), a second small launch of the same wrapper call.

    warrays/dims: from `pack_mlp_weights`; ys, g: [T, B, D] forward
    trajectory and output cotangents at the canonical times tau ([T],
    increasing; sign as in `mlp_solve_perlane`); dt0: each sample's first
    backward step ([B]) or one for all, clamped to the span-scaled minimum.
    Returns (ay0 [B, D] = dL/dy0, aw [n_w] = dL/dweights in
    `pack_mlp_weights`' layout, at (0-d; 0 when autonomous), stats [4]
    int32: the samples' nfe, accepted and rejected summed and the largest
    status, lane_stats [4, B] int32). A failed sample (status 1 or 2) stays
    inactive for the rest of the sweep.
    """
    tab = _tableau(method)
    _check_activations(activation, final_activation)
    if ys.ndim != 3 or g.shape != ys.shape:
        raise ValueError(f"ys and g must both be [T, B, D], got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input, method=method,
              safety=safety, ifactor=ifactor, dfactor=dfactor,
              max_steps=max_steps)
    if _device_kind(ys, g, warrays) == "cpu":
        return mlp_perlane_adjoint_solve_plain(warrays, dims, ys, g, tau,
                                               dt0, rtol, atol, sign, **kw)

    global mlp_perlane_adjoint_solve_launches
    dtype = ys.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_perlane_adjoint_solve takes float32 or "
                        f"float64, got {dtype}")
    T, B, D = ys.shape
    n_w = _check_mlp("mlp_perlane_adjoint_solve", warrays, dims, D,
                     time_input)
    route = _route("mlp_perlane_adjoint_solve", dims,
                   n_w + PERLANE_THREADS, ys.element_size())
    for name, x in (("ys", ys), ("g", g), ("warrays", warrays)):
        _check_float(name, x, dtype)

    S = tab.stages
    c, a, b_sol, b_err = _tableau_args(tab)
    R = n_w + int(time_input)
    n_blk = -(-B // PERLANE_THREADS)
    # Named, so that they live until the launch has read them.
    tau_h, dt_min, dt0_d, _ = _lane_setup(tau, dt0, B, dtype, ys.device)
    tau_d = tau_h.to(ys.device)
    ay0 = torch.empty((B, D), dtype=dtype, device=ys.device)
    aw = torch.empty(n_w, dtype=dtype, device=ys.device)
    at = torch.empty((), dtype=dtype, device=ys.device)
    stats = torch.empty(4, dtype=torch.int32, device=ys.device)
    lane = torch.empty((4, B), dtype=torch.int32, device=ys.device)
    partial = torch.empty(n_blk * R, dtype=dtype, device=ys.device)
    n_work = _adjoint_work_size(dims, S, B, D, time_input)
    work = torch.empty(n_work, dtype=dtype, device=ys.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_perlane_adjoint_f32 if dtype == torch.float32
          else lib.tfd_mlp_perlane_adjoint_f64)
    with torch.cuda.device(ys.device):
        err = fn(_ptr(tau_d), _ptr(ys), _ptr(g), _ptr(dt0_d), _ptr(warrays),
                 _ptr(ay0), _ptr(aw), _ptr(at), _ptr(lane), _ptr(stats),
                 _ptr(partial), _ptr(work), n_work, T, B, D,
                 PERLANE_ADJOINT_THREADS, float(rtol), float(atol),
                 float(dt_min),
                 float(sign), float(safety), float(ifactor), float(dfactor),
                 int(min(max_steps, 2 ** 31 - 1)), len(dims),
                 _dims_arg(dims), _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), S, tab.order, c, a, b_sol, b_err, route,
                 _stream(ys.device))
    _build.check(err, "mlp_perlane_adjoint_solve launch")
    mlp_perlane_adjoint_solve_launches += 1
    return ay0, aw, at, stats, lane
