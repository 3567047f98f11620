"""The fused tier's hand-written CUDA kernels: wrappers, launch counters
and plain PyTorch versions.

Counterpart of `tfdiffeq_tpu/ops/pallas_kernels.py` for the two kernels of
the main path (sources in `tfdiffeq_tpu_torch/csrc/`, built by `_build.py`):

- K1 `dopri5_mlp_step` (csrc/step_kernel.cu) replaces `_make_step_kernel`
  (pallas_kernels.py:614): one dopri5 step of the tanh-MLP neural ODE.
- K2 `mlp_solve` (csrc/solve_kernel.cu) replaces `_make_solve_kernel`
  (pallas_kernels.py:726): a whole adaptive RK solve of a general MLP
  neural ODE in one launch.

Each wrapper takes the kernel's plain PyTorch version (`*_plain`, beside it
here) only for tensors on the CPU, where there is no kernel; a CUDA tensor
launches the kernel or raises, never falls back. The plain versions follow
the JAX kernels operation for operation, on the batch-major [B, D] layout
of the public functions: the TPU kernels' feature-major [D, B] layout and
their sublane packing, VMEM budgets, grid blocks and streamed output are
TPU machinery with no counterpart here.

`dopri5_mlp_step_launches` and `mlp_solve_launches` count kernel launches
(never plain-version calls); `reset_launch_counts()` zeroes them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .rk import interp_fit_cubic_hermite, interp_fit_quartic
from .tableaus import DOPRI5, TABLEAUS_BY_NAME, ButcherTableau

Tensor = torch.Tensor

#: Widest layer (state, state + time column, hidden) of the K2 MLP and
#: deepest MLP (csrc/mlp_rk.cuh kMaxWidth, kMaxLayers).
MAX_WIDTH = 128
MAX_LAYERS = 8
#: Widest state of K1 (csrc/step_kernel.cu kStepMaxD).
STEP_MAX_D = 16
#: Threads per K1 block; each block writes one partial error sum.
STEP_THREADS = 256
#: Threads of K2's one block (at most csrc/solve_kernel.cu kSolveThreads).
SOLVE_THREADS = 512
#: Shared memory K2 may give the packed weights (the card has 227 KB per
#: block; 4 KB stay for the reduction and the tableau).
MAX_WEIGHT_BYTES = 220 * 1024

dopri5_mlp_step_launches = 0
mlp_solve_launches = 0


def reset_launch_counts() -> None:
    global dopri5_mlp_step_launches, mlp_solve_launches
    dopri5_mlp_step_launches = 0
    mlp_solve_launches = 0


def _elu(x: Tensor) -> Tensor:
    return torch.where(x > 0.0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _softplus(x: Tensor) -> Tensor:
    return (torch.clamp(x, min=0.0)
            + torch.log1p(torch.exp(-torch.abs(x))))


def _silu(x: Tensor) -> Tensor:
    return x / (1.0 + torch.exp(-x))


#: pallas_kernels.py:_ACTIVATIONS, the same formulas in PyTorch.
_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp(x, min=0.0),
    "elu": _elu,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "softplus": _softplus,
    "silu": _silu,
    "swish": _silu,
}

#: Activation name -> csrc/mlp_rk.cuh `Act` code.
_ACT_CODES = {"identity": 0, "linear": 0, "tanh": 1, "relu": 2, "elu": 3,
              "sigmoid": 4, "softplus": 5, "silu": 6, "swish": 6}


def _device_kind(*tensors: Tensor) -> str:
    dev = tensors[0].device
    for x in tensors[1:]:
        if x.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type


def _check_float(name: str, x: Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _tree_sum(v: Tensor) -> Tensor:
    """Sum the last axis (a power of two) in the kernels' fixed tree
    order (csrc/mlp_rk.cuh block_sum): red[i] += red[i + s] for s = n/2,
    n/4, ..., 1."""
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def _owned_sums(sq: Tensor, threads: int) -> Tensor:
    """Per-thread sums of sq [B, D] as the kernels take them: thread i
    owns samples i, i + threads, ... and adds their D values in order,
    from 0. Returns [threads]; missing samples add +0, which changes no
    bit."""
    B, D = sq.shape
    K = -(-B // threads)
    sq = torch.nn.functional.pad(sq, (0, 0, 0, K * threads - B))
    sq = sq.view(K, threads, D)
    acc = torch.zeros(threads, dtype=sq.dtype, device=sq.device)
    for k in range(K):
        for d in range(D):
            acc = acc + sq[k, :, d]
    return acc


def _count(y: Tensor) -> Tensor:
    """y.numel() as a 0-d tensor on y's device: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal, which is not the division
    the kernels and the JAX reference perform."""
    return torch.tensor(float(y.numel()), dtype=y.dtype, device=y.device)


# ---------------------------------------------------------------------------
# The Pallas kernels' stage walk (pallas_kernels.py:_rk_stages), for the
# plain versions. It is not ops/rk.runge_kutta_step: the kernels accumulate
# each stage state term by term, the generic engine sums the terms first,
# and each side is held step for step to its own reference.
# ---------------------------------------------------------------------------

def _rk_stages(tab: ButcherTableau, f, y0: Tensor, f0: Tensor, dt: Tensor,
               t0=0.0):
    """All stages and the solution, error and midpoint combines, each
    stage state accumulated as yi + (dt * a_ij) * k_j. Returns
    (k, delta, err, y_mid) with y1 = y0 + delta; y_mid is None for
    tableaus without midpoint weights."""
    k = [f0]
    for i in range(1, tab.stages):
        yi = y0
        for aij, kj in zip(tab.a[i - 1], k):
            if aij != 0.0:
                yi = yi + (dt * aij) * kj
        k.append(f(t0 + tab.c[i] * dt, yi))

    def combine(coeffs, start):
        acc = start
        for c, kj in zip(coeffs, k):
            if c != 0.0:
                acc = (dt * c) * kj if acc is None else acc + (dt * c) * kj
        return acc

    delta = combine(tab.b_sol, None)
    err = combine(tab.b_err, None)
    y_mid = combine(tab.c_mid, y0) if tab.c_mid is not None else None
    return k, delta, err, y_mid


def _controller_factor(ratio, finite: bool, accept: bool, safety: float,
                       ifactor: float, dfactor: float, order: int):
    """pallas_kernels.py:_controller_factor on 0-d tensors: r ** (-1/order)
    as exp(log), clipped to [1, ifactor] on accept, [dfactor, 1] on
    reject."""
    tiny = torch.tensor(1e-38, dtype=ratio.dtype, device=ratio.device)
    r = torch.maximum(ratio if finite else torch.full_like(ratio, 2.0 ** 20),
                      tiny)
    fac = safety * torch.exp((-1.0 / float(order)) * torch.log(r))
    fac = torch.where(ratio <= 0.0, torch.full_like(fac, ifactor), fac)
    lo, hi = (1.0, ifactor) if accept else (dfactor, 1.0)
    return torch.clamp(torch.clamp(fac, min=lo), max=hi)


# ---------------------------------------------------------------------------
# K1: one dopri5 step of the tanh-MLP (pallas_kernels.py:614)
# ---------------------------------------------------------------------------

def _mlp_tanh_plain(params: dict, y: Tensor) -> Tensor:
    """pallas_kernels.py:_make_mlp on [B, D]: the first layer sums its D
    input terms in order, the second sums over the hidden units."""
    w1, b1, w2, b2 = params["w1"], params["b1"], params["w2"], params["b2"]
    y3 = y * y * y
    acc = None
    for i in range(y.shape[1]):
        term = w1[i] * y3[:, i:i + 1]                       # [B, H]
        acc = term if acc is None else acc + term
    h = torch.tanh(acc + b1)
    # The hidden sum in the kernel's order (the reference leaves it to
    # jnp.sum), so that kernel and plain version agree to the bit.
    out = None
    for j in range(h.shape[1]):
        term = h[:, j:j + 1] * w2[j]                        # [B, D]
        out = term if out is None else out + term
    return out + b2


def _step_scalars(y: Tensor, dt, rtol, atol):
    as_t = lambda v: torch.as_tensor(v, dtype=y.dtype).to(y.device)
    return as_t(dt), as_t(rtol), as_t(atol)


def dopri5_mlp_step_plain(params: dict, y: Tensor, f0: Tensor, dt, rtol,
                          atol) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K1. Same contract as `dopri5_mlp_step`."""
    dt, rtol, atol = _step_scalars(y, dt, rtol, atol)
    k, delta, err, y_mid = _rk_stages(
        DOPRI5, lambda t, yy: _mlp_tanh_plain(params, yy), y, f0, dt)
    y1 = y + delta
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    esc = err / scale
    # Per-block partial sums in the kernel's order, +inf for a block whose
    # sum or y1 is not finite (pallas_kernels.py:646-648 per tile).
    n_blocks = -(-y.shape[0] // STEP_THREADS)
    part = _tree_sum(_owned_sums(esc * esc, n_blocks * STEP_THREADS)
                     .view(n_blocks, STEP_THREADS))
    bad = ~torch.isfinite(y1).all(dim=1)
    bad = torch.nn.functional.pad(bad, (0, n_blocks * STEP_THREADS
                                        - y.shape[0]))
    ok = torch.isfinite(part) & ~bad.view(n_blocks, STEP_THREADS).any(dim=1)
    part = torch.where(ok, part, torch.full_like(part, float("inf")))
    return y1, k[-1], torch.sqrt(torch.sum(part) / _count(y)), y_mid


def dopri5_mlp_step(params: dict, y: Tensor, f0: Tensor, dt, rtol, atol
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One fused dopri5 step of f(y) = tanh(y^3 W1 + b1) W2 + b2.

    params: {'w1': [D, H], 'b1': [H], 'w2': [H, D], 'b2': [D]}; y, f0:
    [B, D] state and its derivative (batch-major, where the JAX kernel is
    feature-major). Returns (y1, f1, err_ratio, y_mid): y1, the FSAL
    derivative f1 and the 4th-order midpoint are [B, D]; err_ratio is the
    0-d RMS of err / (atol + rtol max(|y0|, |y1|)), +inf when the step is
    not finite (accept iff <= 1).
    """
    kind = _device_kind(y, f0, *params.values())
    if kind == "cpu":
        return dopri5_mlp_step_plain(params, y, f0, dt, rtol, atol)
    global dopri5_mlp_step_launches
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dopri5_mlp_step takes float32 or float64, got "
                        f"{y.dtype}")
    if y.ndim != 2:
        raise ValueError(f"y must be [B, D], got {tuple(y.shape)}")
    B, D = y.shape
    H = params["w1"].shape[1]
    if D > STEP_MAX_D:
        raise ValueError(f"dopri5_mlp_step supports states up to "
                         f"STEP_MAX_D={STEP_MAX_D} features, got {D}")
    shapes = {"w1": (D, H), "b1": (H,), "w2": (H, D), "b2": (D,)}
    for name, shape in shapes.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"params[{name!r}] has shape "
                             f"{tuple(params[name].shape)}, expected {shape}")
        _check_float(name, params[name], y.dtype)
    _check_float("y", y, y.dtype)
    _check_float("f0", f0, y.dtype)
    if f0.shape != y.shape:
        raise ValueError("f0 must have the shape of y")
    smem = y.element_size() * (2 * D * H + H + D + STEP_THREADS)
    if smem > MAX_WEIGHT_BYTES:
        raise ValueError(f"dopri5_mlp_step: hidden width {H} needs {smem} "
                         f"bytes of shared memory, above {MAX_WEIGHT_BYTES}")
    lib = _build.library()
    y1 = torch.empty_like(y)
    f1 = torch.empty_like(y)
    ymid = torch.empty_like(y)
    n_blocks = -(-B // STEP_THREADS)
    partial = torch.empty(n_blocks, dtype=y.dtype, device=y.device)
    coeffs = [x for row in DOPRI5.a for x in row + (0.0,) * (6 - len(row))]
    coeffs += list(DOPRI5.b_sol) + list(DOPRI5.b_err) + list(DOPRI5.c_mid)
    coeffs = (ctypes.c_double * len(coeffs))(*coeffs)
    fn = (lib.tfd_dopri5_mlp_step_f32 if y.dtype == torch.float32
          else lib.tfd_dopri5_mlp_step_f64)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(f0), _ptr(params["w1"]), _ptr(params["b1"]),
                 _ptr(params["w2"]), _ptr(params["b2"]), _ptr(y1), _ptr(f1),
                 _ptr(ymid), _ptr(partial), B, D, H, STEP_THREADS, float(dt),
                 float(rtol), float(atol), coeffs, _stream(y.device))
    _build.check(err, "dopri5_mlp_step launch")
    dopri5_mlp_step_launches += 1
    # RMS over the D * B elements; a +inf partial (non-finite block)
    # survives the sum.
    ratio = torch.sqrt(torch.sum(partial) / _count(y))
    return y1, f1, ratio, ymid


# ---------------------------------------------------------------------------
# K2: the whole adaptive solve of a general MLP (pallas_kernels.py:726)
# ---------------------------------------------------------------------------

def pack_mlp_weights(weights: Sequence[Tuple[Tensor, Tensor]],
                     dtype: torch.dtype, device=None
                     ) -> Tuple[Tensor, Tuple[Tuple[int, int], ...]]:
    """Pack an MLP weight list for K2 (counterpart of pad_mlp_weights).

    weights: [(W [din, dout], b [dout] or None), ...]. Returns (packed,
    dims): one contiguous tensor holding, layer after layer, W^T as
    [dout, din] row-major and then b (zeros for None), and the static
    ((din, dout), ...). Nothing is padded: the TPU's sublane tiles have no
    counterpart on the card.
    """
    parts, dims = [], []
    for W, b in weights:
        W = torch.as_tensor(W)
        din, dout = W.shape
        parts.append(W.to(device=device, dtype=dtype).t().reshape(-1))
        parts.append(torch.zeros(dout, dtype=dtype, device=device)
                     if b is None
                     else torch.as_tensor(b).to(device=device, dtype=dtype))
        dims.append((int(din), int(dout)))
    return torch.cat(parts).contiguous(), tuple(dims)


def _unpack(packed: Tensor, dims):
    layers, off = [], 0
    for din, dout in dims:
        wT = packed[off:off + din * dout].view(dout, din)
        off += din * dout
        layers.append((wT, packed[off:off + dout]))
        off += dout
    return layers


def _net_plain(packed: Tensor, dims, activation: str, final_activation: str,
               input_power: int, time_input: bool):
    """pallas_kernels.py:_make_net (its VPU path) on [B, D]: each output
    sums its input terms in input order, then the time column, then the
    bias. Returns f(t, y)."""
    layers = _unpack(packed, dims)
    acts = ([_ACTIVATIONS[activation]] * (len(dims) - 1)
            + [_ACTIVATIONS[final_activation]])

    def f(t, y):
        h = y
        for _ in range(input_power - 1):
            h = h * y
        for l, (wT, b) in enumerate(layers):
            n_state = wT.shape[1] - 1 if (time_input and l == 0) else \
                wT.shape[1]
            acc = None
            for i in range(n_state):
                term = wT[:, i] * h[:, i:i + 1]              # [B, dout]
                acc = term if acc is None else acc + term
            if time_input and l == 0:
                acc = acc + wT[:, n_state] * t
            h = acts[l](acc + b)
        return h

    return f


def _solve_setup(tau: Tensor, dt0, dtype):
    """whole_solve_call's scalar prologue (pallas_kernels.py:1349-1388) on
    the host: the span-scaled dt_min, dt0 clamped to it, and whether tau
    increases strictly. Returns host 0-d tensors and a bool."""
    tau_h = tau.detach().to("cpu", dtype)
    span = torch.maximum(torch.maximum(torch.abs(tau_h[0]),
                                       torch.abs(tau_h[-1])),
                         torch.tensor(1.0, dtype=dtype))
    dt_min = torch.tensor(4.0 * torch.finfo(dtype).eps, dtype=dtype) * span
    dt0 = torch.maximum(torch.abs(torch.as_tensor(dt0).detach().to(
        "cpu", dtype)), dt_min)
    valid = bool(torch.all(tau_h[1:] > tau_h[:-1])) if tau_h.numel() > 1 \
        else True
    return tau_h, dt_min, dt0, valid


def mlp_solve_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0,
                    rtol, atol, sign, *, f0: Tensor,
                    activation: str = "tanh",
                    final_activation: str = "identity",
                    input_power: int = 1, time_input: bool = False,
                    method: str = "dopri5", safety: float = 0.9,
                    ifactor: float = 10.0, dfactor: float = 0.2,
                    max_steps: int = 2 ** 31 - 1) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2: a host loop of attempts that mirrors
    `_make_solve_kernel` line for line (one synchronisation per attempt).
    Same contract as `mlp_solve`, except that f0 is required."""
    tab = TABLEAUS_BY_NAME[method]
    dev, dtype = y0.device, y0.dtype
    T = tau.shape[0]
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    tau_d = on(tau_h)
    rtol, atol, sign = on(rtol), on(atol), on(sign)
    raw_f = _net_plain(warrays, dims, activation, final_activation,
                       input_power, time_input)

    def f(s, y):
        # Canonical dynamics: g(tau, y) = sign * f(sign * tau, y).
        return sign * raw_f(sign * s, y)

    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    y, fy, comp = y0, f0, torch.zeros_like(y0)
    t_end, t_start = tau_d[T - 1], tau_d[0]
    t, dt = t_start, on(dt0)
    dt_min, denom = on(dt_min), _count(y0)
    oi, nfe, nacc, nrej = 1, 0, 0, 0
    status = 0 if (float(tau_h[-1]) > float(tau_h[0]) and valid) else 3
    t_h, t_end_h = float(tau_h[0]), float(tau_h[-1])
    while t_h < t_end_h and status == 0:
        rem = t_end - t
        dt_eff = torch.minimum(dt, rem)
        is_last = dt >= rem
        t1 = torch.where(is_last, t_end, t + dt_eff)
        dth = t1 - t

        k, delta, err, y_mid = _rk_stages(tab, f, y, fy, dth, t0=t)
        y1 = y + delta
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        esc = err / scale
        # The kernel's fixed reduction order, so that a float64 solve takes
        # the kernel's exact step sequence.
        ss = _tree_sum(_owned_sums(esc * esc, SOLVE_THREADS))
        ratio = torch.sqrt(ss / denom)
        fin = torch.isfinite(ss) & torch.all(torch.isfinite(y1))
        # The attempt's one synchronisation.
        acc_h, fin_h, t1_h = torch.stack([
            ((ratio <= 1.0) & fin).to(torch.float64), fin.to(torch.float64),
            t1.to(torch.float64)]).tolist()
        accept, finite = bool(acc_h), bool(fin_h)

        fac = _controller_factor(ratio, finite, accept, safety, ifactor,
                                 dfactor, tab.order)
        dt_next = dth * fac
        f1 = k[-1] if tab.fsal else f(t1, y1)

        if accept:
            # pallas_kernels.py:_interp_coeffs is ops/rk's quartic (cubic
            # Hermite without a midpoint), operation for operation.
            if y_mid is not None:
                ca, cb, cc, df0, _ = interp_fit_quartic(y, y1, y_mid, k[0],
                                                        f1, dth)
            else:
                ca, cb, cc, df0, _ = interp_fit_cubic_hermite(y, y1, k[0],
                                                              f1, dth)
            adj = delta - comp
            y_new = y + adj
            comp = (y_new - y) - adj
            # Drain every requested time in (t, t1], exactly y_new at t1.
            while oi < T and float(tau_h[oi]) <= t1_h:
                tj = tau_d[oi]
                x = (tj - t) / dth
                val = (((ca * x + cb) * x + cc) * x + df0) * x + y
                out[oi] = torch.where(tj == t1, y_new, val)
                oi += 1
            y, fy = y_new, f1

        n_att = nacc + nrej + 1
        if status == 0 and not accept and bool(dt_next < dt_min):
            status = 2
        if status == 0 and n_att >= max_steps and t1_h < t_end_h:
            status = 1
        if accept:
            t, t_h = t1, t1_h
        dt = dt_next
        nfe += tab.evals_per_step
        nacc += int(accept)
        nrej += int(not accept)
    stats = torch.tensor([nfe, nacc, nrej, status], dtype=torch.int32,
                         device=dev)
    return out, stats


def mlp_solve(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0, rtol,
              atol, sign, *, f0: Tensor = None, activation: str = "tanh",
              final_activation: str = "identity", input_power: int = 1,
              time_input: bool = False, method: str = "dopri5",
              safety: float = 0.9, ifactor: float = 10.0,
              dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1
              ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fused adaptive RK for a general MLP neural ODE: every
    stage evaluation, combine, error norm, controller decision and
    dense-output write of the solve runs in one kernel launch.

    warrays/dims: from `pack_mlp_weights` (any depth up to MAX_LAYERS,
    widths up to MAX_WIDTH, any activation in `_ACTIVATIONS`, the state
    entering as y ** input_power, an optional time column). `method`
    picks the tableau (dopri5, bosh3, adaptive_heun, tsit5, dopri8);
    tableaus that are not FSAL pay one more evaluation per attempt.

    y0: [B, D]; tau: [T] increasing canonical times (tau = sign * t);
    sign: +1 or -1; dt0: first step, clamped to the span-scaled minimum;
    f0: the signed derivative at (tau[0], y0), computed here when None.
    Returns (out [T, B, D], stats [4] int32 on y0's device: nfe, accepted,
    rejected, status). Status: 0 OK, 1 MAX_STEPS_REACHED, 2 DT_UNDERFLOW,
    3 INVALID_TIMES (tau not strictly increasing; the output is then zero
    beyond row 0).
    """
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    for a in (activation, final_activation):
        if a not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {a!r}; available: "
                             f"{sorted(_ACTIVATIONS)}")
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [B, D], got {tuple(y0.shape)}")
    dtype = y0.dtype
    if f0 is None:
        sgn = torch.as_tensor(sign, dtype=dtype).to(y0.device)
        tau0 = torch.as_tensor(tau[0], dtype=dtype).to(y0.device)
        f0 = sgn * _net_plain(warrays, dims, activation, final_activation,
                              input_power, time_input)(sgn * tau0, y0)
    kind = _device_kind(y0, f0, warrays)
    if kind == "cpu":
        return mlp_solve_plain(
            warrays, dims, y0, tau, dt0, rtol, atol, sign, f0=f0,
            activation=activation, final_activation=final_activation,
            input_power=input_power, time_input=time_input, method=method,
            safety=safety, ifactor=ifactor, dfactor=dfactor,
            max_steps=max_steps)

    global mlp_solve_launches
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_solve takes float32 or float64, got {dtype}")
    B, D = y0.shape
    T = tau.shape[0]
    widths = [w for dd in dims for w in dd]
    if len(dims) > MAX_LAYERS:
        raise ValueError(f"mlp_solve supports up to MAX_LAYERS={MAX_LAYERS} "
                         f"layers, got {len(dims)}")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"mlp_solve supports layer widths up to "
                         f"MAX_WIDTH={MAX_WIDTH}, got {max(widths)}")
    if dims[0][0] != D + int(time_input) or dims[-1][1] != D:
        raise ValueError(f"MLP dims {dims} do not map a {D}-feature state "
                         f"(time_input={time_input}) to itself")
    n_w = sum(din * dout + dout for din, dout in dims)
    if tuple(warrays.shape) != (n_w,):
        raise ValueError(f"warrays has shape {tuple(warrays.shape)}, "
                         f"expected ({n_w},) for dims {dims}")
    if n_w * y0.element_size() > MAX_WEIGHT_BYTES:
        raise ValueError(f"mlp_solve: {n_w} weights exceed the "
                         f"{MAX_WEIGHT_BYTES} bytes of shared memory "
                         "the kernel gives them")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    for name, x in (("y0", y0), ("f0", f0), ("warrays", warrays)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")

    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(y0.device)
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    a = [0.0] * (S * S)
    for i, row in enumerate(tab.a, start=1):
        a[i * S:i * S + len(row)] = row
    dbl = lambda xs: (ctypes.c_double * len(xs))(*xs)
    dims_c = (ctypes.c_int * (2 * len(dims)))(*widths)
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    work = torch.empty((S + 5) * B * D, dtype=dtype, device=y0.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_f64)
    c_mid = dbl(tab.c_mid) if tab.c_mid is not None else None
    with torch.cuda.device(y0.device):
        err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(warrays), _ptr(out),
                 _ptr(stats), _ptr(work), T, B, D, SOLVE_THREADS,
                 float(dt0), float(rtol), float(atol), float(dt_min),
                 float(sign), float(safety), float(ifactor), float(dfactor),
                 int(min(max_steps, 2 ** 31 - 1)), int(valid), len(dims),
                 dims_c, _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), S, tab.order, int(tab.fsal), dbl(tab.c),
                 dbl(a), dbl(tab.b_sol), dbl(tab.b_err), c_mid,
                 _stream(y0.device))
    _build.check(err, "mlp_solve launch")
    mlp_solve_launches += 1
    return out, stats
