"""K13: the whole adaptive conv-ODE solve as one hand-written CUDA kernel;
its wrapper, launch counter and plain PyTorch version.

`conv_solve` (csrc/conv_solve_kernel.cu) replaces the TPU kernel
`conv_solve` (tfdiffeq_tpu/ops/pallas_conv.py:110, right-hand side
`_make_conv_f` :36 in the shared engine `_make_solve_kernel`,
pallas_kernels.py:726): every stage of the tableau, each stage's
GN -> relu -> ConcatConv3x3 -> GN -> relu -> ConcatConv3x3 -> GN field, the
error norm, the step controller, Kahan accumulation and the dense-output
drain, for every controller block of the batch, in one launch.

The batch is cut into controller blocks of `block_size` samples (the last
block holds what is left, unpadded); each block has its own step
controller and initial step, and its own thread block on the card. The
state is NCHW [B, C, H, W]; the output [T, B, C, H, W].

`conv_solve_plain` repeats the kernel's arithmetic in the kernel's order:
each conv output sums its taps in `OFFSETS` order, each tap's C-deep
contraction input channel by input channel; each GroupNorm sums a
channel's positions in order, then the group's channels in order; the
error sum runs over the block's flat [b, C, H * W] elements, thread i of
CONV_THREADS owning elements i, i + CONV_THREADS, ..., then the fixed tree.
On a CPU tensor `conv_solve` runs it; a CUDA tensor launches the kernel or
raises, never falls back. `conv_solve_launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_ode import OFFSETS, ConvODESpec, as_tensors, t_channel_map, \
    tap_weights
from .cuda_kernels import (MAX_WEIGHT_BYTES, _check_float, _device_kind,
                           _ptr, _solve_setup, _stream, _tableau_args,
                           adaptive_solve_plain)
from .tableaus import TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: Threads of each thread block (csrc/conv_solve_kernel.cu kConvThreads);
#: a power of two for the fixed-order error sum.
CONV_THREADS = 512

conv_solve_launches = 0


def reset_launch_counts() -> None:
    global conv_solve_launches
    conv_solve_launches = 0


def pack_conv_ode_weights(params: dict, spec: ConvODESpec,
                          dtype: torch.dtype, device=None) -> Tensor:
    """The parameter dict (ops/conv_ode.py) as K13's one flat array:
    [w0 [9, C, C], w1 [9, C, C], b0 [C], b1 [C], tm0 [C, H, W],
    tm1 [C, H, W], GroupNorm scales [3, C], GroupNorm biases [3, C]], each
    conv's taps in OFFSETS order as [tap, c_in, c_out], TM the time
    channel's map (`t_channel_map`)."""
    p = as_tensors(params, dtype, device)
    (k0, b0), (k1, b1) = p["conv"]
    parts = [tap_weights(k0), tap_weights(k1), b0, b1,
             t_channel_map(k0, spec), t_channel_map(k1, spec),
             torch.stack([s for s, _ in p["gn"]]),
             torch.stack([b for _, b in p["gn"]])]
    return torch.cat([x.reshape(-1) for x in parts]).contiguous()


def _unpack(wpack: Tensor, spec: ConvODESpec):
    C, P = spec.channels, spec.positions
    sizes = [9 * C * C, 9 * C * C, C, C, C * P, C * P, 3 * C, 3 * C]
    w0, w1, b0, b1, tm0, tm1, gs, gb = torch.split(wpack, sizes)
    return ((w0.view(9, C, C), b0, tm0.view(C, P)),
            (w1.view(9, C, C), b1, tm1.view(C, P)),
            gs.view(3, C), gb.view(3, C))


def _seq_sum(x: Tensor) -> Tensor:
    """Sum over the last axis one term after another, in order."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _group_norm_plain(x: Tensor, scale: Tensor, bias: Tensor,
                      spec: ConvODESpec, count: Tensor) -> Tensor:
    """GroupNorm of x [b, C, P] in the kernel's order: each channel's sum
    and sum of squares over its positions in order, then each group's over
    its channels in order; var = max(E[x^2] - mean^2, 0), 1 / sqrt(var +
    eps)."""
    b, C, _ = x.shape
    cg = C // spec.groups
    sums = _seq_sum(torch.stack([x, x * x]))               # [2, b, C]
    g1, g2 = _seq_sum(sums.view(2, b, spec.groups, cg))
    mean = g1 / count
    var = torch.clamp(g2 / count - mean * mean, min=0.0)
    inv = torch.reciprocal(torch.sqrt(var + spec.eps))
    mean_c = mean.repeat_interleave(cg, dim=1)[..., None]
    inv_c = inv.repeat_interleave(cg, dim=1)[..., None]
    return ((x - mean_c) * inv_c) * scale[:, None] + bias[:, None]


def _conv_plain(h: Tensor, conv, t, spec: ConvODESpec) -> Tensor:
    """The kernel's 3x3 SAME conv of h [b, C, P]: each tap's products
    w * h summed input channel after input channel, the taps summed in
    OFFSETS order (a tap outside the map adds an exact zero); then the
    bias, then t * TM."""
    w, bias, tm = conv
    b, C, P = h.shape
    H, W = spec.height, spec.width
    hp = F.pad(h.view(b, C, H, W), (1, 1, 1, 1))
    hs = torch.stack([hp[:, :, 1 + di:1 + di + H, 1 + dj:1 + dj + W]
                      for di, dj in OFFSETS]).reshape(9, b, C, 1, P)
    wc = w[:, None, :, :, None]                            # [9, 1, C, C, 1]
    terms = wc[:, :, 0] * hs[:, :, 0]                      # [9, b, C, P]
    for ci in range(1, C):
        terms = terms + wc[:, :, ci] * hs[:, :, ci]
    acc = _seq_sum(terms.movedim(0, -1))
    return (acc + bias[:, None]) + tm * t


def conv_rhs_plain(wpack: Tensor, spec: ConvODESpec):
    """f(t, x) of K13 on x [b, C, H * W] (t the raw time), operation for
    operation as the kernel computes it."""
    conv0, conv1, gs, gb = _unpack(wpack, spec)
    count = torch.tensor(float(spec.channels // spec.groups
                               * spec.positions),
                         dtype=wpack.dtype, device=wpack.device)

    def f(t, x):
        h = torch.clamp(_group_norm_plain(x, gs[0], gb[0], spec, count),
                        min=0.0)
        h = _conv_plain(h, conv0, t, spec)
        h = torch.clamp(_group_norm_plain(h, gs[1], gb[1], spec, count),
                        min=0.0)
        h = _conv_plain(h, conv1, t, spec)
        return _group_norm_plain(h, gs[2], gb[2], spec, count)

    return f


def _check_spec(spec: ConvODESpec, y0: Tensor) -> None:
    if y0.ndim != 4 or tuple(y0.shape[1:]) != (spec.channels, spec.height,
                                              spec.width):
        raise ValueError(f"y0 must be [B, {spec.channels}, {spec.height}, "
                         f"{spec.width}], got {tuple(y0.shape)}")
    if spec.channels % spec.groups:
        raise ValueError(f"channels {spec.channels} not divisible by groups "
                         f"{spec.groups}")


def conv_solve_plain(wpack: Tensor, spec: ConvODESpec, y0: Tensor,
                     tau: Tensor, dt0: Tensor, rtol, atol, sign, *,
                     f0: Tensor, block_size: int, method: str = "dopri5",
                     safety: float = 0.9, ifactor: float = 10.0,
                     dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1
                     ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K13, block after block: the whole-solve
    engine (`adaptive_solve_plain`) on each block's flat state with
    `conv_rhs_plain`. Same contract as `conv_solve`."""
    _check_spec(spec, y0)
    B = y0.shape[0]
    tab = TABLEAUS_BY_NAME[method]
    sign_d = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    rhs = conv_rhs_plain(wpack, spec)
    C, P = spec.channels, spec.positions

    def f(s, y):
        # Canonical dynamics g(tau, y) = sign * f(sign * tau, y) on the
        # block's flat [b * C * P, 1] state.
        x = y.view(-1, C, P)
        return (sign_d * rhs(sign_d * s, x)).view(-1, 1)

    outs, stats = [], []
    for k, b0 in enumerate(range(0, B, block_size)):
        sl = slice(b0, min(B, b0 + block_size))
        out, st = adaptive_solve_plain(
            f, y0[sl].reshape(-1, 1), f0[sl].reshape(-1, 1), tau, dt0[k],
            rtol, atol, tab, safety=safety, ifactor=ifactor,
            dfactor=dfactor, max_steps=max_steps, threads=CONV_THREADS,
            n_blocks=1)
        outs.append(out.view((tau.shape[0], -1) + tuple(y0.shape[1:])))
        stats.append(st)
    return torch.cat(outs, dim=1), torch.stack(stats)


def conv_solve(wpack: Tensor, spec: ConvODESpec, y0: Tensor, tau: Tensor,
               dt0: Tensor, rtol, atol, sign, *, f0: Tensor, block_size: int,
               method: str = "dopri5", safety: float = 0.9,
               ifactor: float = 10.0, dfactor: float = 0.2,
               max_steps: int = 2 ** 31 - 1) -> Tuple[Tensor, Tensor]:
    """Whole adaptive RK solve of the conv-ODE block, one launch.

    wpack: from `pack_conv_ode_weights`; y0, f0: [B, C, H, W] state and
    signed derivative sign * f(sign * tau[0], y0); tau: [T] increasing
    canonical times (tau = sign * t); dt0: [n_blocks] first steps, clamped
    to the span-scaled minimum; block_size: samples per controller block
    (n_blocks = ceil(B / block_size), the last block ragged). `method`
    picks the tableau (dopri5, bosh3, adaptive_heun, tsit5, dopri8).

    Returns (out [T, B, C, H, W], stats [n_blocks, 4] int32 on y0's
    device: nfe, accepted, rejected, status of each block). Status: 0 OK,
    1 MAX_STEPS_REACHED, 2 DT_UNDERFLOW, 3 INVALID_TIMES (tau not strictly
    increasing; the output is then zero beyond row 0).
    """
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    _check_spec(spec, y0)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    B = y0.shape[0]
    n_blocks = -(-B // block_size)
    if tuple(dt0.shape) != (n_blocks,):
        raise ValueError(f"dt0 must be [{n_blocks}] (one first step a "
                         f"block), got {tuple(dt0.shape)}")
    kind = _device_kind(y0, f0, wpack, dt0)
    if kind == "cpu":
        return conv_solve_plain(
            wpack, spec, y0, tau, dt0, rtol, atol, sign, f0=f0,
            block_size=block_size, method=method, safety=safety,
            ifactor=ifactor, dfactor=dfactor, max_steps=max_steps)

    global conv_solve_launches
    dtype = y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"conv_solve takes float32 or float64, got {dtype}")
    C, G, P = spec.channels, spec.groups, spec.positions
    n_w = 18 * C * C + 2 * C + 2 * C * P + 6 * C
    if tuple(wpack.shape) != (n_w,):
        raise ValueError(f"wpack has shape {tuple(wpack.shape)}, expected "
                         f"({n_w},) for {spec}")
    for name, x in (("y0", y0), ("f0", f0), ("wpack", wpack), ("dt0", dt0)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")
    esz = y0.element_size()
    # Shared memory: the reduction, each block's GroupNorm statistics and,
    # when they fit, one conv's weights (float32 up to C = 64).
    smem = esz * (CONV_THREADS + 2 * block_size * (C + G))
    if smem > MAX_WEIGHT_BYTES:
        raise ValueError(f"conv_solve: a block of {block_size} samples needs "
                         f"{smem} bytes of shared memory, above "
                         f"{MAX_WEIGHT_BYTES}")
    w_smem = smem + esz * 9 * C * C <= MAX_WEIGHT_BYTES
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    tau_h, dt_min, _, valid = _solve_setup(tau, 0.0, dtype)
    # Every device argument of the launch stays referenced until it returns.
    tau_d = tau_h.to(y0.device)
    out = torch.empty((tau.shape[0],) + tuple(y0.shape), dtype=dtype,
                      device=y0.device)
    stats = torch.empty((n_blocks, 4), dtype=torch.int32, device=y0.device)
    work = torch.empty(n_blocks * (S + 8) * block_size * C * P, dtype=dtype,
                       device=y0.device)
    c, a, b_sol, b_err = _tableau_args(tab)
    c_mid = (None if tab.c_mid is None
             else (ctypes.c_double * S)(*tab.c_mid))
    lib = _build.library()
    fn = (lib.tfd_conv_solve_f32 if dtype == torch.float32
          else lib.tfd_conv_solve_f64)
    with torch.cuda.device(y0.device):
        err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(wpack), _ptr(dt0),
                 _ptr(out), _ptr(stats), _ptr(work), tau.shape[0], B,
                 block_size, C, G, spec.height, spec.width, CONV_THREADS,
                 int(w_smem), float(rtol), float(atol), float(dt_min),
                 float(sign), float(spec.eps), float(safety), float(ifactor),
                 float(dfactor), int(min(max_steps, 2 ** 31 - 1)),
                 int(valid), S, tab.order, int(tab.fsal), c, a, b_sol,
                 b_err, c_mid, _stream(y0.device))
    _build.check(err, "conv_solve launch")
    conv_solve_launches += 1
    return out, stats
