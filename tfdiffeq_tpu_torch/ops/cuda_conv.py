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
controller and initial step. On the card each controller block runs on
several CTAs of one cooperative grid (`conv_grid`: at most one 512-thread
CTA per SM, the controller blocks' CTAs in proportion to their samples,
each CTA whole samples of one controller block), whose CTAs meet once an
attempt for the block's error sum. The state is NCHW [B, C, H, W]; the
output [T, B, C, H, W].

`conv_solve_plain` repeats the kernel's arithmetic in the kernel's order:
each conv output sums its nine taps in `OFFSETS` order (an outside tap
multiplies the zero padding), each tap's C-deep contraction input channel
by input channel; each GroupNorm sums a channel's positions in order, then
the group's channels in order; the error sum runs over each CTA's flat
[b, C, H * W] elements, thread i of CONV_THREADS owning elements i, i +
CONV_THREADS, ..., then the fixed tree, and the CTAs' shares add in CTA
order. On a CPU tensor `conv_solve` runs it; a CUDA tensor launches the
kernel or raises, never falls back. `conv_solve_launches` counts the
wrapper calls that launched the kernel (a batch of more controller blocks
than the card has SMs takes one launch for each SMs' worth).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_ode import OFFSETS, ConvODESpec, as_tensors, t_channel_map, \
    tap_weights
from .cuda_kernels import (MAX_WEIGHT_BYTES, _check_blocks, _check_float,
                           _device_kind, _ptr, _solve_setup, _stream,
                           _tableau_args, adaptive_solve_plain)
from .tableaus import TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: Threads of each CTA (csrc/conv_solve_kernel.cu kConvThreads); a power of
#: two for the fixed-order error sum.
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


def conv_grid(B: int, block_size: int, max_ctas: int) -> list:
    """K13's grid: the controller blocks of `block_size` samples (the last
    one ragged) spread over CTAs, at most `max_ctas` (the card's SMs) a
    launch. Returns the launches, each a list of its controller blocks as
    (first sample, samples, CTAs); a launch takes at most `max_ctas`
    controller blocks, in order. A controller block of n samples in a
    launch of N samples gets max(1, min(n, n max_ctas // N)) CTAs: in
    proportion to its samples, at least one and at most one a sample, at
    most `max_ctas` in all. Its CTA k owns the samples [k n // c, (k + 1) n
    // c) of its c CTAs."""
    if B < 1 or block_size < 1 or max_ctas < 1:
        raise ValueError(f"conv_grid takes positive B, block_size and "
                         f"max_ctas, got {B}, {block_size}, {max_ctas}")
    sizes = [min(block_size, B - b) for b in range(0, B, block_size)]
    launches = []
    for k0 in range(0, len(sizes), max_ctas):
        chunk = sizes[k0:k0 + max_ctas]
        N = sum(chunk)
        first = k0 * block_size
        blocks = []
        for n in chunk:
            blocks.append((first, n, max(1, min(n, n * max_ctas // N))))
            first += n
        launches.append(blocks)
    return launches


def conv_ctas(B: int, block_size: int, device, max_ctas: int = None) -> list:
    """Each controller block's CTA count on `device`: `conv_grid` with
    max_ctas (None: the card's SMs on a CUDA device, and on the CPU the
    plain version's default, one CTA a controller block)."""
    _check_blocks(max_ctas)
    if max_ctas is None:
        dev = torch.device(device)
        max_ctas = (torch.cuda.get_device_properties(dev).multi_processor_count
                    if dev.type == "cuda" else -(-B // block_size))
    return [c for launch in conv_grid(B, block_size, max_ctas)
            for _, _, c in launch]


def _conv_table(launch: list, block0: int) -> list:
    """The launch's grid table (csrc/conv_solve_kernel.cu kConvCtaInts a
    CTA): controller block, its first sample and samples, the CTA's rank,
    the block's CTAs, its first CTA and its meeting counter."""
    rows, cta = [], 0
    for k, (first, n, c) in enumerate(launch):
        rows += [[block0 + k, first, n, r, c, cta, k] for r in range(c)]
        cta += c
    return rows


def _conv_smem(esz: int, C: int, G: int, H: int, W: int, w_smem: bool,
               z_smem: bool, n_max: int) -> int:
    """csrc/conv_solve_kernel.cu conv_smem_bytes: each region rounded up to
    16 bytes."""
    al = lambda n: -(-n * esz // 16) * 16
    return (al(CONV_THREADS) + al(2 * C) + al(2 * G)
            + al(C * (H + 2) * (W + 2)) + (al(9 * C * C) if w_smem else 0)
            + (n_max * C * H * W * esz if z_smem else 0))


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
                     dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1,
                     max_ctas: int = None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K13, block after block: the whole-solve
    engine (`adaptive_solve_plain`) on each block's flat state with
    `conv_rhs_plain`, its error sum in the order of the block's CTAs
    (`conv_ctas`; a sample's C H W elements a unit, so CTA k owns its
    samples [k n // c, (k + 1) n // c)). Same contract as `conv_solve`;
    max_ctas None takes the kernel's grid on a CUDA tensor and one CTA a
    controller block on the CPU."""
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

    ctas = conv_ctas(B, block_size, y0.device, max_ctas)
    outs, stats = [], []
    for k, b0 in enumerate(range(0, B, block_size)):
        sl = slice(b0, min(B, b0 + block_size))
        out, st = adaptive_solve_plain(
            f, y0[sl].reshape(-1, 1), f0[sl].reshape(-1, 1), tau, dt0[k],
            rtol, atol, tab, safety=safety, ifactor=ifactor,
            dfactor=dfactor, max_steps=max_steps, threads=CONV_THREADS,
            n_blocks=ctas[k], unit=C * P)
        outs.append(out.view((tau.shape[0], -1) + tuple(y0.shape[1:])))
        stats.append(st)
    return torch.cat(outs, dim=1), torch.stack(stats)


def conv_solve(wpack: Tensor, spec: ConvODESpec, y0: Tensor, tau: Tensor,
               dt0: Tensor, rtol, atol, sign, *, f0: Tensor, block_size: int,
               method: str = "dopri5", safety: float = 0.9,
               ifactor: float = 10.0, dfactor: float = 0.2,
               max_steps: int = 2 ** 31 - 1,
               max_ctas: int = None) -> Tuple[Tensor, Tensor]:
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

    max_ctas: the CTAs a launch may take (`conv_grid`; None: the card's
    SMs). A grid the card cannot hold at once raises; the launch never
    takes fewer CTAs than asked.
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
    _check_blocks(max_ctas)
    kind = _device_kind(y0, f0, wpack, dt0)
    if kind == "cpu":
        return conv_solve_plain(
            wpack, spec, y0, tau, dt0, rtol, atol, sign, f0=f0,
            block_size=block_size, method=method, safety=safety,
            ifactor=ifactor, dfactor=dfactor, max_steps=max_steps,
            max_ctas=max_ctas)

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
    dev = y0.device
    if max_ctas is None:
        max_ctas = torch.cuda.get_device_properties(
            dev).multi_processor_count
    launches = conv_grid(B, block_size, max_ctas)
    n_max = max(-(-n // c) for launch in launches for _, n, c in launch)
    esz = y0.element_size()
    H, W = spec.height, spec.width
    # Shared memory: the reduction, the GroupNorm statistics and the padded
    # conv input; then, where they fit, the applied conv's weights (float32
    # up to C = 64) and the conv outputs of a CTA's samples.
    base = _conv_smem(esz, C, G, H, W, False, False, n_max)
    if base > MAX_WEIGHT_BYTES:
        raise ValueError(f"conv_solve: a sample of {C} channels at {H}x{W} "
                         f"needs {base} bytes of shared memory, above "
                         f"{MAX_WEIGHT_BYTES}")
    w_smem = _conv_smem(esz, C, G, H, W, True, False, n_max) \
        <= MAX_WEIGHT_BYTES
    z_smem = _conv_smem(esz, C, G, H, W, w_smem, True, n_max) \
        <= MAX_WEIGHT_BYTES
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    tau_h, dt_min, _, valid = _solve_setup(tau, 0.0, dtype)
    # Every device argument of a launch stays referenced until it returns.
    tau_d = tau_h.to(dev)
    out = torch.empty((tau.shape[0],) + tuple(y0.shape), dtype=dtype,
                      device=dev)
    stats = torch.empty((n_blocks, 4), dtype=torch.int32, device=dev)
    work = torch.empty((S + 7) * B * C * P, dtype=dtype, device=dev)
    c, a, b_sol, b_err = _tableau_args(tab)
    c_mid = (None if tab.c_mid is None
             else (ctypes.c_double * S)(*tab.c_mid))
    lib = _build.library()
    fn = (lib.tfd_conv_solve_f32 if dtype == torch.float32
          else lib.tfd_conv_solve_f64)
    block0 = 0
    for launch in launches:
        table = torch.tensor(_conv_table(launch, block0), dtype=torch.int32,
                             device=dev)
        n_cta, n_meet = table.shape[0], len(launch)
        gwork = torch.empty(16 * n_meet + 4 * n_cta * esz, dtype=torch.uint8,
                            device=dev)
        with torch.cuda.device(dev):
            err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(wpack),
                     _ptr(dt0), _ptr(out), _ptr(stats), _ptr(work),
                     _ptr(gwork), gwork.numel(), _ptr(table), n_cta, n_meet,
                     n_max, tau.shape[0], B, C, G, H, W, CONV_THREADS,
                     int(w_smem), int(z_smem), float(rtol), float(atol),
                     float(dt_min), float(sign), float(spec.eps),
                     float(safety), float(ifactor), float(dfactor),
                     int(min(max_steps, 2 ** 31 - 1)), int(valid), S,
                     tab.order, int(tab.fsal), c, a, b_sol, b_err, c_mid,
                     _stream(dev))
        _build.check(err, "conv_solve launch")
        block0 += n_meet
    conv_solve_launches += 1
    return out, stats
