"""The fixed-grid kernels of the fused tier: wrappers, launch counters and
plain PyTorch versions.

Counterpart of `tfdiffeq_tpu/ops/pallas_fixed.py` for euler, midpoint, rk4
and rk4_38 (sources in `tfdiffeq_tpu_torch/csrc/`, built by `_build.py`):

- K8 `mlp_solve_fixed` (csrc/fixed_kernel.cu) replaces
  `_make_fixed_solve_kernel` (pallas_fixed.py:102): a whole fixed-grid
  solve of a general MLP neural ODE in one launch.
- K9 `mlp_adjoint_solve_fixed` (csrc/fixed_adjoint_kernel.cu) replaces
  `_make_fixed_adjoint_kernel` (pallas_fixed.py:726): the whole fixed-grid
  adjoint backward sweep.

A fixed grid needs no error norm and no controller, so no sample waits for
another: on the MLP routes K8 gives each sample a group of threads
(FIXED_GROUP on the narrow route, FIXED_WIDE_GROUP on the wide one) in
blocks of FIXED_GROUP_THREADS (csrc/lane_group.h), and K9 a group of 16
threads (K6's layout), 32 samples a block of FIXED_ADJOINT_THREADS. The
wrappers take the plain versions only for tensors on the CPU; a CUDA tensor
launches the kernel or raises. The plain versions follow the kernels operation for operation on
the batch-major [B, D] layout, so a kernel run equals its plain version to
the bit.

`mlp_solve_fixed_launches` and `mlp_adjoint_solve_fixed_launches` count
wrapper calls that launched their kernel; `reset_launch_counts()` zeroes
them. Both take the routes of `cuda_kernels._route`; K8 with a reduced dot
precision (`tiers`) takes the batch route, where a block of
FIXED_BATCH_THREADS threads owns 16 samples (csrc/fixed_kernel.cu
kFixedSamples) and evaluates them layer by layer (K4, csrc/dot_tiers.cuh).
Not ported: `rhs='cnf'` (K7), and the TPU machinery of the reference
(`pack` sublane packing, `n_blocks` grid blocks, padded lanes).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import cuda_kernels as _ck
from .cuda_adjoint import _aug_eval_plain
from .cuda_kernels import (ROUTE_BATCH, ROUTE_NARROW, ROUTE_WIDE,
                           _ACT_CODES, _check_activations, _check_float,
                           _check_mlp, _device_kind, _dims_arg, _increasing,
                           _net_plain, _ptr, _rk_stages, _route, _stream,
                           _tableau_args, _tier_work_bytes, _tiers_arg,
                           _tree_sum)
from .tableaus import FIXED_TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: Threads per block of K14 in K8 (ops/cuda_plan.py: one sample a
#: thread); K8's batch route pads its rows to a multiple of it (a multiple
#: of its blocks' 16 samples, csrc/fixed_kernel.cu kFixedSamples).
FIXED_THREADS = 64
#: K8's MLP routes (csrc/lane_group.h kGroupBlock): a block of
#: FIXED_GROUP_THREADS threads, a group of FIXED_GROUP threads a sample on
#: the narrow route (32 samples a block: 128 blocks of 16 warps at
#: B = 4096) and of FIXED_WIDE_GROUP on the wide route (4 samples a block;
#: on the H100 it ran the wide net 128 -> 256 -> 256 -> 128 about 5%
#: faster than 64 in K8 at B = 1024 and 25% in K5 at B = 256, and 32 half
#: as fast; PERF.md).
FIXED_GROUP_THREADS = 512
FIXED_GROUP = 16
FIXED_WIDE_GROUP = 128
#: K9's block: a group of 16 threads a sample, 32 samples (csrc/lane_group.h
#: kLaneGroup, kLaneGroups), 128 blocks of 16 warps at B = 4096.
FIXED_ADJOINT_THREADS = 512
#: Samples of each tree of K9's end-of-sweep batch sums (lane_group.h
#: kFixedTree): block_sum's tree over 64 samples, then the trees in order.
FIXED_TREE = 64
#: Threads of a K8 block on the batch route (csrc/fixed_kernel.cu
#: kFixedBatchThreads); it owns 16 samples (kFixedSamples).
FIXED_BATCH_THREADS = 256

mlp_solve_fixed_launches = 0
mlp_adjoint_solve_fixed_launches = 0


def reset_launch_counts() -> None:
    global mlp_solve_fixed_launches, mlp_adjoint_solve_fixed_launches
    mlp_solve_fixed_launches = 0
    mlp_adjoint_solve_fixed_launches = 0


def _tableau(method: str):
    if method not in FIXED_TABLEAUS_BY_NAME:
        raise ValueError(f"unknown fixed-grid method {method!r}; available: "
                         f"{sorted(FIXED_TABLEAUS_BY_NAME)}")
    return FIXED_TABLEAUS_BY_NAME[method]


# ---------------------------------------------------------------------------
# K8: the whole fixed-grid solve (pallas_fixed.py:102)
# ---------------------------------------------------------------------------

def mlp_solve_fixed_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                          grid: Tensor, sign, *, f0: Tensor,
                          activation: str = "tanh",
                          final_activation: str = "identity",
                          input_power: int = 1, time_input: bool = False,
                          method: str = "rk4",
                          tiers=None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K8, step for step. Same contract as
    `mlp_solve_fixed`, except that f0 is required."""
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    raw_f = _net_plain(warrays, dims, activation, final_activation,
                       input_power, time_input, tiers)

    def f(s, y):
        # Canonical dynamics: g(tau, y) = sign * f(sign * tau, y).
        return sgn * raw_f(sgn * s, y)

    return fixed_solve_plain(f, y0, f0, tau, grid, _tableau(method))


def hermite_drain_plain(out: Tensor, oi: int, tau_h: Tensor, tau_d: Tensor,
                        t1_h: Tensor, t0: Tensor, t1: Tensor, y0: Tensor,
                        y1: Tensor, f0: Tensor, f1: Tensor,
                        last: bool) -> int:
    """K8's cubic-Hermite drain (pallas_fixed.py:76-98, csrc/rk_fixed.cuh
    hermite_drain) of every requested time in (t0, t1] from the output
    cursor oi, from the interval's end states and canonical derivatives;
    `last` flushes the times that roundoff left beyond the grid's end.
    tau_h / t1_h are the host times the cursor compares, tau_d / t0 / t1
    their device copies. Returns the advanced cursor. Shared by the plain
    K8, K10 and K12."""
    dt = t1 - t0
    df0, df1 = dt * f0, dt * f1
    cb = 2.0 * (y0 - y1) + df0 + df1
    cc = 3.0 * (y1 - y0) - 2.0 * df0 - df1
    while oi < tau_h.shape[0] and (bool(tau_h[oi] <= t1_h) or last):
        tj = tau_d[oi]
        x = (tj - t0) / dt
        val = ((cb * x + cc) * x + df0) * x + y0
        out[oi] = torch.where(tj == t1, y1, val)
        oi += 1
    return oi


def fixed_solve_plain(f, y0: Tensor, f0: Tensor, tau: Tensor, grid: Tensor,
                      tab) -> Tuple[Tensor, Tensor]:
    """K8's engine (`_make_fixed_solve_kernel`) step for step on the host:
    f(s, y) is the canonical (signed) right-hand side on y0's [B, D]
    layout, each stage evaluated for the whole batch at once (so a coupled
    plan's batch sums see every sample, as on K8's one block). Returns
    (out [T, B, D], stats [4] int32)."""
    dev, dtype = y0.device, y0.dtype
    T, G = tau.shape[0], grid.shape[0]
    tau_h = tau.detach().to("cpu", dtype)
    grid_h = grid.detach().to("cpu", dtype)
    tau_d, grid_d = tau_h.to(dev), grid_h.to(dev)
    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    if not (_increasing(tau_h) and _increasing(grid_h)):
        # Non-monotonic times: status 3, output zero beyond row 0.
        return out, torch.tensor([0, 0, 0, 3], dtype=torch.int32, device=dev)
    y, fy, comp = y0, f0, torch.zeros_like(y0)
    oi = 1
    for i in range(G - 1):
        t0, t1 = grid_d[i], grid_d[i + 1]
        dt = t1 - t0
        delta = _rk_stages(tab, f, y, fy, dt, t0=t0)[1]
        adj = delta - comp
        y1 = y + adj
        comp = (y1 - y) - adj
        f1 = f(t1, y1)
        oi = hermite_drain_plain(out, oi, tau_h, tau_d, grid_h[i + 1], t0,
                                 t1, y, y1, fy, f1, i == G - 2)
        y, fy = y1, f1
    stats = torch.tensor([1 + tab.stages * (G - 1), G - 1, 0, 0],
                         dtype=torch.int32, device=dev)
    return out, stats


def mlp_solve_fixed(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                    grid: Tensor, sign, *, f0: Tensor = None,
                    activation: str = "tanh",
                    final_activation: str = "identity",
                    input_power: int = 1, time_input: bool = False,
                    method: str = "rk4", tiers=None) -> Tuple[Tensor, Tensor]:
    """Whole-solve fused fixed-grid RK for a general MLP neural ODE, one
    kernel launch: every stage evaluation, the Kahan-compensated state
    update, the chained end derivative and the output drain.

    warrays/dims: from `pack_mlp_weights`; method: euler, midpoint, rk4 or
    rk4_38. y0: [B, D]; tau: [T] canonical output times (tau = sign * t,
    increasing); grid: [G] canonical step grid from tau[0] to tau[-1] (tau
    itself, or finer; outputs between grid points are cubic-Hermite
    interpolated); sign: +1 or -1; f0: the signed derivative at (grid[0],
    y0), computed here when None. tiers: each layer's dot precision, as in
    `cuda_kernels.mlp_solve` (a reduced tier: two launches, the bf16 weight
    pack and the solve).

    Returns (out [T, B, D], stats [4] int32 on y0's device: nfe = 1 +
    stages * (G - 1), steps = G - 1, 0, status). Status 3 (INVALID_TIMES):
    tau or grid not strictly increasing; the output is then zero beyond
    row 0 and the counts are 0.
    """
    tab = _tableau(method)
    _check_activations(activation, final_activation)
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [B, D], got {tuple(y0.shape)}")
    dtype = y0.dtype
    if f0 is None:
        sgn = torch.as_tensor(sign, dtype=dtype).to(y0.device)
        g0 = torch.as_tensor(grid[0], dtype=dtype).to(y0.device)
        f0 = sgn * _net_plain(warrays, dims, activation, final_activation,
                              input_power, time_input)(sgn * g0, y0)
    if _device_kind(y0, f0, warrays) == "cpu":
        return mlp_solve_fixed_plain(
            warrays, dims, y0, tau, grid, sign, f0=f0, activation=activation,
            final_activation=final_activation, input_power=input_power,
            time_input=time_input, method=method, tiers=tiers)

    global mlp_solve_fixed_launches
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_solve_fixed takes float32 or float64, got "
                        f"{dtype}")
    B, D = y0.shape
    T, G = tau.shape[0], grid.shape[0]
    n_w = _check_mlp("mlp_solve_fixed", warrays, dims, D, time_input, tiers)
    route = _route("mlp_solve_fixed", dims, n_w, y0.element_size(), tiers,
                   input_values=G + T)
    for name, x in (("y0", y0), ("f0", f0), ("warrays", warrays)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")

    tau_h = tau.detach().to("cpu", dtype)
    grid_h = grid.detach().to("cpu", dtype)
    valid = _increasing(tau_h) and _increasing(grid_h)
    S = tab.stages
    c, a, b_sol, _ = _tableau_args(tab)
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    batch = route == ROUTE_BATCH
    group = fixed_group(route)
    n_work = ((S + 3) * B * D if batch else _solve_work_size(
        _fixed_slot_values(S, D, dims), B, group, _wt_values(route, n_w)))
    work = torch.empty(n_work, dtype=dtype, device=y0.device)
    rows = -(-B // FIXED_THREADS) * FIXED_THREADS
    n_batch = (_tier_work_bytes(dims, rows, y0.element_size()) if batch
               else 0)
    batch_work = torch.empty(n_batch, dtype=torch.uint8, device=y0.device)
    # Named, so that they live until the launch has read them.
    grid_d, tau_d = grid_h.to(y0.device), tau_h.to(y0.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_fixed_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_fixed_f64)
    with torch.cuda.device(y0.device):
        err = fn(_ptr(grid_d), _ptr(tau_d), _ptr(y0), _ptr(f0),
                 _ptr(warrays), _ptr(out), _ptr(stats), _ptr(work), n_work,
                 G, T, B, D,
                 FIXED_BATCH_THREADS if batch else FIXED_GROUP_THREADS,
                 group, float(sign), int(valid), len(dims), _dims_arg(dims),
                 _ACT_CODES[activation], _ACT_CODES[final_activation],
                 int(input_power), int(time_input), S, c, a, b_sol, route,
                 _tiers_arg(tiers), _ptr(batch_work), n_batch,
                 _stream(y0.device))
    _build.check(err, "mlp_solve_fixed launch")
    mlp_solve_fixed_launches += 1
    _ck.dot_tier_launches += batch
    return out, stats


def fixed_group(route: int) -> int:
    """Threads a sample of K8 (and of K5, `cuda_perlane.perlane_group`) on
    an MLP route: FIXED_GROUP on the narrow route, FIXED_WIDE_GROUP on the
    wide one; 0 on the batch route (a thread a sample)."""
    return {ROUTE_NARROW: FIXED_GROUP, ROUTE_WIDE: FIXED_WIDE_GROUP}.get(
        route, 0)


def _solve_work_size(slot_values: int, B: int, group: int,
                     n_wt: int) -> int:
    """csrc/lane_group.h group_solve_work_size (the workspace of K8's and
    K5's MLP routes): a slot for every sample of the blocks of
    FIXED_GROUP_THREADS // group samples, then n_wt values (the wide
    route's transposed weights)."""
    spb = FIXED_GROUP_THREADS // group
    return -(-B // spb) * spb * slot_values + n_wt


def _widest(dims) -> int:
    """The widest layer of an MLP (csrc/mlp_rk.cuh net_max_width): the
    group walk's vectors."""
    return max(w for dd in dims for w in dd)


def _fixed_slot_values(S: int, D: int, dims) -> int:
    """csrc/lane_group.h fixed_solve_slot_values: K8's slot (state,
    compensation, chained derivative, step-start state, the S - 1 later
    stages, then the walk's two layer vectors)."""
    return (S + 3) * D + 2 * _widest(dims)


def _wt_values(route: int, n_w: int) -> int:
    """The transposed weights' values at the end of the workspace: the
    wide route's n_w, none on the narrow route (they sit in shared
    memory)."""
    return n_w if route == ROUTE_WIDE else 0


# ---------------------------------------------------------------------------
# K9: the whole fixed-grid adjoint sweep (pallas_fixed.py:726)
# ---------------------------------------------------------------------------

def _block_sums(x: Tensor, threads: int) -> Tensor:
    """Sums of x [B, R] over the batch in K9's (threads = FIXED_TREE) and
    K6's (32) order: each run of `threads` consecutive samples meets in
    `_tree_sum`'s tree (samples past B add 0), then the run sums add in
    order. Returns [R]."""
    B, R = x.shape
    n_blk = -(-B // threads)
    x = torch.nn.functional.pad(x, (0, 0, 0, n_blk * threads - B))
    part = _tree_sum(x.view(n_blk, threads, R).transpose(1, 2))
    total = part[0]
    for k in range(1, n_blk):
        total = total + part[k]
    return total


def mlp_adjoint_solve_fixed_plain(warrays: Tensor, dims, ys: Tensor,
                                  g: Tensor, tau: Tensor, sign, *,
                                  num_steps: int = 1,
                                  activation: str = "tanh",
                                  final_activation: str = "identity",
                                  input_power: int = 1,
                                  time_input: bool = False,
                                  method: str = "rk4"
                                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K9, in the kernel's arithmetic order. Same
    contract as `mlp_adjoint_solve_fixed`.

    Order of the quadratures: each sample accumulates its own weighted
    stage cotangents, per step sum_j (h b_j) (sign x_j) over the stages in
    order and then added to its running sum; the per-sample sums meet over
    the batch once, at the end, in `_block_sums(acc, FIXED_TREE)`' order:
    `_tree_sum`'s tree over each 64 consecutive samples, the trees in order
    (the kernel's second launch, csrc/rk_adjoint.cuh
    fixed_tree_reduce_kernel). (The reference sums each stage over the
    batch first, so the two agree to roundoff.)
    """
    aug = _aug_eval_plain(warrays, dims, activation, final_activation,
                          input_power, time_input)
    ay0, aw, at, _, stats = fixed_adjoint_plain(
        lambda t, y, ay: aug(t, y, ay) + (None,), warrays.shape[0],
        time_input, 0, ys, g, tau, sign, num_steps=num_steps, method=method)
    return ay0, aw, at, stats


def fixed_adjoint_plain(aug, n_w: int, time_input: bool, n_ps: int,
                        ys: Tensor, g: Tensor, tau: Tensor, sign, *,
                        num_steps: int = 1, method: str = "rk4"):
    """K9's engine in plain PyTorch, on a right-hand side `aug(t, y, a_y)`
    -> (f, v_y, xw [B, n_w], v_t [B] or None, xs [B, n_ps] or None), as
    `cuda_adjoint.adjoint_sweep_plain`'s, each stage evaluated for the
    whole batch at once (a coupled plan's walk and its meets, as K9's one
    block runs it): a sample's running quadratures hold its shared ones
    (v_t's last), then its per-sample ones; only the shared ones meet over
    the batch at the end.

    Returns (ay0, aw [n_w], at, aps [B, n_ps], stats)."""
    tab = _tableau(method)
    dev, dtype = ys.device, ys.dtype
    T, B, D = ys.shape
    S, n_sub = tab.stages, int(num_steps)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    sf = on(sign)
    sigma = on(-tau.detach().to("cpu", dtype))
    n_sub_d = on(float(n_sub))
    R = n_w + int(time_input)

    def comb(ks):
        acc = None
        for bj, k in zip(tab.b_sol, ks):
            if bj != 0.0:
                term = (h * bj) * k
                acc = term if acc is None else acc + term
        return acc

    ay = torch.zeros((B, D), dtype=dtype, device=dev)
    acc = torch.zeros((B, R + n_ps), dtype=dtype, device=dev)
    for i in range(T - 1, 0, -1):
        y = ys[i]
        ay = ay + g[i]
        cy = torch.zeros_like(y)
        cay = torch.zeros_like(y)
        s_start = sigma[i]
        h = (sigma[i - 1] - s_start) / n_sub_d
        for j in range(n_sub):
            s = s_start + h * j
            ky, kay, kx = [], [], []
            for st in range(S):
                yi, ayi = y, ay
                if st > 0:
                    for aij, kyj, kayj in zip(tab.a[st - 1], ky, kay):
                        if aij != 0.0:
                            yi = yi + (h * aij) * kyj
                            ayi = ayi + (h * aij) * kayj
                f, v_y, xw, v_t, xs = aug((-sf) * (s + tab.c[st] * h), yi,
                                          ayi)
                ky.append((-sf) * f)
                kay.append(sf * v_y)
                xw = torch.cat([xw] + ([v_t[:, None]] if time_input else [])
                               + ([xs] if n_ps else []), dim=1)
                kx.append(sf * xw)
            adj = comb(ky) - cy
            y_new = y + adj
            cy = (y_new - y) - adj
            y = y_new
            adj = comb(kay) - cay
            ay_new = ay + adj
            cay = (ay_new - ay) - adj
            ay = ay_new
            acc = acc + comb(kx)
    total = _block_sums(acc[:, :R], FIXED_TREE)
    at = total[n_w] if time_input else torch.zeros((), dtype=dtype,
                                                    device=dev)
    stats = torch.tensor([S * n_sub * (T - 1), n_sub * (T - 1), 0, 0],
                         dtype=torch.int32, device=dev)
    return ay + g[0], total[:n_w], at, acc[:, R:], stats


def _group_work_size(S: int, B: int, D: int, n_q: int,
                     walk_values: int) -> int:
    """csrc/lane_group.h lane_group_work_size (K6's workspace): every
    sample's slot (y, a_y, their compensations, the stages of both, the
    stage state and the error terms: (8 + 2 S) D values, the running sums
    of its n_q quadratures, then the walk's `walk_values`) and the STEP
    rows of its n_q quadratures."""
    return B * ((8 + 2 * S) * D + walk_values + 2 * n_q)


def _fixed_work_size(S: int, B: int, D: int, n_q: int, walk_values: int,
                     R: int) -> int:
    """csrc/lane_group.h fixed_group_work_size (K9's workspace): K6's, then
    every sample's running sums of its R shared quadratures for the
    end-of-sweep trees."""
    return _group_work_size(S, B, D, n_q, walk_values) + R * B


def _mlp_walk_values(dims, D: int) -> int:
    """csrc/lane_group.h lane_group_mlp_walk_values: each layer's inputs and
    pre-activation cotangents, f (D) and the layer-0 input cotangent."""
    return D + dims[0][0] + sum(din + dout for din, dout in dims)


def _adjoint_work_size(dims, S: int, B: int, D: int,
                       time_input: bool) -> int:
    """The MLP routes' workspace of K9 (`_fixed_work_size` with the
    parameter and a_t quadratures and the MLP walk's values)."""
    R = sum(din * dout + dout for din, dout in dims) + int(time_input)
    return _fixed_work_size(S, B, D, R, _mlp_walk_values(dims, D), R)


def mlp_adjoint_solve_fixed(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                            tau: Tensor, sign, *, num_steps: int = 1,
                            activation: str = "tanh",
                            final_activation: str = "identity",
                            input_power: int = 1, time_input: bool = False,
                            method: str = "rk4"
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fixed-grid fused adjoint backward sweep of an MLP neural ODE.

    For each observation interval in reverse, y is reset to ys[i] and g[i]
    joins a_y, then `num_steps` equal steps of the tableau in sigma = -tau
    integrate (y, a_y) with the MLP forward and its VJP in every stage, and
    each sample accumulates its share of the parameter (and, with
    `time_input`, the a_t) quadrature; the batch sums come at the end, in a
    fixed order with no atomics (the same bits on every run). That sum is a
    second, small launch of the same wrapper call: the launch counter
    counts one per call. A group of 16 threads walks a sample, 32 samples a
    512-thread block.

    warrays/dims: from `pack_mlp_weights`; ys, g: [T, B, D] forward
    trajectory and output cotangents at the canonical times tau ([T],
    increasing; sign as in `mlp_solve_fixed`). Returns (ay0 [B, D] =
    dL/dy0, aw [n_w] = dL/dweights in `pack_mlp_weights`' layout, at (0-d:
    the a_t quadrature; 0 when autonomous), stats [4] int32: nfe = stages *
    num_steps * (T - 1), steps, 0, 0).
    """
    tab = _tableau(method)
    _check_activations(activation, final_activation)
    if ys.ndim != 3 or g.shape != ys.shape:
        raise ValueError(f"ys and g must both be [T, B, D], got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    if int(num_steps) < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    kw = dict(num_steps=int(num_steps), activation=activation,
              final_activation=final_activation, input_power=input_power,
              time_input=time_input, method=method)
    if _device_kind(ys, g, warrays) == "cpu":
        return mlp_adjoint_solve_fixed_plain(warrays, dims, ys, g, tau, sign,
                                             **kw)

    global mlp_adjoint_solve_fixed_launches
    dtype = ys.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_adjoint_solve_fixed takes float32 or float64, "
                        f"got {dtype}")
    T, B, D = ys.shape
    n_w = _check_mlp("mlp_adjoint_solve_fixed", warrays, dims, D,
                     time_input)
    # The weights and K6's allowance for the quadrature table.
    route = _route("mlp_adjoint_solve_fixed", dims, n_w + 32,
                   ys.element_size())
    for name, x in (("ys", ys), ("g", g), ("warrays", warrays)):
        _check_float(name, x, dtype)

    S = tab.stages
    c, a, b_sol, _ = _tableau_args(tab)
    tau_d = tau.detach().to("cpu", dtype).to(ys.device)
    ay0 = torch.empty((B, D), dtype=dtype, device=ys.device)
    aw = torch.empty(n_w, dtype=dtype, device=ys.device)
    at = torch.empty((), dtype=dtype, device=ys.device)
    stats = torch.empty(4, dtype=torch.int32, device=ys.device)
    n_work = _adjoint_work_size(dims, S, B, D, time_input)
    work = torch.empty(n_work, dtype=dtype, device=ys.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_adjoint_fixed_f32 if dtype == torch.float32
          else lib.tfd_mlp_adjoint_fixed_f64)
    with torch.cuda.device(ys.device):
        err = fn(_ptr(tau_d), _ptr(ys), _ptr(g), _ptr(warrays), _ptr(ay0),
                 _ptr(aw), _ptr(at), _ptr(stats), _ptr(work), n_work, T, B,
                 D, FIXED_ADJOINT_THREADS, int(num_steps),
                 float(sign), len(dims), _dims_arg(dims),
                 _ACT_CODES[activation], _ACT_CODES[final_activation],
                 int(input_power), int(time_input), S, c, a, b_sol, route,
                 _stream(ys.device))
    _build.check(err, "mlp_adjoint_solve_fixed launch")
    mlp_adjoint_solve_fixed_launches += 1
    return ay0, aw, at, stats
