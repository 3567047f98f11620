"""The Adams kernels of the fused tier: wrappers, launch counters and plain
PyTorch versions.

Counterpart of the Adams kernels of `tfdiffeq_tpu/ops/pallas_fixed.py` and
`tfdiffeq_tpu/ops/pallas_vcabm.py` (sources in `tfdiffeq_tpu_torch/csrc/`,
built by `_build.py`):

- K10 `mlp_solve_adams` (csrc/adams_kernel.cu) replaces
  `_make_adams_solve_kernel` (pallas_fixed.py:512): a whole fixed-step
  Adams solve (explicit_adams, fixed_adams) of a general MLP neural ODE in
  one launch.
- K11 `mlp_solve_vcabm` (csrc/vcabm_kernel.cu) replaces
  `_make_vcabm_kernel` (pallas_vcabm.py:51): a whole VCABM ('adams') solve
  in one launch.

Both kernels are templates on their right-hand side (`csrc/rk_adams.cuh`,
`csrc/rk_vcabm.cuh`): the MLP routes here, a generated plan in
`cuda_plan.plan_solve_adams` / `plan_solve_vcabm` (K14). Their engines'
plain versions, `adams_solve_plain` and `vcabm_solve_plain`, take any
canonical right-hand side and serve both.

The wrappers take the plain versions only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. The plain versions follow the
kernels operation for operation on the batch-major [B, D] layout, the
batch sums in the kernels' fixed order (`cuda_kernels._grid_sum`) and
every scalar of the VCABM machinery as a 0-d tensor on the state's
device, so that a kernel run equals its plain version on the same card to
the bit. K11 and fixed_adams' K10 run on a grid of `n_blocks` blocks
(`cuda_kernels.solve_blocks`: one per SM), each owning a contiguous range
of the samples, under one controller (K10: one convergence decision a
corrector iteration); their plain versions take every batch sum in the
grid's order for the same n_blocks (`cuda_kernels._grid_sum`), one block
on the CPU. explicit_adams has no batch sum: K8's layout, a group of
threads a sample (16 on the narrow route, `cuda_fixed.FIXED_WIDE_GROUP` on
the wide one) in 512-thread blocks, each sample's slot in the block's
shared memory where the block's slots fit (`last_adams_layout` keeps what
the latest launch ran). K10 decides status 3 (times that do not increase)
on the card, so its wrapper never waits for the card. Both
kernels take the narrow and wide routes of `cuda_kernels._route`; neither
takes a reduced dot precision (the reference refuses the tiers
for the Adams kernels) nor `rhs='cnf'`. Not ported: the TPU machinery of
the reference (`pack` sublane packing, `n_blocks` grid blocks, padded
lanes).

`mlp_solve_adams_launches` and `mlp_solve_vcabm_launches` count wrapper
calls that launched their kernel; `reset_launch_counts()` zeroes them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .cuda_fixed import (_solve_work_size, _widest, _wt_values, fixed_group,
                         hermite_drain_plain)
from .cuda_kernels import (_ACT_CODES, _block_index, _check_activations,
                           _check_blocks, _check_float, _check_mlp, _count,
                           _device_kind, _dims_arg, _grid_sum, _increasing,
                           _net_plain, _ptr, _route, _shares_work,
                           _solve_setup, _stream, solve_blocks)
from .tableaus import RK4
from ..solvers.adams import GAMMA_STAR
from ..solvers.fixed_adams import (BASHFORTH_TABLE, MAX_ORDER,
                                   MOULTON_TABLE, check_max_order)

Tensor = torch.Tensor

#: Threads of each block of fixed_adams' K10 and of K11 (csrc/rk_adams.cuh
#: kAdamsThreads, csrc/rk_vcabm.cuh kVcabmThreads): thread i owns samples
#: lo + i, lo + i + threads, ... of its block's batch sums; and of
#: explicit_adams' blocks (csrc/lane_group.h kGroupBlock), a group of
#: threads a sample.
ADAMS_THREADS = 512
VCABM_THREADS = 512

_INT32_MAX = 2 ** 31 - 1

mlp_solve_adams_launches = 0
mlp_solve_vcabm_launches = 0
#: What K10's latest launch ran, as the launch reported it (`group_layout`);
#: None before one.
last_adams_layout = None


def reset_launch_counts() -> None:
    global mlp_solve_adams_launches, mlp_solve_vcabm_launches
    global last_adams_layout
    mlp_solve_adams_launches = 0
    mlp_solve_vcabm_launches = 0
    last_adams_layout = None


def group_layout(reported) -> dict:
    """The layout a group launch (explicit_adams' K10, K12) wrote:
    threads a sample, samples a 512-thread block, and whether the block's
    sample slots sit in its shared memory (else in the workspace).
    fixed_adams' grid reports 0 threads a sample and whether its blocks'
    state rows sit in shared memory."""
    return {"threads_a_sample": reported[0],
            "samples_a_block": reported[1],
            "slots_in_shared_memory": bool(reported[2])}


def on_card(x: Tensor, dtype, device) -> Tensor:
    """The step grid or the output times on the card in `dtype`, without
    waiting for it: a host tensor goes by an asynchronous copy (a blocking
    one waits for the card's queue to drain), a card tensor stays there. The
    kernel decides from them whether they increase (status 3)."""
    return x.detach().to(device, dtype, non_blocking=True)


def _signed_net(warrays, dims, sign, dtype, dev, activation,
                final_activation, input_power, time_input):
    """The canonical dynamics g(tau, y) = sign * f(sign * tau, y)."""
    sgn = torch.as_tensor(sign, dtype=dtype).to(dev)
    raw_f = _net_plain(warrays, dims, activation, final_activation,
                       input_power, time_input)
    return lambda s, y: sgn * raw_f(sgn * s, y)


def _f0(warrays, dims, y0, t0, sign, activation, final_activation,
        input_power, time_input) -> Tensor:
    t0 = torch.as_tensor(t0, dtype=y0.dtype).to(y0.device)
    return _signed_net(warrays, dims, sign, y0.dtype, y0.device, activation,
                       final_activation, input_power, time_input)(t0, y0)


# ---------------------------------------------------------------------------
# K10: the whole fixed-step Adams solve (pallas_fixed.py:512)
# ---------------------------------------------------------------------------

def _adams_nfe(G: int, max_order: int, max_iters: int,
               implicit: bool) -> int:
    """f0, 4 an RK4 bootstrap step, then 1 (explicit) or max_iters + 1
    (implicit) an Adams step."""
    boot = min(max_order - 1, G - 1)
    per = max_iters + 1 if implicit else 1
    return 1 + 4 * boot + per * (G - 1 - boot)


def adams_work_size(max_order: int, B: int, D: int) -> int:
    """fixed_adams' workspace: rows of D values a sample for the state, its
    compensation, y_cur, y_next, the history part, the evaluation, the RK4
    stages and the history ring (csrc/rk_adams.cuh adams_grid_rows; its
    grid keeps a block's rows in the block's shared memory where they
    fit)."""
    return (9 + max_order) * B * D


def adams_slot_values(max_order: int, D: int, walk_values: int) -> int:
    """csrc/lane_group.h adams_solve_slot_values: explicit_adams' slot (the
    state, its compensation, the step's increment, RK4 stages 1-3, the
    ring of max_order history slabs, then the walk's values)."""
    return (6 + max_order) * D + walk_values


def adams_group_work(max_order: int, D: int, dims, route: int,
                     B: int) -> int:
    """explicit_adams' workspace on an MLP route: the slots of
    `cuda_fixed._solve_work_size` (the walk's two layer vectors), then the
    wide route's transposed weights."""
    slot = adams_slot_values(max_order, D, 2 * _widest(dims))
    return _solve_work_size(slot, B, fixed_group(route),
                            _wt_values(route, sum(i * o + o
                                                  for i, o in dims)))


def _adams_grid(implicit: bool, n_blocks, B: int, dtype, device):
    """(n_blocks, grid workspace) of a K10 launch: fixed_adams' grid
    (`solve_blocks` when None) and its meetings' workspace of one share a
    block; explicit_adams has neither (1 and a byte)."""
    if not implicit:
        return 1, torch.empty(1, dtype=torch.uint8, device=device)
    nb = n_blocks or solve_blocks(B, device)
    return nb, _shares_work(nb, 1, dtype, device)


def mlp_solve_adams_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                          grid: Tensor, rtol, atol, sign, *, f0: Tensor,
                          activation: str = "tanh",
                          final_activation: str = "identity",
                          input_power: int = 1, time_input: bool = False,
                          implicit: bool = True, max_order: int = 4,
                          max_iters: int = 4, n_blocks: int = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K10, step for step. Same contract as
    `mlp_solve_adams`, except that f0 is required."""
    f = _signed_net(warrays, dims, sign, y0.dtype, y0.device, activation,
                    final_activation, input_power, time_input)
    return adams_solve_plain(f, y0, f0, tau, grid, rtol, atol,
                             implicit=implicit, max_order=max_order,
                             max_iters=max_iters, n_blocks=n_blocks)


def adams_solve_plain(f, y0: Tensor, f0: Tensor, tau: Tensor, grid: Tensor,
                      rtol, atol, *, implicit: bool = True,
                      max_order: int = 4, max_iters: int = 4,
                      n_blocks: int = None) -> Tuple[Tensor, Tensor]:
    """K10's engine (`_make_adams_solve_kernel`) step for step on the host:
    f(s, y) is the canonical (signed) right-hand side on y0's [B, D]
    layout, evaluated for the whole batch at once (a coupled plan's batch
    sums see every sample, as on K10's one block), f0 = f(grid[0], y0). Returns (out [T, B, D], stats [4] int32).
    fixed_adams' convergence norm sums in the order of K10's grid of
    `n_blocks` blocks (None: the kernel's grid for y0's device,
    `solve_blocks`; one block on the CPU, the one-block order). Shared by
    the MLP route (`mlp_solve_adams_plain`) and the plan route
    (`cuda_plan.plan_solve_adams_plain`)."""
    MO = check_max_order(max_order)
    _check_blocks(n_blocks)
    dev, dtype = y0.device, y0.dtype
    T, G = tau.shape[0], grid.shape[0]
    tau_h = tau.detach().to("cpu", dtype)
    grid_h = grid.detach().to("cpu", dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    tau_d, grid_d = on(tau_h), on(grid_h)
    rtol, atol = on(rtol), on(atol)
    ab = on(BASHFORTH_TABLE[:MO, :MO])
    am = on(MOULTON_TABLE[:MO, :MO])

    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    if not (_increasing(tau_h) and _increasing(grid_h)):
        # Non-monotonic times: status 3, output zero beyond row 0.
        return out, torch.tensor([0, 0, 0, 3], dtype=torch.int32, device=dev)
    denom = _count(y0)
    B = y0.shape[0]
    owned = (_block_index(B, n_blocks or solve_blocks(B, dev), ADAMS_THREADS,
                          dev) if implicit else None)
    # RK4's stages 1 .. 3: each row's one nonzero weight a_i,i-1, and c_i.
    rk = [(a[-1], c) for a, c in zip(RK4.a, RK4.c[1:])]
    y, comp = y0, torch.zeros_like(y0)
    hist = [f0] + [torch.zeros_like(y0)] * (MO - 1)    # newest first
    oi = 1
    for n in range(G - 1):
        t0, t1 = grid_d[n], grid_d[n + 1]
        dt = t1 - t0
        f_head = hist[0]
        k_eff = min(n + 1, MO)

        def predictor():
            acc = ab[k_eff - 1, 0] * hist[0]
            for j in range(1, MO):
                acc = acc + ab[k_eff - 1, j] * hist[j]
            return acc

        if n < MO - 1:
            # RK4 (pallas_fixed.py:_fixed_stage_walk): each stage state
            # y + (dt a_i,i-1) k_{i-1}, the only nonzero weight of its row.
            k = [f_head]
            for a, c in rk:
                k.append(f(t0 + c * dt, y + (dt * a) * k[-1]))
            delta = (dt * RK4.b_sol[0]) * k[0]
            for b, kj in zip(RK4.b_sol[1:], k[1:]):
                delta = delta + (dt * b) * kj
            f1 = f(t1, y + delta)
        elif not implicit:
            delta = dt * predictor()
            f1 = f(t1, y + delta)
        else:
            g0 = am[k_eff - 1, 0]
            if MO > 1:
                hist_part = am[k_eff - 1, 1] * hist[0]
                for j in range(1, MO - 1):
                    hist_part = hist_part + am[k_eff - 1, j + 1] * hist[j]
            else:
                hist_part = torch.zeros_like(y)
            y_cur = y + dt * predictor()
            done = False
            for _ in range(max_iters):
                y_next = y + dt * (hist_part + g0 * f(t1, y_cur))
                scale = atol + rtol * torch.maximum(torch.abs(y_cur),
                                                    torch.abs(y_next))
                esc = (y_next - y_cur) / scale
                norm = torch.sqrt(_grid_sum(esc * esc, owned) / denom)
                if not done:
                    y_cur = y_next
                done = done or bool(norm <= 1.0)
            delta = y_cur - y
            f1 = f(t1, y_cur)
        # Kahan-compensated update on the step's increment.
        adj = delta - comp
        y1 = y + adj
        comp = (y1 - y) - adj
        hist = [f1] + hist[:-1]
        oi = hermite_drain_plain(out, oi, tau_h, tau_d, grid_h[n + 1], t0,
                                 t1, y, y1, f_head, f1, n == G - 2)
        y = y1
    stats = torch.tensor([_adams_nfe(G, MO, max_iters, implicit), G - 1, 0,
                          0], dtype=torch.int32, device=dev)
    return out, stats


def _check_net(name, warrays, dims, y0, f0, time_input, extra_values):
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [B, D], got {tuple(y0.shape)}")
    dtype = y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    n_w = _check_mlp(name, warrays, dims, y0.shape[1], time_input)
    route = _route(name, dims, n_w, y0.element_size(),
                   input_values=extra_values)
    for tname, x in (("y0", y0), ("f0", f0), ("warrays", warrays)):
        _check_float(tname, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")
    return route


def mlp_solve_adams(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                    grid: Tensor, rtol, atol, sign, *, f0: Tensor = None,
                    activation: str = "tanh",
                    final_activation: str = "identity",
                    input_power: int = 1, time_input: bool = False,
                    implicit: bool = True, max_order: int = 4,
                    max_iters: int = 4, n_blocks: int = None
                    ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fused fixed-step Adams for a general MLP neural ODE, one
    kernel launch: the RK4 bootstrap, the predictor over the history and,
    with `implicit` ('fixed_adams'), `max_iters` corrector iterations with
    the batch-wide convergence mask; the Kahan update and the output drain.
    `implicit=False` is 'explicit_adams'. rtol/atol drive the corrector's
    convergence mask only.

    warrays/dims: from `pack_mlp_weights`; y0: [B, D]; tau: [T] canonical
    output times (tau = sign * t, increasing); grid: [G] canonical step
    grid from tau[0] to tau[-1] (tau itself, or finer: the outputs between
    grid points are cubic-Hermite interpolated); sign: +1 or -1; f0: the
    signed derivative at (grid[0], y0), computed here when None;
    max_order in [1, 12].

    Returns (out [T, B, D], stats [4] int32 on y0's device: nfe = 1 + 4
    per bootstrap step + 1 or max_iters + 1 per Adams step, steps = G - 1,
    0, status). Status 3 (INVALID_TIMES): tau or grid not strictly
    increasing; the output is then zero beyond row 0 and the counts are 0.

    n_blocks: fixed_adams' grid, each block a contiguous range of the
    samples (None: `cuda_kernels.solve_blocks`, one block per SM); it
    changes only the order of the convergence norm's sum, which the plain
    version repeats for the same n_blocks. explicit_adams has no batch sum
    and gives each sample a group of threads (`cuda_fixed.fixed_group`).
    """
    _check_activations(activation, final_activation)
    _check_blocks(n_blocks)
    MO = check_max_order(max_order)
    if int(max_iters) < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if grid.shape[0] < 2:
        raise ValueError("the step grid needs at least two points")
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input)
    if f0 is None:
        f0 = _f0(warrays, dims, y0, grid[0], sign, **kw)
    if _device_kind(y0, f0, warrays) == "cpu":
        return mlp_solve_adams_plain(
            warrays, dims, y0, tau, grid, rtol, atol, sign, f0=f0,
            implicit=implicit, max_order=MO, max_iters=max_iters,
            n_blocks=n_blocks, **kw)

    global mlp_solve_adams_launches, last_adams_layout
    B, D = y0.shape
    T, G = tau.shape[0], grid.shape[0]
    route = _check_net("mlp_solve_adams", warrays, dims, y0, f0, time_input,
                       G + T)
    dtype = y0.dtype
    dbl = lambda a: (ctypes.c_double * a.size)(*a.reshape(-1).tolist())
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    group = 0 if implicit else fixed_group(route)
    n_work = (adams_work_size(MO, B, D) if implicit
              else adams_group_work(MO, D, dims, route, B))
    work = torch.empty(n_work, dtype=dtype, device=y0.device)
    nb, gwork = _adams_grid(implicit, n_blocks, B, dtype, y0.device)
    # Named, so that they live until the launch has read them.
    grid_d = on_card(grid, dtype, y0.device)
    tau_d = on_card(tau, dtype, y0.device)
    reported = (ctypes.c_int * 3)()
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_adams_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_adams_f64)
    with torch.cuda.device(y0.device):
        err = fn(_ptr(grid_d), _ptr(tau_d), _ptr(y0), _ptr(f0),
                 _ptr(warrays), _ptr(out), _ptr(stats), _ptr(work), n_work,
                 G, T, B, D, ADAMS_THREADS, group, float(sign), float(rtol),
                 float(atol), MO, int(max_iters), int(bool(implicit)),
                 _adams_nfe(G, MO, int(max_iters), bool(implicit)),
                 dbl(BASHFORTH_TABLE[:MO, :MO]), dbl(MOULTON_TABLE[:MO, :MO]),
                 len(dims), _dims_arg(dims), _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), route, _ptr(gwork), gwork.numel(), nb,
                 reported, _stream(y0.device))
    _build.check(err, "mlp_solve_adams launch")
    last_adams_layout = group_layout(reported)
    mlp_solve_adams_launches += 1
    return out, stats


# ---------------------------------------------------------------------------
# K11: the whole VCABM solve (pallas_vcabm.py:51)
# ---------------------------------------------------------------------------

def _batch_rms(x: Tensor, denom: Tensor, owned: Tensor) -> Tensor:
    """sqrt(sum(x^2) / denom), the sum in the order of K11's grid (owned:
    `_block_index(B, n_blocks, VCABM_THREADS)`)."""
    return torch.sqrt(_grid_sum(x * x, owned) / denom)


def _vcabm_dt(dt: Tensor, ratio: Tensor, order: int, accepted: bool,
              safety: float, ifactor: float, dfactor: float) -> Tensor:
    """pallas_vcabm.py:optimal_dt (csrc/vcabm_kernel.cu vcabm_dt):
    safety exp((-1/k) log r) with r = max(ratio, 1e-38), clipped to
    [1, ifactor] on accept and [dfactor, 1] on reject, ifactor when
    ratio <= 0."""
    full = lambda v: torch.full_like(ratio, v)
    r = torch.maximum(ratio, full(1e-38))
    k = torch.maximum(full(float(order)), full(1.0))
    fac = safety * torch.exp((full(-1.0) / k) * torch.log(r))
    lo, hi = (1.0, ifactor) if accepted else (dfactor, 1.0)
    fac = torch.minimum(torch.maximum(fac, full(lo)), full(hi))
    fac = torch.where(ratio <= 0.0, full(ifactor), fac)
    return dt * fac


def mlp_solve_vcabm_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor,
                          dt0, rtol, atol, sign, *, f0: Tensor,
                          activation: str = "tanh",
                          final_activation: str = "identity",
                          input_power: int = 1, time_input: bool = False,
                          max_order: int = MAX_ORDER,
                          safety: float = 0.9, ifactor: float = 10.0,
                          dfactor: float = 0.2, max_steps: int = _INT32_MAX,
                          n_blocks: int = None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K11. Same contract as `mlp_solve_vcabm`,
    except that f0 is required."""
    f = _signed_net(warrays, dims, sign, y0.dtype, y0.device, activation,
                    final_activation, input_power, time_input)
    return vcabm_solve_plain(f, y0, f0, tau, dt0, rtol, atol,
                             max_order=max_order, safety=safety,
                             ifactor=ifactor, dfactor=dfactor,
                             max_steps=max_steps, n_blocks=n_blocks)


def vcabm_solve_plain(f, y0: Tensor, f0: Tensor, tau: Tensor, dt0, rtol,
                      atol, *, max_order: int = MAX_ORDER,
                      safety: float = 0.9, ifactor: float = 10.0,
                      dfactor: float = 0.2, max_steps: int = _INT32_MAX,
                      n_blocks: int = None) -> Tuple[Tensor, Tensor]:
    """K11's engine: a host loop of attempts that mirrors
    `_make_vcabm_kernel` line for line, every scalar a 0-d tensor on y0's
    device (one synchronisation per attempt, two for an accepted one).
    f(s, y) is the canonical (signed) right-hand side, evaluated for the
    whole batch at once (a coupled plan's too), f0 = f(tau[0], y0).
    Every batch sum is taken in the order of K11's grid of `n_blocks`
    blocks (None: the kernel's grid for y0's device, `solve_blocks`; one
    block on the CPU, the one-block order). Shared by the MLP route
    (`mlp_solve_vcabm_plain`) and the plan route
    (`cuda_plan.plan_solve_vcabm_plain`)."""
    MO = check_max_order(max_order)
    K = MO + 2
    dev, dtype = y0.device, y0.dtype
    _check_blocks(n_blocks)
    owned = _block_index(y0.shape[0],
                         n_blocks or solve_blocks(y0.shape[0], dev),
                         VCABM_THREADS, dev)
    T = tau.shape[0]
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    tau_d = on(tau_h)
    rtol, atol, dt_min = on(rtol), on(atol), on(dt_min)
    gstar = on(GAMMA_STAR[:K + 1])

    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    zeros = torch.zeros_like(y0)
    zero, one = on(0.0), on(1.0)
    denom = _count(y0)
    c_init = on([1.0 / float(i) for i in range(1, K + 2)])
    y = y0
    phi = [f0] + [zeros] * (K - 1)
    t0 = tau_d[0]
    prev_t = [t0] + [t0 - float(j) for j in range(1, K)]
    next_t_c = t0 + on(dt0)
    order, oi, nacc, nrej, nfe = 1, 1, 0, 0, 0
    status = 0 if valid else 3
    safe = lambda den: torch.where(den == 0, one, den)

    while oi < T and status == 0:
        final_t = tau_d[min(oi, T - 1)]
        next_t = torch.minimum(next_t_c, final_t)
        curr_t = prev_t[0]
        dt = next_t - curr_t

        # g / beta recurrences, masked by the live order.
        cvec = c_init
        g, beta, ephi = [one], one, [phi[0]]
        for j in range(1, MO + 1):
            if j <= order:
                factor = dt / safe(next_t - prev_t[j - 1])
                cvec = cvec - torch.cat([cvec[1:], cvec[-1:]]) * factor
                g.append(cvec[0])
            else:
                g.append(zero)
            if j < order:
                beta = beta * ((next_t - prev_t[j - 1])
                               / safe(curr_t - prev_t[j]))
                ephi.append(phi[j] * beta)
            else:
                ephi.append(zeros)
        g.append(zero)
        ephi.append(zeros)
        n_pred = max(order - 1, 1)
        om1, cidx = max(order - 1, 0), max(order - 1, 1)

        # Predictor, f_pred, implicit phi, corrector, error at order k.
        acc = g[0] * ephi[0]
        for j in range(1, MO):
            acc = acc + (g[j] if j < n_pred else zero) * ephi[j]
        p_next = y + dt * acc
        fp = f(next_t, p_next)
        run, phip = zeros, []
        for j in range(K):
            phip.append(fp - run if j < order + 1 else zeros)
            if j < K - 1:
                run = run + ephi[j]
        y_next = p_next + (dt * g[cidx]) * phip[cidx]
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_next))
        error_k = _batch_rms(((dt * (g[order] - g[om1])) * phip[order])
                             / scale, denom, owned)
        finite = torch.isfinite(error_k) & torch.all(torch.isfinite(y_next))
        ok = (error_k <= 1.0) & finite
        hit = ok & (next_t >= final_t)
        # The attempt's synchronisation.
        accept, hit = (bool(v) for v in torch.stack([ok, hit]).tolist())
        error_ctrl = torch.where(finite, error_k, on(2.0 ** 20))

        next_order, dt_acc = order, dt
        if accept:
            f_next = f(next_t, y_next)
            om2, om3 = max(order - 2, 0), max(order - 3, 0)
            run, new_phi = zeros, []
            for j in range(K):
                new_phi.append(f_next - run if j < order + 2 else zeros)
                if j < K - 1:
                    run = run + ephi[j]
            errs = torch.stack([
                _batch_rms(((dt * (g[om1] - g[om2])) * phip[om1]) / scale,
                           denom, owned),
                _batch_rms(((dt * (g[om2] - g[om3])) * phip[om2]) / scale,
                           denom, owned),
                _batch_rms(((dt * gstar[order]) * new_phi[order]) / scale,
                           denom, owned),
                error_k])
            e_km1, e_km2, e_kp1, e_k = errs.tolist()
            if nacc + 1 <= 4 or order < 3:
                next_order = min(order + 1, 3, MO)
            elif min(e_km1, e_km2) < e_k:
                next_order = order - 1
            elif order < min(MO, nacc + 1) and e_kp1 < e_k:
                next_order = order + 1
            next_order = min(max(next_order, 1), MO)
            if next_order <= order:
                dt_acc = _vcabm_dt(dt, error_ctrl, order + 1, True, safety,
                                   ifactor, dfactor)
            y, phi = y_next, new_phi
            prev_t = [next_t] + prev_t[:-1]
            if hit:
                out[oi] = y_next
        dt_rej = _vcabm_dt(dt, error_ctrl, order, False, safety, ifactor,
                           dfactor)

        oi_new = oi + int(hit)
        n_att = nacc + nrej + 1
        if not accept and bool(dt_rej < dt_min) and status == 0:
            status = 2
        if n_att >= max_steps and oi_new < T and status == 0:
            status = 1
        next_t_c = next_t + dt_acc if accept else curr_t + dt_rej
        order = next_order
        oi = oi_new
        nacc += int(accept)
        nrej += int(not accept)
        nfe += 2 if accept else 1
    stats = torch.tensor([nfe, nacc, nrej, status], dtype=torch.int32,
                         device=dev)
    return out, stats


def mlp_solve_vcabm(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0,
                    rtol, atol, sign, *, f0: Tensor = None,
                    activation: str = "tanh",
                    final_activation: str = "identity",
                    input_power: int = 1, time_input: bool = False,
                    max_order: int = MAX_ORDER, safety: float = 0.9,
                    ifactor: float = 10.0, dfactor: float = 0.2,
                    max_steps: int = _INT32_MAX, n_blocks: int = None
                    ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fused VCABM ('adams') for a general MLP neural ODE, one
    kernel launch: the g / beta / c recurrences, the phi stacks, predictor
    and corrector, the batch-wide errors at orders k - 2 .. k + 1, the
    order adaptation, the step controller and the output of every accepted
    step that lands on a requested time.

    warrays/dims: from `pack_mlp_weights`; y0: [B, D]; tau: [T] increasing
    canonical times (tau = sign * t); sign: +1 or -1; dt0: first step,
    clamped to the span-scaled minimum; f0: the signed derivative at
    (tau[0], y0), computed here when None; max_order in [1, 12];
    max_steps caps the attempts.

    Returns (out [T, B, D], stats [4] int32 on y0's device: nfe (2 an
    accepted attempt, 1 a rejected one; f0 and the first step are the
    caller's), accepted, rejected, status). Status: 0 OK, 1
    MAX_STEPS_REACHED, 2 DT_UNDERFLOW, 3 INVALID_TIMES (tau not strictly
    increasing; the output is then zero beyond row 0).

    n_blocks: the kernel's grid, each block a contiguous range of the
    samples (None: `cuda_kernels.solve_blocks`, one block per SM); it
    changes only the order of the batch sums, which the plain version
    repeats for the same n_blocks.
    """
    _check_activations(activation, final_activation)
    _check_blocks(n_blocks)
    MO = check_max_order(max_order)
    if tau.shape[0] < 2:
        raise ValueError("mlp_solve_vcabm needs at least two output times")
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input)
    if f0 is None:
        f0 = _f0(warrays, dims, y0, tau[0], sign, **kw)
    if _device_kind(y0, f0, warrays) == "cpu":
        return mlp_solve_vcabm_plain(
            warrays, dims, y0, tau, dt0, rtol, atol, sign, f0=f0,
            max_order=MO, safety=safety, ifactor=ifactor, dfactor=dfactor,
            max_steps=max_steps, n_blocks=n_blocks, **kw)

    global mlp_solve_vcabm_launches
    B, D = y0.shape
    T = tau.shape[0]
    route = _check_net("mlp_solve_vcabm", warrays, dims, y0, f0, time_input,
                       T)
    dtype = y0.dtype
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    K = MO + 2
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    # csrc/rk_vcabm.cuh vcabm_state_rows: y, y_next, the evaluation and the
    # three phi stacks (the kernel keeps a block's rows in its shared
    # memory where they fit).
    work = torch.empty((3 + 3 * K) * B * D, dtype=dtype, device=y0.device)
    nb = n_blocks or solve_blocks(B, y0.device)
    gwork = _shares_work(nb, 3, dtype, y0.device)
    gstar = (ctypes.c_double * (K + 1))(*GAMMA_STAR[:K + 1].tolist())
    # Named, so that it lives until the launch has read it.
    tau_d = tau_h.to(y0.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_vcabm_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_vcabm_f64)
    with torch.cuda.device(y0.device):
        err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(warrays), _ptr(out),
                 _ptr(stats), _ptr(work), T, B, D, VCABM_THREADS,
                 float(dt0), float(rtol), float(atol), float(dt_min),
                 float(sign), float(safety), float(ifactor), float(dfactor),
                 int(min(max_steps, _INT32_MAX)), int(valid), MO, gstar,
                 len(dims), _dims_arg(dims), _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), route, _ptr(gwork), gwork.numel(), nb,
                 _stream(y0.device))
    _build.check(err, "mlp_solve_vcabm launch")
    mlp_solve_vcabm_launches += 1
    return out, stats
