"""K14 and K15 in their hosts: the launch wrappers of a generated plan in
K2, K8, K5, K10, K11 and (two plans) K12, of its reverse walk in K3, K6
and K9, their launch counters and their plain PyTorch versions.

Counterpart of `tfdiffeq_tpu/ops/jaxpr_bridge.py:1038` (`plan_solve`: the
adaptive solve, one controller or, with `per_sample`, one a sample),
`tfdiffeq_tpu/ops/pallas_fixed.py:1167` (`plan_solve_fixed`), `:1143`
(`plan_solve_adams`), `:440` (`plan_solve_hyper`) and
`tfdiffeq_tpu/ops/pallas_vcabm.py:449` (`plan_solve_vcabm`). The plan's
right-hand side is CUDA C++ generated for its structure
(`plan_codegen.cuda_source`) and compiled into the host kernel
(`csrc/plan_rhs.cuh` with `csrc/rk_solve.cuh`, `rk_fixed.cuh`,
`rk_perlane.cuh`, `rk_adams.cuh`, `rk_vcabm.cuh`, `rk_hyper.cuh`), one
library a structure and host, built at first use
(`_build.plan_libraries`).

- `plan_solve`: K2 with the plan, one step controller over the batch. An
  uncoupled plan is evaluated a sample a thread, over K2's grid of one
  block per SM; a plan with batch couplings ('bsum', 'bmax') batch-wide,
  every stage segment by segment with a block meet at each coupling, on
  one block (`plan_blocks`). With `per_sample=True`, K5: a
  controller a sample, a group of PERLANE_GROUP threads a sample running
  the plan's group walk (uncoupled plans only; a coupled one raises
  ValueError, as the reference's front end does).
- `plan_solve_fixed`: K8 with the plan on a fixed grid, a group of
  FIXED_GROUP threads a sample running the plan's group walk; a coupled
  plan on one block of PLAN_BLOCK_THREADS threads, every stage batch-wide
  with the block meeting at each coupling (`csrc/plan_rhs.cuh
  PlanBlockRhs` in `rk_fixed.cuh rk_fixed_kernel`).
- `plan_solve_adams` (explicit_adams, fixed_adams) and `plan_solve_vcabm`
  ('adams'): K10 and K11 with the plan; explicit_adams a group of
  FIXED_GROUP threads a sample running the plan's group walk, K11 and
  fixed_adams' K10 a sample a thread over their grids; a coupled plan
  (both Adams methods and VCABM) on their grid kernels at one block of
  PLAN_BLOCK_THREADS threads, batch-wide as in K8.
- `plan_solve_hyper`: K12, the hypersolvers, with two plans, the dynamics
  and the correction net over the stacked [y, f_user], both on the group
  walk, a group of `hyper_group(B)` threads a sample; f's constants (and
  their transposed copy) in shared memory first, g's after them when both
  fit (`last_route['hyper']` and `['hyper_g']`); a coupled plan raises
  NotImplementedError (ROADMAP.md queue 2 item 3). K10 and K12 decide
  status 3 on the card, so their wrappers never wait for it.

K15, the plan's reverse-mode walk (reference `tfdiffeq_tpu/ops/
plan_adjoint.py:154`), generated as CUDA C++ (`plan_codegen.aug_source`'s
`PlanAug`) inside the adjoint sweeps (`csrc/plan_aug.cuh` with
`csrc/rk_adjoint.cuh`):

- `plan_adjoint_solve` (reference `plan_adjoint.py:529`): K3, one
  controller; a coupled plan's walk batch-wide, cut at each coupling and at
  each coupling's transpose with a block meet.
- `plan_perlane_adjoint_solve` (`plan_adjoint.py:469`): K6, a controller a
  sample, under the (y, a_y) seminorm; a coupled plan raises ValueError, as
  in the reference; a group of 16 threads a sample splitting the walk
  (`plan_codegen`'s group walk: each row of a value a member).
- `plan_adjoint_solve_fixed` (`pallas_fixed.py:1019`): K9 on a fixed grid,
  K6's layout and group walk; a coupled plan on one block of
  PLAN_BLOCK_THREADS threads walking the batch as K3 does, cut at each
  coupling and at each coupling's transpose (`csrc/rk_adjoint.cuh
  rk_fixed_adjoint_block_kernel`), each sample's quadratures accumulated
  and summed over the batch in the uncoupled route's order.

Each returns a cotangent for every packed constant (`pack_consts`'
shapes): the shared ones summed over the batch, a per-sample constant's per
sample.

Each wrapper takes its plain version only for tensors on the CPU: the
whole-solve engines of `cuda_kernels.adaptive_solve_plain`,
`cuda_fixed.fixed_solve_plain`, `cuda_perlane.perlane_solve_plain`,
`cuda_adams.adams_solve_plain` and `vcabm_solve_plain` with
`plan_bridge.eval_plan_host` as the right-hand side, K12's step by step in
`plan_solve_hyper_plain`, and the sweeps of
`cuda_adjoint.adjoint_sweep_plain`, `cuda_perlane.perlane_adjoint_plain`
and `cuda_fixed.fixed_adjoint_plain` with `plan_adjoint.aug_terms`. A
CUDA tensor launches the kernel or raises; a failed build or launch raises
RuntimeError.

The constants sit in shared memory when they fit beside the kernel's own
shared arrays within `cuda_kernels.MAX_WEIGHT_BYTES`, else the kernel reads
them from global memory; `last_route` records the choice of the latest
launch on each host ('shared' or 'global'; 'batch/shared' or
'batch/global' where K8, K9, K10 or K11 ran a coupled plan on its one-block
batch-wide route). The plain versions of a coupled plan take their batch
sums in the one block's order (`plan_bridge._batch_sums`,
`plan_adjoint.aug_terms`). `plan_solve_launches`,
`plan_fixed_launches`, `plan_perlane_launches`, `plan_adams_launches`,
`plan_vcabm_launches`, `plan_hyper_launches`, `plan_adjoint_launches`,
`plan_perlane_adjoint_launches` and `plan_fixed_adjoint_launches` count
launches (a K6 or K9 sweep and its block-sum launch count one);
`reset_launch_counts()` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build, cuda_kernels, plan_codegen
from .cuda_adams import (ADAMS_THREADS, VCABM_THREADS, _adams_grid,
                         _adams_nfe, adams_slot_values, adams_solve_plain,
                         adams_work_size, group_layout, on_card,
                         vcabm_solve_plain)
from .cuda_adjoint import ADJOINT_THREADS, _grid_work, adjoint_sweep_plain
from .cuda_fixed import (FIXED_ADJOINT_THREADS, FIXED_GROUP,
                         _fixed_work_size, _solve_work_size,
                         fixed_adjoint_plain, fixed_solve_plain,
                         hermite_drain_plain)
from .cuda_kernels import (MAX_WEIGHT_BYTES, SOLVE_THREADS, TILE_ROWS,
                           _check_blocks, _check_float, _device_kind,
                           _increasing, _ptr, _shares_work, _solve_setup,
                           _stream, _tableau_args, adaptive_solve_plain,
                           solve_blocks)
from .cuda_perlane import (PERLANE_ADJOINT_THREADS, PERLANE_GROUP,
                           PERLANE_THREADS, TILE_THREADS, _group_work_size,
                           _lane_setup, perlane_adjoint_plain,
                           perlane_solve_plain)
from .plan_adjoint import aug_terms, split_consts
from .plan_bridge import (FusedPlan, check_dot_precision, check_plan_adjoint,
                          eval_plan_host, plan_uses_t, tiered_dots)
from .tableaus import FIXED_TABLEAUS_BY_NAME, TABLEAUS_BY_NAME
from ..solvers.adams import GAMMA_STAR
from ..solvers.fixed_adams import (BASHFORTH_TABLE, MOULTON_TABLE,
                                   check_max_order)
from ..solvers.hyper import HYPER_KINDS

Tensor = torch.Tensor

plan_solve_launches = 0
plan_fixed_launches = 0
plan_perlane_launches = 0
plan_adjoint_launches = 0
plan_perlane_adjoint_launches = 0
plan_fixed_adjoint_launches = 0
plan_adams_launches = 0
plan_vcabm_launches = 0
plan_hyper_launches = 0
#: Threads of the one block that runs a coupled plan in K8, K9, K10 and K11
#: (csrc/plan_rhs.cuh kPlanBlockThreads; K2 and K3 launch as many): its
#: meets' tree is `plan_bridge._batch_sums`' order at this count, which
#: `eval_plan_host` and `plan_adjoint.aug_terms` take by default.
PLAN_BLOCK_THREADS = SOLVE_THREADS
#: K12's group (csrc/lane_group.h kHyperFillBlocks, kHyperMaxGroup, where
#: the H100's times that chose them are): 16 threads a sample where the
#: batch fills the card, else up to HYPER_MAX_GROUP.
HYPER_FILL_BLOCKS = 128
HYPER_MAX_GROUP = 64
#: host -> 'shared' or 'global': where the latest launch read the constants
#: (K12: 'hyper' its dynamics', 'hyper_g' its correction net's).
last_route = {}
#: host -> threads a sample of the latest launch's walk: the group walk's
#: group ('perlane', 'fixed', 'perlane_adjoint', 'fixed_adjoint', 'hyper',
#: 'adams' for explicit_adams), or 1 where a thread walks a sample
#: ('adjoint', 'adams' for fixed_adams).
last_group = {}
#: host -> what the latest group launch of explicit_adams' K10 ('adams') or
#: K12 ('hyper') reported (`cuda_adams.group_layout`).
last_layout = {}


def reset_launch_counts() -> None:
    global plan_solve_launches, plan_fixed_launches, plan_perlane_launches
    global plan_adjoint_launches, plan_perlane_adjoint_launches
    global plan_fixed_adjoint_launches, plan_adams_launches
    global plan_vcabm_launches, plan_hyper_launches
    plan_solve_launches = 0
    plan_fixed_launches = 0
    plan_perlane_launches = 0
    plan_adjoint_launches = 0
    plan_perlane_adjoint_launches = 0
    plan_fixed_adjoint_launches = 0
    plan_adams_launches = 0
    plan_vcabm_launches = 0
    plan_hyper_launches = 0


@functools.lru_cache(maxsize=256)
def source(plan, host: str, dot_precision: str = "highest") -> str:
    """The generated CUDA source of `plan` on `host` (`plan_codegen.HOSTS`,
    `AUG_HOSTS`; for 'hyper' the pair (dynamics, correction net)), at
    `dot_precision` (a reduced tier: the tile route of
    `plan_codegen.TIER_HOSTS`)."""
    return plan_codegen.cuda_source(plan, host, dot_precision)


def build(pairs: Sequence[Tuple]) -> list:
    """Build the libraries of several (plan, host) or (plan, host,
    dot_precision) triples at once (one nvcc each, in parallel; a structure
    built before costs nothing)."""
    return _build.plan_libraries([(source(*p), p[1]) for p in pairs])


def plan_rhs(plan: FusedPlan, packed: Sequence[Tensor], sign,
             threads: int = SOLVE_THREADS, dot_precision: str = "highest"):
    """The canonical right-hand side g(s, y) = sign * f(sign * s, y) of a
    plan on the batch-major [B, D] layout, f by `eval_plan_host` (K14's
    plain version, K4's tier at the tiered dots). s is 0-d, or a [B, 1]
    column of per-sample times."""
    def g(s, y):
        s = s.reshape(1, -1) if s.ndim else s
        return sign * eval_plan_host(plan, packed, sign * s, y, threads,
                                     dot_precision)
    return g


def tile_work_bytes(plan: FusedPlan, dot_precision: str, B: int,
                    itemsize: int) -> int:
    """csrc/plan_rhs.cuh plan_tile_bytes: a tiled plan's workspace (the
    tiered dots' bf16 weights, then the stage inputs, the rows' times, the
    outputs, the live rows and the reduced values)."""
    lay = plan_codegen.layout(plan, dot_precision)
    return (-(-2 * lay.w16_values // 256) * 256 + itemsize * (
        B * (plan.dim + 1 + plan.out_rows + lay.live_rows) + lay.red_values))


def _tile_args(plan: FusedPlan, dot_precision: str, y0: Tensor, host: str):
    """The tile route's workspace and its size (None and 0 at 'highest');
    records the route in `last_route`."""
    if not tiered_dots(plan, dot_precision):
        return None, 0
    work = torch.empty(tile_work_bytes(plan, dot_precision, y0.shape[0],
                                       y0.element_size()),
                       dtype=torch.uint8, device=y0.device)
    last_route[host] = f"tile/{dot_precision}"
    return work, work.numel()


def _fn(lib, host: str, dtype):
    return getattr(lib, f"tfd_plan_{host}_"
                   f"{'f32' if dtype == torch.float32 else 'f64'}")


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.tfd_plan_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _consts_route(host: str, n_consts: int, extra: int,
                  itemsize: int, batch: bool = False) -> bool:
    """Whether the constants go to shared memory beside the kernel's own
    `extra` shared values; raise when those alone do not fit. `batch`: the
    launch is a coupled plan's one-block batch-wide route."""
    if extra * itemsize > MAX_WEIGHT_BYTES:
        raise ValueError(f"plan on {host}: {extra} grid points and output "
                         f"times need {extra * itemsize} bytes of shared "
                         f"memory, above the {MAX_WEIGHT_BYTES} the kernel "
                         "may use")
    smem = (n_consts + extra) * itemsize <= MAX_WEIGHT_BYTES
    last_route[host] = ("batch/" if batch else "") + ("shared" if smem
                                                      else "global")
    return smem


def batch_rows(plan: FusedPlan, B: int) -> int:
    """csrc/plan_rhs.cuh plan_batch_values: the rows of a coupled plan's
    batch-wide evaluation (stage inputs, outputs, live rows, reduced
    values), after the host's own workspace."""
    lay = plan_codegen.layout(plan)
    return B * (2 * plan.dim + lay.live_rows) + lay.red_values


def plan_walk_values(plan: FusedPlan) -> int:
    """csrc/lane_group.h plan_solve_walk_values: K14's group walk in a K8
    or K5 slot (the sample's inputs, the walk's values, its outputs)."""
    return (plan.dim + plan_codegen.group_values(plan) + plan.out_rows)


def aug_walk_values(plan: FusedPlan) -> int:
    """csrc/lane_group.h plan_aug_walk_values: K15's group walk in a K6 or
    K9 slot (the qr rows, the per-sample constants, the walk's values, f
    and v_y)."""
    lay = plan_codegen.aug_layout(plan)
    return (lay.q_rows + lay.n_sample + plan_codegen.aug_group_values(plan)
            + plan.out_rows + plan.dim)


def fixed_group_work(plan: FusedPlan, S: int, B: int) -> int:
    """The workspace of K8's group route (lane_group.h
    group_solve_work_size of fixed_solve_slot_values with the walk)."""
    return _solve_work_size((S + 3) * plan.dim + plan_walk_values(plan), B,
                            FIXED_GROUP, 0)


def adams_group_work(plan: FusedPlan, max_order: int, B: int) -> int:
    """The workspace of explicit_adams' group route (lane_group.h
    group_solve_work_size of adams_solve_slot_values with the walk)."""
    return _solve_work_size(adams_slot_values(max_order, plan.dim,
                                              plan_walk_values(plan)), B,
                            FIXED_GROUP, 0)


def hyper_group(B: int) -> int:
    """csrc/lane_group.h hyper_group: K12's threads a sample, 16 where the
    blocks of 16 reach HYPER_FILL_BLOCKS (the batch fills the card), else
    the narrowest wider group up to HYPER_MAX_GROUP whose blocks do."""
    g = FIXED_GROUP
    while g < HYPER_MAX_GROUP and -(-B // (ADAMS_THREADS // g)) \
            < HYPER_FILL_BLOCKS:
        g *= 2
    return g


def hyper_group_work(plan_f: FusedPlan, plan_g: FusedPlan, B: int) -> int:
    """K12's workspace (lane_group.h group_solve_work_size of
    hyper_solve_slot_values: the state, the previous node's state and
    derivative, f0, then both walks)."""
    slot = (4 * plan_f.dim + plan_walk_values(plan_f)
            + plan_walk_values(plan_g))
    return _solve_work_size(slot, B, hyper_group(B), 0)


def perlane_group_work(plan: FusedPlan, S: int, B: int) -> int:
    """The workspace of K5's group route (perlane_solve_slot_values with
    the walk)."""
    return _solve_work_size((S + 6) * plan.dim + plan_walk_values(plan), B,
                            PERLANE_GROUP, 0)


def aug_group_work(plan: FusedPlan, S: int, B: int, fixed: bool) -> int:
    """The workspace of K6 (lane_group_work_size) or, `fixed`, K9
    (fixed_group_work_size) with K15's group walk."""
    lay = plan_codegen.aug_layout(plan)
    R = lay.n_quad + lay.time_input
    if fixed:
        return _fixed_work_size(S, B, plan.dim, R + lay.n_sample,
                                aug_walk_values(plan), R)
    return _group_work_size(S, B, plan.dim, R + lay.n_sample,
                            aug_walk_values(plan))


def _inputs(plan: FusedPlan, packed, y0: Tensor, f0: Tensor,
            transposed: bool = False):
    if y0.ndim != 2 or tuple(y0.shape[1:]) != (plan.dim,):
        raise ValueError(f"y0 must be [B, {plan.dim}], got "
                         f"{tuple(y0.shape)}")
    if plan.out_rows != plan.dim:
        raise ValueError("a solve needs a square plan (out_rows == dim)")
    dtype = y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"plan kernels take float32 or float64, got {dtype}")
    for name, x in (("y0", y0), ("f0", f0)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")
    return plan_codegen.flat_consts(plan, [p.to(y0.device, dtype)
                                           for p in packed], y0.shape[0],
                                    transposed)


def plan_solve_plain(plan: FusedPlan, packed: Sequence[Tensor], y0: Tensor,
                     tau: Tensor, dt0, rtol, atol, sign, f0: Tensor, *,
                     method: str = "dopri5", safety: float = 0.9,
                     ifactor: float = 10.0, dfactor: float = 0.2,
                     max_steps: int = 2 ** 31 - 1, per_sample: bool = False,
                     n_blocks: int = None, emit_dense: int = 0,
                     dot_precision: str = "highest"):
    """Plain PyTorch version of `plan_solve`, on y0's device: K2's engine
    (`cuda_kernels.adaptive_solve_plain`, the error sum in the order of a
    grid of `n_blocks` blocks; None: the kernel's grid, `plan_blocks`) or
    with per_sample K5's (`cuda_perlane.perlane_solve_plain`), the plan
    evaluated by `eval_plan` at `dot_precision`. Same contract."""
    _check_dense(emit_dense, per_sample)
    tab = TABLEAUS_BY_NAME[method]
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    g = plan_rhs(plan, [p.to(y0.device, y0.dtype) for p in packed], sgn,
                 dot_precision=dot_precision)
    kw = dict(safety=safety, ifactor=ifactor, dfactor=dfactor,
              max_steps=max_steps)
    if per_sample:
        return perlane_solve_plain(g, y0, f0, tau, dt0, rtol, atol, tab,
                                   **kw)
    tiled = bool(tiered_dots(plan, dot_precision))
    return adaptive_solve_plain(
        g, y0, f0, tau, dt0, rtol, atol, tab, threads=SOLVE_THREADS,
        n_blocks=n_blocks or plan_blocks(plan, y0.shape[0], y0.device,
                                         tiled),
        unit=TILE_ROWS if tiled else 1, emit_dense=emit_dense, **kw)


def _check_dense(emit_dense: int, per_sample: bool) -> None:
    """K2's dense output takes S >= 0 rows and one controller (reference
    jaxpr_bridge.py:1079-1081)."""
    if emit_dense < 0:
        raise ValueError(f"emit_dense must be >= 0, got {emit_dense}")
    if emit_dense and per_sample:
        raise ValueError("per_sample=True is unpacked only (no emit_dense): "
                         "per-sample steps have no shared interpolant "
                         "sequence")


def plan_blocks(plan: FusedPlan, B: int, device, tiled: bool = False) -> int:
    """The grid of K2, K3 or K11 for a plan: `cuda_kernels.solve_blocks`
    (`tiled`: K2's tile route, one block at most a tile of TILE_ROWS
    samples), or one block for a coupled plan (its evaluation meets the
    block inside a stage)."""
    return 1 if plan.batch_coupled else solve_blocks(
        B, device, TILE_ROWS if tiled else 1)


def _plan_grid(plan: FusedPlan, n_blocks, what: str) -> None:
    """Refuse a grid of more than one block for a coupled plan, before any
    launch."""
    _check_blocks(n_blocks)
    if (n_blocks or 1) != 1 and plan.batch_coupled:
        raise ValueError(f"a coupled plan's {what} runs on one block, got "
                         f"n_blocks={n_blocks}")


def plan_solve(plan: FusedPlan, packed: Sequence[Tensor], y0: Tensor,
               tau: Tensor, dt0, rtol, atol, sign, f0: Tensor, *,
               method: str = "dopri5", safety: float = 0.9,
               ifactor: float = 10.0, dfactor: float = 0.2,
               max_steps: int = 2 ** 31 - 1, per_sample: bool = False,
               n_blocks: int = None, emit_dense: int = 0,
               dot_precision: str = "highest"):
    """Whole-solve adaptive RK with the plan as right-hand side, one launch.

    packed: `plan_bridge.pack_consts`' output; y0, f0: [B, D] state and its
    signed derivative at tau[0]; tau: [T] increasing canonical times (tau =
    sign * t); dt0: the first step (per_sample: one a sample, [B], or one
    for all). Returns (out [T, B, D], stats [4] int32), and with
    per_sample also lane_stats [4, B], as `cuda_kernels.mlp_solve` and
    `cuda_perlane.mlp_solve_perlane` do.

    n_blocks: K2's grid (None: `plan_blocks`, one block per SM); a coupled
    plan runs on one block and refuses another count (ValueError). K5
    (per_sample) takes no grid argument.

    emit_dense = S > 0: K2 also keeps its first S accepted steps'
    interpolants and returns (out, stats, meta [S, 3], coef [S, 5, B, D]),
    as the reference's `plan_solve` does (its coefficients [5 S, D, B]
    feature-major): meta rows (t0, t1, dt) in tau, +inf past the last
    accepted step; coef rows (ca, cb, cc, df0, y0) of
    (((ca x + cb) x + cc) x + df0) x + y0, zero past the last. The
    reference ties the step budget to the rows (max_steps = S); so do the
    callers here. per_sample refuses it (ValueError).

    dot_precision ('mixed', 'bf16'): K4's tier at every dot whose `mxu`
    flag is set (reference jaxpr_bridge.py:979-983). The plan then runs on
    its tile route (csrc/plan_rhs.cuh PlanTileRhs, `last_route` 'tile/...'):
    K2 over 16-row tiles, each block its share (`plan_blocks` with tiles),
    a coupled plan on one block; with per_sample K5's tile engine, 16
    samples a block in lockstep. The bf16 weight pack is a launch of its
    own; `cuda_kernels.dot_tier_launches` counts the solve once.
    """
    check_dot_precision(dot_precision)
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    if per_sample and plan.batch_coupled:
        raise ValueError(
            "per_sample=True with batch-coupled dynamics (a cross-sample "
            "reduction like y.mean(0)) is unsupported: per-sample stepping "
            "would mix samples at different times")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    _check_dense(emit_dense, per_sample)
    _plan_grid(plan, n_blocks, "solve")
    if per_sample and n_blocks is not None:
        raise ValueError("per_sample=True (K5) takes no n_blocks")
    tab = TABLEAUS_BY_NAME[method]
    if _device_kind(y0, f0) == "cpu":
        return plan_solve_plain(plan, packed, y0, tau, dt0, rtol, atol, sign,
                                f0, method=method, safety=safety,
                                ifactor=ifactor, dfactor=dfactor,
                                max_steps=max_steps, per_sample=per_sample,
                                n_blocks=n_blocks, emit_dense=emit_dense,
                                dot_precision=dot_precision)

    global plan_solve_launches, plan_perlane_launches
    tiled = bool(tiered_dots(plan, dot_precision))
    consts, sample_consts = _inputs(plan, packed, y0, f0,
                                    per_sample and not tiled)
    dtype, dev = y0.dtype, y0.device
    B, D = y0.shape
    T = tau.shape[0]
    S = tab.stages
    lay = plan_codegen.layout(plan)
    c, a, b_sol, b_err = _tableau_args(tab)
    c_mid = (None if tab.c_mid is None
             else (ctypes.c_double * S)(*tab.c_mid))
    out = torch.empty((T, B, D), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    steps = int(min(max_steps, 2 ** 31 - 1))
    isz = y0.element_size()
    if per_sample:
        # K5's group walk: the constants and their transposed copy; or its
        # tile engine with the constants in global memory.
        host = "perlane"
        lib = build([(plan, host, dot_precision)])[0]
        tile, tile_bytes = _tile_args(plan, dot_precision, y0, host)
        if tiled:
            n_c, smem, group = lay.n_consts, False, TILE_THREADS
            n_work = (S + 6) * B * D
        else:
            n_c, group = 2 * lay.n_consts, PERLANE_GROUP
            smem = _consts_route(host, n_c, T, isz)
            n_work = perlane_group_work(plan, S, B)
        last_group[host] = group
        # Named, so that they live until the launch has read them.
        tau_h, dt_min, dt0_d, valid = _lane_setup(tau, dt0, B, dtype, dev)
        tau_d = tau_h.to(dev)
        lane = torch.empty((4, B), dtype=torch.int32, device=dev)
        work = torch.empty(n_work, dtype=dtype, device=dev)
        with torch.cuda.device(dev):
            err = _fn(lib, host, dtype)(
                _ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(dt0_d), _ptr(out),
                _ptr(lane), _ptr(stats), _ptr(work), n_work, T, B, D,
                group, float(rtol), float(atol), float(dt_min),
                float(sign), float(safety), float(ifactor), float(dfactor),
                steps, int(valid), S, tab.order, int(tab.fsal), c, a, b_sol,
                b_err, c_mid, _ptr(consts), n_c, _ptr(sample_consts),
                int(smem), _ptr(tile) if tiled else None, tile_bytes,
                _stream(dev))
        _check(lib, err, "plan_solve(per_sample=True) launch")
        plan_perlane_launches += 1
        cuda_kernels.dot_tier_launches += tiled
        return out, stats, lane

    host = "solve"
    lib = build([(plan, host, dot_precision)])[0]
    tile, tile_bytes = _tile_args(plan, dot_precision, y0, host)
    smem = (False if tiled
            else _consts_route(host, lay.n_consts, SOLVE_THREADS, isz))
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(dev)
    n_work = (S + 5) * B * D
    if lay.segments > 1 and not tiled:
        # The batch route's rows (csrc/plan_rhs.cuh PlanBatchRhs).
        n_work += batch_rows(plan, B)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    nb = n_blocks or plan_blocks(plan, B, dev, tiled)
    if tiled and nb > -(-B // TILE_ROWS):
        raise ValueError(f"K2's tile route takes at most one block a tile "
                         f"of {TILE_ROWS} samples ({-(-B // TILE_ROWS)} at "
                         f"B = {B}), got n_blocks={nb}")
    gwork = _shares_work(nb, 2, dtype, dev)
    meta = coef = None
    if emit_dense:
        # S * 5 * B * D values: 168 MB in float32 at B = 4096, D = 2,
        # S = 1024 (the kernel indexes them with long).
        meta = torch.full((emit_dense, 3), float("inf"), dtype=dtype,
                          device=dev)
        coef = torch.zeros((emit_dense, 5, B, D), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(out), _ptr(stats),
            _ptr(work), T, B, D, SOLVE_THREADS, float(dt0), float(rtol),
            float(atol), float(dt_min), float(sign), float(safety),
            float(ifactor), float(dfactor), steps, int(valid), S, tab.order,
            int(tab.fsal), c, a, b_sol, b_err, c_mid, _ptr(consts),
            lay.n_consts, _ptr(sample_consts), int(smem), _ptr(gwork),
            gwork.numel(), nb, _ptr(meta) if emit_dense else None,
            _ptr(coef) if emit_dense else None, int(emit_dense),
            _ptr(tile) if tiled else None, tile_bytes, _stream(dev))
    _check(lib, err, "plan_solve launch")
    plan_solve_launches += 1
    cuda_kernels.dot_tier_launches += tiled
    if emit_dense:
        return out, stats, meta, coef
    return out, stats


def plan_solve_fixed_plain(plan: FusedPlan, packed: Sequence[Tensor],
                           y0: Tensor, tau: Tensor, grid: Tensor, sign,
                           f0: Tensor, *, method: str = "rk4",
                           dot_precision: str = "highest"
                           ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of `plan_solve_fixed`, on y0's device: K8's
    engine (`cuda_fixed.fixed_solve_plain`) with `eval_plan` at
    `dot_precision`, a coupled plan's batch sums in the order of K8's one
    block."""
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    # A coupled plan's meets fold over its one block's threads: the tile
    # route's TILE_THREADS, else PLAN_BLOCK_THREADS.
    threads = (TILE_THREADS if tiered_dots(plan, dot_precision)
               else PLAN_BLOCK_THREADS)
    g = plan_rhs(plan, [p.to(y0.device, y0.dtype) for p in packed], sgn,
                 threads, dot_precision)
    return fixed_solve_plain(g, y0, f0, tau, grid,
                             FIXED_TABLEAUS_BY_NAME[method])


def plan_solve_fixed(plan: FusedPlan, packed: Sequence[Tensor], y0: Tensor,
                     tau: Tensor, grid: Tensor, sign, f0: Tensor, *,
                     method: str = "rk4", dot_precision: str = "highest"
                     ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fixed-grid RK (euler, midpoint, rk4, rk4_38) with the
    plan as right-hand side, one K8 launch. tau: [T] canonical output
    times; grid: [G] canonical step grid; f0: the signed derivative at
    grid[0]. Returns (out [T, B, D], stats [4] int32), as
    `cuda_fixed.mlp_solve_fixed` does. A coupled plan runs on one block of
    PLAN_BLOCK_THREADS threads (the batch-wide route). A reduced
    dot_precision takes the tile route (csrc/plan_rhs.cuh PlanTileRhs in
    rk_fixed_kernel): a block of TILE_THREADS threads a 16-row tile, K4's
    product at each tiered dot, a coupled plan's whole batch on one such
    block (its meets fold over TILE_THREADS threads, as the plain version's
    batch sums do)."""
    if method not in FIXED_TABLEAUS_BY_NAME:
        raise ValueError(f"unknown fixed-grid method {method!r}; available: "
                         f"{sorted(FIXED_TABLEAUS_BY_NAME)}")
    check_dot_precision(dot_precision)
    tab = FIXED_TABLEAUS_BY_NAME[method]
    if _device_kind(y0, f0) == "cpu":
        return plan_solve_fixed_plain(plan, packed, y0, tau, grid, sign, f0,
                                      method=method,
                                      dot_precision=dot_precision)

    global plan_fixed_launches
    coupled = plan.batch_coupled
    tiled = bool(tiered_dots(plan, dot_precision))
    # K8's group walk reads the constants and their transposed copy.
    consts, sample_consts = _inputs(plan, packed, y0, f0,
                                    not coupled and not tiled)
    dtype, dev = y0.dtype, y0.device
    B, D = y0.shape
    T, G = tau.shape[0], grid.shape[0]
    host = "fixed"
    lib = build([(plan, host, dot_precision)])[0]
    lay = plan_codegen.layout(plan)
    S = tab.stages
    tile, tile_bytes = _tile_args(plan, dot_precision, y0, host)
    if tiled:
        n_c, smem, group = lay.n_consts, False, TILE_THREADS
        n_work = (S + 3) * B * D
        last_group[host] = 1
    elif coupled:
        # One block: the meets' scratch beside the constants; the grid and
        # the output times after them where they fit, else read from global
        # memory (csrc/plan_rhs.cuh launch_plan_fixed).
        n_c, group = lay.n_consts, PLAN_BLOCK_THREADS
        smem = _consts_route(host, n_c, PLAN_BLOCK_THREADS,
                             y0.element_size(), batch=True)
        n_work = (S + 3) * B * D + batch_rows(plan, B)
        last_group[host] = 1
    else:
        n_c, group = 2 * lay.n_consts, FIXED_GROUP
        smem = _consts_route(host, n_c, G + T, y0.element_size())
        n_work = fixed_group_work(plan, S, B)
        last_group[host] = FIXED_GROUP
    tau_h = tau.detach().to("cpu", dtype)
    grid_h = grid.detach().to("cpu", dtype)
    valid = _increasing(tau_h) and _increasing(grid_h)
    c, a, b_sol, _ = _tableau_args(tab)
    out = torch.empty((T, B, D), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    # Named, so that they live until the launch has read them.
    grid_d, tau_d = grid_h.to(dev), tau_h.to(dev)
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(grid_d), _ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(out),
            _ptr(stats), _ptr(work), n_work, G, T, B, D, group,
            float(sign), int(valid), S, c, a, b_sol, _ptr(consts), n_c,
            _ptr(sample_consts), int(smem), _ptr(tile) if tiled else None,
            tile_bytes, _stream(dev))
    _check(lib, err, "plan_solve_fixed launch")
    plan_fixed_launches += 1
    cuda_kernels.dot_tier_launches += tiled
    return out, stats


# ---------------------------------------------------------------------------
# K14 inside K10 and K11, and K12 with two plans
# ---------------------------------------------------------------------------

def _refuse_coupled(plans, kernel: str) -> None:
    if any(p.batch_coupled for p in plans):
        raise NotImplementedError(
            f"batch-coupled dynamics in {kernel} are not ported yet: "
            "ROADMAP.md queue 2 item 3 (coupled plans in K12)")


def plan_solve_adams_plain(plan: FusedPlan, packed: Sequence[Tensor],
                           y0: Tensor, tau: Tensor, grid: Tensor, rtol, atol,
                           sign, f0: Tensor, *, implicit: bool = True,
                           max_order: int = 4, max_iters: int = 4,
                           n_blocks: int = None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of `plan_solve_adams`, on y0's device: K10's
    engine (`cuda_adams.adams_solve_plain`, fixed_adams' norm in the order
    of a grid of `n_blocks` blocks; None: the kernel's grid, `plan_blocks`)
    with `eval_plan`."""
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    g = plan_rhs(plan, [p.to(y0.device, y0.dtype) for p in packed], sgn)
    return adams_solve_plain(
        g, y0, f0, tau, grid, rtol, atol, implicit=implicit,
        max_order=max_order, max_iters=max_iters,
        n_blocks=n_blocks or plan_blocks(plan, y0.shape[0], y0.device))


def plan_solve_adams(plan: FusedPlan, packed: Sequence[Tensor], y0: Tensor,
                     tau: Tensor, grid: Tensor, rtol, atol, sign, f0: Tensor,
                     *, implicit: bool = True, max_order: int = 4,
                     max_iters: int = 4, n_blocks: int = None
                     ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fixed-step Adams (explicit_adams with implicit=False,
    fixed_adams) with the plan as right-hand side, one K10 launch
    (reference `pallas_fixed.py:1143`). tau: [T] canonical output times;
    grid: [G] canonical step grid; f0: the signed derivative at grid[0];
    n_blocks: fixed_adams' grid (None: `plan_blocks`, one block per SM). A
    coupled plan runs both methods on K10's grid kernel at one block of
    PLAN_BLOCK_THREADS threads and refuses another count (ValueError).
    Returns (out [T, B, D], stats [4] int32), as
    `cuda_adams.mlp_solve_adams` does."""
    _plan_grid(plan, n_blocks, "Adams solve")
    MO = check_max_order(max_order)
    if int(max_iters) < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if grid.shape[0] < 2:
        raise ValueError("the step grid needs at least two points")
    kw = dict(implicit=implicit, max_order=MO, max_iters=int(max_iters),
              n_blocks=n_blocks)
    if _device_kind(y0, f0) == "cpu":
        return plan_solve_adams_plain(plan, packed, y0, tau, grid, rtol,
                                      atol, sign, f0, **kw)

    global plan_adams_launches
    coupled = plan.batch_coupled
    # explicit_adams' group walk reads the constants' transposed copy too.
    consts, sample_consts = _inputs(plan, packed, y0, f0,
                                    not (implicit or coupled))
    dtype, dev = y0.dtype, y0.device
    B, D = y0.shape
    T, G = tau.shape[0], grid.shape[0]
    host = "adams"
    lib = build([(plan, host)])[0]
    lay = plan_codegen.layout(plan)
    if coupled:
        # Both methods on the grid kernel's one block: the meets' scratch
        # beside the constants, the engine's rows then the batch rows.
        n_c, group = lay.n_consts, 0
        smem = _consts_route(host, n_c,
                             G + T + ADAMS_THREADS + PLAN_BLOCK_THREADS,
                             y0.element_size(), batch=True)
        n_work = adams_work_size(MO, B, D) + batch_rows(plan, B)
    elif implicit:
        n_c, group = lay.n_consts, 0
        smem = _consts_route(host, n_c, G + T + ADAMS_THREADS,
                             y0.element_size())
        n_work = adams_work_size(MO, B, D)
    else:
        n_c, group = 2 * lay.n_consts, FIXED_GROUP
        smem = _consts_route(host, n_c, G + T, y0.element_size())
        n_work = adams_group_work(plan, MO, B)
    dbl = lambda a: (ctypes.c_double * a.size)(*a.reshape(-1).tolist())
    out = torch.empty((T, B, D), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    if coupled:
        nb, gwork = 1, _shares_work(1, 1, dtype, dev)
    else:
        nb, gwork = _adams_grid(implicit, n_blocks, B, dtype, dev)
    # Named, so that they live until the launch has read them.
    grid_d, tau_d = on_card(grid, dtype, dev), on_card(tau, dtype, dev)
    reported = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(grid_d), _ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(out),
            _ptr(stats), _ptr(work), n_work, G, T, B, D, ADAMS_THREADS,
            group, float(sign), float(rtol), float(atol), MO,
            int(max_iters), int(bool(implicit)),
            _adams_nfe(G, MO, int(max_iters), bool(implicit)),
            dbl(BASHFORTH_TABLE[:MO, :MO]), dbl(MOULTON_TABLE[:MO, :MO]),
            _ptr(consts), n_c, _ptr(sample_consts), int(smem),
            _ptr(gwork), gwork.numel(), nb, reported, _stream(dev))
    _check(lib, err, "plan_solve_adams launch")
    last_group[host] = group or 1
    last_layout[host] = group_layout(reported)
    plan_adams_launches += 1
    return out, stats


def plan_solve_vcabm_plain(plan: FusedPlan, packed: Sequence[Tensor],
                           y0: Tensor, tau: Tensor, dt0, rtol, atol, sign,
                           f0: Tensor, *, max_order: int = 12,
                           safety: float = 0.9, ifactor: float = 10.0,
                           dfactor: float = 0.2,
                           max_steps: int = 2 ** 31 - 1,
                           n_blocks: int = None
                           ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of `plan_solve_vcabm`, on y0's device: K11's
    engine (`cuda_adams.vcabm_solve_plain`, its sums in the order of a grid
    of `n_blocks` blocks; None: the kernel's grid, `plan_blocks`) with
    `eval_plan`."""
    sgn = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    g = plan_rhs(plan, [p.to(y0.device, y0.dtype) for p in packed], sgn)
    return vcabm_solve_plain(
        g, y0, f0, tau, dt0, rtol, atol, max_order=max_order, safety=safety,
        ifactor=ifactor, dfactor=dfactor, max_steps=max_steps,
        n_blocks=n_blocks or plan_blocks(plan, y0.shape[0], y0.device))


def plan_solve_vcabm(plan: FusedPlan, packed: Sequence[Tensor], y0: Tensor,
                     tau: Tensor, dt0, rtol, atol, sign, f0: Tensor, *,
                     max_order: int = 12, safety: float = 0.9,
                     ifactor: float = 10.0, dfactor: float = 0.2,
                     max_steps: int = 2 ** 31 - 1, n_blocks: int = None
                     ) -> Tuple[Tensor, Tensor]:
    """Whole-solve VCABM ('adams') with the plan as right-hand side, one K11
    launch (reference `pallas_vcabm.py:449`). tau: [T] increasing canonical
    times; dt0: the first step, clamped to the span-scaled minimum; f0: the
    signed derivative at tau[0]; max_steps caps the attempts; n_blocks:
    K11's grid (None: `plan_blocks`, one block per SM; a coupled plan one
    block of PLAN_BLOCK_THREADS threads, and it refuses another count).
    Returns (out [T, B, D], stats [4] int32), as
    `cuda_adams.mlp_solve_vcabm` does."""
    _plan_grid(plan, n_blocks, "VCABM solve")
    MO = check_max_order(max_order)
    if tau.shape[0] < 2:
        raise ValueError("plan_solve_vcabm needs at least two output times")
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    kw = dict(max_order=MO, safety=safety, ifactor=ifactor, dfactor=dfactor,
              max_steps=int(max_steps))
    if _device_kind(y0, f0) == "cpu":
        return plan_solve_vcabm_plain(plan, packed, y0, tau, dt0, rtol, atol,
                                      sign, f0, n_blocks=n_blocks, **kw)

    global plan_vcabm_launches
    consts, sample_consts = _inputs(plan, packed, y0, f0)
    dtype, dev = y0.dtype, y0.device
    B, D = y0.shape
    T = tau.shape[0]
    host = "vcabm"
    lib = build([(plan, host)])[0]
    lay = plan_codegen.layout(plan)
    coupled = plan.batch_coupled
    # A coupled plan's one block keeps the meets' scratch beside the
    # constants, and its batch rows after the engine's.
    smem = _consts_route(host, lay.n_consts,
                         T + VCABM_THREADS
                         + (PLAN_BLOCK_THREADS if coupled else 0),
                         y0.element_size(), batch=coupled)
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    K = MO + 2
    out = torch.empty((T, B, D), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    # csrc/rk_vcabm.cuh vcabm_state_rows.
    n_work = (3 + 3 * K) * B * D + (batch_rows(plan, B) if coupled else 0)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    nb = n_blocks or plan_blocks(plan, B, dev)
    gwork = _shares_work(nb, 3, dtype, dev)
    gstar = (ctypes.c_double * (K + 1))(*GAMMA_STAR[:K + 1].tolist())
    # Named, so that it lives until the launch has read it.
    tau_d = tau_h.to(dev)
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(out), _ptr(stats),
            _ptr(work), T, B, D, VCABM_THREADS, float(dt0), float(rtol),
            float(atol), float(dt_min), float(sign), float(safety),
            float(ifactor), float(dfactor), int(min(max_steps, 2 ** 31 - 1)),
            int(valid), MO, gstar, _ptr(consts), lay.n_consts,
            _ptr(sample_consts), int(smem), _ptr(gwork), gwork.numel(), nb,
            n_work, _stream(dev))
    _check(lib, err, "plan_solve_vcabm launch")
    plan_vcabm_launches += 1
    return out, stats


def _hyper_inputs(plan_f: FusedPlan, plan_g: FusedPlan, y0: Tensor,
                  kind: str) -> None:
    if kind not in HYPER_KINDS:
        raise ValueError(f"kind must be one of {sorted(HYPER_KINDS)}, got "
                         f"{kind!r}")
    D = plan_f.dim
    if plan_f.out_rows != D or plan_g.dim != 2 * D or plan_g.out_rows != D:
        raise ValueError(
            f"K12 takes a square dynamics plan [B, D] -> [B, D] and a "
            f"correction plan [B, 2 D] -> [B, D]; got {plan_f.dim} -> "
            f"{plan_f.out_rows} and {plan_g.dim} -> {plan_g.out_rows}")
    if y0.ndim != 2 or y0.shape[1] != D:
        raise ValueError(f"y0 must be [B, {D}], got {tuple(y0.shape)}")


def plan_solve_hyper_plain(plan_f: FusedPlan, plan_g: FusedPlan,
                           packed_f: Sequence[Tensor],
                           packed_g: Sequence[Tensor], y0: Tensor,
                           tau: Tensor, grid: Tensor, sign, *,
                           kind: str = "euler", grid_is_t: bool = False
                           ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of `plan_solve_hyper`: K12's arithmetic step
    by step in the kernel's order (csrc/rk_hyper.cuh), both plans by
    `eval_plan`, on y0's device. Same contract."""
    _hyper_inputs(plan_f, plan_g, y0, kind)
    dev, dtype = y0.device, y0.dtype
    T, G = tau.shape[0], grid.shape[0]
    tau_h = tau.detach().to("cpu", dtype)
    grid_h = grid.detach().to("cpu", dtype)
    tau_d, grid_d = tau_h.to(dev), grid_h.to(dev)
    sgn = torch.as_tensor(sign, dtype=dtype).to(dev)
    pf = [p.to(dev, dtype) for p in packed_f]
    pg = [p.to(dev, dtype) for p in packed_g]
    f = plan_rhs(plan_f, pf, sgn)
    power, evals = HYPER_KINDS[kind]
    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    if not (_increasing(tau_h) and _increasing(grid_h)):
        # Non-monotonic times: status 3, output zero beyond row 0.
        return out, torch.tensor([0, 0, 0, 3], dtype=torch.int32, device=dev)
    y = y0
    oi = 1
    for i in range(G - 1):
        t0, t1 = grid_d[i], grid_d[i + 1]
        dt = t1 - t0
        f0 = f(t0, y)
        if not grid_is_t:
            if i > 0:
                # The previous interval's drain, one step late.
                oi = hermite_drain_plain(out, oi, tau_h, tau_d, grid_h[i],
                                         grid_d[i - 1], t0, yp, y, fp, f0,
                                         False)
            yp, fp = y, f0
        if kind == "euler":
            base = f0
        elif kind == "midpoint":
            h = 0.5 * dt
            base = f(t0 + h, y + h * f0)
        else:
            base = 0.5 * (f0 + f(t1, y + dt * f0))
        corr = eval_plan_host(plan_g, pg, sgn * t0,
                              torch.cat([y, sgn * f0], dim=1))
        sdt = sgn * dt
        sdt_p = sdt * sdt
        for _ in range(power - 2):
            sdt_p = sdt_p * sdt
        y = y + dt * base + sdt_p * corr
        if grid_is_t:
            out[i + 1] = y
    nfe = evals * (G - 1)
    if not grid_is_t:
        hermite_drain_plain(out, oi, tau_h, tau_d, grid_h[G - 1],
                            grid_d[G - 2], grid_d[G - 1], yp, y, fp,
                            f(grid_d[G - 1], y), True)
        nfe += 1
    stats = torch.tensor([nfe, G - 1, 0, 0], dtype=torch.int32, device=dev)
    return out, stats


def plan_solve_hyper(plan_f: FusedPlan, plan_g: FusedPlan,
                     packed_f: Sequence[Tensor], packed_g: Sequence[Tensor],
                     y0: Tensor, tau: Tensor, grid: Tensor, sign, *,
                     kind: str = "euler", grid_is_t: bool = False
                     ) -> Tuple[Tensor, Tensor]:
    """Whole-solve hypersolver, one K12 launch with two plans as its
    right-hand sides (reference `pallas_fixed.py:440`): `plan_f` the
    dynamics (square), `plan_g` the correction net over the stacked
    [y, f_user] ([B, 2 D] -> [B, D], `build_plan(out_dim=D)`). kind:
    'euler', 'midpoint' or 'heun'; tau: [T] canonical output times; grid:
    [G] canonical step grid; grid_is_t: the grid is tau (the outputs are
    the nodes), else they are drained by cubic-Hermite interpolation one
    step late. Returns (out [T, B, D], stats [4] int32: nfe = evaluations
    of f, steps, 0, status; 3 with a zero tail for times that do not
    increase)."""
    _refuse_coupled([plan_f, plan_g], "K12")
    _hyper_inputs(plan_f, plan_g, y0, kind)
    if grid.shape[0] < 2:
        raise ValueError("the step grid needs at least two points")
    kw = dict(kind=kind, grid_is_t=bool(grid_is_t))
    if _device_kind(y0) == "cpu":
        return plan_solve_hyper_plain(plan_f, plan_g, packed_f, packed_g, y0,
                                      tau, grid, sign, **kw)

    global plan_hyper_launches
    dtype, dev = y0.dtype, y0.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"plan kernels take float32 or float64, got {dtype}")
    B, D = y0.shape
    T, G = tau.shape[0], grid.shape[0]
    host = "hyper"
    lib = build([((plan_f, plan_g), host)])[0]
    # Both group walks read their constants' transposed copies too.
    cf, sf = plan_codegen.flat_consts(
        plan_f, [p.to(dev, dtype) for p in packed_f], B, True)
    cg, sg = plan_codegen.flat_consts(
        plan_g, [p.to(dev, dtype) for p in packed_g], B, True)
    n_f = 2 * plan_codegen.layout(plan_f).n_consts
    n_g = 2 * plan_codegen.layout(plan_g).n_consts
    isz = y0.element_size()
    # f's constants first, then g's after them (csrc/rk_hyper.cuh).
    smem_f = _consts_route(host, n_f, G + T, isz)
    smem_g = _consts_route("hyper_g", n_g, G + T + (n_f if smem_f else 0),
                           isz)
    y0c = y0.contiguous()
    out = torch.empty((T, B, D), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    n_work = hyper_group_work(plan_f, plan_g, B)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    # Named, so that they live until the launch has read them.
    grid_d, tau_d = on_card(grid, dtype, dev), on_card(tau, dtype, dev)
    reported = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(grid_d), _ptr(tau_d), _ptr(y0c), _ptr(out), _ptr(stats),
            _ptr(work), n_work, G, T, B, D, float(sign),
            list(HYPER_KINDS).index(kind), int(bool(grid_is_t)), _ptr(cf),
            n_f, _ptr(sf), int(smem_f), _ptr(cg), n_g, _ptr(sg),
            int(smem_g), reported, _stream(dev))
    _check(lib, err, "plan_solve_hyper launch")
    last_group[host] = reported[0]
    last_layout[host] = group_layout(reported)
    plan_hyper_launches += 1
    return out, stats


# ---------------------------------------------------------------------------
# K15: the plan's reverse walk inside K3, K6 and K9
# ---------------------------------------------------------------------------

def _quad_counts(plan: FusedPlan) -> Tuple[int, bool, int]:
    """(shared quadratures: the flat constants' count, whether a_t joins
    them, per-sample quadratures: the per-sample constants' rows)."""
    _, n_flat, _, n_rows = plan_codegen._const_layout(plan)
    return n_flat, plan_uses_t(plan), n_rows


def plan_aug(plan: FusedPlan, packed: Sequence[Tensor]):
    """K15's plain version as the plain sweeps take it: aug(t, y [B, D],
    a_y [B, D]) -> (f, v_y, xw [B, n_flat], v_t [B] or None, xs [B, n_rows])
    by `plan_adjoint.aug_terms`; t is 0-d, or [B] per-sample times."""
    ti = plan_uses_t(plan)

    def aug(t, y, ay):
        tt = t.reshape(1, -1) if t.ndim else t
        f, v_y, xq, xs, v_t = aug_terms(plan, packed, tt, y.t(), ay.t())
        return f.t(), v_y.t(), xq.t(), (v_t[0] if ti else None), xs.t()
    return aug


def fixed_block_work(plan: FusedPlan, S: int, B: int) -> int:
    """The workspace of K9's one-block sweep of a coupled plan
    (csrc/rk_adjoint.cuh fixed_block_own_values, then the batch-wide walk's
    rows, csrc/plan_aug.cuh plan_batch_aug_values)."""
    lay = plan_codegen.aug_layout(plan)
    n_q = lay.n_quad + lay.time_input + lay.n_sample
    return ((4 + 2 * S) * B * plan.dim + 2 * n_q * B
            + B * (lay.q_rows + 4 * plan.dim + lay.live_rows)
            + lay.red_values)


def _adjoint_inputs(plan: FusedPlan, packed, ys: Tensor, g: Tensor,
                    name: str):
    check_plan_adjoint(plan)
    if ys.ndim != 3 or g.shape != ys.shape:
        raise ValueError(f"{name}: ys and g must both be [T, B, D], got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    if ys.shape[1] != plan.batch or ys.shape[2] != plan.dim:
        raise ValueError(f"{name}: ys is {tuple(ys.shape)}, the plan takes "
                         f"[T, {plan.batch}, {plan.dim}]")
    if plan.out_rows != plan.dim:
        raise ValueError(f"{name}: the sweep needs a square plan "
                         "(out_rows == dim)")
    dtype = ys.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    _check_float("g", g, dtype)
    return [p.to(ys.device, dtype) for p in packed]


def plan_adjoint_solve_plain(plan: FusedPlan, packed: Sequence[Tensor],
                             ys: Tensor, g: Tensor, tau: Tensor, dt0, rtol,
                             atol, sign, *, method: str = "dopri5",
                             safety: float = 0.9, ifactor: float = 10.0,
                             dfactor: float = 0.2,
                             max_steps: int = 2 ** 31 - 1,
                             seminorm: bool = False, n_blocks: int = None):
    """Plain PyTorch version of `plan_adjoint_solve`, on ys' device: K3's
    engine (`cuda_adjoint.adjoint_sweep_plain`) with `aug_terms`, its sums
    in the order of a grid of `n_blocks` blocks (None: the kernel's grid,
    `plan_blocks`)."""
    packed = _adjoint_inputs(plan, packed, ys, g, "plan_adjoint_solve")
    n_flat, ti, n_rows = _quad_counts(plan)
    ay0, aw, at, aps, stats = adjoint_sweep_plain(
        plan_aug(plan, packed), n_flat, ti, n_rows, ys, g, tau, dt0, rtol,
        atol, sign, seminorm=seminorm, method=method, safety=safety,
        ifactor=ifactor, dfactor=dfactor, max_steps=max_steps,
        n_blocks=n_blocks or plan_blocks(plan, ys.shape[1],
                                                 ys.device))
    return ay0, split_consts(plan, packed, aw, aps.t()), at, stats


def plan_adjoint_solve(plan: FusedPlan, packed: Sequence[Tensor],
                       ys: Tensor, g: Tensor, tau: Tensor, dt0, rtol, atol,
                       sign, *, method: str = "dopri5", safety: float = 0.9,
                       ifactor: float = 10.0, dfactor: float = 0.2,
                       max_steps: int = 2 ** 31 - 1, seminorm: bool = False,
                       n_blocks: int = None):
    """Fused adjoint backward sweep of a plan's dynamics, one K3 launch with
    K15 as its augmented right-hand side (reference `plan_adjoint.py:529`).

    packed: `plan_bridge.pack_consts`' output; ys, g: [T, B, D] forward
    trajectory and output cotangents at the canonical times tau ([T],
    increasing; sign as in `plan_solve`); dt0: the first backward step in
    sigma = -tau, clamped to the span-scaled minimum; seminorm: leave the
    constants' and the time quadratures out of the step control.

    Returns (ay0 [B, D] = dL/dy0, dconsts: one cotangent a packed constant
    in its shape, at (0-d, the integrated a_t quadrature; 0 when the plan
    does not read t), stats [4] int32: nfe, accepted, rejected, status).

    n_blocks: K3's grid (None: `plan_blocks`), as in
    `mlp_adjoint_solve`; a coupled plan (the block meets inside a stage)
    runs on one block, and refuses another count."""
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    kw = dict(method=method, safety=safety, ifactor=ifactor,
              dfactor=dfactor, max_steps=max_steps, seminorm=seminorm)
    _plan_grid(plan, n_blocks, "sweep")
    if _device_kind(ys, g) == "cpu":
        return plan_adjoint_solve_plain(plan, packed, ys, g, tau, dt0, rtol,
                                        atol, sign, n_blocks=n_blocks, **kw)

    global plan_adjoint_launches
    packed = _adjoint_inputs(plan, packed, ys, g, "plan_adjoint_solve")
    dtype, dev = ys.dtype, ys.device
    T, B, D = ys.shape
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    host = "adjoint"
    lib = build([(plan, host)])[0]
    lay = plan_codegen.aug_layout(plan)
    consts, sample_consts = plan_codegen.flat_consts(plan, packed, B)
    # K3 walks a sample a thread (or a coupled plan batch-wide).
    last_group[host] = 1
    n_quad = 2 * lay.n_quad + S * (lay.n_quad + lay.time_input)
    # Shared memory for the constants first (read in every stage), then the
    # shared quadratures' accumulator, increment and stage values.
    isz = ys.element_size()
    smem = _consts_route(host, lay.n_quad, ADJOINT_THREADS, isz)
    quad_smem = ((lay.n_quad if smem else 0) + n_quad
                 + ADJOINT_THREADS) * isz <= MAX_WEIGHT_BYTES
    tau_h, dt_min, dt0, _ = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(dev)
    c, a, b_sol, b_err = _tableau_args(tab)
    ay0 = torch.empty((B, D), dtype=dtype, device=dev)
    aw = torch.empty(max(1, lay.n_quad), dtype=dtype, device=dev)
    at = torch.empty((), dtype=dtype, device=dev)
    aps = torch.empty((max(1, lay.n_sample), B), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    # The engine's rows (csrc/rk_adjoint.cuh rk_adjoint_work_size), then
    # the walk's: qr, and on the batch route X, AX, FO, VO, the live rows
    # and the reduced values (csrc/plan_aug.cuh).
    n_work = ((6 + 2 * S) * B * D + (2 + S) * lay.n_sample * B
              + lay.q_rows * B)
    if lay.segments > 1:
        n_work += 4 * B * D + lay.live_rows * B + lay.red_values
    work = torch.empty(max(1, n_work), dtype=dtype, device=dev)
    pwork = torch.empty(1 if quad_smem else n_quad, dtype=dtype, device=dev)
    nb = n_blocks or plan_blocks(plan, B, dev)
    gwork = _grid_work(S, nb, lay.n_quad + lay.time_input, dtype, dev)
    ys_c, g_c = ys.contiguous(), g.contiguous()
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(tau_d), _ptr(ys_c), _ptr(g_c), _ptr(ay0), _ptr(aw),
            _ptr(at), _ptr(aps), _ptr(stats), _ptr(work), _ptr(pwork), T, B,
            D, ADJOINT_THREADS, float(dt0), float(rtol), float(atol),
            float(dt_min), float(sign), float(safety), float(ifactor),
            float(dfactor), int(min(max_steps, 2 ** 31 - 1)), int(seminorm),
            S, tab.order, c, a, b_sol, b_err, _ptr(consts), lay.n_quad,
            _ptr(sample_consts), int(smem), int(quad_smem), _ptr(gwork),
            gwork.numel(), nb, _stream(dev))
    _check(lib, err, "plan_adjoint_solve launch")
    plan_adjoint_launches += 1
    return (ay0, split_consts(plan, packed, aw[:lay.n_quad],
                                  aps[:lay.n_sample]), at, stats)


def plan_perlane_adjoint_solve_plain(plan: FusedPlan,
                                     packed: Sequence[Tensor], ys: Tensor,
                                     g: Tensor, tau: Tensor, dt0, rtol, atol,
                                     sign, *, method: str = "dopri5",
                                     safety: float = 0.9,
                                     ifactor: float = 10.0,
                                     dfactor: float = 0.2,
                                     max_steps: int = 2 ** 31 - 1):
    """Plain PyTorch version of `plan_perlane_adjoint_solve`: K6's engine
    (`cuda_perlane.perlane_adjoint_plain`) with `aug_terms`."""
    packed = _adjoint_inputs(plan, packed, ys, g,
                             "plan_perlane_adjoint_solve")
    n_flat, ti, n_rows = _quad_counts(plan)
    ay0, aw, at, aps, stats, lane = perlane_adjoint_plain(
        plan_aug(plan, packed), n_flat, ti, n_rows, ys, g, tau, dt0, rtol,
        atol, sign, method=method, safety=safety, ifactor=ifactor,
        dfactor=dfactor, max_steps=max_steps)
    return (ay0, split_consts(plan, packed, aw, aps.t()), at, stats,
            lane)


def plan_perlane_adjoint_solve(plan: FusedPlan, packed: Sequence[Tensor],
                               ys: Tensor, g: Tensor, tau: Tensor, dt0, rtol,
                               atol, sign, *, method: str = "dopri5",
                               safety: float = 0.9, ifactor: float = 10.0,
                               dfactor: float = 0.2,
                               max_steps: int = 2 ** 31 - 1):
    """`plan_adjoint_solve` with a step controller a sample, one K6 launch
    (and its block-sum launch) with K15 (reference `plan_adjoint.py:469`):
    every sample steps on its own (y, a_y) seminorm, adds the quadratures
    of its accepted trials only, and its dt carries from one interval to
    the next; dt0 is one step or one a sample ([B]). A coupled plan raises
    ValueError (the samples are not independent).

    Returns (ay0, dconsts, at, stats, lane_stats [4, B] int32)."""
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    if plan.batch_coupled:
        raise ValueError("per_sample=True with batch-coupled dynamics is "
                         "unsupported (lanes are interdependent)")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    kw = dict(method=method, safety=safety, ifactor=ifactor,
              dfactor=dfactor, max_steps=max_steps)
    if _device_kind(ys, g) == "cpu":
        return plan_perlane_adjoint_solve_plain(plan, packed, ys, g, tau,
                                                dt0, rtol, atol, sign, **kw)

    global plan_perlane_adjoint_launches
    packed = _adjoint_inputs(plan, packed, ys, g,
                             "plan_perlane_adjoint_solve")
    dtype, dev = ys.dtype, ys.device
    T, B, D = ys.shape
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    host = "perlane_adjoint"
    lib = build([(plan, host)])[0]
    lay = plan_codegen.aug_layout(plan)
    # The group walk reads the constants and their transposed copy.
    consts, sample_consts = plan_codegen.flat_consts(plan, packed, B, True)
    n_c = 2 * lay.n_quad
    smem = _consts_route(host, n_c, PERLANE_THREADS, ys.element_size())
    last_group[host] = PERLANE_GROUP
    R = lay.n_quad + lay.time_input
    n_blk = -(-B // PERLANE_THREADS)
    # Named, so that they live until the launch has read them.
    tau_h, dt_min, dt0_d, _ = _lane_setup(tau, dt0, B, dtype, dev)
    tau_d = tau_h.to(dev)
    c, a, b_sol, b_err = _tableau_args(tab)
    ay0 = torch.empty((B, D), dtype=dtype, device=dev)
    aw = torch.empty(max(1, lay.n_quad), dtype=dtype, device=dev)
    at = torch.empty((), dtype=dtype, device=dev)
    aps = torch.empty((max(1, lay.n_sample), B), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    lane = torch.empty((4, B), dtype=torch.int32, device=dev)
    partial = torch.empty(max(1, n_blk * R), dtype=dtype, device=dev)
    n_work = aug_group_work(plan, S, B, fixed=False)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    ys_c, g_c = ys.contiguous(), g.contiguous()
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(tau_d), _ptr(ys_c), _ptr(g_c), _ptr(dt0_d), _ptr(ay0),
            _ptr(aw), _ptr(at), _ptr(aps), _ptr(lane), _ptr(stats),
            _ptr(partial), _ptr(work), n_work, T, B, D,
            PERLANE_ADJOINT_THREADS, float(rtol), float(atol),
            float(dt_min), float(sign), float(safety),
            float(ifactor), float(dfactor), int(min(max_steps, 2 ** 31 - 1)),
            S, tab.order, c, a, b_sol, b_err, _ptr(consts), n_c,
            _ptr(sample_consts), int(smem), _stream(dev))
    _check(lib, err, "plan_perlane_adjoint_solve launch")
    plan_perlane_adjoint_launches += 1
    return (ay0, split_consts(plan, packed, aw[:lay.n_quad],
                                  aps[:lay.n_sample]), at, stats, lane)


def plan_adjoint_solve_fixed_plain(plan: FusedPlan, packed: Sequence[Tensor],
                                   ys: Tensor, g: Tensor, tau: Tensor, sign,
                                   *, num_steps: int = 1,
                                   method: str = "rk4"):
    """Plain PyTorch version of `plan_adjoint_solve_fixed`: K9's engine
    (`cuda_fixed.fixed_adjoint_plain`) with `aug_terms` (a coupled plan's
    meets in the order of K9's one block)."""
    packed = _adjoint_inputs(plan, packed, ys, g, "plan_adjoint_solve_fixed")
    n_flat, ti, n_rows = _quad_counts(plan)
    ay0, aw, at, aps, stats = fixed_adjoint_plain(
        plan_aug(plan, packed), n_flat, ti, n_rows, ys, g, tau, sign,
        num_steps=num_steps, method=method)
    return ay0, split_consts(plan, packed, aw, aps.t()), at, stats


def plan_adjoint_solve_fixed(plan: FusedPlan, packed: Sequence[Tensor],
                             ys: Tensor, g: Tensor, tau: Tensor, sign, *,
                             num_steps: int = 1, method: str = "rk4"):
    """Fixed-grid fused adjoint backward sweep of a plan's dynamics, one K9
    launch (and its block-sum launch) with K15 (reference
    `pallas_fixed.py:1019`): `num_steps` equal steps of the tableau an
    observation interval. A coupled plan's sweep runs on one block of
    PLAN_BLOCK_THREADS threads, its walk batch-wide as K3's.

    Returns (ay0, dconsts, at, stats [4] int32: nfe = stages * num_steps *
    (T - 1), steps, 0, 0)."""
    if method not in FIXED_TABLEAUS_BY_NAME:
        raise ValueError(f"unknown fixed-grid method {method!r}; available: "
                         f"{sorted(FIXED_TABLEAUS_BY_NAME)}")
    if int(num_steps) < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if _device_kind(ys, g) == "cpu":
        return plan_adjoint_solve_fixed_plain(plan, packed, ys, g, tau, sign,
                                              num_steps=num_steps,
                                              method=method)

    global plan_fixed_adjoint_launches
    packed = _adjoint_inputs(plan, packed, ys, g, "plan_adjoint_solve_fixed")
    dtype, dev = ys.dtype, ys.device
    T, B, D = ys.shape
    tab = FIXED_TABLEAUS_BY_NAME[method]
    S = tab.stages
    host = "fixed_adjoint"
    lib = build([(plan, host)])[0]
    lay = plan_codegen.aug_layout(plan)
    coupled = plan.batch_coupled
    # The group walk reads the constants and their transposed copy; the
    # coupled walk the constants alone, the meets' scratch beside them.
    consts, sample_consts = plan_codegen.flat_consts(plan, packed, B,
                                                     not coupled)
    if coupled:
        n_c = lay.n_quad
        smem = _consts_route(host, n_c, PLAN_BLOCK_THREADS,
                             ys.element_size(), batch=True)
        last_group[host] = 1
        n_work = fixed_block_work(plan, S, B)
    else:
        n_c = 2 * lay.n_quad
        smem = _consts_route(host, n_c, PERLANE_THREADS, ys.element_size())
        last_group[host] = PERLANE_GROUP
        n_work = aug_group_work(plan, S, B, fixed=True)
    tau_d = tau.detach().to("cpu", dtype).to(dev)
    c, a, b_sol, _ = _tableau_args(tab)
    ay0 = torch.empty((B, D), dtype=dtype, device=dev)
    aw = torch.empty(max(1, lay.n_quad), dtype=dtype, device=dev)
    at = torch.empty((), dtype=dtype, device=dev)
    aps = torch.empty((max(1, lay.n_sample), B), dtype=dtype, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    work = torch.empty(n_work, dtype=dtype, device=dev)
    ys_c, g_c = ys.contiguous(), g.contiguous()
    with torch.cuda.device(dev):
        err = _fn(lib, host, dtype)(
            _ptr(tau_d), _ptr(ys_c), _ptr(g_c), _ptr(ay0), _ptr(aw),
            _ptr(at), _ptr(aps), _ptr(stats), _ptr(work), n_work, T, B, D,
            FIXED_ADJOINT_THREADS, int(num_steps), float(sign), S, c, a,
            b_sol, _ptr(consts), n_c, _ptr(sample_consts), int(smem),
            _stream(dev))
    _check(lib, err, "plan_adjoint_solve_fixed launch")
    plan_fixed_adjoint_launches += 1
    return (ay0, split_consts(plan, packed, aw[:lay.n_quad],
                                  aps[:lay.n_sample]), at, stats)
