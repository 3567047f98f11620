"""Fused fast paths for MLP neural ODEs.

Counterpart of `tfdiffeq_tpu/fast.py` for the forward solve of the main
path. `solve_mlp` integrates the batched tanh-MLP neural ODE

    f(t, y) = tanh(y^3 @ W1 + b1) @ W2 + b2,      y: [B, D]

where the entire adaptive solve — every stage evaluation, combine, error
norm, controller decision and dense-output write — is ONE launch of a
hand-written CUDA kernel (`ops/cuda_kernels.mlp_solve`, K2) on a CUDA
tensor; on the CPU the kernel's plain PyTorch version runs instead.

- `solve_mlp_spec` / `MLPSpec`: general autonomous or concat-t MLP dynamics
  (any depth and activation in `_ACTIVATIONS`, the state entering as
  y ** p, layers up to 512 wide, the dot-precision tiers of K4 on the
  layers `matmul` selects), both time directions; the five adaptive RK
  tableaus with one
  step controller shared by the batch (K2) or, with `per_sample=True`, a
  controller per sample (K5, `ops/cuda_perlane.mlp_solve_perlane`), or
  the four fixed-grid methods (euler, midpoint, rk4, rk4_38) on the
  requested times or a finer `num_steps` / `step_size` grid, in one launch
  of `ops/cuda_fixed.mlp_solve_fixed` (K8), or the Adams family on the same
  grids ('explicit_adams', 'fixed_adams': K10,
  `ops/cuda_adams.mlp_solve_adams`) or adaptively (VCABM 'adams': K11,
  `ops/cuda_adams.mlp_solve_vcabm`).
- `solve_mlp_stepwise`: the one-step kernel (`dopri5_mlp_step`, K1) plugged
  into the generic adaptive engine through `AdaptiveConfig.step_override`.
- `odeint_adjoint_mlp`: the O(1)-memory training path, a
  `torch.autograd.Function` whose forward is one K2, K8, K10 or K11 launch
  and whose backward is one launch of an adjoint-sweep kernel: K3
  (`ops/cuda_adjoint.mlp_adjoint_solve`) for an adaptive adjoint method,
  K9 (`ops/cuda_fixed.mlp_adjoint_solve_fixed`) for a fixed-grid one; with
  `per_sample=True`, K5 forward and K6
  (`ops/cuda_perlane.mlp_perlane_adjoint_solve`) backward.
- `solve_conv_ode`: the ODE-Net MNIST block's conv dynamics, the whole
  adaptive solve of every controller block in one launch of K13
  (`ops/cuda_conv.conv_solve`).

- `cnf_log_prob_fused`, `cnf_sample_fused` and `cnf_log_prob_train`: the
  FFJORD density of a concat-t MLP flow as one K2 launch with K7's forward
  right-hand side (`mlp_solve(rhs='cnf')`: the flow and its exact
  divergence), sampling as one K2 launch of the plain concat-t MLP, and
  training as one K2 launch forward and one K3 sweep backward with K7's
  adjoint (`mlp_adjoint_solve(rhs='cnf')`), in the reference's chunks
  (`cnf_train_block_size`).

- `calibrate_dot_precision` / `DOT_PASSES`: the reference's one-time
  choice of the cheapest tier by NFE x passes.

- `solve_fused`: the whole solve of ARBITRARY plain-PyTorch dynamics: the
  function is captured into a plan (`ops/plan_bridge.build_plan`), the
  plan's right-hand side generated as CUDA C++ (`ops/plan_codegen.py`, K14)
  and compiled into K2 (adaptive, one controller; batch couplings such as
  y.mean(0) evaluated batch-wide), K5 (`per_sample=True`), K8 (fixed
  grids), K10 (explicit_adams, fixed_adams) or K11 (VCABM 'adams'), one
  launch a solve (`ops/cuda_plan.py`). `odeint` / `solve`
  route `options={'fuse': True}` here; `tree_state_adapter` carries tuple
  and dict states; `cnf_sample_auto` samples a plain-PyTorch flow.
  `fuse_fallbacks` counts the calls that ran the generic engine because the
  dynamics fell outside the plan's subset (a trace-time FusionError, never a
  build or launch failure).
- `solve_hyper`: the hypersolvers (hyper_euler, hyper_midpoint,
  hyper_heun) with both the dynamics and the correction net captured into
  plans and generated into one K12 launch (`cuda_plan.plan_solve_hyper`);
  `odeint(method='hyper_*', options={'fuse': True, 'hypernet': g})` routes
  here. Inference only: the hypernet trains through the generic walk.
- `odeint_adjoint_fused`: training of such dynamics in two launches, the
  plan's forward above and one backward sweep whose right-hand side is the
  plan's reverse walk (K15, generated as CUDA C++ by `ops/plan_codegen.py`)
  inside K3, K6 (`per_sample=True`) or K9 (fixed grids); the gradients reach
  the user's tensors through autograd's graph of the packed constants.
  `odeint_adjoint(options={'fuse': True})` routes here.

The dot-precision tiers ('mixed', 'bf16') run wherever the reference
runs them: K2, K8 and K5 (its tile engine, 16 samples a block in
lockstep) on the MLP routes of `solve_mlp_spec`, and K2, K8 and K5 at the
plan's dots of `solve_fused` (the plan's tile route, `ops/cuda_plan.py`).

Not ported yet (each raises NotImplementedError naming its ROADMAP queue 1
item): the multi-card `axis_name` / `global_batch` coupling (item 18);
`solve_conv_ode_sharded` has no counterpart here yet (item 18), nor has
`cnf_log_prob_auto` (item 16, the plan CNF), nor `solve_hyper` a coupled
plan (queue 2 item 3). A coupled plan (a batch
reduction such as `y.mean(0)`) runs on one block of K2, K8, K10 or K11,
and trains on K3 or K9 the same way. `solve_fused(dense_output=True)` keeps K2's
per-step interpolants (a `DenseOutput`), which drive
`odeint_adjoint(adjoint_mode='interpolated', options={'fuse': True})`.
What the kernels cannot take (widths past `MAX_WIDTH`) raises, as do the
reduced tiers on the Adams kernels and an Adams `adjoint_method` (no
adjoint kernel exists for it in either package). As in the reference,
`solve_conv_ode` solves with the generic engine, with a warning, when not one sample fits a
controller block; nothing else falls back (the fused CNF runs K2 and K3 at
every batch, where the reference falls back past its TPU memory budget).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import cnf as _cnf
from .ops import conv_ode as co
from .ops import tableaus
from .ops.controller import StepController
from .ops.cuda_adams import mlp_solve_adams, mlp_solve_vcabm
from .ops.cuda_adjoint import mlp_adjoint_solve
from .ops.cuda_conv import conv_solve, pack_conv_ode_weights
from .ops.cuda_fixed import mlp_adjoint_solve_fixed, mlp_solve_fixed
from .ops.cuda_kernels import (_ACTIVATIONS, dopri5_mlp_step, layer_tiers,
                               mlp_solve, pack_mlp_weights)
from .ops.cuda_perlane import mlp_perlane_adjoint_solve, mlp_solve_perlane
from .ops.norms import select_initial_step, select_initial_step_per_sample
from .ops import cuda_plan
from .ops import plan_bridge as _pb
from .ops.pytree import tree_leaves, tree_unflatten
from .odeint import solve as _generic_solve
from .solvers.adaptive import AdaptiveConfig, solve_adaptive
from .solvers.base import (CanonicalProblem, DenseOutput, SolveResult,
                           SolverStats)
from .solvers.fixed_grid import steps_for_size, uniform_grid
from .solvers.hyper import HYPER_KINDS
from .utils.nfe import emit_bwd, emit_fwd

Tensor = torch.Tensor

_INT32_MAX = 2 ** 31 - 1

_ADAMS_METHODS = frozenset({"adams", "explicit_adams", "fixed_adams"})


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static topology of a fused MLP neural ODE (weights passed separately
    as [(W [din, dout], b [dout] or None), ...]).

    activation: hidden nonlinearity; final_activation: the last layer's;
    input_power: the state enters as y ** p (the spiral uses p = 3);
    time_input: the time is one extra first-layer input (last column);
    matmul: which layers a reduced dot precision acts on, as in the
    reference (`ops/cuda_kernels._layer_uses_mxu`): 'vpu' none, 'mxu' all,
    'auto' (the default) those at least 32 wide both ways with 2048 weights
    or more. It names the TPU's engines; here every 'highest' layer sums
    its float products in input order on the CUDA cores, whatever matmul.
    dot_precision: the selected layers' products (K4, csrc/dot_tiers.cuh):
    'highest' (the default) float32-accurate; 'mixed' bf16 weights times
    activations split into bf16 hi and lo parts, two passes with float32
    accumulation (the bf16-weight model, solved to about 2^-16, so adaptive
    step control keeps working); 'bf16' one pass of bf16 weights and
    activations (about 2e-3 relative, for fixed-grid serving). On the card
    the float32 tiers run on the tensor cores. `calibrate_dot_precision`
    picks the cheapest tier for a workload.
    """
    activation: str = "tanh"
    final_activation: str = "identity"
    input_power: int = 1
    time_input: bool = False
    matmul: str = "auto"
    dot_precision: str = "highest"

    def __post_init__(self):
        for a in (self.activation, self.final_activation):
            if a not in _ACTIVATIONS:
                raise ValueError(f"unknown activation {a!r}; available: "
                                 f"{sorted(_ACTIVATIONS)}")
        if self.matmul not in ("vpu", "mxu", "auto"):
            raise ValueError(f"matmul must be 'vpu', 'mxu' or 'auto', got "
                             f"{self.matmul!r}")
        if self.dot_precision not in ("highest", "bf16", "mixed"):
            raise ValueError(f"dot_precision must be 'highest', 'bf16' or "
                             f"'mixed', got {self.dot_precision!r}")


def mlp_apply(spec: MLPSpec, weights: Sequence[Tuple[Tensor, Tensor]],
              y: Tensor, t=0.0) -> Tensor:
    """Plain PyTorch MLP dynamics on batch-major y [..., D] (the fused
    solve's f0 and initial-step probe). Float32 products on the card run
    in full float32 (PyTorch's default; TF32 stays off)."""
    h = y
    for _ in range(spec.input_power - 1):
        h = h * y
    if spec.time_input:
        tt = torch.as_tensor(t, dtype=h.dtype).to(h.device)
        h = torch.cat([h, tt.expand(h.shape[:-1] + (1,))], dim=-1)
    L = len(weights)
    for l, (W, b) in enumerate(weights):
        z = h @ W
        if b is not None:
            z = z + b
        act = spec.activation if l < L - 1 else spec.final_activation
        h = _ACTIVATIONS[act](z)
    return h


def weights_from_linears(module: torch.nn.Module) -> List[Tuple[Tensor,
                                                                Tensor]]:
    """[(W [din, dout], b), ...] from the nn.Linear layers of a module, in
    registration order (counterpart of `weights_from_flax_dense`)."""
    layers = [m for m in module.modules() if isinstance(m, torch.nn.Linear)]
    if not layers:
        raise ValueError(f"no nn.Linear layers in {type(module).__name__}")
    return [(m.weight.detach().t().contiguous(),
             None if m.bias is None else m.bias.detach())
            for m in layers]


def _as_state(y0) -> Tensor:
    y0 = torch.as_tensor(y0)
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [batch, dim], got {tuple(y0.shape)}")
    return y0


def _host_times(t, dtype) -> Tensor:
    return torch.as_tensor(t).detach().to("cpu", dtype)


def _check_spec_inputs(y0, t, time_dtype=None) -> Tuple[Tensor, Tensor]:
    y0 = _as_state(y0)
    t = _host_times(t, time_dtype or y0.dtype)
    if t.shape[0] > 1:
        d = np.diff(t.numpy())
        if not (np.all(d > 0) or np.all(d < 0)):
            raise ValueError("t must be strictly monotonic (increasing or "
                             f"decreasing); got {t.numpy()}")
    return y0, t


def solve_mlp(params: dict, y0: Tensor, t, *, rtol=1e-6, atol=1e-8,
              method: str = "dopri5", max_num_steps=None,
              first_step=None) -> SolveResult:
    """Whole-solve fused adaptive RK for the tanh-MLP neural ODE.

    params: {'w1': [D, H], 'b1': [H], 'w2': [H, D], 'b2': [D]} tensors on
    y0's device; y0: [B, D]; method: 'dopri5' (default), 'bosh3',
    'adaptive_heun', 'tsit5' or 'dopri8' (K2), or any other method of
    `solve_mlp_spec` ('adams': K11; 'explicit_adams', 'fixed_adams' and the
    fixed-grid RK methods on the requested times). Returns ys [T, B, D]
    and stats.
    """
    spec = MLPSpec(activation="tanh", final_activation="identity",
                   input_power=3)
    weights = [(params["w1"], params["b1"]), (params["w2"], params["b2"])]
    return solve_mlp_spec(spec, weights, y0, t, rtol=rtol, atol=atol,
                          method=method, max_num_steps=max_num_steps,
                          first_step=first_step)


def odeint_mlp(params: dict, y0: Tensor, t, *, rtol=1e-6, atol=1e-8,
               **kwargs) -> Tensor:
    """`odeint`-style front-end of `solve_mlp`; returns ys [T, B, D]."""
    return solve_mlp(params, y0, t, rtol=rtol, atol=atol, **kwargs).ys


def solve_mlp_stepwise(params: dict, y0: Tensor, t, *, rtol=1e-6, atol=1e-8,
                       max_num_steps=None, first_step=None,
                       axis_name: Optional[str] = None,
                       global_batch: Optional[int] = None) -> SolveResult:
    """The fused one-step kernel (K1) driven by the generic adaptive engine
    through `AdaptiveConfig.step_override`: one launch per attempt, the
    controller on the host. Slower than `solve_mlp`; it exercises the
    composition of a kernel with the generic engine. t must increase.
    """
    if axis_name is not None or global_batch is not None:
        raise NotImplementedError(
            "solve_mlp_stepwise(axis_name=..., global_batch=...) couples "
            "the step control across cards: ROADMAP.md queue 1 item 18 "
            "(multi-GPU)")
    y0 = _as_state(y0)
    dtype = y0.dtype
    t = _host_times(t, dtype)
    if t.shape[0] > 1 and not np.all(np.diff(t.numpy()) > 0):
        raise ValueError("this path requires strictly increasing t")

    spec = MLPSpec(activation="tanh", input_power=3)
    weights = [(params["w1"], params["b1"]), (params["w2"], params["b2"])]

    def func(tt, y):
        return mlp_apply(spec, weights, y)

    def step_override(tt, y, f, dt):
        y1, f1, ratio, ymid = dopri5_mlp_step(params, y, f, dt, rtol, atol)
        return y1, f1, ratio, ymid, tableaus.DOPRI5.evals_per_step

    prob = CanonicalProblem(
        func=func, y0=y0, tau=t, sign=torch.tensor(1.0, dtype=dtype),
        unravel=lambda x: x, dtype=dtype, time_dtype=dtype, native=True)
    cfg = AdaptiveConfig(tableau=tableaus.DOPRI5, controller=StepController(),
                         step_override=step_override)
    return solve_adaptive(prob, cfg, rtol, atol, first_step=first_step,
                          max_num_steps=max_num_steps)


def _check_method(method: str, spec: Optional[MLPSpec] = None) -> None:
    if (spec is not None and spec.dot_precision != "highest"
            and method in _ADAMS_METHODS):
        raise ValueError(
            f"dot_precision={spec.dot_precision!r} is not supported on "
            "the Adams kernels (their corrector/order machinery assumes "
            "f32-accurate dots); use an RK method for reduced-precision "
            "serving ('bf16' fixed-grid, 'mixed' fixed-grid or adaptive)")
    if method not in tableaus.TABLEAUS_BY_NAME \
            and method not in tableaus.FIXED_TABLEAUS_BY_NAME \
            and method not in _ADAMS_METHODS:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(tableaus.TABLEAUS_BY_NAME)}, "
                         f"{sorted(tableaus.FIXED_TABLEAUS_BY_NAME)} and "
                         f"{sorted(_ADAMS_METHODS)}")


def _check_adjoint_method(adjoint_method: str) -> None:
    """The backward sweeps are adaptive RK (K3, K6) or fixed-grid (K9):
    no adjoint kernel exists for the Adams family in either package."""
    if adjoint_method in _ADAMS_METHODS:
        raise ValueError(
            f"odeint_adjoint_mlp: adjoint_method={adjoint_method!r} has no "
            "adjoint kernel (the reference's backward fails on it); pass "
            "an adaptive RK adjoint_method "
            f"({', '.join(sorted(tableaus.TABLEAUS_BY_NAME))}) or a "
            "fixed-grid one "
            f"({', '.join(sorted(tableaus.FIXED_TABLEAUS_BY_NAME))}), e.g. "
            "method='adams', adjoint_method='dopri5'")
    _check_method(adjoint_method)


def _fixed_grid_tau(tau: Tensor, t: Tensor, num_steps, step_size) -> Tensor:
    """The fixed-grid step grid in tau-space (reference `fast.py:355`):
    num_steps or ceil(span / step_size) uniform steps from tau[0] to
    tau[-1], else the requested times themselves."""
    if num_steps is not None and step_size is not None:
        raise ValueError("pass num_steps OR step_size, not both")
    if num_steps is not None:
        n = int(num_steps)
        if n < 1:
            raise ValueError(f"num_steps must be >= 1, got {n}")
        return uniform_grid(tau[0], tau[-1], n)
    if step_size is not None:
        span = abs(float(t[-1]) - float(t[0]))
        return uniform_grid(tau[0], tau[-1], steps_for_size(span, step_size))
    return tau


def solve_mlp_spec(spec: MLPSpec, weights, y0: Tensor, t, *, rtol=1e-6,
                   atol=1e-8, method: str = "dopri5", max_num_steps=None,
                   first_step=None, num_steps=None, step_size=None,
                   max_order: Optional[int] = None, max_iters: int = 4,
                   per_sample: bool = False) -> SolveResult:
    """Whole-solve fused solve of a general MLP neural ODE, one launch.

    weights: [(W [din, dout], b [dout] or None), ...] on y0's device;
    y0: [B, D]; t may increase or decrease (solved in tau = sign * t, as
    the generic engine does). Returns ys [T, B, D] and stats.

    Adaptive methods (dopri5, bosh3, adaptive_heun, tsit5, dopri8) run K2:
    the host computes f0 and, when first_step is None, the HNW initial
    step (2 extra evaluations, else 1, counted in nfe); rtol, atol,
    first_step and max_num_steps apply, num_steps and step_size do not.
    spec.matmul and spec.dot_precision give each layer its tier
    (`ops/cuda_kernels.layer_tiers`); K2, K8 and K5 run the reduced tiers
    (K5 on its tile engine, 16 samples a block in lockstep).
    per_sample=True runs K5 instead: every sample takes its own steps from
    its own HNW first step (`select_initial_step_per_sample`, one batched
    probe), with max_num_steps counting each sample's attempts; stats sum
    the samples' counts (the initial-step evaluations once a sample) and
    take the largest status, and `lane_stats` holds each sample's
    (SolverStats of [B] int32 tensors on y0's device). per_sample applies
    to the adaptive methods only.
    Fixed-grid methods (euler, midpoint, rk4, rk4_38) run K8 on the
    requested times, or on a uniform grid of `num_steps` steps or of steps
    at most `step_size` long with the outputs cubic-Hermite interpolated
    (nfe = 1 + stages * steps; the tolerances, first_step and
    max_num_steps do not apply).
    The Adams family takes the same grids: 'explicit_adams' and
    'fixed_adams' run K10 (`ops/cuda_adams.mlp_solve_adams`), an RK4
    bootstrap of max_order - 1 steps and then the AB predictor and, for
    'fixed_adams', max_iters corrector iterations whose convergence the
    tolerances judge (max_order defaults to 4). 'adams' (VCABM) runs K11
    (`ops/cuda_adams.mlp_solve_vcabm`) from f0 and the HNW first step at
    order 1 (2 extra evaluations, 1 with first_step), with rtol, atol,
    first_step and max_num_steps as for the adaptive RK methods
    (max_order defaults to 12). The Adams kernels take no reduced
    dot_precision (ValueError, as in the reference).
    """
    _check_method(method, spec)
    if per_sample and method not in tableaus.TABLEAUS_BY_NAME:
        raise ValueError("per_sample applies to adaptive RK methods only")
    tiers = layer_tiers([tuple(W.shape) for W, _ in weights], spec.matmul,
                        spec.dot_precision)
    y0, t = _check_spec_inputs(y0, t)
    dtype, dev = y0.dtype, y0.device
    if t.shape[0] == 1:
        return SolveResult(y0[None].clone(), SolverStats(0, 0, 0, 0))

    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=dtype)
    tau = sign * t
    sign_d = sign.to(dev)

    def g(s, y):
        return sign_d * mlp_apply(spec, weights, y, sign_d * s)

    f0 = g(tau[0].to(dev), y0).contiguous()
    y0 = y0.contiguous()
    warrays, dims = pack_mlp_weights(weights, dtype, dev)
    net = dict(f0=f0, activation=spec.activation,
               final_activation=spec.final_activation,
               input_power=spec.input_power, time_input=spec.time_input)
    if max_order is None:
        max_order = 12 if method == "adams" else 4   # the engines' defaults
    if method in ("explicit_adams", "fixed_adams"):
        out, stats = mlp_solve_adams(
            warrays, dims, y0, tau,
            _fixed_grid_tau(tau, t, num_steps, step_size), rtol, atol,
            float(sign), implicit=method == "fixed_adams",
            max_order=int(max_order), max_iters=int(max_iters), **net)
        return SolveResult(out, SolverStats(*stats.tolist()))
    if method in tableaus.FIXED_TABLEAUS_BY_NAME:
        out, stats = mlp_solve_fixed(
            warrays, dims, y0, tau,
            _fixed_grid_tau(tau, t, num_steps, step_size), float(sign),
            method=method, tiers=tiers, **net)
        return SolveResult(out, SolverStats(*stats.tolist()))

    if first_step is None:
        # HNW's first step at the method's order - 1; VCABM's at order 1,
        # as the generic engine's.
        hnw_order = (1 if method == "adams"
                     else tableaus.TABLEAUS_BY_NAME[method].order - 1)
        rdt = torch.as_tensor(rtol, dtype=dtype).to(dev)
        adt = torch.as_tensor(atol, dtype=dtype).to(dev)
        pick = (select_initial_step_per_sample if per_sample
                else select_initial_step)
        dt0 = pick(g, tau[0].to(dev), y0, f0, hnw_order, rdt, adt)
        extra_nfe = 2
    else:
        dt0 = torch.abs(torch.as_tensor(first_step, dtype=dtype))
        extra_nfe = 1

    max_steps = (int(max_num_steps) if max_num_steps is not None
                 else _INT32_MAX)
    args = (warrays, dims, y0, tau, dt0, rtol, atol, float(sign))
    if method == "adams":
        out, stats = mlp_solve_vcabm(*args, max_order=int(max_order),
                                     max_steps=max_steps, **net)
    elif per_sample:
        out, stats, lane = mlp_solve_perlane(*args, method=method,
                                             max_steps=max_steps,
                                             tiers=tiers, **net)
        nfe, nacc, nrej, status = stats.tolist()
        return SolveResult(
            out, SolverStats(nfe + extra_nfe * y0.shape[0], nacc, nrej,
                             status),
            lane_stats=SolverStats(lane[0] + extra_nfe, lane[1], lane[2],
                                   lane[3]))
    else:
        out, stats = mlp_solve(*args, method=method, max_steps=max_steps,
                               tiers=tiers, **net)
    nfe, nacc, nrej, status = stats.tolist()
    return SolveResult(out, SolverStats(nfe + extra_nfe, nacc, nrej, status))


#: Systolic passes per dot of each `dot_precision` tier: the reference's
#: cost model behind `calibrate_dot_precision` (tfdiffeq_tpu/fast.py:729,
#: measured there on a TPU v5e), kept so that both packages pick the same
#: tier. It is not an H100 measurement: on the card 'highest' runs on the
#: CUDA cores and the other two on the tensor cores (PERF.md).
DOT_PASSES = {"highest": 3, "mixed": 2, "bf16": 1}


def calibrate_dot_precision(spec: MLPSpec, weights, y0: Tensor, t, *,
                            rtol=1e-6, atol=1e-8, method: str = "dopri5",
                            candidates=("bf16", "mixed"),
                            max_nfe_inflation: float = 0.5,
                            **solve_kw) -> MLPSpec:
    """The reference's one-time cost gate for the reduced tiers
    (tfdiffeq_tpu/fast.py:732): one solve per candidate `dot_precision` on
    a representative (y0, t), and `spec` rebuilt with the tier of least
    NFE x `DOT_PASSES[tier]`. A candidate whose NFE exceeds
    (1 + max_nfe_inflation) x the 'highest' solve's is rejected outright,
    and one that raises a ValueError (not supported for the method) is
    skipped. Fixed-grid methods have the same NFE at every tier, so the
    fewest passes win. solve_kw goes to `solve_mlp_spec`."""
    ref = solve_mlp_spec(dataclasses.replace(spec, dot_precision="highest"),
                         weights, y0, t, rtol=rtol, atol=atol,
                         method=method, **solve_kw)
    ref_nfe = int(ref.stats.nfe)
    best, best_cost = "highest", ref_nfe * DOT_PASSES["highest"]
    for prec in candidates:
        if prec == "highest":
            continue
        try:
            r = solve_mlp_spec(dataclasses.replace(spec, dot_precision=prec),
                               weights, y0, t, rtol=rtol, atol=atol,
                               method=method, **solve_kw)
        except ValueError:        # tier not supported for this method
            continue
        nfe = int(r.stats.nfe)
        if nfe > ref_nfe * (1.0 + max_nfe_inflation):
            continue
        cost = nfe * DOT_PASSES[prec]
        if cost < best_cost:
            best, best_cost = prec, cost
    return dataclasses.replace(spec, dot_precision=best)


class _AdjointMLP(torch.autograd.Function):
    """Forward: `solve_mlp_spec` (K2, K5 or K8). Backward: K3's, K6's or
    K9's whole sweep (reference `fast.py:_vjp_bwd`). `cfg` carries the
    static options and receives the forward stats."""

    @staticmethod
    def forward(ctx, cfg, y0, t, *flat):
        weights = cfg["unflatten"](flat)
        res = solve_mlp_spec(cfg["spec"], weights, y0, t, rtol=cfg["rtol"],
                             atol=cfg["atol"], method=cfg["method"],
                             max_num_steps=cfg["max_num_steps"],
                             first_step=cfg["first_step"],
                             num_steps=cfg["num_steps"],
                             step_size=cfg["step_size"],
                             per_sample=cfg["per_sample"])
        emit_fwd(cfg["nfe_meter"], res.stats.nfe, res.stats.n_accepted)
        cfg["stats"] = res.stats
        ctx.cfg = cfg
        ctx.save_for_backward(res.ys, t, *flat)
        return res.ys

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        ys, t, *flat = ctx.saved_tensors
        weights = cfg["unflatten"](flat)
        T = t.shape[0]
        if T < 2:
            return (None, g[0], torch.zeros_like(t),
                    *[torch.zeros_like(x) for x in flat])
        dtype, dev = ys.dtype, ys.device
        spec = cfg["spec"]
        # d loss / d t_i = <f(t_i, y_i), g_i>; ts_bar[0] also carries the
        # integrated a_t quadrature (zero for autonomous dynamics).
        f_obs = mlp_apply(spec, weights, ys,
                          t.to(dev, dtype).reshape(T, 1, 1))
        t_bars = torch.sum(f_obs * g, dim=(1, 2)).to(t.device, t.dtype)
        t_h = _host_times(t, dtype)
        sign = 1.0 if bool(t_h[-1] >= t_h[0]) else -1.0
        tau = sign * t_h
        warrays, dims = pack_mlp_weights(weights, dtype, dev)
        net = dict(activation=spec.activation,
                   final_activation=spec.final_activation,
                   input_power=spec.input_power, time_input=spec.time_input)
        if cfg["adjoint_method"] in tableaus.FIXED_TABLEAUS_BY_NAME:
            ay0, aw, at, bstats = mlp_adjoint_solve_fixed(
                warrays, dims, ys.contiguous(), g.contiguous(), tau, sign,
                num_steps=cfg["bwd_num_steps"], method=cfg["adjoint_method"],
                **net)
        else:
            if cfg["adjoint_first_step"] is not None:
                dt0 = torch.abs(torch.as_tensor(cfg["adjoint_first_step"],
                                                dtype=dtype))
            else:
                # A tenth of the last observation gap (the reference's
                # cheap heuristic; the controller settles within a few
                # attempts).
                dt0 = 0.1 * torch.abs(tau[-1] - tau[-2])
            args = (warrays, dims, ys.contiguous(), g.contiguous(), tau, dt0,
                    cfg["adjoint_rtol"], cfg["adjoint_atol"], sign)
            if cfg["per_sample"]:
                # Always the (y, a_y) seminorm: a batch-shared parameter
                # quadrature cannot drive one sample's step control.
                ay0, aw, at, bstats, _ = mlp_perlane_adjoint_solve(
                    *args, method=cfg["adjoint_method"],
                    max_steps=cfg["max_steps"], **net)
            else:
                ay0, aw, at, bstats = mlp_adjoint_solve(
                    *args, seminorm=cfg["adjoint_seminorm"],
                    method=cfg["adjoint_method"],
                    max_steps=cfg["max_steps"], **net)
        nfe, nacc, _, status = bstats.tolist()
        emit_bwd(cfg["nfe_meter"], nfe, nacc)
        at = at.to(t.device, t.dtype)
        ts_bar = torch.cat([(at - torch.sum(t_bars[1:]))[None], t_bars[1:]])

        grads, off = [], 0
        for (W, b), (din, dout) in zip(weights, dims):
            grads.append(aw[off:off + din * dout].view(dout, din).t()
                         .to(W.dtype))
            off += din * dout
            if b is not None:
                grads.append(aw[off:off + dout].to(b.dtype))
            off += dout
        grads = [ay0.to(ys.dtype), ts_bar] + grads
        if status != 0:
            # A truncated sweep (dt underflow, max_num_steps) would return
            # a partial adjoint: poison every gradient, as the reference
            # does (fast.py:1539-1557).
            grads = [torch.full_like(x, float("nan")) for x in grads]
        return (None, *grads)


def odeint_adjoint_mlp(spec: MLPSpec, weights, y0: Tensor, t, *, rtol=1e-6,
                       atol=1e-8, adjoint_rtol=None, adjoint_atol=None,
                       method: str = "dopri5",
                       adjoint_method: Optional[str] = None,
                       adjoint_seminorm: bool = False, max_num_steps=None,
                       first_step=None, adjoint_first_step=None,
                       nfe_meter=None, return_stats: bool = False,
                       num_steps=None, step_size=None,
                       adjoint_num_steps=None, per_sample: bool = False):
    """Fused O(1)-memory training path for MLP neural ODEs.

    Forward = ONE whole-solve kernel launch (`solve_mlp_spec`: K2 for an
    adaptive method, K8 for a fixed-grid one, K10 for 'explicit_adams' /
    'fixed_adams', K11 for 'adams'); backward = ONE launch of an
    adjoint-sweep kernel running the interval loop, stored-state resets,
    cotangent injections, the steps, MLP VJPs and the parameter
    quadrature: K3 (adaptive steps) for an adaptive adjoint_method, K9 for
    a fixed-grid one. On CPU tensors every kernel runs its plain PyTorch
    version. No adjoint kernel exists for the Adams family: with an Adams
    forward, name an RK adjoint_method (e.g. method='adams',
    adjoint_method='dopri5'); an Adams adjoint_method, the default when
    method is one, raises ValueError before any launch.

    per_sample=True: both sweeps give every sample its own step
    controller, K5 forward and K6 backward, so a stiff sample sets the
    steps of neither direction for the others; adaptive forward and
    adjoint methods only. The backward then always uses the (y, a_y)
    seminorm (adjoint_seminorm is ignored, as in the reference).

    A reduced `spec.dot_precision` reaches the forward solve only, as in
    the reference: the backward sweep is float32-accurate, on the weights
    as given.

    Fixed-grid options, as in the reference: num_steps or step_size shape
    a fixed forward's grid (`solve_mlp_spec`); a fixed backward takes
    adjoint_num_steps equal steps per observation interval, else the
    forward's num_steps, else 1 (a forward step_size is not carried over:
    the generic `odeint_adjoint` walks ceil(span_i / step_size) steps per
    interval instead). Any mix of adaptive and fixed methods works.

    Differentiable wrt `weights` ([(W [din, dout], b [dout] or None), ...]
    on y0's device), `y0` [B, D] and `t` (when they require grad); for
    concat-t dynamics (`spec.time_input`) the sweep also integrates the a_t
    quadrature and the first layer's t-column gradient. Returns ys
    [T, B, D], with the FORWARD stats when return_stats=True; forward and
    backward stats go to `nfe_meter`. A backward sweep that fails (status
    != 0) returns NaN gradients.
    """
    adjoint_rtol = rtol if adjoint_rtol is None else adjoint_rtol
    adjoint_atol = atol if adjoint_atol is None else adjoint_atol
    adjoint_method = method if adjoint_method is None else adjoint_method
    _check_method(method, spec)
    _check_adjoint_method(adjoint_method)
    if per_sample and (method not in tableaus.TABLEAUS_BY_NAME
                       or adjoint_method not in tableaus.TABLEAUS_BY_NAME):
        raise ValueError("per_sample=True training applies to adaptive RK "
                         "methods only (forward and adjoint)")
    weights = [(W, b) for W, b in weights]
    has_bias = [b is not None for _, b in weights]
    flat = [x for W, b in weights for x in ((W, b) if b is not None
                                            else (W,))]

    def unflatten(xs):
        it = iter(xs)
        return [(next(it), next(it) if hb else None) for hb in has_bias]

    cfg = {"spec": spec, "unflatten": unflatten, "rtol": rtol, "atol": atol,
           "adjoint_rtol": adjoint_rtol, "adjoint_atol": adjoint_atol,
           "method": method, "adjoint_method": adjoint_method,
           "adjoint_seminorm": bool(adjoint_seminorm),
           "per_sample": bool(per_sample),
           "max_num_steps": max_num_steps,
           "max_steps": (int(max_num_steps) if max_num_steps is not None
                         else _INT32_MAX),
           "first_step": first_step,
           "adjoint_first_step": adjoint_first_step,
           "num_steps": num_steps, "step_size": step_size,
           "bwd_num_steps": int(adjoint_num_steps
                                if adjoint_num_steps is not None
                                else (num_steps if num_steps is not None
                                      else 1)),
           "nfe_meter": nfe_meter}
    t_in = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    ys = _AdjointMLP.apply(cfg, y0, t_in, *flat)
    if return_stats:
        return ys, cfg["stats"]
    return ys


# The reference's controller blocks (fast.py:2340-2356): it cuts the batch
# into blocks of b_max samples, b_max from a TPU VMEM model, and each block
# takes its own step sequence. These constants reproduce that partition,
# which the reference's answers depend on; they are no memory budget of
# the card.
_CONV_STACK_BLOCKS = 60
_CONV_STACK_BUDGET = 14 * 2 ** 20
_LANE = 128

#: `solve_conv_ode` calls that took the generic engine because not one
#: sample fit a controller block (no K13 launch); a measured path keeps
#: it at 0.
conv_ode_fallbacks = 0


def conv_block_size(channels: int, n_times: int, positions: int) -> int:
    """Samples a controller block of `solve_conv_ode` holds: the
    reference's largest block whose [C, round_up(b * positions, 128)]
    float32 state fits its stack model (18 at C = 64, 7x7, two times).
    0 when not even one sample does."""
    cap = _CONV_STACK_BUDGET // (4 * (_CONV_STACK_BLOCKS + n_times)
                                 * channels)
    return (cap // _LANE) * _LANE // positions


def conv_params(func_or_params) -> dict:
    """The conv-ODE parameter dict (ops/conv_ode.py) of the port's
    `ODEConvFunc`, or the dict itself."""
    if isinstance(func_or_params, dict) and "gn" in func_or_params:
        return func_or_params
    m = func_or_params
    return {"gn": [(n.weight, n.bias) for n in (m.norm1, m.norm2, m.norm3)],
            "conv": [(c.conv.weight.permute(2, 3, 1, 0), c.conv.bias)
                     for c in (m.conv1, m.conv2)]}


def _conv_inputs_checked(x, t, groups: int, method: str):
    """Validate solve_conv_ode's x and t (the reference's messages, its
    order); returns x and t as tensors, t on the host."""
    x = torch.as_tensor(x)
    if x.ndim != 4:
        raise ValueError(f"x must be [B, C, H, W] (NCHW; the JAX package's "
                         f"[B, H, W, C] is NHWC), got {tuple(x.shape)}")
    if x.shape[1] % groups:
        raise ValueError(f"channels {x.shape[1]} not divisible by groups "
                         f"{groups}")
    t = _host_times(t, torch.float64)
    if t.ndim != 1:
        raise ValueError("t must be 1-D")
    if t.shape[0] > 1 and not (np.all(np.diff(t.numpy()) > 0)
                               or np.all(np.diff(t.numpy()) < 0)):
        raise ValueError("t must be strictly monotonic")
    _check_method(method)
    if method not in tableaus.TABLEAUS_BY_NAME:
        raise ValueError(f"solve_conv_ode takes an adaptive method, got "
                         f"{method!r}")
    return x, t


def conv_solve_inputs(func_or_params, x: Tensor, t, *, groups: int = 32,
                      rtol=1e-3, atol=1e-3, method: str = "dopri5",
                      first_step=None, dtype=torch.float32):
    """What `solve_conv_ode` hands K13, for x [B, C, H, W] and t of two or
    more times: (args, kwargs, extra_nfe) with
    `ops.cuda_conv.conv_solve(*args, **kwargs)` the solve, kwargs holding
    f0 and the controller block size, and extra_nfe the initial-step
    evaluations (2, or 1 with first_step). `dtype` is float32 on the public
    path; float64 serves the kernel's exactness checks."""
    x, t = _conv_inputs_checked(x, t, groups, method)
    B, C, H, W = x.shape
    spec = co.ConvODESpec(height=H, width=W, channels=C, groups=groups)
    b_max = conv_block_size(C, t.shape[0], spec.positions)
    if b_max < 1:
        raise ValueError(
            f"solve_conv_ode: not one sample of {C} channels and "
            f"{t.shape[0]} output times fits the reference's block limit "
            f"(_CONV_STACK_BUDGET = {_CONV_STACK_BUDGET} bytes for "
            f"{_CONV_STACK_BLOCKS} + T state copies)")
    b_blk = min(B, b_max)
    dev = x.device
    with torch.no_grad():
        x = x.detach().to(dtype).contiguous()
        t = t.to(dtype)
        params = co.as_tensors(conv_params(func_or_params), dtype, dev)
        sign = 1.0 if t[-1] >= t[0] else -1.0
        tau = sign * t
        sign_d = torch.tensor(sign, dtype=dtype, device=dev)
        tau0 = tau[0].to(dev)
        ref_f = co.make_conv_ode_f(params, spec, dtype, dev)

        def g(s, y):
            return sign_d * ref_f(sign_d * s, y)

        f0 = g(tau0, x)
        if first_step is None:
            # Each block's HNW first step, over its own samples.
            order = tableaus.TABLEAUS_BY_NAME[method].order
            rdt = torch.as_tensor(rtol, dtype=dtype).to(dev)
            adt = torch.as_tensor(atol, dtype=dtype).to(dev)
            dt0 = torch.stack([
                select_initial_step(g, tau0, x[b:b + b_blk],
                                    f0[b:b + b_blk], order - 1, rdt, adt)
                for b in range(0, B, b_blk)])
            extra_nfe = 2
        else:
            dt0 = torch.full((-(-B // b_blk),), abs(float(first_step)),
                             dtype=dtype, device=dev)
            extra_nfe = 1
        wpack = pack_conv_ode_weights(params, spec, dtype, dev)
    args = (wpack, spec, x, tau, dt0, rtol, atol, sign)
    return args, dict(f0=f0, block_size=b_blk, method=method), extra_nfe


def solve_conv_ode(func_or_params, x: Tensor, t, *, groups: int = 32,
                   rtol=1e-3, atol=1e-3, method: str = "dopri5",
                   max_num_steps=None, first_step=None) -> SolveResult:
    """Whole-solve fused adaptive RK for the ODE-Net conv dynamics (GN ->
    relu -> ConcatConv3x3 -> GN -> relu -> ConcatConv3x3 -> GN): one
    launch of K13 (`ops/cuda_conv.conv_solve`) on a CUDA tensor, its plain
    version on a CPU tensor. Forward only (inference); `ODEBlock` pairs it
    with the generic adjoint for training.

    func_or_params: the port's `ODEConvFunc` or the parameter dict of
    ops/conv_ode.py. x: [B, C, H, W], NCHW (the JAX package's layout is
    NHWC); t may increase or decrease. Computes in float32, as the
    reference does. Returns ys [T, B, C, H, W] and stats.

    When not one sample fits a controller block (many output times, or
    many channels), it warns and solves the whole batch with the generic
    engine instead, as the reference does, and counts the call in
    `conv_ode_fallbacks`.

    The batch runs as controller blocks of `conv_block_size` samples, the
    reference's partition, each with its own HNW first step and step
    control (the last block holds only its true samples, where the
    reference pads it with zero samples that join its error norm). Stats
    follow the reference: nfe, accepted and rejected summed over blocks
    plus the initial-step evaluations once (2, or 1 with first_step), and
    the worst status.
    """
    x, t = _conv_inputs_checked(x, t, groups, method)
    if t.shape[0] == 1:
        return SolveResult(x.detach().to(torch.float32)[None].clone(),
                           SolverStats(0, 0, 0, 0))
    B, C, H, W = x.shape
    spec = co.ConvODESpec(height=H, width=W, channels=C, groups=groups)
    if conv_block_size(C, t.shape[0], spec.positions) < 1:
        # The reference's fallback (tfdiffeq_tpu/fast.py:2357-2371): the
        # generic engine over the whole batch, on the caller's device.
        global conv_ode_fallbacks
        conv_ode_fallbacks += 1
        warnings.warn(
            "solve_conv_ode: even a single-sample block exceeds the "
            "kernel's block limit (huge T or C); falling back to the "
            "generic while-loop engine", stacklevel=2)
        options = {"loop": "while"}
        if max_num_steps is not None:
            options["max_num_steps"] = max_num_steps
        if first_step is not None:
            options["first_step"] = first_step
        with torch.no_grad():
            f = co.make_conv_ode_f(conv_params(func_or_params), spec,
                                   torch.float32, x.device)
            return _generic_solve(f, x.detach().to(torch.float32),
                                  t.to(torch.float32), rtol=rtol, atol=atol,
                                  method=method, options=options)
    args, kw, extra_nfe = conv_solve_inputs(
        func_or_params, x, t, groups=groups, rtol=rtol, atol=atol,
        method=method, first_step=first_step)
    with torch.no_grad():
        out, stats = conv_solve(
            *args, **kw, max_steps=(int(max_num_steps)
                                    if max_num_steps is not None
                                    else _INT32_MAX))
    st = stats.cpu()
    return SolveResult(out, SolverStats(
        int(st[:, 0].sum()) + extra_nfe, int(st[:, 1].sum()),
        int(st[:, 2].sum()), int(st[:, 3].max())))


# ---------------------------------------------------------------------------
# Continuous normalizing flows (FFJORD) on K7: the density, sampling and
# training entry points of the reference (fast.py:2170-2639)
# ---------------------------------------------------------------------------

def _cnf_weights(weights, D: int, name: str):
    """The flow's [(W, b), ...] as a list, raising unless the first layer
    takes D + 1 inputs (the concat-t convention, time last)."""
    weights = [(W, b) for W, b in weights]
    if weights[0][0].shape[0] != D + 1:
        raise ValueError(
            f"{name}: first-layer input dim {weights[0][0].shape[0]} != D+1 "
            f"= {D + 1} (concat-t convention, time last)")
    return weights


def _cnf_method(method: str) -> None:
    _check_method(method)
    if method not in tableaus.TABLEAUS_BY_NAME:
        raise ValueError(f"the fused CNF takes an adaptive method, got "
                         f"{method!r}")


def _cnf_forward_solve(spec: MLPSpec, weights, z0: Tensor, t: Tensor, rtol,
                       atol, method: str, max_num_steps, first_step):
    """The fused CNF forward (reference fast.py:2170): one K2 solve with
    K7's forward right-hand side over the augmented state [z; logp],
    [B, D + 1], from logp = 0. f0 and the HNW first step come from the
    plain augmented dynamics (exact trace) over the whole state, as in the
    reference. Returns (out [T, B, D + 1], stats as a host list, the
    initial-step evaluations)."""
    B, D = z0.shape
    dtype, dev = z0.dtype, z0.device
    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=dtype)
    tau = sign * t
    sign_d = sign.to(dev)
    aug = _cnf.augmented_dynamics(
        lambda tt, zz: mlp_apply(spec, weights, zz, tt), trace="exact")

    def g(s, st):
        dz, dl = aug(sign_d * s, (st[:, :D], st[:, D]))
        return sign_d * torch.cat([dz, dl[:, None]], dim=1)

    with torch.no_grad():
        state0 = torch.cat([z0, torch.zeros(B, 1, dtype=dtype, device=dev)],
                           dim=1)
        tau0 = tau[0].to(dev)
        f0 = g(tau0, state0)
        if first_step is None:
            dt0 = select_initial_step(
                g, tau0, state0, f0,
                tableaus.TABLEAUS_BY_NAME[method].order - 1,
                torch.as_tensor(rtol, dtype=dtype).to(dev),
                torch.as_tensor(atol, dtype=dtype).to(dev))
            extra_nfe = 2
        else:
            dt0 = torch.abs(torch.as_tensor(first_step, dtype=dtype))
            extra_nfe = 1
        warrays, dims = pack_mlp_weights(weights, dtype, dev)
        out, stats = mlp_solve(
            warrays, dims, state0, tau, dt0, rtol, atol, float(sign),
            f0=f0.contiguous(), activation=spec.activation, time_input=True,
            rhs="cnf", method=method,
            max_steps=(int(max_num_steps) if max_num_steps is not None
                       else _INT32_MAX))
    return out, stats.tolist(), extra_nfe


def _log_prob_from_base(out: Tensor, D: int) -> Tensor:
    """log N(z(t0)) - l(t0) from the last row of the augmented solve."""
    z_base, dlog = out[-1, :, :D], out[-1, :, D]
    return (-0.5 * torch.sum(z_base ** 2, dim=-1)
            - 0.5 * D * math.log(2.0 * math.pi)) - dlog


def cnf_log_prob_fused(weights, x: Tensor, *, t0: float = 0.0,
                       t1: float = 1.0, rtol=1e-5, atol=1e-7,
                       activation: str = "tanh", method: str = "dopri5",
                       max_num_steps=None, first_step=None):
    """log p(x) under a concat-t MLP flow, the whole augmented solve (flow
    field, exact divergence from D forward-mode passes, adaptive stepping,
    log-det quadrature) as one launch of K2 with K7's forward right-hand
    side (`ops/cuda_kernels.mlp_solve(rhs='cnf')`).

    weights: [(W [din, dout], b), ...] on x's device, the first layer
    taking D + 1 inputs with the time last (`models.cnf.CNFDynamics`;
    `weights_from_linears` or `convert.weights_from_jax` give them); hidden
    layers `activation`, the last layer linear. x: [B, D]. Integrates
    (x, 0) backward from t1 to t0. Matches `models.cnf.log_prob(trace=
    'exact')` to the solve's tolerance. Forward only: train with
    `cnf_log_prob_train` or `models.cnf.log_prob`.

    K2 runs at every B: the reference's fallback to the generic engine past
    a TPU memory budget has no counterpart here. Returns (logp [B],
    SolverStats), nfe counting the initial-step evaluations.
    """
    x = _as_state(x)
    B, D = x.shape
    weights = _cnf_weights(weights, D, "cnf_log_prob_fused")
    _cnf_method(method)
    spec = MLPSpec(activation=activation, time_input=True)
    out, st, extra = _cnf_forward_solve(
        spec, weights, x.detach(), torch.tensor([t1, t0], dtype=x.dtype),
        rtol, atol, method, max_num_steps, first_step)
    return (_log_prob_from_base(out, D),
            SolverStats(st[0] + extra, st[1], st[2], st[3]))


def cnf_sample_fused(weights, generator: torch.Generator, n: int, dim: int,
                     *, t0: float = 0.0, t1: float = 1.0, rtol=1e-5,
                     atol=1e-7, activation: str = "tanh",
                     method: str = "dopri5", max_num_steps=None,
                     dtype=torch.float32) -> Tensor:
    """Flow samples with the whole forward solve as one K2 launch (the
    fused counterpart of `models.cnf.sample`): base noise [n, dim] drawn
    from `generator` (the reference's `key`) on its device, moved to the
    weights' device and solved from t0 to t1 by `solve_mlp_spec` with the
    concat-t MLP."""
    z = torch.randn((n, dim), generator=generator, dtype=dtype,
                    device=generator.device)
    z = z.to(weights[0][0].device)
    spec = MLPSpec(activation=activation, time_input=True)
    res = solve_mlp_spec(spec, weights, z, [t0, t1], rtol=rtol, atol=atol,
                         method=method, max_num_steps=max_num_steps)
    return res.ys[-1]


#: The reference's training chunks (fast.py:2559-2579): it cuts the batch
#: into chunks of b_max samples, b_max from a TPU stack model, and each
#: chunk is its own forward and backward solve with its own controllers.
#: This constant, with _CONV_STACK_BUDGET and _LANE, reproduces that
#: partition, which the answers depend on; it is no memory budget of the
#: card.
_CNF_STACK_BLOCKS = 56


def cnf_train_block_size(D: int, widths) -> int:
    """Samples in a chunk of `cnf_log_prob_train`: the reference's
    ((14 MiB // (4 * 56 * h_maxP)) // 128) * 128 with h_maxP the largest of
    D + 1 and the layers' output `widths`, each rounded up to 8 (2048 at
    width 32, 1024 at 64)."""
    h = max(-(-w // 8) * 8 for w in [D + 1, *widths])
    return (_CONV_STACK_BUDGET // (4 * _CNF_STACK_BLOCKS * h)) // _LANE \
        * _LANE


class _CNFTrain(torch.autograd.Function):
    """Forward: `_cnf_forward_solve` (K2 with K7's forward). Backward: one
    K3 sweep with K7's adjoint (reference fast.py:_vjp_bwd, :2604-2631).
    `cfg` carries the static options."""

    @staticmethod
    def forward(ctx, cfg, x, *flat):
        weights = cfg["unflatten"](flat)
        out, st, extra = _cnf_forward_solve(
            cfg["spec"], weights, x.detach(), cfg["t"], cfg["rtol"],
            cfg["atol"], cfg["method"], cfg["max_num_steps"],
            cfg["first_step"])
        emit_fwd(cfg["nfe_meter"], st[0] + extra, st[1])
        ctx.cfg = cfg
        ctx.save_for_backward(out, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        out, *flat = ctx.saved_tensors
        weights = cfg["unflatten"](flat)
        dtype, dev = out.dtype, out.device
        D = out.shape[2] - 1
        # t = [t1, t0] decreases: tau = -t, the reference's sign -1.
        tau = -cfg["t"]
        dt0 = 0.1 * torch.abs(tau[-1] - tau[-2])
        warrays, dims = pack_mlp_weights(weights, dtype, dev)
        ay0, aw, _, bstats = mlp_adjoint_solve(
            warrays, dims, out.contiguous(), g.to(dtype).contiguous(), tau,
            dt0, cfg["adjoint_rtol"], cfg["adjoint_atol"], -1.0,
            activation=cfg["spec"].activation, method=cfg["method"],
            max_steps=cfg["max_steps"], seminorm=cfg["adjoint_seminorm"],
            rhs="cnf")
        nfe, nacc, _, status = bstats.tolist()
        emit_bwd(cfg["nfe_meter"], nfe, nacc)
        grads, off = [], 0
        for (W, b), (din, dout) in zip(weights, dims):
            grads.append(aw[off:off + din * dout].view(dout, din).t()
                         .to(W.dtype))
            off += din * dout
            if b is not None:
                grads.append(aw[off:off + dout].to(b.dtype))
            off += dout
        # ay0 = dL/d state(t1) = [dL/dx; dL/dl0]: l0 is the zero start.
        grads = [ay0[:, :D].contiguous()] + grads
        if status != 0:
            # A truncated sweep would return a partial adjoint: poison
            # every gradient, as the reference does (fast.py:2617-2631).
            grads = [torch.full_like(v, float("nan")) for v in grads]
        return (None, *grads)


def cnf_log_prob_train(weights, x: Tensor, *, t0: float = 0.0,
                       t1: float = 1.0, rtol=1e-5, atol=1e-7,
                       activation: str = "tanh", method: str = "dopri5",
                       adjoint_rtol=None, adjoint_atol=None,
                       adjoint_seminorm: bool = False, max_num_steps=None,
                       first_step=None, nfe_meter=None) -> Tensor:
    """O(1)-memory differentiable FFJORD density, two kernels: the forward
    augmented solve is one K2 launch with K7's forward right-hand side
    (flow, exact divergence, log-det quadrature), and the backward is one
    K3 sweep with K7's adjoint, the divergence's second-order VJP inside
    (`ops/cuda_adjoint.mlp_adjoint_solve(rhs='cnf')`). A
    `torch.autograd.Function`: gradients flow to the weights and to x.

    Same weight convention as `cnf_log_prob_fused`. The sweep starts from
    a tenth of the span and takes `adjoint_rtol` / `adjoint_atol` (default
    rtol / atol), `adjoint_seminorm` and the forward's max_num_steps; a
    sweep that fails (status != 0) returns NaN gradients. Forward and
    backward stats go to `nfe_meter`.

    As in the reference, a batch past `cnf_train_block_size` samples is cut
    into chunks of that size, each its own K2 and K3 launch with its own
    controllers (2048 samples at width 32: B = 4096 is two chunks); the
    log-probs concatenate and the gradients add.
    """
    x = _as_state(x)
    B, D = x.shape
    weights = _cnf_weights(weights, D, "cnf_log_prob_train")
    _cnf_method(method)
    kw = dict(t0=t0, t1=t1, rtol=rtol, atol=atol, activation=activation,
              method=method, adjoint_rtol=adjoint_rtol,
              adjoint_atol=adjoint_atol, adjoint_seminorm=adjoint_seminorm,
              max_num_steps=max_num_steps, first_step=first_step,
              nfe_meter=nfe_meter)
    b_max = cnf_train_block_size(D, [W.shape[1] for W, _ in weights])
    if 0 < b_max < B:
        return torch.cat([cnf_log_prob_train(weights, x[s:s + b_max], **kw)
                          for s in range(0, B, b_max)])
    has_bias = [b is not None for _, b in weights]
    flat = [v for W, b in weights for v in ((W, b) if b is not None
                                            else (W,))]

    def unflatten(xs):
        it = iter(xs)
        return [(next(it), next(it) if hb else None) for hb in has_bias]

    cfg = {"spec": MLPSpec(activation=activation, time_input=True),
           "unflatten": unflatten, "t": torch.tensor([t1, t0],
                                                     dtype=x.dtype),
           "rtol": rtol, "atol": atol,
           "adjoint_rtol": rtol if adjoint_rtol is None else adjoint_rtol,
           "adjoint_atol": atol if adjoint_atol is None else adjoint_atol,
           "adjoint_seminorm": bool(adjoint_seminorm), "method": method,
           "max_num_steps": max_num_steps,
           "max_steps": (int(max_num_steps) if max_num_steps is not None
                         else _INT32_MAX),
           "first_step": first_step, "nfe_meter": nfe_meter}
    out = _CNFTrain.apply(cfg, x, *flat)
    return _log_prob_from_base(out, D)


# ---------------------------------------------------------------------------
# Fusion of arbitrary dynamics (K14): solve_fused and its adapters
# ---------------------------------------------------------------------------

#: Calls of the fused front ends that ran the generic engine instead: the
#: dynamics (or the options) fell outside the plan's subset.
fuse_fallbacks = 0


def tree_state_parts(y0):
    """Pieces that put a tuple / dict state on the fused tier's [B, D]
    layout (reference `fast.py:384`). Returns None for a plain [B, D] or
    [D] tensor, else (y_bd, to_bd, from_bd, rebuild): to_bd maps a state
    nest to the [B, D] concat of its leaves (each reshaped to [B, d_i]),
    from_bd inverts it, rebuild maps a trajectory [..., B, D] back to the
    nest with leaves [..., B, *leaf_shape[1:]]. A nest without a shared
    leading batch axis raises FusionError."""
    if isinstance(y0, Tensor) and y0.ndim in (1, 2):
        return None
    leaves = tree_leaves(y0)
    if not leaves:
        raise _pb.FusionError("empty pytree state")
    if any(l.ndim < 1 for l in leaves):
        raise _pb.FusionError(
            "pytree state with scalar leaves is not fusable (the fused tier "
            "needs a shared leading batch axis)")
    B = int(leaves[0].shape[0])
    if any(int(l.shape[0]) != B for l in leaves):
        raise _pb.FusionError("pytree state leaves disagree on the leading "
                              "(batch) axis; not fusable")
    shapes = [tuple(l.shape) for l in leaves]
    ds = [math.prod(s[1:]) for s in shapes]
    offs = np.concatenate([[0], np.cumsum(ds)]).tolist()
    dtype = leaves[0].dtype
    for l in leaves[1:]:
        dtype = torch.promote_types(dtype, l.dtype)

    def to_bd(tree):
        ls = tree_leaves(tree)
        if len(ls) != len(shapes):
            raise _pb.FusionError("dynamics returned a different pytree "
                                  "structure than the state")
        return torch.cat([l.reshape(B, d).to(dtype)
                          for l, d in zip(ls, ds)], dim=1)

    def from_bd(y):
        return tree_unflatten(y0, [y[:, o:o + d].reshape(s) for o, d, s in
                                   zip(offs, ds, shapes)])

    def rebuild(ys):
        lead = tuple(ys.shape[:-2])
        return tree_unflatten(y0, [ys[..., o:o + d].reshape(lead + s)
                                   for o, d, s in zip(offs, ds, shapes)])

    return to_bd(y0), to_bd, from_bd, rebuild


def tree_state_adapter(func, y0):
    """A tuple / dict state on the fused tier (reference `fast.py:438`):
    None for a plain tensor state, else (wrapped_func, y_bd, rebuild), the
    function wrapped to map the [B, D] concat to itself (its slices,
    reshapes and concat trace into the plan) and `rebuild` mapping the
    trajectory back to the nest."""
    parts = tree_state_parts(y0)
    if parts is None:
        return None
    y_bd, to_bd, from_bd, rebuild = parts

    def wrapped(t, y):
        return to_bd(func(t, from_bd(y)))

    return wrapped, y_bd, rebuild


def solve_fused(func, y0: Tensor, t, *, rtol=1e-6, atol=1e-8,
                method: str = "dopri5", max_num_steps=None, first_step=None,
                matmul: str = "auto", safety: float = 0.9,
                ifactor: float = 10.0, dfactor: float = 0.2,
                num_steps=None, step_size=None, per_sample: bool = False,
                dot_precision: str = "highest", dense_output: bool = False,
                max_order: Optional[int] = None,
                max_iters: int = 4, _dtype=None) -> SolveResult:
    """Whole-solve fused solve of arbitrary plain-PyTorch dynamics, one
    kernel launch (reference `fast.py:784`).

    func(t, y): a function of the batch-major state y [B, D] built from the
    plan's subset (`ops/plan_bridge.py`: elementwise ops, products against
    closed-over weights or module parameters, broadcasts, feature-axis
    reductions, concats, slices and flips, and the batch couplings
    y.sum(0) / y.mean(0) / y.amax(0)). It is captured once with make_fx on
    y0; dynamics outside the subset raise `plan_bridge.FusionError` (the
    `odeint(options={'fuse': True})` route catches it and runs the generic
    engine). y0: [B, D], or [D] (vmapped over a batch of one); t may
    increase or decrease. Returns ys [T, B, D] (or [T, D]) and stats.

    Adaptive methods run K2 with the plan (per_sample=True: K5, a step
    controller a sample, with `lane_stats`); the front end evaluates f0 and,
    when first_step is None, the HNW first step with the plan's plain
    version (2 extra evaluations, else 1, counted in nfe). Fixed-grid
    methods run K8 on the requested times or a `num_steps` / `step_size`
    grid. The Adams family runs K10 ('explicit_adams', 'fixed_adams': the
    same grids, max_order default 4, max_iters) or K11 ('adams': VCABM from
    f0 and the HNW first step at order 1, max_order default 12), as
    `solve_mlp_spec` does; a reduced dot_precision raises ValueError there,
    as in the reference.

    dot_precision ('mixed', 'bf16'): K4's tier at every dot of the plan
    that `matmul` selects (reference `fast.py:844-859`); the plan then runs
    on its tile route (`cuda_plan.plan_solve`, `plan_solve_fixed`): K2,
    K8, or K5's tile engine with per_sample. 'bf16' is fixed-grid only and
    the Adams kernels take no tier (ValueError, as in the reference).

    dense_output=True (adaptive RK methods, one controller): K2 also keeps
    every accepted step's interpolant in a buffer of S = max_num_steps
    (default 1024) rows, and the step budget is S, so running out of rows
    surfaces as status 1 (MAX_STEPS_REACHED), as in the reference;
    `SolveResult.dense` is a `DenseOutput` over the flat [B * D] state
    (batch-major) whose unused rows read t1 = +inf. The VCABM, the
    fixed-grid and Adams methods and per_sample refuse it with FusionError,
    as in the reference (the reference's grid-blocked `BlockDenseOutput`
    has no counterpart: K2 runs one controller at every batch).

    A coupled plan (a cross-sample `bsum`/`bmax` such as `y.mean(0)`) runs
    on one block of its kernel, every evaluation batch-wide with the block
    meeting at each coupling: K2 (adaptive), K8 (fixed grid), K10 (both
    fixed-step Adams methods) or K11 ('adams'); with per_sample it raises
    ValueError, as in the reference.
    """
    y0 = torch.as_tensor(y0)
    squeeze = False
    if y0.ndim == 1:
        inner = func

        def func(tt, yy):
            return torch.func.vmap(lambda v: inner(tt, v))(yy)

        y0 = y0[None]
        squeeze = True
    fixed = method in tableaus.FIXED_TABLEAUS_BY_NAME
    adams = method in _ADAMS_METHODS
    if not (fixed or adams or method in tableaus.TABLEAUS_BY_NAME):
        raise _pb.FusionError(
            f"method {method!r} has no whole-solve kernel (available: "
            f"{sorted(tableaus.TABLEAUS_BY_NAME)} adaptive, "
            f"{sorted(tableaus.FIXED_TABLEAUS_BY_NAME)} fixed-grid, "
            f"{sorted(_ADAMS_METHODS)} Adams; the hypersolvers run "
            "solve_hyper)")
    if method == "adams" and dense_output:
        raise _pb.FusionError(
            "dense_output applies to adaptive RK methods only")
    if dot_precision not in ("highest", "bf16", "mixed"):
        raise ValueError(f"dot_precision must be 'highest', 'bf16' or "
                         f"'mixed', got {dot_precision!r}")
    if adams and dot_precision != "highest":
        raise ValueError(
            f"dot_precision={dot_precision!r} is not supported on the Adams "
            "kernels (their corrector/order machinery assumes f32-accurate "
            "dots); use an RK method")
    if dot_precision == "bf16" and not fixed:
        raise ValueError(
            "dot_precision='bf16' is fixed-grid serving only (its ~2e-3 "
            "single-pass noise poisons the embedded error estimate); use "
            "'mixed' for adaptive methods")
    if dense_output and (fixed or adams):
        raise _pb.FusionError(
            "dense_output applies to adaptive methods only (the generic "
            "fixed-grid engine has no dense output either)")
    if per_sample and (fixed or adams):
        raise _pb.FusionError(
            "per_sample applies to adaptive RK methods only (fixed grids "
            "and the Adams kernels have one controller or none)")
    if per_sample and dense_output:
        raise _pb.FusionError(
            "per_sample + dense_output is unsupported (per-sample steps "
            "have no shared interpolant sequence)")
    # _dtype (ops/doublefloat only): capture at y0's own dtype, then pack
    # the constants and run the state, the times, the solve and the results
    # in _dtype.
    dtype = _dtype or y0.dtype
    y0, t = _check_spec_inputs(y0, t, dtype)
    dev = y0.device

    def result(out, stats, extra=None):
        ys = out[:, 0] if squeeze else out
        if dense_output:
            return SolveResult(ys, stats, dense=extra)
        if extra is not None and squeeze:
            extra = SolverStats(*(x[0] for x in extra))
        return SolveResult(ys, stats, lane_stats=extra)

    if t.shape[0] == 1:
        return result(y0[None].to(dtype, copy=True), SolverStats(0, 0, 0, 0))
    y0 = y0.contiguous()
    plan, consts = _pb.build_plan(func, t[0].to(dev), y0, matmul=matmul)
    _check_plan_route(plan, per_sample)
    packed = _pb.pack_consts(plan, consts, dtype, dev)
    out, stats, extra = _plan_solve(
        plan, packed, y0.to(dtype), t, rtol=rtol, atol=atol, method=method,
        max_num_steps=max_num_steps, first_step=first_step, safety=safety,
        ifactor=ifactor, dfactor=dfactor, num_steps=num_steps,
        step_size=step_size, per_sample=per_sample, max_order=max_order,
        max_iters=max_iters,
        emit_dense=((int(max_num_steps) if max_num_steps is not None
                     else 1024) if dense_output else 0),
        dot_precision=dot_precision)
    return result(out, stats, extra)


def _check_plan_route(plan, per_sample: bool) -> None:
    if plan.batch_coupled and per_sample:
        raise ValueError(
            "per_sample=True with batch-coupled dynamics (a cross-sample "
            "reduction like y.mean(0)) is unsupported: per-sample stepping "
            "would mix samples at different times")


def _plan_solve(plan, packed, y0: Tensor, t: Tensor, *, rtol, atol, method,
                max_num_steps, first_step, safety=0.9, ifactor=10.0,
                dfactor=0.2, num_steps=None, step_size=None,
                per_sample=False, max_order=None, max_iters=4,
                emit_dense=0, dot_precision="highest"):
    """The forward solve of a captured plan (one K2, K5, K8, K10 or K11
    launch): f0 and, for an adaptive method or VCABM without first_step,
    the HNW first step by the plan's plain version (2 extra evaluations,
    else 1, counted in nfe). y0 [B, D] on its device, t the host times.
    Returns (out [T, B, D], SolverStats, extra): extra is the lane
    SolverStats with per_sample, with emit_dense = S > 0 K2's DenseOutput
    (its S rows; the step budget is S, as in the reference), else None.
    dot_precision is the kernel's tier at the plan's dots; f0 and the first
    step come from the plan at 'highest', as the reference's do."""
    dtype, dev = y0.dtype, y0.device
    fixed = method in tableaus.FIXED_TABLEAUS_BY_NAME
    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=dtype)
    tau = sign * t
    sign_d = sign.to(dev)
    g = cuda_plan.plan_rhs(plan, packed, sign_d)
    f0 = g(tau[0].to(dev), y0).contiguous()
    if max_order is None:
        max_order = 12 if method == "adams" else 4   # the engines' defaults
    if fixed or method in ("explicit_adams", "fixed_adams"):
        grid = _fixed_grid_tau(tau, t, num_steps, step_size)
        if fixed:
            out, stats = cuda_plan.plan_solve_fixed(
                plan, packed, y0, tau, grid, float(sign), f0, method=method,
                dot_precision=dot_precision)
        else:
            out, stats = cuda_plan.plan_solve_adams(
                plan, packed, y0, tau, grid, rtol, atol, float(sign), f0,
                implicit=method == "fixed_adams", max_order=int(max_order),
                max_iters=int(max_iters))
        return out, SolverStats(*stats.tolist()), None

    if first_step is None:
        # HNW's first step at the method's order - 1; VCABM's at order 1,
        # as the generic engine's.
        rdt = torch.as_tensor(rtol, dtype=dtype).to(dev)
        adt = torch.as_tensor(atol, dtype=dtype).to(dev)
        pick = (select_initial_step_per_sample if per_sample
                else select_initial_step)
        dt0 = pick(g, tau[0].to(dev), y0, f0,
                   1 if method == "adams"
                   else tableaus.TABLEAUS_BY_NAME[method].order - 1,
                   rdt, adt)
        extra_nfe = 2
    else:
        dt0 = torch.abs(torch.as_tensor(first_step, dtype=dtype))
        extra_nfe = 1
    max_steps = (int(max_num_steps) if max_num_steps is not None
                 else _INT32_MAX)
    if method == "adams":
        out, stats = cuda_plan.plan_solve_vcabm(
            plan, packed, y0, tau, dt0, rtol, atol, float(sign), f0,
            max_order=int(max_order), safety=safety, ifactor=ifactor,
            dfactor=dfactor, max_steps=max_steps)
        nfe, nacc, nrej, status = stats.tolist()
        return (out, SolverStats(nfe + extra_nfe, nacc, nrej, status),
                None)
    kw = dict(method=method, safety=safety, ifactor=ifactor,
              dfactor=dfactor, max_steps=max_steps,
              dot_precision=dot_precision)
    if per_sample:
        out, stats, lane = cuda_plan.plan_solve(
            plan, packed, y0, tau, dt0, rtol, atol, float(sign), f0,
            per_sample=True, **kw)
        nfe, nacc, nrej, status = stats.tolist()
        return (out, SolverStats(nfe + extra_nfe * y0.shape[0], nacc, nrej,
                                 status),
                SolverStats(lane[0] + extra_nfe, lane[1], lane[2], lane[3]))
    if emit_dense:
        # Reference fast.py:1162-1185: max_steps = S, so running out of
        # rows surfaces as MAX_STEPS_REACHED; the rows are batch-major
        # already (the reference transposes from [5 S, D, B]).
        kw["max_steps"] = emit_dense
        out, stats, meta, coef = cuda_plan.plan_solve(
            plan, packed, y0, tau, dt0, rtol, atol, float(sign), f0,
            emit_dense=emit_dense, **kw)
        m = meta.t().contiguous()
        extra = DenseOutput(m[0], m[1], m[2],
                            coef.reshape(emit_dense, 5, -1), sign)
    else:
        out, stats = cuda_plan.plan_solve(plan, packed, y0, tau, dt0, rtol,
                                          atol, float(sign), f0, **kw)
        extra = None
    nfe, nacc, nrej, status = stats.tolist()
    return out, SolverStats(nfe + extra_nfe, nacc, nrej, status), extra


def solve_hyper(func, hypernet, y0: Tensor, t, *,
                method: str = "hyper_euler", num_steps=None, step_size=None,
                matmul: str = "auto") -> SolveResult:
    """Whole-solve fused hypersolver (Poli et al. 2020) for arbitrary
    plain-PyTorch dynamics and correction nets, one K12 launch (reference
    `fast.py:1223`).

    func(t, y) and hypernet(t, y, f) work on batch-major [B, D] states;
    both are captured into plans (`ops/plan_bridge.build_plan`: the
    dynamics square, the correction net over the stacked [y, f] as a
    [B, 2 D] -> [B, D] plan) and generated as CUDA C++ into one kernel
    (`cuda_plan.plan_solve_hyper`). Either one outside the plan's subset
    raises `plan_bridge.FusionError` (`odeint(options={'fuse': True})`
    catches it and runs the generic `solvers/hyper.py`); a batch coupling
    raises NotImplementedError (ROADMAP.md queue 2 item 3). y0: [B, D], or
    [D] (vmapped over a batch of one); t may increase or decrease; the grid
    is t itself, or `num_steps` / `step_size` uniform steps with the
    outputs cubic-Hermite interpolated (nfe = evaluations of func, one more
    off the output grid). Inference only: training the hypernet
    differentiates the generic walk, as in the reference. Returns ys
    [T, B, D] (or [T, D]) and stats.
    """
    kind = method[len("hyper_"):]
    if not method.startswith("hyper_") or kind not in HYPER_KINDS:
        raise ValueError(f"unknown hypersolver {method!r}; available: "
                         f"{[f'hyper_{k}' for k in HYPER_KINDS]}")
    y0 = torch.as_tensor(y0)
    squeeze = False
    if y0.ndim == 1:
        inner_f, inner_g = func, hypernet

        def func(tt, yy):
            return torch.func.vmap(lambda v: inner_f(tt, v))(yy)

        def hypernet(tt, yy, ff):
            return torch.func.vmap(lambda v, w: inner_g(tt, v, w))(yy, ff)

        y0 = y0[None]
        squeeze = True
    y0, t = _check_spec_inputs(y0, t)
    dtype, dev = y0.dtype, y0.device
    if t.shape[0] == 1:
        ys = y0[None].clone()
        return SolveResult(ys[:, 0] if squeeze else ys,
                           SolverStats(0, 0, 0, 0))
    D = y0.shape[1]
    y0 = y0.contiguous()
    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=dtype)
    tau = sign * t
    grid = _fixed_grid_tau(tau, t, num_steps, step_size)
    t0 = t[0].to(dev)
    plan_f, consts_f = _pb.build_plan(func, t0, y0, matmul=matmul)
    with torch.no_grad():
        f0u = func(t0, y0)
    plan_g, consts_g = _pb.build_plan(
        lambda tt, ss: hypernet(tt, ss[:, :D], ss[:, D:]), t0,
        torch.cat([y0, f0u.to(dtype)], dim=1), matmul=matmul, out_dim=D)
    out, stats = cuda_plan.plan_solve_hyper(
        plan_f, plan_g, _pb.pack_consts(plan_f, consts_f, dtype, dev),
        _pb.pack_consts(plan_g, consts_g, dtype, dev), y0, tau, grid,
        float(sign), kind=kind,
        grid_is_t=num_steps is None and step_size is None)
    return SolveResult(out[:, 0] if squeeze else out,
                       SolverStats(*stats.tolist()))


class _AdjointFused(torch.autograd.Function):
    """Forward: the plan's solve (K2, K5 or K8 with K14). Backward: one
    sweep with K15, K3, K6 or K9 (reference `fast.py:_vjp_bwd` of
    `odeint_adjoint_fused`). The inputs are y0, t and the packed constants,
    which keep autograd's path to the user's tensors; `cfg` carries the
    plan and the static options and receives the forward stats."""

    @staticmethod
    def forward(ctx, cfg, y0, t, *packed):
        out, stats, _ = _plan_solve(
            cfg["plan"], packed, y0, _host_times(t, y0.dtype),
            rtol=cfg["rtol"], atol=cfg["atol"], method=cfg["method"],
            max_num_steps=cfg["max_num_steps"],
            first_step=cfg["first_step"], num_steps=cfg["num_steps"],
            step_size=cfg["step_size"], per_sample=cfg["per_sample"])
        emit_fwd(cfg["nfe_meter"], stats.nfe, stats.n_accepted)
        cfg["stats"] = stats
        ctx.cfg = cfg
        ctx.save_for_backward(out, t, *packed)
        return out

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        plan = cfg["plan"]
        ys, t, *packed = ctx.saved_tensors
        if cfg["nan_on_failed_forward"] and cfg["stats"].status != 0:
            # A failed forward's trajectory stops short: every gradient NaN
            # and no sweep (reference doublefloat.py:438-441).
            return (None, *[torch.full_like(x, float("nan"))
                            for x in (ys[0], t, *packed)])
        T = t.shape[0]
        dtype, dev = ys.dtype, ys.device
        g = g.to(dtype).contiguous()
        t_h = _host_times(t, dtype)
        # d loss / d t_i = <f(t_i, y_i), g_i>; ts_bar[0] also carries the
        # integrated a_t quadrature (zero for autonomous plans).
        t_bars = torch.stack([
            torch.sum(_pb.eval_plan_host(plan, packed, t_h[i].to(dev), ys[i])
                      * g[i]) for i in range(T)]).to(t.device, t.dtype)
        sign = 1.0 if bool(t_h[-1] >= t_h[0]) else -1.0
        tau = sign * t_h
        ys = ys.contiguous()
        if cfg["adjoint_method"] in tableaus.FIXED_TABLEAUS_BY_NAME:
            ay0, dconsts, at, bstats = cuda_plan.plan_adjoint_solve_fixed(
                plan, packed, ys, g, tau, sign,
                num_steps=cfg["bwd_num_steps"],
                method=cfg["adjoint_method"])
        else:
            if cfg["adjoint_first_step"] is not None:
                dt0 = torch.abs(torch.as_tensor(cfg["adjoint_first_step"],
                                                dtype=dtype))
            else:
                dt0 = 0.1 * torch.abs(tau[-1] - tau[-2])
            args = (plan, packed, ys, g, tau, dt0, cfg["adjoint_rtol"],
                    cfg["adjoint_atol"], sign)
            if cfg["per_sample"]:
                # A controller a sample in the backward sweep too, always
                # on the (y, a_y) seminorm.
                ay0, dconsts, at, bstats, _ = (
                    cuda_plan.plan_perlane_adjoint_solve(
                        *args, method=cfg["adjoint_method"],
                        max_steps=cfg["max_steps"]))
            else:
                ay0, dconsts, at, bstats = cuda_plan.plan_adjoint_solve(
                    *args, method=cfg["adjoint_method"],
                    max_steps=cfg["max_steps"],
                    seminorm=cfg["adjoint_seminorm"])
        nfe, nacc, _, status = bstats.tolist()
        emit_bwd(cfg["nfe_meter"], nfe, nacc)
        at = at.to(t.device, t.dtype)
        ts_bar = torch.cat([(at - torch.sum(t_bars[1:]))[None], t_bars[1:]])
        grads = [ay0, ts_bar] + [dc.to(p.dtype) for dc, p in
                                 zip(dconsts, packed)]
        if status != 0:
            # A truncated sweep would return a partial adjoint: poison every
            # gradient, as the reference does (fast.py:1938-1947).
            grads = [torch.full_like(x, float("nan")) for x in grads]
        return (None, *grads)


def odeint_adjoint_fused(func, y0: Tensor, t, *, params=None, rtol=1e-6,
                         atol=1e-8, adjoint_rtol=None, adjoint_atol=None,
                         method: str = "dopri5",
                         adjoint_method: Optional[str] = None,
                         adjoint_seminorm: bool = False, max_num_steps=None,
                         first_step=None, adjoint_first_step=None,
                         matmul: str = "auto", nfe_meter=None,
                         return_stats: bool = False, num_steps=None,
                         step_size=None, adjoint_num_steps=None,
                         per_sample: bool = False, _dtype=None,
                         _nan_on_failed_forward: bool = False):
    """O(1)-memory training of ARBITRARY plain-PyTorch dynamics in two
    launches (reference `fast.py:1566`): the forward is the plan's solve
    (`solve_fused`: K2, K5 or K8 with K14), the backward ONE sweep with the
    plan's reverse walk K15 as its right-hand side (`ops/cuda_plan.py`:
    K3 for an adaptive adjoint method, K9 for a fixed-grid one, K6 with
    per_sample).

    func(t, y, params), or func(t, y) when params is None (an nn.Module's
    parameters are then the constants it closes over): dynamics in the
    plan's subset (`ops/plan_bridge.py`) whose reverse walk exists
    (`plan_bridge.check_plan_adjoint`); otherwise FusionError, which
    `odeint_adjoint(options={'fuse': True})` catches to fall back. The
    gradients reach every tensor the function closes over that requires
    grad: the autograd boundary sits at the packed constants
    (`pack_consts(differentiable=True)`), so tied weights, transposes and
    a 0-d learnable scalar (a 'scalar' constant, data of the plan: a new
    value builds nothing) differentiate through autograd's own graph.

    per_sample=True: a controller a sample in both sweeps (K5 forward, K6
    backward on the (y, a_y) seminorm; the reference's backward takes its
    shared-controller kernel, ROADMAP.md queue 3); adaptive methods only;
    a coupled plan raises FusionError. A coupled plan trains on one block
    in both sweeps (K2 or K8 forward, K3 or K9 backward, the walk cut at
    each coupling and its transpose). Fixed backward: adjoint_num_steps
    steps an observation interval, else the forward's num_steps, else 1.
    Differentiable wrt the constants, y0 ([B, D], or [D]) and t. Returns
    the trajectory [T, B, D] ([T, D]), with the forward SolverStats when
    return_stats; both sweeps' counts go to `nfe_meter`. A failed backward
    sweep returns NaN gradients.
    """
    if params is None:
        user_func = lambda tt, yy, pp: func(tt, yy)      # noqa: E731
        params_in = ()
    else:
        user_func, params_in = func, params
    adjoint_rtol = rtol if adjoint_rtol is None else adjoint_rtol
    adjoint_atol = atol if adjoint_atol is None else adjoint_atol
    adjoint_method = method if adjoint_method is None else adjoint_method
    fixed_fwd = method in tableaus.FIXED_TABLEAUS_BY_NAME
    fixed_bwd = adjoint_method in tableaus.FIXED_TABLEAUS_BY_NAME
    for m, fx in ((method, fixed_fwd), (adjoint_method, fixed_bwd)):
        if not fx and m not in tableaus.TABLEAUS_BY_NAME:
            raise _pb.FusionError(
                f"method {m!r} has no whole-solve tableau (available: "
                f"{sorted(tableaus.TABLEAUS_BY_NAME)} adaptive, "
                f"{sorted(tableaus.FIXED_TABLEAUS_BY_NAME)} fixed-grid)")
    if per_sample and (fixed_fwd or fixed_bwd):
        raise ValueError("per_sample=True training applies to adaptive RK "
                         "methods only (forward and adjoint)")
    y0 = torch.as_tensor(y0)
    squeeze = False
    if y0.ndim == 1:
        inner = user_func

        def user_func(tt, yy, pp):
            return torch.func.vmap(lambda v: inner(tt, v, pp))(yy)

        y0 = y0[None]
        squeeze = True
    y0c, t_h = _check_spec_inputs(y0, t)
    if t_h.shape[0] < 2:
        raise _pb.FusionError("fused adjoint needs >= 2 observation times")
    # _dtype and _nan_on_failed_forward (ops/doublefloat only): both sweeps
    # run in _dtype from a capture at y0's dtype (the casts sit inside
    # autograd's graph, so each gradient comes back in its tensor's dtype),
    # and a failed forward gives NaN gradients instead of raising.
    dtype, dev = _dtype or y0c.dtype, y0c.device
    plan, consts = _pb.build_plan(
        lambda tt, yy: user_func(tt, yy, params_in), t_h[0].to(dev),
        y0c.detach().contiguous(), matmul=matmul)
    _pb.check_plan_adjoint(plan)
    if per_sample and plan.batch_coupled:
        raise _pb.FusionError(
            "per_sample=True with batch-coupled dynamics (a cross-sample "
            "reduction makes the samples interdependent)")
    packed = _pb.pack_consts(plan, consts, dtype, dev, differentiable=True)
    cfg = {"plan": plan, "rtol": rtol, "atol": atol,
           "adjoint_rtol": adjoint_rtol, "adjoint_atol": adjoint_atol,
           "method": method, "adjoint_method": adjoint_method,
           "adjoint_seminorm": bool(adjoint_seminorm),
           "per_sample": bool(per_sample), "max_num_steps": max_num_steps,
           "max_steps": (int(max_num_steps) if max_num_steps is not None
                         else _INT32_MAX),
           "first_step": first_step,
           "adjoint_first_step": adjoint_first_step,
           "num_steps": num_steps, "step_size": step_size,
           "bwd_num_steps": int(adjoint_num_steps
                                if adjoint_num_steps is not None
                                else (num_steps if num_steps is not None
                                      else 1)),
           "nfe_meter": nfe_meter,
           "nan_on_failed_forward": bool(_nan_on_failed_forward)}
    t_in = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    ys = _AdjointFused.apply(cfg, y0c.to(dtype).contiguous(),
                             t_in.to(dtype), *packed)
    if squeeze:
        ys = ys[:, 0]
    if return_stats:
        return ys, cfg["stats"]
    return ys


def cnf_sample_auto(flow, params, generator: torch.Generator, n: int,
                    dim: int, *, t0: float = 0.0, t1: float = 1.0,
                    rtol=1e-5, atol=1e-7, method: str = "dopri5",
                    max_num_steps=None, matmul: str = "auto",
                    dtype=torch.float32, z=None) -> Tensor:
    """Samples of an arbitrary plain-PyTorch flow, the forward solve as one
    fused launch (reference `fast.py:2713`; the plan counterpart of
    `cnf_sample_fused`). flow(t, z [n, dim], params) -> dz; base noise
    [n, dim] drawn from `generator` (the reference's key) on its device,
    or handed in as `z`, moved to the device of params' first tensor and
    solved from t0 to t1 by `solve_fused`. A flow outside the plan's subset
    warns and runs the generic engine (`models.cnf.sample`'s solve on the
    same noise), counted in `fuse_fallbacks`."""
    global fuse_fallbacks
    if z is None:
        z = torch.randn((n, dim), generator=generator, dtype=dtype,
                        device=generator.device)
    p_leaves = tree_leaves(params)
    if p_leaves:
        z = z.to(p_leaves[0].device)
    t = torch.tensor([t0, t1], dtype=z.dtype)

    def f(tt, zz):
        return flow(tt, zz, params)

    try:
        res = solve_fused(f, z, t, rtol=rtol, atol=atol, method=method,
                          max_num_steps=max_num_steps, matmul=matmul)
    except _pb.FusionError as e:
        warnings.warn(f"cnf_sample_auto: flow not fusable ({e}); running "
                      "the generic engine", stacklevel=2)
        fuse_fallbacks += 1
        res = _generic_solve(f, z, t, rtol=rtol, atol=atol, method=method)
    return res.ys[-1]
