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
  y ** p), both time directions, the five adaptive RK tableaus, one step
  controller shared by the batch.
- `solve_mlp_stepwise`: the one-step kernel (`dopri5_mlp_step`, K1) plugged
  into the generic adaptive engine through `AdaptiveConfig.step_override`.

Not ported yet (each raises NotImplementedError naming its ROADMAP queue 1
item): per-sample controllers (item 9), fixed-grid and Adams methods
(items 11 and 12), dot precisions other than 'highest' (item 14), and the
multi-card `axis_name` / `global_batch` coupling (item 18). The adjoint
training path (`odeint_adjoint_mlp`, kernel K3) is item 6's next slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import tableaus
from .ops.controller import StepController
from .ops.cuda_kernels import (_ACTIVATIONS, dopri5_mlp_step, mlp_solve,
                               pack_mlp_weights)
from .ops.norms import select_initial_step
from .solvers.adaptive import AdaptiveConfig, solve_adaptive
from .solvers.base import CanonicalProblem, SolveResult, SolverStats

Tensor = torch.Tensor

_INT32_MAX = 2 ** 31 - 1

_FIXED_METHODS = frozenset({"euler", "midpoint", "rk4", "rk4_38"})
_ADAMS_METHODS = frozenset({"adams", "explicit_adams", "fixed_adams"})


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Static topology of a fused MLP neural ODE (weights passed separately
    as [(W [din, dout], b [dout] or None), ...]).

    activation: hidden nonlinearity; final_activation: the last layer's;
    input_power: the state enters as y ** p (the spiral uses p = 3);
    time_input: the time is one extra first-layer input (last column);
    dot_precision: only 'highest' (float32-accurate products) is ported.
    The reference's `matmul` engine choice (TPU VPU or MXU) has no
    counterpart: the kernel sums every product in input order.
    """
    activation: str = "tanh"
    final_activation: str = "identity"
    input_power: int = 1
    time_input: bool = False
    dot_precision: str = "highest"

    def __post_init__(self):
        for a in (self.activation, self.final_activation):
            if a not in _ACTIVATIONS:
                raise ValueError(f"unknown activation {a!r}; available: "
                                 f"{sorted(_ACTIVATIONS)}")
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


def _check_spec_inputs(y0, t) -> Tuple[Tensor, Tensor]:
    y0 = _as_state(y0)
    t = _host_times(t, y0.dtype)
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
    'adaptive_heun', 'tsit5' or 'dopri8'. Returns ys [T, B, D] and stats.
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


def solve_mlp_spec(spec: MLPSpec, weights, y0: Tensor, t, *, rtol=1e-6,
                   atol=1e-8, method: str = "dopri5", max_num_steps=None,
                   first_step=None, per_sample: bool = False
                   ) -> SolveResult:
    """Whole-solve fused adaptive RK for a general MLP neural ODE.

    weights: [(W [din, dout], b [dout] or None), ...] on y0's device;
    y0: [B, D]; t may increase or decrease (solved in tau = sign * t, as
    the generic engine does). The host computes f0 and, when first_step is
    None, the HNW initial step (2 extra evaluations, else 1, counted in
    nfe); the kernel does the rest. Returns ys [T, B, D] and stats.
    """
    if spec.dot_precision != "highest":
        raise NotImplementedError(
            f"dot_precision={spec.dot_precision!r} is not ported yet: "
            "ROADMAP.md queue 1 item 14 (dot-precision tiers)")
    if per_sample:
        raise NotImplementedError(
            "per_sample=True is not ported yet: ROADMAP.md queue 1 item 9 "
            "(per-sample tier)")
    if method in _FIXED_METHODS:
        raise NotImplementedError(
            f"method {method!r} (fixed grid) is not ported to the fused "
            "tier yet: ROADMAP.md queue 1 item 11")
    if method in _ADAMS_METHODS:
        raise NotImplementedError(
            f"method {method!r} (Adams family) is not ported to the fused "
            "tier yet: ROADMAP.md queue 1 item 12")
    if method not in tableaus.TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(tableaus.TABLEAUS_BY_NAME)}")
    y0, t = _check_spec_inputs(y0, t)
    dtype, dev = y0.dtype, y0.device
    if t.shape[0] == 1:
        return SolveResult(y0[None].clone(), SolverStats(0, 0, 0, 0))

    sign = torch.tensor(1.0 if t[-1] >= t[0] else -1.0, dtype=dtype)
    tau = sign * t
    sign_d = sign.to(dev)

    def g(s, y):
        return sign_d * mlp_apply(spec, weights, y, sign_d * s)

    f0 = g(tau[0].to(dev), y0)
    order = tableaus.TABLEAUS_BY_NAME[method].order
    if first_step is None:
        rdt = torch.as_tensor(rtol, dtype=dtype).to(dev)
        adt = torch.as_tensor(atol, dtype=dtype).to(dev)
        dt0 = select_initial_step(g, tau[0].to(dev), y0, f0, order - 1, rdt,
                                  adt)
        extra_nfe = 2
    else:
        dt0 = torch.abs(torch.as_tensor(first_step, dtype=dtype))
        extra_nfe = 1

    warrays, dims = pack_mlp_weights(weights, dtype, dev)
    out, stats = mlp_solve(
        warrays, dims, y0.contiguous(), tau, dt0, rtol, atol, float(sign),
        f0=f0.contiguous(), activation=spec.activation,
        final_activation=spec.final_activation,
        input_power=spec.input_power, time_input=spec.time_input,
        method=method,
        max_steps=(int(max_num_steps) if max_num_steps is not None
                   else _INT32_MAX))
    nfe, nacc, nrej, status = stats.tolist()
    return SolveResult(out, SolverStats(nfe + extra_nfe, nacc, nrej, status))
