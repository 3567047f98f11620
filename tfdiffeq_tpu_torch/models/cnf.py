"""Continuous normalizing flows (Chen et al. 2018 §4, FFJORD).

Counterpart of `tfdiffeq_tpu/models/cnf.py`: density modelling with an ODE
flow

    dz/dt = f_theta(t, z),    d log p(z(t))/dt = -tr(df/dz)

solved as one augmented solve of the generic engine. The trace is exact
(`trace='exact'`: the diagonal of each sample's Jacobian from D
forward-mode passes, `torch.func.vmap` over `jacfwd`) or a Hutchinson
estimate (`trace='hutchinson'`) from Rademacher probes drawn once, when
the dynamics are built, and held for the whole solve.

`log_prob` and `sample` run on the port's `odeint`; autograd
differentiates the eager loop, so training needs nothing else
(`examples/cnf.py`). The fused counterparts are `fast.cnf_log_prob_fused`,
`fast.cnf_sample_fused` and `fast.cnf_log_prob_train`. Not ported yet:
`augmented_dynamics_fusable`, which exists to feed the reference's plan
tracer (ROADMAP.md queue 1 item 16).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

Tensor = torch.Tensor


class CNFDynamics(nn.Module):
    """Time-conditioned MLP flow field f(t, z) = MLP([z; t]): `depth - 1`
    tanh hidden layers of `hidden` units and a linear last layer, the time
    as the last input column. Its `nn.Linear` layers come out of
    `fast.weights_from_linears` in the reference's order. With `generator`
    the kernels are drawn from N(0, 1 / fan_in) (the variance of flax's
    lecun_normal) and the biases are zero; without it, PyTorch's default
    initialisation."""

    def __init__(self, dim: int = 2, hidden: int = 64, depth: int = 3, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [dim + 1] + [hidden] * (depth - 1) + [dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device, dtype=dtype)
            for i, o in zip(widths[:-1], widths[1:]))
        if generator is not None:
            with torch.no_grad():
                for layer in self.layers:
                    w = torch.randn(layer.weight.shape, generator=generator,
                                    dtype=layer.weight.dtype)
                    layer.weight.copy_(w / math.sqrt(layer.in_features))
                    layer.bias.zero_()

    def forward(self, t, z: Tensor) -> Tensor:
        tt = torch.as_tensor(t, dtype=z.dtype).to(z.device)
        h = torch.cat([z, tt.expand(z.shape[:-1] + (1,))], dim=-1)
        for layer in self.layers[:-1]:
            h = torch.tanh(layer(h))
        return self.layers[-1](h)


def _rademacher(generator: torch.Generator, shape: Sequence[int],
                dtype=torch.float32) -> Tensor:
    """Rademacher draws (+1 or -1 with equal odds) from `generator`, on
    its device."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def augmented_dynamics(f: Callable, *, trace: str = "exact",
                       n_probes: int = 1,
                       generator: Optional[torch.Generator] = None,
                       shape: Optional[Sequence[int]] = None,
                       probes: Optional[Tensor] = None) -> Callable:
    """Lift f(t, z[B, D]) -> dz into ((z, logp) -> (dz, -tr df/dz)).

    trace='exact': the diagonal of each sample's Jacobian, D forward-mode
    passes (`torch.func.jacfwd` under `vmap`; right for small D).
    trace='hutchinson': the mean of e^T (df/dz)^T e over `n_probes`
    Rademacher probes e, each through one VJP. The probes are fixed for the
    whole solve, as the reference's `fold_in(key, i)` draws are: pass
    `probes` [n_probes, B, D], or `generator` and the state's `shape` [B, D]
    to draw them here, once.
    """
    if trace == "exact":
        def aug(t, state):
            z, _ = state

            def f_single(zi):
                return f(t, zi[None, :])[0]

            def div_single(zi):
                return torch.trace(torch.func.jacfwd(f_single)(zi))

            return f(t, z), -torch.func.vmap(div_single)(z)

        return aug
    if trace != "hutchinson":
        raise ValueError(f"unknown trace {trace!r} (expected 'exact' or "
                         "'hutchinson')")
    if probes is None:
        if generator is None or shape is None:
            raise ValueError("trace='hutchinson' requires generator= and "
                             "shape= (the reference's key=), or probes=")
        probes = _rademacher(generator, (n_probes,) + tuple(shape))
    elif probes.shape[0] != n_probes:
        raise ValueError(f"probes holds {probes.shape[0]} probes, "
                         f"n_probes is {n_probes}")

    def aug_h(t, state):
        z, _ = state
        dz, vjp_fn = torch.func.vjp(lambda zz: f(t, zz), z)
        div = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for i in range(n_probes):
            eps = probes[i].to(z.device, z.dtype)
            (vjp_eps,) = vjp_fn(eps)
            div = div + torch.sum(vjp_eps * eps, dim=-1)
        return dz, -(div / n_probes)

    return aug_h


def log_prob(f: Callable, x: Tensor, *, t0: float = 0.0, t1: float = 1.0,
             rtol: float = 1e-5, atol: float = 1e-7, trace: str = "exact",
             n_probes: int = 1, generator: Optional[torch.Generator] = None,
             probes: Optional[Tensor] = None, method: str = "dopri5",
             options: Optional[dict] = None) -> Tensor:
    """log p(x) under the flow z(t1) ~ x, z(t0) ~ N(0, I).

    Integrates (x, 0) BACKWARD from t1 to t0 through the augmented system;
    dl/dt = -tr takes l from 0 at t1 to +int tr dt at t0, so log p(x) =
    log N(z(t0)) - l(t0). Differentiable in x and in the flow's parameters
    (autograd through the generic engine's loop). Hutchinson probes come
    from `generator` or `probes` (see `augmented_dynamics`).
    """
    from ..odeint import odeint

    B, D = x.shape
    aug = augmented_dynamics(f, trace=trace, n_probes=n_probes,
                             generator=generator, shape=(B, D),
                             probes=probes)
    t = torch.tensor([t1, t0], dtype=x.dtype)
    zs, dlogs = odeint(aug, (x, torch.zeros(B, dtype=x.dtype,
                                            device=x.device)),
                       t, rtol=rtol, atol=atol, method=method,
                       options=options)
    z_base, dlog = zs[-1], dlogs[-1]
    logp_base = (-0.5 * torch.sum(z_base ** 2, dim=-1)
                 - 0.5 * D * math.log(2.0 * math.pi))
    return logp_base - dlog


def sample(f: Callable, generator: torch.Generator, n: int, dim: int, *,
           t0: float = 0.0, t1: float = 1.0, rtol: float = 1e-5,
           atol: float = 1e-7, method: str = "dopri5",
           options: Optional[dict] = None,
           dtype=torch.float32) -> Tensor:
    """Draw samples by integrating base noise N(0, I), [n, dim] drawn from
    `generator` on its device (the reference's `key`), forward through the
    flow from t0 to t1."""
    from ..odeint import odeint

    z = torch.randn((n, dim), generator=generator, dtype=dtype,
                    device=generator.device)
    t = torch.tensor([t0, t1], dtype=dtype)
    return odeint(f, z, t, rtol=rtol, atol=atol, method=method,
                  options=options)[-1]
