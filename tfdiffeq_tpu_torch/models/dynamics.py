"""Dynamics networks for the spiral neural-ODE demo.

Counterpart of `tfdiffeq_tpu/models/dynamics.py`: the ground-truth spiral
dy/dt = y^3 A with A = [[-0.1, 2], [-2, -0.1]], and the trainable `ODEFunc`
MLP (2 -> 50 tanh -> 2) applied to y^3, as an `nn.Module` whose layers
`dense_0` and `dense_1` match the flax module's `Dense_0` and `Dense_1`
(`convert.ode_func_from_flax` loads them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

SPIRAL_A = ((-0.1, 2.0), (-2.0, -0.1))


def spiral_dynamics(t, y: torch.Tensor) -> torch.Tensor:
    """Ground-truth spiral: dy/dt = y^3 A (the reference's `Lambda`)."""
    A = torch.tensor(SPIRAL_A, dtype=y.dtype, device=y.device)
    return (y ** 3) @ A


class ODEFunc(nn.Module):
    """Trainable dynamics MLP: net(y ** 3), weights drawn from N(0, 0.1^2)
    with `generator`, biases zero (the reference's initialisers)."""

    def __init__(self, hidden: int = 50, out_dim: int = 2,
                 cube_input: bool = True, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cube_input = cube_input
        self.dense_0 = nn.Linear(out_dim, hidden, device=device, dtype=dtype)
        self.dense_1 = nn.Linear(hidden, out_dim, device=device, dtype=dtype)
        with torch.no_grad():
            for layer in (self.dense_0, self.dense_1):
                w = torch.randn(layer.weight.shape, generator=generator,
                                dtype=layer.weight.dtype)
                layer.weight.copy_(0.1 * w)
                layer.bias.zero_()

    def forward(self, t, y: torch.Tensor) -> torch.Tensor:
        x = y ** 3 if self.cube_input else y
        return self.dense_1(torch.tanh(self.dense_0(x)))


def make_ode_func(hidden: int = 50, out_dim: int = 2,
                  cube_input: bool = True, seed: int = 0, *, device=None,
                  dtype=None) -> ODEFunc:
    """An `ODEFunc` with weights drawn from a generator seeded with `seed`
    (they differ from the JAX package's draws for the same seed)."""
    gen = torch.Generator().manual_seed(seed)
    return ODEFunc(hidden, out_dim, cube_input, device=device, dtype=dtype,
                   generator=gen)
