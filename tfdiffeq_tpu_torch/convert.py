"""Carry parameters of the JAX package across to this one.

Inputs are numpy arrays (`np.asarray` of the JAX arrays), so this module
needs no JAX: the tests build every input with numpy from a seed and hand
the same arrays to both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .models.dynamics import ODEFunc


def _t(x, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_jax(np_params: dict, device=None,
                    dtype=torch.float32) -> dict:
    """The bench-style tanh-MLP parameters {'w1', 'b1', 'w2', 'b2'}
    (w1 [D, H], b1 [H], w2 [H, D], b2 [D]) as tensors for
    `fast.solve_mlp`."""
    return {k: _t(np_params[k], device, dtype).contiguous()
            for k in ("w1", "b1", "w2", "b2")}


def weights_from_jax(weights: Sequence[Tuple], device=None,
                     dtype=torch.float32) -> list:
    """An `MLPSpec` weight list [(W [din, dout], b [dout] or None), ...]
    as tensors for `fast.solve_mlp_spec` (same layout on both sides)."""
    return [(_t(W, device, dtype),
             None if b is None else _t(b, device, dtype))
            for W, b in weights]


def ode_func_from_flax(np_variables: dict, device=None,
                       dtype=torch.float32,
                       cube_input: bool = True) -> ODEFunc:
    """A port `ODEFunc` holding the weights of the flax `ODEFunc`
    (`params` -> `Dense_0` / `Dense_1` -> `kernel` [din, dout], `bias`).
    nn.Linear keeps [dout, din], so each kernel is transposed."""
    params = np_variables.get("params", np_variables)
    k0 = np.asarray(params["Dense_0"]["kernel"])
    k1 = np.asarray(params["Dense_1"]["kernel"])
    hidden, out_dim = k0.shape[1], k1.shape[1]
    if k0.shape[0] != out_dim:
        raise ValueError(f"Dense_0 takes {k0.shape[0]} inputs, Dense_1 "
                         f"gives {out_dim} outputs: not an ODEFunc")
    func = ODEFunc(hidden, out_dim, cube_input, device=device, dtype=dtype)
    with torch.no_grad():
        for layer, name in ((func.dense_0, "Dense_0"),
                            (func.dense_1, "Dense_1")):
            layer.weight.copy_(_t(params[name]["kernel"], device, dtype).t())
            layer.bias.copy_(_t(params[name]["bias"], device, dtype))
    return func
