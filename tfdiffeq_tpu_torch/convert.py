"""Carry parameters of the JAX package across to this one.

Inputs are numpy arrays (`np.asarray` of the JAX arrays), so this module
needs no JAX: the tests build every input with numpy from a seed and hand
the same arrays to both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .models.cnf import CNFDynamics
from .models.dynamics import ODEFunc
from .models.latent_ode import Decoder, LatentODEFunc, RecognitionRNN
from .models.odenet import ODEBlock, ODEConvFunc, ODENetMNIST


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


def cnf_from_flax(np_variables: dict, device=None,
                  dtype=torch.float32) -> CNFDynamics:
    """A port `CNFDynamics` holding the weights of the flax `CNFDynamics`
    (`params` -> `Dense_0` .. `Dense_{depth-1}` -> `kernel` [din, dout],
    `bias`), given as numpy; dim, hidden and depth are read from the
    arrays."""
    params = np_variables.get("params", np_variables)
    depth = sum(1 for k in params if k.startswith("Dense_"))
    k0 = np.asarray(params["Dense_0"]["kernel"])
    dim = np.asarray(params[f"Dense_{depth - 1}"]["kernel"]).shape[1]
    if k0.shape[0] != dim + 1:
        raise ValueError(f"Dense_0 takes {k0.shape[0]} inputs, the flow "
                         f"gives {dim} outputs: not a concat-t CNFDynamics")
    flow = CNFDynamics(dim, k0.shape[1], depth, device=device, dtype=dtype)
    for i, layer in enumerate(flow.layers):
        dense = params[f"Dense_{i}"]
        _load_linear(layer, dense["kernel"], dense["bias"], device, dtype)
    return flow


def _load_linear(layer: torch.nn.Linear, kernel, bias, device, dtype):
    """Copy a flax Dense (kernel [din, dout], bias [dout]) into an
    nn.Linear (weight [dout, din])."""
    with torch.no_grad():
        layer.weight.copy_(_t(kernel, device, dtype).t())
        layer.bias.copy_(_t(bias, device, dtype))


def latent_ode_from_flax(np_variables: dict, device=None,
                         dtype=torch.float32):
    """The port's (RecognitionRNN, LatentODEFunc, Decoder) holding the
    parameters of the JAX example's flax modules, given as numpy:
    {'rec': {'params': {'i2h_kernel', 'i2h_bias', 'h2o'}}, 'dyn':
    {'params': {'Dense_0'..'Dense_2'}}, 'dec': {'params': {'Dense_0',
    'Dense_1'}}} (the layout of `examples/latent_ode.init_params`). Sizes
    are read from the arrays."""
    rec_p = np_variables["rec"].get("params", np_variables["rec"])
    dyn_p = np_variables["dyn"].get("params", np_variables["dyn"])
    dec_p = np_variables["dec"].get("params", np_variables["dec"])
    i2h = np.asarray(rec_p["i2h_kernel"])
    hidden = i2h.shape[1]
    latent = np.asarray(rec_p["h2o"]["kernel"]).shape[1] // 2
    obs = i2h.shape[0] - hidden
    nhidden = np.asarray(dyn_p["Dense_0"]["kernel"]).shape[1]
    dec_hidden = np.asarray(dec_p["Dense_0"]["kernel"]).shape[1]
    kw = dict(device=device, dtype=dtype)
    rec = RecognitionRNN(latent, obs, hidden, **kw)
    dyn = LatentODEFunc(latent, nhidden, **kw)
    dec = Decoder(latent, obs, dec_hidden, **kw)
    _load_linear(rec.i2h, rec_p["i2h_kernel"], rec_p["i2h_bias"], device,
                 dtype)
    _load_linear(rec.h2o, rec_p["h2o"]["kernel"], rec_p["h2o"]["bias"],
                 device, dtype)
    for mod, params, n in ((dyn, dyn_p, 3), (dec, dec_p, 2)):
        for i in range(n):
            dense = params[f"Dense_{i}"]
            _load_linear(getattr(mod, f"dense_{i}"), dense["kernel"],
                         dense["bias"], device, dtype)
    return rec, dyn, dec


def _load_conv(conv: torch.nn.Conv2d, p: dict, device, dtype) -> None:
    """Copy a flax Conv (kernel [kh, kw, C_in, C_out] HWIO, bias) into an
    nn.Conv2d (weight [C_out, C_in, kh, kw] OIHW)."""
    with torch.no_grad():
        conv.weight.copy_(_t(p["kernel"], device, dtype).permute(3, 2, 0, 1))
        conv.bias.copy_(_t(p["bias"], device, dtype))


def _load_group_norm(norm: torch.nn.GroupNorm, p: dict, device,
                     dtype) -> None:
    """Copy a flax GroupNorm (scale, bias) into an nn.GroupNorm."""
    with torch.no_grad():
        norm.weight.copy_(_t(p["scale"], device, dtype))
        norm.bias.copy_(_t(p["bias"], device, dtype))


def _load_ode_conv_func(func: ODEConvFunc, p: dict, device, dtype) -> None:
    for i, norm in enumerate((func.norm1, func.norm2, func.norm3)):
        _load_group_norm(norm, p[f"GroupNorm_{i}"], device, dtype)
    for i, cc in enumerate((func.conv1, func.conv2)):
        _load_conv(cc.conv, p[f"ConcatConv2d_{i}"]["Conv_0"], device, dtype)


def odenet_from_flax(np_variables: dict, device=None, dtype=torch.float32,
                     **kwargs):
    """The port's ODE-Net module holding the parameters of a flax one
    (`tfdiffeq_tpu/models/odenet.py`), given as numpy: an `ODENetMNIST`
    (odenet or resnet, read from the tree), or an `ODEBlock` or
    `ODEConvFunc` alone when the tree is one of those. `kwargs` go to the
    module's constructor (tol, adjoint, fused, nfe_meter, groups of an
    `ODEConvFunc`); the width is read from the arrays."""
    p = np_variables.get("params", np_variables)
    kw = dict(device=device, dtype=dtype)
    if "ConcatConv2d_0" in p:
        features = np.asarray(p["GroupNorm_0"]["scale"]).shape[0]
        func = ODEConvFunc(features, **kwargs, **kw)
        _load_ode_conv_func(func, p, device, dtype)
        return func
    if "ODEConvFunc_0" in p:
        fp = p["ODEConvFunc_0"]
        features = np.asarray(fp["GroupNorm_0"]["scale"]).shape[0]
        block = ODEBlock(features, **kwargs, **kw)
        _load_ode_conv_func(block.func, fp, device, dtype)
        return block
    features = np.asarray(p["Conv_0"]["kernel"]).shape[-1]
    n_res = sum(1 for k in p if k.startswith("ResBlock_"))
    net = ODENetMNIST(features, network="resnet" if n_res else "odenet",
                      n_res_blocks=n_res or 6, **kwargs, **kw)
    for i, conv in enumerate((net.conv_0, net.conv_1, net.conv_2)):
        _load_conv(conv, p[f"Conv_{i}"], device, dtype)
    for i, norm in enumerate((net.norm_0, net.norm_1, net.norm_out)):
        _load_group_norm(norm, p[f"GroupNorm_{i}"], device, dtype)
    _load_linear(net.fc, p["Dense_0"]["kernel"], p["Dense_0"]["bias"],
                 device, dtype)
    if n_res:
        for i, blk in enumerate(net.block):
            bp = p[f"ResBlock_{i}"]
            _load_group_norm(blk.norm1, bp["GroupNorm_0"], device, dtype)
            _load_group_norm(blk.norm2, bp["GroupNorm_1"], device, dtype)
            _load_conv(blk.conv1, bp["Conv_0"], device, dtype)
            _load_conv(blk.conv2, bp["Conv_1"], device, dtype)
    else:
        _load_ode_conv_func(net.block.func, p["ODEBlock_0"]["ODEConvFunc_0"],
                            device, dtype)
    return net
