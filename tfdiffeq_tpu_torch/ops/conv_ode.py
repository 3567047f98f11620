"""Conv-ODE dynamics of the ODE-Net MNIST block, as plain tensor functions.

Counterpart of `tfdiffeq_tpu/ops/conv_ode.py`: the field GN -> relu ->
ConcatConv3x3 -> GN -> relu -> ConcatConv3x3 -> GN (upstream
`examples/odenet_mnist.py` `ODEfunc`) over an NCHW [B, C, H, W] feature map.
The reference's feature-major [C, B*H*W] layout, its lane masks and its
reduce/spread indicator matrices exist for the TPU's lanes and matrix unit
and have no counterpart here.

What fixes the answer is kept from the reference:

- the 3x3 SAME conv sums its 9 taps in `OFFSETS` order, each tap a C-deep
  contraction of the zero-padded shifted input;
- the concatenated time channel (the LAST input channel, as in the JAX
  `ConcatConv2d`) contributes t * TM, where TM is the SAME conv of the
  all-ones image by the kernel's last input-channel slice;
- GroupNorm takes var = max(E[x^2] - mean^2, 0) and rsqrt(var + eps), with
  flax's eps of 1e-6.

`conv_ode_apply` is the fast plain version (each tap's contraction is one
`einsum`); the kernel's own plain version, which repeats K13's summation
order, lives in `ops/cuda_conv.py`. Parameters are the reference's dict
{'gn': [(scale [C], bias [C])] * 3, 'conv': [(kernel [3, 3, C + 1, C],
bias [C])] * 2}, kernels in flax's HWIO layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# 3x3 neighbourhood offsets (di, dj), cross-correlation convention (what
# nn.Conv2d computes): out[i, j] += W[di + 1, dj + 1] . in[i + di, j + dj].
# Row-major over the kernel's (kh, kw), so kernel.reshape(9, ...) follows it.
OFFSETS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


@dataclasses.dataclass(frozen=True)
class ConvODESpec:
    """Static topology of the conv-ODE block."""
    height: int = 7
    width: int = 7
    channels: int = 64
    groups: int = 32
    eps: float = 1e-6       # flax nn.GroupNorm's default (torch's is 1e-5)

    @property
    def positions(self) -> int:
        return self.height * self.width


def conv_params_from_flax(variables) -> dict:
    """The parameter dict from the numpy variables of a flax `ODEConvFunc`
    (three GroupNorms, two ConcatConv2d(3x3)), as numpy arrays."""
    p = variables.get("params", variables)
    gn = [(np.asarray(p[f"GroupNorm_{i}"]["scale"]),
           np.asarray(p[f"GroupNorm_{i}"]["bias"])) for i in range(3)]
    conv = [(np.asarray(p[f"ConcatConv2d_{i}"]["Conv_0"]["kernel"]),
             np.asarray(p[f"ConcatConv2d_{i}"]["Conv_0"]["bias"]))
            for i in range(2)]
    return {"gn": gn, "conv": conv}


def as_tensors(params: dict, dtype: torch.dtype, device=None) -> dict:
    """The parameter dict with every array a detached tensor."""
    def cvt(a):
        a = a if isinstance(a, Tensor) else torch.tensor(np.asarray(a))
        return a.detach().to(device=device, dtype=dtype)

    return {"gn": [(cvt(s), cvt(b)) for s, b in params["gn"]],
            "conv": [(cvt(k), cvt(b)) for k, b in params["conv"]]}


def shift(x: Tensor, di: int, dj: int) -> Tensor:
    """out[..., i, j] = x[..., i + di, j + dj], zero outside the map."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return xp[..., 1 + di:1 + di + H, 1 + dj:1 + dj + W]


def tap_weights(kernel: Tensor) -> Tensor:
    """kernel [3, 3, C + 1, C_out] -> [9, C, C_out], taps in OFFSETS order
    (the time channel is handled by `t_channel_map`)."""
    C = kernel.shape[2] - 1
    return kernel[:, :, :C, :].reshape(9, C, kernel.shape[3]).contiguous()


def t_channel_map(kernel: Tensor, spec: ConvODESpec) -> Tensor:
    """TM [C_out, H, W]: the sum, in OFFSETS order, of the time channel's
    taps whose source lies inside the map (the SAME conv of the all-ones
    image by kernel[:, :, -1, :])."""
    ones = torch.ones((1, spec.height, spec.width), dtype=kernel.dtype,
                      device=kernel.device)
    tm = None
    for di, dj in OFFSETS:
        term = shift(ones, di, dj) * kernel[di + 1, dj + 1, -1, :][:, None,
                                                                   None]
        tm = term if tm is None else tm + term
    return tm


def conv3x3(x: Tensor, wtaps: Tensor, bias: Tensor, tm: Tensor, t) -> Tensor:
    """SAME 3x3 conv of x [B, C, H, W] by wtaps [9, C, C_out]: the taps'
    contractions summed in OFFSETS order, then the bias, then t * TM."""
    acc = None
    for k, (di, dj) in enumerate(OFFSETS):
        term = torch.einsum("bchw,co->bohw", shift(x, di, dj), wtaps[k])
        acc = term if acc is None else acc + term
    return acc + bias[:, None, None] + tm * t


def group_norm(x: Tensor, scale: Tensor, bias: Tensor,
               spec: ConvODESpec) -> Tensor:
    """Per-sample, per-group normalisation of x [B, C, H, W] with flax's
    statistics: var = max(E[x^2] - mean^2, 0) (float32 cancellation can
    make it negative for near-constant large groups, and rsqrt of a
    negative number is NaN)."""
    B, C = x.shape[:2]
    xg = x.reshape(B, spec.groups, -1)
    mean = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.clamp(torch.mean(xg * xg, dim=-1, keepdim=True)
                      - mean * mean, min=0.0)
    h = ((xg - mean) * torch.rsqrt(var + spec.eps)).reshape(x.shape)
    return h * scale[:, None, None] + bias[:, None, None]


def make_conv_ode_f(params: dict, spec: ConvODESpec, dtype=torch.float32,
                    device=None):
    """f(t, x): [B, C, H, W] -> [B, C, H, W], the whole GN/relu/conv chain
    (the parameter dict is converted once, here)."""
    p = as_tensors(params, dtype, device)
    gn = p["gn"]
    convs = [(tap_weights(k), b, t_channel_map(k, spec))
             for k, b in p["conv"]]

    def f(t, x):
        h = torch.clamp(group_norm(x, *gn[0], spec), min=0.0)
        h = conv3x3(h, *convs[0], t)
        h = torch.clamp(group_norm(h, *gn[1], spec), min=0.0)
        h = conv3x3(h, *convs[1], t)
        return group_norm(h, *gn[2], spec)

    return f


def conv_ode_apply(params: dict, t, x: Tensor, spec: ConvODESpec) -> Tensor:
    """The dynamics on NCHW x; matches the flax `ODEConvFunc` to float32
    roundoff."""
    return make_conv_ode_f(params, spec, x.dtype, x.device)(t, x)
