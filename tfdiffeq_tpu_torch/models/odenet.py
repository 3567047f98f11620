"""ODE-Net MNIST classifier building blocks.

Counterpart of `tfdiffeq_tpu/models/odenet.py` (upstream
`examples/odenet_mnist.py`): `ConcatConv2d` (a conv over the channels with
the time concatenated as one more channel), the GroupNorm-normalised conv
dynamics `ODEConvFunc`, `ODEBlock` integrating them over [0, 1] at
tol = 1e-3, the `ResBlock` baseline and the whole `ODENetMNIST`: a conv
stem from 28x28 down to 7x7, the feature block, GroupNorm/relu/average
pool and the linear head. Layout is NCHW; the input is [B, 1, 28, 28].

Numbers that fix the answer, kept from the reference:

- the time channel comes LAST in `ConcatConv2d` (the JAX module's order;
  upstream torchdiffeq puts it first), so flax weights carry across;
- every GroupNorm has flax's eps of 1e-6 (PyTorch's default is 1e-5);
- the ODE dynamics' convs run with TF32 off, forward and backward (scoped
  with `torch.backends.cudnn.flags`), the counterpart of the reference's
  `Precision.HIGHEST`: they feed dopri5's error estimate and the adjoint's
  VJPs. The stem's and the ResBlocks' convs run at PyTorch's default, as
  the reference's run at XLA's: on the card cuDNN may take TF32 for them.

`ODEBlock` keeps the reference's three routes: the generic `solve`
(autograd through the eager loop), `fused=True` alone (inference through
`fast.solve_conv_ode`, K13), and `adjoint=True`, optionally with
`fused=True` (the O(1)-memory `odeint_adjoint`, its forward K13 when
fused). The last forward's NFE is the `nfe` attribute; an `NFEMeter` given
as `nfe_meter` records the adjoint's forward and backward NFE.
`convert.odenet_from_flax` carries flax parameters into these modules.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..adjoint import odeint_adjoint
from ..fast import solve_conv_ode
from ..odeint import solve
from ..ops.conv_ode import ConvODESpec

Tensor = torch.Tensor

#: flax nn.GroupNorm's epsilon.
GN_EPS = ConvODESpec.eps
#: The reference's step budget of the ODE block (its generic path's
#: options={'max_steps': 256}, its fused path's max_num_steps=256).
MAX_STEPS = 256


def _group_norm(features: int, groups: int, **kw) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, features), features, eps=GN_EPS, **kw)


def _no_tf32():
    """cuDNN with TF32 off, the other flags as they are."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


class _ConvNoTF32(torch.autograd.Function):
    """A stride-1 conv2d whose forward and backward both run with TF32
    off. Autograd runs a conv's backward after the forward's scope has
    closed, so a scope around the forward alone leaves the VJP in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        with _no_tf32():
            return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]], [1, 1], [p, p], [1, 1],
                False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None


class ConcatConv2d(nn.Module):
    """Conv2d over the channels of [x, t * 1] (reference `ConcatConv2d`;
    the time channel last), SAME padding, run with TF32 off."""

    def __init__(self, dim_in: int, dim_out: int, ksize: int = 3, *,
                 device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(dim_in + 1, dim_out, ksize,
                              padding=ksize // 2, device=device, dtype=dtype)

    def forward(self, t, x: Tensor) -> Tensor:
        tt = x.new_ones(x.shape[:1] + (1,) + x.shape[2:]) * t
        return _ConvNoTF32.apply(torch.cat([x, tt], dim=1), self.conv.weight,
                                 self.conv.bias, self.conv.padding[0])


class ODEConvFunc(nn.Module):
    """The conv dynamics with GroupNorm (reference `ODEfunc`): norm1 ->
    relu -> conv1 -> norm2 -> relu -> conv2 -> norm3."""

    def __init__(self, features: int = 64, groups: int = 32, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.features = features
        self.groups = min(groups, features)
        self.norm1 = _group_norm(features, groups, **kw)
        self.conv1 = ConcatConv2d(features, features, **kw)
        self.norm2 = _group_norm(features, groups, **kw)
        self.conv2 = ConcatConv2d(features, features, **kw)
        self.norm3 = _group_norm(features, groups, **kw)

    def forward(self, t, x: Tensor) -> Tensor:
        h = self.conv1(t, torch.relu(self.norm1(x)))
        h = self.conv2(t, torch.relu(self.norm2(h)))
        return self.norm3(h)


class ODEBlock(nn.Module):
    """Integrate `ODEConvFunc` over [0, 1] (reference `ODEBlock`) and return
    the state at t = 1.

    adjoint: O(1)-memory gradients through `odeint_adjoint`; else autograd
    differentiates the generic solve. fused: the forward solve is one K13
    launch (`fast.solve_conv_ode`, float32); alone it is inference only,
    with adjoint=True the adjoint supplies the gradients. `nfe` holds the
    last forward's NFE.
    """

    def __init__(self, features: int = 64, tol: float = 1e-3,
                 adjoint: bool = False, method: str = "dopri5",
                 nfe_meter: Any = None, fused: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.func = ODEConvFunc(features, device=device, dtype=dtype)
        self.tol = tol
        self.adjoint = adjoint
        self.method = method
        self.nfe_meter = nfe_meter
        self.fused = fused
        self.nfe = 0

    def _solve_fused(self, y0: Tensor, t: Tensor):
        res = solve_conv_ode(self.func, y0, t, rtol=self.tol, atol=self.tol,
                             method=self.method, groups=self.func.groups,
                             max_num_steps=MAX_STEPS)
        return res.ys.to(y0.dtype), res.stats

    def forward(self, x: Tensor) -> Tensor:
        t = torch.tensor([0.0, 1.0], dtype=x.dtype)
        if self.fused and not self.adjoint:
            ys, stats = self._solve_fused(x, t)
        elif self.adjoint:
            fwd = ((lambda y0, tt, _: self._solve_fused(y0, tt))
                   if self.fused else None)
            ys, stats = odeint_adjoint(self.func, x, t, rtol=self.tol,
                                       atol=self.tol, method=self.method,
                                       return_stats=True,
                                       nfe_meter=self.nfe_meter,
                                       forward_solver=fwd)
        else:
            res = solve(self.func, x, t, rtol=self.tol, atol=self.tol,
                        method=self.method,
                        options={"max_num_steps": MAX_STEPS})
            ys, stats = res.ys, res.stats
        self.nfe = int(stats.nfe)
        return ys[-1]


class ResBlock(nn.Module):
    """Plain residual block (reference `--network resnet` baseline)."""

    def __init__(self, features: int = 64, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = _group_norm(features, 32, **kw)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, **kw)
        self.norm2 = _group_norm(features, 32, **kw)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv1(torch.relu(self.norm1(x)))
        h = self.conv2(torch.relu(self.norm2(h)))
        return x + h


class ODENetMNIST(nn.Module):
    """The whole MNIST classifier (reference `ODENetMNIST`): conv stem
    (28 -> 14 -> 7 by 4x4 stride-2 convs, padding 1: flax's SAME) ->
    feature block -> GroupNorm/relu/average pool -> Linear(10)."""

    def __init__(self, features: int = 64, network: str = "odenet",
                 adjoint: bool = False, tol: float = 1e-3,
                 n_res_blocks: int = 6, nfe_meter: Any = None,
                 fused: bool = False, *, device=None, dtype=None):
        super().__init__()
        if network not in ("odenet", "resnet"):
            raise ValueError(f"network must be 'odenet' or 'resnet', got "
                             f"{network!r}")
        kw = dict(device=device, dtype=dtype)
        self.network = network
        self.conv_0 = nn.Conv2d(1, features, 3, padding=1, **kw)
        self.norm_0 = nn.GroupNorm(32, features, eps=GN_EPS, **kw)
        self.conv_1 = nn.Conv2d(features, features, 4, stride=2, padding=1,
                                **kw)
        self.norm_1 = nn.GroupNorm(32, features, eps=GN_EPS, **kw)
        self.conv_2 = nn.Conv2d(features, features, 4, stride=2, padding=1,
                                **kw)
        if network == "odenet":
            self.block = ODEBlock(features, tol, adjoint,
                                  nfe_meter=nfe_meter, fused=fused, **kw)
        else:
            self.block = nn.Sequential(*[ResBlock(features, **kw)
                                         for _ in range(n_res_blocks)])
        self.norm_out = nn.GroupNorm(32, features, eps=GN_EPS, **kw)
        self.fc = nn.Linear(features, 10, **kw)

    @property
    def nfe(self) -> int:
        """The ODE block's last forward NFE (0 for the resnet)."""
        return self.block.nfe if self.network == "odenet" else 0

    def stem(self, x: Tensor) -> Tensor:
        """[B, 1, 28, 28] images -> the [B, features, 7, 7] state the
        feature block starts from."""
        h = torch.relu(self.norm_0(self.conv_0(x)))
        h = torch.relu(self.norm_1(self.conv_1(h)))
        return self.conv_2(h)

    def forward(self, x: Tensor) -> Tensor:
        h = torch.relu(self.norm_out(self.block(self.stem(x))))
        return self.fc(torch.mean(h, dim=(2, 3)))
