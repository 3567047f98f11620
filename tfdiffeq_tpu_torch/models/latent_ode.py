"""Latent ODE model components.

Counterpart of `tfdiffeq_tpu/models/latent_ode.py` (upstream
`examples/latent_ode.py`): `RecognitionRNN` (backward-in-time encoder
producing q(z0)), `LatentODEFunc` (ELU MLP latent dynamics), `Decoder`, and
the ELBO pieces (`log_normal_pdf`, `normal_kl`), as `nn.Module`s and tensor
functions. Default sizes match the reference (latent 4, dynamics hidden 20,
rnn hidden 25, obs 2, decoder hidden 20). Layer names follow the flax
modules' (`dense_<i>` for `Dense_<i>`, `i2h` for `i2h_kernel`/`i2h_bias`,
`h2o`), so `convert.latent_ode_from_flax` carries parameters across; the
modules are built with PyTorch's default initialisation on the given
device and dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

Tensor = torch.Tensor


class LatentODEFunc(nn.Module):
    """Latent dynamics MLP (reference `LatentODEfunc`): latent -> hidden
    ELU -> hidden ELU -> latent, autonomous (t is ignored)."""

    def __init__(self, latent_dim: int = 4, hidden: int = 20, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dense_0 = nn.Linear(latent_dim, hidden, **kw)
        self.dense_1 = nn.Linear(hidden, hidden, **kw)
        self.dense_2 = nn.Linear(hidden, latent_dim, **kw)

    def forward(self, t, z: Tensor) -> Tensor:
        x = nn.functional.elu(self.dense_0(z))
        x = nn.functional.elu(self.dense_1(x))
        return self.dense_2(x)


class RecognitionRNN(nn.Module):
    """Plain RNN encoder run backward over the observations (reference
    `RecognitionRNN`): h' = tanh([x, h] W + b); outputs q(z0)."""

    def __init__(self, latent_dim: int = 4, obs_dim: int = 2,
                 hidden: int = 25, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.hidden = hidden
        self.i2h = nn.Linear(obs_dim + hidden, hidden, **kw)
        self.h2o = nn.Linear(hidden, 2 * latent_dim, **kw)

    def forward(self, xs: Tensor) -> Tuple[Tensor, Tensor]:
        """xs: [B, T, obs_dim] -> (qz0_mean, qz0_logvar), each [B, latent].
        A Python loop over reversed time takes the place of `lax.scan`."""
        h = torch.zeros(xs.shape[0], self.hidden, dtype=xs.dtype,
                        device=xs.device)
        for i in range(xs.shape[1] - 1, -1, -1):
            h = torch.tanh(self.i2h(torch.cat([xs[:, i], h], dim=-1)))
        qz0_mean, qz0_logvar = torch.chunk(self.h2o(h), 2, dim=-1)
        return qz0_mean, qz0_logvar


class Decoder(nn.Module):
    """Latent -> observation decoder MLP (reference `Decoder`)."""

    def __init__(self, latent_dim: int = 4, obs_dim: int = 2,
                 hidden: int = 20, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dense_0 = nn.Linear(latent_dim, hidden, **kw)
        self.dense_1 = nn.Linear(hidden, obs_dim, **kw)

    def forward(self, z: Tensor) -> Tensor:
        return self.dense_1(torch.relu(self.dense_0(z)))


def log_normal_pdf(x: Tensor, mean: Tensor, logvar: Tensor) -> Tensor:
    """Elementwise log N(x; mean, exp(logvar)) (reference
    `log_normal_pdf`)."""
    const = math.log(2.0 * math.pi)
    return -0.5 * (const + logvar + (x - mean) ** 2 / torch.exp(logvar))


def normal_kl(mu1: Tensor, lv1: Tensor, mu2: Tensor, lv2: Tensor) -> Tensor:
    """Elementwise KL(N(mu1, exp(lv1)) || N(mu2, exp(lv2))) (reference
    `normal_kl`)."""
    v1 = torch.exp(lv1)
    v2 = torch.exp(lv2)
    return 0.5 * (lv2 - lv1 + (v1 + (mu1 - mu2) ** 2) / v2 - 1.0)
