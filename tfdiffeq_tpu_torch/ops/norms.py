"""Error norms and initial-step selection.

Counterpart of `tfdiffeq_tpu/ops/norms.py`: the RMS norm of the error over
the tolerance scale, and the Hairer–Nørsett–Wanner initial step (algorithm
4.14). Every function works on tensors of any shape on any device and
returns a 0-d tensor on that device. The per-sample initial step of the
reference (`select_initial_step_per_sample`) arrives with the per-sample
tier (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def rms_norm(x: Tensor) -> Tensor:
    """Root-mean-square norm, with a NaN-free gradient at 0 (complex states
    use |x|^2)."""
    m = torch.mean((x * x.conj()).real if x.is_complex() else x * x)
    pos = m > 0.0
    safe = torch.where(pos, m, torch.ones_like(m))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(m))


def max_norm(x: Tensor) -> Tensor:
    return torch.max(torch.abs(x))


def error_ratio(y_err: Tensor, rtol, atol, y0: Tensor, y1: Tensor,
                norm: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """err / (atol + rtol * max(|y0|, |y1|)) under `norm` (default RMS).
    A step is accepted iff the result is <= 1."""
    norm = norm or rms_norm
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    return norm(y_err / scale)


def select_initial_step(func: Callable[[Tensor, Tensor], Tensor], t0: Tensor,
                        y0: Tensor, f0: Tensor, order: int, rtol, atol,
                        norm: Optional[Callable[[Tensor], Tensor]] = None
                        ) -> Tensor:
    """Empirical first step size (HNW algorithm 4.14): two trial norms give
    h0, one explicit-Euler probe refines it to h1. Costs one evaluation of
    `func`. Returns a 0-d tensor of the state's real dtype on y0's device."""
    norm = norm or rms_norm
    rdt = _real_dtype(y0.dtype)
    scale = atol + torch.abs(y0) * rtol
    d0 = norm(y0 / scale)
    d1 = norm(f0 / scale)

    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.where(d1 > 0.0, d1,
                                             torch.ones_like(d1))).to(rdt)

    y1 = y0 + h0.to(y0.dtype) * f0
    f1 = func(t0 + h0.to(t0.device), y1)
    d2 = norm((f1 - f0) / scale) / h0

    d_max = torch.maximum(d1, d2)
    h1 = torch.where(
        d_max <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.where(d_max > 0.0, d_max, torch.ones_like(d_max)))
        ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * h0, h1).to(rdt)
