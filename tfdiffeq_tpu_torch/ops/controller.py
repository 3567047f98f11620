"""PI step-size controller.

Counterpart of `tfdiffeq_tpu/ops/controller.py`:

    dt_next = dt * clip(safety * ratio^(-icoeff/k) * prev_ratio^(-pcoeff/k),
                        lo, hi)

with k the solver order. The defaults (icoeff=1, pcoeff=0, safety=0.9,
ifactor=10, dfactor=0.2) are the reference's I-only controller: an accepted
step never shrinks (lower clip 1), a rejected one never grows (upper clip 1).

The generic engine runs this on the host, once per attempt, on 0-d tensors
that keep the dtypes of the reference (time dtype for `dt`, state dtype for
`ratio`), so the float32 rounding of every step size matches it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepController:
    safety: float = 0.9
    ifactor: float = 10.0    # max growth per step
    dfactor: float = 0.2     # max shrink per step
    icoeff: float = 1.0      # integral gain (reference-equivalent: 1)
    pcoeff: float = 0.0      # proportional gain (reference-equivalent: 0)


def next_step_size(dt: Tensor, ratio: Tensor, prev_ratio: Tensor,
                   accepted: bool, order: int, ctrl: StepController
                   ) -> Tuple[Tensor, Tensor]:
    """Next step size and updated error-ratio history.

    `ratio` is the current step's error ratio (accept iff <= 1);
    `prev_ratio` the last accepted step's. Returns (dt_next, prev_next) in
    the dtypes of `dt` and `prev_ratio`.
    """
    k = float(order)
    tiny = torch.tensor(torch.finfo(dt.dtype).tiny, dtype=dt.dtype,
                        device=dt.device)
    r = torch.maximum(ratio, tiny)
    rp = torch.maximum(prev_ratio, tiny)

    factor = ctrl.safety * r ** (-ctrl.icoeff / k)
    if ctrl.pcoeff != 0.0:
        factor = factor * (r / rp) ** (-ctrl.pcoeff / k)
    # Zero error: grow maximally (the reference's `last * ifactor`).
    factor = torch.where(ratio <= 0.0, torch.full_like(factor, ctrl.ifactor),
                         factor)

    # Accepted with I-only gains: clip to [1, ifactor]. A PI controller must
    # be able to damp an accepted step, so its lower clip stays dfactor.
    # Rejected: clip to [dfactor, 1].
    if accepted:
        lo = 1.0 if ctrl.pcoeff == 0.0 else ctrl.dfactor
        hi = ctrl.ifactor
    else:
        lo, hi = ctrl.dfactor, 1.0
    dt_next = dt * torch.clamp(factor, lo, hi)

    prev_next = r if accepted else prev_ratio
    return dt_next.to(dt.dtype), prev_next.to(prev_ratio.dtype)
