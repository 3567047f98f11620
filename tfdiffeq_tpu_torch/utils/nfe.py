"""Host-side NFE counting for adjoint training loops.

Counterpart of `tfdiffeq_tpu/utils/nfe.py`: the reference's NFE logging
(upstream `examples/odenet_mnist.py` logs forward AND backward NFE per
step). The JAX package streams the stats out of compiled programs through
`io_callback`; in eager PyTorch every solve's stats are host integers once
it returns, so `odeint_adjoint` and `fast.odeint_adjoint_mlp` record them
directly (`emit_fwd`, `emit_bwd`).

Usage::

    meter = NFEMeter()
    ys = odeint_adjoint(f, y0, t, nfe_meter=meter)
    ys.sum().backward()
    print(meter.f_nfe, meter.b_nfe)   # cumulative forward/backward NFE
"""

from __future__ import annotations

import threading

__all__ = ["NFEMeter"]


class NFEMeter:
    """Accumulates forward/backward solver stats.

    Attributes (host ints, cumulative until `reset()`):
      f_nfe / b_nfe: function evaluations in forward / backward solves.
      f_steps / b_steps: accepted steps.
      f_calls / b_calls: number of solves recorded.
      last_f_nfe / last_b_nfe: most recent single-solve values.
      disabled_reason: always None here (the reference sets it when its
        backend cannot stream host callbacks).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.disabled_reason = None
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.f_nfe = 0
            self.b_nfe = 0
            self.f_steps = 0
            self.b_steps = 0
            self.f_calls = 0
            self.b_calls = 0
            self.last_f_nfe = 0
            self.last_b_nfe = 0

    def _record_fwd(self, nfe, n_acc) -> None:
        with self._lock:
            self.f_nfe += int(nfe)
            self.f_steps += int(n_acc)
            self.f_calls += 1
            self.last_f_nfe = int(nfe)

    def _record_bwd(self, nfe, n_acc) -> None:
        with self._lock:
            self.b_nfe += int(nfe)
            self.b_steps += int(n_acc)
            self.b_calls += 1
            self.last_b_nfe = int(nfe)

    def snapshot(self) -> dict:
        """Consistent copy of all counters (for periodic logging)."""
        with self._lock:
            return {
                "f_nfe": self.f_nfe, "b_nfe": self.b_nfe,
                "f_steps": self.f_steps, "b_steps": self.b_steps,
                "f_calls": self.f_calls, "b_calls": self.b_calls,
            }


def emit_fwd(meter, nfe, n_acc) -> None:
    """Record a forward solve's stats in `meter` (no-op when None)."""
    if meter is not None:
        meter._record_fwd(nfe, n_acc)


def emit_bwd(meter, nfe, n_acc) -> None:
    """Record a backward sweep's stats in `meter` (no-op when None)."""
    if meter is not None:
        meter._record_bwd(nfe, n_acc)
