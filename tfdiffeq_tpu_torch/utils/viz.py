"""Phase-portrait and vector-field plots of 2-D dynamics.

Counterpart of `tfdiffeq_tpu/utils/viz.py` (upstream
`tfdiffeq/viz_utils.py`): `plot_vector_field` and `plot_phase_portrait` of
func(t, y[2]) -> dy[2] over an n x n grid, with matplotlib. The grid is
evaluated in one batched call (`torch.func.vmap` over the points, as the
reference vmaps) on the dynamics' own device and dtype: those of an
nn.Module's first parameter, else the CPU in float32 (the reference's);
then it moves to numpy. matplotlib is imported inside the plotting
functions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _grid_dynamics(func: Callable, t: float, lim: float, n: int):
    """(X, Y, U, V): the n x n grid over [-lim, lim]^2 and the dynamics'
    two components on it, as numpy arrays [n, n]."""
    param = (next(iter(func.parameters()), None)
             if isinstance(func, torch.nn.Module) else None)
    device = param.device if param is not None else "cpu"
    dtype = param.dtype if param is not None else torch.float32
    xs = np.linspace(-lim, lim, n)
    X, Y = np.meshgrid(xs, xs)
    pts = torch.tensor(np.stack([X.ravel(), Y.ravel()], axis=-1),
                       dtype=dtype, device=device)
    tt = torch.tensor(t, dtype=dtype, device=device)
    with torch.no_grad():
        dydt = torch.func.vmap(lambda y: func(tt, y))(pts)
    dydt = dydt.detach().cpu().numpy()
    return X, Y, dydt[:, 0].reshape(n, n), dydt[:, 1].reshape(n, n)


def plot_vector_field(func: Callable, t: float = 0.0, lim: float = 2.0,
                      n: int = 21, ax=None, normalize: bool = True,
                      **quiver_kwargs):
    """Quiver plot of a 2-D dynamics func(t, y[2]) -> dy[2]."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    X, Y, U, V = _grid_dynamics(func, t, lim, n)
    if normalize:
        mag = np.sqrt(U ** 2 + V ** 2) + 1e-12
        U, V = U / mag, V / mag
    ax.quiver(X, Y, U, V, **quiver_kwargs)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    return ax


def plot_phase_portrait(func: Callable, t: float = 0.0, lim: float = 2.0,
                        n: int = 200, ax=None, trajectories=None,
                        density: float = 1.2, **stream_kwargs):
    """Streamline phase portrait of a 2-D dynamics; optionally overlays
    trajectories (a tensor or array [T, 2], or a sequence of them)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    X, Y, U, V = _grid_dynamics(func, t, lim, n)
    ax.streamplot(X, Y, U, V, density=density, **stream_kwargs)
    if trajectories is not None:
        if hasattr(trajectories, "ndim") and trajectories.ndim == 2:
            trajectories = [trajectories]
        for traj in trajectories:
            if isinstance(traj, torch.Tensor):
                traj = traj.detach().cpu().numpy()
            traj = np.asarray(traj)
            ax.plot(traj[:, 0], traj[:, 1], lw=2)
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    return ax
