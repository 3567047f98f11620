"""PyTorch port: `utils/viz.py` against the JAX package's
(tests/test_viz.py:17, :25 under matplotlib's Agg backend).

Both plots write a figure; the grid the port evaluates (one vmapped call of
the dynamics) equals the reference's `_grid_dynamics` on the same function
within float32 roundoff of the two libraries' products (1e-6 relative to
the field's largest entry); an nn.Module's grid runs on its parameters'
device and dtype.
"""

import matplotlib
matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tfdiffeq_tpu.utils import viz as JV  # noqa: E402
from tfdiffeq_tpu_torch import (plot_phase_portrait,  # noqa: E402
                                plot_vector_field)
from tfdiffeq_tpu_torch.utils import viz as PV  # noqa: E402

A = np.asarray([[-0.1, 2.0], [-2.0, -0.1]])


def _f(t, y):
    return y @ torch.tensor(A.T, dtype=y.dtype)


def _jf(t, y):
    return y @ jnp.asarray(A).T


def test_plot_vector_field(tmp_path):
    ax = plot_vector_field(_f, n=8)
    out = tmp_path / "vf.png"
    ax.get_figure().savefig(out)
    assert out.stat().st_size > 1000


def test_plot_phase_portrait(tmp_path):
    ax = plot_phase_portrait(_f, n=6, trajectories=torch.zeros(5, 2))
    out = tmp_path / "pp.png"
    ax.get_figure().savefig(out)
    assert out.stat().st_size > 1000


@pytest.mark.parametrize("n, lim, t", [(8, 2.0, 0.0), (21, 3.0, 1.5)])
def test_grid_matches_the_reference(n, lim, t):
    def f(tt, y):
        return _f(tt, y) * torch.cos(tt) + y ** 3

    def jf(tt, y):
        return _jf(tt, y) * jnp.cos(tt) + y ** 3

    got = PV._grid_dynamics(f, t, lim, n)
    ref = JV._grid_dynamics(jf, t, lim, n)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    scale = max(np.abs(np.asarray(ref[2])).max(),
                np.abs(np.asarray(ref[3])).max())
    for a, b in zip(got[2:], ref[2:]):
        assert a.dtype == np.float32 and a.shape == (n, n)
        assert np.abs(a - np.asarray(b)).max() <= 1e-6 * scale


def test_a_module_grid_takes_its_parameters_dtype():
    lin = torch.nn.Linear(2, 2, dtype=torch.float64)

    class F(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = lin

        def forward(self, t, y):
            return self.lin(y)

    X, Y, U, V = PV._grid_dynamics(F(), 0.0, 1.0, 4)
    assert U.dtype == np.float64
    pts = torch.tensor(np.stack([X.ravel(), Y.ravel()], -1))
    with torch.no_grad():
        ref = lin(pts).numpy()
    np.testing.assert_array_equal(U.ravel(), ref[:, 0])
