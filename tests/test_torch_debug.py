"""PyTorch port: `utils/debug.py` against the JAX package's.

`SolverFailure` carries the reference's message for each status, word for
word, on the same stats; `raise_on_failure` passes a clean result through
and raises on a failed one; `checkify_solve` (the reference's checkify
wrapper; eager PyTorch needs no functionalised check) raises
`SolverFailure` where the reference's checked function reports an error,
and returns the result where it does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import solve as jsolve
from tfdiffeq_tpu.solvers.base import SolverStats as JStats
from tfdiffeq_tpu.utils import debug as JD
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch.utils import debug as PD

Y0 = np.random.RandomState(0).randn(4, 2)
T = np.linspace(0.0, 5.0, 4)


def _stiff(t, y):
    return -50.0 * y * (1.0 + y * y)


@pytest.mark.parametrize("status", [1, 2, 3])
def test_messages_match_the_reference(status):
    stats = (57, 11, 3, status)
    got = PD.SolverFailure(status, P.SolverStats(*stats))
    ref = JD.SolverFailure(status, JStats(*(jnp.asarray(s) for s in stats)))
    assert str(got) == str(ref)
    assert got.status == P.Status(status) and got.stats.nfe == 57


def test_raise_on_failure_as_the_reference():
    ok = P.solve(lambda t, y: -y, torch.tensor(Y0), torch.tensor(T))
    assert PD.raise_on_failure(ok) is ok
    bad = P.solve(_stiff, torch.tensor(Y0), torch.tensor(T),
                  options={"max_num_steps": 4})
    jbad = jsolve(_stiff, jnp.asarray(Y0), jnp.asarray(T),
                  options={"max_num_steps": 4, "loop": "while"})
    assert bad.stats.status == int(jbad.stats.status) == 1
    with pytest.raises(PD.SolverFailure) as got:
        PD.raise_on_failure(bad)
    with pytest.raises(JD.SolverFailure) as ref:
        JD.raise_on_failure(jbad)
    assert got.value.status == ref.value.status
    assert "MAX_STEPS_REACHED" in str(got.value)
    assert str(got.value) == str(ref.value)


def test_checkify_solve_raises_where_the_reference_reports():
    def run(n):
        return P.solve(_stiff, torch.tensor(Y0), torch.tensor(T),
                       options={"max_num_steps": n})

    checked = PD.checkify_solve(run)
    assert checked.__name__ == "run"
    assert checked(10_000).stats.status == 0
    with pytest.raises(PD.SolverFailure, match="MAX_STEPS_REACHED"):
        checked(4)

    def jrun(n):
        return jsolve(_stiff, jnp.asarray(Y0), jnp.asarray(T),
                      options={"max_num_steps": n, "loop": "while"})

    err, _ = JD.checkify_solve(lambda: jrun(4))()
    assert err.get() is not None
    err, _ = JD.checkify_solve(lambda: jrun(10_000))()
    assert err.get() is None
