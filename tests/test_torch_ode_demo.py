"""PyTorch port: the spiral demo (`tfdiffeq_tpu_torch/examples/ode_demo.py`)
against the JAX package's `examples/ode_demo.py`.

The JAX example's flax `ODEFunc` parameters are carried across as numpy by
`convert.ode_func_from_flax`; both sides get the same ground truth
(compared first), the same window starts and the same batch. One training
step's L1 loss and gradients, in float64:

- `--adjoint --method rk4` and `--fused --method rk4` (the plain K8 and K9
  on the CPU; the reference's fixed-grid kernels in interpret mode): the
  same steps with the same arithmetic, so the loss and every gradient
  agree within 1e-10 relative (to the leaf's largest entry).
- `--adjoint` with the default dopri5: identical step sequences, within
  1e-10.
- the default generic mode (dopri5, gradients through the solver): the
  reference's XLA loop also differentiates through its step-size
  controller, the port's eager loop takes the step sizes as constants, so
  gradients agree to the solver's tolerance: within 1e-6 (the loss within
  1e-12).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tfdiffeq_tpu import odeint as j_odeint, odeint_adjoint as j_adjoint  # noqa: E402
from tfdiffeq_tpu import fast as JF  # noqa: E402
from tfdiffeq_tpu.models.dynamics import (make_ode_func as j_make_ode_func,  # noqa: E402
                                          spiral_dynamics as j_spiral)
from tfdiffeq_tpu_torch import convert  # noqa: E402
from tfdiffeq_tpu_torch.examples import ode_demo as PD  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module")
def setup():
    """The JAX side's float64 parameters, ground truth and a batch, and the
    port's ground truth."""
    args = PD.parse_args([])
    _, params = j_make_ode_func(seed=0)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
    t = jnp.linspace(0.0, 25.0, args.data_size)
    true_y = j_odeint(j_spiral, jnp.asarray([[2.0, 0.0]]), t,
                      method="dopri5", options={"loop": "while"})
    p_t, _, p_true_y = PD.true_trajectory(args, dtype=F64)
    s, _, _, _ = PD.get_batch(args, p_t, p_true_y, np.random.RandomState(0))
    idx = s[None, :] + np.arange(args.batch_time)[:, None]
    batch = (true_y[s], t[:args.batch_time], true_y[idx])
    return args, params, (t, true_y), (p_t, p_true_y), s, batch


def test_ground_truth_matches_reference(setup):
    _, _, (t, true_y), (p_t, p_true_y), _, _ = setup
    np.testing.assert_allclose(p_t.numpy(), np.asarray(t), rtol=1e-15)
    np.testing.assert_allclose(p_true_y.numpy(), np.asarray(true_y),
                               rtol=1e-9, atol=1e-9)


def _j_pred(mode, method, p, y0, ts, func):
    if mode == "--fused":
        ys = JF.odeint_adjoint_mlp(
            JF.MLPSpec(activation="tanh", input_power=3),
            JF.weights_from_flax_dense(p), y0[:, 0, :], ts, rtol=1e-6,
            atol=1e-8, method=method, interpret=True)
        return ys[:, :, None, :]
    if mode == "--adjoint":
        return j_adjoint(func, y0, ts, params=p, method=method)
    return j_odeint(lambda tt, yy: func(tt, yy, p), y0, ts, method=method,
                    options={"max_steps": 512, "chunk_size": 16})


# name: (mode, method, gradient tolerance)
CASES = {
    "generic_dopri5": ("", "dopri5", 1e-6),
    "adjoint_rk4": ("--adjoint", "rk4", 1e-10),
    "adjoint_dopri5": ("--adjoint", "dopri5", 1e-10),
    "fused_rk4": ("--fused", "rk4", 1e-10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_step_matches_reference(setup, name):
    mode, method, tol = CASES[name]
    args, params, _, (p_t, p_true_y), s, (by0, bt, by) = setup
    func, _ = j_make_ode_func(seed=0)

    def jloss(p):
        pred = _j_pred(mode, method, p, by0, bt, func)
        return jnp.mean(jnp.abs(pred - by))

    j_loss, j_grads = jax.value_and_grad(jloss)(params)

    pargs = PD.parse_args([mode, "--method", method] if mode
                          else ["--method", method])
    pfunc = convert.ode_func_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              params),
                                       dtype=F64)
    _, loss_fn = PD.make_train_step(pargs, pfunc, None)
    idx = torch.as_tensor(s[None, :] + np.arange(args.batch_time)[:, None])
    p_loss = loss_fn(p_true_y[torch.as_tensor(s)], p_t[:args.batch_time],
                     p_true_y[idx])
    p_loss.backward()
    assert abs(float(p_loss.detach()) - float(j_loss)) <= \
        1e-12 * abs(float(j_loss))
    jp = j_grads["params"]
    pairs = [(pfunc.dense_0.weight.grad.t(), jp["Dense_0"]["kernel"]),
             (pfunc.dense_0.bias.grad, jp["Dense_0"]["bias"]),
             (pfunc.dense_1.weight.grad.t(), jp["Dense_1"]["kernel"]),
             (pfunc.dense_1.bias.grad, jp["Dense_1"]["bias"])]
    for a, b in pairs:
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= tol * np.max(np.abs(b))


@pytest.mark.parametrize("mode", ["", "--adjoint", "--fused"])
def test_main_runs_each_mode(mode, capsys):
    """Two RMSprop steps of the example at a small size, one test line."""
    argv = ["--method", "rk4", "--niters", "2", "--test_freq", "2",
            "--data_size", "120", "--device", "cpu"] + ([mode] if mode
                                                        else [])
    func = PD.main(argv)
    out = capsys.readouterr().out
    assert "Iter 00002" in out
    assert all(torch.isfinite(q).all() for q in func.parameters())


def test_viz_is_not_ported(tmp_path):
    """--viz (once refused here, ROADMAP item 19) writes a figure at each
    test iteration into --viz_dir."""
    d = tmp_path / "png"
    PD.main(["--viz", "--viz_dir", str(d), "--method", "rk4", "--niters",
             "2", "--test_freq", "2", "--data_size", "120", "--device",
             "cpu"])
    assert [f.name for f in d.iterdir()] == ["00002.png"]
    assert (d / "00002.png").stat().st_size > 1000


def test_default_device_is_the_card(monkeypatch):
    """--device defaults to cuda; without a card the example raises and
    names --device cpu instead of running on the CPU unasked."""
    assert PD.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        PD.main(["--niters", "1"])
