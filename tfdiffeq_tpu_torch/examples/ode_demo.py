"""Spiral neural-ODE training demo (PyTorch port).

Counterpart of the repository's `examples/ode_demo.py` (upstream
`examples/ode_demo.py`): the ground truth dy/dt = y^3 A from y0 = [[2, 0]]
is integrated once with dopri5 by the generic engine; an `ODEFunc` MLP
(2 -> 50 tanh -> 2 on y^3) is trained on random windows of `batch_time`
consecutive times (`batch_size` of them a step) with the L1 loss and
RMSprop.

    python -m tfdiffeq_tpu_torch.examples.ode_demo [--method rk4]
        [--adjoint | --fused] [--niters N]

Gradients: by default autograd differentiates through the solve
(`odeint`); `--adjoint` integrates the adjoint ODE (`odeint_adjoint`);
`--fused` trains through `fast.odeint_adjoint_mlp`, one whole-solve kernel
forward and one adjoint-sweep kernel backward a step on a CUDA device
(with `--method rk4`: K8, then K9).

Differences from the reference:

- The windows are drawn with numpy's `RandomState(seed)`, not a JAX key.
- RMSprop is `torch.optim.RMSprop` with the reference's decay (alpha 0.9,
  where PyTorch's default is 0.99) and eps 1e-8, but PyTorch adds eps
  outside the square root, g / (sqrt(v) + eps), where `optax.rmsprop`
  adds it inside, g / sqrt(v + eps). The first steps therefore differ in
  size; the loss and its gradients do not.
- The reference's generic mode passes `options={'max_steps': 512,
  'chunk_size': 16}`, knobs of its XLA loop that the eager loop here does
  not have (and that its own fixed-grid methods refuse); no options are
  passed here.

`--viz` writes a figure at every test iteration into `--viz_dir` (the
trajectory, the phase plane and the learned vector field through
`utils/viz.plot_phase_portrait`; matplotlib's Agg backend).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import fast
from ..adjoint import odeint_adjoint
from ..models.dynamics import make_ode_func, spiral_dynamics
from ..odeint import odeint
from . import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--method", default="dopri5")
    p.add_argument("--data_size", type=int, default=1000)
    p.add_argument("--batch_time", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=20)
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--test_freq", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="train through the fused path (one whole-solve "
                        "kernel forward, one adjoint-sweep kernel "
                        "backward); implies adjoint gradients")
    p.add_argument("--viz", action="store_true",
                   help="write a figure to --viz_dir at every test "
                        "iteration")
    p.add_argument("--viz_dir", default="png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a "
                        "card unless --device cpu is given)")
    return p.parse_args(argv)


class RunningAverageMeter:
    """The reference's exponential running average."""

    def __init__(self, momentum=0.97):
        self.momentum = momentum
        self.val = None
        self.avg = 0.0

    def update(self, val):
        if self.val is None:
            self.avg = val
        else:
            self.avg = self.avg * self.momentum + val * (1 - self.momentum)
        self.val = val


def true_trajectory(args, device=None, dtype=torch.float32):
    """(t [data_size], true_y0 [1, 2], true_y [data_size, 1, 2]): the
    ground truth, solved with dopri5 by the generic engine."""
    true_y0 = torch.tensor([[2.0, 0.0]], dtype=dtype, device=device)
    t = torch.linspace(0.0, 25.0, args.data_size, dtype=dtype)
    with torch.no_grad():
        true_y = odeint(spiral_dynamics, true_y0, t, method="dopri5")
    return t, true_y0, true_y


def get_batch(args, t, true_y, rng: np.random.RandomState):
    """A training batch: `batch_size` distinct window starts s drawn from
    `rng`. Returns (s, batch_y0 [B, 1, 2], batch_t [batch_time],
    batch_y [batch_time, B, 1, 2])."""
    s = rng.choice(args.data_size - args.batch_time, args.batch_size,
                   replace=False)
    idx = torch.as_tensor(s[None, :] + np.arange(args.batch_time)[:, None],
                          device=true_y.device)
    s_t = torch.as_tensor(s, device=true_y.device)
    return s, true_y[s_t], t[:args.batch_time], true_y[idx]


def make_pred_fn(args, func, nfe_meter=None):
    """pred(batch_y0, batch_t) -> [batch_time, B, 1, 2] in the mode that
    `args` selects; the adjoint modes report their forward and backward
    solves to `nfe_meter` (an `NFEMeter`) when one is given."""
    if args.fused:
        # The 2 -> 50 tanh(y^3) MLP as an MLPSpec: the whole forward solve
        # and the whole adjoint sweep are one kernel each.
        spec = fast.MLPSpec(activation="tanh", input_power=3)
        layers = (func.dense_0, func.dense_1)

        def pred(y0, ts):
            weights = [(m.weight.t(), m.bias) for m in layers]
            ys = fast.odeint_adjoint_mlp(spec, weights, y0[:, 0, :], ts,
                                         rtol=1e-6, atol=1e-8,
                                         method=args.method,
                                         nfe_meter=nfe_meter)
            return ys[:, :, None, :]
    elif args.adjoint:
        def pred(y0, ts):
            return odeint_adjoint(func, y0, ts, method=args.method,
                                  nfe_meter=nfe_meter)
    else:
        def pred(y0, ts):
            return odeint(func, y0, ts, method=args.method)
    return pred


def make_train_step(args, func, opt, nfe_meter=None):
    """Returns (train_step, loss_fn). loss_fn(batch_y0, batch_t, batch_y)
    is the mean absolute error of the prediction; train_step takes one
    optimizer step on it and returns the loss (detached)."""
    pred = make_pred_fn(args, func, nfe_meter)

    def loss_fn(batch_y0, batch_t, batch_y):
        return torch.mean(torch.abs(pred(batch_y0, batch_t) - batch_y))

    def train_step(batch_y0, batch_t, batch_y):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch_y0, batch_t, batch_y)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, loss_fn


def make_optimizer(args, func):
    """RMSprop at the reference's learning rate and decay (see the module
    docstring for where its eps differs)."""
    return torch.optim.RMSprop(func.parameters(), lr=args.lr, alpha=0.9,
                               eps=1e-8)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    t, true_y0, true_y = true_trajectory(args, device)
    func = make_ode_func(seed=args.seed, device=device)
    opt = make_optimizer(args, func)
    train_step, _ = make_train_step(args, func, opt)
    rng = np.random.RandomState(args.seed)

    loss_meter, time_meter = RunningAverageMeter(), RunningAverageMeter()
    end = time.time()
    for itr in range(1, args.niters + 1):
        _, by0, bt, by = get_batch(args, t, true_y, rng)
        loss = train_step(by0, bt, by)
        loss_meter.update(float(loss))
        time_meter.update(time.time() - end)
        end = time.time()
        if itr % args.test_freq == 0:
            with torch.no_grad():
                pred = odeint(func, true_y0, t, method=args.method)
                test_loss = torch.mean(torch.abs(pred - true_y))
            print(f"Iter {itr:05d} | train {loss_meter.avg:.6f} | "
                  f"total {float(test_loss):.6f} | "
                  f"{time_meter.avg * 1000:.1f} ms/it")
            if args.viz:
                visualize(args, itr, t, true_y, pred, func)
    return func


def visualize(args, itr, t, true_y, pred_y, func):
    """One figure, `<viz_dir>/<itr>.png`: x(t) true and predicted, the two
    trajectories in the phase plane, and the learned vector field (the
    reference's `visualize`)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..utils.viz import plot_phase_portrait

    t, true_y, pred_y = (x.detach().cpu().numpy() for x in (t, true_y,
                                                           pred_y))
    os.makedirs(args.viz_dir, exist_ok=True)
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    axes[0].plot(t, true_y[:, 0, 0], "g-", label="true x")
    axes[0].plot(t, pred_y[:, 0, 0], "b--", label="pred x")
    axes[0].legend()
    axes[0].set_title("trajectory")
    axes[1].plot(true_y[:, 0, 0], true_y[:, 0, 1], "g-")
    axes[1].plot(pred_y[:, 0, 0], pred_y[:, 0, 1], "b--")
    axes[1].set_title("phase")
    plot_phase_portrait(func, ax=axes[2], lim=2.0, n=40)
    axes[2].set_title("learned vector field")
    fig.tight_layout()
    fig.savefig(os.path.join(args.viz_dir, f"{itr:05d}.png"), dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
