"""Latent ODE on irregularly-sampled spirals (PyTorch port).

Counterpart of the repository's `examples/latent_ode.py` (upstream
`examples/latent_ode.py`): generate noisy clockwise/counter-clockwise
spirals sampled at irregular time points; encode backward with
`RecognitionRNN` to q(z0); reparameterize-sample z0; decode the latent
trajectory with dopri5 through `LatentODEFunc`; train all three nets
jointly on the ELBO with Adam.

    python -m tfdiffeq_tpu_torch.examples.latent_ode [--fused] [--niters N]

`--fused` decodes through `fast.odeint_adjoint_mlp`: one whole-solve kernel
forward (K2) and one adjoint-sweep kernel backward (K3) per step on a CUDA
device. Without it, decoding goes through the generic `odeint_adjoint`.

`--train_dir` keeps checkpoints (`examples/ckpt.py`: the three nets, Adam's
state, the iteration and the noise generator's state) every `--save_every`
iterations and at the last one; a rerun with the same directory resumes
from the newest, prints `resumed from ... at iter N` and continues exactly
as an uninterrupted run would. Not ported yet: `--dp` data parallelism
(ROADMAP.md queue 1 item 18), which raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import fast
from ..adjoint import odeint_adjoint
from ..models.latent_ode import (Decoder, LatentODEFunc, RecognitionRNN,
                                 log_normal_pdf, normal_kl)
from . import ckpt, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--niters", type=int, default=2000)
    p.add_argument("--nspiral", type=int, default=1000)
    p.add_argument("--ntimes", type=int, default=500)
    p.add_argument("--nsample", type=int, default=100)
    p.add_argument("--latent_dim", type=int, default=4)
    p.add_argument("--nhidden", type=int, default=20)
    p.add_argument("--rnn_nhidden", type=int, default=25)
    p.add_argument("--obs_dim", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--noise_std", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a "
                        "card unless --device cpu is given)")
    p.add_argument("--train_dir", default="",
                   help="checkpoint directory: save there, and resume from "
                        "its newest checkpoint")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--fused", action="store_true",
                   help="decode with the fused training path (one "
                        "whole-solve kernel forward, one adjoint-sweep "
                        "kernel backward) instead of the generic adjoint")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel training (not ported yet)")
    return p.parse_args(argv)


def generate_spirals(nspiral=1000, ntotal=500, nsample=100, start=0.0,
                     stop=6 * np.pi, noise_std=0.3, a=0.0, b=0.3, seed=0):
    """Two-class (cw/ccw) Archimedean-like spirals, irregularly subsampled
    (reference `generate_spiral2d`). Returns:
      orig_trajs [N, ntotal, 2], samp_trajs [N, nsample, 2],
      orig_ts [ntotal], samp_ts [nsample].
    """
    rng = np.random.RandomState(seed)
    orig_ts = np.linspace(start, stop, ntotal)
    samp_idx = np.sort(rng.choice(ntotal // 2, nsample, replace=False))
    samp_ts = orig_ts[samp_idx]

    # counter-clockwise spiral: r = a + b * t
    zs_cc = stop + 1.0 - orig_ts
    # Hyperbolic-like radius at the same scale as the cw spiral (the
    # upstream example uses a + b*50/zs); a sub-noise-std radius would make
    # the ccw class indistinguishable from observation noise.
    rs_cc = a + b * 50.0 / (zs_cc + 2.0)
    xs_cc, ys_cc = rs_cc * np.cos(zs_cc) - 5.0, rs_cc * np.sin(zs_cc)
    cc_traj = np.stack([xs_cc, ys_cc], axis=1)

    # clockwise spiral
    zs_cw = orig_ts
    rw_cw = a + b * zs_cw
    xs_cw, ys_cw = rw_cw * np.cos(zs_cw) + 5.0, rw_cw * np.sin(zs_cw)
    cw_traj = np.stack([xs_cw, ys_cw], axis=1)

    orig_trajs, samp_trajs = [], []
    for _ in range(nspiral):
        t0_idx = rng.randint(0, ntotal // 2)
        cc = bool(rng.rand() > 0.5)
        base = cc_traj if cc else cw_traj
        traj = base.copy()
        orig_trajs.append(traj)
        samp = traj[np.clip(samp_idx + t0_idx, 0, ntotal - 1)]
        samp = samp + rng.randn(*samp.shape) * noise_std
        samp_trajs.append(samp)

    return (np.stack(orig_trajs), np.stack(samp_trajs),
            orig_ts, samp_ts)


def build_model(args, device=None, dtype=torch.float32):
    """(rec, dyn, dec) at the sizes of `args`, with PyTorch's default
    initialisation drawn from `args.seed` (the global RNG is left as it
    was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        kw = dict(dtype=dtype)
        mods = (RecognitionRNN(args.latent_dim, args.obs_dim,
                               args.rnn_nhidden, **kw),
                LatentODEFunc(args.latent_dim, args.nhidden, **kw),
                Decoder(args.latent_dim, args.obs_dim, args.nhidden, **kw))
    return tuple(m.to(device) for m in mods)


def flax_layout_params(args, seed: int = 0) -> dict:
    """Random parameters in the JAX example's flax layout, as numpy
    (`convert.latent_ode_from_flax` takes them): kernels drawn from
    N(0, 1 / fan_in) with numpy's RandomState(seed) (the variance of flax's
    lecun_normal), zero biases."""
    rng = np.random.RandomState(seed)

    def dense(din, dout):
        return {"kernel": (rng.randn(din, dout) / np.sqrt(din))
                .astype(np.float32),
                "bias": np.zeros(dout, np.float32)}

    L, H, R, O = args.latent_dim, args.nhidden, args.rnn_nhidden, \
        args.obs_dim
    i2h = dense(O + R, R)
    return {
        "rec": {"params": {"i2h_kernel": i2h["kernel"],
                           "i2h_bias": i2h["bias"],
                           "h2o": dense(R, 2 * L)}},
        "dyn": {"params": {"Dense_0": dense(L, H), "Dense_1": dense(H, H),
                           "Dense_2": dense(H, L)}},
        "dec": {"params": {"Dense_0": dense(L, H), "Dense_1": dense(H, O)}},
    }


def make_train_step(args, rec, dyn, dec, opt, samp_ts):
    """Returns (train_step, loss_fn).

    loss_fn(xs, eps=None, generator=None) -> the negative ELBO; `eps` is the
    reparameterisation noise [B, latent] (drawn from `generator` when None).
    train_step(xs, generator=None, eps=None) takes one Adam step and returns
    the loss (detached)."""
    noise_std = args.noise_std
    fused = bool(getattr(args, "fused", False))
    spec = fast.MLPSpec(activation="elu")
    linears = (dyn.dense_0, dyn.dense_1, dyn.dense_2)

    def loss_fn(xs, eps=None, generator=None):
        # encode backward in time
        qz0_mean, qz0_logvar = rec(xs)
        if eps is None:
            eps = torch.randn(qz0_mean.shape, generator=generator,
                              dtype=qz0_mean.dtype, device=qz0_mean.device)
        z0 = qz0_mean + eps * torch.exp(0.5 * qz0_logvar)
        if fused:
            # One whole-solve kernel forward, one adjoint-sweep kernel
            # backward, with the ELU-MLP dynamics as an MLPSpec.
            weights = [(m.weight.t(), m.bias) for m in linears]
            pred_z = fast.odeint_adjoint_mlp(spec, weights, z0, samp_ts,
                                             rtol=1e-4, atol=1e-6)
        else:
            pred_z = odeint_adjoint(dyn, z0, samp_ts, method="dopri5",
                                    rtol=1e-4, atol=1e-6)
        pred_z = pred_z.transpose(0, 1)                  # [B, T, latent]
        pred_x = dec(pred_z)                             # [B, T, obs]

        # ELBO
        logvar_obs = torch.log(torch.tensor(noise_std ** 2,
                                            dtype=pred_x.dtype,
                                            device=pred_x.device))
        logpx = torch.sum(log_normal_pdf(xs, pred_x,
                                         logvar_obs.expand_as(pred_x)),
                          dim=(-2, -1))
        kl = torch.sum(normal_kl(qz0_mean, qz0_logvar,
                                 torch.zeros_like(qz0_mean),
                                 torch.zeros_like(qz0_logvar)), dim=-1)
        return -torch.mean(logpx - kl)

    def train_step(xs, generator=None, eps=None):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(xs, eps=eps, generator=generator)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step, loss_fn


def main(argv=None):
    args = parse_args(argv)
    if args.dp:
        raise NotImplementedError(
            "--dp (data-parallel training) is not ported yet: ROADMAP.md "
            "queue 1 item 18")
    device = resolve_device(args.device)

    _, samp_trajs, _, samp_ts = generate_spirals(
        nspiral=args.nspiral, ntotal=args.ntimes, nsample=args.nsample,
        noise_std=args.noise_std, seed=args.seed)
    xs = torch.tensor(samp_trajs, dtype=torch.float32, device=device)
    samp_ts = torch.tensor(samp_ts, dtype=torch.float32)

    rec, dyn, dec = build_model(args, device)
    params = [p for m in (rec, dyn, dec) for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=args.lr)
    train_step, _ = make_train_step(args, rec, dyn, dec, opt, samp_ts)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    nets = {"rec": rec, "dyn": dyn, "dec": dec}

    # Checkpoint and resume: the whole training state from the newest
    # checkpoint in --train_dir, if there is one.
    mngr, start_iter = None, 0
    if args.train_dir:
        mngr = ckpt.make_manager(args.train_dir)
        step, state = ckpt.restore_latest(mngr)
        if step is not None:
            for name, m in nets.items():
                m.load_state_dict(state["model"][name])
            opt.load_state_dict(state["optimizer"])
            gen.set_state(state["generator"])
            start_iter = step
            print(f"resumed from {args.train_dir} at iter {step}")

    start = time.time()
    n_done = 0
    for itr in range(start_iter + 1, args.niters + 1):
        loss = train_step(xs, gen)
        n_done += 1
        if itr == start_iter + 1 or itr % 20 == 0 or itr == args.niters:
            print(f"Iter {itr:04d} | -ELBO {float(loss):.4f} | "
                  f"{(time.time() - start) / n_done * 1000:.1f} ms/it")
        if mngr is not None and (itr % args.save_every == 0
                                 or itr == args.niters):
            ckpt.save(mngr, itr, {
                "model": {k: m.state_dict() for k, m in nets.items()},
                "optimizer": opt.state_dict(), "step": itr,
                "generator": gen.get_state()})
    print(f"done: {n_done} iters in {time.time() - start:.1f}s")
    return rec, dyn, dec


if __name__ == "__main__":
    main()
