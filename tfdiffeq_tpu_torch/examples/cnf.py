"""Continuous normalizing flow on a 2-D toy density (FFJORD), PyTorch port.

Counterpart of the repository's `examples/cnf.py`: trains
`models.cnf.CNFDynamics` (3 -> hidden -> hidden -> 2, tanh, concat-t) by
maximum likelihood on two moons with Adam, then draws 1000 samples from the
learned flow with the generic `models.cnf.sample`.

    python -m tfdiffeq_tpu_torch.examples.cnf [--fused] [--niters N]

Without `--fused`, the log-density is one augmented dopri5 solve of the
generic engine (exact trace) per batch, and autograd differentiates the
eager loop. `--fused` trains through `fast.cnf_log_prob_train`: one K2
launch forward (the flow and its exact divergence, K7's forward) and one K3
sweep backward (K7's adjoint) per step on a CUDA device, their plain
versions on the CPU. Both keep the reference's budget of 256 attempts a
solve (the generic path's failed solve raises; the fused backward returns
NaN gradients). `--auto` (the reference's plan-traced flow) is not ported
yet and raises NotImplementedError (ROADMAP.md queue 1 item 16).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import fast
from ..models.cnf import CNFDynamics, log_prob, sample
from . import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--niters", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a "
                        "card unless --device cpu is given)")
    p.add_argument("--fused", action="store_true",
                   help="train through fast.cnf_log_prob_train: one "
                        "whole-solve kernel forward (flow + exact "
                        "divergence + log-det) and one adjoint-sweep kernel "
                        "backward")
    p.add_argument("--auto", action="store_true",
                   help="train through the plan-traced flow (not ported "
                        "yet)")
    return p.parse_args(argv)


#: The reference's step budget of a solve (examples/cnf.py: max_steps=256).
MAX_NUM_STEPS = 256


def two_moons(n, rng):
    """Two interleaved half-circles with noise (reference `two_moons`)."""
    i = rng.randint(0, 2, n)
    theta = rng.rand(n) * np.pi
    x = np.stack([np.cos(theta) * (1 - 2 * i) + i,
                  np.sin(theta) * (1 - 2 * i) + 0.3 * i], axis=-1)
    return (x + rng.randn(n, 2) * 0.08).astype(np.float32)


def make_nll(args, flow: CNFDynamics, nfe_meter=None):
    """nll(xb) -> -mean log p(xb) through the fused or the generic path;
    the fused path's solves go to `nfe_meter`."""
    if args.fused:
        def nll(xb):
            # The weights as views of the module's parameters, so that the
            # gradients reach them.
            weights = [(m.weight.t(), m.bias) for m in flow.layers]
            return -torch.mean(fast.cnf_log_prob_train(
                weights, xb, rtol=args.rtol, atol=args.atol,
                max_num_steps=MAX_NUM_STEPS, nfe_meter=nfe_meter))
    else:
        def nll(xb):
            return -torch.mean(log_prob(
                flow, xb, rtol=args.rtol, atol=args.atol,
                options={"max_num_steps": MAX_NUM_STEPS}))
    return nll


def main(argv=None):
    args = parse_args(argv)
    if args.auto:
        raise NotImplementedError(
            "--auto (the plan-traced flow, fast.cnf_log_prob_auto) is not "
            "ported yet: ROADMAP.md queue 1 item 16")
    device = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    flow = CNFDynamics(dim=2, hidden=args.hidden, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    opt = torch.optim.Adam(flow.parameters(), lr=args.lr)
    nll = make_nll(args, flow)

    losses = []
    start = time.time()
    for itr in range(1, args.niters + 1):
        xb = torch.tensor(two_moons(args.batch_size, rng), device=device)
        opt.zero_grad(set_to_none=True)
        loss = nll(xb)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if itr == 1 or itr % 50 == 0 or itr == args.niters:
            print(f"Iter {itr:04d} | NLL {losses[-1]:.4f} | "
                  f"{(time.time() - start) / itr * 1000:.1f} ms/it")

    # Sample from the learned flow.
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        xs = sample(flow, gen, 1000, 2, rtol=args.rtol, atol=args.atol,
                    options={"max_num_steps": MAX_NUM_STEPS}).cpu().numpy()
    print(f"samples: mean {xs.mean(0).round(3)} std {xs.std(0).round(3)}")
    print(f"done: {args.niters} iters in {time.time() - start:.1f}s")
    return flow, losses, xs


if __name__ == "__main__":
    main()
