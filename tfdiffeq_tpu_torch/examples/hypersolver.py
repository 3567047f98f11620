"""Hypersolver demo (PyTorch port): train a learned correction for cheap
fixed-step solves, then serve it fused.

Counterpart of the repository's `examples/hypersolver.py` (Poli et al.
2020, "Hypersolvers: Toward Fast Continuous-Depth Models"): a small MLP
g(t, y, f) (5 -> hidden tanh -> 2 over [y, f, t]) learns the base
method's local truncation error over dt^(p+1) on the cubic spiral
dy/dt = y^3 A, so that a one-evaluation Euler walk at a fixed step budget
comes closer to the truth. Training is autograd through the generic
fixed-grid walk (`solve(..., method='hyper_euler', options={'hypernet':
g})`, Adam); serving runs `options={'fuse': True}`, where the dynamics and
the hypernet are both captured into plans and the whole corrected walk is
one K12 launch on a CUDA device (`fast.solve_hyper`).

    python -m tfdiffeq_tpu_torch.examples.hypersolver [--kind euler]
        [--num_steps 32] [--iters 1500] [--device cpu]

Differences from the reference:

- The hypernet's weights are drawn from an explicit `torch.Generator`
  seeded with 0, not a JAX key: the same keys and shapes
  (`init_hypernet`), other numbers. `hypernet(params)` takes any dict of
  those keys, so the same numpy arrays give both packages the same net.
- Adam is `torch.optim.Adam` at the reference's learning rate
  (`optax.adam`'s defaults are PyTorch's).
- The initial conditions come from the reference's disk sampler on
  `np.random.RandomState(0)`, so both draw the same states.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..odeint import solve
from . import resolve_device

A = [[-0.1, 2.0], [-2.0, -0.1]]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", default="euler",
                   choices=["euler", "midpoint", "heun"])
    p.add_argument("--num_steps", type=int, default=32,
                   help="fixed step budget over the integration span")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--span", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="initial-condition disk radius. The cubic spiral "
                        "amplifies rotation as |y|^2: Euler is only "
                        "conditionally stable, so large radii / long "
                        "spans need more steps")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a "
                        "card unless --device cpu is given)")
    return p.parse_args(argv)


def disk(rng: np.random.RandomState, n: int, radius: float, device=None,
         dtype=torch.float32) -> torch.Tensor:
    """Uniform initial conditions in a disk (bounded |y| keeps the
    conditionally stable base methods stable at the demo's step budget)."""
    th = rng.rand(n) * 2.0 * np.pi
    rr = radius * np.sqrt(rng.rand(n))
    return torch.tensor(np.stack([rr * np.cos(th), rr * np.sin(th)], 1),
                        dtype=dtype, device=device)


def dynamics(device=None, dtype=torch.float32):
    """f(t, y) = y^3 A on `device`."""
    a = torch.tensor(A, dtype=dtype, device=device)
    return lambda t, y: (y ** 3) @ a


def init_hypernet(generator: torch.Generator, hidden: int, device=None,
                  dtype=torch.float32) -> dict:
    """The reference's parameters: inputs [y (2), f (2), t (1)] -> the
    correction (2)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype).to(
            device)

    return {"w1": (normal(5, hidden) * 0.3).requires_grad_(),
            "b1": torch.zeros(hidden, dtype=dtype,
                              device=device).requires_grad_(),
            "w2": (normal(hidden, 2) * 0.1).requires_grad_(),
            "b2": torch.zeros(2, dtype=dtype, device=device).requires_grad_()}


def hypernet(params: dict):
    """g(t, y, f) = tanh([y, f, t] w1 + b1) w2 + b2 on [B, 2] states."""
    def g(t, y, fv):
        tt = torch.as_tensor(t, dtype=y.dtype, device=y.device).reshape(
            1, 1).expand(y.shape[0], 1)
        h = torch.cat([y, fv, tt], dim=1)
        return torch.tanh(h @ params["w1"] + params["b1"]) @ params["w2"] \
            + params["b2"]
    return g


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    method = f"hyper_{args.kind}"
    rng = np.random.RandomState(0)
    t = torch.linspace(0.0, args.span, args.num_steps + 1)
    f = dynamics(device)

    # Ground truth at a tight tolerance (the fixed-grid solvers output at
    # every grid node, so every node is supervised).
    y0s = disk(rng, args.batch, args.scale, device)
    with torch.no_grad():
        truth = solve(f, y0s, t, rtol=1e-7, atol=1e-9, method="dopri5").ys
        base = solve(f, y0s, t, method=args.kind).ys
    print(f"[init] {args.kind} x{args.num_steps} max err: "
          f"{float((base - truth).abs().max()):.4e}")

    params = init_hypernet(torch.Generator().manual_seed(0), args.hidden,
                           device)
    opt = torch.optim.Adam(params.values(), lr=args.lr)
    t0 = time.time()
    for it in range(1, args.iters + 1):
        opt.zero_grad(set_to_none=True)
        ys = solve(f, y0s, t, method=method,
                   options={"hypernet": hypernet(params)}).ys
        loss = torch.mean(torch.abs(ys - truth))
        loss.backward()
        opt.step()
        if it % 300 == 0 or it == 1:
            print(f"iter {it:5d}  loss {float(loss.detach()):.3e}  "
                  f"({time.time() - t0:.1f}s)")

    # Evaluation on FRESH initial conditions: generic vs fused hypersolver.
    y0e = disk(rng, args.batch, args.scale, device)
    with torch.no_grad():
        g_net = hypernet({k: v.detach() for k, v in params.items()})
        truth_e = solve(f, y0e, t, rtol=1e-7, atol=1e-9, method="dopri5").ys
        hyp = solve(f, y0e, t, method=method, options={"hypernet": g_net})
        fus = solve(f, y0e, t, method=method,
                    options={"hypernet": g_net, "fuse": True})
        base_e = solve(f, y0e, t, method=args.kind).ys

        def serve():
            return solve(f, y0e, t, method=method,
                         options={"hypernet": g_net, "fuse": True}).ys

        serve()
        sync = (torch.cuda.synchronize if device.type == "cuda"
                else lambda: None)
        sync()
        start = time.perf_counter()
        reps = 50
        for _ in range(reps):
            serve()
        sync()
        serve_ms = (time.perf_counter() - start) / reps * 1e3
    out = {"base_err": float((base_e - truth_e).abs().max()),
           "hyper_err": float((hyp.ys - truth_e).abs().max()),
           "fused_err": float((fus.ys - truth_e).abs().max()),
           "fused_nfe": int(fus.stats.nfe), "serve_ms": serve_ms,
           "loss": float(loss.detach()) if args.iters else None}
    print(f"[eval] base {args.kind}: {out['base_err']:.4e}   hyper: "
          f"{out['hyper_err']:.4e} ("
          f"{out['base_err'] / max(out['hyper_err'], 1e-12):.1f}x better)"
          f"   fused-kernel hyper: {out['fused_err']:.4e} (NFE "
          f"{out['fused_nfe']})")
    print(f"[serve] fused {method} x{args.num_steps}: {serve_ms:.3f} "
          f"ms/solve (B={args.batch}, {device.type})")
    return out


if __name__ == "__main__":
    main()
