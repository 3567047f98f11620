"""The port's resets and interpolated adjoints against a direct gradient at
the bench training protocol (bench.py:788-804) at B = 4096, on the CPU.

The direct gradient is autograd through the generic `odeint` at rtol =
atol = 1e-10 in float64, taken over chunks of the batch (the samples do not
interact and the loss is a sum over them), with the biases given one row a
sample so that each bias gradient's per-sample terms come out too. Prints,
for b1 and b2, |gradient| against the sum of its terms' magnitudes (the
cancellation), then each parameter's max |got - direct| / max |direct| for
`odeint_adjoint(options={'fuse': True})` in resets and interpolated mode
at rtol = atol = 1e-6 in float64 and float32 (chip_smoke.py [42]'s
configuration) and at 1e-8 in float64.

    python tools/torch_adjoint_gap.py [--batch 4096] [--chunk 256]

About 3 minutes on 4 CPU threads; tests/test_torch_adjoint_gap.py holds
the same comparison at B = 16.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import tfdiffeq_tpu_torch as P  # noqa: E402

T_OUT, SPAN, D, H = 64, 25.0, 2, 50
NAMES = ("w1", "b1", "w2", "b2")


def _f(t, y, q):
    return torch.tanh((y ** 3) @ q[0] + q[1]) @ q[2] + q[3]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=256)
    args = ap.parse_args(argv)
    Bn = args.batch
    rng = np.random.RandomState(0)
    params = [rng.randn(D, H) * 0.1, np.zeros(H), rng.randn(H, D) * 0.1,
              np.zeros(D)]
    y0 = np.random.RandomState(1).randn(Bn, D) * 1.5
    target = np.random.RandomState(2).randn(T_OUT, Bn, D) * 0.5
    f64 = torch.float64
    t = torch.linspace(0.0, SPAN, T_OUT, dtype=f64)

    t0 = time.perf_counter()
    w1 = torch.tensor(params[0], dtype=f64, requires_grad=True)
    w2 = torch.tensor(params[2], dtype=f64, requires_grad=True)
    gw1, gw2 = torch.zeros_like(w1), torch.zeros_like(w2)
    tb1, tb2 = [], []
    for c in range(0, Bn, args.chunk):
        n = min(args.chunk, Bn - c)
        b1 = torch.zeros(n, H, dtype=f64, requires_grad=True)
        b2 = torch.zeros(n, D, dtype=f64, requires_grad=True)
        q = (w1, b1, w2, b2)
        ys = P.odeint(lambda tt, yy: _f(tt, yy, q),
                      torch.tensor(y0[c:c + n], dtype=f64), t, rtol=1e-10,
                      atol=1e-10)
        tg = torch.tensor(target[:, c:c + n], dtype=f64)
        loss = torch.sum((ys - tg) ** 2) / (T_OUT * Bn * D)
        g = torch.autograd.grad(loss, q)
        gw1 += g[0]
        gw2 += g[2]
        tb1.append(g[1])
        tb2.append(g[3])
    tb1, tb2 = torch.cat(tb1), torch.cat(tb2)
    direct = [gw1, tb1.sum(0), gw2, tb2.sum(0)]
    print(f"direct gradient (rtol = atol = 1e-10, float64, B = {Bn}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, terms in (("b1", tb1), ("b2", tb2)):
        total, mag = terms.sum(0).abs(), terms.abs().sum(0)
        i = int(total.argmax())
        print(f"{name}: largest |gradient| {float(total[i]):.4e}, the sum of "
              f"its {Bn} terms' magnitudes {float(mag[i]):.4e}, ratio "
              f"{float(total[i] / mag[i]):.3e}", flush=True)
    for dtype, tol in ((f64, 1e-6), (torch.float32, 1e-6), (f64, 1e-8)):
        got = {}
        for mode in ("resets", "interpolated"):
            q = tuple(torch.tensor(p, dtype=dtype, requires_grad=True)
                      for p in params)
            ys = P.odeint_adjoint(_f, torch.tensor(y0, dtype=dtype),
                                  t.to(dtype), params=q, rtol=tol, atol=tol,
                                  adjoint_mode=mode, options={"fuse": True})
            loss = torch.mean((ys - torch.tensor(target, dtype=dtype)) ** 2)
            got[mode] = torch.autograd.grad(loss, q)
            gaps = [float((a.double() - b).abs().max() / b.abs().max())
                    for a, b in zip(got[mode], direct)]
            print(f"{str(dtype)[6:]} rtol {tol:g} {mode}: against the direct "
                  f"gradient " + ", ".join(
                      f"{n} {x:.3e}" for n, x in zip(NAMES, gaps)),
                  flush=True)
        gaps = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got["interpolated"], got["resets"])]
        print(f"{str(dtype)[6:]} rtol {tol:g} interpolated against resets: "
              + ", ".join(f"{n} {x:.3e}" for n, x in zip(NAMES, gaps)),
              flush=True)


if __name__ == "__main__":
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    main()
