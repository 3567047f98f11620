#!/usr/bin/env python3
"""Time the port's adaptive (K2), fixed-grid (K8) and per-sample (K5) solve
kernels, their adjoint sweeps (K3, K9, K6), the Adams kernels (K10, K11)
at the bench protocol and the conv-ODE solve (K13), for two or more
checkouts of the repository on one NVIDIA card, in alternating order.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [ROUNDS] [plans | cnf | hyper
                                                       | dense]

Each checkout builds its own kernels first (all together), then every
round runs one process a checkout, in the order A B B A A B ... (ROUNDS
pairs, 3 by default; with `plans` the plan rows alone, with `cnf` the K2
and K3 rows and the K7, K1 and CNF rows below, with `hyper` the K12 and
explicit_adams rows below), each timing with
CUDA events (median of 7 after a
warm-up): the MLP routes of K2 (dopri5, bench spiral y [4096, 2], hidden
50, 64 outputs over [0, 25], rtol = atol = 1e-6, first step 0.01), K8
(rk4 x 500) and K5 (every sample's first step 0.01), the MLP routes of
K3, K9 (8 rk4 steps an interval) and K6 on K2's trajectory with the
bench training protocol's MSE cotangent (median of 3), the MLP routes of
K10 (fixed_adams and explicit_adams x 512, bench.py:205) and K11 (VCABM,
first step 0.01; median of 3), K4 alone (`tier_net`: the bf16 weight pack
and one evaluation of the wide net 128 -> 256 -> 256 -> 128 at B = 1024,
'mixed' and 'bf16'; ten calls queued behind a sleep on the card, so the
device time alone), K8 rk4 x 128 and K2 dopri5 at 'mixed' on that net
(the batch route), K8 rk4 x 128 at 'highest' (the wide route), K5, K3 and
K9 on the wide route at B = 256, K7's adjoint
sweep in K3 (the CNF flow 3 -> 32 -> 32 -> 2 at B = 4096), K13 at the
ODE-Net's width (C = 64, 32 groups, 7x7, controller blocks of 18, t = [0,
1], rtol = atol = 1e-3, each block's first step 0.05; weights and states
from numpy seeds) at B = 128 and 256 (median of 3), and, where the checkout
has the plan routes (`ops/cuda_plan.py`), the same spiral written as
plain PyTorch in each host (K15 in K3 among them) and the
stiffness battery per sample (K15 in K6 on its own K5 trajectory, the
cotangent of sum(ys ** 2), first backward step 0.01). Then K7's forward in
K2 on that flow and trajectory, K1 (one dopri5 step of the bench spiral at
B = 4096, dt 0.3: the kernel alone, events around its launch behind a
queued sleep; and a wrapper call, ten queued behind a sleep, its device
work with the partials' sum),
`fast.solve_mlp_stepwise` at the bench protocol, and on chip_smoke.py
[22]'s flow (`CNFDynamics(2, 32, 3)` from seed 0, 4096 two-moons points,
rtol 1e-5, atol 1e-7) a `fast.cnf_log_prob_train` step with its backward
(two chunks of 2048), an `examples/cnf.py --fused` Adam step at its
defaults (B = 512, hidden 64) and `fast.cnf_sample_fused` of 1000 points
(median of 3 each, CUDA events around the host's call). Then K12 (the
hypersolvers, `plan_solve_hyper`) on examples/hypersolver.py's dynamics
and hypernet at B = 4096 on its 33-point output grid: the kernel alone for
the three kinds and for euler at B = 256, and a wrapper call's device
work (ten calls queued behind a sleep); and a wrapper call's device work
of explicit_adams' K10 x 512 at the bench widths, B = 4096. With `dense`
the K2 rows alone: its MLP route, its plan route (the spiral as plain
PyTorch) without and, where the checkout has it, with the dense-output
emission (`emit_dense`, 1024 rows, the step budget too), and two training
steps of the bench protocol through `odeint_adjoint(options={'fuse':
True})`, the resets mode (K2 + K3) and, where the checkout has it,
`adjoint_mode='interpolated'` (K2 with the emission, the generic backward)
(median of 3, CUDA events around the host's call). It prints the card's
name and power limit, a line a run and the median of each kernel a
checkout.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import numpy as np


def _kernel_ms(lib, name: str, call, reps: int = 7) -> float:
    """Median device ms of the launch of lib.<name> inside call(): CUDA
    events right before and after the ctypes call, behind a sleep queued
    first, so that the window holds the kernel alone and none of the
    wrapper's host or device work."""
    import torch
    fn0, marks = getattr(lib, name), []

    def timed(*a):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(20_000_000)
        s.record()
        r = fn0(*a)
        e.record()
        marks.append((s, e))
        return r

    setattr(lib, name, timed)
    try:
        for _ in range(reps + 1):
            call()
    finally:
        setattr(lib, name, fn0)
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks[1:])


def _cnf_rows(out: dict, timed, device_timed, dev) -> None:
    """K1, the stepwise solve and chip_smoke.py [22]-[24]'s CNF steps."""
    import torch
    from tfdiffeq_tpu_torch import fast
    from tfdiffeq_tpu_torch.examples import cnf as cnf_example
    from tfdiffeq_tpu_torch.models import cnf as mcnf
    from tfdiffeq_tpu_torch.ops import _build, cuda_kernels as ck
    rng = np.random.RandomState(0)
    c = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    p = {"w1": c(rng.randn(2, 50) * 0.1), "b1": c(np.zeros(50)),
         "w2": c(rng.randn(50, 2) * 0.1), "b2": c(np.zeros(2))}
    y = c(np.random.RandomState(1).randn(4096, 2) * 1.5)
    f0 = fast.mlp_apply(fast.MLPSpec(activation="tanh", input_power=3),
                        [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y)
    out["K1"] = _kernel_ms(_build.library(), "tfd_dopri5_mlp_step_f32",
                           lambda: ck.dopri5_mlp_step(p, y, f0, 0.3, 1e-6,
                                                      1e-6))
    out["K1 call"] = device_timed(lambda: ck.dopri5_mlp_step(
        p, y, f0, 0.3, 1e-6, 1e-6))
    t = torch.linspace(0.0, 25.0, 64)
    out["stepwise"] = timed(lambda: fast.solve_mlp_stepwise(
        p, y, t, rtol=1e-6, atol=1e-6, first_step=0.01), reps=3)
    flow = mcnf.CNFDynamics(2, 32, 3, device=dev,
                            generator=torch.Generator().manual_seed(0))
    x = c(cnf_example.two_moons(4096, np.random.RandomState(0)))
    W = [(w.detach(), b.detach()) for w, b in fast.weights_from_linears(flow)]
    Wg = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for w, b in W]

    def train_step():
        loss = -torch.mean(fast.cnf_log_prob_train(Wg, x, rtol=1e-5,
                                                   atol=1e-7))
        loss.backward()

    out["CNF train step"] = timed(train_step, reps=3)
    eargs = cnf_example.parse_args(["--fused", "--device", "cuda"])
    erng = np.random.RandomState(eargs.seed)
    eflow = mcnf.CNFDynamics(2, eargs.hidden, device=dev,
                             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(eflow.parameters(), lr=eargs.lr)
    nll = cnf_example.make_nll(eargs, eflow)
    xb = c(cnf_example.two_moons(eargs.batch_size, erng))

    def adam_step():
        opt.zero_grad(set_to_none=True)
        nll(xb).backward()
        opt.step()

    out["CNF example step"] = timed(adam_step, reps=3)
    ew = [(m.weight.detach().t().contiguous(), m.bias.detach())
          for m in eflow.layers]
    out["cnf_sample_fused"] = timed(lambda: fast.cnf_sample_fused(
        ew, torch.Generator(device=dev).manual_seed(1), 1000, 2,
        rtol=eargs.rtol, atol=eargs.atol), reps=3)


def _hyper_rows(out: dict, device_timed, dev) -> None:
    """K12 alone and a wrapper call's device work; explicit_adams' K10 a
    wrapper call's device work."""
    import torch
    from tfdiffeq_tpu_torch import fast
    from tfdiffeq_tpu_torch.examples import hypersolver as hx
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, \
        cuda_kernels as ck, cuda_plan as cpl, plan_bridge as pb
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    f32 = torch.float32
    params = {k: v.detach() for k, v in hx.init_hypernet(
        torch.Generator().manual_seed(0), 32, dev, f32).items()}
    f, g = hx.dynamics(dev, f32), hx.hypernet(params)
    y0 = hx.disk(np.random.RandomState(1), 4096, 1.0, dev, f32)
    t0 = torch.tensor(0.0, device=dev)
    pf, cf = pb.build_plan(f, t0, y0)
    pg, cg = pb.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t0,
                           torch.cat([y0, f(t0, y0)], 1), out_dim=2)
    kf, kg = (pb.pack_consts(pf, cf, f32, dev),
              pb.pack_consts(pg, cg, f32, dev))
    lib = cpl.build([((pf, pg), "hyper")])[0]
    t = torch.linspace(0.0, 2.0, 33)
    for B, kinds in ((4096, ("euler", "midpoint", "heun")), (256, ("euler",))):
        y = y0[:B].contiguous()
        for kind in kinds:
            key = f"K12 {kind}" + ("" if B == 4096 else f" B{B}")
            out[key] = _kernel_ms(lib, "tfd_plan_hyper_f32", lambda: (
                cpl.plan_solve_hyper(pf, pg, kf, kg, y, t, t, 1.0, kind=kind,
                                     grid_is_t=True)))
    out["K12 call"] = device_timed(lambda: cpl.plan_solve_hyper(
        pf, pg, kf, kg, y0, t, t, 1.0, kind="euler", grid_is_t=True))
    rng = np.random.RandomState(0)
    c = lambda a: torch.tensor(a, dtype=f32, device=dev)
    W = [(c(rng.randn(2, 50) * 0.1), c(np.zeros(50))),
         (c(rng.randn(50, 2) * 0.1), c(np.zeros(2)))]
    y = c(np.random.RandomState(1).randn(4096, 2) * 1.5)
    warr, dims = ck.pack_mlp_weights(W, f32, dev)
    f0 = fast.mlp_apply(fast.MLPSpec(activation="tanh", input_power=3), W, y)
    ts = torch.linspace(0.0, 25.0, 64)
    grid512 = uniform_grid(ts[0], ts[-1], 512)
    out["K10 explicit call"] = device_timed(lambda: cad.mlp_solve_adams(
        warr, dims, y, ts, grid512, 1e-6, 1e-6, 1.0, f0=f0,
        activation="tanh", input_power=3, implicit=False), reps=3, inner=5)


def _dense_rows(out: dict, timed, dev, p, y, t) -> None:
    """K2's plan route with and without the dense-output emission and the
    two fused training steps (module docstring, `dense`)."""
    import inspect
    import torch
    from tfdiffeq_tpu_torch import fast, odeint_adjoint
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb

    def f3(tt, yy, q):
        return torch.tanh((yy ** 3) @ q[0] + q[1]) @ q[2] + q[3]

    q = tuple(p[k] for k in ("w1", "b1", "w2", "b2"))
    plan, consts = pb.build_plan(lambda tt, yy: f3(tt, yy, q), t[0].to(dev),
                                 y)
    packed = pb.pack_consts(plan, consts, torch.float32, dev)
    g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, device=dev))
    pf0 = g(t[0].to(dev), y).contiguous()
    cpl.build([(plan, "solve")])
    out["K14 in K2"] = timed(lambda: cpl.plan_solve(
        plan, packed, y, t, 0.01, 1e-6, 1e-6, 1.0, pf0))
    dense = "emit_dense" in inspect.signature(cpl.plan_solve).parameters
    if dense:
        out["K14 in K2 dense"] = timed(lambda: cpl.plan_solve(
            plan, packed, y, t, 0.01, 1e-6, 1e-6, 1.0, pf0, max_steps=1024,
            emit_dense=1024))
    target = torch.tensor(np.random.RandomState(2).randn(64, 4096, 2) * 0.5,
                          dtype=torch.float32, device=dev)

    def step(mode):
        qq = tuple(x.clone().requires_grad_() for x in q)
        kw = {"adjoint_mode": mode} if mode != "resets" else {}
        ys = odeint_adjoint(f3, y, t, params=qq, rtol=1e-6, atol=1e-6,
                            options={"fuse": True}, **kw)
        torch.autograd.grad(torch.mean((ys - target) ** 2), qq)

    out["resets step"] = timed(lambda: step("resets"), reps=3)
    if dense:
        out["interpolated step"] = timed(lambda: step("interpolated"),
                                         reps=3)
    assert fast.fuse_fallbacks == 0


def _one(root: str, only: str = "") -> None:
    """Time the kernels of the checkout at `root` (with `only` = "plans"
    the plan rows alone, "cnf" the K2, K3, K7, K1 and CNF rows, "hyper"
    the K12 and explicit_adams rows); print one line."""
    # `hyper` (the K12 and explicit_adams rows alone) skips both.
    plans_only = only in ("plans", "hyper")
    cnf_only = only in ("cnf", "hyper")
    sys.path.insert(0, root)
    import torch
    from tfdiffeq_tpu_torch import fast
    from tfdiffeq_tpu_torch.ops import _build, cuda_fixed as cf, \
        cuda_kernels as ck, cuda_perlane as cp
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    _build.library()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    c = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    p = {"w1": c(rng.randn(2, 50) * 0.1), "b1": c(np.zeros(50)),
         "w2": c(rng.randn(50, 2) * 0.1), "b2": c(np.zeros(2))}
    y = c(np.random.RandomState(1).randn(4096, 2) * 1.5)
    t = torch.linspace(0.0, 25.0, 64)
    grid = torch.linspace(0.0, 25.0, 501)
    dt0 = torch.full((4096,), 0.01, device=dev)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    warr, dims = ck.pack_mlp_weights(W, torch.float32, dev)
    f0 = fast.mlp_apply(fast.MLPSpec(activation="tanh", input_power=3), W, y)
    kw = dict(f0=f0, activation="tanh", input_power=3)

    def timed(fn, reps=7):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def device_timed(fn, reps=7, inner=10):
        # Calls queued behind a sleep on the card: the device time alone.
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            torch.cuda._sleep(20_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / inner)
        return statistics.median(ts)

    out = {}
    if not plans_only:
        out["K2"] = timed(lambda: ck.mlp_solve(warr, dims, y, t, 0.01, 1e-6,
                                               1e-6, 1.0, **kw))
    if only == "dense":
        _dense_rows(out, timed, dev, p, y, t)
        print("RESULT " + " ".join(f"{k.replace(' ', '_')}={v:.3f}"
                                   for k, v in out.items()), flush=True)
        return
    if not (plans_only or cnf_only):
        out["K8"] = timed(lambda: cf.mlp_solve_fixed(warr, dims, y, t, grid,
                                                     1.0, **kw))
        out["K5"] = timed(lambda: cp.mlp_solve_perlane(
            warr, dims, y, t, dt0, 1e-6, 1e-6, 1.0, **kw))
    from tfdiffeq_tpu_torch.ops import cuda_adjoint as ca
    ys, _ = ck.mlp_solve(warr, dims, y, t, 0.01, 1e-6, 1e-6, 1.0, **kw)
    target = c(np.random.RandomState(2).randn(64, 4096, 2) * 0.5)
    ct = (2.0 * (ys - target) / target.numel()).contiguous()
    ys = ys.contiguous()
    dt_b = 0.1 * abs(float(t[-1] - t[-2]))
    akw = dict(activation="tanh", input_power=3)
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad
    grid512 = uniform_grid(t[0], t[-1], 512)
    if not plans_only:
        out["K3"] = timed(lambda: ca.mlp_adjoint_solve(
            warr, dims, ys, ct, t, dt_b, 1e-6, 1e-6, 1.0, **akw), reps=3)
    if not (plans_only or cnf_only):
        out["K9"] = timed(lambda: cf.mlp_adjoint_solve_fixed(
            warr, dims, ys, ct, t, 1.0, num_steps=8, method="rk4", **akw),
            reps=3)
        out["K6"] = timed(lambda: cp.mlp_perlane_adjoint_solve(
            warr, dims, ys, ct, t, dt_b, 1e-6, 1e-6, 1.0, **akw), reps=3)
        for key, implicit in (("K10 fixed_adams", True),
                              ("K10 explicit_adams", False)):
            out[key] = timed(lambda: cad.mlp_solve_adams(
                warr, dims, y, t, grid512, 1e-6, 1e-6, 1.0, implicit=implicit,
                **kw), reps=3)
        out["K11"] = timed(lambda: cad.mlp_solve_vcabm(
            warr, dims, y, t, 0.01, 1e-6, 1e-6, 1.0, **kw), reps=3)
        # The wide net 128 -> 256 -> 256 -> 128 at B = 1024: K4 alone (the bf16
        # weight pack and one evaluation) at 'mixed' and 'bf16', K8 rk4 x 128
        # and K2 dopri5 at 'mixed' (the batch route), K8 at 'highest' (the
        # wide route); K5, K3 and K9 on the wide route at B = 256.
        rw = np.random.RandomState(1)
        wd = ((128, 256), (256, 256), (256, 128))
        WW = [(c(rw.randn(i, o) / np.sqrt(i)), c(rw.randn(o) * 0.05))
              for i, o in wd]
        xw = c(rw.randn(1024, 128) * 0.5)
        wwarr, wpd = ck.pack_mlp_weights(WW, torch.float32, dev)
        tiers = {tier: ck.layer_tiers(wpd, "auto", tier)
                 for tier in ("mixed", "bf16")}
        for tier, tt in tiers.items():
            out[f"K4 {tier}"] = device_timed(lambda: ck.tier_net(
                wwarr, wpd, xw, tiers=tt))
        wspec = fast.MLPSpec(activation="tanh")
        wf0 = fast.mlp_apply(wspec, WW, xw)
        tw = torch.linspace(0.0, 1.0, 8)
        out["K8 wide mixed"] = timed(lambda: cf.mlp_solve_fixed(
            wwarr, wpd, xw, tw, uniform_grid(tw[0], tw[-1], 128), 1.0, f0=wf0,
            method="rk4", tiers=tiers["mixed"]), reps=3)
        out["K2 wide mixed"] = timed(lambda: ck.mlp_solve(
            wwarr, wpd, xw, tw, 0.01, 1e-5, 1e-5, 1.0, f0=wf0,
            tiers=tiers["mixed"]), reps=3)
        out["K8 wide highest"] = timed(lambda: cf.mlp_solve_fixed(
            wwarr, wpd, xw, tw, uniform_grid(tw[0], tw[-1], 128), 1.0, f0=wf0,
            method="rk4"), reps=3)
        xs = xw[:256].contiguous()
        out["K5 wide"] = timed(lambda: cp.mlp_solve_perlane(
            wwarr, wpd, xs, tw[:4], 0.05, 1e-5, 1e-5, 1.0,
            f0=wf0[:256].contiguous()), reps=3)
        wys, _ = ck.mlp_solve(wwarr, wpd, xs, tw[:4], 0.01, 1e-5, 1e-5, 1.0,
                              f0=wf0[:256].contiguous())
        wg = c(rw.randn(*wys.shape) * 0.01)
        out["K3 wide"] = timed(lambda: ca.mlp_adjoint_solve(
            wwarr, wpd, wys.contiguous(), wg, tw[:4], 0.05, 1e-5, 1e-5, 1.0),
            reps=3)
        out["K9 wide"] = timed(lambda: cf.mlp_adjoint_solve_fixed(
            wwarr, wpd, wys.contiguous(), wg, tw[:4], 1.0, num_steps=2),
            reps=3)
        # K13 at the ODE-Net's width: the conv-ODE block's parameters (HWIO
        # kernels with lecun-normal variance, perturbed GroupNorm affines).
        from tfdiffeq_tpu_torch.ops import conv_ode as co, cuda_conv as cc
        rn = np.random.RandomState(11)
        C = 64
        params = {"gn": [(1.0 + 0.1 * rn.randn(C), 0.1 * rn.randn(C))
                         for _ in range(3)],
                  "conv": [(rn.randn(3, 3, C + 1, C) / np.sqrt(9 * (C + 1)),
                            0.1 * rn.randn(C)) for _ in range(2)]}
        spec = co.ConvODESpec(channels=C, groups=32)
        wpack = cc.pack_conv_ode_weights(params, spec, torch.float32, dev)
        xo = c(rn.randn(256, C, 7, 7) * 0.5)
        tau = torch.tensor([0.0, 1.0])
        for Bc in (128, 256):
            x = xo[:Bc].contiguous()
            cf0 = co.conv_ode_apply(params, tau[0].to(dev), x,
                                    spec).contiguous()
            cdt = torch.full((-(-Bc // 18),), 0.05, device=dev)
            out[f"K13 B{Bc}"] = timed(lambda: cc.conv_solve(
                wpack, spec, x, tau, cdt, 1e-3, 1e-3, 1.0, f0=cf0,
                block_size=18), reps=3)
    if not plans_only:
        # K7's forward in K2 and its adjoint in K3: the CNF flow 3 -> 32 ->
        # 32 -> 2 at B = 4096, t = 1 -> 0, the adjoint on its own forward
        # trajectory with the density loss's cotangent.
        rc = np.random.RandomState(3)
        CW = [(c(rc.randn(i, o) * 0.6 / np.sqrt(i)), c(rc.randn(o) * 0.1))
              for i, o in ((3, 32), (32, 32), (32, 2))]
        cpk, cpd = ck.pack_mlp_weights(CW, torch.float32, dev)
        s0 = torch.cat([c(rc.randn(4096, 2)),
                        torch.zeros(4096, 1, device=dev)], dim=1)
        tau = torch.tensor([-1.0, 0.0])
        cf0 = -ck._cnf_net_plain(cpk, cpd, "tanh")(
            torch.tensor(1.0, device=dev), s0)
        ckw = dict(f0=cf0.contiguous(), activation="tanh", time_input=True,
                   rhs="cnf")
        cys, _ = ck.mlp_solve(cpk, cpd, s0, tau, 0.1, 1e-5, 1e-7, -1.0, **ckw)
        out["K7 in K2"] = timed(lambda: ck.mlp_solve(
            cpk, cpd, s0, tau, 0.1, 1e-5, 1e-7, -1.0, **ckw))
        cg = torch.zeros_like(cys)
        cg[-1, :, :2] = cys[-1, :, :2] / 4096
        cg[-1, :, 2] = 1.0 / 4096
        out["K7 in K3"] = timed(lambda: ca.mlp_adjoint_solve(
            cpk, cpd, cys.contiguous(), cg, tau, 0.1, 1e-5, 1e-7, -1.0,
            activation="tanh", rhs="cnf"), reps=3)
        _cnf_rows(out, timed, device_timed, dev)
    plan_mod = os.path.join(root, "tfdiffeq_tpu_torch", "ops", "cuda_plan.py")
    if os.path.exists(plan_mod) and not cnf_only:
        from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, \
            plan_bridge as pb

        def f(tt, yy):
            return torch.tanh((yy ** 3) @ p["w1"] + p["b1"]) @ p["w2"] \
                + p["b2"]

        plan, consts = pb.build_plan(f, t[0].to(dev), y)
        packed = pb.pack_consts(plan, consts, torch.float32, dev)
        g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, device=dev))
        pf0 = g(t[0].to(dev), y).contiguous()
        cpl.build([(plan, "solve"), (plan, "fixed"), (plan, "perlane")])
        out["K14 in K2"] = timed(lambda: cpl.plan_solve(
            plan, packed, y, t, 0.01, 1e-6, 1e-6, 1.0, pf0))
        out["K14 in K8"] = timed(lambda: cpl.plan_solve_fixed(
            plan, packed, y, t, grid, 1.0, pf0))
        out["K14 in K5"] = timed(lambda: cpl.plan_solve(
            plan, packed, y, t, dt0, 1e-6, 1e-6, 1.0, pf0, per_sample=True))
        if hasattr(cpl, "plan_adjoint_solve"):
            cpl.build([(plan, "adjoint"), (plan, "fixed_adjoint"),
                       (plan, "perlane_adjoint")])
            out["K15 in K3"] = timed(lambda: cpl.plan_adjoint_solve(
                plan, packed, ys, ct, t, dt_b, 1e-6, 1e-6, 1.0), reps=3)
            out["K15 in K9"] = timed(lambda: cpl.plan_adjoint_solve_fixed(
                plan, packed, ys, ct, t, 1.0, num_steps=8), reps=3)
            out["K15 in K6"] = timed(lambda: cpl.plan_perlane_adjoint_solve(
                plan, packed, ys, ct, t, dt_b, 1e-6, 1e-6, 1.0), reps=3)
            # The stiffness battery (bench.py:502-504: a per-sample scale
            # over the spiral's net, 5 outputs over [0, 2]) per sample: its
            # K5 forward, the cotangent of sum(ys ** 2), a K6 sweep.
            scb = c(np.logspace(0.0, 2.0, 4096))

            def fb(tt, yy):
                return scb[:, None] * (torch.tanh((yy ** 3) @ p["w1"]
                                                  + p["b1"]) @ p["w2"])

            bplan, bconsts = pb.build_plan(fb, t[0].to(dev), y)
            bpk = pb.pack_consts(bplan, bconsts, torch.float32, dev)
            t5 = torch.linspace(0.0, 2.0, 5)
            bf0 = cpl.plan_rhs(bplan, bpk, torch.tensor(1.0, device=dev))(
                t5[0].to(dev), y).contiguous()
            cpl.build([(bplan, "perlane"), (bplan, "perlane_adjoint")])
            bys = cpl.plan_solve(bplan, bpk, y, t5, dt0, 1e-6, 1e-6, 1.0,
                                 bf0, per_sample=True)[0].contiguous()
            bct = (2.0 * bys).contiguous()
            out["K15 in K6 battery"] = timed(
                lambda: cpl.plan_perlane_adjoint_solve(
                    bplan, bpk, bys, bct, t5, 0.01, 1e-6, 1e-6, 1.0), reps=3)
        if hasattr(cpl, "plan_solve_adams"):
            cpl.build([(plan, "adams"), (plan, "vcabm")])
            for key, implicit in (("K14 in K10 fixed_adams", True),
                                  ("K14 in K10 explicit_adams", False)):
                out[key] = timed(lambda: cpl.plan_solve_adams(
                    plan, packed, y, t, grid512, 1e-6, 1e-6, 1.0, pf0,
                    implicit=implicit), reps=3)
            out["K14 in K11"] = timed(lambda: cpl.plan_solve_vcabm(
                plan, packed, y, t, 0.01, 1e-6, 1e-6, 1.0, pf0), reps=3)
    if only in ("", "hyper"):
        _hyper_rows(out, device_timed, dev)
    print("RESULT " + " ".join(f"{k.replace(' ', '_')}={v:.3f}"
                               for k, v in out.items()), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        _one(os.path.abspath(sys.argv[2]), (sys.argv[3:] or [""])[0])
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = [os.path.abspath(d) for d in sys.argv[1:3]]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    only = sys.argv[4:5]
    me = os.path.abspath(__file__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]);"
                                " from tfdiffeq_tpu_torch.ops import _build;"
                                " _build.library()", d]) for d in dirs]
    if any(b.wait() for b in builds):
        return 1
    order = []
    for r in range(rounds):
        order += dirs if r % 2 == 0 else dirs[::-1]
    runs = {d: [] for d in dirs}
    for d in order:
        res = subprocess.run([sys.executable, me, "--one", d] + only,
                             capture_output=True, text=True)
        line = next((l for l in res.stdout.splitlines()
                     if l.startswith("RESULT ")), None)
        if res.returncode != 0 or line is None:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        vals = dict(kv.split("=") for kv in line.split()[1:])
        runs[d].append({k: float(v) for k, v in vals.items()})
        print(f"{d}: {line[7:]}", flush=True)
    for d in dirs:
        keys = runs[d][0].keys()
        med = {k: statistics.median(r[k] for r in runs[d]) for k in keys}
        print(f"median {d}: " + " ".join(f"{k}={v:.3f}"
                                         for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
