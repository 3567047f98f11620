#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`tfdiffeq_tpu_torch`) on one NVIDIA
card, at the benchmark's main path.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Refuse to run without a card; print the card's name and power limit.
2. Build the CUDA kernels from csrc/ with nvcc; print the build time and
   the -Xptxas -v register and spill report.
3. K1 `dopri5_mlp_step` against its plain PyTorch version at B=4096, D=2,
   H=50, in float32 and float64.
4. K2 `mlp_solve` against its plain version at the bench protocol (dopri5,
   y [4096, 2], hidden 50, 64 outputs over [0, 25], rtol = atol = 1e-6,
   first step 0.01), in float32 and float64, and run to run bitwise.
5. The slice through the public entry points at the bench protocol:
   `fast.solve_mlp` (K2), `fast.solve_mlp_stepwise` (K1) and the generic
   `solve` on an `ODEFunc` with the same weights. Launch counters are
   zeroed just before and read just after; each kernel must have run.
   Outputs must be finite, of shape [64, 4096, 2], with status 0; on a
   small input (B=96, 12 outputs over [0, 5]) the three agree.
6. Time each kernel and its plain version with CUDA events (median of 5
   after a warm-up) and print them beside the card's name and power limit.

The last two lines of standard output are one JSON object with each
kernel's record and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np

B, H, D, T_OUT, SPAN, TOL, FIRST_STEP = 4096, 50, 2, 64, 25.0, 1e-6, 0.01


def _bench_params(B, dtype, device):
    """bench.py:32-39 and :268-270: seed-0 weights, zero biases, seed-1
    states."""
    import torch
    rng = np.random.RandomState(0)
    p = {"w1": rng.randn(D, H) * 0.1, "b1": np.zeros(H),
         "w2": rng.randn(H, D) * 0.1, "b2": np.zeros(D)}
    y0 = np.random.RandomState(1).randn(B, D) * 1.5
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return {k: as_t(v) for k, v in p.items()}, as_t(y0), p


def _timed(fn, reps=5, inner=1):
    """Median milliseconds per call of fn over `reps` CUDA-event windows of
    `inner` calls each, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tfdiffeq_tpu_torch import convert, fast, solve
    from tfdiffeq_tpu_torch.ops import _build, cuda_kernels as ck

    # [2] build.
    _build.library()
    print(f"[2] nvcc build: {_build.build_seconds():.2f} s, library "
          f"{_build.source_hash()}", flush=True)
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64

    # [3] K1 against its plain version (dt 0.3: a typical main-path step).
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    k1_err = {}
    for dtype, tol in ((f32, 1e-5), (f64, 1e-12)):
        p, y, _ = _bench_params(B, dtype, dev)
        f0 = fast.mlp_apply(spec, [(p["w1"], p["b1"]), (p["w2"], p["b2"])],
                            y)
        got = ck.dopri5_mlp_step(p, y, f0, 0.3, TOL, TOL)
        ref = ck.dopri5_mlp_step_plain(p, y, f0, 0.3, TOL, TOL)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        rel = abs(float(got[2]) / float(ref[2]) - 1.0)
        print(f"[3] K1 {dtype}: max |kernel - plain| y1 {errs[0]:.3e} f1 "
              f"{errs[1]:.3e} y_mid {errs[3]:.3e}; ratio {float(got[2]):.9e}"
              f" vs {float(ref[2]):.9e} (rel {rel:.3e}); tolerance {tol}",
              flush=True)
        if max(errs[0], errs[1], errs[3]) > tol or rel > tol:
            raise AssertionError(f"K1 {dtype} disagrees with its plain "
                                 "version")
        k1_err[dtype] = max(errs)

    # [4] K2 against its plain version at the bench protocol.
    k2_err, k2_args = {}, {}
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
        warr, dims = ck.pack_mlp_weights(W, dtype, dev)
        f0 = fast.mlp_apply(spec, W, y)
        t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
        args = (warr, dims, y, t, FIRST_STEP, TOL, TOL, 1.0)
        kw = dict(f0=f0, activation="tanh", input_power=3)
        k2_args[dtype] = (args, kw)
        out, st = ck.mlp_solve(*args, **kw)
        again, st2 = ck.mlp_solve(*args, **kw)
        ref, st_ref = ck.mlp_solve_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bitwise = bool(torch.equal(out, again) and torch.equal(st, st2))
        print(f"[4] K2 {dtype}: kernel stats {st.tolist()}, plain "
              f"{st_ref.tolist()}; max |kernel - plain| {err:.3e}; two "
              f"kernel runs bitwise equal: {bitwise}", flush=True)
        if not bitwise:
            raise AssertionError("K2 is not deterministic from run to run")
        if st[3].item() != 0 or not torch.isfinite(out).all():
            raise AssertionError(f"K2 {dtype} failed: stats {st.tolist()}")
        if dtype == f64:
            if st.tolist() != st_ref.tolist() or err > 1e-9:
                raise AssertionError("K2 float64 differs from its plain "
                                     "version (needs identical stats, ys "
                                     "within 1e-9)")
        else:
            torch.testing.assert_close(out, ref, rtol=1e-3, atol=2e-4)
        k2_err[dtype] = err

    # [5] the slice through the public entry points.
    p, y, p_np = _bench_params(B, f32, dev)
    t = torch.linspace(0.0, SPAN, T_OUT)
    flax_like = {"params": {
        "Dense_0": {"kernel": p_np["w1"], "bias": p_np["b1"]},
        "Dense_1": {"kernel": p_np["w2"], "bias": p_np["b2"]}}}
    func = convert.ode_func_from_flax(flax_like, device=dev, dtype=f32)
    ck.reset_launch_counts()
    whole = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL,
                           first_step=FIRST_STEP)
    step = fast.solve_mlp_stepwise(p, y, t, rtol=TOL, atol=TOL,
                                   first_step=FIRST_STEP)
    with torch.no_grad():
        generic = solve(func, y, t, rtol=TOL, atol=TOL,
                        options={"first_step": FIRST_STEP})
    torch.cuda.synchronize()
    launches = {"dopri5_mlp_step": ck.dopri5_mlp_step_launches,
                "mlp_solve": ck.mlp_solve_launches}
    for name, res in (("fast.solve_mlp", whole),
                      ("fast.solve_mlp_stepwise", step),
                      ("solve(ODEFunc)", generic)):
        nfe, acc, rej, status = res.stats
        print(f"[5] {name}: nfe {nfe}, accepted {acc}, rejected {rej}, "
              f"status {status}", flush=True)
        if status != 0 or tuple(res.ys.shape) != (T_OUT, B, D) \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"{name} failed at the bench protocol")
    print(f"[5] launches in the slice: {launches}", flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if launches["dopri5_mlp_step"] != step.stats.n_accepted + \
            step.stats.n_rejected:
        raise AssertionError("K1 launches differ from the stepwise attempts")
    gap = float((step.ys - whole.ys).abs().max())
    print(f"[5] max |stepwise - whole| at full size {gap:.3e}; "
          f"max |generic - whole| "
          f"{float((generic.ys - whole.ys).abs().max()):.3e}", flush=True)
    # Agreement on a small input, at the reference's float32 budget.
    ps, ys, _ = _bench_params(96, f32, dev)
    ts = torch.linspace(0.0, 5.0, 12)
    small = [fast.solve_mlp(ps, ys, ts, rtol=TOL, atol=TOL).ys,
             fast.solve_mlp_stepwise(ps, ys, ts, rtol=TOL, atol=TOL).ys]
    with torch.no_grad():
        small.append(solve(func, ys, ts, rtol=TOL, atol=TOL).ys)
    for other in small[1:]:
        torch.testing.assert_close(other, small[0], rtol=1e-3, atol=2e-4)
    print("[5] B=96: whole, stepwise and generic agree within rtol 1e-3 / "
          "atol 2e-4", flush=True)

    # [6] timings (these launches are not counted above).
    p, y, _ = _bench_params(B, f32, dev)
    f0 = fast.mlp_apply(spec, [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y)
    step_ms = _timed(lambda: ck.dopri5_mlp_step(p, y, f0, 0.3, TOL, TOL),
                     inner=20)
    step_plain_ms = _timed(
        lambda: ck.dopri5_mlp_step_plain(p, y, f0, 0.3, TOL, TOL), inner=5)
    args, kw = k2_args[f32]
    solve_ms = _timed(lambda: ck.mlp_solve(*args, **kw))
    solve_plain_ms = _timed(lambda: ck.mlp_solve_plain(*args, **kw))
    print(f"[6] {smi}: K1 dopri5_mlp_step {step_ms:.4f} ms/call vs plain "
          f"{step_plain_ms:.4f} ms (B=4096, float32)", flush=True)
    print(f"[6] {smi}: K2 mlp_solve {solve_ms:.3f} ms/solve vs plain "
          f"{solve_plain_ms:.3f} ms (bench protocol, float32, "
          f"{whole.stats.n_accepted + whole.stats.n_rejected} attempts)",
          flush=True)

    kernels = [
        {"name": "dopri5_mlp_step", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/step_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:614",
         "launches": launches["dopri5_mlp_step"],
         "max_abs_err": k1_err[f32], "ms": step_ms,
         "plain_ms": step_plain_ms},
        {"name": "mlp_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/solve_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:726",
         "launches": launches["mlp_solve"],
         "max_abs_err": k2_err[f32], "ms": solve_ms,
         "plain_ms": solve_plain_ms},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
