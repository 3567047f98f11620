#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`tfdiffeq_tpu_torch`) on one NVIDIA
card, at the benchmark's main path.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; nothing is caught):

1. Refuse to run without a card; print the card's name and power limit.
2. Build the CUDA kernels from csrc/ with nvcc; print the build time and
   the -Xptxas -v register and spill report.
3. K1 `dopri5_mlp_step` against its plain PyTorch version at B=4096, D=2,
   H=50 (and at B = 1, 33, 4097), in float32 and float64, bitwise; each
   prints its blocks and threads a sample.
4. K2 `mlp_solve` against its plain version at the bench protocol (dopri5,
   y [4096, 2], hidden 50, 64 outputs over [0, 25], rtol = atol = 1e-6,
   first step 0.01), in float32 and float64, and run to run bitwise.
5. The slice through the public entry points at the bench protocol:
   `fast.solve_mlp` (K2), `fast.solve_mlp_stepwise` (K1) and the generic
   `solve` on an `ODEFunc` with the same weights. Launch counters are
   zeroed just before and read just after; each kernel must have run.
   Outputs must be finite, of shape [64, 4096, 2], with status 0; on a
   small input (B=96, 12 outputs over [0, 5]) the three agree.
6. Time each kernel with CUDA events (median of 5 after a warm-up; K1's
   wrapper calls behind a queued sleep, their device work, with the
   kernel alone, events around its launch, beside it as `kernel_ms`) and
   its plain version by one synchronised call on the host clock (it is
   host-bound and takes seconds; so in every later phase), and print them
   beside the card's name and power limit. Each phase prints the second
   of the run at which it starts (`[clock]`).
7. K3 `mlp_adjoint_solve` against its plain version at the bench protocol,
   with the cotangent of bench.py's MSE training loss (bench.py:800-807):
   float64 (identical stats, gradients within 1e-9 relative) and float32
   (within 1e-3 relative; whether bitwise equal is printed), run to run
   bitwise; K3 and plain timed per sweep.
8. Three SGD steps (lr 1e-3) of the spiral at the bench protocol through
   `fast.odeint_adjoint_mlp` (bench.py:810-817). Counters zeroed before,
   read after: K2 and K3 must each have run 3 times; forward status 0,
   finite gradients (a failed backward sweep returns NaN gradients), the
   weights move. At B=96 the fused gradients agree with the port's
   generic `odeint_adjoint` within 1e-3 relative.
9. Three Adam steps (lr 0.01) of the latent ODE with `--fused` decoding at
   the example's defaults (1000 spirals, 100 of 500 samples, latent 4,
   hidden 20, rnn hidden 25, rtol 1e-4 / atol 1e-6), parameters drawn
   with numpy in the flax layout and carried over by `convert`. K2 = K3 = 3
   launches, finite losses and gradients.
10. K8 `mlp_solve_fixed` against its plain version at the bench widths (y
    [4096, 2], hidden 50, 64 outputs over [0, 25]): rk4 with num_steps=500
    (the Hermite drain) and on the default grid, each in float32 and
    float64; euler, midpoint and rk4_38 in float64 on the default grid.
    Bitwise equal to the plain version in both types, stats included, and
    run to run bitwise (K8 a group of 16 threads a sample, 128 blocks of
    16 warps; the layout printed, also in [11], [19]).
11. `fast.solve_mlp_spec(method='rk4', num_steps=500)` at the bench
    widths: one K8 launch (counter zeroed before, read after), status 0,
    finite [64, 4096, 2]; the gap to `fast.solve_mlp` (dopri5, K2) printed;
    at B=96 (12 outputs over [0, 5]) within 1e-5 relative of the generic
    `solve(ODEFunc, method='rk4', options={'num_steps': 500})`.
12. K9 `mlp_adjoint_solve_fixed` against its plain version at the bench
    training protocol with rk4: forward K8 with num_steps=500, backward
    8 steps an interval, the MSE cotangent: bitwise equal in float32 and
    float64 (stats included; K9 a group of 16 threads a sample, 128 blocks
    of 16 warps, printed), run to run bitwise. K8 and K9 are timed against
    their plain versions.
13. Three RMSprop steps of `examples/ode_demo.py --fused --method rk4` at
    its defaults: K8 = K9 = 3 launches, forward NFE 37 a step, finite
    losses, weights moved; at the first step the fused gradients agree with
    `--adjoint --method rk4` (the generic fixed-grid adjoint) within 1e-4
    relative. The training step is timed on the host clock.
14. K13 `conv_solve` at the ODE-Net's full width (C = 64, 7x7, 32 groups,
    dopri5, rtol = atol = 1e-3, t = [0, 1]) on the port's stem applied to
    `--synthetic_hard` images, at B = 128 and B = 256 (8 and 15 controller
    blocks of 18, each on several CTAs of a cooperative grid, the CTAs per
    controller block printed): against its plain version at the same grid
    in float32 and float64 (identical stats in every block, bitwise equal
    outputs), run to run bitwise; against the generic engine
    `solve(ODEConvFunc)` (cuDNN, TF32
    off) run block by block with the kernel's first steps, within the
    solve's tolerance. K13, its plain version and the generic engine are
    timed with CUDA events at B = 128.
15. The ODE-Net example (`examples/odenet_mnist.py --synthetic_hard
    --adjoint --fused`) at batch 128: three SGD steps (K13 forward, generic
    adjoint backward), then one `--fused_eval` batch of 256. Counters zeroed
    before, read after: K13 = 4 launches (one a step, one for the
    evaluation); finite losses, the weights move; no `solve_conv_ode` call
    of phases 14-15 fell back to the generic engine
    (`fast.conv_ode_fallbacks`); f-NFE and b-NFE printed;
    the step time is the median of the three on the host clock. A fourth
    step runs under torch.profiler: the kernels' device time, the device's
    idle share and the kernels that take the most time.
16. K5 `mlp_solve_perlane` at the bench protocol with every sample's own
    controller, from the per-sample HNW first steps
    (`select_initial_step_per_sample`): against its plain version in
    float64 and float32: bitwise equal, per-sample counts included (K5 a
    group of 16 threads a sample under its own controller, 128 blocks of
    16 warps; the layout printed), run to run bitwise.
    `fast.solve_mlp_spec(per_sample=True)`: one K5 launch
    and no K2 launch (counters zeroed before, read after), status 0, finite
    [64, 4096, 2]; the samples' nfe (min, median, max) beside the shared
    controller's (`fast.solve_mlp`, K2). At B=96 (12 outputs over [0, 5],
    float64) within 1e-5 relative of the generic `solve(ODEFunc,
    options={'per_sample': True})`, every sample's nfe within max(8, 15%)
    of its generic count. K5, its plain version and K2 timed.
17. K6 `mlp_perlane_adjoint_solve` (a group of 16 threads a sample, 32
    samples a block; the layout printed) at the bench training protocol
    with K5 as the forward and the MSE cotangent: bitwise equal to its
    plain version in float64 and float32, per-sample counts included, run
    to run bitwise; the samples' backward nfe. Three SGD steps through
    `fast.odeint_adjoint_mlp(per_sample=True)`: K5 = K6 = 3 launches,
    K2 = K3 = 0, forward status 0, finite gradients, the weights move. At
    B=96 (float64) the per-sample gradients agree with the shared-
    controller fused ones within 1e-4 relative. K6, its plain version and
    K3 timed.

18. The wide-MLP tier (bench.py:291-424): the 128 -> 256 -> 256 -> 128
    tanh net, seed-0 weights randn(din, dout) / sqrt(din), zero biases,
    seed-1 states randn(1024, 128) * 0.5, 8 outputs over [0, 2]. K2 at the
    bench tolerances (dopri5, rtol = atol = 1e-6, first step 0.01) against
    its plain version: 'highest' (the wide route) bitwise in float32 and
    float64 with identical stats; 'mixed' (the batch route, K4 on the
    tensor cores) in float64 bitwise, in float32 status 0, accepted and
    rejected counts within one and trajectories within 5e-5, and more than
    5e-5 from the plain 'highest' (a control); each tier timed with its
    NFE. 'highest' forced onto the batch route: bitwise the wide route's
    solve on the same grid (one block a 16-row tile on both routes, so
    each block owns the same samples and the error sums keep their order),
    and timed against the wide route at its own grid.
19. K8 at rk4 x 128 steps over [0, 2] on the same net, 'highest', 'bf16'
    and 'mixed': 'highest' bitwise, float32 'mixed' within 1e-5 of its
    plain version and 'bf16' within 2e-3 (SOLVE_BARS: it rounds every layer
    input to 8 bits, so a last-bit difference in a tensor-core sum can move
    a rounding by 2^-8), and past that bar from the plain 'highest' version
    ('mixed' also from the plain 'bf16'; controls); float64 tiers bitwise
    at 16 steps; 'highest' on
    the batch route bitwise and timed, as in [18]. The plain versions of
    phases 18-20 are timed (host clock) by the call that checks them, the
    kernels with CUDA events. Then the slice through `fast.solve_mlp_spec`:
    counters zeroed, dopri5 at 'highest' and 'mixed' and rk4 x 128 at all
    three tiers, counters read (K2 = 2, K8 = 3, K4 = 3 launches; a solve on
    the batch route is two launches, the bf16 weight pack and the solve,
    counted as one). K4 alone (`cuda_kernels.tier_net`, one evaluation of
    the net at B = 1024): each tier within EVAL_BARS of its plain version
    (largest and mean difference; 'highest' bitwise) and outside them
    against the other tiers' plain versions (controls), its error against
    a float64 product printed, and timed. K4's record: the 'mixed' call
    (the weight pack and the evaluation), against the plain net, its bound
    at the 989 TFLOP/s bf16 tensor-core peak, and three torch.matmul calls
    of the bf16 operands (which round their output to bf16) as its
    library time.
20. Wide training and the other kernels at width 256, B = 256: one
    `fast.odeint_adjoint_mlp` SGD step (K2 + K3 on the wide route) and one
    with a 'mixed' forward; K3, K5, K6 and K9 on the wide route against
    their plain versions (bitwise, identical counts; K5's group layout
    printed) and timed.
21. `fast.calibrate_dot_precision` on the wide configuration ('bf16' and
    'mixed' against 'highest', the reference's NFE x passes model): the
    tier it picks and the NFEs.

22. K7's forward in K2 (`mlp_solve(rhs='cnf')`) at BASELINE.md:83's CNF
    configuration: the 3 -> 32 -> 32 -> 2 tanh flow (`CNFDynamics` from a
    seeded generator), 4096 two-moons points, t = [1, 0], dopri5 at rtol
    1e-5, atol 1e-7. `fast.cnf_log_prob_fused` in float32 and float64: one
    K2 launch with K7 each (counters zeroed before, read after), status 0;
    that launch, recorded with its inputs (`_Recording`), against its plain
    version on the same inputs (bitwise, identical stats) and run again
    (bitwise); float32 within 1e-4 of the generic
    `models.cnf.log_prob(trace='exact')` on the card. The kernel (CUDA
    events), its plain version (host clock), the entry point and the
    generic path timed; the bound from the run's NFE. [22]-[24] print each
    recorded launch's grouped walk (blocks, samples a round, threads a
    sample).
23. K7's adjoint in K3 (`mlp_adjoint_solve(rhs='cnf')`) on [22]'s
    trajectory with g = d(-mean log p)/d out, B = 4096: against its plain
    version in float64 and float32 (bitwise, identical stats; one K3 launch
    each), run to run bitwise; timed with its bound. One
    `fast.cnf_log_prob_train` step at B = 4096: two chunks of 2048, so two
    K2 and two K3 launches, both with K7; the first chunk's K2 and K3,
    recorded, against their plain versions (bitwise); its gradients within
    1e-3 relative of autograd through the generic `models.cnf.log_prob`;
    then both steps timed warm on the host clock (median of 3).
24. `examples/cnf.py --fused` at its defaults (B = 512 two moons, hidden
    64, lr 1e-3, 256 attempts at most): a first Adam step whose K2 and K3
    (with K7) are recorded and held to their plain versions (bitwise,
    identical stats), then three more timed (median); one K2 and one K3
    a step, finite NLL and gradients; then `fast.cnf_sample_fused` of 1000
    points: one K2 of the plain concat-t MLP, finite.

25. K11 `mlp_solve_vcabm` at the VCABM protocol (bench.py:237-253: the
    spiral, y [4096, 2], hidden 50, 64 outputs over [0, 25], rtol = atol =
    1e-6, first step 0.01, max_order 12): the launch that
    `fast.solve_mlp(method='adams')` makes (counter zeroed before, read
    after: one K11), recorded with its inputs (`_Recording`) and held to
    its plain version (bitwise, identical stats) in float32 and float64,
    and in float64 at max_order 5 through `fast.solve_mlp_spec`; each run
    again bitwise. Status 0, finite [64, 4096, 2]; the gap to dopri5 (K2)
    printed; at B = 96 (12 outputs over [0, 5]) within 1e-3 relative of the
    generic `solve(ODEFunc, method='adams')`. K11 and its plain version
    timed with CUDA events, the generic engine on the host clock (median
    of 3 after one more); the bound counts the live phi rows at the orders
    the run took (`_Orders`).
26. K10 `mlp_solve_adams` at the bench widths with bench.py:205's 512
    steps: fixed_adams and explicit_adams (max_order 4, max_iters 4) in
    float32 and float64, and both on the default grid (outputs at t), each
    the launch that `fast.solve_mlp_spec` makes (one K10; fixed_adams on
    its grid of one block per SM, n_blocks printed), held to its plain
    version at the kernel's grid (bitwise, identical stats, nfe 1 + 3 x 4 +
    5 or 1 a step) and run again bitwise; at B = 96 within 1e-5 relative
    of the generic engine; both methods timed against their plain versions and the
    generic engine. Then explicit_adams' group kernel (a group of threads a
    sample) on the narrow route and the wide route (128 -> 256 -> 256 ->
    128) at B = 4096, 256, 33 and 1, max_order 1 forward and 12 in reverse
    time on a 40-step grid over [0, 0.25], float32 and float64, each launch
    held to its plain version and run again bitwise, the layout each
    launch reported printed (threads a sample, samples a block, where the
    slots sit).
27. Three SGD steps of the spiral (bench.py:788-838) through
    `fast.odeint_adjoint_mlp(method='adams', adjoint_method='dopri5')`:
    K11 = K3 = 3 launches and no K2, forward status 0, finite gradients,
    the weights move; one step with `method='fixed_adams',
    adjoint_method='rk4', num_steps=512` and 8 backward steps an interval
    (phase 12's): K10 = K9 = 1, the K10 launch held bitwise to its plain
    version at its grid. At B = 96 the Adams-forward gradients
    agree with the generic `odeint_adjoint(method='adams',
    adjoint_method='dopri5')` within 1e-3 relative.

28. K14, a traced plan's generated right-hand side (ops/plan_bridge.py,
    ops/plan_codegen.py, csrc/plan_rhs.cuh), inside K2: the bench spiral
    written as plain PyTorch over the bench weights and solved by
    `odeint(..., options={'fuse': True, 'first_step': 0.01})` at the bench
    protocol, float32 and float64: one plan-K2 launch, no fallback, status
    0, finite [64, 4096, 2]; the launch, recorded with its inputs, held to
    its plain version (`cuda_plan.plan_solve_plain`: K2's engine with
    `eval_plan`) bitwise with identical stats, and run again bitwise. K2's
    MLP route (`fast.solve_mlp`) and the generic engine on the same weights
    are timed beside it and the largest gaps printed (not held: at B = 4096
    over [0, 25] summation order moves the step counts); at B = 96 with 12
    outputs over [0, 5] within 1e-5 relative of the generic solve. The
    plan libraries of phases 28-32 are captured after [2] and built beside
    phases 3-27 (one nvcc each, together); their build times and -Xptxas
    -v reports are printed here.
29. K14 in K8: the same plan, rk4 with 500 steps through
    `fast.solve_fused` (one plan-K8 launch), held to its plain version in
    both types; euler, midpoint and rk4_38 in float64 on the default grid
    (the 64 output times) at B = 96; K8's MLP route timed beside it.
30. K14 in K5: `solve(..., options={'fuse': True, 'per_sample': True})`
    at the bench protocol (one plan-K5 launch), held to its plain version
    in both types; the samples' nfe (min, median, max); K5's MLP route
    timed beside it.
31. Batch couplings in K2's batch route: the reference's `meanfield`,
    `scalar_coupled` and a max coupling (y - max_j y) at B = 4096, D = 3, 7
    outputs over [0, 2], each one plan-K2 launch held to its plain version
    (the block's sum order) in both types; the generic engine timed beside.
32. `fast.cnf_sample_auto` of BASELINE's flow (3 -> 32 -> 32 -> 2, concat-t,
    tanh; flax-layout weights through `convert.cnf_from_flax`), written as
    plain PyTorch, n = 4096 over [0, 1] at rtol 1e-5, atol 1e-7: one
    plan-K2 launch held to its plain version; within 1e-4 relative of
    `fast.cnf_sample_fused` on the same base noise; both timed. Then [28]
    once more: no plan library is built again (the cache by structure),
    and the result is bitwise the first run's.

33. K15, a traced plan's reverse walk (ops/plan_adjoint.py,
    ops/plan_codegen.py `PlanAug`, csrc/plan_aug.cuh), inside K3: one SGD
    step (lr 1e-3) of the spiral training protocol (bench.py:842-895: the
    bench spiral as plain PyTorch over its four weights, B = 4096, 64
    outputs over [0, 25], dopri5 at rtol = atol = 1e-6, the MSE against
    the seed-2 target) through `odeint_adjoint(options={'fuse': True})`,
    float32 and float64: one plan-K2 and one plan-K3 launch, no fallback,
    finite gradients, the weights move; the K3 launch, recorded, held to
    its plain version (`cuda_plan.plan_adjoint_solve_plain`: K3's engine
    with `aug_terms`) bitwise with identical stats, and run again bitwise.
    The sweep (CUDA events) beside K3's MLP route on the same trajectory
    and cotangent; the step (median of 3 warm) beside
    `fast.odeint_adjoint_mlp` and the generic `odeint_adjoint` (one step),
    every timed step at the same weights (its update computed, not
    applied).
34. K15 in K6: one SGD step of the stiffness battery (bench.py:483-535:
    sc[:, None] * (tanh((y^3) W1 + b1) W2), sc = logspace(0, 2, 4096), 5
    outputs over [0, 2], the loss sum(ys^2)) through `odeint_adjoint(
    options={'fuse': True, 'per_sample': True})` in float32: one plan-K5
    and one plan-K6 launch, the K6 launch held to its plain version ([50]
    runs the plain versions of this phase's three K6 holds), a NaN
    allowed only where a sample ended with a status (the stiffest samples'
    reverse-time sweep underflows dt, and the front end then returns NaN
    gradients by contract) or, in a batch sum, where any did; the samples'
    backward nfe and how many failed; the step beside the same battery
    under one shared controller (K2 + K3). Then one SGD step of [33]'s
    spiral per sample, where every sample finishes, in both types: the K6
    launch held bitwise to its plain version and every gradient finite.
35. K15 in K3's batch-wide walk: one SGD step of each of [31]'s couplings
    over a learnable weight (B = 4096, D = 3, 7 outputs over [0, 2], the
    MSE against a seed-1 target): one plan-K2 and one plan-K3 launch each,
    the K3 launch held to its plain version in both types (the couplings'
    transposes meet in the block's order); the sweep timed, the step
    beside the generic `odeint_adjoint`.
36. K15 in K9: one SGD step of [33]'s spiral with rk4 (500 steps forward,
    K8; 8 steps an interval backward, K9: [12]'s grid), held to the plain
    versions in both types; the sweep beside K9's MLP route on the same
    inputs, the step beside `fast.odeint_adjoint_mlp` and the generic
    `odeint_adjoint`.

37. K12, the hypersolvers (`csrc/rk_hyper.cuh`: two generated plans, the
    dynamics and the correction net, in one kernel), through
    `fast.solve_hyper` at the example's widths (`examples/hypersolver.py`:
    f = y^3 A, the 5 -> 32 -> 2 tanh hypernet from seed 0, B = 4096 states
    in the unit disk, and the same at B = 256, 33 and 1, each batch's layout
    as its launch reported it printed): hyper_euler, hyper_midpoint and
    hyper_heun on the output grid (33 nodes over [0, 2]), `num_steps=32`
    with 9 outputs and reverse time with `step_size=0.0625`, float32 and
    float64: one launch a
    solve, each held to `cuda_plan.plan_solve_hyper_plain` bitwise with
    identical stats and run again bitwise; each kind timed (CUDA events)
    against its plain version, the bound from both plans' `_plan_flops`.
38. The hypersolver path through its entry points: `solve(f, y0, t,
    method='hyper_euler', options={'hypernet': g, 'fuse': True})` is one
    K12 launch with `fast.fuse_fallbacks` unchanged, within 2e-6 of the
    generic hypersolver with its NFE (the reference's bar); both timed.
    Then `examples/hypersolver.py --iters 300` at its defaults: its trained
    hypersolver beats plain euler on fresh states, every fused serving call
    one K12 launch, the serving ms printed.
39. K14 in K10: the bench spiral as plain PyTorch through `solve(...,
    method='fixed_adams' / 'explicit_adams', options={'fuse': True,
    'num_steps': 512})` at the bench widths, float32 and float64: one
    launch each, held to `cuda_plan.plan_solve_adams_plain` bitwise at
    fixed_adams' grid (n_blocks printed); timed
    beside K10's MLP route on the same function and the generic engine.
    Then explicit_adams' group kernel on the plan route at B = 4096, 256,
    33 and 1, max_order 1 and 12 as in [26], each launch held to its plain
    version, its reported layout printed.
40. K14 in K11: VCABM at the bench protocol through `solve(...,
    method='adams', options={'fuse': True, 'first_step': 0.01})`
    (bench.py:237-253), float32 and float64, held to
    `plan_solve_vcabm_plain` bitwise and timed beside K11's MLP route; one
    `odeint_adjoint(method='adams', adjoint_method='dopri5', options={'fuse':
    True})` SGD step of the bench training protocol: tier 2, one K11 launch
    forward and the generic backward, no fallback, finite gradients.
41. K2's dense-output emission (`csrc/rk_solve.cuh`): the bench spiral as
    plain PyTorch through `fast.solve_fused(dense_output=True)` at the
    bench protocol (S = 1024 rows, the step budget), float32 and float64:
    one K2 plan launch each, its out, stats, meta and coef held bitwise to
    `plan_solve_plain(emit_dense=S)`, the same launch without the buffers
    bitwise equal in out and stats, and `eval_flat` at the 64 outputs
    within `DENSE_EVAL_BARS` of ys (interior outputs bitwise equal are
    counted); the same for the mean-field plan at B = 33 (the batch route,
    built with [28]'s). K2's device time with and without the emission
    (CUDA events, without/with/with/without), the emission's bytes and
    bound. Then the generic `solve(options={'telemetry': True})` on the
    card: its counts agree with the stats.
42. The interpolated spiral training step, `odeint_adjoint(adjoint_mode=
    'interpolated', options={'fuse': True})` at the bench training
    protocol, float32: one K2 launch with the emission and no K3, then the
    generic backward on the interpolants; gradients within
    `INTERP_GRAD_BAR` of [33]'s resets-mode fused step at the same
    weights, relative to its largest entry (each parameter's gap printed); the
    interpolated step timed once warm, the resets step's median of 3, the
    b-NFE of both, and the device-idle share of an interpolated step
    profiled on the card's activity.
43. [34]'s stiffness battery (B = 4096, 5 outputs over [0, 2], float32)
    under one shared controller with the interpolated adjoint, tier 2
    (`BATTERY_S` rows and steps forward, `BATTERY_BWD` attempts an
    interval backward): the forward's stats, the backward's status an
    interval, b-NFE, whether every gradient is finite (a NaN only where a
    status says so) and the time of the one step.
44.-47. The coupled plans (the mean field, a scalar coupling and a max
    coupling at B = 4096, D = 3, 7 outputs over [0, 2]) on the one-block
    routes of K8 (rk4, euler), K10 (fixed_adams, explicit_adams), K11 and
    K9, through `solve` / `odeint_adjoint` with `options={'fuse': True}`,
    float32 and float64: every launch held bitwise to its plain version,
    timed beside the generic engine.
48. The float64 tier, `solve_df`, from float32 callers: bench.py:595-633's
    protocol (y' = y^3 A, B = 32, 64 outputs over [0, 25], rtol 1e-10 /
    atol 1e-12) within `DF_BAR` of the port's generic float64 solve on the
    CPU at rtol 1e-12; the spiral MLP at B = 4096 against K2's MLP route
    in float64 at rtol 1e-12, relative to max(1, |y|): within
    `DF_BAR_DEFAULTS` (1e-4) at solve_df's defaults (rtol 1e-8 is not
    1e-6 over this span) and within `DF_BAR` (1e-6) at the protocol's
    tolerance (the float64 launch's own absolute error printed beside
    it). Each is one K2 launch in float64 with K14 (the capture at
    float32, the constants packed in float64), run again bitwise and held
    bitwise to its plain version after the timed phases; no fallback.
    Device ms a solve (CUDA events), the call's host ms, nfe and attempts,
    bounds with the products at the FP64 tensor cores' 67 TFLOP/s and the
    other operations at the CUDA cores' 34 TFLOP/s.
49. One `odeint_adjoint_df` step of the spiral with bench.py's MSE at
    B = 4096 (one K2 and one K3 launch in float64, no fallback, finite
    float32 gradients): the step's host ms, the K3 sweep's device ms and
    b-NFE, K2's launch bitwise equal to [48]'s held one on the same inputs,
    the K3 sweep held bitwise to its plain version; at B = 32 both
    launches held bitwise and the gradients within `DF_BAR` of the generic
    float64 `odeint_adjoint` on the CPU, on the whole gradient's scale.
51. K4 at its last sites, on the wide MLP (bench.py:291-424, its [18]
    weights) at full width, B = 1024, through the public entry points,
    counters zeroed before each and read after: (a) the net written as
    plain PyTorch through `solve(options={'fuse': True, 'dot_precision':
    'mixed'})`, dopri5, 8 outputs over [0, 2], rtol = atol = 1e-6, first
    step 0.01: one plan-K2 launch on its tile route (K14's segments a
    thread a sample, each tiered dot K4's product on the block's 16-row
    tiles) and one K4 count; (b) rk4 x 128 over [0, 2] at 'bf16' and
    'mixed': two plan-K8 launches on the tile route; (c) per sample, 'mixed':
    `fast.solve_mlp_spec(MLPSpec(matmul='mxu', dot_precision='mixed'),
    per_sample=True)` (one K5 launch on its tile engine, 16 samples a block
    in lockstep) and the plan through `options={'fuse': True, 'per_sample':
    True, 'dot_precision': 'mixed'}` (one plan-K5 launch). Each full-size
    float32 launch is held in [50] to its plain version within its bar
    ('mixed' K2 5e-5 with counts within one; K8 `SOLVE_BARS`, stats
    identical; K5 2e-4, each sample's counts within one, statuses equal),
    and at B = 64 in float64 bitwise: the same routes, K2's dense output,
    the coupled plan (a mean-field term) on one block of K2 and K8, and
    the battery of per-sample stiffness (the plan scaled by logspace(0, 2,
    B)) on K5's tile engine, whose samples finish at very different
    attempts. Each launch timed (CUDA events) beside the MLP route's K2 and
    K8 at the same tier ([18], [19]).
50. The holds kept for after the timed phases (`_LaterHolds`: [7]'s K3
    sweeps, [17]'s K6 sweeps, [19]'s K8 tier solves (with the controls
    against the other tiers' plain versions, which need their results),
    [26]'s K10 solves, [34]'s K6 sweeps, [48]'s and [49]'s launches and
    [51]'s), whose plain versions take seconds to a minute and a half
    each: `WORKERS` worker processes on the card run them side by side;
    each must be bitwise equal as above, or for a float32 tier within its
    bar; the plain versions' times of [7], [17], [19] and [26] are taken
    there, with the others running.

Before the last line come the card's name and power limit and one JSON
object with each kernel's record: its launches on its path, the largest difference
from its plain version, its time and its plain version's, and its bound,
the least time the card could take for the work of this run's inputs (the
larger of its operations over the float32 peak of 67 TFLOP/s, or for K4's
tier products the bf16 tensor-core peak of 989 TFLOP/s, and the bytes it
must read and write once over 3.35 TB/s). No single PyTorch call computes
any of these whole solves, steps or sweeps, so library_ms is null but for
K4. K10 (`adams_solve`: fixed_adams, with explicit_adams' numbers under
`explicit_*`) and K11 (`vcabm_solve`) carry the generic engine's time
(`generic_engine_ms`), their launches in [27]'s training steps, and K11 the
Adams-forward training step (`train_step_ms`). K14 (`plan_rhs`) carries
its launches, largest difference from the plain version, times, plain
times and bounds in each host (`*_by_host`: K2, K8, K5; the top-level
numbers are K2's at the bench protocol), each plan library's build seconds
(`build_s`), the hand-written MLP route's time on the same function in each
host (`mlp_route_ms`, its nearest yardstick), the coupled plans' times
beside the generic engine, and the two samplers' times. K15 (`plan_aug`)
carries the same by host (K3, K6, K9; the top-level numbers K3's in [33]),
the bound from `_plan_aug_flops`, the training step's time in each host,
the MLP route's sweep and step on the same spiral (`mlp_route_ms`,
`mlp_route_step_ms`), the generic `odeint_adjoint` step (`generic_ms`), the
battery's shared-controller step and the couplings' sweeps and steps.
K2 (`mlp_solve`) also carries its dense-output emission on the plan route
([41]-[43]: `dense_ms` beside `dense_no_emission_ms`, the plain time, the
bound with and without the emission's bytes, its launches and largest
difference, the interpolated and resets steps, the battery's statuses).
K2's and K14's records carry the float64 tier ([48], [49]: `float64_tier`,
its K2 launches and each case's time, plain time, float64 bound,
largest difference from the plain version, nfe and error against its
float64 reference), K3's and K15's its K3 sweep ([49]).
K14 also carries its K10 and K11 hosts ([39], [40]) with the generic
engine beside K10 and the Adams-forward training step through tier 2. K12
(`hyper_solve`) carries each kind's time, plain time and bound, the
entry point's and the generic hypersolver's times and the example's
errors and serving time.
K7 has two records, its
forward in K2 (`cnf_forward`, launches in
[24]'s steps) and its adjoint in K3 (`cnf_adjoint`), each with the
nearest library-built path's time beside it: the generic engine with
autograd's exact trace (`generic_engine_ms`, the density solve;
`generic_train_step_ms`, a training step, beside the fused step's
`train_step_ms`). The MLP kernels' records also carry their wide-route time (`wide_ms`,
phases 18-20), and K2's and K8's records their 'highest' time on the batch
route (`wide_batch_route_ms`). The grid kernels' records (K2 `mlp_solve`, K3
`mlp_adjoint_solve`, K11 `vcabm_solve`, K14 `plan_rhs`) carry `n_blocks`,
their grid at the bench batch; every phase that holds a K2, K3 or K11
launch to its plain version hands it the wrapper's grid (`_grid_kw`) and
prints it. The run's total time is printed before them. The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np

B, H, D, T_OUT, SPAN, TOL, FIRST_STEP = 4096, 50, 2, 64, 25.0, 1e-6, 0.01
TRAIN_STEPS, SGD_LR = 3, 1e-3


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


def _bench_target(dtype, device):
    """bench.py:803-804: the MSE target of the training protocol."""
    import torch
    return torch.tensor(np.random.RandomState(2).randn(T_OUT, B, D) * 0.5,
                        dtype=dtype, device=device)


def _rel(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _host_ms(fn, reps=3):
    """Median host milliseconds of `reps` calls that each end in a
    synchronise."""
    import time
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _profiled(fn, top=6, cpu=True):
    """One call of fn under torch.profiler: (host ms, device-busy ms,
    [(kernel name, device ms, calls)] of the `top` kernels by device
    time). Device time is the sum of the kernels' own times. cpu=False
    records the card's activity alone: a step of some 10^5 host operations
    then takes seconds, not minutes, to summarise (a trace that shows no
    kernel is taken again with the host's)."""
    import time
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels and not cpu:
        return _profiled(fn, top, True)
    kernels.sort(key=lambda k: -k[1])
    return host_ms, sum(k[1] for k in kernels), kernels[:top]


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


#: Cycles of the sleep `_device_ms` queues first (about 10 ms on an H100).
SLEEP_CYCLES = 20_000_000


def _device_ms(fn, reps=7, inner=10):
    """Median device ms per call of fn, whose launches queue behind a sleep
    on the card: CUDA events around `inner` calls enqueued while the card
    sleeps, so the window holds the device work alone and none of the
    host's (which `_timed` measures when it is the slower). fn must not
    synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _kernel_ms(lib, name: str, call, reps: int = 7) -> float:
    """Median device ms of the launch of lib.<name> (a ctypes launch
    function of the kernels' library) inside call(): CUDA events right
    before and after the ctypes call, behind a sleep queued first, so that
    the window holds the kernel alone and none of the wrapper's work."""
    import torch
    fn0, marks = getattr(lib, name), []

    def timed(*a):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
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


def _peaks():
    """`tfdiffeq_tpu_torch/utils/flops.py`, whose H100 SXM peaks (NVIDIA's
    data sheet) every bound here divides by, as PERF.md's table does."""
    from tfdiffeq_tpu_torch.utils import flops
    return flops


#: perf_counter at the start of main(), for `_at`.
_RUN_T0 = [0.0]


def _at(phase) -> None:
    """Print when a phase starts, in seconds since the run began: where the
    run's time limit goes."""
    import time
    print(f"[clock] phase {phase} starts at "
          f"{time.perf_counter() - _RUN_T0[0]:.1f} s", flush=True)


def _bound(flops: float, nbytes: float, peak: float = None):
    """(bound in ms, what sets it): the larger of the operations over the
    peak (float32 on the CUDA cores unless given) and the bytes over the
    memory rate."""
    return _bound_s(flops / (peak or _peaks().PEAK_F32_CUDA), nbytes)


def _bound_f64(products: float, other: float, nbytes: float):
    """`_bound` of float64 work: its products at the FP64 tensor cores'
    peak and its other operations at the CUDA cores' (`flops.float64_ops_s`,
    the two added), or its bytes, whichever takes longer."""
    return _bound_s(_peaks().float64_ops_s(products, other), nbytes)


def _bound_s(t_ops: float, nbytes: float):
    """(bound in ms, what sets it) from the operations' seconds."""
    t_bytes = nbytes / _peaks().PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _mlp_flops(dims, input_power: int = 1) -> int:
    """One MLP evaluation for one sample: a multiply and an add per weight,
    a bias add and an activation per output, the input power's
    multiplies."""
    return (sum(2 * din * dout + 2 * dout for din, dout in dims)
            + dims[-1][1] * (input_power - 1))


def _combine_flops(tab) -> int:
    """An RK attempt's combines for one state element: each nonzero stage,
    solution, error and midpoint weight costs a multiply and an add; the
    error scale, ratio and square about 8 more."""
    nnz = sum(1 for row in tab.a for a in row if a != 0.0)
    for w in (tab.b_sol, tab.b_err, tab.c_mid or ()):
        nnz += sum(1 for x in w if x != 0.0)
    return 2 * nnz + 8


def _conv_eval_flops(C: int, H: int, W: int) -> int:
    """One evaluation of the ODE-Net field for one sample: two 3x3 SAME
    convs over the taps that fall inside the map ((3H - 2)(3W - 2) of the
    9HW), a multiply and an add a weight; bias and t * TM; three
    GroupNorms (about 8 operations an element) and two relus."""
    P = H * W
    conv = 2 * C * C * (3 * H - 2) * (3 * W - 2) + 3 * C * P
    return 2 * conv + 3 * 8 * C * P + 2 * C * P


WIDE_D, WIDE_H, WIDE_B = 128, 256, 1024


def _wide_net(dtype, device, B=WIDE_B, seed=1):
    """bench.py:308-320 and :344-354: the wide MLP's seed-0 weights, zero
    biases, and seed-`seed` states randn(B, 128) * 0.5."""
    import torch
    rng = np.random.RandomState(0)
    dims = ((WIDE_D, WIDE_H), (WIDE_H, WIDE_H), (WIDE_H, WIDE_D))
    W = [(torch.tensor(rng.randn(i, o) / np.sqrt(i), dtype=dtype,
                       device=device),
          torch.zeros(o, dtype=dtype, device=device)) for i, o in dims]
    y0 = torch.tensor(np.random.RandomState(seed).randn(B, WIDE_D) * 0.5,
                      dtype=dtype, device=device)
    return W, y0


def _host_call(fn):
    """(fn(), host milliseconds of the call, synchronised): the plain
    versions of the wide phases are timed by the call that checks them."""
    import time
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _plain_ms(fn) -> float:
    """Host milliseconds of one synchronised call of a plain version: it
    is host-bound and takes seconds, so one call needs no median."""
    return _host_call(fn)[1]


def _clone(v):
    """v with every tensor in it (through tuples, lists and dicts) cloned."""
    import torch
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


class _Recording:
    """`with _Recording(module, name) as rec:` passes every call of
    module.name through unchanged and keeps its (args, kwargs, result),
    tensors cloned, in rec.calls: the kernel launch that a public entry
    point makes is then held against its plain version on its own
    inputs."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.fn = fn = getattr(self.module, self.name)

        def record(*args, **kw):
            kept = _clone(args), _clone(kw)
            res = fn(*args, **kw)
            self.calls.append((*kept, _clone(res)))
            return res

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _same(a, b, nan_ok=None) -> bool:
    """Bitwise equal (`torch.equal`: a NaN fails). Where the bool mask
    `nan_ok` (broadcast to a's shape) is true, a NaN in a matching a NaN at
    the same place in b also counts: a failed sample's row."""
    import torch
    if nan_ok is None or not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and not bool((na & ~nan_ok).any())
            and torch.equal(a[~na], b[~nb]))


def _group_layout(name: str, B: int, group: int, threads: int) -> str:
    """A group engine's launch shape at batch B: threads a sample, blocks,
    warps a block."""
    return (f"{name} a group of {group} threads a sample, "
            f"{-(-B // (threads // group))} blocks of {threads} "
            f"({threads // 32} warps a block)")


def _k8_layout(B: int, route: int = 0) -> str:
    """K8's launch shape at batch B on an MLP route (0 narrow, 1 wide;
    csrc/lane_group.h): a group of threads a sample, 512-thread blocks."""
    from tfdiffeq_tpu_torch.ops import cuda_fixed as cf
    return _group_layout("K8", B, cf.fixed_group(route),
                         cf.FIXED_GROUP_THREADS)


def _k5_layout(B: int, route: int = 0) -> str:
    """K5's launch shape at batch B on an MLP route: K8's layout, each
    group under its own controller."""
    from tfdiffeq_tpu_torch.ops import cuda_perlane as cp
    return _group_layout("K5", B, cp.perlane_group(route),
                         cp.PERLANE_SOLVE_THREADS)


def _k6_layout(B: int) -> str:
    """K6's launch shape at batch B (csrc/lane_group.h): a group of threads
    a sample, 32 samples a block."""
    from tfdiffeq_tpu_torch.ops import cuda_perlane as cp
    return (f"K6 a group of {cp.PERLANE_GROUP} threads a sample, "
            f"{-(-B // cp.PERLANE_THREADS)} blocks of "
            f"{cp.PERLANE_ADJOINT_THREADS}")


def _k9_layout(B: int) -> str:
    """K9's launch shape at batch B: K6's layout, a group of threads a
    sample, 32 samples a block of 512 threads."""
    from tfdiffeq_tpu_torch.ops import cuda_fixed as cf
    return (f"K9 a group of 16 threads a sample, {-(-B // 32)} blocks of "
            f"{cf.FIXED_ADJOINT_THREADS} ({cf.FIXED_ADJOINT_THREADS // 32} "
            "warps)")


def _k13_grid(B: int, block: int, dev) -> str:
    """K13's grid at batch B: each controller block's CTAs."""
    from tfdiffeq_tpu_torch.ops import cuda_conv as cc
    ctas = cc.conv_ctas(B, block, dev)
    return (f"K13 grid: {sum(ctas)} CTAs, CTAs per controller block "
            f"{ctas}")


def _grid_kw(plain, args, kw) -> dict:
    """kw with the kernel's grid for the plain version of K2, K3, K11 or
    fixed_adams' K10: the n_blocks that the kernel's wrapper chose for
    these inputs (`cuda_kernels.solve_blocks`: one block per SM, one a
    16-row tile on K2's batch route; one block for a coupled plan),
    printed; else kw (explicit_adams has no grid)."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, \
        cuda_adjoint as ca, cuda_kernels as ck, cuda_plan as cpl
    grids = {ca.mlp_adjoint_solve_plain: "K3", cpl.plan_adjoint_solve_plain:
             "K3", ck.mlp_solve_plain: "K2", cpl.plan_solve_plain: "K2",
             cad.mlp_solve_vcabm_plain: "K11",
             cpl.plan_solve_vcabm_plain: "K11",
             cad.mlp_solve_adams_plain: "K10",
             cpl.plan_solve_adams_plain: "K10"}
    if "n_blocks" in kw or plain not in grids or kw.get("per_sample") \
            or (grids[plain] == "K10" and not kw.get("implicit", True)):
        return kw
    if grids[plain] == "K3":
        B, dev = args[2].shape[1], args[2].device
    else:
        B, dev = args[2].shape[0], args[2].device
    if plain in (cpl.plan_adjoint_solve_plain, cpl.plan_solve_plain,
                 cpl.plan_solve_vcabm_plain, cpl.plan_solve_adams_plain):
        nb = cpl.plan_blocks(args[0], B, dev, bool(cpl.tiered_dots(
            args[0], kw.get("dot_precision", "highest"))))
    elif plain is ck.mlp_solve_plain:
        nb = ck.solve_blocks(B, dev, ck._solve_unit(args[1], args[2],
                                                    kw.get("tiers")))
    else:
        nb = ck.solve_blocks(B, dev)
    print(f"{grids[plain]} grid: n_blocks = {nb} (B = {B})", flush=True)
    return {**kw, "n_blocks": nb}


def _hold_to_plain(call, plain, what: str, nan_ok=None):
    """A recorded launch (args, kwargs, result, the stats last) against its
    plain version on the same inputs: every output bitwise equal and the
    stats identical, else AssertionError. `nan_ok`, one mask an output (or
    None), lets a NaN match a NaN where its mask is true (`_same`).
    Returns (largest |kernel - plain| where both are numbers, the plain
    version's host ms)."""
    import torch
    args, kw, got = call
    kw = _grid_kw(plain, args, kw)
    ref, plain_ms = _host_call(lambda: plain(*args, **kw))
    masks = nan_ok or [None] * len(got)
    err = max(float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
              if a.numel() else 0.0 for a, b in zip(got[:-1], ref[:-1]))
    same = all(a.shape == b.shape and _same(a, b, m)
               for a, b, m in zip(got, ref, masks))
    print(f"{what}: kernel stats {got[-1].tolist()}, plain "
          f"{ref[-1].tolist()}; max |kernel - plain| {err:.3e}; bitwise equal "
          f"to plain: {same}", flush=True)
    if not same:
        raise AssertionError(f"{what} differs from its plain version")
    return err, plain_ms


def _moved(v, dev):
    """v with every tensor in it (through tuples, lists and dicts)
    detached and copied to dev."""
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().to(dev, copy=True)
    if isinstance(v, (tuple, list)):
        return type(v)(_moved(x, dev) for x in v)
    if isinstance(v, dict):
        return {k: _moved(x, dev) for k, x in v.items()}
    return v


def _flat_sweep(r):
    """An adjoint sweep's result (ay0, the constants' cotangents, a_t,
    stats[, lane stats]) flattened to tensors, the stats last."""
    return (r[0], *r[1], r[2], *r[4:5], r[3])


def _later_hold(job):
    """One of `_LaterHolds`' jobs, in a worker process: the plain version
    on the launch's device on the recorded inputs, against the kernel's
    recorded outputs as `_hold_to_plain` holds them. Returns (largest
    |kernel - plain| where both are numbers, the plain version's host ms,
    bitwise equal, the kernel's stats, the plain version's)."""
    import torch
    dev = torch.device(job["device"])
    args, kw = _moved(job["args"], dev), _moved(job["kw"], dev)
    got = _moved(job["got"], dev)
    masks = _moved(job["masks"], dev) or [None] * len(got)
    with torch.no_grad():
        ref, plain_ms = _host_call(lambda: job["plain"](*args, **kw))
    if job["flat"]:
        ref = _flat_sweep(ref)
    if job["bar"] is None:
        err = max(float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
                  if a.numel() else 0.0 for a, b in zip(got[:-1], ref[:-1]))
        same = all(a.shape == b.shape and _same(a, b, m)
                   for a, b, m in zip(got, ref, masks))
    else:
        # A float32 tier: the floating outputs within the bar, the accepted
        # and rejected counts within `slack` and the statuses equal, a
        # sample's own where the result has per-sample stats [4, B] (their
        # sums then differ by as many samples as moved), else the solve's.
        pairs = list(zip(got, ref))
        err = max((float((a - b).abs().max()) for a, b in pairs
                   if a.is_floating_point() and a.numel()), default=0.0)
        counts = [(a, b) for a, b in pairs if not a.is_floating_point()]
        if any(a.ndim == 2 for a, _ in counts):
            counts = [(a, b) for a, b in counts if a.ndim == 2]
        same = all(a.shape == b.shape for a, b in pairs) and \
            err <= job["bar"] and all(
                int((a.reshape(4, -1)[1:3] - b.reshape(4, -1)[1:3]).abs()
                    .max()) <= job["slack"]
                and torch.equal(a.reshape(4, -1)[3], b.reshape(4, -1)[3])
                for a, b in counts)
    kept = _moved(ref, "cpu") if job["keep"] else None
    return err, plain_ms, same, got[-1].tolist(), ref[-1].tolist(), kept


def _stats_line(st):
    """A hold's stats for its line: as they are, or per-sample stats [4, B]
    as the sums of the counts and the largest status."""
    if st and isinstance(st[0], list):
        return [sum(r) for r in st[:3]] + [max(st[3])]
    return st


class _LaterHolds:
    """Holds of a launch to its plain version whose plain run takes many
    seconds, kept here and run after the timed phases in `WORKERS` worker
    processes on the same card: the plain versions are host-bound, so
    they run side by side, and none shares the card with a timed run (the
    plain times are taken with the others running). `add` copies the
    inputs and outputs to the host; `run` checks every job as
    `_hold_to_plain` does (or, for a float32 tier, within its bar), prints
    its line and hands (largest |kernel - plain|, plain ms[, the plain
    result]) to the job's `done`, runs the checks `after` queued, and
    stops the workers."""

    WORKERS = 3

    def __init__(self):
        self.jobs = []
        self.afters = []

    def add(self, call, plain, what, done, nan_ok=None, flat=False,
            bar=None, slack=0, keep=False):
        """call: (args, kwargs, result) of the launch, the result already
        flattened (`_flat_sweep`) when flat. bar: None (bitwise equal,
        stats identical) or the largest |kernel - plain| a float32 tier
        may show, its counts within `slack` and its statuses equal. keep:
        `done` also receives the plain result (on the host)."""
        args, kw, got = call
        kw = _grid_kw(plain, args, kw)
        self.jobs.append(({"args": _moved(args, "cpu"),
                           "kw": _moved(kw, "cpu"),
                           "got": _moved(got, "cpu"),
                           "masks": _moved(nan_ok, "cpu"),
                           "plain": plain, "flat": flat, "bar": bar,
                           "slack": slack, "keep": keep,
                           "device": str(got[0].device)}, what, done))

    def after(self, check):
        """check() runs once every job's `done` has."""
        self.afters.append(check)

    def run(self):
        import concurrent.futures
        import multiprocessing
        import time
        t0 = time.perf_counter()
        pool = concurrent.futures.ProcessPoolExecutor(
            self.WORKERS, mp_context=multiprocessing.get_context("spawn"))
        try:
            futures = [pool.submit(_later_hold, job)
                       for job, _, _ in self.jobs]
            for (job, what, done), fut in zip(self.jobs, futures):
                err, plain_ms, same, st_k, st_p, kept = fut.result()
                held = ("bitwise equal to plain" if job["bar"] is None
                        else f"within the bar {job['bar']}")
                st_k, st_p = _stats_line(st_k), _stats_line(st_p)
                print(f"{what}: kernel stats {st_k}, plain {st_p}; max "
                      f"|kernel - plain| {err:.3e}; {held}: {same} (plain "
                      f"{plain_ms:.1f} ms, in a worker)", flush=True)
                if not same:
                    raise AssertionError(
                        f"{what} differs from its plain version")
                if job["keep"]:
                    done(err, plain_ms, kept)
                else:
                    done(err, plain_ms)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        for check in self.afters:
            check()
        print(f"[holds] {len(self.jobs)} plain versions in "
              f"{self.WORKERS} workers: {time.perf_counter() - t0:.1f} s",
              flush=True)
        self.jobs, self.afters = [], []


_LATER = _LaterHolds()


#: Largest and mean |kernel - plain| a float32 tier may show, from the
#: order of its tensor-core sums alone: 'mixed' at roundoff; 'bf16' where a
#: last-bit difference flips the bf16 rounding of a layer input by 2^-8 on
#: a few outputs (0.7% of them in a CPU model of another summation order,
#: largest 1.3e-3). The tiers differ from each other by about 8e-4 on
#: average and 5e-3 at most in one evaluation of the wide net, so a kernel
#: that ran another tier's arithmetic fails the mean bar by 80x or more.
EVAL_BARS = {"highest": (0.0, 0.0), "mixed": (2e-5, 2e-6),
             "bf16": (3e-3, 1e-5)}
#: Largest |kernel - plain| of K8's rk4 x 128 wide solve in float32.
SOLVE_BARS = {"highest": 0.0, "mixed": 1e-5, "bf16": 2e-3}


def _gap(a, b):
    """(largest, mean) |a - b|."""
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def _held(label, tier, got, plains, gap_ok):
    """Hold a float32 tier's kernel output `got` to the plain version of its
    own tier (`gap_ok` must pass) and, as controls, to the plain versions of
    the other tiers in `plains` (each must fail: the check tells the tiers
    apart). Returns the gap to its own plain version."""
    own = _gap(got, plains[tier])
    if not gap_ok(own):
        raise AssertionError(f"{label} {tier}: |kernel - plain| (largest, "
                             f"mean) {own} past its bar")
    for other, ref in plains.items():
        if other != tier and gap_ok(_gap(got, ref)):
            raise AssertionError(f"{label} {tier}: the kernel passes the bar "
                                 f"against the plain {other!r} version too")
    return own


def _batch_route():
    """A context in which K2's and K8's wrappers take the batch route at
    every tier ('highest' layers there sum in input order on the CUDA
    cores): the route the solves take only for a reduced tier, timed
    against the wide route."""
    import contextlib
    from tfdiffeq_tpu_torch.ops import cuda_fixed as cf, cuda_kernels as ck

    @contextlib.contextmanager
    def forced():
        saved = ck._route, cf._route
        ck._route = cf._route = lambda *a, **k: ck.ROUTE_BATCH
        try:
            yield
        finally:
            ck._route, cf._route = saved
    return forced()


def _wide_tier(smi: str, dev) -> dict:
    """Phases 18-21: the wide-MLP tier and K4. Returns the numbers that the
    kernel records take."""
    import torch
    from tfdiffeq_tpu_torch import fast
    from tfdiffeq_tpu_torch.ops import _build, cuda_adjoint as ca, \
        cuda_fixed as cf, cuda_kernels as ck, cuda_perlane as cp
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5, RK4
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    f32, f64 = torch.float32, torch.float64
    rec = {}
    dims = ((WIDE_D, WIDE_H), (WIDE_H, WIDE_H), (WIDE_H, WIDE_D))
    n_mac = sum(i * o for i, o in dims)
    spec = fast.MLPSpec(activation="tanh", matmul="auto")

    def bound(evals, io, tier="highest", per=1):
        """A wide run's bound: `evals` sample-evaluations (`per` times the
        forward's operations each), on the CUDA cores in float32 or, for a
        tier, two bf16 passes ('mixed') or one on the tensor cores; the
        bytes of the weights and of `io` float32 state values read or
        written once."""
        if tier == "highest":
            return _bound(evals * per * _mlp_flops(dims), 4 * (n_mac + io))
        passes = 2 if tier == "mixed" else 1
        return _bound(evals * passes * 2 * n_mac, 2 * n_mac + 4 * io,
                      peak=_peaks().PEAK_BF16_TENSOR)

    t8 = {dt: torch.linspace(0.0, 2.0, 8, dtype=dt) for dt in (f32, f64)}
    tol = 1e-6

    _at("18")
    # [18] K2 at the bench tolerances, each tier against its plain version.
    k2, k2_plain = {}, {}
    for tier, dtype in (("highest", f32), ("highest", f64), ("mixed", f64),
                        ("mixed", f32)):
        W, y = _wide_net(dtype, dev)
        warr, pd = ck.pack_mlp_weights(W, dtype, dev)
        tiers = ck.layer_tiers(pd, "auto", tier)
        args = (warr, pd, y, t8[dtype], 0.01, tol, tol, 1.0)
        kw = dict(f0=fast.mlp_apply(spec, W, y), tiers=tiers)
        out, st = ck.mlp_solve(*args, **kw)
        pkw = _grid_kw(ck.mlp_solve_plain, args, kw)
        (ref, st_ref), plain_ms = _host_call(
            lambda: ck.mlp_solve_plain(*args, **pkw))
        err = float((out - ref).abs().max())
        same = bool(torch.equal(out, ref) and torch.equal(st, st_ref))
        print(f"[18] K2 wide {tier} {dtype}: kernel stats {st.tolist()}, "
              f"plain {st_ref.tolist()}; max |kernel - plain| {err:.3e}; "
              f"bitwise equal to plain: {same}", flush=True)
        if st[3].item() != 0 or not torch.isfinite(out).all():
            raise AssertionError(f"K2 wide {tier} {dtype} failed")
        if (tier == "highest" or dtype == f64) and not same:
            raise AssertionError(f"K2 wide {tier} {dtype} differs from its "
                                 "plain version")
        if tier == "mixed" and dtype == f32 and (
                abs(st[1].item() - st_ref[1].item()) > 1
                or abs(st[2].item() - st_ref[2].item()) > 1 or err > 5e-5):
            raise AssertionError("K2 wide mixed float32 differs from its "
                                 "plain version")
        k2[(tier, dtype)] = (args, kw, st.tolist(), plain_ms, out)
        if dtype == f32:
            k2_plain[tier] = ref
    # Control: float32 'mixed' held against the plain 'highest' fails.
    ctl = _gap(k2[("mixed", f32)][4], k2_plain["highest"])[0]
    print(f"[18] control: K2 wide mixed float32 against the plain highest "
          f"version: {ctl:.3e} (must exceed the bar 5e-5)", flush=True)
    if ctl <= 5e-5:
        raise AssertionError("K2 wide mixed cannot be told from highest")
    for tier in ("highest", "mixed"):
        args, kw, st, plain_ms, _ = k2[(tier, f32)]
        ms = _timed(lambda: ck.mlp_solve(*args, **kw), reps=3)
        rec[f"k2_{tier}"] = (ms, plain_ms, st)
        print(f"[18] {smi}: K2 wide {tier} {ms:.3f} ms/solve vs plain "
              f"{plain_ms:.3f} ms (B={WIDE_B}, float32, nfe {st[0]}, "
              f"{st[1] + st[2]} attempts; {ms / st[0]:.4f} ms an "
              f"evaluation); bound "
              f"{bound(WIDE_B * st[0], 9 * WIDE_B * WIDE_D, tier)}",
              flush=True)
    # 'highest' on the batch route: bitwise the wide route's solve on the
    # same grid (one block a 16-row tile on both: the same samples a block,
    # so the same error sums), and its time against the wide route's.
    args, kw, st, _, _ = k2[("highest", f32)]
    nb = ck.solve_blocks(WIDE_B, dev, ck.TILE_ROWS)
    out, st = ck.mlp_solve(*args, n_blocks=nb, **kw)
    st = st.tolist()
    with _batch_route():
        got, st_b = ck.mlp_solve(*args, n_blocks=nb, **kw)
        ms = _timed(lambda: ck.mlp_solve(*args, **kw), reps=3)
    print(f"[18] {smi}: K2 wide highest on the batch route {ms:.3f} ms/solve"
          f" ({ms / st[0]:.4f} ms an evaluation) against the wide route's "
          f"{rec['k2_highest'][0]:.3f}; bitwise equal to it: "
          f"{torch.equal(got, out)}", flush=True)
    if not (torch.equal(got, out) and st_b.tolist() == st):
        raise AssertionError("K2 highest differs between its routes")
    rec["k2_highest_batch"] = ms

    _at("19")
    # [19] K8 rk4 x 128 at each tier.
    k8, k8_plain = {}, {}
    for tier, dtype, steps in (("highest", f32, 128), ("bf16", f32, 128),
                               ("mixed", f32, 128), ("bf16", f64, 16),
                               ("mixed", f64, 16)):
        W, y = _wide_net(dtype, dev)
        warr, pd = ck.pack_mlp_weights(W, dtype, dev)
        t = torch.tensor([0.0, 2.0], dtype=dtype)
        args = (warr, pd, y, t, uniform_grid(t[0], t[-1], steps), 1.0)
        kw = dict(f0=fast.mlp_apply(spec, W, y), method="rk4",
                  tiers=ck.layer_tiers(pd, "auto", tier))
        out, st = cf.mlp_solve_fixed(*args, **kw)
        torch.cuda.synchronize()
        print(f"[19] K8 wide rk4 x {steps} {tier} {dtype}: stats "
              f"{st.tolist()}"
              + (f"; {_k8_layout(WIDE_B, ck.ROUTE_WIDE)}"
                 if tier == "highest" else "; the batch route (K4)")
              + "; its plain version holds it in [50]", flush=True)
        if st[3].item() != 0 or not torch.isfinite(out).all():
            raise AssertionError(f"K8 wide {tier} {dtype} failed")
        exact = dtype == f64 or tier == "highest"

        # Held in [50]'s workers: bitwise (float64, 'highest') or within
        # SOLVE_BARS, the stats identical; float32 keeps the plain result
        # for the controls below.
        def k8_done(err, plain_ms, ref=None, tier=tier, dtype=dtype):
            if dtype == f32:
                k8_plain[tier] = ref[0]
                ms_, _, st_ = rec[f"k8_{tier}"]
                rec[f"k8_{tier}"] = (ms_, plain_ms, st_)
        _LATER.add((args, kw, (out, st)), cf.mlp_solve_fixed_plain,
                   f"[19] K8 wide rk4 x {steps} {tier} {dtype} (held in "
                   "[50])", k8_done, bar=None if exact else SOLVE_BARS[tier],
                   keep=dtype == f32)
        if dtype == f32:
            k8[tier] = (args, kw, st.tolist(), None, out)

    # Controls. Over 128 steps the order noise of 'bf16' adds up to about
    # a third of the 'bf16' - 'mixed' gap (9e-4 in a CPU model), so a
    # solve tells 'bf16' from 'highest' only; K4's one-evaluation check
    # below tells it from 'mixed'. Run once [50] has the plain results.
    def k8_controls():
        for tier, others in (("mixed", ("highest", "bf16")),
                             ("bf16", ("highest",))):
            got = k8[tier][4].cpu()
            _held("K8 wide rk4 x 128", tier, got,
                  {o: k8_plain[o] for o in (tier,) + others},
                  lambda g, tier=tier: g[0] <= SOLVE_BARS[tier])
            print(f"[19] controls (in [50]): K8 wide {tier} against the "
                  "plain " + ", ".join(
                      f"{o} version {_gap(got, k8_plain[o])[0]:.3e}"
                      for o in others)
                  + f" (each must exceed the bar {SOLVE_BARS[tier]})",
                  flush=True)
    _LATER.after(k8_controls)
    for tier in ("highest", "bf16", "mixed"):
        args, kw, st, _, _ = k8[tier]
        ms = _timed(lambda: cf.mlp_solve_fixed(*args, **kw), reps=3)
        rec[f"k8_{tier}"] = (ms, None, st)
        print(f"[19] {smi}: K8 wide rk4 x 128 {tier} {ms:.3f} ms/solve "
              f"(B={WIDE_B}, float32, nfe {st[0]}; "
              f"{ms / st[0]:.4f} ms an evaluation; the plain version timed "
              f"in [50]); bound "
              f"{bound(WIDE_B * st[0], 3 * WIDE_B * WIDE_D, tier)}",
              flush=True)
    args, kw, st, _, out = k8["highest"]
    with _batch_route():
        got = cf.mlp_solve_fixed(*args, **kw)[0]
        ms = _timed(lambda: cf.mlp_solve_fixed(*args, **kw), reps=3)
    print(f"[19] {smi}: K8 wide rk4 x 128 highest on the batch route "
          f"{ms:.3f} ms/solve ({ms / st[0]:.4f} ms an evaluation) against "
          f"the wide route's {rec['k8_highest'][0]:.3f}; bitwise equal to "
          f"it: {torch.equal(got, out)}", flush=True)
    if not torch.equal(got, out):
        raise AssertionError("K8 highest differs between its routes")
    rec["k8_highest_batch"] = ms

    # The slice through the public entry point.
    W, y = _wide_net(f32, dev)
    runs = []
    ck.reset_launch_counts()
    cf.reset_launch_counts()
    for tier, method in (("highest", "dopri5"), ("mixed", "dopri5"),
                         ("highest", "rk4"), ("bf16", "rk4"),
                         ("mixed", "rk4")):
        s_ = fast.MLPSpec(activation="tanh", matmul="auto",
                          dot_precision=tier)
        kw = (dict(rtol=tol, atol=tol, first_step=0.01) if method == "dopri5"
              else dict(method="rk4", num_steps=128))
        tt = t8[f32] if method == "dopri5" else torch.tensor([0.0, 2.0])
        runs.append((tier, method, fast.solve_mlp_spec(s_, W, y, tt, **kw)))
    torch.cuda.synchronize()
    launches = {"mlp_solve": ck.mlp_solve_launches,
                "mlp_solve_fixed": cf.mlp_solve_fixed_launches,
                "dot_tiers": ck.dot_tier_launches}
    for tier, method, res in runs:
        print(f"[19] fast.solve_mlp_spec({method}, {tier}) wide: stats "
              f"{res.stats}", flush=True)
        if res.stats.status != 0 or not torch.isfinite(res.ys).all():
            raise AssertionError(f"the wide {method} {tier} solve failed")
    gap_mixed = float((runs[1][2].ys - runs[0][2].ys).abs().max())
    gap_bf16 = float((runs[3][2].ys[-1] - runs[2][2].ys[-1]).abs().max())
    print(f"[19] launches in the wide slice: {launches}; max |mixed - "
          f"highest| (dopri5) {gap_mixed:.3e}, |bf16 - highest| (rk4) "
          f"{gap_bf16:.3e}", flush=True)
    if launches != {"mlp_solve": 2, "mlp_solve_fixed": 3, "dot_tiers": 3}:
        raise AssertionError(f"wide slice launches {launches}")
    rec["k4_launches"] = launches["dot_tiers"]

    # K4 alone: one evaluation of the net at B = 1024 (`tier_net`), each
    # tier against its plain version and a float64 product of the float32
    # weights; the other tiers' plain versions as controls.
    x = y
    f_exact = fast.mlp_apply(spec, [(a.double(), b.double()) for a, b in W],
                             x.double())
    warr, pd = ck.pack_mlp_weights(W, f32, dev)
    tiers = {tier: ck.layer_tiers(pd, "auto", tier)
             for tier in ("highest", "mixed", "bf16")}
    plains = {tier: ck._net_plain(warr, pd, "tanh", "identity", 1, False,
                                  tt)(0.0, x) for tier, tt in tiers.items()}
    k4_err, k4_ms = 0.0, {}
    for tier, tt in tiers.items():
        got = ck.tier_net(warr, pd, x, tiers=tt)
        torch.cuda.synchronize()
        bar = EVAL_BARS[tier]
        mx, mean = _held("K4 one evaluation", tier, got, plains,
                         lambda g, bar=bar: g[0] <= bar[0] and g[1] <= bar[1])
        k4_ms[tier] = _timed(lambda: ck.tier_net(warr, pd, x, tiers=tt),
                             reps=5, inner=10)
        print(f"[19] K4 one evaluation at B={WIDE_B}, {tier}: |kernel - "
              f"plain| largest {mx:.3e}, mean {mean:.3e} (bars {bar}); "
              f"against the other tiers' plain versions (largest, mean) "
              + ", ".join(f"{o} {_gap(got, r)}" for o, r in plains.items()
                          if o != tier)
              + f"; max |kernel - float64 product| "
              f"{float((got.double() - f_exact).abs().max()):.3e} (plain "
              f"{float((plains[tier].double() - f_exact).abs().max()):.3e});"
              f" {smi}: {k4_ms[tier]:.4f} ms", flush=True)
        if tier != "highest":
            k4_err = max(k4_err, mx)
    rec["k4_err"], rec["k4_ms"] = k4_err, k4_ms["mixed"]
    # K4's two launches apart, at each reduced tier: the bf16 weight pack
    # alone, then the evaluation alone on the packed workspace (the solves
    # pack once and evaluate many times); and float64, bitwise.
    out_k4, work_k4 = torch.empty_like(x), ck.tier_net_work(pd, x)
    k4_parts = {}
    for tier in ("mixed", "bf16"):
        def part(mode, tt=tiers[tier]):
            ck.tier_net_parts(warr, pd, x, 0.0, out_k4, work_k4, tiers=tt,
                              mode=mode)
        k4_parts[tier] = (_device_ms(lambda: part(1)),
                          _device_ms(lambda: part(2)),
                          _device_ms(lambda: part(0)))
        if not torch.equal(out_k4, ck.tier_net(warr, pd, x,
                                               tiers=tiers[tier])):
            raise AssertionError(f"K4 {tier}: the evaluation alone differs "
                                 "from tier_net")
    W64 = [(a.double(), b.double()) for a, b in W]
    warr64, pd64 = ck.pack_mlp_weights(W64, f64, dev)
    for tier in ("mixed", "bf16"):
        tt = ck.layer_tiers(pd64, "auto", tier)
        got = ck.tier_net(warr64, pd64, x.double(), tiers=tt)
        ref = ck._net_plain(warr64, pd64, "tanh", "identity", 1, False,
                            tt)(0.0, x.double())
        print(f"[19] K4 float64 {tier}: bitwise equal to plain "
              f"{torch.equal(got, ref)}", flush=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"K4 float64 {tier} differs from its plain "
                                 "version")
    rec["k4_parts"] = k4_parts
    # The new kernel's registers and static shared memory (-Xptxas -v), and
    # its tiles' dynamic shared memory (csrc/dot_tiers.cuh tier_tile for 8
    # warps and 16 rows a block: 16-row tiles, 256-output chunks).
    log = _build.build_log().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and "tier_net_kernel" in line:
            for more in log[i:i + 4]:
                if "Compiling entry" in more or "Used" in more \
                        or "spill" in more:
                    print("[19] ptxas: " + more.strip(), flush=True)
    ldf = ck._pad16(max(w for dd in pd for w in dd)) + 8
    print(f"[19] K4 tile: {2 * 16 * ldf * 4 + 2 * 256 * 72 * 2} bytes of "
          "dynamic shared memory a block (two 16-row float regions and "
          "two 256 x 64 bf16 weight slices)", flush=True)
    h16 = torch.tensor(np.random.RandomState(3).randn(WIDE_B, WIDE_H),
                       dtype=torch.bfloat16, device=dev)
    ws16 = [w.to(torch.bfloat16) for w, _ in W]
    xs16 = [x.to(torch.bfloat16), h16, h16]
    rec["k4_library_host_ms"] = _timed(
        lambda: [torch.matmul(a, w) for a, w in zip(xs16, ws16)], reps=5,
        inner=20)
    rec["k4_library_ms"] = _device_ms(
        lambda: [torch.matmul(a, w) for a, w in zip(xs16, ws16)])
    lib_layer = _timed(lambda: torch.matmul(h16, ws16[1]), reps=5, inner=20)
    net_plain = ck._net_plain(warr, pd, "tanh", "identity", 1, False,
                              tiers["mixed"])
    rec["k4_plain_ms"] = _timed(lambda: net_plain(0.0, x), reps=3)
    # Two bf16 passes of a multiply and an add a weight and sample; the
    # float32 weights and states read once, the outputs written once.
    n_w = sum(i * o + o for i, o in dims)
    rec["k4_bound"] = _bound(2 * 2 * WIDE_B * n_mac,
                             4 * (n_w + 2 * WIDE_B * WIDE_D),
                             peak=_peaks().PEAK_BF16_TENSOR)
    print(f"[19] {smi}: K4 alone ('mixed', `tier_net`: the bf16 weight pack "
          f"and one evaluation at B={WIDE_B}) {rec['k4_ms']:.4f} ms (bound "
          f"{rec['k4_bound'][0]:.5f} ms at the bf16 tensor-core peak; "
          f"'bf16' {k4_ms['bf16']:.4f}, 'highest' on the CUDA cores "
          f"{k4_ms['highest']:.4f}) vs plain {rec['k4_plain_ms']:.3f} ms; "
          f"torch.matmul of the bf16 operands (bf16 output) "
          f"{rec['k4_library_host_ms']:.4f} ms for the three layers, "
          f"{lib_layer:.4f} ms for the 256 x 256 layer", flush=True)
    for tier, (pack_ms, eval_ms, both_ms) in k4_parts.items():
        print(f"[19] {smi}: K4 {tier!r} device time (`_device_ms`): the bf16 "
              f"weight pack {pack_ms:.4f} ms, the evaluation alone "
              f"{eval_ms:.4f} ms, both {both_ms:.4f} ms (host-clocked "
              f"`tier_net` {k4_ms[tier]:.4f} ms) vs torch.matmul's device "
              f"time {rec['k4_library_ms']:.4f} ms (host-clocked "
              f"{rec['k4_library_host_ms']:.4f}); bound "
              f"{rec['k4_bound'][0] / (2 if tier == 'bf16' else 1):.5f} ms",
              flush=True)
    rec["k4_device_ms"] = k4_parts["mixed"][2]

    _at("20")
    # [20] wide training, and K5, K6, K9 at width 256, B = 256.
    Bt = 256
    W, y = _wide_net(f32, dev, B=Bt)
    target = torch.tensor(np.random.RandomState(2).randn(8, Bt, WIDE_D) * 0.5,
                          dtype=f32, device=dev)
    for tier in ("highest", "mixed"):
        Wt = [(a.clone().requires_grad_(), b.clone().requires_grad_())
              for a, b in W]
        s_ = fast.MLPSpec(activation="tanh", dot_precision=tier)
        ck.reset_launch_counts()
        ca.reset_launch_counts()

        def sgd():
            ys, st = fast.odeint_adjoint_mlp(s_, Wt, y, t8[f32], rtol=tol,
                                             atol=tol, first_step=0.01,
                                             return_stats=True)
            torch.mean((ys - target) ** 2).backward()
            with torch.no_grad():
                for q in (q for pair in Wt for q in pair):
                    if not torch.isfinite(q.grad).all():
                        raise AssertionError("non-finite wide gradient")
                    q -= SGD_LR * q.grad
            return st

        step_ms, _ = _host_ms(sgd, reps=1)
        got = {"mlp_solve": ck.mlp_solve_launches,
               "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches,
               "dot_tiers": ck.dot_tier_launches}
        print(f"[20] {smi}: wide SGD step, {tier} forward (K2 + K3 wide, "
              f"B={Bt}, float32) {step_ms:.3f} ms; launches {got}",
              flush=True)
        if got != {"mlp_solve": 1, "mlp_adjoint_solve": 1,
                   "dot_tiers": int(tier == "mixed")}:
            raise AssertionError(f"wide training launches {got}")
        rec[f"train_{tier}"] = step_ms
    warr, pd = ck.pack_mlp_weights(W, f32, dev)
    t4 = torch.linspace(0.0, 1.0, 4)
    f0 = fast.mlp_apply(spec, W, y)
    ys = fast.solve_mlp_spec(spec, W, y, t4, rtol=1e-5, atol=1e-5).ys
    g = (2.0 * (ys - target[:4]) / ys.numel()).contiguous()
    cases = {
        "K5": (cp.mlp_solve_perlane, cp.mlp_solve_perlane_plain,
               (warr, pd, y, t4, 0.05, 1e-5, 1e-5, 1.0), dict(f0=f0)),
        "K6": (cp.mlp_perlane_adjoint_solve,
               cp.mlp_perlane_adjoint_solve_plain,
               (warr, pd, ys.contiguous(), g, t4, 0.05, 1e-5, 1e-5, 1.0),
               {}),
        "K9": (cf.mlp_adjoint_solve_fixed, cf.mlp_adjoint_solve_fixed_plain,
               (warr, pd, ys.contiguous(), g, t4, 1.0), dict(num_steps=2)),
        "K3": (ca.mlp_adjoint_solve, ca.mlp_adjoint_solve_plain,
               (warr, pd, ys.contiguous(), g, t4, 0.05, 1e-5, 1e-5, 1.0),
               {}),
    }
    for name, (fn, plain, args, kw) in cases.items():
        got = fn(*args, **kw)
        pkw = _grid_kw(plain, args, kw)
        ref, plain_ms = _host_call(lambda: plain(*args, **pkw))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        counts = [a for a in got if not a.is_floating_point()]
        counts_ref = [a for a in ref if not a.is_floating_point()]
        rels = [_rel(a, b) for a, b in zip(got, ref) if a.is_floating_point()]
        ms = _timed(lambda: fn(*args, **kw), reps=2)
        rec[f"{name}_wide"] = ms
        nfe = counts[0][0].item() * (Bt if name in ("K3", "K9") else 1)
        print(f"[20] {smi}: {name} wide (width 256, B={Bt}, float32) "
              f"{ms:.3f} ms vs plain {plain_ms:.3f} ms; stats "
              f"{counts[0].tolist()}; max relative |kernel - plain| "
              f"{max(rels):.3e}; bitwise equal to plain: {same}; bound "
              f"{bound(nfe, 9 * Bt * WIDE_D, per=1 if name == 'K5' else 3)}"
              + (f"; {_k6_layout(Bt)}" if name == "K6" else "")
              + (f"; {_k9_layout(Bt)}" if name == "K9" else "")
              + (f"; {_k5_layout(Bt, ck.ROUTE_WIDE)}" if name == "K5"
                 else ""),
              flush=True)
        if any(not torch.equal(a, b) for a, b in zip(counts, counts_ref)) \
                or max(rels) > 1e-5 or counts[0][3].item() != 0 \
                or not same:
            raise AssertionError(f"{name} wide differs from its plain "
                                 "version")

    _at("21")
    # [21] calibration on the wide configuration.
    W, y = _wide_net(f32, dev)
    picked = fast.calibrate_dot_precision(spec, W, y, t8[f32], rtol=tol,
                                          atol=tol, first_step=0.01)
    nfes = {tier: fast.solve_mlp_spec(
        fast.MLPSpec(activation="tanh", dot_precision=tier), W, y, t8[f32],
        rtol=tol, atol=tol, first_step=0.01).stats.nfe
        for tier in ("highest", "mixed", "bf16")}
    print(f"[21] calibrate_dot_precision on the wide net (dopri5, rtol = "
          f"atol = {tol}): picks {picked.dot_precision!r}; nfe {nfes}; cost "
          f"(nfe x DOT_PASSES) "
          f"{ {k: v * fast.DOT_PASSES[k] for k, v in nfes.items()} }",
          flush=True)
    return rec


#: BASELINE.md:83 and :114: the 2-D flow 3 -> 32 -> 32 -> 2 (tanh), 4096
#: points, t = [1, 0], dopri5 at rtol 1e-5, atol 1e-7.
CNF_D, CNF_H, CNF_B, CNF_RTOL, CNF_ATOL = 2, 32, 4096, 1e-5, 1e-7


def _cnf_pass_flops(dims) -> int:
    """One forward-mode pass of K7 for one sample (`cnf_eval`,
    `cnf_aug_eval` in csrc/cnf_net.cuh): act' times the seeded column on
    the first layer's outputs, then on each later hidden layer a multiply
    and an add a weight with the multiply by act' (2 din an output), and the
    one output of the last layer that enters the trace (2 din - 1)."""
    if len(dims) == 1:
        return 0
    return (dims[0][1] + sum(2 * i * o for i, o in dims[1:-1])
            + 2 * dims[-1][0] - 1)


def _cnf_eval_flops(dims) -> int:
    """One K7 forward evaluation for one sample, as `cnf_eval` does it: the
    flow (a multiply and an add a weight with the bias, 2 din an output;
    the activation and act' on a hidden output, 3), the D passes, the
    divergence's D - 1 adds and its sign."""
    D = dims[-1][1]
    n_hid = sum(o for _, o in dims[:-1])
    return (sum(2 * i * o for i, o in dims) + 3 * n_hid
            + D * _cnf_pass_flops(dims) + D)


def _cnf_stage_flops(dims) -> int:
    """One K7 adjoint stage for one sample, as `cnf_aug_eval` and
    `cnf_weight_x` (csrc/cnf_net.cuh) do it: the flow with act' and act''
    (5 a hidden output) and -sf F; the D passes; part A's VJP (a multiply
    and an add a weight, 2 dout - 1 an input, and act' on a hidden layer's
    inputs); part B's D reverse passes (the products past the first layer,
    3 a hidden output for x and zbar, and zbar's adds over the passes); the
    delta injection (the hidden layers' products and the deltas' adds); v_y
    and v_t (3 D + 3); and the sample's share of each batch sum, the
    kernel's own arithmetic in `cnf_weight_x`: a weight past the first
    layer takes the D direct products (2 D - 1; on the first layer the
    direct term is a read), a hidden layer's delta term 2, dz h minus those
    2 and the sum's add 1 (2 D + 4 on a hidden layer past the first); a
    bias dz minus its delta on a hidden layer, and the add."""
    L, D = len(dims), dims[-1][1]
    hid = dims[:-1]
    n_mac = sum(i * o for i, o in dims)
    n_hid = sum(o for _, o in hid)
    forward = 2 * n_mac + 5 * n_hid + D
    passes = D * _cnf_pass_flops(dims) + D
    part_a = 2 * n_mac - dims[0][0]
    part_b = (D * (sum(i * (2 * o - 1) for i, o in dims[1:]) + 3 * n_hid)
              + (D - 1) * n_hid)
    delta = (sum(i * (2 * o - 1) for i, o in hid)
             + sum(i for i, _ in hid[1:]) + n_hid - (hid[-1][1] if hid else 0))
    sums = sum(i * o * ((2 * D - 1 if l else 0) + 2 * (l < L - 1) + 3)
               + o * (1 + (l < L - 1)) for l, (i, o) in enumerate(dims))
    return forward + passes + part_a + part_b + delta + 3 * D + 3 + sums


def _cnf_layout(what: str, call, lay) -> dict:
    """Print the grouped walk that a recorded K2 or K3 launch with K7
    reported (ops/cuda_kernels.last_solve_layout,
    ops/cuda_adjoint.last_adjoint_layout, read right after it): its
    blocks, samples a round (slots), threads a sample, a slot's values and,
    for K3, where the rows of its batch sums sit."""
    args = call[0]
    dims, x = args[1], args[2]
    if not lay or not lay["slots"]:
        raise AssertionError(f"{what}: the launch reported no grouped walk")
    rows = ""
    if "rows_in_shared_memory" in lay:
        rows = ", rows in " + ("the block's shared memory"
                               if lay["rows_in_shared_memory"]
                               else "the workspace")
    print(f"{what} ({x.dtype}, B = {x.shape[-2]}, flow {dims}): "
          f"{lay['blocks']} blocks of 512 threads, {lay['slots']} samples a "
          f"round, {lay['threads_a_sample']} threads a sample, "
          f"{lay['slot_values']} values a slot{rows} (as the launch "
          "reported)", flush=True)
    return lay


def _cnf_tier(smi: str, dev) -> dict:
    """Phases 22-24: the CNF path (K7 in K2 and K3). Returns the numbers
    that the kernel records take."""
    import torch
    from tfdiffeq_tpu_torch import NFEMeter, fast
    from tfdiffeq_tpu_torch.examples import cnf as cnf_example
    from tfdiffeq_tpu_torch.models import cnf as mcnf
    from tfdiffeq_tpu_torch.ops import cuda_adjoint as ca, cuda_kernels as ck
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5
    f32, f64 = torch.float32, torch.float64
    D, B = CNF_D, CNF_B
    rec = {}
    flow = mcnf.CNFDynamics(D, CNF_H, 3, device=dev,
                            generator=torch.Generator().manual_seed(0))
    x_np = cnf_example.two_moons(B, np.random.RandomState(0))
    W32 = [(w.detach(), b.detach()) for w, b in fast.weights_from_linears(flow)]
    dims = tuple((w.shape[0], w.shape[1]) for w, _ in W32)

    _at("22")
    # [22] K7's forward in K2: the launch that fast.cnf_log_prob_fused makes,
    # held against its plain version on its own inputs.
    k2 = {}
    for dtype in (f32, f64):
        W = [(w.to(dtype), b.to(dtype)) for w, b in W32]
        x = torch.tensor(x_np, dtype=dtype, device=dev)
        ck.reset_launch_counts()
        with _Recording(fast, "mlp_solve") as k2_rec:
            lp, st = fast.cnf_log_prob_fused(W, x, rtol=CNF_RTOL,
                                             atol=CNF_ATOL)
        torch.cuda.synchronize()
        fwd_launches = {"mlp_solve": ck.mlp_solve_launches,
                        "cnf_solve": ck.cnf_solve_launches}
        print(f"[22] fast.cnf_log_prob_fused {dtype}, B = {B}, flow {dims}: "
              f"stats {st}, launches {fwd_launches}", flush=True)
        if fwd_launches != {"mlp_solve": 1, "cnf_solve": 1} \
                or len(k2_rec.calls) != 1 or st.status != 0 \
                or lp.shape != (B,) or not torch.isfinite(lp).all():
            raise AssertionError(f"cnf_log_prob_fused {dtype} launches "
                                 f"{fwd_launches}, stats {st}")
        k2[dtype] = call = k2_rec.calls[0]
        rec["fwd_layout"] = _cnf_layout("[22] K7 forward in K2", call,
                                        ck.last_solve_layout)
        err, plain_ms = _hold_to_plain(
            call, ck.mlp_solve_plain, f"[22] K7 forward (K2 rhs='cnf') {dtype}")
        args, kw, got = call
        if not all(torch.equal(a, b) for a, b in
                   zip(got, ck.mlp_solve(*args, **kw))):
            raise AssertionError(f"K7 forward {dtype}: two kernel runs differ")
        if dtype == f32:
            rec["fwd_err"], rec["fwd_plain_ms"] = err, plain_ms
            lp32 = lp
    # The public entry point against the generic engine's exact trace.
    W, x = W32, torch.tensor(x_np, device=dev)
    with torch.no_grad():
        lp_g = mcnf.log_prob(flow, x, rtol=CNF_RTOL, atol=CNF_ATOL,
                             trace="exact")
    gap = float((lp32 - lp_g).abs().max())
    print(f"[22] two kernel runs bitwise equal; max |fused - generic "
          f"log_prob(trace='exact')| {gap:.3e} (bar 1e-4)", flush=True)
    if gap > 1e-4:
        raise AssertionError("cnf_log_prob_fused differs from the generic "
                             "log_prob")
    args, kw, _ = k2[f32]
    fwd_ms = _timed(lambda: ck.mlp_solve(*args, **kw))
    fused_ms = _timed(lambda: fast.cnf_log_prob_fused(
        W, x, rtol=CNF_RTOL, atol=CNF_ATOL), reps=3)
    with torch.no_grad():
        gen_ms = _timed(lambda: mcnf.log_prob(flow, x, rtol=CNF_RTOL,
                                              atol=CNF_ATOL), reps=3)
    nfe, acc, rej, _ = k2[f32][2][1].tolist()
    n_w = sum(i * o + o for i, o in dims)
    rec["fwd_bound"] = _bound(
        B * (nfe * _cnf_eval_flops(dims)
             + (acc + rej) * (D + 1) * _combine_flops(DOPRI5)),
        4 * (2 * 2 * B * (D + 1) + n_w + 2))
    rec.update(fwd_ms=fwd_ms, fwd_generic_ms=gen_ms)
    print(f"[22] {smi}: K7 forward in K2 {fwd_ms:.3f} ms a density solve "
          f"(B = {B}, float32, nfe {nfe}, {acc + rej} attempts) vs plain "
          f"{rec['fwd_plain_ms']:.3f} ms; fast.cnf_log_prob_fused "
          f"{fused_ms:.3f} ms (with f0 and the first step); generic "
          f"log_prob(trace='exact') {gen_ms:.3f} ms; bound "
          f"{rec['fwd_bound'][0]:.4f} ms ({rec['fwd_bound'][1]}, "
          f"{_cnf_eval_flops(dims)} operations an evaluation)", flush=True)

    _at("23")
    # [23] K7's adjoint in K3 on [22]'s trajectory, g = d(-mean log p)/dout.
    k3_args = {}
    for dtype in (f64, f32):
        packed, out = k2[dtype][0][0], k2[dtype][2][0]
        g = torch.zeros_like(out)
        g[-1, :, :D] = out[-1, :, :D] / B
        g[-1, :, D] = 1.0 / B
        args = (packed, dims, out.contiguous(), g,
                torch.tensor([-1.0, 0.0], dtype=dtype), 0.1, CNF_RTOL,
                CNF_ATOL, -1.0)
        kw = dict(activation="tanh", rhs="cnf")
        k3_args[dtype] = (args, kw)
        ca.reset_launch_counts()
        got = ca.mlp_adjoint_solve(*args, **kw)
        torch.cuda.synchronize()
        sweep_launches = ca.cnf_adjoint_launches
        rec["adj_layout"] = _cnf_layout("[23] K7 adjoint in K3",
                                        (args, kw, got),
                                        ca.last_adjoint_layout)
        err, plain_ms = _hold_to_plain(
            (args, kw, got), ca.mlp_adjoint_solve_plain,
            f"[23] K7 adjoint (K3 rhs='cnf') {dtype}, B = {B}")
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(got, ca.mlp_adjoint_solve(*args, **kw)))
        print(f"[23] two kernel runs bitwise equal: {bitwise}; K3 launches "
              f"{sweep_launches}", flush=True)
        if not bitwise or got[3][3].item() != 0 or sweep_launches != 1 \
                or not all(torch.isfinite(v).all() for v in got[:3]):
            raise AssertionError(f"K7 adjoint {dtype} failed")
        if dtype == f32:
            rec.update(adj_err=err, adj_plain_ms=plain_ms,
                       adj_stats=got[3].tolist())
    args, kw = k3_args[f32]
    adj_ms = _timed(lambda: ca.mlp_adjoint_solve(*args, **kw), reps=3)
    nfe_b = rec["adj_stats"][0]
    rec["adj_bound"] = _bound(B * nfe_b * _cnf_stage_flops(dims),
                              4 * (2 * 2 * B * (D + 1) + B * (D + 1)
                                   + 2 * n_w + 2))
    rec["adj_ms"] = adj_ms
    print(f"[23] {smi}: K7 adjoint in K3 {adj_ms:.3f} ms a sweep (B = {B}, "
          f"float32, {nfe_b} stages, {rec['adj_stats'][1]} accepted) vs plain "
          f"{rec['adj_plain_ms']:.3f} ms; bound {rec['adj_bound'][0]:.4f} ms "
          f"({rec['adj_bound'][1]}, {_cnf_stage_flops(dims)} operations a "
          f"sample and stage)", flush=True)

    # A training step at B = 4096 (two chunks of 2048) against autograd
    # through the generic engine. The first step's launches are recorded,
    # and its first chunk's K2 and K3 held to their plain versions.
    b_max = fast.cnf_train_block_size(D, [o for _, o in dims])
    Wg = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for w, b in W32]
    meter = NFEMeter()

    def fused_step():
        loss = -torch.mean(fast.cnf_log_prob_train(
            Wg, x, rtol=CNF_RTOL, atol=CNF_ATOL, nfe_meter=meter))
        loss.backward()
        return loss

    for mod in (ck, ca):
        mod.reset_launch_counts()
    with _Recording(fast, "mlp_solve") as t_k2, \
            _Recording(fast, "mlp_adjoint_solve") as t_k3:
        fused_step()
    torch.cuda.synchronize()
    train_launches = {"mlp_solve": ck.mlp_solve_launches,
                      "cnf_solve": ck.cnf_solve_launches,
                      "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches,
                      "cnf_adjoint": ca.cnf_adjoint_launches}
    fused_g = [v.grad.clone() for pair in Wg for v in pair]
    f_nfe, b_nfe = meter.f_nfe, meter.b_nfe
    if train_launches != {"mlp_solve": 2, "cnf_solve": 2,
                          "mlp_adjoint_solve": 2, "cnf_adjoint": 2} \
            or len(t_k2.calls) != 2 or len(t_k3.calls) != 2:
        raise AssertionError(f"training launches {train_launches}")
    chunk = t_k2.calls[0][0][2].shape[0]
    _cnf_layout("[23] training step's last K2", t_k2.calls[-1],
                ck.last_solve_layout)
    _cnf_layout("[23] training step's last K3", t_k3.calls[-1],
                ca.last_adjoint_layout)
    errs = [_hold_to_plain(t_k2.calls[0], ck.mlp_solve_plain,
                           f"[23] training step, chunk 1 of 2 ({chunk} "
                           "samples): K2 with K7")[0],
            _hold_to_plain(t_k3.calls[0], ca.mlp_adjoint_solve_plain,
                           f"[23] training step, chunk 1 of 2 ({chunk} "
                           "samples): K3 with K7")[0]]
    gflow = mcnf.CNFDynamics(D, CNF_H, 3, device=dev)
    with torch.no_grad():
        for layer, (w, b) in zip(gflow.layers, W32):
            layer.weight.copy_(w.t())
            layer.bias.copy_(b)

    def generic_step():
        loss = -torch.mean(mcnf.log_prob(gflow, x, rtol=CNF_RTOL,
                                         atol=CNF_ATOL))
        loss.backward()

    generic_step()
    gen_g = [v.clone() for layer in gflow.layers
             for v in (layer.weight.grad.t(), layer.bias.grad)]
    gap = max(_rel(a, b) for a, b in zip(fused_g, gen_g))
    print(f"[23] cnf_log_prob_train step at B = {B} (chunks of {b_max}): "
          f"launches {train_launches}; NFE forward {f_nfe}, backward "
          f"{b_nfe}; gradients against autograd through the generic "
          f"log_prob {gap:.3e} relative (bar 1e-3)", flush=True)
    if gap > 1e-3 or not all(torch.isfinite(v).all() for v in fused_g):
        raise AssertionError("fused CNF gradients differ from the generic")
    # Both steps timed warm: after the checked step, the median of three.
    train_ms, train_all = _host_ms(fused_step)
    gen_train_ms, gen_all = _host_ms(generic_step)
    print(f"[23] {smi}: training step {train_ms:.3f} ms (K2 + K3 a chunk; "
          f"{', '.join(f'{v:.3f}' for v in train_all)}) vs generic engine + "
          f"autograd {gen_train_ms:.3f} ms "
          f"({', '.join(f'{v:.3f}' for v in gen_all)}); host clock, median "
          "of 3 after a first step", flush=True)
    rec.update(gen_train_ms=gen_train_ms, train_ms=train_ms)

    _at("24")
    # [24] the example: Adam steps of examples/cnf.py --fused. The first
    # step's launches are recorded and held to their plain versions, then
    # three more are timed.
    eargs = cnf_example.parse_args(["--fused", "--device", "cuda"])
    rng = np.random.RandomState(eargs.seed)
    eflow = mcnf.CNFDynamics(D, eargs.hidden, device=dev,
                             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(eflow.parameters(), lr=eargs.lr)
    emeter = NFEMeter()
    nll = cnf_example.make_nll(eargs, eflow, nfe_meter=emeter)
    losses = []

    def adam_step():
        xb = torch.tensor(cnf_example.two_moons(eargs.batch_size, rng),
                          device=dev)
        opt.zero_grad(set_to_none=True)
        loss = nll(xb)
        loss.backward()
        for q in eflow.parameters():
            if not torch.isfinite(q.grad).all():
                raise AssertionError("non-finite CNF gradient (a failed "
                                     "backward sweep)")
        opt.step()
        losses.append(float(loss.detach()))

    for mod in (ck, ca):
        mod.reset_launch_counts()
    with _Recording(fast, "mlp_solve") as e_k2, \
            _Recording(fast, "mlp_adjoint_solve") as e_k3:
        adam_step()
    e_lay = ck.last_solve_layout, ca.last_adjoint_layout
    ex_ms, ex_all = _host_ms(adam_step, reps=TRAIN_STEPS)
    ex_launches = {"cnf_solve": ck.cnf_solve_launches,
                   "cnf_adjoint": ca.cnf_adjoint_launches}
    steps = TRAIN_STEPS + 1
    print(f"[24] examples/cnf.py --fused x{steps} (B = "
          f"{eargs.batch_size}, hidden {eargs.hidden}): launches "
          f"{ex_launches}; NLL {', '.join(f'{v:.4f}' for v in losses)}; NFE "
          f"forward {emeter.f_nfe}, backward {emeter.b_nfe}", flush=True)
    print(f"[24] {smi}: CNF example step {ex_ms:.3f} ms median of "
          f"{TRAIN_STEPS} after the first "
          f"({', '.join(f'{v:.3f}' for v in ex_all)})", flush=True)
    if ex_launches != {"cnf_solve": steps, "cnf_adjoint": steps} \
            or len(e_k2.calls) != 1 or len(e_k3.calls) != 1:
        raise AssertionError(f"CNF example launches {ex_launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"CNF example losses {losses}")
    _cnf_layout("[24] example, K2", e_k2.calls[0], e_lay[0])
    _cnf_layout("[24] example, K3", e_k3.calls[0], e_lay[1])
    errs += [_hold_to_plain(e_k2.calls[0], ck.mlp_solve_plain,
                            f"[24] first step's K2 with K7 (B = "
                            f"{eargs.batch_size}, hidden {eargs.hidden})")[0],
             _hold_to_plain(e_k3.calls[0], ca.mlp_adjoint_solve_plain,
                            f"[24] first step's K3 with K7 (B = "
                            f"{eargs.batch_size}, hidden {eargs.hidden})")[0]]
    rec["fwd_err"] = max(rec["fwd_err"], errs[0], errs[2])
    rec["adj_err"] = max(rec["adj_err"], errs[1], errs[3])
    ck.reset_launch_counts()
    ew = [(m.weight.detach().t().contiguous(), m.bias.detach())
          for m in eflow.layers]
    xs = fast.cnf_sample_fused(ew, torch.Generator(device=dev).manual_seed(1),
                               1000, D, rtol=eargs.rtol, atol=eargs.atol)
    torch.cuda.synchronize()
    print(f"[24] cnf_sample_fused of 1000: launches {ck.mlp_solve_launches} "
          f"K2 (the concat-t MLP, no K7: {ck.cnf_solve_launches}); mean "
          f"{xs.mean(0).tolist()}, std {xs.std(0).tolist()}", flush=True)
    if ck.mlp_solve_launches != 1 or xs.shape != (1000, D) \
            or not torch.isfinite(xs).all():
        raise AssertionError("cnf_sample_fused failed")
    rec.update(ex_ms=ex_ms, ex_launches=ex_launches)
    return rec


ADAMS_STEPS = 512        # bench.py:205's fixed-step budget


def _adams_step_flops(max_order: int, max_iters: int, implicit: bool) -> int:
    """K10's combines for one state element of an Adams step: the
    predictor (a multiply and an add a history row, then y0 + dt acc), the
    Kahan update and the Hermite coefficients (12); fixed_adams adds the
    history part and, each corrector iteration, y_next (4), the scale (5)
    and the norm's term (4)."""
    fl = 2 * max_order + 2 + 12
    if implicit:
        fl += 2 * (max_order - 1) + 13 * max_iters
    return fl


def _vcabm_attempt_flops(order: int) -> int:
    """K11's phi work for one state element of an attempt at `order`,
    counting the live rows only: the explicit phi rows (a multiply each),
    the predictor (a multiply and an add a term, then y + dt acc), the
    implicit phi rows (a subtract and an add each), the corrector (2) and
    the error's scale, term and square (9)."""
    return ((order - 1) + 2 * max(order - 1, 1) + 2 + 2 * (order + 1) + 2
            + 9)


def _vcabm_accept_flops(order: float) -> float:
    """On accept: the errors at orders k - 1 and k - 2 (4 each), the scale
    (5), the new phi rows (2 each of order + 2) and the error at k + 1
    (4)."""
    return 8 + 5 + 2 * (order + 2) + 4


class _Orders:
    """`with _Orders() as o:` keeps the order of every attempt of a plain
    K11 run (its rejection controller, `cuda_adams._vcabm_dt(...,
    accepted=False)`, runs once an attempt at the attempt's order); the
    plain run takes the kernel's steps bit for bit."""

    def __enter__(self):
        from tfdiffeq_tpu_torch.ops import cuda_adams as cad
        self.mod, self.fn, self.orders = cad, cad._vcabm_dt, []

        def record(dt, ratio, order, accepted, *a, **k):
            if not accepted:
                self.orders.append(order)
            return self.fn(dt, ratio, order, accepted, *a, **k)

        cad._vcabm_dt = record
        return self

    def __exit__(self, *exc):
        self.mod._vcabm_dt = self.fn


#: The batches at which [26], [37] and [39] hold every group launch of
#: explicit_adams' K10 and of K12 to its plain version: the bench batch,
#: the example's, and two that leave groups past B.
GROUP_BATCHES = (B, 256, 33, 1)


def _held_launch(wrapper, plain, args, kw, what: str):
    """wrapper(*args, **kw) on the card, held to plain(*args, **kw)
    bitwise (`_hold_to_plain`), finite with status 0, and run again
    bitwise."""
    import torch
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    if got[-1][3].item() != 0 or not torch.isfinite(got[0]).all():
        raise AssertionError(f"{what}: stats {got[-1].tolist()}")
    _hold_to_plain((args, kw, got), plain, what)
    if not all(torch.equal(a, b) for a, b in zip(got, wrapper(*args,
                                                              **kw))):
        raise AssertionError(f"{what}: two kernel runs differ")


def _layout_str(lay) -> str:
    return (f"{lay['threads_a_sample']} threads a sample, "
            f"{lay['samples_a_block']} samples a block, slots in "
            f"{'shared memory' if lay['slots_in_shared_memory'] else 'the workspace'}")


def _explicit_group_sweep(dev) -> dict:
    """[26]: explicit_adams' K10 (a group of threads a sample) on the
    narrow route (the bench spiral) and the wide route (section 1's wide
    net) at GROUP_BATCHES, max_order 1 forward and 12 in reverse time on a
    40-step Hermite grid over [0, 0.25], float32 and float64, each launch held to its
    plain version; prints and returns the layout each launch reported."""
    import torch
    from tfdiffeq_tpu_torch import fast
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_kernels as ck
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    layouts = {}
    for dtype in (torch.float32, torch.float64):
        for route in ("narrow", "wide"):
            if route == "narrow":
                p, yb, _ = _bench_params(B, dtype, dev)
                W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
                net = dict(activation="tanh", input_power=3)
            else:
                W, yb = _wide_net(dtype, dev, B)
                net = dict(activation="tanh")
            warr, dims = ck.pack_mlp_weights(W, dtype, dev)
            spec = fast.MLPSpec(**net)
            # A short span: AB12 multiplies float32 roundoff by about 1e5
            # over 40 steps of 0.00625 (1e7 at 0.025).
            t = torch.linspace(0.0, 0.25, 5, dtype=dtype)
            for Bx in GROUP_BATCHES:
                y = yb[:Bx].contiguous()
                for order, sign in ((1, 1.0), (12, -1.0)):
                    tau = t if sign > 0 else (-t).flip(0)
                    grid = uniform_grid(tau[0], tau[-1], 40)
                    sgn = torch.tensor(sign, dtype=dtype, device=dev)
                    f0 = (sgn * fast.mlp_apply(spec, W, y, sgn * grid[0].to(
                        dev))).contiguous()
                    _held_launch(
                        cad.mlp_solve_adams, cad.mlp_solve_adams_plain,
                        (warr, dims, y, tau, grid, TOL, TOL, sign),
                        dict(f0=f0, implicit=False, max_order=order, **net),
                        f"[26] explicit_adams {route} B={Bx} max_order="
                        f"{order} {dtype}")
                    layouts[(route, Bx)] = cad.last_adams_layout
    for (route, Bx), lay in layouts.items():
        print(f"[26] explicit_adams' K10 {route} route, B = {Bx}: "
              f"{_layout_str(lay)} (as the launch reported)", flush=True)
    return {f"{r} B={b}": lay for (r, b), lay in layouts.items()}


def _adams_tier(smi: str, dev) -> dict:
    """Phases 25-27: the Adams family (K10 and K11) at the bench widths.
    Returns the numbers that the kernel records take."""
    import torch
    from tfdiffeq_tpu_torch import convert, fast, odeint_adjoint, solve
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, \
        cuda_adjoint as ca, cuda_fixed as cf, cuda_kernels as ck
    from tfdiffeq_tpu_torch.ops.tableaus import RK4
    f32, f64 = torch.float32, torch.float64
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    mlp = _mlp_flops(((D, H), (H, D)), input_power=3)
    n_w = D * H + H + H * D + D
    rec = {}

    def bench_w(dtype, B_=B):
        p, y, p_np = _bench_params(B_, dtype, dev)
        return p, [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y, p_np

    _, _, _, p_np = bench_w(f32)
    func = convert.ode_func_from_flax({"params": {
        "Dense_0": {"kernel": p_np["w1"], "bias": p_np["b1"]},
        "Dense_1": {"kernel": p_np["w2"], "bias": p_np["b2"]}}},
        device=dev, dtype=f32)

    _at("25")
    # [25] K11 at the VCABM protocol (bench.py:237-253): the launch that
    # the public entry point makes, held against its plain version on its
    # own inputs in float32 and float64, then again at max_order 5.
    k11 = {}
    for dtype, order in ((f32, 12), (f64, 12), (f64, 5)):
        p, W, y, _ = bench_w(dtype)
        t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
        cad.reset_launch_counts()
        with _Recording(fast, "mlp_solve_vcabm") as r:
            if order == 12:
                res = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL,
                                     method="adams", first_step=FIRST_STEP)
            else:
                res = fast.solve_mlp_spec(spec, W, y, t, rtol=TOL, atol=TOL,
                                          method="adams",
                                          first_step=FIRST_STEP,
                                          max_order=order)
        torch.cuda.synchronize()
        launches = cad.mlp_solve_vcabm_launches
        nfe, acc, rej, status = res.stats
        print(f"[25] fast.{'solve_mlp' if order == 12 else 'solve_mlp_spec'}"
              f"(method='adams', max_order={order}) {dtype}: nfe {nfe}, "
              f"accepted {acc}, rejected {rej}, status {status}; K11 "
              f"launches {launches}", flush=True)
        if launches != 1 or len(r.calls) != 1 or status != 0 \
                or tuple(res.ys.shape) != (T_OUT, B, D) \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"VCABM {dtype} failed at the bench "
                                 "protocol")
        call = r.calls[0]
        with _Orders() as o:
            err, plain_ms = _hold_to_plain(
                call, cad.mlp_solve_vcabm_plain,
                f"[25] K11 {dtype} max_order {order}")
        args, kw, got = call
        if not all(torch.equal(a, b) for a, b in
                   zip(got, cad.mlp_solve_vcabm(*args, **kw))):
            raise AssertionError(f"K11 {dtype}: two kernel runs differ")
        k11[(dtype, order)] = (call, err, o.orders)
    print("[25] K11: two kernel runs bitwise equal in each case", flush=True)
    p, W, y, _ = bench_w(f32)
    t = torch.linspace(0.0, SPAN, T_OUT)
    vcabm_ys = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL, method="adams",
                              first_step=FIRST_STEP).ys
    dopri = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL,
                           first_step=FIRST_STEP).ys
    print(f"[25] max |adams (K11) - dopri5 (K2)| at full size "
          f"{float((vcabm_ys - dopri).abs().max()):.3e}", flush=True)
    ps, ys, _ = _bench_params(96, f32, dev)
    ts = torch.linspace(0.0, 5.0, 12)
    small = fast.solve_mlp(ps, ys, ts, rtol=TOL, atol=TOL,
                           method="adams").ys
    with torch.no_grad():
        generic = solve(func, ys, ts, rtol=TOL, atol=TOL, method="adams").ys
    gap = _rel(small, generic)
    print(f"[25] B=96: K11 and the generic VCABM agree to {gap:.3e} relative "
          "(bar 1e-3)", flush=True)
    if gap > 1e-3:
        raise AssertionError("K11 and the generic VCABM engine differ")
    (args, kw, got), rec["vcabm_err"], orders = k11[(f32, 12)]
    rec["vcabm_ms"] = _timed(lambda: cad.mlp_solve_vcabm(*args, **kw))
    rec["vcabm_plain_ms"] = _plain_ms(
        lambda: cad.mlp_solve_vcabm_plain(*args, **kw))
    with torch.no_grad():
        rec["vcabm_generic_ms"] = _host_ms(lambda: solve(
            func, y, t, rtol=TOL, atol=TOL, method="adams",
            options={"first_step": FIRST_STEP}))[0]
    nfe, acc, rej, _ = got[1].tolist()
    rec["vcabm_bound"] = _bound(
        B * (nfe * mlp + D * (sum(_vcabm_attempt_flops(k) for k in orders)
                              + acc * _vcabm_accept_flops(
                                  sum(orders) / len(orders)))),
        4 * (2 * B * D + T_OUT * B * D + T_OUT + n_w))
    print(f"[25] {smi}: K11 mlp_solve_vcabm {rec['vcabm_ms']:.3f} ms/solve "
          f"vs plain {rec['vcabm_plain_ms']:.3f} ms vs the generic engine "
          f"solve(ODEFunc, method='adams') {rec['vcabm_generic_ms']:.3f} ms "
          f"(bench protocol, float32, nfe {nfe}, {acc + rej} attempts, "
          f"orders {min(orders)}..{max(orders)}); bound "
          f"{rec['vcabm_bound'][0]:.4f} ms ({rec['vcabm_bound'][1]})",
          flush=True)

    _at("26")
    # [26] K10 at the bench widths with bench.py:205's 512 steps, both
    # methods, float32 and float64, and on the default grid.
    k10 = {}
    for method, dtype, steps in (
            ("fixed_adams", f32, ADAMS_STEPS),
            ("explicit_adams", f32, ADAMS_STEPS),
            ("fixed_adams", f64, ADAMS_STEPS),
            ("explicit_adams", f64, ADAMS_STEPS),
            ("fixed_adams", f32, None), ("explicit_adams", f32, None)):
        _, W, y, _ = bench_w(dtype)
        t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
        cad.reset_launch_counts()
        with _Recording(fast, "mlp_solve_adams") as r:
            res = fast.solve_mlp_spec(spec, W, y, t, rtol=TOL, atol=TOL,
                                      method=method, num_steps=steps)
        torch.cuda.synchronize()
        launches = cad.mlp_solve_adams_launches
        nfe, acc, _, status = res.stats
        G = (steps or T_OUT - 1) + 1
        per = 5 if method == "fixed_adams" else 1
        print(f"[26] fast.solve_mlp_spec(method={method!r}, num_steps="
              f"{steps}) {dtype}: nfe {nfe}, steps {acc}, status {status}; "
              f"K10 launches {launches}", flush=True)
        if launches != 1 or len(r.calls) != 1 or status != 0 \
                or nfe != 1 + 4 * 3 + per * (G - 4) \
                or tuple(res.ys.shape) != (T_OUT, B, D) \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"{method} {dtype} failed at the bench "
                                 "widths")
        call = r.calls[0]
        args, kw, got = call
        if not all(torch.equal(a, b) for a, b in
                   zip(got, cad.mlp_solve_adams(*args, **kw))):
            raise AssertionError(f"K10 {method} {dtype}: two kernel runs "
                                 "differ")
        k10[(method, dtype, steps)] = (call, None, res.ys)

        # Bitwise equal to the plain version, in [50]'s workers; the
        # plain time of the timed cases taken there.
        def k10_done(err, plain_ms, key=(method, dtype, steps)):
            c, _, ys_ = k10[key]
            k10[key] = (c, err, ys_)
            if key[1] == f32 and key[2] == ADAMS_STEPS:
                name = "adams" if key[0] == "fixed_adams" else "explicit"
                rec[f"{name}_plain_ms"] = plain_ms
            rec["adams_err"] = max(e for (m, dt_, s), (_, e, _) in
                                   k10.items() if dt_ == f32 and
                                   e is not None)
        _LATER.add(call, cad.mlp_solve_adams_plain,
                   f"[26] K10 {method} {dtype} grid {G - 1} steps (held in "
                   "[50])", k10_done)
    print("[26] K10: two kernel runs bitwise equal in each case", flush=True)
    rec["explicit_launches"] = sum(
        1 for (m, _, _) in k10 if m == "explicit_adams")
    rec["explicit_layouts"] = _explicit_group_sweep(dev)
    fixed_ys = k10[("fixed_adams", f32, ADAMS_STEPS)][2]
    print(f"[26] max |fixed_adams x {ADAMS_STEPS} (K10) - dopri5 (K2)| at "
          f"full size {float((fixed_ys - dopri).abs().max()):.3e}",
          flush=True)
    Ws = [(ps["w1"], ps["b1"]), (ps["w2"], ps["b2"])]
    for method in ("fixed_adams", "explicit_adams"):
        small = fast.solve_mlp_spec(spec, Ws, ys, ts, rtol=TOL, atol=TOL,
                                    method=method,
                                    num_steps=ADAMS_STEPS).ys
        with torch.no_grad():
            generic = solve(func, ys, ts, rtol=TOL, atol=TOL, method=method,
                            options={"num_steps": ADAMS_STEPS}).ys
        gap = _rel(small, generic)
        print(f"[26] B=96: K10 {method} and the generic engine agree to "
              f"{gap:.3e} relative (bar 1e-5)", flush=True)
        if gap > 1e-5:
            raise AssertionError(f"K10 {method} and the generic engine "
                                 "differ")
    _, W, y, _ = bench_w(f32)
    t = torch.linspace(0.0, SPAN, T_OUT)
    for method in ("fixed_adams", "explicit_adams"):
        (args, kw, got), _, _ = k10[(method, f32, ADAMS_STEPS)]
        key = "adams" if method == "fixed_adams" else "explicit"
        rec[f"{key}_ms"] = _timed(lambda: cad.mlp_solve_adams(*args, **kw))
        with torch.no_grad():
            rec[f"{key}_generic_ms"] = _host_ms(lambda: solve(
                func, y, t, rtol=TOL, atol=TOL, method=method,
                options={"num_steps": ADAMS_STEPS}))[0]
        implicit = method == "fixed_adams"
        nfe = got[1][0].item()
        rec[f"{key}_bound"] = _bound(
            B * (nfe * mlp + D * (3 * (_combine_flops(RK4) + 12)
                                  + (ADAMS_STEPS - 3) * _adams_step_flops(
                                      4, 4, implicit))),
            4 * (2 * B * D + T_OUT * B * D + n_w + T_OUT
                 + ADAMS_STEPS + 1))
        print(f"[26] {smi}: K10 {method} {rec[f'{key}_ms']:.3f} ms/solve "
              f"(the plain version timed in [50]) vs the generic engine "
              f"solve(ODEFunc, method={method!r}) "
              f"{rec[f'{key}_generic_ms']:.3f} ms (bench widths, "
              f"{ADAMS_STEPS} steps, float32, nfe {nfe}); bound "
              f"{rec[f'{key}_bound'][0]:.4f} ms ({rec[f'{key}_bound'][1]})",
              flush=True)

    _at("27")
    # [27] training with an Adams forward: three SGD steps of the spiral
    # (bench.py:788-838) on K11 + K3, one step on K10 + K9.
    p, _, y, _ = bench_w(f32)
    W = [(p["w1"].clone().requires_grad_(), p["b1"].clone().requires_grad_()),
         (p["w2"].clone().requires_grad_(), p["b2"].clone().requires_grad_())]
    W0 = [x.detach().clone() for pair in W for x in pair]
    target = _bench_target(f32, dev)

    def sgd_step(**kw):
        ys, st = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=TOL, atol=TOL,
                                         return_stats=True, **kw)
        loss = torch.mean((ys - target) ** 2)
        loss.backward()
        with torch.no_grad():
            for x in (x for pair in W for x in pair):
                if not torch.isfinite(x.grad).all():
                    raise AssertionError("non-finite Adams-forward gradient "
                                         "(a failed backward sweep)")
                x -= SGD_LR * x.grad
                x.grad = None
        if st.status != 0:
            raise AssertionError(f"Adams forward failed: {st}")
        return float(loss.detach())

    for mod in (cad, ca, cf, ck):
        mod.reset_launch_counts()
    losses = []
    rec["train_ms"], train_all = _host_ms(lambda: losses.append(sgd_step(
        method="adams", adjoint_method="dopri5")), reps=TRAIN_STEPS)
    train_launches = {"mlp_solve_vcabm": cad.mlp_solve_vcabm_launches,
                      "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches,
                      "mlp_solve": ck.mlp_solve_launches}
    moved = max(float((x.detach() - x0).abs().max())
                for x, x0 in zip((x for pair in W for x in pair), W0))
    print(f"[27] spiral SGD x{TRAIN_STEPS} (method='adams', adjoint_method="
          f"'dopri5'): launches {train_launches}; MSE "
          f"{', '.join(f'{v:.6f}' for v in losses)}; max weight change "
          f"{moved:.3e}", flush=True)
    print(f"[27] {smi}: Adams-forward training step (K11 + K3, bench "
          f"protocol, float32) {rec['train_ms']:.3f} ms median of "
          f"{TRAIN_STEPS} ({', '.join(f'{x:.3f}' for x in train_all)})",
          flush=True)
    if train_launches != {"mlp_solve_vcabm": TRAIN_STEPS,
                          "mlp_adjoint_solve": TRAIN_STEPS, "mlp_solve": 0} \
            or not moved > 0.0:
        raise AssertionError(f"Adams training launches {train_launches}")
    rec["vcabm_launches"] = train_launches["mlp_solve_vcabm"]
    for mod in (cad, cf):
        mod.reset_launch_counts()
    with _Recording(fast, "mlp_solve_adams") as r:
        fixed_ms, _ = _host_ms(lambda: sgd_step(
            method="fixed_adams", adjoint_method="rk4",
            num_steps=ADAMS_STEPS, adjoint_num_steps=8), reps=1)
    fixed_launches = {"mlp_solve_adams": cad.mlp_solve_adams_launches,
                      "mlp_adjoint_solve_fixed":
                          cf.mlp_adjoint_solve_fixed_launches}
    _hold_to_plain(r.calls[0], cad.mlp_solve_adams_plain,
                   "[27] K10 fixed_adams forward of the training step")
    print(f"[27] one SGD step (method='fixed_adams', adjoint_method='rk4', "
          f"num_steps={ADAMS_STEPS}, adjoint_num_steps=8): launches "
          f"{fixed_launches}; {fixed_ms:.3f} ms ({smi})", flush=True)
    if fixed_launches != {"mlp_solve_adams": 1,
                          "mlp_adjoint_solve_fixed": 1}:
        raise AssertionError(f"fixed_adams training launches "
                             f"{fixed_launches}")
    rec["adams_launches"] = fixed_launches["mlp_solve_adams"]
    # Fused against the generic adjoint on a small input.
    tgt = torch.tensor(np.random.RandomState(2).randn(12, 96, D) * 0.5,
                       dtype=f32, device=dev)
    grads = []
    for fused in (True, False):
        Ws = [(ps["w1"].clone().requires_grad_(),
               ps["b1"].clone().requires_grad_()),
              (ps["w2"].clone().requires_grad_(),
               ps["b2"].clone().requires_grad_())]
        if fused:
            out = fast.odeint_adjoint_mlp(spec, Ws, ys, ts, rtol=TOL,
                                          atol=TOL, method="adams",
                                          adjoint_method="dopri5")
        else:
            out = odeint_adjoint(
                lambda tt, yy, w: fast.mlp_apply(spec, w, yy), ys, ts,
                params=Ws, rtol=TOL, atol=TOL, method="adams",
                adjoint_method="dopri5")
        torch.mean((out - tgt) ** 2).backward()
        grads.append([x.grad for pair in Ws for x in pair])
    gap = max(_rel(a, b) for a, b in zip(*grads))
    print(f"[27] B=96: Adams-forward fused and generic adjoint gradients "
          f"agree to {gap:.3e} relative (bar 1e-3)", flush=True)
    if gap > 1e-3:
        raise AssertionError("Adams-forward fused and generic adjoint "
                             "gradients differ")
    return rec


#: [28]-[32]: the coupled plans' state width, batch, outputs and span
#: (tests/test_meanfield.py:23-26 at B = 4096).
PLAN_D, PLAN_B, PLAN_T, PLAN_SPAN = 3, 4096, 7, 2.0
#: The flow of [32] (BASELINE.md:83) and its sample count.
FLOW_N = 4096


def _spiral_params_func(t, y, q):
    """The bench spiral as plain PyTorch over the weights (w1, b1, w2,
    b2)."""
    import torch
    return torch.tanh((y ** 3) @ q[0] + q[1]) @ q[2] + q[3]


def _spiral_func(p):
    """The bench spiral over the dict `p` (w1, b1, w2, b2)."""
    q = (p["w1"], p["b1"], p["w2"], p["b2"])
    return lambda t, y: _spiral_params_func(t, y, q)


def _coupled_params_funcs():
    """The reference's mean-field dynamics (tests/test_meanfield.py:27-34)
    and a max coupling, as plain PyTorch over a weight W (the parameter
    tuple's only entry)."""
    import torch
    return {
        "meanfield": lambda t, y, q: (torch.tanh(y @ q[0])
                                      - 0.5 * (y - y.mean(0))),
        "scalar_coupled": lambda t, y, q: (torch.tanh(y @ q[0])
                                           - 0.1 * (y ** 2).mean() * y),
        "bmax": lambda t, y, q: (torch.tanh(y @ q[0])
                                 - 0.5 * (y - y.amax(0))),
    }


def _coupled_funcs(dtype, device):
    """[31]'s couplings over their seed-0 weight."""
    import torch
    W = (torch.tensor(np.random.RandomState(0).randn(PLAN_D, PLAN_D) * 0.3,
                      dtype=dtype, device=device),)
    return {name: (lambda t, y, f=f: f(t, y, W))
            for name, f in _coupled_params_funcs().items()}


def _flow_variables():
    """BASELINE's CNF flow (3 -> 32 -> 32 -> 2, concat-t, tanh) in the flax
    layout that `convert.cnf_from_flax` reads, from a seeded generator."""
    rng = np.random.RandomState(0)
    widths = [CNF_D + 1, CNF_H, CNF_H, CNF_D]
    return {"params": {f"Dense_{i}": {
        "kernel": rng.randn(i_, o) * 0.6 / np.sqrt(i_),
        "bias": rng.randn(o) * 0.1}
        for i, (i_, o) in enumerate(zip(widths[:-1], widths[1:]))}}


def _flow_func(t, z, params):
    """The concat-t flow as plain PyTorch over [(W [din, dout], b), ...]."""
    import torch
    h = torch.cat([z, t.expand(z.shape[0], 1)], dim=1)
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


def _plan_pairs(dev):
    """Every (plan, host) that phases 28-32 run, captured at a small batch
    where the generated code does not depend on it, so that their libraries
    build together before the phases need them."""
    import torch
    from tfdiffeq_tpu_torch import convert, fast
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    t0 = torch.tensor(0.0, device=dev)
    p, _, _ = _bench_params(8, torch.float32, dev)
    spiral, _ = pb.build_plan(_spiral_func(p), t0, torch.ones(8, D,
                                                             device=dev))
    pairs = [(spiral, "solve"), (spiral, "fixed"), (spiral, "perlane")]
    # A batch mean divides by B, a literal of the plan: the coupled plans
    # are captured at their batch.
    for f in _coupled_funcs(torch.float32, dev).values():
        plan, _ = pb.build_plan(f, t0, torch.ones(PLAN_B, PLAN_D,
                                                  device=dev))
        pairs.append((plan, "solve"))
    flow = convert.cnf_from_flax(_flow_variables(), device=dev)
    W = fast.weights_from_linears(flow)
    plan, _ = pb.build_plan(lambda t, z: _flow_func(t, z, W), t0,
                            torch.ones(8, CNF_D, device=dev))
    pairs.append((plan, "solve"))
    return pairs


def _plan_flops(plan) -> int:
    """One evaluation of a plan for one sample: a multiply and an add a
    dot weight, one operation an element of every elementwise op and
    reduction (a transcendental function counted as one); moves, casts
    and broadcasts are free."""
    from tfdiffeq_tpu_torch.ops.plan_codegen import value_rows
    rows = value_rows(plan)
    n = _plan_dot_flops(plan)
    for ins in plan.instrs:
        op = ins[0]
        if op in ("un", "bin", "select"):
            n += rows[ins[1]]
        elif op == "clamp":
            n += 2 * rows[ins[1]]
        elif op == "ipow":
            n += max(abs(ins[3]) - 1, 1) * rows[ins[1]]
        elif op in ("reduce", "bsum", "bmax"):
            a = ins[2]
            n += rows[a[1]] if a[0] == "v" else 1
    return n


def _plan_dot_flops(plan) -> int:
    """The products' part of `_plan_flops`: a multiply and an add a dot
    weight."""
    return sum(2 * ins[4] * ins[5] for ins in plan.instrs if ins[0] == "dot")


def _walk_of(cpl, host: str) -> dict:
    """How the latest launch on a plan host walked a sample: `group`
    threads (1: a thread a sample; else the generated group walk) and
    where it read the constants (`route`: 'shared' or 'global')."""
    return {"group": cpl.last_group.get(host),
            "route": cpl.last_route.get(host)}


def _plan_tier(smi: str, dev, builds, pairs) -> dict:
    """Phases 28-32: K14, a traced plan's generated right-hand side, in K2,
    K8 and K5. `builds` is the future of the build of `pairs`' plan
    libraries, started after [2]. Returns the numbers of K14's record."""
    import time
    import torch
    from tfdiffeq_tpu_torch import fast, odeint, solve
    from tfdiffeq_tpu_torch import convert
    from tfdiffeq_tpu_torch.ops import _build, cuda_fixed as cf, \
        cuda_kernels as ck, cuda_perlane as cp, cuda_plan as cpl, \
        plan_bridge as pb
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5, RK4
    f32, f64 = torch.float32, torch.float64
    rec = {"ms": {}, "plain_ms": {}, "mlp_route_ms": {}, "err": {},
           "launches": {"K2": 0, "K8": 0, "K5": 0}}
    t_wait = time.perf_counter()
    builds.result()
    rec["build_s"] = {f"{h}:{k}": round(v, 3) for (k, h), v in
                      _build.plan_build_times.items()}
    print(f"[28] plan libraries: {_build.plan_builds} nvcc builds in "
          f"{_build.plan_build_seconds:.1f} s (started after [2], beside "
          f"phases 3-27; waited {time.perf_counter() - t_wait:.1f} s here); "
          f"per library {rec['build_s']}", flush=True)
    for plan_, host in pairs:
        for line in _build.plan_build_log(cpl.source(plan_, host),
                                          host).splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {host}: " + line.strip())

    def launches():
        return (cpl.plan_solve_launches, cpl.plan_fixed_launches,
                cpl.plan_perlane_launches)

    def hold(call, plain, what, again):
        """A recorded launch against its plain version, and run again."""
        err, plain_ms = _hold_to_plain(call, plain, what)
        args, kw, got = call
        if not all(torch.equal(a, b) for a, b in zip(got, again(*args,
                                                                 **kw))):
            raise AssertionError(f"{what}: two kernel runs differ")
        return err, plain_ms

    t = torch.linspace(0.0, SPAN, T_OUT)

    _at("28")
    # [28] K14 in K2 at the bench protocol, through odeint(fuse).
    def fused_bench():
        p, y, _ = _bench_params(B, f32, dev)
        return odeint(_spiral_func(p), y, t, rtol=TOL, atol=TOL,
                      options={"fuse": True, "first_step": FIRST_STEP})

    calls = {}
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        tt = t.to(dtype)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_solve") as r:
            ys = odeint(_spiral_func(p), y, tt, rtol=TOL, atol=TOL,
                        options={"fuse": True, "first_step": FIRST_STEP})
        torch.cuda.synchronize()
        st = r.calls[0][2][1].tolist() if r.calls else None
        print(f"[28] odeint(spiral as plain torch, fuse) {dtype}: plan "
              f"launches (K2, K8, K5) {launches()}, fallbacks "
              f"{fast.fuse_fallbacks - fb}, kernel stats {st}", flush=True)
        if launches() != (1, 0, 0) or fast.fuse_fallbacks != fb \
                or st[3] != 0 or tuple(ys.shape) != (T_OUT, B, D) \
                or not torch.isfinite(ys).all():
            raise AssertionError(f"[28] the fused spiral {dtype} failed")
        rec["launches"]["K2"] += 1
        calls[dtype] = r.calls[0]
        err, plain_ms = hold(r.calls[0], cpl.plan_solve_plain,
                             f"[28] K14 in K2 {dtype}", cpl.plan_solve)
        if dtype == f32:
            rec["err"]["K2"], rec["plain_ms"]["K2"] = err, plain_ms
            ys32 = ys
    args, kw, got = calls[f32]
    rec["ms"]["K2"] = _timed(lambda: cpl.plan_solve(*args, **kw))
    rec["k2_stats"] = got[1].tolist()
    rec["n_consts"] = sum(x.numel() for x in args[1])
    rec["plan_flops"] = _plan_flops(args[0])
    p, y, _ = _bench_params(B, f32, dev)
    mlp = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL, first_step=FIRST_STEP)
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    warr, dims = ck.pack_mlp_weights(W, f32, dev)
    f0 = fast.mlp_apply(spec, W, y)
    mlp_args = (warr, dims, y, t, FIRST_STEP, TOL, TOL, 1.0)
    mlp_kw = dict(f0=f0, activation="tanh", input_power=3)
    y32 = y
    rec["mlp_route_ms"]["K2"] = _timed(lambda: ck.mlp_solve(*mlp_args,
                                                            **mlp_kw))
    with torch.no_grad():
        gen = solve(_spiral_func(p), y, t, rtol=TOL, atol=TOL,
                    options={"first_step": FIRST_STEP})
        gen_ms = _host_ms(lambda: solve(_spiral_func(p), y, t, rtol=TOL,
                                        atol=TOL, options={
                                            "first_step": FIRST_STEP}))[0]
    print(f"[28] {smi}: K14 in K2 {rec['ms']['K2']:.3f} ms a solve (nfe "
          f"{got[1][0].item()}) vs K2's MLP route "
          f"{rec['mlp_route_ms']['K2']:.3f} ms (fast.solve_mlp nfe "
          f"{mlp.stats.nfe}) vs the generic engine "
          f"{gen_ms:.3f} ms (nfe {gen.stats.nfe}); plain version "
          f"{rec['plain_ms']['K2']:.1f} ms; max |fused - solve_mlp| "
          f"{float((ys32 - mlp.ys).abs().max()):.3e}, |fused - generic| "
          f"{float((ys32 - gen.ys).abs().max()):.3e} (printed, not held: the "
          f"bench protocol's step counts follow summation order)", flush=True)
    ps, ys_, _ = _bench_params(96, f32, dev)
    ts = torch.linspace(0.0, 5.0, 12)
    small = odeint(_spiral_func(ps), ys_, ts, rtol=TOL, atol=TOL,
                   options={"fuse": True})
    with torch.no_grad():
        small_g = solve(_spiral_func(ps), ys_, ts, rtol=TOL, atol=TOL).ys
    rel = _rel(small, small_g)
    print(f"[28] B=96: fused within {rel:.3e} relative of the generic solve "
          "(bar 1e-5)", flush=True)
    if rel > 1e-5:
        raise AssertionError("[28] the fused spiral differs from the generic "
                             "engine at B=96")

    _at("29")
    # [29] K14 in K8: rk4 with 500 steps at the bench widths.
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        cpl.reset_launch_counts()
        with _Recording(cpl, "plan_solve_fixed") as r:
            res = fast.solve_fused(_spiral_func(p), y, t.to(dtype),
                                   method="rk4", num_steps=500)
        if launches() != (0, 1, 0) or res.stats.status != 0 \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[29] K14 in K8 {dtype}: launches "
                                 f"{launches()}, stats {res.stats}")
        rec["launches"]["K8"] += 1
        err, plain_ms = hold(r.calls[0], cpl.plan_solve_fixed_plain,
                             f"[29] K14 in K8 rk4 x 500 {dtype}",
                             cpl.plan_solve_fixed)
        if dtype == f32:
            rec["err"]["K8"], rec["plain_ms"]["K8"] = err, plain_ms
            args8, kw8, _ = r.calls[0]
            rec["k8_nfe"] = res.stats.nfe
    rec["ms"]["K8"] = _timed(lambda: cpl.plan_solve_fixed(*args8, **kw8))
    rec.setdefault("walk", {})["K8"] = _walk_of(cpl, "fixed")
    grid = args8[4]
    rec["mlp_route_ms"]["K8"] = _timed(lambda: cf.mlp_solve_fixed(
        warr, dims, y32, t, grid, 1.0, **mlp_kw))
    # The other methods on the default grid (the output times), as [10].
    ps, ys_, _ = _bench_params(96, f64, dev)
    for method in ("euler", "midpoint", "rk4_38"):
        cpl.reset_launch_counts()
        with _Recording(cpl, "plan_solve_fixed") as r:
            fast.solve_fused(_spiral_func(ps), ys_, t.to(f64),
                             method=method)
        rec["launches"]["K8"] += launches()[1]
        hold(r.calls[0], cpl.plan_solve_fixed_plain,
             f"[29] K14 in K8 {method} float64 B=96", cpl.plan_solve_fixed)
    print(f"[29] {smi}: K14 in K8 {rec['ms']['K8']:.3f} ms an rk4 x 500 "
          f"solve vs K8's MLP route {rec['mlp_route_ms']['K8']:.3f} ms; "
          f"plain {rec['plain_ms']['K8']:.1f} ms; walk {rec['walk']['K8']}",
          flush=True)

    _at("30")
    # [30] K14 in K5: a controller a sample, through solve(fuse,
    # per_sample), HNW first steps per sample.
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        cpl.reset_launch_counts()
        with _Recording(cpl, "plan_solve") as r:
            res = solve(_spiral_func(p), y, t.to(dtype), rtol=TOL, atol=TOL,
                        options={"fuse": True, "per_sample": True})
        lane = res.lane_stats.nfe.float()
        print(f"[30] solve(spiral, fuse, per_sample) {dtype}: launches "
              f"{launches()}, stats {res.stats}, lane nfe min "
              f"{lane.min():.0f} median {lane.median():.0f} max "
              f"{lane.max():.0f}", flush=True)
        if launches() != (0, 0, 1) or res.stats.status != 0 \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[30] K14 in K5 {dtype} failed")
        rec["launches"]["K5"] += 1
        # The per-sample counts last, as _hold_to_plain prints and compares
        # them: (out, stats, lane_stats) -> (out, lane_stats, stats).
        args5, kw5, got5 = r.calls[0]
        swap = lambda fn: lambda *a, **k: (lambda o: (o[0], o[2], o[1]))(
            fn(*a, **k))
        err, plain_ms = hold((args5, kw5, (got5[0], got5[2], got5[1])),
                             swap(cpl.plan_solve_plain),
                             f"[30] K14 in K5 {dtype}", swap(cpl.plan_solve))
        if dtype == f32:
            rec["err"]["K5"], rec["plain_ms"]["K5"] = err, plain_ms
            rec["k5_stats"] = got5[1].tolist()
    rec["ms"]["K5"] = _timed(lambda: cpl.plan_solve(*args5, **kw5))
    rec.setdefault("walk", {})["K5"] = _walk_of(cpl, "perlane")
    dt0 = args5[4]
    rec["mlp_route_ms"]["K5"] = _timed(lambda: cp.mlp_solve_perlane(
        warr, dims, y32, t, dt0, TOL, TOL, 1.0, **mlp_kw))
    print(f"[30] {smi}: K14 in K5 {rec['ms']['K5']:.3f} ms a solve vs K5's "
          f"MLP route {rec['mlp_route_ms']['K5']:.3f} ms; plain "
          f"{rec['plain_ms']['K5']:.1f} ms; walk {rec['walk']['K5']}",
          flush=True)

    _at("31")
    # [31] batch couplings in K2: the block meets in their fixed order.
    tc = torch.linspace(0.0, PLAN_SPAN, PLAN_T)
    rec["coupled"] = {}
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        for name, f in _coupled_funcs(dtype, dev).items():
            cpl.reset_launch_counts()
            with _Recording(cpl, "plan_solve") as r:
                res = solve(f, y, tc.to(dtype), rtol=TOL, atol=1e-8,
                            options={"fuse": True})
            if launches() != (1, 0, 0) or res.stats.status != 0 \
                    or not torch.isfinite(res.ys).all():
                raise AssertionError(f"[31] {name} {dtype}: launches "
                                     f"{launches()}, stats {res.stats}")
            rec["launches"]["K2"] += 1
            err, plain_ms = hold(r.calls[0], cpl.plan_solve_plain,
                                 f"[31] K14 {name} in K2 (batch route) "
                                 f"{dtype}", cpl.plan_solve)
            if dtype == f32:
                a, k, g_ = r.calls[0]
                ms = _timed(lambda: cpl.plan_solve(*a, **k), reps=3)
                with torch.no_grad():
                    gen_ms = _host_ms(lambda: solve(
                        f, y, tc, rtol=TOL, atol=1e-8))[0]
                rec["coupled"][name] = {"ms": ms, "plain_ms": plain_ms,
                                        "generic_engine_ms": gen_ms,
                                        "nfe": g_[1][0].item()}
                rec["err"]["K2"] = max(rec["err"]["K2"], err)
                print(f"[31] {smi}: {name} K14 in K2 {ms:.3f} ms (nfe "
                      f"{g_[1][0].item()}) vs the generic engine "
                      f"{gen_ms:.3f} ms; plain {plain_ms:.1f} ms",
                      flush=True)

    _at("32")
    # [32] cnf_sample_auto: BASELINE's flow as plain PyTorch.
    flow = convert.cnf_from_flax(_flow_variables(), device=dev)
    Wf = fast.weights_from_linears(flow)
    cpl.reset_launch_counts()
    with _Recording(cpl, "plan_solve") as r:
        xs = fast.cnf_sample_auto(_flow_func, Wf,
                                  torch.Generator(device=dev).manual_seed(7),
                                  FLOW_N, CNF_D, rtol=CNF_RTOL, atol=CNF_ATOL)
    if launches() != (1, 0, 0) or not torch.isfinite(xs).all():
        raise AssertionError(f"[32] cnf_sample_auto: launches {launches()}")
    rec["launches"]["K2"] += 1
    err, plain_ms = hold(r.calls[0], cpl.plan_solve_plain,
                         "[32] K14 (the flow) in K2 float32", cpl.plan_solve)
    xs_f = fast.cnf_sample_fused(Wf, torch.Generator(device=dev).manual_seed(
        7), FLOW_N, CNF_D, rtol=CNF_RTOL, atol=CNF_ATOL)
    rel = _rel(xs, xs_f)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    rec["flow_ms"] = _host_ms(lambda: fast.cnf_sample_auto(
        _flow_func, Wf, gen(), FLOW_N, CNF_D, rtol=CNF_RTOL,
        atol=CNF_ATOL))[0]
    rec["flow_fused_ms"] = _host_ms(lambda: fast.cnf_sample_fused(
        Wf, gen(), FLOW_N, CNF_D, rtol=CNF_RTOL, atol=CNF_ATOL))[0]
    z = torch.randn((FLOW_N, CNF_D), device=dev)
    rec["capture_ms"] = _host_ms(lambda: pb.build_plan(
        lambda tt, zz: _flow_func(tt, zz, Wf), torch.tensor(0.0, device=dev),
        z))[0]
    a, k, _ = r.calls[0]
    rec["flow_kernel_ms"] = _timed(lambda: cpl.plan_solve(*a, **k))
    print(f"[32] {smi}: cnf_sample_auto {rec['flow_ms']:.3f} ms (its K2 "
          f"launch {rec['flow_kernel_ms']:.3f} ms, the capture by make_fx "
          f"{rec['capture_ms']:.3f} ms) vs cnf_sample_fused "
          f"{rec['flow_fused_ms']:.3f} ms (n = {FLOW_N}); within {rel:.3e} "
          "relative (bar 1e-4)", flush=True)
    if rel > 1e-4:
        raise AssertionError("[32] cnf_sample_auto differs from "
                             "cnf_sample_fused")

    _at("28 again")
    # [28] again: the same structure builds nothing.
    n_builds = _build.plan_builds
    cpl.reset_launch_counts()
    again = fused_bench()
    if _build.plan_builds != n_builds or launches() != (1, 0, 0) \
            or not torch.equal(again, ys32):
        raise AssertionError("[28] a repeated structure rebuilt or differs")
    rec["launches"]["K2"] += 1
    print(f"[28] again: plan builds still {n_builds}, bitwise the first "
          "run", flush=True)
    return rec


#: [34]: the stiffness battery's outputs and span (bench.py:483-535).
STIFF_T, STIFF_SPAN = 5, 2.0


def _battery_func(sc):
    """bench.py:502-504: the stiffness battery, a per-sample scale sc [B]
    (a 'bvec' constant of the plan) over the spiral's net (w1, b1, w2)."""
    import torch

    def f(t, y, q):
        return sc[:, None] * (torch.tanh((y ** 3) @ q[0] + q[1]) @ q[2])
    return f


def _aug_pairs(dev):
    """Every (plan, host) that phases 33-36 run beyond [28]-[32]'s: the
    spiral's reverse walk in K3 and K9, the battery in K5 and K6 (and in K2
    and K3, the shared controller it is timed against; captured at a small batch: the per-sample scale is a
    'bvec' constant, data of the plan), the couplings' walks in K3
    (captured at their batch: a batch mean divides by B)."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    t0 = torch.tensor(0.0, device=dev)
    p, _, _ = _bench_params(8, torch.float32, dev)
    q = (p["w1"], p["b1"], p["w2"], p["b2"])
    spiral, _ = pb.build_plan(lambda t, y: _spiral_params_func(t, y, q), t0,
                              torch.ones(8, D, device=dev))
    sc = torch.ones(8, device=dev)
    battery, _ = pb.build_plan(lambda t, y: _battery_func(sc)(t, y, q), t0,
                               torch.ones(8, D, device=dev))
    pairs = [(spiral, "adjoint"), (spiral, "fixed_adjoint"),
             (battery, "perlane"), (battery, "perlane_adjoint"),
             (battery, "solve"), (battery, "adjoint")]
    W = (torch.ones(PLAN_D, PLAN_D, device=dev),)
    for f in _coupled_params_funcs().values():
        plan, _ = pb.build_plan(lambda t, y, f=f: f(t, y, W), t0,
                                torch.ones(PLAN_B, PLAN_D, device=dev))
        pairs.append((plan, "adjoint"))
    return pairs


def _plan_aug_flops(plan) -> int:
    """One augmented evaluation of a plan for one sample (K15): three
    forward walks (`_plan_flops`), the convention of K3's MLP bound (the
    forward re-walk, the reverse walk's products with the cotangent and
    each dot's dh and per-sample dW term, about twice the forward)."""
    return 3 * _plan_flops(plan)


def _aug_tier(smi: str, dev) -> dict:
    """Phases 33-36: K15, a traced plan's reverse walk, in K3, K6 and K9,
    through `odeint_adjoint(options={'fuse': True})` at full width. The
    plan libraries were built with [28]'s. Returns K15's record."""
    import torch
    from tfdiffeq_tpu_torch import fast, odeint_adjoint
    from tfdiffeq_tpu_torch.ops import cuda_adjoint as ca, \
        cuda_fixed as cf, cuda_kernels as ck, cuda_plan as cpl
    f32, f64 = torch.float32, torch.float64
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    rec = {"ms": {}, "plain_ms": {}, "err": {}, "bound": {},
           "launches": {"K3": 0, "K6": 0, "K9": 0}, "step_ms": {},
           "mlp_route_ms": {}, "mlp_route_step_ms": {}, "generic_ms": {}}

    def launches():
        return {"K2": cpl.plan_solve_launches, "K8": cpl.plan_fixed_launches,
                "K5": cpl.plan_perlane_launches,
                "K3": cpl.plan_adjoint_launches,
                "K9": cpl.plan_fixed_adjoint_launches,
                "K6": cpl.plan_perlane_adjoint_launches}

    def flat(fn):
        """A sweep's result flattened to tensors, the stats last."""
        def call(*a, **k):
            r = fn(*a, **k)
            lane = list(r[4:5])
            return (r[0], *r[1], r[2], *lane, r[3])
        return call

    def hold(call, plain, kernel, what, nan_ok=None):
        """A recorded launch against its plain version, and run again."""
        args, kw, got = call
        got = flat(lambda *a, **k: got)()
        err, plain_ms = _hold_to_plain((args, _grid_kw(plain, args, kw), got),
                                       flat(plain), what, nan_ok)
        again = flat(kernel)(*args, **kw)
        masks = nan_ok or [None] * len(got)
        if not all(_same(a, b, m) for a, b, m in zip(got, again, masks)):
            raise AssertionError(f"{what}: two kernel runs differ")
        return err, plain_ms

    def hold_later(call, plain, kernel, what, done, nan_ok=None):
        """A recorded launch run again here, and held to its plain version
        after the timed phases (`_LaterHolds`)."""
        args, kw, got = call
        got = flat(lambda *a, **k: got)()
        again = flat(kernel)(*args, **kw)
        masks = nan_ok or [None] * len(got)
        if not all(_same(a, b, m) for a, b, m in zip(got, again, masks)):
            raise AssertionError(f"{what}: two kernel runs differ")
        _LATER.add((args, kw, got), plain, what, done, nan_ok, flat=True)

    def failed_masks(call):
        """A K6 sweep's NaN masks (`_same`) from its lane status: ay0's and
        each per-sample constant's rows where the sample failed, the batch
        sums (the shared constants' cotangents, at) if any sample did."""
        plan, lane = call[0][0], call[2][4]
        bad = lane[3] != 0
        anyb = bad.any()
        masks = [bad[:, None]]
        for lay in plan.const_layouts:
            masks.append(bad[None, :] if lay[0] in ("batch", "bvec")
                         else anyb)
        return masks + [anyb, None, None]

    def params(p, dtype, n=4):
        return tuple(p[k].to(dtype).clone().requires_grad_()
                     for k in ("w1", "b1", "w2", "b2")[:n])

    def sgd(q, loss):
        grads = torch.autograd.grad(loss, q)
        with torch.no_grad():
            for x, g_ in zip(q, grads):
                x -= SGD_LR * g_
        return grads

    def update(q, loss):
        """A timed step's update, left unapplied: every timed step (and
        each path it is compared with) runs at the same weights."""
        grads = torch.autograd.grad(loss, q)
        return [x.detach() - SGD_LR * g_ for x, g_ in zip(q, grads)]

    def check(tag, q0, q, grads, want, fb, failed=False):
        """The launches, no fallback, and the gradients: finite and the
        weights moved, or, after a sweep that failed (`failed`: its status
        not 0), every gradient NaN, as the front end's contract says."""
        got = launches()
        moved = max(float((a.detach() - b).abs().max())
                    for a, b in zip(q, q0))
        print(f"[{tag}] launches {got}; fallbacks {fast.fuse_fallbacks - fb}"
              f"; weights moved {moved:.3e}", flush=True)
        ok = (all(torch.isnan(g_).all() for g_ in grads) if failed else
              moved > 0.0 and all(torch.isfinite(g_).all() for g_ in grads))
        if any(got[k] != v for k, v in want.items()) \
                or fast.fuse_fallbacks != fb or not ok:
            raise AssertionError(f"[{tag}] launches {got}, want {want}; "
                                 f"gradients as the sweep's status: {ok}")

    t = torch.linspace(0.0, SPAN, T_OUT)

    _at("33")
    # [33] P1: the spiral training step (bench.py:842-895) on K2 + K3.
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        q = params(p, dtype)
        q0 = [x.detach().clone() for x in q]
        target = _bench_target(dtype, dev)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_adjoint_solve") as r:
            ys = odeint_adjoint(_spiral_params_func, y, t.to(dtype),
                                params=q, rtol=TOL, atol=TOL,
                                options={"fuse": True})
            grads = sgd(q, torch.mean((ys - target) ** 2))
        check(f"33 {dtype}", q0, q, grads, {"K2": 1, "K3": 1}, fb)
        rec["launches"]["K3"] += 1
        err, plain_ms = hold(r.calls[0], cpl.plan_adjoint_solve_plain,
                             cpl.plan_adjoint_solve,
                             f"[33] K15 in K3 {dtype}")
        if dtype == f32:
            rec["err"]["K3"], rec["plain_ms"]["K3"] = err, plain_ms
            a3, k3, g3 = r.calls[0]
            rec["k3_stats"] = g3[3].tolist()
            rec["aug_flops"] = _plan_aug_flops(a3[0])
            rec["n_consts"] = sum(x.numel() for x in a3[1])
    rec["ms"]["K3"] = _timed(lambda: cpl.plan_adjoint_solve(*a3, **k3),
                             reps=3)
    rec.setdefault("walk", {})["K3"] = _walk_of(cpl, "adjoint")
    # K3's MLP route on the same trajectory, cotangent and weights.
    p, y, _ = _bench_params(B, f32, dev)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    warr, dims = ck.pack_mlp_weights(W, f32, dev)
    ys3, g3_, tau3, dt03 = a3[2], a3[3], a3[4], a3[5]
    rec["mlp_route_ms"]["K3"] = _timed(lambda: ca.mlp_adjoint_solve(
        warr, dims, ys3, g3_, tau3, dt03, TOL, TOL, 1.0, activation="tanh",
        input_power=3), reps=3)
    target = _bench_target(f32, dev)
    q = params(p, f32)

    def fused_step():
        ys_ = odeint_adjoint(_spiral_params_func, y, t, params=q, rtol=TOL,
                             atol=TOL, options={"fuse": True})
        update(q, torch.mean((ys_ - target) ** 2))

    Wm = [(x.clone().requires_grad_(), b.clone().requires_grad_())
          for x, b in W]

    def mlp_step():
        ys_ = fast.odeint_adjoint_mlp(spec, Wm, y, t, rtol=TOL, atol=TOL)
        update([x for pair in Wm for x in pair],
            torch.mean((ys_ - target) ** 2))

    def generic_step():
        ys_ = odeint_adjoint(_spiral_params_func, y, t, params=q, rtol=TOL,
                             atol=TOL)
        update(q, torch.mean((ys_ - target) ** 2))

    fused_step()
    rec["step_ms"]["K3"] = _host_ms(fused_step)[0]
    mlp_step()
    rec["mlp_route_step_ms"]["K3"] = _host_ms(mlp_step)[0]
    rec["generic_ms"]["K3"] = _host_ms(generic_step, reps=1)[0]
    print(f"[33] {smi}: K15 in K3 {rec['ms']['K3']:.3f} ms a sweep (stats "
          f"{rec['k3_stats']}) vs K3's MLP route "
          f"{rec['mlp_route_ms']['K3']:.3f} ms on the same inputs; plain "
          f"{rec['plain_ms']['K3']:.1f} ms. Step: fused "
          f"{rec['step_ms']['K3']:.3f} ms (median of 3) vs odeint_adjoint_mlp "
          f"{rec['mlp_route_step_ms']['K3']:.3f} ms vs the generic "
          f"odeint_adjoint {rec['generic_ms']['K3']:.3f} ms (one step); "
          f"walk {rec['walk']['K3']}", flush=True)

    _at("34")
    # [34] P2: per-sample training of the stiffness battery
    # (bench.py:483-535) on K5 + K6, in float32; then the spiral per sample
    # at the bench protocol, where every sample finishes, in both types.
    t5 = torch.linspace(0.0, STIFF_SPAN, STIFF_T)
    p, y, _ = _bench_params(B, f32, dev)
    battery_sc = torch.tensor(np.logspace(0.0, 2.0, B), dtype=f32,
                              device=dev)
    q = params(p, f32, 3)
    q0 = [x.detach().clone() for x in q]
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    with _Recording(cpl, "plan_perlane_adjoint_solve") as r:
        ys = odeint_adjoint(_battery_func(battery_sc), y, t5, params=q,
                            rtol=TOL, atol=TOL,
                            options={"fuse": True, "per_sample": True})
        grads = sgd(q, torch.sum(ys ** 2))
    a6, k6, g6 = r.calls[0]
    bst, lane_st = g6[3], g6[4]
    n_failed = int((lane_st[3] != 0).sum())
    lane = lane_st[0].float()
    print(f"[34] battery float32: backward stats {bst.tolist()}; the "
          f"samples' backward nfe min {lane.min():.0f}, median "
          f"{lane.median():.0f}, max {lane.max():.0f}; {n_failed} samples "
          "ended with a status (their reverse-time sweep underflows dt: NaN "
          "gradients)", flush=True)
    check("34 battery float32", q0, q, grads, {"K5": 1, "K6": 1, "K3": 0},
          fb, failed=int(bst[3]) != 0)
    rec["launches"]["K6"] += 1
    rec["err"]["K6"] = 0.0
    rec["k6_spiral"] = {}

    def k6_done(key):
        """A `_LaterHolds` job's `done` for a K6 hold: the largest error
        over the three, the plain time of `key` (None: the battery's)."""
        def done(err, plain_ms):
            rec["err"]["K6"] = max(rec["err"]["K6"], err)
            if key is None:
                rec["plain_ms"]["K6"] = plain_ms
            else:
                rec["k6_spiral"][key] = plain_ms
        return done

    hold_later(r.calls[0], cpl.plan_perlane_adjoint_solve_plain,
               cpl.plan_perlane_adjoint_solve,
               "[34] K15 in K6, battery float32", k6_done(None),
               failed_masks(r.calls[0]))
    rec["k6_failed_samples"] = n_failed
    rec["k6_nfe"] = int(bst[0])
    rec["ms"]["K6"] = _timed(lambda: cpl.plan_perlane_adjoint_solve(
        *a6, **k6), reps=3)
    rec.setdefault("walk", {})["K6"] = _walk_of(cpl, "perlane_adjoint")
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        q = params(p, dtype)
        q0 = [x.detach().clone() for x in q]
        target = _bench_target(dtype, dev)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_perlane_adjoint_solve") as r:
            ys = odeint_adjoint(_spiral_params_func, y, t.to(dtype),
                                params=q, rtol=TOL, atol=TOL,
                                options={"fuse": True, "per_sample": True})
            grads = sgd(q, torch.mean((ys - target) ** 2))
        check(f"34 spiral {dtype}", q0, q, grads,
              {"K5": 1, "K6": 1, "K3": 0}, fb)
        a_, k_, g_ = r.calls[0]
        if int((g_[4][3] != 0).sum()) != 0:
            raise AssertionError(f"[34] spiral {dtype}: a sample's backward "
                                 f"sweep failed: stats {g_[3].tolist()}")
        rec["launches"]["K6"] += 1
        hold_later(r.calls[0], cpl.plan_perlane_adjoint_solve_plain,
                   cpl.plan_perlane_adjoint_solve,
                   f"[34] K15 in K6, spiral {dtype}",
                   k6_done("plain_ms" if dtype == f32 else "plain_ms_f64"))
        if dtype == f32:
            rec["k6_spiral"].update({
                "nfe": int(g_[3][0]),
                "ms": _timed(lambda: cpl.plan_perlane_adjoint_solve(
                    *a_, **k_), reps=3)})
    p, y, _ = _bench_params(B, f32, dev)
    q = params(p, f32, 3)

    def battery_step(per_sample):
        def step():
            ys_ = odeint_adjoint(_battery_func(battery_sc), y, t5, params=q,
                                 rtol=TOL, atol=TOL,
                                 options={"fuse": True,
                                          "per_sample": per_sample})
            update(q, torch.sum(ys_ ** 2))
        return step

    battery_step(True)()
    rec["step_ms"]["K6"] = _host_ms(battery_step(True))[0]
    # The nearest route: the same battery under one shared controller
    # (K2 + K3), what a controller a sample is measured against.
    battery_step(False)()
    rec["mlp_route_step_ms"]["K6"] = None
    rec["shared_controller_step_ms"] = _host_ms(battery_step(False))[0]
    rec["generic_ms"]["K6"] = None
    sp = rec["k6_spiral"]
    print(f"[34] {smi}: K15 in K6 {rec['ms']['K6']:.3f} ms a float32 "
          f"battery sweep (the samples' nfe {rec['k6_nfe']}; "
          f"{_k6_layout(B)}). The spiral per sample "
          f"{sp['ms']:.3f} ms (nfe {sp['nfe']}). Battery step: per-sample {rec['step_ms']['K6']:.3f} ms vs "
          f"the shared controller (K2 + K3) "
          f"{rec['shared_controller_step_ms']:.3f} ms (medians of 3); walk "
          f"{rec['walk']['K6']}", flush=True)

    _at("35")
    # [35] P3: coupled training on K2's batch route and K3's batch-wide
    # walk, cut at each coupling and its transpose.
    tc = torch.linspace(0.0, PLAN_SPAN, PLAN_T)
    rec["coupled"] = {}
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        tgt = torch.tensor(np.random.RandomState(1).randn(
            PLAN_T, PLAN_B, PLAN_D), dtype=dtype, device=dev)
        for name, f in _coupled_params_funcs().items():
            w = torch.tensor(np.random.RandomState(0).randn(PLAN_D, PLAN_D)
                             * 0.3, dtype=dtype, device=dev)
            q = (w.requires_grad_(),)
            q0 = [w.detach().clone()]
            cpl.reset_launch_counts()
            fb = fast.fuse_fallbacks
            with _Recording(cpl, "plan_adjoint_solve") as r:
                ys = odeint_adjoint(f, y, tc.to(dtype), params=q, rtol=TOL,
                                    atol=1e-8, options={"fuse": True})
                grads = sgd(q, torch.mean((ys - tgt) ** 2))
            check(f"35 {name} {dtype}", q0, q, grads, {"K2": 1, "K3": 1},
                  fb)
            rec["launches"]["K3"] += 1
            err, plain_ms = hold(r.calls[0], cpl.plan_adjoint_solve_plain,
                                 cpl.plan_adjoint_solve,
                                 f"[35] K15 {name} in K3 (batch-wide) "
                                 f"{dtype}")
            if dtype == f32:
                a_, k_, g_ = r.calls[0]
                ms = _timed(lambda: cpl.plan_adjoint_solve(*a_, **k_),
                            reps=3)

                def gen_step():
                    ys_ = odeint_adjoint(f, y, tc, params=q, rtol=TOL,
                                         atol=1e-8)
                    update(q, torch.mean((ys_ - tgt) ** 2))

                def fused_c():
                    ys_ = odeint_adjoint(f, y, tc, params=q, rtol=TOL,
                                         atol=1e-8, options={"fuse": True})
                    update(q, torch.mean((ys_ - tgt) ** 2))

                rec["coupled"][name] = {
                    "ms": ms, "plain_ms": plain_ms,
                    "nfe": int(g_[3][0]), "step_ms": _host_ms(fused_c)[0],
                    "generic_step_ms": _host_ms(gen_step, reps=1)[0],
                    "aug_flops": _plan_aug_flops(a_[0])}
                rec["err"]["K3"] = max(rec["err"]["K3"], err)
                c_ = rec["coupled"][name]
                print(f"[35] {smi}: {name} K15 in K3 {ms:.3f} ms a sweep "
                      f"(nfe {c_['nfe']}); plain {plain_ms:.1f} ms; step "
                      f"{c_['step_ms']:.3f} ms vs the generic odeint_adjoint"
                      f" {c_['generic_step_ms']:.3f} ms", flush=True)

    _at("36")
    # [36] P4: fixed-grid training, rk4 x 500 forward (K8) and 8 steps an
    # interval backward (K9), [12]'s grid.
    fx = dict(method="rk4", options={"fuse": True, "num_steps": 500},
              adjoint_options={"num_steps": 8})
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        q = params(p, dtype)
        q0 = [x.detach().clone() for x in q]
        target = _bench_target(dtype, dev)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_adjoint_solve_fixed") as r:
            ys = odeint_adjoint(_spiral_params_func, y, t.to(dtype),
                                params=q, **fx)
            grads = sgd(q, torch.mean((ys - target) ** 2))
        check(f"36 {dtype}", q0, q, grads, {"K8": 1, "K9": 1}, fb)
        rec["launches"]["K9"] += 1
        err, plain_ms = hold(r.calls[0], cpl.plan_adjoint_solve_fixed_plain,
                             cpl.plan_adjoint_solve_fixed,
                             f"[36] K15 in K9 {dtype}")
        if dtype == f32:
            rec["err"]["K9"], rec["plain_ms"]["K9"] = err, plain_ms
            a9, k9, g9 = r.calls[0]
            rec["k9_nfe"] = int(g9[3][0])
    rec["ms"]["K9"] = _timed(lambda: cpl.plan_adjoint_solve_fixed(
        *a9, **k9), reps=3)
    rec.setdefault("walk", {})["K9"] = _walk_of(cpl, "fixed_adjoint")
    p, y, _ = _bench_params(B, f32, dev)
    rec["mlp_route_ms"]["K9"] = _timed(lambda: cf.mlp_adjoint_solve_fixed(
        warr, dims, a9[2], a9[3], a9[4], 1.0, num_steps=8, method="rk4",
        activation="tanh", input_power=3), reps=3)
    q = params(p, f32)
    target = _bench_target(f32, dev)

    def fixed_step():
        ys_ = odeint_adjoint(_spiral_params_func, y, t, params=q, **fx)
        update(q, torch.mean((ys_ - target) ** 2))

    Wm = [(x.clone().requires_grad_(), b.clone().requires_grad_())
          for x, b in W]

    def mlp_fixed_step():
        ys_ = fast.odeint_adjoint_mlp(spec, Wm, y, t, method="rk4",
                                      num_steps=500, adjoint_num_steps=8)
        update([x for pair in Wm for x in pair],
            torch.mean((ys_ - target) ** 2))

    def generic_fixed_step():
        ys_ = odeint_adjoint(_spiral_params_func, y, t, params=q,
                             method="rk4", options={"num_steps": 500},
                             adjoint_options={"num_steps": 8})
        update(q, torch.mean((ys_ - target) ** 2))

    fixed_step()
    rec["step_ms"]["K9"] = _host_ms(fixed_step)[0]
    mlp_fixed_step()
    rec["mlp_route_step_ms"]["K9"] = _host_ms(mlp_fixed_step)[0]
    rec["generic_ms"]["K9"] = _host_ms(generic_fixed_step, reps=1)[0]
    print(f"[36] {smi}: K15 in K9 {rec['ms']['K9']:.3f} ms a sweep (nfe "
          f"{rec['k9_nfe']}) vs K9's MLP route "
          f"{rec['mlp_route_ms']['K9']:.3f} ms on the same inputs; plain "
          f"{rec['plain_ms']['K9']:.1f} ms. Step: fused "
          f"{rec['step_ms']['K9']:.3f} ms vs odeint_adjoint_mlp "
          f"{rec['mlp_route_step_ms']['K9']:.3f} ms vs the generic "
          f"odeint_adjoint {rec['generic_ms']['K9']:.3f} ms (one step); "
          f"walk {rec['walk']['K9']}", flush=True)

    # Bounds: the evaluations of these runs' inputs.
    af, nc = rec["aug_flops"], rec["n_consts"]
    traj = 2 * T_OUT * B * D + B * D + 2 * nc + T_OUT
    rec["bound"]["K3"] = _bound(B * rec["k3_stats"][0] * af, 4 * traj)
    print(f"[33] {smi}: K15 in K3 {rec['ms']['K3']:.3f} ms a sweep against "
          f"its bound {rec['bound']['K3'][0]:.5f} ms "
          f"({rec['bound']['K3'][1]}; n_blocks "
          f"{ck.solve_blocks(B, dev)})", flush=True)
    rec["bound"]["K6"] = _bound(rec["k6_nfe"] * af,
                                4 * (2 * STIFF_T * B * D + B * D + 2 * nc
                                     + 2 * B + STIFF_T))
    rec["bound"]["K9"] = _bound(B * rec["k9_nfe"] * af, 4 * traj)
    return rec


#: [37]-[38]: the hypersolver example's batch and hidden width
#: (examples/hypersolver.py defaults: 32 steps over [0, 2]).
HYPER_B, HYPER_H = 4096, 32


def _launch_ms(module, call, reps=7) -> float:
    """Median device ms of the plan library launch inside `call`: CUDA
    events recorded on the stream right before and after the ctypes call
    of `module._fn`'s launch function, behind a queued sleep (so that the
    start event waits on the card and the launch is queued before it
    runs): the window holds the kernel and none of the wrapper's host
    work."""
    import torch
    fn0, times = module._fn, []

    def timed_fn(lib, host, dtype):
        launch = fn0(lib, host, dtype)

        def run(*a):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SLEEP_CYCLES)
            s.record()
            err = launch(*a)
            e.record()
            times.append((s, e))
            return err
        return run

    module._fn = timed_fn
    try:
        call()
        for _ in range(reps):
            call()
    finally:
        module._fn = fn0
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times[1:])


def _hyper_funcs(dtype, dev, B=HYPER_B):
    """The example's dynamics y^3 A, its 5 -> 32 -> 2 tanh hypernet with the
    weights `init_hypernet` draws from seed 0, and B states from its disk
    sampler (radius 1, seed 1)."""
    import torch
    from tfdiffeq_tpu_torch.examples import hypersolver as hx
    params = {k: v.detach() for k, v in hx.init_hypernet(
        torch.Generator().manual_seed(0), HYPER_H, dev, dtype).items()}
    return (hx.dynamics(dev, dtype), hx.hypernet(params),
            hx.disk(np.random.RandomState(1), B, 1.0, dev, dtype))


def _late_pairs(dev):
    """Every (plan, host) that phases 37-40 run: the bench spiral in K10
    and K11, the example's two plans in K12; they build with [28]'s."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    t0 = torch.tensor(0.0, device=dev)
    p, _, _ = _bench_params(8, torch.float32, dev)
    spiral, _ = pb.build_plan(_spiral_func(p), t0, torch.ones(8, D,
                                                             device=dev))
    f, g, y0 = _hyper_funcs(torch.float32, dev, B=8)
    plan_f, _ = pb.build_plan(f, t0, y0)
    plan_g, _ = pb.build_plan(lambda tt, ss: g(tt, ss[:, :D], ss[:, D:]),
                              t0, torch.cat([y0, f(t0, y0)], 1), out_dim=D)
    return [(spiral, "adams"), (spiral, "vcabm"), ((plan_f, plan_g),
                                                   "hyper")]


def _hyper_adams_tier(smi: str, dev) -> dict:
    """Phases 37-40: K12 (the hypersolvers, two plans) and K14 inside K10
    and K11. Returns K12's record and K14's numbers in K10, K11 and K12."""
    import torch
    from tfdiffeq_tpu_torch import fast, odeint_adjoint, solve
    from tfdiffeq_tpu_torch.examples import hypersolver as hx
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, \
        cuda_kernels as ck, cuda_plan as cpl, plan_bridge as pb
    from tfdiffeq_tpu_torch.ops.tableaus import RK4
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    f32, f64 = torch.float32, torch.float64
    rec = {"ms": {}, "plain_ms": {}, "err": {}, "bound": {},
           "mlp_route_ms": {}, "generic_ms": {},
           "launches": {"K10": 0, "K11": 0, "K12": 0}}

    def hold(call, plain, kernel, what):
        """A recorded launch against its plain version, and run again."""
        err, plain_ms = _hold_to_plain(call, plain, what)
        args, kw, got = call
        if not all(torch.equal(a, b) for a, b in zip(got, kernel(*args,
                                                                 **kw))):
            raise AssertionError(f"{what}: two kernel runs differ")
        return err, plain_ms

    _at("37")
    # [37] K12 through fast.solve_hyper: the three kinds on the output grid
    # (33 nodes over [0, 2]), num_steps=32 with 9 outputs, and reverse time
    # with step_size, float32 and float64, each launch held to its plain
    # version.
    cases = (("t", torch.linspace(0.0, 2.0, 33), {}),
             ("num_steps", torch.linspace(0.0, 2.0, 9), {"num_steps": 32}),
             ("reverse", torch.linspace(2.0, 0.0, 5), {"step_size": 0.0625}))
    k12, layouts = {}, {}
    for dtype in (f32, f64):
        for Bx in GROUP_BATCHES:
            f, g, y0 = _hyper_funcs(dtype, dev, B=Bx)
            for method in ("hyper_euler", "hyper_midpoint", "hyper_heun"):
                for case, t, opts in cases:
                    cpl.reset_launch_counts()
                    with _Recording(cpl, "plan_solve_hyper") as r:
                        res = fast.solve_hyper(f, g, y0, t.to(dtype),
                                               method=method, **opts)
                    torch.cuda.synchronize()
                    what = f"[37] K12 {method} {case} B={Bx} {dtype}"
                    if cpl.plan_hyper_launches != 1 or len(r.calls) != 1 \
                            or res.stats.status != 0 \
                            or not torch.isfinite(res.ys).all():
                        raise AssertionError(
                            f"{what}: launches {cpl.plan_hyper_launches}, "
                            f"stats {res.stats}")
                    layouts[Bx] = cpl.last_layout["hyper"]
                    if layouts[Bx]["threads_a_sample"] != cpl.hyper_group(Bx):
                        raise AssertionError(f"{what}: layout {layouts[Bx]}")
                    err, plain_ms = hold(r.calls[0],
                                         cpl.plan_solve_hyper_plain,
                                         cpl.plan_solve_hyper, what)
                    k12[(dtype, Bx, method, case)] = (r.calls[0], err,
                                                      plain_ms)
    print(f"[37] K12: {len(k12)} launches bitwise equal to their plain "
          f"versions, each run again bitwise; constants {cpl.last_route}",
          flush=True)
    for Bx, lay in layouts.items():
        print(f"[37] K12 at B = {Bx}: {_layout_str(lay)} (as the launch "
              "reported)", flush=True)
    rec["k12_layouts"] = {f"B={b}": lay for b, lay in layouts.items()}
    rec["k12_err"] = max(e for (dt_, _, _, _), (_, e, _) in k12.items()
                         if dt_ == f32)
    rec["k12_ms_by_kind"], rec["k12_plain_ms_by_kind"] = {}, {}
    for method in ("hyper_euler", "hyper_midpoint", "hyper_heun"):
        (args, kw, got), _, plain_ms = k12[(f32, HYPER_B, method, "t")]
        # The CUDA-event window of a call holds the wrapper's host work
        # too (the constants' flattening, the grid's copy).
        ms = _timed(lambda: cpl.plan_solve_hyper(*args, **kw))
        rec["k12_ms_by_kind"][method] = ms
        rec["k12_plain_ms_by_kind"][method] = plain_ms
        kern_ms = _launch_ms(cpl, lambda: cpl.plan_solve_hyper(*args, **kw))
        rec.setdefault("k12_kernel_ms_by_kind", {})[method] = kern_ms
        print(f"[37] {smi}: K12 {method} the kernel's own device time "
              f"{kern_ms:.4f} ms (CUDA events around the launch alone; the "
              f"wrapper's call {ms:.3f} ms)", flush=True)
        plan_f, plan_g = args[0], args[1]
        evals = 1 if method == "hyper_euler" else 2
        G, T_ = args[6].shape[0], args[5].shape[0]
        n_c = sum(x.numel() for x in args[2]) + sum(x.numel()
                                                    for x in args[3])
        bound = _bound(HYPER_B * (G - 1) * (evals * _plan_flops(plan_f)
                                            + _plan_flops(plan_g) + 8 * D),
                       4 * (HYPER_B * D + T_ * HYPER_B * D + n_c + G + T_))
        rec.setdefault("k12_bound_by_kind", {})[method] = bound
        print(f"[37] {smi}: K12 {method} {ms:.3f} ms a call (B = "
              f"{HYPER_B}, {G - 1} steps, nfe {got[1][0].item()}) vs plain "
              f"{plain_ms:.1f} ms; bound {bound[0]:.5f} ms ({bound[1]}; f "
              f"{_plan_flops(plan_f)}, g {_plan_flops(plan_g)} operations a "
              "sample)", flush=True)
    args, kw, _ = k12[(f32, 256, "hyper_euler", "t")][0]
    rec["k12_kernel_ms_b256"] = _launch_ms(
        cpl, lambda: cpl.plan_solve_hyper(*args, **kw))
    print(f"[37] {smi}: K12 hyper_euler at B = 256 the kernel's own device "
          f"time {rec['k12_kernel_ms_b256']:.4f} ms "
          f"({_layout_str(rec['k12_layouts']['B=256'])})", flush=True)
    rec["ms"]["K12"] = rec["k12_ms_by_kind"]["hyper_euler"]
    rec["plain_ms"]["K12"] = rec["k12_plain_ms_by_kind"]["hyper_euler"]
    rec["bound"]["K12"] = rec["k12_bound_by_kind"]["hyper_euler"]
    rec["err"]["K12"] = rec["k12_err"]

    _at("38")
    # [38] the hypersolver path through its entry points: odeint(fuse) is
    # one K12 launch and no fallback, within 2e-6 of the generic
    # hypersolver with its NFE; then the example at its defaults.
    f, g, y0 = _hyper_funcs(f32, dev)
    t = torch.linspace(0.0, 2.0, 33)
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    res = solve(f, y0, t, method="hyper_euler",
                options={"hypernet": g, "fuse": True})
    torch.cuda.synchronize()
    launches = cpl.plan_hyper_launches
    with torch.no_grad():
        gen = solve(f, y0, t, method="hyper_euler", options={"hypernet": g})
    gap = float((res.ys - gen.ys).abs().max())
    print(f"[38] solve(hyper_euler, fuse): K12 launches {launches}, "
          f"fallbacks {fast.fuse_fallbacks - fb}, nfe {res.stats.nfe} "
          f"(generic {gen.stats.nfe}); max |fused - generic| {gap:.3e} (bar "
          "2e-6)", flush=True)
    if launches != 1 or fast.fuse_fallbacks != fb or gap > 2e-6 \
            or res.stats.nfe != gen.stats.nfe or res.stats.status != 0:
        raise AssertionError("[38] the fused hypersolver path failed")
    rec["launches"]["K12"] += launches
    rec["k12_entry_ms"] = _host_ms(lambda: solve(
        f, y0, t, method="hyper_euler",
        options={"hypernet": g, "fuse": True}))[0]
    with torch.no_grad():
        rec["generic_ms"]["K12"] = _host_ms(lambda: solve(
            f, y0, t, method="hyper_euler", options={"hypernet": g}))[0]
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    ex = hx.main(["--iters", "300"])
    ex_launches = cpl.plan_hyper_launches
    print(f"[38] examples/hypersolver.py --iters 300: K12 launches "
          f"{ex_launches}, fallbacks {fast.fuse_fallbacks - fb}; max error "
          f"on fresh states: euler {ex['base_err']:.4e}, hypersolver "
          f"{ex['hyper_err']:.4e}, fused {ex['fused_err']:.4e}; fused "
          f"serving {ex['serve_ms']:.3f} ms a solve (B = 256, {smi})",
          flush=True)
    if ex_launches < 2 or fast.fuse_fallbacks != fb \
            or not ex["hyper_err"] < ex["base_err"]:
        raise AssertionError("[38] the example's hypersolver failed")
    rec["launches"]["K12"] += ex_launches
    rec["example"] = ex
    print(f"[38] {smi}: solve(hyper_euler, fuse) {rec['k12_entry_ms']:.3f} "
          f"ms (capture of both plans and one K12 launch) vs the generic "
          f"hypersolver {rec['generic_ms']['K12']:.3f} ms (B = {HYPER_B}, 32"
          " steps)", flush=True)

    _at("39")
    # [39] K14 in K10: the bench spiral as plain PyTorch, fixed_adams and
    # explicit_adams x 512 at the bench widths, through solve(fuse).
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    for method in ("fixed_adams", "explicit_adams"):
        for dtype in (f32, f64):
            p, y, _ = _bench_params(B, dtype, dev)
            t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
            cpl.reset_launch_counts()
            fb = fast.fuse_fallbacks
            with _Recording(cpl, "plan_solve_adams") as r:
                res = solve(_spiral_func(p), y, t, rtol=TOL, atol=TOL,
                            method=method, options={
                                "fuse": True, "num_steps": ADAMS_STEPS})
            torch.cuda.synchronize()
            per = 5 if method == "fixed_adams" else 1
            nfe = 1 + 4 * 3 + per * (ADAMS_STEPS - 3)
            print(f"[39] solve(spiral, method={method!r}, fuse, num_steps="
                  f"{ADAMS_STEPS}) {dtype}: K10 launches "
                  f"{cpl.plan_adams_launches}, fallbacks "
                  f"{fast.fuse_fallbacks - fb}, stats {res.stats}",
                  flush=True)
            if cpl.plan_adams_launches != 1 or fast.fuse_fallbacks != fb \
                    or res.stats.status != 0 or res.stats.nfe != nfe \
                    or not torch.isfinite(res.ys).all():
                raise AssertionError(f"[39] K14 in K10 {method} {dtype}")
            rec["launches"]["K10"] += 1
            err, plain_ms = hold(r.calls[0], cpl.plan_solve_adams_plain,
                                 cpl.plan_solve_adams,
                                 f"[39] K14 in K10 {method} {dtype}")
            if dtype != f32:
                continue
            args, kw, got = r.calls[0]
            key = "K10" if method == "fixed_adams" else "K10 explicit"
            rec["err"][key], rec["plain_ms"][key] = err, plain_ms
            rec["ms"][key] = _timed(lambda: cpl.plan_solve_adams(*args,
                                                                  **kw),
                                    reps=3)
            W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
            warr, dims = ck.pack_mlp_weights(W, f32, dev)
            f0 = fast.mlp_apply(spec, W, y)
            rec["mlp_route_ms"][key] = _timed(lambda: cad.mlp_solve_adams(
                warr, dims, y, t, args[4], TOL, TOL, 1.0, f0=f0,
                activation="tanh", input_power=3,
                implicit=method == "fixed_adams"), reps=3)
            with torch.no_grad():
                rec["generic_ms"][key] = _host_ms(lambda: solve(
                    _spiral_func(p), y, t, rtol=TOL, atol=TOL, method=method,
                    options={"num_steps": ADAMS_STEPS}), reps=1)[0]
            pf = _plan_flops(args[0])
            rec["bound"][key] = _bound(
                B * (nfe * pf + D * (3 * (_combine_flops(RK4) + 12)
                                     + (ADAMS_STEPS - 3) * _adams_step_flops(
                                         4, 4, method == "fixed_adams"))),
                4 * (2 * B * D + T_OUT * B * D + T_OUT + ADAMS_STEPS + 1
                     + sum(x.numel() for x in args[1])))
            print(f"[39] {smi}: K14 in K10 {method} {rec['ms'][key]:.3f} ms "
                  f"a solve vs K10's MLP route {rec['mlp_route_ms'][key]:.3f}"
                  f" ms vs the generic engine {rec['generic_ms'][key]:.3f} ms"
                  f" (nfe {nfe}); plain {plain_ms:.1f} ms; bound "
                  f"{rec['bound'][key][0]:.4f} ms ({rec['bound'][key][1]})",
                  flush=True)

    # explicit_adams' group launch on the plan route at the batches and
    # orders it takes (max_order 1 forward and 12 in reverse time on a
    # 40-step grid), float32 and float64, each held to its plain version.
    playouts = {}
    for dtype in (f32, f64):
        p, yb, _ = _bench_params(B, dtype, dev)
        t0 = torch.tensor(0.0, dtype=dtype, device=dev)
        plan, consts = pb.build_plan(_spiral_func(p), t0, yb)
        packed = pb.pack_consts(plan, consts, dtype, dev)
        t = torch.linspace(0.0, 0.25, 5, dtype=dtype)
        for Bx in GROUP_BATCHES:
            y = yb[:Bx].contiguous()
            for order, sign in ((1, 1.0), (12, -1.0)):
                tau = t if sign > 0 else (-t).flip(0)
                grid = uniform_grid(tau[0], tau[-1], 40)
                gfun = cpl.plan_rhs(plan, packed, torch.tensor(
                    sign, dtype=dtype, device=dev))
                f0 = gfun(grid[0].to(dev), y).contiguous()
                _held_launch(cpl.plan_solve_adams, cpl.plan_solve_adams_plain,
                             (plan, packed, y, tau, grid, TOL, TOL, sign, f0),
                             dict(implicit=False, max_order=order),
                             f"[39] K14 in explicit_adams B={Bx} max_order="
                             f"{order} {dtype}")
                playouts[Bx] = cpl.last_layout["adams"]
    for Bx, lay in playouts.items():
        print(f"[39] K14 in explicit_adams' K10, B = {Bx}: "
              f"{_layout_str(lay)} (as the launch reported)", flush=True)
    rec["explicit_plan_layouts"] = {f"B={b}": lay
                                    for b, lay in playouts.items()}

    _at("40")
    # [40] K14 in K11: VCABM at the bench protocol through
    # solve(method='adams', fuse) (bench.py:237-253), then one training
    # step through odeint_adjoint(fuse): tier 2, the fused forward with the
    # generic backward.
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_solve_vcabm") as r:
            res = solve(_spiral_func(p), y, t, rtol=TOL, atol=TOL,
                        method="adams",
                        options={"fuse": True, "first_step": FIRST_STEP})
        torch.cuda.synchronize()
        print(f"[40] solve(spiral, method='adams', fuse) {dtype}: K11 "
              f"launches {cpl.plan_vcabm_launches}, fallbacks "
              f"{fast.fuse_fallbacks - fb}, stats {res.stats}", flush=True)
        if cpl.plan_vcabm_launches != 1 or fast.fuse_fallbacks != fb \
                or res.stats.status != 0 or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[40] K14 in K11 {dtype}")
        rec["launches"]["K11"] += 1
        with _Orders() as o:
            err, plain_ms = hold(r.calls[0], cpl.plan_solve_vcabm_plain,
                                 cpl.plan_solve_vcabm,
                                 f"[40] K14 in K11 {dtype}")
        if dtype != f32:
            continue
        args, kw, got = r.calls[0]
        rec["err"]["K11"], rec["plain_ms"]["K11"] = err, plain_ms
        rec["ms"]["K11"] = _timed(lambda: cpl.plan_solve_vcabm(*args, **kw),
                                  reps=3)
        W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
        warr, dims = ck.pack_mlp_weights(W, f32, dev)
        f0 = fast.mlp_apply(spec, W, y)
        rec["mlp_route_ms"]["K11"] = _timed(lambda: cad.mlp_solve_vcabm(
            warr, dims, y, t, FIRST_STEP, TOL, TOL, 1.0, f0=f0,
            activation="tanh", input_power=3), reps=3)
        orders = o.orders
        nfe, acc, rej, _ = got[1].tolist()
        rec["bound"]["K11"] = _bound(
            B * (nfe * _plan_flops(args[0])
                 + D * (sum(_vcabm_attempt_flops(k) for k in orders)
                        + acc * _vcabm_accept_flops(
                            sum(orders) / len(orders)))),
            4 * (2 * B * D + T_OUT * B * D + T_OUT
                 + sum(x.numel() for x in args[1])))
        print(f"[40] {smi}: K14 in K11 {rec['ms']['K11']:.3f} ms a solve "
              f"(nfe {nfe}, {acc + rej} attempts, orders "
              f"{min(orders)}..{max(orders)}) vs K11's MLP route "
              f"{rec['mlp_route_ms']['K11']:.3f} ms; plain {plain_ms:.1f} "
              f"ms; bound {rec['bound']['K11'][0]:.4f} ms "
              f"({rec['bound']['K11'][1]})", flush=True)
    p, y, _ = _bench_params(B, f32, dev)
    t = torch.linspace(0.0, SPAN, T_OUT)
    q = [p["w1"].clone().requires_grad_(), p["b1"].clone().requires_grad_(),
         p["w2"].clone().requires_grad_(), p["b2"].clone().requires_grad_()]
    target = _bench_target(f32, dev)

    def step():
        ys = odeint_adjoint(_spiral_params_func, y, t, params=q, rtol=TOL,
                            atol=TOL, method="adams", adjoint_method="dopri5",
                            options={"fuse": True, "first_step": FIRST_STEP})
        torch.mean((ys - target) ** 2).backward()

    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    rec["train_step_ms"] = _host_ms(step, reps=1)[0]
    grads = [x.grad for x in q]
    print(f"[40] odeint_adjoint(method='adams', adjoint_method='dopri5', "
          f"fuse) step: K11 launches {cpl.plan_vcabm_launches}, fallbacks "
          f"{fast.fuse_fallbacks - fb}, {rec['train_step_ms']:.3f} ms (the "
          f"fused forward and the generic backward, {smi})", flush=True)
    if cpl.plan_vcabm_launches != 1 or fast.fuse_fallbacks != fb \
            or not all(torch.isfinite(x).all() for x in grads):
        raise AssertionError("[40] the Adams-forward fused training step "
                             "failed")
    rec["launches"]["K11"] += 1
    return rec


#: [41]'s rows: fast.solve_fused(dense_output=True)'s default S, which is
#: also its step budget; [43] gives the stiffness battery's forward more
#: (2345 attempts at B = 128 in a CPU rehearsal) and caps its backward at
#: BATTERY_BWD attempts an interval: in float32 the interpolated backward
#: took more than 8192 in three of its four intervals there, and 1024 ran
#: out in every interval on an H100 too (45 s); at some 10 ms an
#: attempt the run's time limit holds a quarter of that.
DENSE_S, DENSE_COUPLED_B, BATTERY_S, BATTERY_BWD = 1024, 33, 8192, 256
#: eval_flat at the output times against the trajectory: interior outputs
#: are the same Horner evaluation (equal bits are counted and printed); at
#: a step's end the trajectory holds the drain's Kahan-updated state, the
#: interpolant its value at x = 1, a sum of five planes: a few ulps of
#: the state (|y| <= 3 here) apart.
DENSE_EVAL_BARS = {"torch.float32": 1e-5, "torch.float64": 1e-12}
#: [42]: two continuous adjoints of one ODE (the resets sweep re-solves y
#: backward, the interpolated one reads the forward's interpolant) differ
#: by solver error, at rtol 1e-6 over 25 time units of the spiral. Held:
#: the largest gap over all four parameters' gradients relative to the
#: largest gradient entry (a CPU probe at B = 4096: 3.1e-3 in float32,
#: 1.6e-3 between the two adjoints in float64). Each parameter's own gap
#: is printed, not held: b1's and b2's gradients are sums over the batch
#: that cancel to 2.2e-2 and 2.0e-2 of their terms' magnitudes, so solver
#: error of 0.4% of the terms is 10-20% of those gradients; against a
#: direct float64 gradient both adjoints err so at rtol 1e-6 and converge
#: at 1e-8 (tools/torch_adjoint_gap.py, tests/test_torch_adjoint_gap.py).
INTERP_GRAD_BAR = 1e-2


def _dense_pairs(dev):
    """[41]'s coupled plan at B = 33 (a batch mean divides by B, a literal
    of the plan), built with [28]'s."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    f = _coupled_funcs(torch.float32, dev)["meanfield"]
    plan, _ = pb.build_plan(f, torch.tensor(0.0, device=dev),
                            torch.ones(DENSE_COUPLED_B, PLAN_D, device=dev))
    return [(plan, "solve")]


def _dense_tier(smi: str, dev) -> dict:
    """Phases 41-43: K2's per-step interpolant emission through
    `fast.solve_fused(dense_output=True)`, the interpolated adjoint's
    training step on it, and the stiffness battery under one controller
    with the interpolated adjoint. Returns the numbers K2's record gains."""
    import torch
    from tfdiffeq_tpu_torch import NFEMeter, fast, odeint_adjoint, solve
    from tfdiffeq_tpu_torch import adjoint as adj_mod
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5
    f32, f64 = torch.float32, torch.float64
    rec = {"launches": 0, "err": 0.0}

    def stats_last(fn):
        """plan_solve's dense result (out, stats, meta, coef) with the
        stats last, as `_hold_to_plain` reads it."""
        def call(*a, **k):
            out, st, meta, coef = fn(*a, **k)
            return out, meta, coef, st
        return call

    def hold(call, what):
        """A recorded emission launch against its plain version, bitwise;
        the same launch without the buffers (out and stats bitwise equal);
        the launch again (bitwise)."""
        args, kw, got = call
        out, st, meta, coef = got
        err, plain_ms = _hold_to_plain(
            (args, _grid_kw(cpl.plan_solve_plain, args, kw),
             (out, meta, coef, st)), stats_last(cpl.plan_solve_plain), what)
        kw0 = {k: v for k, v in kw.items() if k != "emit_dense"}
        out0, st0 = cpl.plan_solve(*args, **kw0)
        again = cpl.plan_solve(*args, **kw)
        same0 = torch.equal(out0, out) and torch.equal(st0, st)
        same1 = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"{what}: without the buffers out and stats bitwise equal: "
              f"{same0}; run again bitwise: {same1}", flush=True)
        if not (same0 and same1):
            raise AssertionError(f"{what}: the emission changed the solve "
                                 "or two runs differ")
        return err, plain_ms

    def eval_gap(res, tt, what):
        """eval_flat at the output times against ys (DENSE_EVAL_BARS)."""
        ev = res.dense.eval_flat(tt).reshape(res.ys.shape)
        n = res.stats.n_accepted
        ends = torch.isin(res.dense.sign.to(dev) * tt.to(dev),
                          res.dense.t1s[:n])
        gap = float((ev - res.ys).abs().max())
        inner = ~ends
        inner[0] = False
        n_eq = int(sum(torch.equal(ev[i], res.ys[i])
                       for i in torch.nonzero(inner).flatten().tolist()))
        bar = DENSE_EVAL_BARS[str(tt.dtype)]
        print(f"{what}: eval_flat at the {tt.shape[0]} outputs within "
              f"{gap:.3e} of ys (bar {bar:g}); {int(ends.sum())} outputs at "
              f"a step's end; {n_eq} of {int(inner.sum())} interior outputs "
              "bitwise equal", flush=True)
        if not gap <= bar:
            raise AssertionError(f"{what}: eval_flat off the trajectory")

    t = torch.linspace(0.0, SPAN, T_OUT)

    _at("41")
    # [41] K2's emission at the bench protocol through
    # fast.solve_fused(dense_output=True), the spiral as plain PyTorch.
    for dtype in (f32, f64):
        p, y, _ = _bench_params(B, dtype, dev)
        tt = t.to(dtype)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_solve") as r:
            res = fast.solve_fused(_spiral_func(p), y, tt, rtol=TOL,
                                   atol=TOL, first_step=FIRST_STEP,
                                   dense_output=True)
        torch.cuda.synchronize()
        n_l, emit = cpl.plan_solve_launches, [c[1].get("emit_dense")
                                              for c in r.calls]
        print(f"[41] solve_fused(spiral, dense_output=True) {dtype}: K2 "
              f"launches {n_l} (emit_dense {emit}), fallbacks "
              f"{fast.fuse_fallbacks - fb}, stats {list(res.stats)}",
              flush=True)
        if n_l != 1 or emit != [DENSE_S] or res.stats.status != 0 \
                or fast.fuse_fallbacks != fb \
                or tuple(res.ys.shape) != (T_OUT, B, D) \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[41] the dense fused spiral {dtype}")
        rec["launches"] += 1
        err, plain_ms = hold(r.calls[0], f"[41] K2 with the emission "
                                         f"{dtype}")
        eval_gap(res, tt, f"[41] {dtype}")
        rec["err"] = max(rec["err"], err)
        if dtype == f32:
            rec["plain_ms"] = plain_ms
            a41, k41, g41 = r.calls[0]
    k0 = {k: v for k, v in k41.items() if k != "emit_dense"}
    ms = [_timed(lambda: cpl.plan_solve(*a41, **k0)),
          _timed(lambda: cpl.plan_solve(*a41, **k41)),
          _timed(lambda: cpl.plan_solve(*a41, **k41)),
          _timed(lambda: cpl.plan_solve(*a41, **k0))]
    rec["no_emission_ms"] = statistics.median([ms[0], ms[3]])
    rec["ms"] = statistics.median([ms[1], ms[2]])
    nfe, nacc, nrej, _ = g41[1].tolist()
    nc = sum(x.numel() for x in a41[1])
    emit_bytes = 5 * nacc * B * D * 4 + 3 * nacc * 4
    base = (B * (nfe * _plan_flops(a41[0]) + (nacc + nrej) * D
                 * _combine_flops(DOPRI5)),
            4 * (2 * B * D + T_OUT * B * D + T_OUT + nc))
    rec["bound"] = _bound(base[0], base[1] + emit_bytes)
    rec["emission_bound_ms"] = emit_bytes / _peaks().PEAK_HBM_BYTES * 1e3
    print(f"[41] {smi}: K2 (plan route) with the emission {rec['ms']:.3f} ms"
          f" vs without {rec['no_emission_ms']:.3f} ms (CUDA events, "
          f"without/with/with/without: {', '.join(f'{x:.3f}' for x in ms)});"
          f" the emission's {nacc} rows, {emit_bytes} bytes, bound "
          f"{rec['emission_bound_ms']:.4f} ms; the solve's bound "
          f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]}); plain "
          f"{rec['plain_ms']:.1f} ms", flush=True)

    # The coupled plan at B = 33 on K2's batch route.
    tc = torch.linspace(0.0, PLAN_SPAN, PLAN_T)
    for dtype in (f32, f64):
        yc = torch.tensor(np.random.RandomState(0).randn(DENSE_COUPLED_B,
                                                         PLAN_D),
                          dtype=dtype, device=dev)
        f = _coupled_funcs(dtype, dev)["meanfield"]
        cpl.reset_launch_counts()
        with _Recording(cpl, "plan_solve") as r:
            res = fast.solve_fused(f, yc, tc.to(dtype), rtol=TOL, atol=1e-8,
                                   dense_output=True)
        if cpl.plan_solve_launches != 1 or res.stats.status != 0 \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[41] coupled B=33 {dtype}: launches "
                                 f"{cpl.plan_solve_launches}, stats "
                                 f"{res.stats}")
        rec["launches"] += 1
        err, _ = hold(r.calls[0], f"[41] K2 batch route (meanfield, B = 33) "
                                  f"with the emission {dtype}")
        rec["err"] = max(rec["err"], err)
        eval_gap(res, tc.to(dtype), f"[41] coupled {dtype}")

    # Telemetry of the generic engine on the card.
    p, y, _ = _bench_params(B, f32, dev)
    with torch.no_grad():
        tr = solve(_spiral_func(p), y, t, rtol=TOL, atol=TOL,
                   options={"telemetry": True, "first_step": FIRST_STEP})
    tel, st = tr.telemetry, tr.stats
    ok = (int(tel.accepted.sum()) == st.n_accepted
          and tel.t0.shape[0] == st.n_accepted + st.n_rejected
          and bool(tel.active.all()) and bool((tel.dt > 0).all()))
    print(f"[41] solve(options={{'telemetry': True}}) on the card: stats "
          f"{list(st)}; {tel.t0.shape[0]} attempts, "
          f"{int(tel.accepted.sum())} accepted; dt from "
          f"{float(tel.dt.min()):.4g} to {float(tel.dt.max()):.4g}; agree "
          f"with the stats: {ok}", flush=True)
    if not ok or st.status != 0:
        raise AssertionError("[41] telemetry disagrees with the stats")

    _at("42")
    # [42] the interpolated spiral training step at the bench training
    # protocol (float32): one K2 launch with the emission, the generic
    # backward reading its interpolants; against [33]'s resets-mode fused
    # step (K2 + K3) at the same weights.
    target = _bench_target(f32, dev)

    def step(mode, meter=None):
        q = tuple(p[k].clone().requires_grad_()
                  for k in ("w1", "b1", "w2", "b2"))
        ys_ = odeint_adjoint(_spiral_params_func, y, t, params=q, rtol=TOL,
                             atol=TOL, adjoint_mode=mode,
                             options={"fuse": True}, nfe_meter=meter)
        return torch.autograd.grad(torch.mean((ys_ - target) ** 2), q)

    meter = NFEMeter()
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    with _Recording(cpl, "plan_solve") as r:
        gi = step("interpolated", meter)
    torch.cuda.synchronize()
    got = (cpl.plan_solve_launches, cpl.plan_adjoint_launches)
    emit = [c[1].get("emit_dense") for c in r.calls]
    finite = all(bool(torch.isfinite(g).all()) for g in gi)
    print(f"[42] interpolated step: launches (K2, K3) {got}, emit_dense "
          f"{emit}, fallbacks {fast.fuse_fallbacks - fb}; NFE forward "
          f"{meter.f_nfe}, backward {meter.b_nfe} ({meter.b_steps} steps); "
          f"finite gradients {finite}", flush=True)
    if got != (1, 0) or emit != [DENSE_S] or fast.fuse_fallbacks != fb \
            or not finite:
        raise AssertionError("[42] the interpolated step")
    rec["launches"] += 1
    rmeter = NFEMeter()
    gr = step("resets", rmeter)
    gap = (max(float((a - b).abs().max()) for a, b in zip(gi, gr))
           / max(float(b.abs().max()) for b in gr))
    each = [f"{_rel(a, b):.3e}" for a, b in zip(gi, gr)]
    print(f"[42] gradients within {gap:.3e} of [33]'s resets-mode fused "
          f"step, relative to its largest entry (bar {INTERP_GRAD_BAR:g}); "
          f"each parameter's own (w1, b1, w2, b2) {each} (b1's and b2's "
          f"gradients cancel to about 2e-2 of their terms: solver error, "
          f"tools/torch_adjoint_gap.py); resets b-NFE {rmeter.b_nfe}",
          flush=True)
    if not gap <= INTERP_GRAD_BAR:
        raise AssertionError("[42] interpolated and resets gradients differ")
    # One timed interpolated step (a few seconds each) and a profile of the
    # card's activity alone keep [41]-[43] inside the run's time budget.
    rec["interp_step_ms"], _ = _host_ms(lambda: step("interpolated"),
                                            reps=1)
    rec["resets_step_ms"], all_r = _host_ms(lambda: step("resets"))
    host_ms, busy_ms, top = _profiled(lambda: step("interpolated"),
                                      cpu=False)
    rec["interp_b_nfe"], rec["resets_b_nfe"] = meter.b_nfe, rmeter.b_nfe
    rec["interp_idle"] = 1.0 - busy_ms / host_ms
    print(f"[42] {smi}: interpolated fused step {rec['interp_step_ms']:.3f}"
          f" ms (one warm step) "
          f"vs [33]'s resets-mode fused step {rec['resets_step_ms']:.3f} ms "
          f"({', '.join(f'{x:.3f}' for x in all_r)}); b-NFE {meter.b_nfe} "
          f"vs {rmeter.b_nfe}; a profiled interpolated step {host_ms:.1f} "
          f"ms on the host, {busy_ms:.1f} ms of kernels: the device idle "
          f"{rec['interp_idle']:.3f} of it; top kernels "
          f"{[(k[0][:40], round(k[1], 3), k[2]) for k in top]}", flush=True)

    _at("43")
    # [43] the stiffness battery (bench.py:483-535) under one shared
    # controller with the interpolated adjoint, tier 2: the measurement of
    # ROADMAP queue 3's finding. A NaN is allowed only where a status says
    # so; finiteness is reported, not required.
    t5 = torch.linspace(0.0, STIFF_SPAN, STIFF_T)
    sc = torch.tensor(np.logspace(0.0, 2.0, B), dtype=f32, device=dev)
    real_solve, bwd = adj_mod.solve, []

    def counted(*a, **k):
        res_ = real_solve(*a, **k)
        bwd.append(res_.stats)
        return res_

    def battery_step(meter=None):
        bwd.clear()
        q = tuple(p[k].clone().requires_grad_() for k in ("w1", "b1", "w2"))
        ys_, fst = odeint_adjoint(
            _battery_func(sc), y, t5, params=q, rtol=TOL, atol=TOL,
            adjoint_mode="interpolated", nfe_meter=meter, return_stats=True,
            options={"fuse": True, "max_num_steps": BATTERY_S},
            adjoint_options={"max_num_steps": BATTERY_BWD})
        return fst, torch.autograd.grad(torch.sum(ys_ ** 2), q)

    meter = NFEMeter()
    cpl.reset_launch_counts()
    adj_mod.solve = counted
    try:
        (fst, grads), step_ms = _host_call(lambda: battery_step(meter))
    finally:
        adj_mod.solve = real_solve
    b_status = max(s.status for s in bwd)
    finite = [bool(torch.isfinite(g).all()) for g in grads]
    all_nan = all(bool(torch.isnan(g).all()) for g in grads)
    rec["battery"] = {
        "forward_status": fst.status, "forward_nfe": fst.nfe,
        "backward_status": b_status,
        "backward_statuses": [s.status for s in bwd],
        "b_nfe": meter.b_nfe, "b_steps": meter.b_steps,
        "finite": all(finite), "step_ms": step_ms}
    print(f"[43] battery, one shared controller, interpolated adjoint: "
          f"K2 launches {cpl.plan_solve_launches} (emit_dense rows "
          f"{BATTERY_S}); forward stats {list(fst)}; backward statuses by "
          f"interval {rec['battery']['backward_statuses']} (budget "
          f"{BATTERY_BWD} attempts), b-NFE {meter.b_nfe} ({meter.b_steps} "
          f"steps); gradients finite {finite} (all NaN: {all_nan})",
          flush=True)
    print(f"[43] {smi}: battery step {step_ms:.3f} ms (one step; the same "
          "battery per sample, K5 + K6, is [34]'s)", flush=True)
    if cpl.plan_solve_launches != 1 or fst.status != 0:
        raise AssertionError("[43] the battery's fused forward")
    if not (all(finite) if b_status == 0 else all_nan):
        raise AssertionError("[43] a NaN gradient without a failed status, "
                             "or a failed backward with finite gradients")
    return rec


#: [44]-[47]: the steps of the coupled plans' fixed grids over PLAN_SPAN
#: (tests/test_meanfield.py:54-60), and K9's steps an observation interval.
COUPLED_STEPS, COUPLED_BWD_STEPS = 32, 8


def _coupled_pairs(dev):
    """Every (plan, host) that phases 44-47 run: [31]'s couplings on K8,
    K10, K11 and K9 (captured at their batch: a batch mean divides by B);
    they build with [28]'s."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    t0 = torch.tensor(0.0, device=dev)
    pairs = []
    for f in _coupled_funcs(torch.float32, dev).values():
        plan, _ = pb.build_plan(f, t0, torch.ones(PLAN_B, PLAN_D,
                                                  device=dev))
        pairs += [(plan, h) for h in ("fixed", "adams", "vcabm",
                                      "fixed_adjoint")]
    return pairs


def _coupled_tier(smi: str, dev, k2_coupled, k3_coupled) -> dict:
    """Phases 44-47: coupled plans on the one-block routes of K8, K10, K11
    and K9 (K14's and K15's coupled modes), through the entry points at
    [31]'s configuration (B = 4096, D = 3, 7 outputs over [0, 2]) in
    float32 and float64: every launch held bitwise to its plain version and
    run again, the launch counters and `fast.fuse_fallbacks` checked, the
    device ms beside the generic engine and [31]'s K2 / [35]'s K3 coupled
    routes (`k2_coupled`, `k3_coupled`) on the same dynamics. Returns a
    record a host."""
    import torch
    from tfdiffeq_tpu_torch import fast, odeint_adjoint, solve
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    from tfdiffeq_tpu_torch.ops.tableaus import FIXED_TABLEAUS_BY_NAME, RK4
    f32, f64 = torch.float32, torch.float64
    tc = torch.linspace(0.0, PLAN_SPAN, PLAN_T)
    recs = {h: {"launches": 0, "err": 0.0, "ms": {}, "plain_ms": {},
                "bound": {}, "generic_ms": {}}
            for h in ("K8", "K10", "K11", "K9")}
    traj = PLAN_T * PLAN_B * PLAN_D

    def launches():
        return {"K2": cpl.plan_solve_launches, "K8": cpl.plan_fixed_launches,
                "K10": cpl.plan_adams_launches,
                "K11": cpl.plan_vcabm_launches,
                "K3": cpl.plan_adjoint_launches,
                "K9": cpl.plan_fixed_adjoint_launches}

    def flat(fn):
        """A sweep's result flattened to tensors, the stats last."""
        def call(*a, **k):
            r = fn(*a, **k)
            return (r[0], *r[1], r[2], r[3])
        return call

    def hold(call, plain, kernel, what, sweep=False):
        """A recorded launch against its plain version (bitwise, the stats
        too), and run again bitwise."""
        args, kw, got = call
        if sweep:
            got, plain, kernel = flat(lambda *a, **k: got)(), flat(plain), \
                flat(kernel)
        err, plain_ms = _hold_to_plain((args, kw, got), plain, what)
        if not all(torch.equal(a, b)
                   for a, b in zip(got, kernel(*args, **kw))):
            raise AssertionError(f"{what}: two kernel runs differ")
        return err, plain_ms

    def entry(tag, want, fb, ok=True):
        got = launches()
        route = {h: cpl.last_route.get(h) for h in
                 ("fixed", "adams", "vcabm", "fixed_adjoint")}
        print(f"[{tag}] launches {got}, fallbacks {fast.fuse_fallbacks - fb}"
              f", constants {route}", flush=True)
        if any(got[k] != want.get(k, 0) for k in got) \
                or fast.fuse_fallbacks != fb or not ok:
            raise AssertionError(f"[{tag}] launches {got}, want {want}")

    def consts_n(args):
        return sum(x.numel() for x in args[1])

    _at("44")
    # [44] K8: rk4 and euler on COUPLED_STEPS steps through solve(fuse).
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        for name, f in _coupled_funcs(dtype, dev).items():
            for method in ("rk4", "euler"):
                cpl.reset_launch_counts()
                fb = fast.fuse_fallbacks
                with _Recording(cpl, "plan_solve_fixed") as r:
                    res = solve(f, y, tc.to(dtype), method=method,
                                options={"fuse": True,
                                         "num_steps": COUPLED_STEPS})
                torch.cuda.synchronize()
                entry(f"44 {name} {method} {dtype}", {"K8": 1}, fb,
                      res.stats.status == 0 and bool(
                          torch.isfinite(res.ys).all()))
                recs["K8"]["launches"] += 1
                err, plain_ms = hold(
                    r.calls[0], cpl.plan_solve_fixed_plain,
                    cpl.plan_solve_fixed,
                    f"[44] K14 {name} in K8 {method} (one block) {dtype}")
                recs["K8"]["err"] = max(recs["K8"]["err"], err)
                if dtype != f32:
                    continue
                a, k, g_ = r.calls[0]
                key = f"{name} {method}"
                ms = _timed(lambda: cpl.plan_solve_fixed(*a, **k), reps=3)
                with torch.no_grad():
                    gen = _host_ms(lambda: solve(
                        f, y, tc, method=method,
                        options={"num_steps": COUPLED_STEPS}), reps=1)[0]
                nfe = int(g_[1][0])
                bound = _bound(
                    PLAN_B * (nfe * _plan_flops(a[0]) + COUPLED_STEPS * PLAN_D
                              * _combine_flops(FIXED_TABLEAUS_BY_NAME[method])),
                    4 * (2 * PLAN_B * PLAN_D + traj + PLAN_T
                         + COUPLED_STEPS + 1 + consts_n(a)))
                rec = recs["K8"]
                rec["ms"][key], rec["plain_ms"][key] = ms, plain_ms
                rec["bound"][key], rec["generic_ms"][key] = bound, gen
                print(f"[44] {smi}: {name} K14 in K8 {method} {ms:.3f} ms a "
                      f"solve (nfe {nfe}, one block of "
                      f"{cpl.PLAN_BLOCK_THREADS} threads) vs the generic "
                      f"engine {gen:.3f} ms; [31]'s K2 coupled route "
                      f"{k2_coupled[name]['ms']:.3f} ms (dopri5, nfe "
                      f"{k2_coupled[name]['nfe']}); plain {plain_ms:.1f} ms; "
                      f"bound {bound[0]:.5f} ms ({bound[1]})", flush=True)

    _at("45")
    # [45] K10: fixed_adams and explicit_adams (max_order 4) on
    # COUPLED_STEPS steps through solve(fuse), on K10's grid kernel at one
    # block.
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        for name, f in _coupled_funcs(dtype, dev).items():
            for method in ("fixed_adams", "explicit_adams"):
                implicit = method == "fixed_adams"
                nfe = 1 + 4 * 3 + (5 if implicit else 1) * (COUPLED_STEPS
                                                            - 3)
                cpl.reset_launch_counts()
                fb = fast.fuse_fallbacks
                with _Recording(cpl, "plan_solve_adams") as r:
                    res = solve(f, y, tc.to(dtype), rtol=TOL, atol=1e-8,
                                method=method,
                                options={"fuse": True,
                                         "num_steps": COUPLED_STEPS})
                torch.cuda.synchronize()
                entry(f"45 {name} {method} {dtype}", {"K10": 1}, fb,
                      res.stats.status == 0 and res.stats.nfe == nfe
                      and bool(torch.isfinite(res.ys).all()))
                recs["K10"]["launches"] += 1
                err, plain_ms = hold(
                    r.calls[0], cpl.plan_solve_adams_plain,
                    cpl.plan_solve_adams,
                    f"[45] K14 {name} in K10 {method} (one block) {dtype}")
                recs["K10"]["err"] = max(recs["K10"]["err"], err)
                if dtype != f32:
                    continue
                a, k, g_ = r.calls[0]
                key = f"{name} {method}"
                ms = _timed(lambda: cpl.plan_solve_adams(*a, **k), reps=3)
                with torch.no_grad():
                    gen = _host_ms(lambda: solve(
                        f, y, tc, rtol=TOL, atol=1e-8, method=method,
                        options={"num_steps": COUPLED_STEPS}), reps=1)[0]
                bound = _bound(
                    PLAN_B * (nfe * _plan_flops(a[0]) + PLAN_D * (
                        3 * (_combine_flops(RK4) + 12)
                        + (COUPLED_STEPS - 3) * _adams_step_flops(
                            4, 4, implicit))),
                    4 * (2 * PLAN_B * PLAN_D + traj + PLAN_T
                         + COUPLED_STEPS + 1 + consts_n(a)))
                rec = recs["K10"]
                rec["ms"][key], rec["plain_ms"][key] = ms, plain_ms
                rec["bound"][key], rec["generic_ms"][key] = bound, gen
                print(f"[45] {smi}: {name} K14 in K10 {method} {ms:.3f} ms a"
                      f" solve (nfe {nfe}, one block) vs the generic engine "
                      f"{gen:.3f} ms; [31]'s K2 coupled route "
                      f"{k2_coupled[name]['ms']:.3f} ms; plain "
                      f"{plain_ms:.1f} ms; bound {bound[0]:.5f} ms "
                      f"({bound[1]})", flush=True)

    _at("46")
    # [46] K11: VCABM ('adams') through solve(fuse), HNW's first step.
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        for name, f in _coupled_funcs(dtype, dev).items():
            cpl.reset_launch_counts()
            fb = fast.fuse_fallbacks
            with _Recording(cpl, "plan_solve_vcabm") as r:
                res = solve(f, y, tc.to(dtype), rtol=TOL, atol=1e-8,
                            method="adams", options={"fuse": True})
            torch.cuda.synchronize()
            entry(f"46 {name} {dtype}", {"K11": 1}, fb,
                  res.stats.status == 0
                  and bool(torch.isfinite(res.ys).all()))
            recs["K11"]["launches"] += 1
            with _Orders() as o:
                err, plain_ms = hold(
                    r.calls[0], cpl.plan_solve_vcabm_plain,
                    cpl.plan_solve_vcabm,
                    f"[46] K14 {name} in K11 (one block) {dtype}")
            recs["K11"]["err"] = max(recs["K11"]["err"], err)
            if dtype != f32:
                continue
            a, k, g_ = r.calls[0]
            ms = _timed(lambda: cpl.plan_solve_vcabm(*a, **k), reps=3)
            with torch.no_grad():
                gen = _host_ms(lambda: solve(f, y, tc, rtol=TOL, atol=1e-8,
                                             method="adams"), reps=1)[0]
            nfe, acc, rej, _ = g_[1].tolist()
            orders = o.orders
            bound = _bound(
                PLAN_B * (nfe * _plan_flops(a[0]) + PLAN_D * (
                    sum(_vcabm_attempt_flops(q) for q in orders)
                    + acc * _vcabm_accept_flops(sum(orders) / len(orders)))),
                4 * (2 * PLAN_B * PLAN_D + traj + PLAN_T + consts_n(a)))
            rec = recs["K11"]
            rec["ms"][name], rec["plain_ms"][name] = ms, plain_ms
            rec["bound"][name], rec["generic_ms"][name] = bound, gen
            print(f"[46] {smi}: {name} K14 in K11 {ms:.3f} ms a solve (nfe "
                  f"{nfe}, {acc + rej} attempts, one block) vs the generic "
                  f"engine {gen:.3f} ms; [31]'s K2 coupled route "
                  f"{k2_coupled[name]['ms']:.3f} ms; plain {plain_ms:.1f} "
                  f"ms; bound {bound[0]:.5f} ms ({bound[1]})", flush=True)

    _at("47")
    # [47] training: one SGD step of each coupling on K8 + K9 (rk4 both
    # ways), and of the mean field on the mixes K2 + K9 (dopri5 forward)
    # and K8 + K3 (dopri5 backward), through odeint_adjoint(fuse); every
    # K8, K2, K9 and K3 launch held to its plain version.
    fx = {"num_steps": COUPLED_STEPS}
    bx = {"num_steps": COUPLED_BWD_STEPS}
    mixes = [("k8_k9", "rk4", fx, "rk4", bx, {"K8": 1, "K9": 1}),
             ("k2_k9", "dopri5", {}, "rk4", bx, {"K2": 1, "K9": 1}),
             ("k8_k3", "rk4", fx, "dopri5", {}, {"K8": 1, "K3": 1})]
    wrappers = {"K8": ("plan_solve_fixed", cpl.plan_solve_fixed_plain,
                       False),
                "K2": ("plan_solve", cpl.plan_solve_plain, False),
                "K9": ("plan_adjoint_solve_fixed",
                       cpl.plan_adjoint_solve_fixed_plain, True),
                "K3": ("plan_adjoint_solve", cpl.plan_adjoint_solve_plain,
                       True)}
    recs["K9"]["steps"] = {}
    for dtype in (f32, f64):
        y = torch.tensor(np.random.RandomState(0).randn(PLAN_B, PLAN_D),
                         dtype=dtype, device=dev)
        tgt = torch.tensor(np.random.RandomState(1).randn(
            PLAN_T, PLAN_B, PLAN_D), dtype=dtype, device=dev)
        for mix, m, fo, am, bo, want in mixes:
            for name, f in _coupled_params_funcs().items():
                if mix != "k8_k9" and name != "meanfield":
                    continue
                w = torch.tensor(np.random.RandomState(0).randn(
                    PLAN_D, PLAN_D) * 0.3, dtype=dtype, device=dev)
                q = (w.requires_grad_(),)
                w0 = w.detach().clone()
                cpl.reset_launch_counts()
                fb = fast.fuse_fallbacks
                recs_ = {h: _Recording(cpl, wrappers[h][0]) for h in want}
                for x in recs_.values():
                    x.__enter__()
                try:
                    ys = odeint_adjoint(f, y, tc.to(dtype), params=q,
                                        rtol=TOL, atol=1e-8, method=m,
                                        adjoint_method=am,
                                        options={"fuse": True, **fo},
                                        adjoint_options=bo or None)
                    loss = torch.mean((ys - tgt) ** 2)
                    g_w, = torch.autograd.grad(loss, q)
                finally:
                    for x in recs_.values():
                        x.__exit__()
                with torch.no_grad():
                    w -= SGD_LR * g_w
                moved = float((w.detach() - w0).abs().max())
                entry(f"47 {mix} {name} {dtype}", want, fb,
                      bool(torch.isfinite(g_w).all()) and moved > 0.0)
                for h, x in recs_.items():
                    _, plain, sweep = wrappers[h]
                    kernel = getattr(cpl, wrappers[h][0])
                    err, plain_ms = hold(
                        x.calls[0], plain, kernel,
                        f"[47] {mix} {name}: {h} (one block) {dtype}",
                        sweep)
                    if h == "K9":
                        recs["K9"]["launches"] += 1
                        recs["K9"]["err"] = max(recs["K9"]["err"], err)
                if dtype != f32 or "K9" not in want:
                    continue
                a, k, g9 = recs_["K9"].calls[0]
                key = f"{name} {mix}"
                ms = _timed(lambda: cpl.plan_adjoint_solve_fixed(*a, **k),
                            reps=3)
                ws = w.detach().clone()

                def fused_step(fuse=True):
                    q_ = (ws.clone().requires_grad_(),)
                    ys_ = odeint_adjoint(
                        f, y, tc, params=q_, rtol=TOL, atol=1e-8, method=m,
                        adjoint_method=am,
                        options={"fuse": True, **fo} if fuse else (fo or None),
                        adjoint_options=bo or None)
                    torch.autograd.grad(torch.mean((ys_ - tgt) ** 2), q_)

                step = _host_ms(fused_step)[0]
                gen = _host_ms(lambda: fused_step(False), reps=1)[0]
                nfe9 = int(g9[3][0])
                nc = consts_n(a)
                bound = _bound(PLAN_B * nfe9 * _plan_aug_flops(a[0]),
                               4 * (2 * traj + PLAN_B * PLAN_D + 2 * nc
                                    + PLAN_T))
                rec = recs["K9"]
                rec["ms"][key], rec["plain_ms"][key] = ms, plain_ms
                rec["bound"][key], rec["generic_ms"][key] = bound, gen
                rec["steps"][key] = step
                print(f"[47] {smi}: {name} K15 in K9 ({mix}) {ms:.3f} ms a "
                      f"sweep (nfe {nfe9}, one block) vs [35]'s K3 coupled "
                      f"sweep {k3_coupled[name]['ms']:.3f} ms; plain "
                      f"{plain_ms:.1f} ms; bound {bound[0]:.5f} ms "
                      f"({bound[1]}); training step {step:.3f} ms vs the "
                      f"generic odeint_adjoint {gen:.3f} ms", flush=True)
    return recs


#: [48]: bench.py:595-633's float64-tier protocol, y' = y^3 A at B = 32
#: (tests/test_doublefloat.py's A32 and states), and its CPU oracle.
DF_A = ((-0.1, 2.0), (-2.0, -0.1))
DF_B, DF_RTOL, DF_ATOL, DF_ORACLE_TOL = 32, 1e-10, 1e-12, (1e-12, 1e-14)
#: The float64 tier's bar against its float64 references (the reference's
#: north star, tests/test_doublefloat.py:66): absolute on the cubic, and on
#: the spiral at rtol 1e-10 relative to max(1, |y|) (|y| reaches 31 there,
#: and the float64 solve itself sits 3.8e-6 from the rtol 1e-12 reference
#: in absolute terms, 2.7e-7 in relative ones).
DF_BAR = 1e-6
#: The spiral's bar at solve_df's defaults (rtol 1e-8), relative to
#: max(1, |y|): the gap measured there is 2.4e-5.
DF_BAR_DEFAULTS = 1e-4


def _df_cubic(dtype, device):
    """[48]'s dynamics over A and its seed-1 states, both rounded to
    float32 first (the oracle solves the float32 inputs' problem, as
    bench.py's does)."""
    import torch
    A = torch.tensor(DF_A, dtype=torch.float32).to(device, dtype)
    y = torch.tensor(np.random.RandomState(1).randn(DF_B, 2) * 1.5,
                     dtype=torch.float32).to(device, dtype)
    return (lambda t, yy: (yy ** 3) @ A), y


def _df_pairs(dev):
    """The plan [48] adds to [28]'s builds: the cubic on K2 (the spiral's
    K2 and K3 plans are [28]'s and [33]'s)."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    f, y = _df_cubic(torch.float32, dev)
    plan, _ = pb.build_plan(f, torch.tensor(0.0, device=dev), y)
    return [(plan, "solve")]


def _df_tier(smi: str, dev) -> dict:
    """Phases 48-49: the float64 tier (`solve_df`, `odeint_adjoint_df`):
    the capture at the caller's float32, K14 in K2 and K15 in K3 launched
    in float64, each launch held bitwise to its plain version, the answers
    to float64 references. Returns the tier's numbers for the kernels
    line."""
    import time
    import torch
    from tfdiffeq_tpu_torch import (fast, odeint_adjoint, odeint_adjoint_df,
                                    solve, solve_df)
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5
    f32, f64 = torch.float32, torch.float64
    cpu = torch.device("cpu")
    rec = {"K2": {}, "K3": {}, "launches": {"K2": 0, "K3": 0}}

    def launches():
        return {"K2": cpl.plan_solve_launches, "K8": cpl.plan_fixed_launches,
                "K5": cpl.plan_perlane_launches,
                "K3": cpl.plan_adjoint_launches,
                "K9": cpl.plan_fixed_adjoint_launches,
                "K6": cpl.plan_perlane_adjoint_launches}

    def entry(tag, want, fb, ok):
        got = launches()
        print(f"[{tag}] launches {got}, fallbacks {fast.fuse_fallbacks - fb}",
              flush=True)
        if any(got[k] != want.get(k, 0) for k in got) \
                or fast.fuse_fallbacks != fb or not ok:
            raise AssertionError(f"[{tag}] launches {got}, want {want}; "
                                 f"result as required: {ok}")
        for k_ in ("K2", "K3"):
            rec["launches"][k_] += got[k_]

    def filled(r):
        """A `_LaterHolds` job's `done`: the hold's numbers into r."""
        def done(err, plain_ms):
            r["kernel_err"], r["plain_ms"] = err, plain_ms
        return done

    def hold_solve(call, what, r):
        """A K2 launch: float64, run again bitwise, and held bitwise to its
        plain version after the timed phases (into r)."""
        args, kw, got = call
        if args[2].dtype != f64 or any(c.dtype != f64 for c in args[1]):
            raise AssertionError(f"{what}: the launch is not float64")
        if not all(torch.equal(a, b) for a, b in
                   zip(got, cpl.plan_solve(*args, **kw))):
            raise AssertionError(f"{what}: two kernel runs differ")
        _LATER.add(call, cpl.plan_solve_plain, what, filled(r))

    def hold_sweep(call, what, r):
        """A K3 launch, as hold_solve."""
        args, kw, got = call
        if args[2].dtype != f64 or any(c.dtype != f64 for c in args[1]):
            raise AssertionError(f"{what}: the launch is not float64")
        got = _flat_sweep(got)
        if not all(torch.equal(a, b) for a, b in
                   zip(got, _flat_sweep(cpl.plan_adjoint_solve(*args,
                                                               **kw)))):
            raise AssertionError(f"{what}: two kernel runs differ")
        _LATER.add((args, kw, got), cpl.plan_adjoint_solve_plain, what,
                   filled(r), flat=True)

    def k2_bound(args, stats, Bn):
        """Products at the FP64 tensor cores' peak, the rest at the CUDA
        cores'."""
        nfe, acc, rej, _ = stats.tolist()
        nc = sum(x.numel() for x in args[1])
        dots = _plan_dot_flops(args[0])
        return _bound_f64(Bn * nfe * dots,
                          Bn * (nfe * (_plan_flops(args[0]) - dots)
                                + (acc + rej) * D * _combine_flops(DOPRI5)),
                          8 * (2 * Bn * D + T_OUT * Bn * D + T_OUT + nc))

    t = torch.linspace(0.0, SPAN, T_OUT)

    _at("48")
    # [48] bench.py's float64-tier protocol: solve_df at rtol 1e-10 from
    # float32 inputs, against the port's generic solve in float64 on the
    # CPU at rtol 1e-12.
    f, y = _df_cubic(f32, dev)
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    with _Recording(cpl, "plan_solve") as r:
        res = solve_df(f, y, t, rtol=DF_RTOL, atol=DF_ATOL)
    torch.cuda.synchronize()
    entry("48 cubic", {"K2": 1}, fb, res.stats.status == 0
          and res.ys.dtype == f32 and tuple(res.ys.shape) == (T_OUT, DF_B, D)
          and bool(torch.isfinite(res.ys).all()))
    cubic = rec["K2"]["cubic"] = {}
    hold_solve(r.calls[0], "[48] K14 (cubic) in K2 float64", cubic)
    t0 = time.perf_counter()
    fo, yo = _df_cubic(f64, cpu)
    with torch.no_grad():
        oracle = solve(fo, yo, t.to(f64), rtol=DF_ORACLE_TOL[0],
                       atol=DF_ORACLE_TOL[1])
    oracle_s = time.perf_counter() - t0
    err = float((res.ys.to(cpu, f64) - oracle.ys).abs().max())
    a, k, g_ = r.calls[0]
    ms = _timed(lambda: cpl.plan_solve(*a, **k), reps=3)
    call_ms = _host_ms(lambda: solve_df(f, y, t, rtol=DF_RTOL,
                                        atol=DF_ATOL))[0]
    bound = k2_bound(a, g_[1], DF_B)
    nfe, acc, rej, _ = res.stats
    cubic.update({"ms": ms, "call_ms": call_ms, "bound": bound, "err": err,
                  "nfe": nfe, "attempts": acc + rej})
    print(f"[48] {smi}: solve_df(y^3 A, B = {DF_B}, rtol {DF_RTOL:g}) "
          f"max |float32 out - float64 oracle| {err:.3e} (bar {DF_BAR:g}; "
          f"the oracle, the generic solve at rtol {DF_ORACLE_TOL[0]:g} on "
          f"the CPU, took {oracle_s:.1f} s, nfe {oracle.stats.nfe}); nfe "
          f"{nfe} ({acc + rej} attempts); K2 float64 {ms:.3f} ms a solve, "
          f"the call {call_ms:.3f} ms; bound {bound[0]:.6f} ms "
          f"({bound[1]})", flush=True)
    if not err <= DF_BAR:
        raise AssertionError("[48] solve_df misses the float64 oracle")

    # [48] the spiral MLP at full width, float32 weights: solve_df at its
    # defaults and at the protocol's rtol, each held to K2's MLP route in
    # float64 at rtol 1e-12 (DF_BAR_DEFAULTS, DF_BAR).
    p, y, _ = _bench_params(B, f32, dev)
    p64 = {k_: v.to(f64) for k_, v in p.items()}
    ck_ref = fast.solve_mlp(p64, y.to(f64), t, rtol=DF_ORACLE_TOL[0],
                            atol=DF_ORACLE_TOL[1])
    ref = ck_ref.ys
    scale = ref.abs().clamp_min(1.0)
    for name, tol, bar in (("defaults", (1e-8, 1e-10), DF_BAR_DEFAULTS),
                           ("protocol", (DF_RTOL, DF_ATOL), DF_BAR)):
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_solve") as r:
            res = solve_df(_spiral_func(p), y, t, rtol=tol[0], atol=tol[1])
        torch.cuda.synchronize()
        entry(f"48 spiral {name}", {"K2": 1}, fb, res.stats.status == 0
              and res.ys.dtype == f32 and bool(torch.isfinite(res.ys).all()))
        case = rec["K2"][f"spiral_{name}"] = {}
        hold_solve(r.calls[0],
                   f"[48] K14 (spiral, rtol {tol[0]:g}) in K2 float64", case)
        gap = (res.ys.to(f64) - ref).abs()
        err_abs, err_rel = float(gap.max()), float((gap / scale).max())
        a, k, g_ = r.calls[0]
        err64 = float((g_[0] - ref).abs().max())
        if name == "defaults":
            held_defaults = r.calls[0]
        ms = _timed(lambda: cpl.plan_solve(*a, **k), reps=3)
        call_ms = _host_ms(lambda: solve_df(_spiral_func(p), y, t,
                                            rtol=tol[0], atol=tol[1]))[0]
        bound = k2_bound(a, g_[1], B)
        nfe, acc, rej, _ = res.stats
        case.update({"ms": ms, "call_ms": call_ms, "bound": bound,
                     "err": err_abs, "err_rel": err_rel,
                     "err_launch_f64": err64, "nfe": nfe,
                     "attempts": acc + rej})
        print(f"[48] {smi}: solve_df(spiral, B = {B}, rtol {tol[0]:g}) "
              f"max |out - K2's MLP route in float64 at rtol "
              f"{DF_ORACLE_TOL[0]:g}| {err_abs:.3e}, relative to max(1, |y|) "
              f"{err_rel:.3e} (bar {bar:g}), the float64 launch's own "
              f"{err64:.3e}; nfe {nfe} ({acc + rej} attempts; the "
              f"reference route nfe {ck_ref.stats.nfe}); K2 float64 "
              f"{ms:.3f} ms a solve, the call {call_ms:.3f} ms; bound "
              f"{bound[0]:.5f} ms ({bound[1]})", flush=True)
        if not err_rel <= bar:
            raise AssertionError(f"[48] solve_df at rtol {tol[0]:g} misses "
                                 "K2's float64 reference")

    _at("49")
    # [49] one odeint_adjoint_df step of the spiral at B = 4096 (the MSE
    # of bench.py's training protocol), K2 + K3 in float64.
    def step_df(q, y, tgt):
        ys = odeint_adjoint_df(_spiral_params_func, y, t, params=q)
        return torch.autograd.grad(torch.mean((ys - tgt) ** 2), q)

    def params(dtype, Bn):
        pp, yy, _ = _bench_params(Bn, dtype, dev)
        return (tuple(pp[k_].clone().requires_grad_()
                      for k_ in ("w1", "b1", "w2", "b2")), yy,
                _bench_target(dtype, dev)[:, :Bn])

    for Bn in (B, DF_B):
        q, y, tgt = params(f32, Bn)
        cpl.reset_launch_counts()
        fb = fast.fuse_fallbacks
        with _Recording(cpl, "plan_solve") as r2, \
                _Recording(cpl, "plan_adjoint_solve") as r3:
            grads = step_df(q, y, tgt)
        torch.cuda.synchronize()
        entry(f"49 B = {Bn}", {"K2": 1, "K3": 1}, fb,
              all(g.dtype == f32 and bool(torch.isfinite(g).all())
                  for g in grads))
        k3_case = rec["K3"]["spiral" if Bn == B else "b32"] = {}
        if Bn == B:
            # [48]'s held launch at the defaults had these inputs: the same
            # inputs and bits stand for its plain version here.
            a48, _, g48 = held_defaults
            a2_, _, g2_ = r2.calls[0]
            same = all(torch.equal(u, v) for u, v in
                       zip((a2_[2], *a2_[1], *g2_), (a48[2], *a48[1], *g48)))
            print(f"[49] K14 in K2 float64, B = {Bn}: inputs and outputs "
                  f"bitwise equal to [48]'s held launch at the defaults: "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError("[49] the forward launch differs from "
                                     "[48]'s")
        else:
            k3_case["fwd"] = {}
            hold_solve(r2.calls[0], f"[49] K14 in K2 float64, B = {Bn}",
                       k3_case["fwd"])
        hold_sweep(r3.calls[0], f"[49] K15 in K3 float64, B = {Bn}",
                   k3_case)
        a3, k3, g3 = r3.calls[0]
        bst = g3[3].tolist()
        if Bn == B:
            step_ms = _host_ms(lambda: step_df(q, y, tgt))[0]
            ms3 = _timed(lambda: cpl.plan_adjoint_solve(*a3, **k3), reps=3)
            traj = T_OUT * Bn * D
            nc = sum(x.numel() for x in a3[1])
            # K15's three walks an evaluation (`_plan_aug_flops`): their
            # products at the FP64 tensor cores' peak, the rest at the CUDA
            # cores'.
            dots = 3 * _plan_dot_flops(a3[0])
            bound3 = _bound_f64(Bn * bst[0] * dots,
                                Bn * bst[0] * (_plan_aug_flops(a3[0]) - dots),
                                8 * (2 * traj + Bn * D + 2 * nc + T_OUT))
            a2, k2, g2 = r2.calls[0]
            ms2 = _timed(lambda: cpl.plan_solve(*a2, **k2), reps=3)
            # The forward's plain time and error are [48]'s defaults hold's.
            k3_case.update({
                "ms": ms3, "bound": bound3, "b_nfe": bst[0],
                "step_ms": step_ms, "fwd_ms": ms2,
                "fwd": rec["K2"]["spiral_defaults"],
                "fwd_bound": k2_bound(a2, g2[1], Bn),
                "fwd_nfe": int(g2[1][0])})
            print(f"[49] {smi}: odeint_adjoint_df step, B = {Bn}: "
                  f"{step_ms:.3f} ms (host clock, median of 3); K3 float64 "
                  f"{ms3:.3f} ms a sweep, b-NFE {bst[0]} ({bst[1] + bst[2]} "
                  f"attempts), bound {bound3[0]:.5f} ms ({bound3[1]}); "
                  f"K2 float64 {ms2:.3f} ms, nfe {int(g2[1][0])}",
                  flush=True)
            continue
        # Against the generic float64 odeint_adjoint on the CPU, on the
        # whole gradient's scale.
        q64 = tuple(x.detach().to(cpu, f64).requires_grad_() for x in q)
        ys_g = odeint_adjoint(_spiral_params_func, y.to(cpu, f64), t.to(f64),
                              params=q64, rtol=1e-8, atol=1e-10)
        g_gen = torch.autograd.grad(
            torch.mean((ys_g - tgt.to(cpu, f64)) ** 2), q64)
        scale_g = max(float(x.abs().max()) for x in g_gen)
        gap = max(float((a_.to(cpu, f64) - b_).abs().max())
                  for a_, b_ in zip(grads, g_gen)) / scale_g
        k3_case.update({"grad_gap": gap, "b_nfe": bst[0]})
        print(f"[49] B = {Bn}: gradients within {gap:.3e} of the generic "
              f"float64 odeint_adjoint (CPU), on the whole gradient's scale "
              f"{scale_g:.4g} (bar {DF_BAR:g}); b-NFE {bst[0]}", flush=True)
        if not gap <= DF_BAR:
            raise AssertionError("[49] odeint_adjoint_df's gradients miss "
                                 "the generic float64 adjoint")
    return rec


# ---------------------------------------------------------------------------
# [51] K4 at its last sites: a plan's tiered dots in K2 and K8 (K14's tile
# walk) and K5's tile engine, the MLP's and a plan's
# ---------------------------------------------------------------------------

#: The wide MLP's tier slice: dopri5 with 8 outputs over [0, 2] at bench.py's
#: RTOL / ATOL and first step 0.01 (bench_mixed_adaptive), rk4 x 128 over
#: [0, 2] (bench_bf16_serving); the holds' reduced size (a plain wide
#: evaluation takes milliseconds of host-bound launches, PERF.md section 6).
TIER_TOL, TIER_STEPS, TIER_HOLD_B = 1e-6, 128, 64


def _wide_dyn(W):
    """The wide MLP as plain PyTorch code over the weights W: what a user
    writes and `solve(options={'fuse': True})` captures."""
    import torch

    def f(t, y):
        h = y
        for i, (w, b) in enumerate(W):
            h = h @ w + b
            if i < len(W) - 1:
                h = torch.tanh(h)
        return h
    return f


def _coupled_wide_dyn(W):
    """The wide MLP with a mean-field term, a batch coupling (one block)."""
    f = _wide_dyn(W)
    return lambda t, y: f(t, y) - 0.5 * (y - y.mean(0))


def _scaled_wide_dyn(W, sc):
    """The wide MLP time-rescaled per sample by sc [B, 1] (bench.py:427-480's
    battery: a per-sample constant)."""
    f = _wide_dyn(W)
    return lambda t, y: sc * f(t, y)


def _battery_scale(B, dtype, device):
    import torch
    return torch.tensor(np.logspace(0.0, 2.0, B), dtype=dtype,
                        device=device)[:, None]


def _tier_plans(dev):
    """The plans of [51]: (name, plan, packed, y0) at float32, captured on
    the card (the structure alone names a library: the full and the reduced
    batch share one, but for the coupled plan, whose mean divides by B)."""
    import torch
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    out = {}
    for name, Bn in (("wide", WIDE_B), ("coupled", TIER_HOLD_B),
                     ("battery", TIER_HOLD_B)):
        for dtype in (torch.float32, torch.float64):
            W, y = _wide_net(dtype, dev, B=Bn)
            f = {"wide": _wide_dyn(W), "coupled": _coupled_wide_dyn(W),
                 "battery": _scaled_wide_dyn(
                     W, _battery_scale(Bn, dtype, dev))}[name]
            plan, consts = pb.build_plan(f, torch.zeros((), dtype=dtype,
                                                        device=dev), y)
            out[(name, dtype)] = (plan, pb.pack_consts(plan, consts, dtype,
                                                       dev), y, f)
    return out


def _tier_pairs(plans):
    """The tiled libraries of [51], built beside phases 3-27."""
    import torch
    f32 = torch.float32
    return [(plans[("wide", f32)][0], "solve", "mixed"),
            (plans[("wide", f32)][0], "fixed", "bf16"),
            (plans[("wide", f32)][0], "fixed", "mixed"),
            (plans[("wide", f32)][0], "perlane", "mixed"),
            (plans[("coupled", f32)][0], "solve", "mixed"),
            (plans[("coupled", f32)][0], "fixed", "mixed"),
            (plans[("battery", f32)][0], "perlane", "mixed")]


def _dense_reordered_plain(*args, **kw):
    """`cuda_plan.plan_solve_plain` with emit_dense, its results in the
    holds' order (the stats last): (out, meta, coef, stats)."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    out, stats, meta, coef = cpl.plan_solve_plain(*args, **kw)
    return out, meta, coef, stats


def _tier_sites(smi: str, dev, wide, plans) -> dict:
    """Phase 51: K4's tiers at the sites where the reference applies them
    and the port did not until now, on the wide MLP at full width (B =
    1024) through the public entry points: (a) the plain-PyTorch net through
    solve(options={'fuse': True, 'dot_precision': 'mixed'}) (K14's tile walk
    in K2), (b) rk4 x 128 at 'bf16' and 'mixed' (in K8), (c) per sample
    through `fast.solve_mlp_spec(per_sample=True)` (K5's tile engine, the
    MLP) and the plan's per_sample route (K5's tile engine, the plan).
    Counters zeroed before each run and read after; every launch held in
    [50]'s workers: the full-size float32 launches within the tier's bars
    (K8 stats identical; K2 and K5 counts within one, statuses equal),
    float64 launches at B = 64 bitwise, with and without K2's dense
    output, the coupled plans on one block of K2 and K8, and a battery of
    per-sample stiffness on K5. Timed beside the MLP route's K2 and K8 at
    the same tier ([18], [19])."""
    import torch
    from tfdiffeq_tpu_torch import fast, solve
    from tfdiffeq_tpu_torch.ops import cuda_kernels as ck, \
        cuda_perlane as cp, cuda_plan as cpl, plan_bridge as pb
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid
    f32, f64 = torch.float32, torch.float64
    _at("51")
    rec = {"launches": {}, "err": {}, "ms": {}, "plain_ms": {},
           "stats": {}}
    dims = ((WIDE_D, WIDE_H), (WIDE_H, WIDE_H), (WIDE_H, WIDE_D))
    n_mac = sum(i * o for i, o in dims)

    def bound(evals, io, tier):
        """`evals` sample-evaluations at the tier (2 passes 'mixed', 1
        'bf16') of a multiply and an add a weight at the bf16 tensor-core
        peak; the bf16 weights and `io` float32 state values read or
        written once."""
        passes = 2 if tier == "mixed" else 1
        return _bound(evals * passes * 2 * n_mac, 2 * n_mac + 4 * io,
                      peak=_peaks().PEAK_BF16_TENSOR)

    def reset():
        for m in (ck, cp, cpl):
            m.reset_launch_counts()

    def counts():
        return {"plan_solve": cpl.plan_solve_launches,
                "plan_fixed": cpl.plan_fixed_launches,
                "plan_perlane": cpl.plan_perlane_launches,
                "mlp_solve_perlane": cp.mlp_solve_perlane_launches,
                "mlp_solve": ck.mlp_solve_launches,
                "dot_tiers": ck.dot_tier_launches}

    def ok(name, res, shape):
        status = int(torch.as_tensor(res.stats.status).max())
        if status != 0 or tuple(res.ys.shape) != shape \
                or not torch.isfinite(res.ys).all():
            raise AssertionError(f"[51] {name} failed: {res.stats}")

    def expect(name, got, want):
        print(f"[51] {name}: launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"[51] {name}: launches {got}, want {want}")

    def held(key, bar, slack=0):
        """The hold's keywords: its largest difference into rec["err"][key]
        (the largest of the key's holds), the first one's plain time."""
        def done(err, plain_ms):
            rec["err"][key] = max(rec["err"].get(key, 0.0), err)
            rec["plain_ms"].setdefault(key, plain_ms)
        return dict(done=done, bar=bar, slack=slack)

    zero = {k: 0 for k in counts()}
    plan, packed, y, f = plans[("wide", f32)]
    t8 = torch.linspace(0.0, 2.0, 8)
    tspan = torch.tensor([0.0, 2.0])
    shape = (8, WIDE_B, WIDE_D)

    # (a) dopri5 through the fused route, 'mixed': K14's tile walk in K2.
    reset()
    with _Recording(cpl, "plan_solve") as r:
        res = solve(f, y, t8, rtol=TIER_TOL, atol=TIER_TOL, options={
            "fuse": True, "dot_precision": "mixed", "first_step": 0.01})
    torch.cuda.synchronize()
    expect("solve(fuse, 'mixed') dopri5", counts(),
           dict(zero, plan_solve=1, dot_tiers=1))
    ok("(a)", res, shape)
    rec["launches"]["K2"] = 1
    call = r.calls[0]
    rec["stats"]["K2"] = res.stats
    print(f"[51] (a) solve(fuse, 'mixed') dopri5 wide: stats {res.stats}; "
          f"route {cpl.last_route.get('solve')}", flush=True)
    _LATER.add(call, cpl.plan_solve_plain, "[51] K2 plan tile 'mixed' "
               f"float32 B={WIDE_B}", **held("K2", 5e-5, 1))
    args, kw, _ = call
    rec["ms"]["K2"] = _timed(lambda: cpl.plan_solve(*args, **kw), reps=3)
    nfe = int(res.stats.nfe) - 2
    rec["bound"] = {"K2": bound(WIDE_B * nfe, 10 * WIDE_B * WIDE_D,
                                "mixed")}

    # (b) rk4 x 128 at 'bf16' and 'mixed': K14's tile walk in K8.
    reset()
    runs = {}
    with _Recording(cpl, "plan_solve_fixed") as r:
        for tier in ("bf16", "mixed"):
            runs[tier] = solve(f, y, tspan, method="rk4", options={
                "fuse": True, "dot_precision": tier,
                "num_steps": TIER_STEPS})
    torch.cuda.synchronize()
    expect("solve(fuse, rk4 x 128, 'bf16' and 'mixed')", counts(),
           dict(zero, plan_fixed=2, dot_tiers=2))
    for (tier, res), call in zip(runs.items(), r.calls):
        ok(f"(b) {tier}", res, (2, WIDE_B, WIDE_D))
        key = f"K8 {tier}"
        rec["launches"][key] = 1
        rec["stats"][key] = res.stats
        _LATER.add(call, cpl.plan_solve_fixed_plain,
                   f"[51] K8 plan tile {tier!r} float32 B={WIDE_B}",
                   **held(key, SOLVE_BARS[tier]))
        args, kw, _ = call
        rec["ms"][key] = _timed(lambda: cpl.plan_solve_fixed(*args, **kw),
                                reps=3)
        rec["bound"][key] = bound(WIDE_B * int(res.stats.nfe),
                                  4 * WIDE_B * WIDE_D, tier)
    gap = float((runs["bf16"].ys - runs["mixed"].ys).abs().max())
    print(f"[51] (b) rk4 x {TIER_STEPS} wide: bf16 stats "
          f"{runs['bf16'].stats}, mixed {runs['mixed'].stats}; max |bf16 - "
          f"mixed| {gap:.3e}; route {cpl.last_route.get('fixed')}", flush=True)

    # (c) per sample: K5's tile engine, the MLP and the plan.
    spec = fast.MLPSpec(activation="tanh", matmul="mxu",
                        dot_precision="mixed")
    W, _ = _wide_net(f32, dev)
    reset()
    with _Recording(fast, "mlp_solve_perlane") as rm:
        res_m = fast.solve_mlp_spec(spec, W, y, t8, rtol=TIER_TOL,
                                    atol=TIER_TOL, first_step=0.01,
                                    per_sample=True)
    torch.cuda.synchronize()
    expect("solve_mlp_spec('mixed', per_sample=True)", counts(),
           dict(zero, mlp_solve_perlane=1, dot_tiers=1))
    reset()
    with _Recording(cpl, "plan_solve") as rp:
        res_p = solve(f, y, t8, rtol=TIER_TOL, atol=TIER_TOL, options={
            "fuse": True, "per_sample": True, "dot_precision": "mixed",
            "first_step": 0.01})
    torch.cuda.synchronize()
    expect("solve(fuse, per_sample, 'mixed')", counts(),
           dict(zero, plan_perlane=1, dot_tiers=1))
    for key, res, call, plain in (
            ("K5 MLP", res_m, rm.calls[0], cp.mlp_solve_perlane_plain),
            ("K5 plan", res_p, rp.calls[0], cpl.plan_solve_plain)):
        ok(f"(c) {key}", res, shape)
        rec["launches"][key] = 1
        rec["stats"][key] = res.stats
        nacc = res.lane_stats.n_accepted.float()
        print(f"[51] (c) {key} per sample wide: stats {res.stats}; "
              f"accepted steps a sample min {int(nacc.min())}, median "
              f"{int(nacc.median())}, max {int(nacc.max())}", flush=True)
        # Each sample under its own controller: a decision that the
        # tensor cores' order flips moves that sample's later steps, so
        # the bar is the reference's float32 budget's atol (2e-4).
        _LATER.add(call, plain, f"[51] {key} tile engine 'mixed' float32 "
                   f"B={WIDE_B}", **held(key, 2e-4, 1))
        args, kw, _ = call
        fn = cp.mlp_solve_perlane if key == "K5 MLP" else cpl.plan_solve
        rec["ms"][key] = _timed(lambda: fn(*args, **kw), reps=3)
        rec["bound"][key] = bound(int(res.stats.nfe) - 2 * WIDE_B,
                                  (2 * 8 + 9) * WIDE_B * WIDE_D, "mixed")
    gap = float((res_m.ys - res_p.ys).abs().max())
    print(f"[51] (c) max |MLP route - plan route| per sample {gap:.3e}",
          flush=True)

    # Float64 at B = 64, bitwise in [50]: the same routes, K2's dense
    # output, the coupled plans on one block of K2 and K8, and the battery.
    B64 = TIER_HOLD_B
    for name in ("wide", "coupled", "battery"):
        plan64, packed64, y64, f64f = plans[(name, f64)]
        y64 = y64[:B64].contiguous()
        tt = t8.double()
        f0 = pb.eval_plan_host(plan64, packed64, tt[0].to(dev),
                               y64).contiguous()
        common = (plan64, packed64, y64, tt)
        launches = []
        if name in ("wide", "coupled"):
            a = common + (0.01, TIER_TOL, TIER_TOL, 1.0, f0)
            launches.append((cpl.plan_solve, cpl.plan_solve_plain, a,
                             dict(dot_precision="mixed"), f"K2 {name}"))
            grid = uniform_grid(tt[0], tt[-1], 8)
            for tier in (("bf16", "mixed") if name == "wide"
                         else ("mixed",)):
                launches.append((cpl.plan_solve_fixed,
                                 cpl.plan_solve_fixed_plain,
                                 common[:3] + (tt, grid, 1.0, f0),
                                 dict(method="rk4", dot_precision=tier),
                                 f"K8 {name} {tier}"))
        if name in ("wide", "battery"):
            a = common + (0.01, TIER_TOL, TIER_TOL, 1.0, f0)
            launches.append((cpl.plan_solve, cpl.plan_solve_plain, a,
                             dict(dot_precision="mixed", per_sample=True),
                             f"K5 plan {name}"))
        for fn, plain, a, kw, what in launches:
            got = fn(*a, **kw)
            if not _same(got[0], fn(*a, **kw)[0]):
                raise AssertionError(f"[51] {what}: two runs differ")
            _LATER.add((a, kw, got), plain, f"[51] {what} float64 B={B64}",
                       **held(what.split()[0] + " f64", None))
        if name == "wide":
            # K2's dense output and K5's tile engine on the MLP route.
            a = common + (0.01, TIER_TOL, TIER_TOL, 1.0, f0)
            kw = dict(dot_precision="mixed", emit_dense=64, max_steps=64)
            out, st, meta, coef = cpl.plan_solve(*a, **kw)
            _LATER.add((a, kw, (out, meta, coef, st)),
                       _dense_reordered_plain,
                       f"[51] K2 wide dense output float64 B={B64}",
                       **held("K2 f64", None))
            W64 = [(w.double(), b.double()) for w, b in W]
            warr, pd = ck.pack_mlp_weights(W64, f64, dev)
            mf0 = ck._net_plain(warr, pd, "tanh", "identity", 1, False)(
                tt[0], y64).contiguous()
            a = (warr, pd, y64, tt, 0.01, TIER_TOL, TIER_TOL, 1.0)
            kw = dict(f0=mf0, tiers=ck.layer_tiers(pd, "mxu", "mixed"))
            _LATER.add((a, kw, cp.mlp_solve_perlane(*a, **kw)),
                       cp.mlp_solve_perlane_plain,
                       f"[51] K5 MLP wide float64 B={B64}",
                       **held("K5 MLP f64", None))
    bplan, bpacked, by, _ = plans[("battery", f64)]
    by = by[:B64].contiguous()
    bf0 = pb.eval_plan_host(bplan, bpacked, t8.double()[0].to(dev),
                            by).contiguous()
    lane = cpl.plan_solve(bplan, bpacked, by, t8.double(), 0.01, TIER_TOL,
                          TIER_TOL, 1.0, bf0, dot_precision="mixed",
                          per_sample=True)[2]
    rec["battery_accepted"] = (int(lane[1].min()), int(lane[1].max()))
    print(f"[51] K5 plan battery float64 B={B64}: accepted steps a sample "
          f"from {rec['battery_accepted'][0]} to "
          f"{rec['battery_accepted'][1]}", flush=True)
    if rec["battery_accepted"][1] < 3 * rec["battery_accepted"][0]:
        raise AssertionError("[51] the battery's samples do not differ")

    mlp = {"K2": wide["k2_mixed"][0], "K8 bf16": wide["k8_bf16"][0],
           "K8 mixed": wide["k8_mixed"][0]}
    for key, ms in rec["ms"].items():
        side = mlp.get(key, mlp["K2"])
        print(f"[51] {smi}: {key} tile route {ms:.3f} ms/solve beside the "
              f"MLP route's {'K8' if key.startswith('K8') else 'K2'} at the "
              f"same tier {side:.3f} ms (B={WIDE_B}, float32, "
              f"{rec['stats'][key]}); bound {rec['bound'][key][0]:.5f} ms "
              f"({rec['bound'][key][1]})", flush=True)
    rec["mlp_route_ms"] = mlp
    return rec


def main() -> int:
    import time
    import torch
    run_t0 = _RUN_T0[0] = time.perf_counter()
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
    from tfdiffeq_tpu_torch import NFEMeter, convert, fast, odeint_adjoint, \
        solve
    from tfdiffeq_tpu_torch.examples import latent_ode as lode, \
        ode_demo as demo, odenet_mnist as onet
    from tfdiffeq_tpu_torch.ops import _build, cuda_adjoint as ca, \
        cuda_conv as cc, cuda_fixed as cf, cuda_kernels as ck, \
        cuda_perlane as cp
    from tfdiffeq_tpu_torch.ops.norms import select_initial_step_per_sample
    from tfdiffeq_tpu_torch.ops.tableaus import DOPRI5, RK4
    from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid

    # [2] build.
    _build.library()
    print(f"[2] nvcc build: {_build.build_seconds():.2f} s, library "
          f"{_build.source_hash()}", flush=True)
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # K14's plan libraries of phases 28-32 build beside phases 3-27.
    from concurrent.futures import ThreadPoolExecutor
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    plan_pool = ThreadPoolExecutor(1)
    plan_pairs = _plan_pairs(dev)
    tier_plans = _tier_plans(dev)
    plan_builds = plan_pool.submit(cpl.build, plan_pairs + _aug_pairs(dev)
                                   + _late_pairs(dev) + _dense_pairs(dev)
                                   + _coupled_pairs(dev) + _df_pairs(dev)
                                   + _tier_pairs(tier_plans))

    _at("3")
    # [3] K1 against its plain version (dt 0.3: a typical main-path step),
    # bitwise, at the bench batch and at batches that leave a block part
    # empty.
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    k1_err = {}
    for dtype in (f32, f64):
        for Bk in (B, 1, 33, B + 1):
            p, y, _ = _bench_params(Bk, dtype, dev)
            f0 = fast.mlp_apply(spec, [(p["w1"], p["b1"]),
                                       (p["w2"], p["b2"])], y)
            got = ck.dopri5_mlp_step(p, y, f0, 0.3, TOL, TOL)
            ref = ck.dopri5_mlp_step_plain(p, y, f0, 0.3, TOL, TOL)
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            spb = ck.step_samples(D, p["w1"].shape[1], y.element_size())
            print(f"[3] K1 {dtype}, B = {Bk}: {-(-Bk // spb)} blocks of "
                  f"{ck.STEP_BLOCK} threads, {spb} samples a block, "
                  f"{ck.STEP_BLOCK // spb} threads a sample; max |kernel - "
                  f"plain| y1 {errs[0]:.3e} f1 {errs[1]:.3e} y_mid "
                  f"{errs[3]:.3e}; ratio {float(got[2]):.9e} vs "
                  f"{float(ref[2]):.9e}; bitwise equal to plain: {same}",
                  flush=True)
            if not same or not bool(torch.isfinite(got[2])):
                raise AssertionError(f"K1 {dtype} at B = {Bk} differs from "
                                     "its plain version")
            if Bk == B:
                k1_err[dtype] = max(errs)

    _at("4")
    # [4] K2 against its plain version at the bench protocol.
    k2_err, k2_args, k2_st = {}, {}, {}
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
        ref, st_ref = ck.mlp_solve_plain(*args,
                                         **_grid_kw(ck.mlp_solve_plain, args,
                                                    kw))
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
        k2_st[dtype] = st.tolist()

    _at("5")
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

    _at("6")
    # [6] timings (these launches are not counted above).
    p, y, _ = _bench_params(B, f32, dev)
    f0 = fast.mlp_apply(spec, [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y)
    step_kernel_ms = _kernel_ms(
        _build.library(), "tfd_dopri5_mlp_step_f32",
        lambda: ck.dopri5_mlp_step(p, y, f0, 0.3, TOL, TOL))
    step_ms = _device_ms(
        lambda: ck.dopri5_mlp_step(p, y, f0, 0.3, TOL, TOL))
    step_plain_ms = _timed(
        lambda: ck.dopri5_mlp_step_plain(p, y, f0, 0.3, TOL, TOL), inner=5)
    args, kw = k2_args[f32]
    solve_ms = _timed(lambda: ck.mlp_solve(*args, **kw))
    solve_plain_ms = _plain_ms(lambda: ck.mlp_solve_plain(*args, **kw))
    print(f"[6] {smi}: K1 dopri5_mlp_step {step_ms:.4f} ms of device work "
          f"a wrapper call, with the partials' sum ({step_kernel_ms:.4f} ms "
          f"the kernel alone) vs plain {step_plain_ms:.4f} ms (B=4096, "
          "float32)", flush=True)
    print(f"[6] {smi}: K2 mlp_solve {solve_ms:.3f} ms/solve vs plain "
          f"{solve_plain_ms:.3f} ms (bench protocol, float32, "
          f"{whole.stats.n_accepted + whole.stats.n_rejected} attempts)",
          flush=True)

    _at("7")
    # [7] K3 against its plain version at the bench protocol.
    k3_err, k3_args = {}, {}
    # The plain versions' host ms of the holds that [50] runs.
    holds_ms = {}
    for dtype in (f64, f32):
        p, y, _ = _bench_params(B, dtype, dev)
        W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
        t = torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
        ys = fast.solve_mlp_spec(spec, W, y, t, rtol=TOL, atol=TOL).ys
        target = _bench_target(dtype, dev)
        g = 2.0 * (ys - target) / target.numel()
        warr, dims = ck.pack_mlp_weights(W, dtype, dev)
        args = (warr, dims, ys.contiguous(), g.contiguous(), t,
                0.1 * abs(float(t[-1] - t[-2])), TOL, TOL, 1.0)
        kw = dict(activation="tanh", input_power=3)
        k3_args[dtype] = (args, kw)
        got = ca.mlp_adjoint_solve(*args, **kw)
        again = ca.mlp_adjoint_solve(*args, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[7] K3 {dtype}: kernel stats {got[3].tolist()}; two kernel "
              f"runs bitwise equal: {bitwise}; its plain version holds it "
              "in [50]", flush=True)
        if not bitwise:
            raise AssertionError("K3 is not deterministic from run to run")
        if got[3][3].item() != 0 or not all(
                torch.isfinite(x).all() for x in got[:3]):
            raise AssertionError(f"K3 {dtype} failed: {got[3].tolist()}")

        # Bitwise equal to the plain version at the kernel's grid (so
        # float64 with identical stats), in [50]'s workers.
        def k3_done(err, plain_ms, dtype=dtype):
            k3_err[dtype] = err
            if dtype == f32:
                holds_ms["K3"] = plain_ms
        _LATER.add((args, kw, got), ca.mlp_adjoint_solve_plain,
                   f"[7] K3 {dtype} (held in [50])", k3_done)
    args, kw = k3_args[f32]
    adj_ms = _timed(lambda: ca.mlp_adjoint_solve(*args, **kw))
    pkw = _grid_kw(ca.mlp_adjoint_solve_plain, args, kw)
    bst = ca.mlp_adjoint_solve(*args, **kw)[3].tolist()
    print(f"[7] {smi}: K3 mlp_adjoint_solve {adj_ms:.3f} ms/sweep "
          f"(bench protocol, float32, "
          f"{bst[1] + bst[2]} attempts, nfe {bst[0]}, n_blocks "
          f"{pkw['n_blocks']}; the plain version timed in [50]); bound "
          f"{_bound(B * bst[0] * 3 * _mlp_flops(((D, H), (H, D)), 3), 4 * (2 * T_OUT * B * D + B * D + 2 * (2 * D * H + H + D) + T_OUT))}",
          flush=True)

    _at("8")
    # [8] spiral training at the bench protocol: SGD through the fused path.
    p, y, _ = _bench_params(B, f32, dev)
    W = [(p["w1"].clone().requires_grad_(), p["b1"].clone().requires_grad_()),
         (p["w2"].clone().requires_grad_(), p["b2"].clone().requires_grad_())]
    W0 = [x.detach().clone() for pair in W for x in pair]
    t = torch.linspace(0.0, SPAN, T_OUT)
    target = _bench_target(f32, dev)
    meter = NFEMeter()

    def sgd_step():
        ys, st = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=TOL, atol=TOL,
                                         nfe_meter=meter, return_stats=True)
        loss = torch.mean((ys - target) ** 2)
        loss.backward()
        with torch.no_grad():
            for x in (x for pair in W for x in pair):
                if not torch.isfinite(x.grad).all():
                    raise AssertionError("non-finite spiral gradient (a "
                                         "failed backward sweep)")
                x -= SGD_LR * x.grad
                x.grad = None
        if st.status != 0:
            raise AssertionError(f"spiral forward failed: {st}")
        return float(loss.detach())

    ck.reset_launch_counts()
    ca.reset_launch_counts()
    sgd_ms, sgd_all = _host_ms(sgd_step, reps=TRAIN_STEPS)
    train_launches = {"mlp_solve": ck.mlp_solve_launches,
                      "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches}
    moved = max(float((x.detach() - x0).abs().max())
                for x, x0 in zip((x for pair in W for x in pair), W0))
    print(f"[8] spiral SGD x{TRAIN_STEPS}: launches {train_launches}; "
          f"NFE forward {meter.f_nfe}, backward {meter.b_nfe}; max weight "
          f"change {moved:.3e}", flush=True)
    print(f"[8] {smi}: spiral training step (K2 + K3, bench protocol, "
          f"float32) {sgd_ms:.3f} ms median of {TRAIN_STEPS} "
          f"({', '.join(f'{x:.3f}' for x in sgd_all)})", flush=True)
    if train_launches != {"mlp_solve": TRAIN_STEPS,
                          "mlp_adjoint_solve": TRAIN_STEPS}:
        raise AssertionError(f"training launches {train_launches}")
    if not moved > 0.0:
        raise AssertionError("SGD left the weights unchanged")
    # Fused against the generic adjoint on a small input.
    ps, ys_, _ = _bench_params(96, f32, dev)
    ts = torch.linspace(0.0, 5.0, 12)
    tgt = torch.tensor(np.random.RandomState(2).randn(12, 96, D) * 0.5,
                       dtype=f32, device=dev)
    grads = []
    for fused in (True, False):
        Ws = [(ps["w1"].clone().requires_grad_(),
               ps["b1"].clone().requires_grad_()),
              (ps["w2"].clone().requires_grad_(),
               ps["b2"].clone().requires_grad_())]
        if fused:
            out = fast.odeint_adjoint_mlp(spec, Ws, ys_, ts, rtol=TOL,
                                          atol=TOL)
        else:
            out = odeint_adjoint(lambda tt, yy, w: fast.mlp_apply(spec, w,
                                                                 yy),
                                 ys_, ts, params=Ws, rtol=TOL, atol=TOL)
        torch.mean((out - tgt) ** 2).backward()
        grads.append([x.grad for pair in Ws for x in pair])
    gap = max(_rel(a, b) for a, b in zip(*grads))
    print(f"[8] B=96: fused and generic adjoint gradients agree to {gap:.3e}"
          " relative (bar 1e-3)", flush=True)
    if gap > 1e-3:
        raise AssertionError("fused and generic adjoint gradients differ")

    _at("9")
    # [9] latent-ODE training with --fused decoding at the defaults.
    largs = lode.parse_args(["--fused"])
    _, samp, _, samp_ts = lode.generate_spirals(
        nspiral=largs.nspiral, ntotal=largs.ntimes, nsample=largs.nsample,
        noise_std=largs.noise_std, seed=largs.seed)
    xs = torch.tensor(samp, dtype=f32, device=dev)
    samp_ts = torch.tensor(samp_ts, dtype=f32)
    rec, dyn, dec = convert.latent_ode_from_flax(
        lode.flax_layout_params(largs, seed=0), device=dev, dtype=f32)
    opt = torch.optim.Adam([q for m in (rec, dyn, dec)
                            for q in m.parameters()], lr=largs.lr)
    train_step, _ = lode.make_train_step(largs, rec, dyn, dec, opt, samp_ts)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []

    def adam_step():
        losses.append(float(train_step(xs, gen)))
        for m in (rec, dyn, dec):
            for q in m.parameters():
                if not torch.isfinite(q).all():
                    raise AssertionError("non-finite latent-ODE parameter")

    ck.reset_launch_counts()
    ca.reset_launch_counts()
    lat_ms, lat_all = _host_ms(adam_step, reps=TRAIN_STEPS)
    lat_launches = {"mlp_solve": ck.mlp_solve_launches,
                    "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches}
    print(f"[9] latent ODE Adam x{TRAIN_STEPS} (--fused, {largs.nspiral} "
          f"spirals x {largs.nsample} samples): launches {lat_launches}; "
          f"-ELBO {', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[9] {smi}: latent-ODE training step {lat_ms:.3f} ms median of "
          f"{TRAIN_STEPS} ({', '.join(f'{x:.3f}' for x in lat_all)})",
          flush=True)
    if lat_launches != {"mlp_solve": TRAIN_STEPS,
                        "mlp_adjoint_solve": TRAIN_STEPS}:
        raise AssertionError(f"latent-ODE launches {lat_launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"latent-ODE losses {losses}")

    _at("10")
    # [10] K8 against its plain version at the bench widths.
    t64 = {dtype: torch.linspace(0.0, SPAN, T_OUT, dtype=dtype)
           for dtype in (f32, f64)}
    k8_err, k8_args, k8_st = {}, {}, {}
    for method, steps, dtype in (
            ("rk4", 500, f32), ("rk4", 500, f64), ("rk4", None, f32),
            ("rk4", None, f64), ("euler", None, f64),
            ("midpoint", None, f64), ("rk4_38", None, f64)):
        p, y, _ = _bench_params(B, dtype, dev)
        W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
        warr, dims = ck.pack_mlp_weights(W, dtype, dev)
        t = t64[dtype]
        grid = t if steps is None else uniform_grid(t[0], t[-1], steps)
        args = (warr, dims, y, t, grid, 1.0)
        kw = dict(f0=fast.mlp_apply(spec, W, y), activation="tanh",
                  input_power=3, method=method)
        out, st = cf.mlp_solve_fixed(*args, **kw)
        again, st2 = cf.mlp_solve_fixed(*args, **kw)
        ref, st_ref = cf.mlp_solve_fixed_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        bitwise = bool(torch.equal(out, again) and torch.equal(st, st2))
        print(f"[10] K8 {method} {dtype} grid {grid.shape[0] - 1} steps: "
              f"kernel stats {st.tolist()}, plain {st_ref.tolist()}; max "
              f"|kernel - plain| {err:.3e} (relative {_rel(out, ref):.3e}); "
              f"bitwise equal to plain: {torch.equal(out, ref)}; two kernel "
              f"runs bitwise equal: {bitwise}; {_k8_layout(B)}", flush=True)
        if not bitwise:
            raise AssertionError("K8 is not deterministic from run to run")
        if not torch.equal(out, ref):
            raise AssertionError(f"K8 {method} {dtype} is not bitwise its "
                                 "plain version")
        if st[3].item() != 0 or not torch.isfinite(out).all() \
                or st.tolist() != st_ref.tolist():
            raise AssertionError(f"K8 {method} {dtype} failed: stats "
                                 f"{st.tolist()}, plain {st_ref.tolist()}")
        if dtype == f64 and _rel(out, ref) > 1e-12:
            raise AssertionError("K8 float64 differs from its plain version "
                                 "by more than 1e-12 relative")
        if dtype == f32 and err > 1e-5:
            raise AssertionError("K8 float32 differs from its plain version "
                                 "by more than 1e-5")
        if steps is not None:
            k8_err[dtype] = err
            k8_args[dtype] = (args, kw)
            k8_st[dtype] = st.tolist()

    _at("11")
    # [11] the fixed-grid forward through the public entry point.
    p, y, p_np = _bench_params(B, f32, dev)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    t = t64[f32]
    cf.reset_launch_counts()
    fixed = fast.solve_mlp_spec(spec, W, y, t, method="rk4", num_steps=500)
    torch.cuda.synchronize()
    k8_launches = cf.mlp_solve_fixed_launches
    nfe, acc, rej, status = fixed.stats
    print(f"[11] fast.solve_mlp_spec(method='rk4', num_steps=500): nfe {nfe}"
          f", steps {acc}, status {status}; K8 launches {k8_launches}; "
          f"{_k8_layout(B)}", flush=True)
    if k8_launches != 1 or status != 0 or nfe != 1 + 4 * 500 \
            or tuple(fixed.ys.shape) != (T_OUT, B, D) \
            or not torch.isfinite(fixed.ys).all():
        raise AssertionError("the fixed-grid forward failed at the bench "
                             "widths")
    adaptive = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL,
                              first_step=FIRST_STEP)
    print(f"[11] max |rk4 (K8) - dopri5 (K2)| at full size "
          f"{float((fixed.ys - adaptive.ys).abs().max()):.3e}", flush=True)
    ps, ys, _ = _bench_params(96, f32, dev)
    ts = torch.linspace(0.0, 5.0, 12)
    small = fast.solve_mlp_spec(spec, [(ps["w1"], ps["b1"]),
                                       (ps["w2"], ps["b2"])], ys, ts,
                                method="rk4", num_steps=500).ys
    with torch.no_grad():
        generic = solve(func, ys, ts, method="rk4",
                        options={"num_steps": 500}).ys
    gap = _rel(small, generic)
    print(f"[11] B=96: K8 and the generic rk4 agree to {gap:.3e} relative "
          "(bar 1e-5)", flush=True)
    if gap > 1e-5:
        raise AssertionError("K8 and the generic fixed-grid engine differ")

    _at("12")
    # [12] K9 against its plain version at the bench training protocol.
    k9_err, k9_args, k9_st = {}, {}, {}
    for dtype in (f64, f32):
        (fargs, fkw) = k8_args[dtype]
        ys = cf.mlp_solve_fixed(*fargs, **fkw)[0]
        target = _bench_target(dtype, dev)
        g = 2.0 * (ys - target) / target.numel()
        warr, dims, _, t = fargs[:4]
        args = (warr, dims, ys, g.contiguous(), t, 1.0)
        kw = dict(num_steps=8, activation="tanh", input_power=3,
                  method="rk4")
        k9_args[dtype] = (args, kw)
        got = cf.mlp_adjoint_solve_fixed(*args, **kw)
        again = cf.mlp_adjoint_solve_fixed(*args, **kw)
        ref = cf.mlp_adjoint_solve_fixed_plain(*args, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        rels = [_rel(a, b) for a, b in zip(got[:2], ref[:2])]
        print(f"[12] K9 {dtype}: kernel stats {got[3].tolist()}, plain "
              f"{ref[3].tolist()}; max relative |kernel - plain| ay0 "
              f"{rels[0]:.3e} aw {rels[1]:.3e}; kernel bitwise equal to "
              f"plain: {same}; two kernel runs bitwise equal: {bitwise}; "
              f"{_k9_layout(B)}", flush=True)
        if not bitwise:
            raise AssertionError("K9 is not deterministic from run to run")
        if not same:
            raise AssertionError(f"K9 {dtype} is not bitwise its plain "
                                 "version")
        if got[3].tolist() != ref[3].tolist() or got[3][0].item() != \
                4 * 8 * (T_OUT - 1) or not all(
                    torch.isfinite(x).all() for x in got[:3]):
            raise AssertionError(f"K9 {dtype} failed: {got[3].tolist()}")
        if max(rels) > (1e-9 if dtype == f64 else 1e-3):
            raise AssertionError(f"K9 {dtype} differs from its plain "
                                 "version")
        k9_err[dtype] = max(float((a - b).abs().max())
                            for a, b in zip(got[:3], ref[:3]))
        k9_st[dtype] = got[3].tolist()
    args, kw = k8_args[f32]
    fixed_ms = _timed(lambda: cf.mlp_solve_fixed(*args, **kw))
    fixed_plain_ms = _plain_ms(lambda: cf.mlp_solve_fixed_plain(*args,
                                                                **kw))
    print(f"[12] {smi}: K8 mlp_solve_fixed {fixed_ms:.3f} ms/solve vs plain "
          f"{fixed_plain_ms:.3f} ms (bench widths, rk4, 500 steps, "
          "float32)", flush=True)
    args, kw = k9_args[f32]
    fadj_ms = _timed(lambda: cf.mlp_adjoint_solve_fixed(*args, **kw))
    fadj_plain_ms = _plain_ms(
        lambda: cf.mlp_adjoint_solve_fixed_plain(*args, **kw))
    print(f"[12] {smi}: K9 mlp_adjoint_solve_fixed {fadj_ms:.3f} ms/sweep "
          f"vs plain {fadj_plain_ms:.3f} ms (bench training protocol, rk4, "
          f"8 steps an interval, {8 * (T_OUT - 1)} steps, float32)",
          flush=True)

    _at("13")
    # [13] ode_demo --fused --method rk4 at its defaults: RMSprop steps.
    dargs = demo.parse_args(["--fused", "--method", "rk4"])
    t_d, _, true_y = demo.true_trajectory(dargs, dev)
    rng = np.random.RandomState(dargs.seed)
    batches = [demo.get_batch(dargs, t_d, true_y, rng)[1:]
               for _ in range(TRAIN_STEPS)]
    grads = []
    for mode in ("--fused", "--adjoint"):
        margs = demo.parse_args([mode, "--method", "rk4"])
        mfunc = demo.make_ode_func(seed=margs.seed, device=dev)
        _, loss_fn = demo.make_train_step(margs, mfunc, None)
        loss_fn(*batches[0]).backward()
        grads.append([q.grad for q in mfunc.parameters()])
    gap = max(_rel(a, b) for a, b in zip(*grads))
    print(f"[13] first ode_demo batch: --fused and --adjoint (rk4) "
          f"gradients agree to {gap:.3e} relative (bar 1e-4)", flush=True)
    if gap > 1e-4:
        raise AssertionError("fused and generic fixed-grid adjoint "
                             "gradients differ")
    dfunc = demo.make_ode_func(seed=dargs.seed, device=dev)
    w0 = [q.detach().clone() for q in dfunc.parameters()]
    dmeter = NFEMeter()
    train_step, _ = demo.make_train_step(
        dargs, dfunc, demo.make_optimizer(dargs, dfunc), dmeter)
    demo_losses = []
    it = iter(batches)

    def rmsprop_step():
        demo_losses.append(float(train_step(*next(it))))

    cf.reset_launch_counts()
    demo_ms, demo_all = _host_ms(rmsprop_step, reps=TRAIN_STEPS)
    demo_launches = {
        "mlp_solve_fixed": cf.mlp_solve_fixed_launches,
        "mlp_adjoint_solve_fixed": cf.mlp_adjoint_solve_fixed_launches}
    moved = max(float((q.detach() - q0).abs().max())
                for q, q0 in zip(dfunc.parameters(), w0))
    print(f"[13] ode_demo --fused --method rk4, RMSprop x{TRAIN_STEPS}: "
          f"launches {demo_launches}; NFE forward {dmeter.f_nfe} "
          f"({dmeter.f_calls} solves), backward {dmeter.b_nfe}; L1 loss "
          f"{', '.join(f'{x:.6f}' for x in demo_losses)}; max weight change "
          f"{moved:.3e}", flush=True)
    print(f"[13] {smi}: ode_demo fused training step (K8 + K9, B = "
          f"{dargs.batch_size}, {dargs.batch_time} times) {demo_ms:.3f} ms "
          f"median of {TRAIN_STEPS} "
          f"({', '.join(f'{x:.3f}' for x in demo_all)})", flush=True)
    if demo_launches != {"mlp_solve_fixed": TRAIN_STEPS,
                         "mlp_adjoint_solve_fixed": TRAIN_STEPS}:
        raise AssertionError(f"ode_demo launches {demo_launches}")
    if dmeter.f_nfe != 37 * TRAIN_STEPS or dmeter.f_calls != TRAIN_STEPS:
        raise AssertionError(f"ode_demo forward NFE {dmeter.f_nfe}, "
                             f"expected 37 a step")
    if not all(np.isfinite(demo_losses)) or not moved > 0.0:
        raise AssertionError(f"ode_demo losses {demo_losses}, weight "
                             f"change {moved}")

    _at("14")
    # [14] K13 at the ODE-Net's full width, on the stem's output.
    fallbacks = fast.conv_ode_fallbacks
    oargs = onet.parse_args(["--synthetic_hard", "--adjoint", "--fused"])
    OB = oargs.batch_size
    x_tr, y_tr, x_te, y_te = onet.load_data(
        oargs, n_train=TRAIN_STEPS * OB, n_test=onet.EVAL_BATCH)
    omodel = onet.build_model(oargs, dev)
    ofunc, ot = omodel.block.func, [0.0, 1.0]
    with torch.no_grad():
        states = omodel.stem(torch.from_numpy(x_te).to(dev))
    k13_err, k13_args = {}, {}
    for Bc in (OB, onet.EVAL_BATCH):
        for dtype in (f32, f64):
            args, kw, _ = fast.conv_solve_inputs(ofunc, states[:Bc], ot,
                                                 dtype=dtype)
            out, st = cc.conv_solve(*args, **kw)
            again, st2 = cc.conv_solve(*args, **kw)
            ref, st_ref = cc.conv_solve_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            bitwise = bool(torch.equal(out, again) and torch.equal(st, st2))
            print(f"[14] K13 B={Bc} {dtype} ({st.shape[0]} blocks of "
                  f"{kw['block_size']}): kernel stats per block "
                  f"{st.tolist()}; plain identical: "
                  f"{st.tolist() == st_ref.tolist()}; max |kernel - plain| "
                  f"{err:.3e} (relative {_rel(out, ref):.3e}); bitwise equal "
                  f"to plain: {torch.equal(out, ref)}; two kernel runs "
                  f"bitwise equal: {bitwise}; "
                  f"{_k13_grid(Bc, kw['block_size'], dev)}", flush=True)
            if not bitwise:
                raise AssertionError("K13 is not deterministic from run to "
                                     "run")
            if not torch.equal(out, ref):
                raise AssertionError(f"K13 B={Bc} {dtype} is not bitwise its "
                                     "plain version")
            if st.tolist() != st_ref.tolist() or (st[:, 3] != 0).any() \
                    or not torch.isfinite(out).all():
                raise AssertionError(f"K13 B={Bc} {dtype} failed: stats "
                                     f"{st.tolist()}, plain "
                                     f"{st_ref.tolist()}")
            if (_rel(out, ref) > 1e-12) if dtype == f64 else (err > 1e-5):
                raise AssertionError(f"K13 B={Bc} {dtype} differs from its "
                                     "plain version")
            k13_err[(Bc, dtype)] = err
            k13_args[(Bc, dtype)] = (args, kw, out, st)
    # The generic engine on the same partition and first steps (cuDNN convs
    # with TF32 off, ConcatConv2d's scope).
    args, kw, k13_out, k13_st = k13_args[(OB, f32)]
    blk, dt0 = kw["block_size"], args[4].tolist()
    tt = torch.tensor(ot)

    def generic_blocks():
        with torch.no_grad():
            return [solve(ofunc, states[b:min(OB, b + blk)], tt,
                          rtol=1e-3,
                          atol=1e-3, options={"first_step": d})
                    for b, d in zip(range(0, OB, blk), dt0)]

    gen = generic_blocks()
    gen_ys = torch.cat([r.ys for r in gen], dim=1)
    gap = _rel(gen_ys, k13_out)
    same = sum(list(r.stats)[1:3] == s[1:3]
               for r, s in zip(gen, k13_st.tolist()))
    print(f"[14] B={OB}: the generic engine block by block agrees with K13 "
          f"to {gap:.3e} relative (bar 1e-2, ten times the tolerance); "
          f"{same} of {len(gen)} blocks took the same steps", flush=True)
    if gap > 1e-2 or any(r.stats.status != 0 for r in gen):
        raise AssertionError("K13 and the generic engine differ")
    conv_ms = _timed(lambda: cc.conv_solve(*args, **kw))
    conv_plain_ms = _plain_ms(lambda: cc.conv_solve_plain(*args, **kw))
    conv_generic_ms = _timed(generic_blocks, reps=2)
    args256, kw256 = k13_args[(onet.EVAL_BATCH, f32)][:2]
    conv256_ms = _timed(lambda: cc.conv_solve(*args256, **kw256))
    print(f"[14] {smi}: K13 conv_solve {conv_ms:.3f} ms/solve at B={OB} "
          f"({conv256_ms:.3f} ms at B={onet.EVAL_BATCH}) vs plain "
          f"{conv_plain_ms:.3f} ms vs the generic engine {conv_generic_ms:.3f}"
          f" ms (float32, {int(k13_st[:, 1].sum() + k13_st[:, 2].sum())} "
          f"attempts over {k13_st.shape[0]} blocks)", flush=True)

    _at("15")
    # [15] the ODE-Net example: --synthetic_hard --adjoint --fused steps.
    ometer = NFEMeter()
    model = onet.build_model(oargs, dev, nfe_meter=ometer)
    w0 = [q.detach().clone() for q in model.parameters()]
    opt, sched = onet.make_optimizer(oargs, model, len(x_tr) // OB)
    onet_step = onet.make_train_step(model, opt, sched)
    batches = iter([(torch.from_numpy(x_tr[i * OB:(i + 1) * OB]).to(dev),
                     torch.from_numpy(y_tr[i * OB:(i + 1) * OB]).to(dev))
                    for i in range(TRAIN_STEPS)])
    eval_model = onet.build_model(oargs, dev, fused_inference=True)
    onet_losses = []

    def onet_sgd():
        onet_losses.append(float(onet_step(*next(batches))))

    cc.reset_launch_counts()
    onet_ms, onet_all = _host_ms(onet_sgd, reps=TRAIN_STEPS)
    step_launches = cc.conv_solve_launches
    eval_model.load_state_dict(model.state_dict())
    acc, eval_nfe = onet.evaluate(eval_model, x_te, y_te, dev)
    torch.cuda.synchronize()
    k13_launches = cc.conv_solve_launches
    moved = max(float((q.detach() - q0).abs().max())
                for q, q0 in zip(model.parameters(), w0))
    print(f"[15] odenet_mnist --synthetic_hard --adjoint --fused, SGD "
          f"x{TRAIN_STEPS} at B={OB}: K13 launches {step_launches} in the "
          f"steps, {k13_launches} with the --fused_eval batch of "
          f"{onet.EVAL_BATCH}; cross-entropy "
          f"{', '.join(f'{x:.4f}' for x in onet_losses)}; f-NFE "
          f"{ometer.f_nfe / max(1, ometer.f_calls):.0f} and b-NFE "
          f"{ometer.b_nfe / max(1, ometer.b_calls):.0f} a step; max weight "
          f"change {moved:.3e}; evaluation accuracy {acc:.4f}, NFE "
          f"{eval_nfe}", flush=True)
    print(f"[15] {smi}: ODE-Net training step (K13 forward + generic "
          f"adjoint backward, B={OB}) {onet_ms:.3f} ms median of "
          f"{TRAIN_STEPS} ({', '.join(f'{x:.3f}' for x in onet_all)})",
          flush=True)
    if step_launches != TRAIN_STEPS or k13_launches != TRAIN_STEPS + 1:
        raise AssertionError(f"ODE-Net K13 launches {step_launches}, "
                             f"{k13_launches}")
    if ometer.f_calls != TRAIN_STEPS or ometer.b_calls != TRAIN_STEPS:
        raise AssertionError(f"ODE-Net solves recorded {ometer.snapshot()}")
    if not all(np.isfinite(onet_losses)) or not moved > 0.0:
        raise AssertionError(f"ODE-Net losses {onet_losses}, weight change "
                             f"{moved}")
    if fast.conv_ode_fallbacks != fallbacks:
        raise AssertionError("solve_conv_ode took the generic engine")
    # One more step, profiled: where the step's time goes.
    batches = iter([(torch.from_numpy(x_tr[:OB]).to(dev),
                     torch.from_numpy(y_tr[:OB]).to(dev))])
    host_ms, busy_ms, top = _profiled(onet_sgd)
    print(f"[15] {smi}: one profiled ODE-Net step: {host_ms:.3f} ms on the "
          f"host clock, {busy_ms:.3f} ms of kernels (device idle share "
          f"{1.0 - busy_ms / host_ms:.3f}); top kernels by device time: "
          + "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, ms, n in top),
          flush=True)

    _at("16")
    # [16] K5 at the bench protocol, every sample under its own controller.
    def perlane_inputs(Bn, dtype, span, n_out):
        p, y, _ = _bench_params(Bn, dtype, dev)
        W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
        warr, dims = ck.pack_mlp_weights(W, dtype, dev)
        f0 = fast.mlp_apply(spec, W, y)
        t = torch.linspace(0.0, span, n_out, dtype=dtype)
        on = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        dt0 = select_initial_step_per_sample(
            lambda s, yy: fast.mlp_apply(spec, W, yy), on(0.0), y, f0,
            DOPRI5.order - 1, on(TOL), on(TOL))
        return p, W, y, t, (warr, dims, y, t, dt0, TOL, TOL, 1.0), f0

    k5_err, k5_args = {}, {}
    for dtype in (f64, f32):
        _, _, _, _, args, f0 = perlane_inputs(B, dtype, SPAN, T_OUT)
        kw = dict(f0=f0, activation="tanh", input_power=3)
        k5_args[dtype] = (args, kw)
        out, st, lane = cp.mlp_solve_perlane(*args, **kw)
        again = cp.mlp_solve_perlane(*args, **kw)
        ref, st_ref, lane_ref = cp.mlp_solve_perlane_plain(*args, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip((out, st, lane),
                                                        again))
        same_lanes = torch.equal(lane, lane_ref) and torch.equal(st, st_ref)
        rel = _rel(out, ref)
        print(f"[16] K5 {dtype}: kernel stats {st.tolist()}, plain "
              f"{st_ref.tolist()}; per-sample counts identical in all {B} "
              f"samples: {same_lanes}; max |kernel - plain| "
              f"{float((out - ref).abs().max()):.3e} (relative {rel:.3e}); "
              f"bitwise equal to plain: {torch.equal(out, ref)}; two kernel "
              f"runs bitwise equal: {bitwise}; {_k5_layout(B)}", flush=True)
        if not bitwise:
            raise AssertionError("K5 is not deterministic from run to run")
        if not (same_lanes and torch.equal(out, ref)):
            raise AssertionError(f"K5 {dtype} is not bitwise its plain "
                                 "version")
        if (lane[3] != 0).any() or not torch.isfinite(out).all():
            raise AssertionError(f"K5 {dtype} failed: stats {st.tolist()}")
        if dtype == f64 and (not same_lanes or rel > 1e-12):
            raise AssertionError("K5 float64 differs from its plain version "
                                 "(needs identical per-sample counts, ys "
                                 "within 1e-12 relative)")
        if dtype == f32 and rel > 1e-5:
            raise AssertionError("K5 float32 differs from its plain version "
                                 "by more than 1e-5 relative")
        k5_err[dtype] = float((out - ref).abs().max())
    # The public entry point: one K5 launch, no shared-controller launch.
    p, W, y, t, _, _ = perlane_inputs(B, f32, SPAN, T_OUT)
    cp.reset_launch_counts()
    ck.reset_launch_counts()
    per = fast.solve_mlp_spec(spec, W, y, t, rtol=TOL, atol=TOL,
                              per_sample=True)
    torch.cuda.synchronize()
    k5_launches = {"mlp_solve_perlane": cp.mlp_solve_perlane_launches,
                   "mlp_solve": ck.mlp_solve_launches}
    lane_nfe = per.lane_stats.nfe.float()
    shared = fast.solve_mlp(p, y, t, rtol=TOL, atol=TOL)
    print(f"[16] fast.solve_mlp_spec(per_sample=True): stats {per.stats}; "
          f"launches {k5_launches} ({_k5_layout(B)}); the samples' nfe min "
          f"{int(lane_nfe.min())}, median {int(lane_nfe.median())}, max "
          f"{int(lane_nfe.max())} against {shared.stats.nfe} for every "
          f"sample under the shared controller (fast.solve_mlp, K2); max "
          f"|per-sample - shared| {float((per.ys - shared.ys).abs().max()):.3e}",
          flush=True)
    if k5_launches != {"mlp_solve_perlane": 1, "mlp_solve": 0} \
            or per.stats.status != 0 or tuple(per.ys.shape) != (T_OUT, B, D) \
            or not torch.isfinite(per.ys).all():
        raise AssertionError("the per-sample forward failed at the bench "
                             "protocol")
    # Against the generic engine, one solve a sample (float64).
    func64 = convert.ode_func_from_flax(flax_like, device=dev, dtype=f64)
    p64, W64, y64, t64s, _, _ = perlane_inputs(96, f64, 5.0, 12)
    small = fast.solve_mlp_spec(spec, W64, y64, t64s, rtol=TOL, atol=TOL,
                                per_sample=True)
    with torch.no_grad():
        gen = solve(func64, y64, t64s, rtol=TOL, atol=TOL,
                    options={"per_sample": True})
    gap = _rel(small.ys, gen.ys)
    nfe_k, nfe_g = small.lane_stats.nfe.cpu(), gen.lane_stats.nfe
    nfe_gap = (nfe_k - nfe_g).abs()
    nfe_ok = bool((nfe_gap <= torch.clamp(0.15 * nfe_g, min=8)).all())
    print(f"[16] B=96 float64: K5 and the generic per-sample solve agree to "
          f"{gap:.3e} relative (bar 1e-5); every sample's nfe within "
          f"max(8, 15%) of its generic count: {nfe_ok} (largest gap "
          f"{int(nfe_gap.max())})", flush=True)
    if gap > 1e-5 or not nfe_ok or gen.stats.status != 0:
        raise AssertionError("K5 and the generic per-sample solve differ")
    args, kw = k5_args[f32]
    perlane_ms = _timed(lambda: cp.mlp_solve_perlane(*args, **kw))
    perlane_plain_ms = _plain_ms(lambda: cp.mlp_solve_perlane_plain(
        *args, **kw))
    k2_args32, k2_kw32 = k2_args[f32]
    shared_ms = _timed(lambda: ck.mlp_solve(*k2_args32, **k2_kw32))
    k5_st = cp.mlp_solve_perlane(*args, **kw)[1].tolist()
    print(f"[16] {smi}: K5 mlp_solve_perlane {perlane_ms:.3f} ms/solve vs "
          f"plain {perlane_plain_ms:.3f} ms vs K2 (shared controller) "
          f"{shared_ms:.3f} ms (bench protocol, float32; K5 nfe {k5_st[0]}, "
          f"{k5_st[1] + k5_st[2]} attempts over the samples)", flush=True)

    _at("17")
    # [17] K6 at the bench training protocol with per_sample=True.
    k6_err, k6_args = {}, {}
    for dtype in (f64, f32):
        _, W, y, t, _, _ = perlane_inputs(B, dtype, SPAN, T_OUT)
        ys = fast.solve_mlp_spec(spec, W, y, t, rtol=TOL, atol=TOL,
                                 per_sample=True).ys
        target = _bench_target(dtype, dev)
        g = 2.0 * (ys - target) / target.numel()
        warr, dims = ck.pack_mlp_weights(W, dtype, dev)
        args = (warr, dims, ys.contiguous(), g.contiguous(), t,
                0.1 * abs(float(t[-1] - t[-2])), TOL, TOL, 1.0)
        kw = dict(activation="tanh", input_power=3)
        k6_args[dtype] = (args, kw)
        got = cp.mlp_perlane_adjoint_solve(*args, **kw)
        again = cp.mlp_perlane_adjoint_solve(*args, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        bnfe = got[4][0].float()
        print(f"[17] K6 {dtype}: kernel stats {got[3].tolist()}; two "
              f"kernel runs bitwise equal: {bitwise}; the samples' "
              f"backward nfe min {int(bnfe.min())}, median "
              f"{int(bnfe.median())}, max {int(bnfe.max())}; its plain "
              "version holds it in [50]", flush=True)
        if not bitwise:
            raise AssertionError("K6 is not deterministic from run to run")
        if (got[4][3] != 0).any() or not all(
                torch.isfinite(x).all() for x in got[:3]):
            raise AssertionError(f"K6 {dtype} failed: {got[3].tolist()}")

        # Outputs, stats and per-sample counts bitwise equal to the plain
        # version's, in [50]'s workers.
        def k6_done(err, plain_ms, dtype=dtype):
            k6_err[dtype] = err
            if dtype == f32:
                holds_ms["K6"] = plain_ms
        _LATER.add((args, kw, got), cp.mlp_perlane_adjoint_solve_plain,
                   f"[17] K6 {dtype} (held in [50])", k6_done)
    # Three SGD steps through the public entry point.
    p, _, y, t, _, _ = perlane_inputs(B, f32, SPAN, T_OUT)
    W = [(p["w1"].clone().requires_grad_(), p["b1"].clone().requires_grad_()),
         (p["w2"].clone().requires_grad_(), p["b2"].clone().requires_grad_())]
    W0 = [x.detach().clone() for pair in W for x in pair]
    target = _bench_target(f32, dev)
    pmeter = NFEMeter()

    def per_sample_sgd():
        ys, st = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=TOL, atol=TOL,
                                         nfe_meter=pmeter, return_stats=True,
                                         per_sample=True)
        torch.mean((ys - target) ** 2).backward()
        with torch.no_grad():
            for x in (x for pair in W for x in pair):
                if not torch.isfinite(x.grad).all():
                    raise AssertionError("non-finite per-sample gradient (a "
                                         "failed backward sweep)")
                x -= SGD_LR * x.grad
                x.grad = None
        if st.status != 0:
            raise AssertionError(f"per-sample forward failed: {st}")

    for mod in (ck, ca, cp):
        mod.reset_launch_counts()
    ps_sgd_ms, ps_sgd_all = _host_ms(per_sample_sgd, reps=TRAIN_STEPS)
    ps_launches = {"mlp_solve_perlane": cp.mlp_solve_perlane_launches,
                   "mlp_perlane_adjoint_solve":
                       cp.mlp_perlane_adjoint_solve_launches,
                   "mlp_solve": ck.mlp_solve_launches,
                   "mlp_adjoint_solve": ca.mlp_adjoint_solve_launches}
    moved = max(float((x.detach() - x0).abs().max())
                for x, x0 in zip((x for pair in W for x in pair), W0))
    print(f"[17] per-sample SGD x{TRAIN_STEPS}: launches {ps_launches}; NFE "
          f"forward {pmeter.f_nfe}, backward {pmeter.b_nfe}; max weight "
          f"change {moved:.3e}", flush=True)
    print(f"[17] {smi}: per-sample training step (K5 + K6, bench protocol, "
          f"float32) {ps_sgd_ms:.3f} ms median of {TRAIN_STEPS} "
          f"({', '.join(f'{x:.3f}' for x in ps_sgd_all)})", flush=True)
    if ps_launches != {"mlp_solve_perlane": TRAIN_STEPS,
                       "mlp_perlane_adjoint_solve": TRAIN_STEPS,
                       "mlp_solve": 0, "mlp_adjoint_solve": 0}:
        raise AssertionError(f"per-sample training launches {ps_launches}")
    if not moved > 0.0:
        raise AssertionError("per-sample SGD left the weights unchanged")
    # Per-sample against shared-controller fused gradients (float64).
    ts = torch.linspace(0.0, 5.0, 12, dtype=f64)
    tgt = torch.tensor(np.random.RandomState(2).randn(12, 96, D) * 0.5,
                       dtype=f64, device=dev)
    grads = []
    for per_sample in (True, False):
        Ws = [(w.clone().requires_grad_(), b.clone().requires_grad_())
              for w, b in W64]
        out = fast.odeint_adjoint_mlp(spec, Ws, y64, ts, rtol=TOL, atol=TOL,
                                      adjoint_seminorm=True,
                                      per_sample=per_sample)
        torch.mean((out - tgt) ** 2).backward()
        grads.append([x.grad for pair in Ws for x in pair])
    gap = max(_rel(a, b) for a, b in zip(*grads))
    print(f"[17] B=96 float64: per-sample and shared-controller fused "
          f"gradients agree to {gap:.3e} relative (bar 1e-4)", flush=True)
    if gap > 1e-4:
        raise AssertionError("per-sample and shared-controller gradients "
                             "differ")
    args, kw = k6_args[f32]
    perlane_adj_ms = _timed(lambda: cp.mlp_perlane_adjoint_solve(*args, **kw))
    k3a, k3k = k3_args[f32]
    shared_adj_ms = _timed(lambda: ca.mlp_adjoint_solve(*k3a, **k3k), reps=3)
    k6_st = cp.mlp_perlane_adjoint_solve(*args, **kw)[3].tolist()
    print(f"[17] {smi}: K6 mlp_perlane_adjoint_solve {perlane_adj_ms:.3f} "
          f"ms/sweep (the plain version timed in [50]) vs K3 (shared "
          f"controller) {shared_adj_ms:.3f} ms (bench training protocol, "
          f"float32; K6 nfe {k6_st[0]}, {k6_st[1] + k6_st[2]} attempts over "
          f"the samples; {_k6_layout(B)})", flush=True)

    wide = _wide_tier(smi, dev)
    cnf = _cnf_tier(smi, dev)
    adams = _adams_tier(smi, dev)
    plan = _plan_tier(smi, dev, plan_builds, plan_pairs)
    plan_pool.shutdown()
    aug = _aug_tier(smi, dev)
    late = _hyper_adams_tier(smi, dev)
    dense = _dense_tier(smi, dev)
    coupled = _coupled_tier(smi, dev, plan["coupled"], aug["coupled"])
    df = _df_tier(smi, dev)
    tier_sites = _tier_sites(smi, dev, wide, tier_plans)
    _at("50")
    _LATER.run()

    # Bounds: the operations and bytes of each timed run's inputs.
    mlp = _mlp_flops(((D, H), (H, D)), input_power=3)
    n_w = D * H + H + H * D + D
    k1_bound = _bound(B * (6 * mlp + D * _combine_flops(DOPRI5)),
                      4 * (5 * B * D + n_w))
    nfe, acc2, rej, _ = k2_st[f32]
    k2_bound = _bound(
        B * (nfe * mlp + (acc2 + rej) * D * _combine_flops(DOPRI5)),
        4 * (2 * B * D + T_OUT * B * D + T_OUT + n_w))
    # An adjoint evaluation: the forward MLP and its VJP (about 3 times the
    # forward's operations).
    k3_bound = _bound(B * bst[0] * 3 * mlp,
                      4 * (2 * T_OUT * B * D + B * D + 2 * n_w + T_OUT))
    k8_bound = _bound(
        B * (k8_st[f32][0] * mlp + 500 * D * _combine_flops(RK4)),
        4 * (2 * B * D + T_OUT * B * D + n_w + T_OUT + 501))
    k9_bound = _bound(B * k9_st[f32][0] * 3 * mlp,
                      4 * (2 * T_OUT * B * D + B * D + 2 * n_w + T_OUT))
    k13a = k13_args[(OB, f32)][0]
    spec13 = k13a[1]
    C13, P13 = spec13.channels, spec13.positions
    sizes = [min(blk, OB - b) for b in range(0, OB, blk)]
    k13_flops = sum(
        nb * (s[0] * _conv_eval_flops(C13, spec13.height, spec13.width)
              + (s[1] + s[2]) * C13 * P13 * _combine_flops(DOPRI5))
        for nb, s in zip(sizes, k13_st.tolist()))
    k13_bound = _bound(k13_flops, 4 * (2 * OB * C13 * P13
                                       + len(ot) * OB * C13 * P13
                                       + k13a[0].numel() + len(sizes)))
    # K5 and K6: the sums of the samples' own evaluations and attempts.
    k5_bound = _bound(
        k5_st[0] * mlp + (k5_st[1] + k5_st[2]) * D * _combine_flops(DOPRI5),
        4 * (2 * B * D + B + T_OUT * B * D + T_OUT + n_w) + 4 * 5 * B)
    k6_bound = _bound(k6_st[0] * 3 * mlp,
                      4 * (2 * T_OUT * B * D + B * D + B + 2 * n_w + T_OUT)
                      + 4 * 5 * B)

    k4_bound = wide["k4_bound"]
    pf, nc = plan["plan_flops"], plan["n_consts"]
    nfe14, acc14, rej14, _ = plan["k2_stats"]
    nfe5, acc5, rej5, _ = plan["k5_stats"]
    k14_bound = {
        "K2": _bound(B * (nfe14 * pf + (acc14 + rej14) * D
                          * _combine_flops(DOPRI5)),
                     4 * (2 * B * D + T_OUT * B * D + T_OUT + nc)),
        "K8": _bound(B * (plan["k8_nfe"] * pf + 500 * D
                          * _combine_flops(RK4)),
                     4 * (2 * B * D + T_OUT * B * D + nc + T_OUT + 501)),
        "K5": _bound(nfe5 * pf + (acc5 + rej5) * D * _combine_flops(DOPRI5),
                     4 * (2 * B * D + B + T_OUT * B * D + T_OUT + nc)
                     + 4 * 5 * B)}
    # K14 in K10 and K11 ([39], [40]) beside its other hosts.
    for host in ("K10", "K11"):
        plan["launches"][host] = late["launches"][host]
        plan["err"][host] = late["err"][host]
        plan["ms"][host] = late["ms"][host]
        plan["plain_ms"][host] = late["plain_ms"][host]
        plan["mlp_route_ms"][host] = late["mlp_route_ms"][host]
        k14_bound[host] = late["bound"][host]
    plan["ms"]["K10 explicit"] = late["ms"]["K10 explicit"]
    plan["plain_ms"]["K10 explicit"] = late["plain_ms"]["K10 explicit"]
    plan["mlp_route_ms"]["K10 explicit"] = late["mlp_route_ms"][
        "K10 explicit"]
    kernels = [
        {"name": "dopri5_mlp_step", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/step_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:614",
         "launches": launches["dopri5_mlp_step"],
         "max_abs_err": k1_err[f32], "ms": step_ms,
         "plain_ms": step_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "threads_a_sample": ck.STEP_BLOCK // ck.step_samples(D, H, 4),
         "kernel_ms": step_kernel_ms},
        {"name": "mlp_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/solve_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:726",
         "launches": launches["mlp_solve"],
         "max_abs_err": k2_err[f32], "ms": solve_ms,
         "plain_ms": solve_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "n_blocks": ck.solve_blocks(B, dev)},
        {"name": "mlp_adjoint_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/adjoint_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_adjoint.py:430",
         "launches": train_launches["mlp_adjoint_solve"],
         "max_abs_err": k3_err[f32], "ms": adj_ms,
         "plain_ms": holds_ms["K3"], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None,
         "n_blocks": ck.solve_blocks(B, dev)},
        {"name": "fixed_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/fixed_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_fixed.py:102",
         "launches": k8_launches, "max_abs_err": k8_err[f32],
         "ms": fixed_ms, "plain_ms": fixed_plain_ms,
         "bound_ms": k8_bound[0], "bound_by": k8_bound[1],
         "library_ms": None, "group": cf.FIXED_GROUP,
         "blocks": -(-B // (cf.FIXED_GROUP_THREADS // cf.FIXED_GROUP))},
        {"name": "fixed_adjoint_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/fixed_adjoint_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_fixed.py:726",
         "launches": demo_launches["mlp_adjoint_solve_fixed"],
         "max_abs_err": k9_err[f32], "ms": fadj_ms,
         "plain_ms": fadj_plain_ms, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": None,
         "group": 16, "blocks": -(-B // 32)},
        {"name": "conv_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/conv_solve_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_conv.py:110",
         "launches": k13_launches, "max_abs_err": k13_err[(OB, f32)],
         "ms": conv_ms, "plain_ms": conv_plain_ms, "bound_ms": k13_bound[0],
         "bound_by": k13_bound[1], "library_ms": None,
         "generic_engine_ms": conv_generic_ms,
         "ms_eval_batch": conv256_ms,
         "ctas": cc.conv_ctas(OB, k13_args[(OB, f32)][1]["block_size"], dev),
         "ctas_eval_batch": cc.conv_ctas(
             onet.EVAL_BATCH, k13_args[(onet.EVAL_BATCH, f32)][1][
                 "block_size"], dev)},
        {"name": "mlp_solve_perlane", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/perlane_solve_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:929",
         "launches": k5_launches["mlp_solve_perlane"],
         "max_abs_err": k5_err[f32], "ms": perlane_ms,
         "plain_ms": perlane_plain_ms, "bound_ms": k5_bound[0],
         "bound_by": k5_bound[1], "library_ms": None,
         "shared_controller_ms": shared_ms, "group": cp.PERLANE_GROUP,
         "blocks": -(-B // (cp.PERLANE_SOLVE_THREADS // cp.PERLANE_GROUP))},
        {"name": "mlp_perlane_adjoint_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/perlane_adjoint_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_adjoint.py:681",
         "launches": ps_launches["mlp_perlane_adjoint_solve"],
         "max_abs_err": k6_err[f32], "ms": perlane_adj_ms,
         "plain_ms": holds_ms["K6"], "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "library_ms": None,
         "shared_controller_ms": shared_adj_ms,
         "group": cp.PERLANE_GROUP, "blocks": -(-B // cp.PERLANE_THREADS)},
        {"name": "dot_tiers", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/dot_tiers.cuh",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:361",
         "launches": wide["k4_launches"], "max_abs_err": wide["k4_err"],
         "ms": wide["k4_device_ms"], "host_clocked_ms": wide["k4_ms"],
         "pack_ms": wide["k4_parts"]["mixed"][0],
         "eval_ms": wide["k4_parts"]["mixed"][1],
         "library_host_clocked_ms": wide["k4_library_host_ms"],
         "plain_ms": wide["k4_plain_ms"],
         "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": wide["k4_library_ms"]},
        {"name": "cnf_forward", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/cnf_net.cuh",
         "replaces": "tfdiffeq_tpu/ops/pallas_kernels.py:442",
         "launches": cnf["ex_launches"]["cnf_solve"],
         "max_abs_err": cnf["fwd_err"], "ms": cnf["fwd_ms"],
         "plain_ms": cnf["fwd_plain_ms"], "bound_ms": cnf["fwd_bound"][0],
         "bound_by": cnf["fwd_bound"][1], "library_ms": None,
         "generic_engine_ms": cnf["fwd_generic_ms"],
         "layout": cnf["fwd_layout"]},
        {"name": "cnf_adjoint", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/cnf_net.cuh",
         "replaces": "tfdiffeq_tpu/ops/pallas_adjoint.py:240",
         "launches": cnf["ex_launches"]["cnf_adjoint"],
         "max_abs_err": cnf["adj_err"], "ms": cnf["adj_ms"],
         "plain_ms": cnf["adj_plain_ms"], "bound_ms": cnf["adj_bound"][0],
         "bound_by": cnf["adj_bound"][1], "library_ms": None,
         "train_step_ms": cnf["train_ms"],
         "generic_train_step_ms": cnf["gen_train_ms"],
         "layout": cnf["adj_layout"]},
        {"name": "adams_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/adams_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_fixed.py:512",
         "launches": adams["adams_launches"],
         "max_abs_err": adams["adams_err"], "ms": adams["adams_ms"],
         "plain_ms": adams["adams_plain_ms"],
         "bound_ms": adams["adams_bound"][0],
         "bound_by": adams["adams_bound"][1], "library_ms": None,
         "generic_engine_ms": adams["adams_generic_ms"],
         "explicit_ms": adams["explicit_ms"],
         "explicit_plain_ms": adams["explicit_plain_ms"],
         "explicit_bound_ms": adams["explicit_bound"][0],
         "explicit_generic_engine_ms": adams["explicit_generic_ms"],
         "explicit_launches": adams["explicit_launches"],
         "explicit_layouts": adams["explicit_layouts"],
         "explicit_plan_layouts": late["explicit_plan_layouts"],
         "n_blocks": ck.solve_blocks(B, dev)},
        {"name": "vcabm_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/vcabm_kernel.cu",
         "replaces": "tfdiffeq_tpu/ops/pallas_vcabm.py:51",
         "launches": adams["vcabm_launches"],
         "max_abs_err": adams["vcabm_err"], "ms": adams["vcabm_ms"],
         "plain_ms": adams["vcabm_plain_ms"],
         "bound_ms": adams["vcabm_bound"][0],
         "bound_by": adams["vcabm_bound"][1], "library_ms": None,
         "generic_engine_ms": adams["vcabm_generic_ms"],
         "train_step_ms": adams["train_ms"],
         "n_blocks": ck.solve_blocks(B, dev)},
        {"name": "plan_rhs", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/plan_rhs.cuh",
         "generated_by": "tfdiffeq_tpu_torch/ops/plan_codegen.py",
         "replaces": "tfdiffeq_tpu/ops/jaxpr_bridge.py:826",
         "launches": sum(plan["launches"].values()),
         "launches_by_host": plan["launches"],
         "max_abs_err": max(plan["err"].values()),
         "max_abs_err_by_host": plan["err"],
         "ms": plan["ms"]["K2"], "ms_by_host": plan["ms"],
         "plain_ms": plan["plain_ms"]["K2"],
         "plain_ms_by_host": plan["plain_ms"],
         "bound_ms": k14_bound["K2"][0], "bound_by": k14_bound["K2"][1],
         "bound_ms_by_host": {h: b[0] for h, b in k14_bound.items()},
         "library_ms": None, "build_s": plan["build_s"],
         "n_blocks": ck.solve_blocks(B, dev),
         "mlp_route_ms": plan["mlp_route_ms"],
         "walk_by_host": plan["walk"],
         "coupled_k2": plan["coupled"],
         "cnf_sample_auto_ms": plan["flow_ms"],
         "cnf_sample_auto_kernel_ms": plan["flow_kernel_ms"],
         "capture_ms": plan["capture_ms"],
         "cnf_sample_fused_ms": plan["flow_fused_ms"]},
        {"name": "plan_aug", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/plan_aug.cuh",
         "generated_by": "tfdiffeq_tpu_torch/ops/plan_codegen.py",
         "replaces": "tfdiffeq_tpu/ops/plan_adjoint.py:154",
         "launches": sum(aug["launches"].values()),
         "launches_by_host": aug["launches"],
         "max_abs_err": max(aug["err"].values()),
         "max_abs_err_by_host": aug["err"],
         "ms": aug["ms"]["K3"], "ms_by_host": aug["ms"],
         "plain_ms": aug["plain_ms"]["K3"],
         "plain_ms_by_host": aug["plain_ms"],
         "bound_ms": aug["bound"]["K3"][0],
         "bound_by": aug["bound"]["K3"][1],
         "bound_ms_by_host": {h: b[0] for h, b in aug["bound"].items()},
         "library_ms": None,
         "generic_ms": aug["generic_ms"]["K3"],
         "generic_ms_by_host": aug["generic_ms"],
         "train_step_ms_by_host": aug["step_ms"],
         "mlp_route_ms": aug["mlp_route_ms"],
         "mlp_route_step_ms": aug["mlp_route_step_ms"],
         "walk_by_host": aug["walk"],
         "shared_controller_step_ms": aug["shared_controller_step_ms"],
         "k6_failed_samples": aug["k6_failed_samples"],
         "k6_spiral": aug["k6_spiral"],
         "coupled_k3": aug["coupled"]},
        {"name": "hyper_solve", "route": "cuda",
         "source": "tfdiffeq_tpu_torch/csrc/rk_hyper.cuh",
         "generated_by": "tfdiffeq_tpu_torch/ops/plan_codegen.py",
         "replaces": "tfdiffeq_tpu/ops/pallas_fixed.py:313",
         "launches": late["launches"]["K12"],
         "max_abs_err": late["err"]["K12"], "ms": late["ms"]["K12"],
         "plain_ms": late["plain_ms"]["K12"],
         "bound_ms": late["bound"]["K12"][0],
         "bound_by": late["bound"]["K12"][1], "library_ms": None,
         "ms_by_kind": late["k12_ms_by_kind"],
         "kernel_ms_by_kind": late["k12_kernel_ms_by_kind"],
         "kernel_ms_b256": late["k12_kernel_ms_b256"],
         "layouts": late["k12_layouts"],
         "plain_ms_by_kind": late["k12_plain_ms_by_kind"],
         "bound_ms_by_kind": {k: b[0] for k, b in
                              late["k12_bound_by_kind"].items()},
         "entry_point_ms": late["k12_entry_ms"],
         "generic_engine_ms": late["generic_ms"]["K12"],
         "example": late["example"]},
    ]
    # K14's record: the generic engine beside K10, and the Adams-forward
    # training step on K11 (tier 2).
    kernels[-3]["generic_engine_ms_by_host"] = {
        h: late["generic_ms"][h] for h in ("K10", "K10 explicit")}
    kernels[-3]["k11_tier2_train_step_ms"] = late["train_step_ms"]
    wide_ms = {"mlp_solve": wide["k2_highest"][0],
               "mlp_adjoint_solve": wide["K3_wide"],
               "fixed_solve": wide["k8_highest"][0],
               "fixed_adjoint_solve": wide["K9_wide"],
               "mlp_solve_perlane": wide["K5_wide"],
               "mlp_perlane_adjoint_solve": wide["K6_wide"]}
    for k in kernels:
        if k["name"] in wide_ms:
            k["wide_ms"] = wide_ms[k["name"]]
    kernels[1]["wide_batch_route_ms"] = wide["k2_highest_batch"]
    # K2's dense-output emission ([41]-[43]: the plan route, K14 in K2).
    kernels[1].update({
        "dense_ms": dense["ms"], "dense_no_emission_ms":
            dense["no_emission_ms"], "dense_plain_ms": dense["plain_ms"],
        "dense_bound_ms": dense["bound"][0],
        "dense_bound_by": dense["bound"][1],
        "dense_emission_bound_ms": dense["emission_bound_ms"],
        "dense_launches": dense["launches"],
        "dense_max_abs_err": dense["err"],
        "interpolated_step_ms": dense["interp_step_ms"],
        "resets_step_ms": dense["resets_step_ms"],
        "interpolated_b_nfe": dense["interp_b_nfe"],
        "interpolated_step_device_idle": dense["interp_idle"],
        "battery_interpolated": dense["battery"]})
    kernels[3]["wide_batch_route_ms"] = wide["k8_highest_batch"]
    # The coupled plans' one-block routes ([44]-[47]): K14's coupled mode in
    # K8, K10 and K11 and K15's in K9, a record each; `ms`, `plain_ms` and
    # `bound_ms` of the mean field's first method, the rest by case.
    sites = (("plan_rhs_coupled_k8", "K8", "meanfield rk4", "rk_fixed.cuh",
              "pallas_fixed.py:1167"),
             ("plan_rhs_coupled_k10", "K10", "meanfield fixed_adams",
              "rk_adams.cuh", "pallas_fixed.py:1143"),
             ("plan_rhs_coupled_k11", "K11", "meanfield", "rk_vcabm.cuh",
              "pallas_vcabm.py:449"),
             ("plan_aug_coupled_k9", "K9", "meanfield k8_k9",
              "rk_adjoint.cuh", "pallas_fixed.py:1019"))
    for name, host, key, src, ref in sites:
        c = coupled[host]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tfdiffeq_tpu_torch/csrc/{src}",
            "generated_by": "tfdiffeq_tpu_torch/ops/plan_codegen.py",
            "replaces": f"tfdiffeq_tpu/ops/{ref}",
            "launches": c["launches"], "max_abs_err": c["err"],
            "ms": c["ms"][key], "plain_ms": c["plain_ms"][key],
            "bound_ms": c["bound"][key][0], "bound_by": c["bound"][key][1],
            "library_ms": None, "blocks": 1,
            "threads": cpl.PLAN_BLOCK_THREADS, "ms_by_case": c["ms"],
            "plain_ms_by_case": c["plain_ms"],
            "bound_ms_by_case": {k: b[0] for k, b in c["bound"].items()},
            "generic_ms_by_case": c["generic_ms"],
            **({"train_step_ms_by_case": c["steps"]} if "steps" in c
               else {})})
    # The float64 tier ([48], [49]): K14 in K2 and K15 in K3 launched in
    # float64 from float32 callers, bounds with the products at 67 and the
    # rest at 34 TFLOP/s; on K2's and K3's records and on K14's and K15's.
    by_name = {k["name"]: k for k in kernels}
    sp = df["K3"]["spiral"]
    cases = dict(df["K2"], spiral_train_forward={
        "ms": sp["fwd_ms"], "plain_ms": sp["fwd"]["plain_ms"],
        "bound": sp["fwd_bound"], "kernel_err": sp["fwd"]["kernel_err"],
        "nfe": sp["fwd_nfe"]})
    f64_k2 = {case: {"ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                     "max_abs_err": c["kernel_err"], "nfe": c["nfe"],
                     **{k: c[k] for k in ("call_ms", "attempts", "err",
                                          "err_rel", "err_launch_f64")
                        if k in c}}
              for case, c in cases.items()}
    f64_k3 = {"ms": sp["ms"], "plain_ms": sp["plain_ms"],
              "bound_ms": sp["bound"][0], "bound_by": sp["bound"][1],
              "max_abs_err": sp["kernel_err"], "b_nfe": sp["b_nfe"],
              "train_step_ms": sp["step_ms"],
              "b32": df["K3"]["b32"]}
    for name in ("mlp_solve", "plan_rhs"):
        by_name[name]["float64_tier"] = {"launches": df["launches"]["K2"],
                                         "by_case": f64_k2}
    for name in ("mlp_adjoint_solve", "plan_aug"):
        by_name[name]["float64_tier"] = {"launches": df["launches"]["K3"],
                                         **f64_k3}
    # K4's last sites ([51]): K14's tile walk in K2 and K8 and K5's tile
    # engine, the MLP's and a plan's, a record each; the top-level numbers
    # the float32 full-size launch of the public entry point, its plain
    # version's time and largest difference from [50]'s hold.
    ts = tier_sites
    for name, keys, src, ref in (
            ("plan_tile_k2", ("K2",), "plan_rhs.cuh",
             "jaxpr_bridge.py:979"),
            ("plan_tile_k8", ("K8 mixed", "K8 bf16"), "plan_rhs.cuh",
             "jaxpr_bridge.py:979"),
            ("perlane_tile_mlp", ("K5 MLP",), "rk_perlane.cuh",
             "pallas_kernels.py:929"),
            ("plan_tile_k5", ("K5 plan",), "rk_perlane.cuh",
             "pallas_kernels.py:929")):
        k0 = keys[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tfdiffeq_tpu_torch/csrc/{src}",
            "replaces": f"tfdiffeq_tpu/ops/{ref}",
            "launches": sum(ts["launches"][k] for k in keys),
            "max_abs_err": max(ts["err"][k] for k in keys),
            "ms": ts["ms"][k0], "plain_ms": ts["plain_ms"][k0],
            "bound_ms": ts["bound"][k0][0], "bound_by": ts["bound"][k0][1],
            "library_ms": None,
            "by_tier": {k: {"ms": ts["ms"][k],
                            "plain_ms": ts["plain_ms"][k],
                            "bound_ms": ts["bound"][k][0],
                            "max_abs_err": ts["err"][k],
                            "stats": [int(x) if not hasattr(x, "sum")
                                      else int(x.sum())
                                      for x in ts["stats"][k]]}
                        for k in keys},
            "mlp_route_ms": ts["mlp_route_ms"].get(
                k0, ts["mlp_route_ms"]["K2"])})
    by_name["dot_tiers"]["float64_holds_max_abs_err"] = {
        k: e for k, e in ts["err"].items() if k.endswith("f64")}
    by_name["dot_tiers"]["battery_accepted_range"] = ts["battery_accepted"]
    print(f"[total] chip_smoke.py took {time.perf_counter() - run_t0:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
