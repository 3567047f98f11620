"""K15's plain version: the reverse-mode walk of a plan, the right-hand
side of the plan adjoint sweeps.

Counterpart of `tfdiffeq_tpu/ops/plan_adjoint.py:154`
(`make_plan_aug_eval`). For the augmented adjoint system of a plan's
dynamics f(t, y),

    dy/dsigma = -sign f,   da_y/dsigma = sign (df/dy)^T a_y,
    da_c/dsigma = sign (df/dc)^T a_y (per constant c),
    da_t/dsigma = sign a_y . df/dt,

`aug_terms` re-walks the plan forward (`plan_bridge.eval_plan`) and then
writes every cotangent in reverse instruction order, on the feature-major
[rows, B] blocks, with the reference's rules (plan_adjoint.py:173-441): the
unary gradients (erf's exact derivative), balanced ties for max and min,
ipow, clamp, select, the transposes of concat, slice and rev, the reduce
broadcast, the `bsum` transpose (the cotangent's batch sum broadcast back)
and the `bmax` tie split, and each dot's dW and dh.

The order of every operation is the order of the CUDA code that
`plan_codegen.aug_source` generates from the same plan (the first
contribution to a cotangent assigns it, later ones add in walk order; a
contribution to a one-row value folds its rows in order; a dot's dh sums
over its outputs in order), and every batch sum is taken in the order of
the kernel that hosts the walk, so each kernel is bitwise equal to its
plain version:

- the couplings' sums (forward and transposed) in the order of a block of
  ADJOINT_THREADS threads (`plan_bridge._batch_sums`, K3's `BlockMeet`);
- a constant's cotangent, per sample: a weight's element (o, i) sums
  c_s[o] h_s[i] over the dots s that read it, in walk order; a column or
  scalar constant its cotangent rows; a per-sample constant ('batch',
  'bvec') its own cotangent, which no batch sum touches. `eval_plan_aug`
  sums the shared ones over the batch in K3's lane order
  (`cuda_adjoint._lane_sums`); K6 and K9 sum them per sample first, at
  the end of their sweeps.

The reference's lane padding and pad-lane masks have no counterpart:
blocks are exactly B wide.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .cuda_adjoint import ADJOINT_THREADS, _lane_sums
from .plan_bridge import (NO_GRAD_BIN, ZERO_GRAD_UN, FusedPlan,
                          _batch_sums, _materialize, _row_fold, eval_plan)
from .plan_codegen import value_rows

Tensor = torch.Tensor


def _un_grad(name: str, x: Tensor, o: Tensor, lit) -> Tensor:
    """d out / d x of a unary op from (x, out), as the generated code
    computes it (plan_codegen._UN_GRAD)."""
    one = lit(1.0)
    if name == "neg":
        return -one
    if name == "exp":
        return o
    if name == "log":
        return one / x
    if name == "log1p":
        return one / (one + x)
    if name == "tanh":
        return one - o * o
    if name == "logistic":
        return o * (one - o)
    if name == "sin":
        return torch.cos(x)
    if name == "cos":
        return -torch.sin(x)
    if name == "sqrt":
        return lit(0.5) / o
    if name == "rsqrt":
        return (lit(-0.5) * o) / x
    if name == "abs":
        return torch.sign(x)
    if name == "copy":
        return one
    if name == "expm1":
        return o + one
    if name == "cosh":
        return lit(0.5) * (torch.exp(x) - torch.exp(-x))
    if name == "sinh":
        return lit(0.5) * (torch.exp(x) + torch.exp(-x))
    if name == "erf":
        return lit(1.1283791670955126) * torch.exp(-(x * x))
    if name == "erfc":
        return lit(-1.1283791670955126) * torch.exp(-(x * x))
    if name == "tan":
        return one + o * o
    if name == "asinh":
        return one / torch.sqrt(x * x + one)
    if name == "acosh":
        return one / torch.sqrt(x * x - one)
    if name == "atanh":
        return one / (one - x * x)
    raise AssertionError(f"no gradient rule for {name}")    # pragma: no cover


def aug_terms(plan: FusedPlan, cvals: Sequence[Tensor], t, y: Tensor,
              a_y: Tensor):
    """The plan's value and reverse walk at (t, y [D, B]) with the output
    cotangent a_y [out_rows, B]. t is 0-d, or a [1, B] row of per-sample
    times; cvals: `plan_bridge.pack_consts`' output.

    Returns (f [out_rows, B], v_y [D, B], xq [n_flat, B]: each shared
    constant's per-sample cotangent term in `plan_codegen.flat_consts`'
    order, xs [n_rows, B]: the per-sample constants' cotangents in the
    order of flat_consts' per-sample rows, v_t [1, B])."""
    dev, dtype = y.device, y.dtype
    B = y.shape[1]
    rows = value_rows(plan)
    env = eval_plan(plan, cvals, t, y, ADJOINT_THREADS)
    lits = {}

    def lit(v: float) -> Tensor:
        x = lits.get(v)
        if x is None:
            x = lits[v] = torch.tensor(v, dtype=dtype, device=dev)
        return x

    def getp(a):
        return lit(a[1]) if a[0] == "l" else env[a[1]]

    def full(v: Tensor, r: int) -> Tensor:
        return _materialize(v, r, B) if v.ndim == 0 or v.shape[1] != B \
            else v.expand(r, B)

    ct: List = [None] * plan.n_vals
    sites = {}                           # const index -> [(c, h), ...]

    def addct(a, contrib: Tensor) -> None:
        if a[0] == "l":
            return
        vid = a[1]
        if contrib.shape[0] != rows[vid]:
            contrib = _row_fold(contrib, torch.add)
        ct[vid] = contrib if ct[vid] is None else ct[vid] + contrib

    out = plan.out_id
    f = full(env[out], plan.out_rows)
    addct(("v", out), a_y)
    for ins in reversed(plan.instrs):
        op = ins[0]
        c = ct[ins[1]]
        if op == "litv" or c is None:
            continue
        R = rows[ins[1]]
        c = full(c, R)
        if op == "un":
            if ins[3] in ZERO_GRAD_UN:
                continue
            x = getp(ins[2])
            addct(ins[2], c * _un_grad(ins[3], x, env[ins[1]], lit))
        elif op == "bin":
            name = ins[4]
            if name in NO_GRAD_BIN:
                continue
            av, bv = getp(ins[2]), getp(ins[3])
            if name == "add":
                addct(ins[2], c)
                addct(ins[3], c)
            elif name == "sub":
                addct(ins[2], c)
                addct(ins[3], -c)
            elif name == "mul":
                addct(ins[2], full(c * bv, R))
                addct(ins[3], full(c * av, R))
            elif name == "div":
                addct(ins[2], full(c / bv, R))
                addct(ins[3], full(((-c) * av) / (bv * bv), R))
            elif name in ("max", "min"):
                # Balanced ties (0.5 each way), jax.lax's _balanced_eq.
                win = (av > bv) if name == "max" else (av < bv)
                w_a = torch.where(av == bv, lit(0.5),
                                  torch.where(win, lit(1.0), lit(0.0)))
                addct(ins[2], full(c * w_a, R))
                addct(ins[3], full(c * (lit(1.0) - w_a), R))
            elif name == "pow":
                o = env[ins[1]]
                addct(ins[2], full(((c * bv) * o) / av, R))
                addct(ins[3], full((c * o) * torch.log(av), R))
            else:                                  # pragma: no cover
                raise AssertionError(f"bin grad {name}")
        elif op == "ipow":
            n = ins[3]
            if n == 0:
                continue
            x = getp(ins[2])
            if n == 1:
                addct(ins[2], c)
            elif n >= 2:
                xp = x
                for _ in range(n - 2):
                    xp = xp * x
                addct(ins[2], full(c * (lit(float(n)) * xp), R))
            else:
                addct(ins[2], full(c * ((lit(float(n)) * env[ins[1]]) / x),
                                   R))
        elif op == "clamp":
            lov, xv, hiv = getp(ins[2]), getp(ins[3]), getp(ins[4])
            zero = lit(0.0)
            addct(ins[3], full(torch.where((xv >= lov) & (xv <= hiv), c,
                                           zero), R))
            addct(ins[2], full(torch.where(xv < lov, c, zero), R))
            addct(ins[4], full(torch.where(xv > hiv, c, zero), R))
        elif op == "select":
            pred = getp(ins[2]) != 0
            zero = lit(0.0)
            addct(ins[4], full(torch.where(pred, c, zero), R))
            addct(ins[3], full(torch.where(pred, zero, c), R))
        elif op == "cast":
            if not ins[3]:
                addct(ins[2], c)
        elif op in ("bcast", "reshape"):
            addct(ins[2], c)
        elif op == "concat":
            off = 0
            for a in ins[2]:
                r = 1 if a[0] == "l" else rows[a[1]]
                addct(a, c[off:off + r])
                off += r
        elif op == "slice":
            r = rows[ins[2][1]]
            r0, r1 = ins[3], ins[4]
            parts = [c.new_zeros((r0, B)), c, c.new_zeros((r - r1, B))]
            addct(ins[2], torch.cat([p for p in parts if p.shape[0]]))
        elif op == "rev":
            addct(ins[2], torch.flip(c, dims=(0,)))
        elif op == "reduce":
            addct(ins[2], c.expand(rows[ins[2][1]], B))
        elif op == "bsum":
            # The transpose of a batch sum: the cotangent's batch sum (in
            # the block's order), broadcast back over the samples.
            cc = _batch_sums(c, ADJOINT_THREADS)
            addct(ins[2], cc.expand(ins[3], B))
        elif op == "bmax":
            # A batch max / min routes the cotangent to the extremal
            # samples, split evenly over exact ties.
            r = ins[3]
            v = full(getp(ins[2]), r)
            tie = (v == env[ins[1]]).to(dtype)
            cc = _batch_sums(c, ADJOINT_THREADS)
            cnt = _batch_sums(tie, ADJOINT_THREADS)
            if ins[4]:
                cnt = _row_fold(cnt, torch.add)
            addct(ins[2], tie * (cc / cnt))
        elif op == "dot":
            _, _, a_id, cidx, din, dout, _mxu = ins
            wT = cvals[cidx]
            h = full(env[a_id], din)
            sites.setdefault(cidx, []).append((c, h))
            dh = wT[0][:, None] * c[0:1]
            for o in range(1, dout):
                dh = dh + wT[o][:, None] * c[o:o + 1]
            addct(("v", a_id), dh)
        else:                                      # pragma: no cover
            raise AssertionError(f"bad instr {op}")

    zeros = lambda r: torch.zeros((r, B), dtype=dtype, device=dev)
    v_y = ct[plan.y_id] if ct[plan.y_id] is not None else zeros(plan.dim)
    v_t = ct[plan.t_id] if ct[plan.t_id] is not None else zeros(1)
    xq, xs = [], []
    for cidx, lay in enumerate(plan.const_layouts):
        tag = lay[0]
        if tag == "wT":
            x = None
            for c, h in sites.get(cidx, ()):
                term = c[:, None, :] * h[None, :, :]
                x = term if x is None else x + term
            xq.append(x.reshape(-1, B) if x is not None
                      else zeros(lay[1] * lay[2]))
            continue
        if tag == "unused":
            continue
        r = lay[1] if tag in ("col", "batch") else 1
        cc = ct[plan.const_val_ids[cidx]]
        cc = zeros(r) if cc is None else full(cc, r)
        (xq if tag in ("col", "scalar") else xs).append(cc)
    xq = torch.cat(xq) if xq else zeros(0)
    xs = torch.cat(xs) if xs else zeros(0)
    return f, full(v_y, plan.dim), xq, xs, full(v_t, 1)


def split_consts(plan: FusedPlan, cvals: Sequence[Tensor], xq: Tensor,
                 xs: Tensor) -> list:
    """Shared quadratures xq [n_flat] (batch-summed) and per-sample ones
    xs [n_rows, B] back into one cotangent a packed constant, in
    `pack_consts`' shapes."""
    out, q, s = [], 0, 0
    for lay, cv in zip(plan.const_layouts, cvals):
        tag = lay[0]
        if tag == "unused":
            out.append(torch.zeros_like(cv))
            continue
        n = cv.numel() if tag in ("wT", "col", "scalar") else None
        if n is not None:
            out.append(xq[q:q + n].reshape(cv.shape))
            q += n
        else:
            r = cv.shape[0]
            out.append(xs[s:s + r].reshape(cv.shape))
            s += r
    return out


def eval_plan_aug(plan: FusedPlan, cvals: Sequence[Tensor], t, y: Tensor,
                  a_y: Tensor, parts: str = "all"):
    """The reference's aug_eval contract (plan_adjoint.py:154) at (t, y
    [D, B]) with a_y [out_rows, B]: (f, v_y = (df/dy)^T a_y, dconsts: one
    cotangent a packed constant in `pack_consts`' shapes, the shared ones
    summed over the batch in K3's lane order, v_t = a_y . df/dt per sample
    [1, B]). parts='dyn' returns (f, v_y), parts='quad' (dconsts, v_t)."""
    if parts not in ("all", "dyn", "quad"):
        raise ValueError(f"parts must be 'all', 'dyn' or 'quad', got "
                         f"{parts!r}")
    f, v_y, xq, xs, v_t = aug_terms(plan, cvals, t, y, a_y)
    if parts == "dyn":
        return f, v_y
    dconsts = split_consts(plan, cvals, _lane_sums(xq.t()), xs)
    if parts == "quad":
        return dconsts, v_t
    return f, v_y, dconsts, v_t
