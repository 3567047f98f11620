"""K3: the fused adjoint backward sweep for MLP neural ODEs — wrapper,
launch counter and plain PyTorch version.

Counterpart of `tfdiffeq_tpu/ops/pallas_adjoint.py` for the training path:
`mlp_adjoint_solve` runs the ENTIRE continuous-adjoint backward pass of
`fast.odeint_adjoint_mlp` as one launch of the CUDA kernel in
`csrc/adjoint_kernel.cu` (replacing `_make_adjoint_kernel`,
pallas_adjoint.py:430, with its RHS `_make_aug_eval` :107): the loop over
observation intervals in reverse with stored-state resets and cotangent
injections, every adaptive RK attempt on (y, a_y) in sigma = -tau, the MLP
forward and hand-written VJP in each stage, the parameter and a_t
quadratures, the error norm and the shared controller.

The wrapper takes the plain version (`mlp_adjoint_solve_plain`) only for
tensors on the CPU; a CUDA tensor launches the kernel or raises. The kernel
runs on a grid of `n_blocks` blocks, all resident together (`solve_blocks`
chooses it: one per SM, fewer for a batch smaller than the card), each
owning a contiguous range of the samples and of the parameters. The plain
version mirrors the kernel attempt for attempt, with one host
synchronisation per attempt, and takes every batch sum in the kernel's
fixed order for the same `n_blocks` (each block's lane sums over its own
samples, `_block_lane_sums`; its threads' error terms, `_block_owned_sums`,
and `_tree_sum`; the blocks' partials added in block order,
`_merge_blocks`), so the two take the same steps in float64; n_blocks = 1
is one block's order (`_lane_sums`).

The kernel takes the routes of `cuda_kernels._route`: narrow (the weights,
the parameter accumulator and the stage cotangents in shared memory) or wide
(layers up to MAX_WIDTH, all of those in global memory). The sweep is always
float32-accurate: the reference's dot-precision tiers reach the forward
solves only (`fast.odeint_adjoint_mlp`).

`rhs='cnf'` runs K7's adjoint (csrc/cnf_net.cuh `cnf_aug_eval_group`,
replacing `_make_cnf_aug_eval`, pallas_adjoint.py:240) in each stage
instead: the backward sweep of the augmented FFJORD system, with the
divergence's second-order VJP; `_cnf_aug_eval_plain` is its plain version.

Not ported: the TPU machinery of the reference (`pack` sublane packing,
`n_blocks` grid blocks, `stream_io`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .cuda_kernels import (ROUTE_WIDE, _ACT_CODES, _ACTIVATION_GRAD2,
                           _ACTIVATION_GRADS, _ACTIVATIONS, _block_index,
                           _block_owned_sums, _check_blocks,
                           _check_activations, _check_cnf, _check_float,
                           _check_mlp, _check_rhs,
                           _controller_factor, _device_kind, _dims_arg,
                           _dot_in_order, _gather, _merge_blocks,
                           _net_widths, _ptr, _route, _solve_setup, _stream,
                           _tableau_args, _tree_sum, _unpack, launch_layout,
                           solve_blocks)
from .tableaus import TABLEAUS_BY_NAME

Tensor = torch.Tensor

#: Threads of each K3 block (csrc/rk_adjoint.cuh kAdjThreads).
ADJOINT_THREADS = 512
#: Lanes of a batch sum: lane j adds samples j, j + 32, ... (one warp).
LANES = 32

#: K3 launches, and those with K7's adjoint (rhs='cnf') among them.
mlp_adjoint_solve_launches = 0
cnf_adjoint_launches = 0
#: The grouped walk that K3's last launch ran, as the launch reported it
#: (`cuda_kernels.launch_layout`); None before one.
last_adjoint_layout = None


def reset_launch_counts() -> None:
    global mlp_adjoint_solve_launches, cnf_adjoint_launches
    global last_adjoint_layout
    mlp_adjoint_solve_launches = 0
    cnf_adjoint_launches = 0
    last_adjoint_layout = None


def _lane_sums(x: Tensor) -> Tensor:
    """Sums of x [B, R] over the batch in one K3 block's order: lane j adds
    rows j, j + 32, j + 64, ... in turn from 0, then the 32 lane sums meet
    in `_tree_sum`'s tree. Returns [R]."""
    return _block_lane_sums(x, _block_index(x.shape[0], 1, LANES,
                                            x.device))[0]


def _block_lane_sums(x: Tensor, idx: Tensor) -> Tensor:
    """Each block's sums of x [B, R] over its samples in K3's lane order
    (`_lane_sums` on its rows; idx from `_block_index(B, n_blocks,
    LANES)`). Returns [n_blocks, R]."""
    xp = _gather(x, idx)                         # [n_blocks, K, LANES, R]
    acc = x.new_zeros(idx.shape[0], LANES, x.shape[1])
    for k in range(idx.shape[1]):
        acc = acc + xp[:, k]
    return _tree_sum(acc.transpose(1, 2))


def _dot_t_in_order(wT: Tensor, x: Tensor) -> Tensor:
    """W^T x for x [B, dout]: sum_o wT[o] x[:, o] over the outputs in
    order, [B, din]."""
    acc = None
    for o in range(wT.shape[0]):
        term = wT[o] * x[:, o:o + 1]
        acc = term if acc is None else acc + term
    return acc


def _aug_eval_plain(packed: Tensor, dims, activation: str,
                    final_activation: str, input_power: int,
                    time_input: bool):
    """pallas_adjoint.py:_make_aug_eval on [B, D], in the kernel's order:
    each pre-activation sums its inputs in order (the time column last),
    each input cotangent sums over the layer's outputs in order.

    Returns F(t, y, a_y) -> (f, v_y, per-sample parameter cotangents
    [B, n_w] in `pack_mlp_weights`' layout, v_t [B] or None); t is one time
    (0-d) or one a sample ([B])."""
    layers = _unpack(packed, dims)
    L = len(dims)
    acts = [activation] * (L - 1) + [final_activation]

    def aug(t, y, ay):
        B = y.shape[0]
        h = y
        for _ in range(input_power - 1):
            h = h * y
        if time_input:
            h = torch.cat([h, t.reshape(-1, 1).expand(B, 1)], dim=1)
        hs, zs = [], []
        for l, (wT, b) in enumerate(layers):
            hs.append(h)
            zs.append(_dot_in_order(wT, h) + b)
            h = _ACTIVATIONS[acts[l]](zs[-1])
        f = h
        dz = ay * _ACTIVATION_GRADS[acts[-1]](zs[-1], f)
        dzs = [None] * L
        for l in range(L - 1, -1, -1):
            dzs[l] = dz
            dh = _dot_t_in_order(layers[l][0], dz)
            dz = (dh * _ACTIVATION_GRADS[acts[l - 1]](zs[l - 1], hs[l])
                  if l > 0 else dh)
        D = y.shape[1]
        v_t = dz[:, D] if time_input else None
        v_y = dz[:, :D]
        if input_power > 1:
            yp = y
            for _ in range(input_power - 2):
                yp = yp * y
            v_y = v_y * (float(input_power) * yp)
        parts = []
        for l in range(L):
            parts.append((dzs[l][:, :, None] * hs[l][:, None, :])
                         .reshape(B, -1))                     # W^T layout
            parts.append(dzs[l])
        return f, v_y, torch.cat(parts, dim=1), v_t

    return aug


def _cnf_aug_eval_plain(packed: Tensor, dims, activation: str):
    """Plain version of K7's adjoint (pallas_adjoint.py:_make_cnf_aug_eval)
    on [B, D + 1], in the kernel's order (csrc/cnf_net.cuh
    cnf_aug_eval_group).
    For y = [z; logp] and a = [a_z; a_l]:

    - the forward keeps each layer's input, act'(z) and act''(z); D
      forward-mode passes keep each pass's v_l (the product) and u_l
      (act'(z) v_l) and give F = [f; -div];
    - part A, the f-VJP with a_z: dzA_l, and v_z_A, v_t_A;
    - part B, the divergence's VJP with a_l: pass i0 walks back from vb =
      a_l on row i0 of the last layer, vb_l = act'(z_l) ub_l on the hidden
      layers, gathering zbar_l += act''(z_l) v_l ub_l; then zbar is
      injected through the primal backward as delta_l, giving v_z_B and
      v_t_B.

    v_y = [v_z_A - v_z_B, 0] and v_t = v_t_A - v_t_B. A sample's cotangent
    of weight (o, k) of layer l is x = dzA[o] h[k] - xB, where xB sums the
    direct terms vb_i0[o] u_i0,l-1[k] in i0 order (on layer 0 vb_k[o] for a
    state column k, nothing for the time column), plus delta[o] h[k] on the
    hidden layers; a bias takes dzA[o] - delta[o] (dzA[o] on the last
    layer). The reference sums each product over the batch first; this
    order differs from it by roundoff only, and the kernel repeats it.

    Returns F(t, y, a) -> (F, v_y [B, D + 1], per-sample parameter
    cotangents [B, n_w] in `pack_mlp_weights`' layout, v_t [B])."""
    layers = _unpack(packed, dims)
    L, D = len(dims), dims[-1][1]
    act, actg = _ACTIVATIONS[activation], _ACTIVATION_GRADS[activation]
    actg2 = _ACTIVATION_GRAD2[activation]

    def aug(t, y, ay):
        B = y.shape[0]
        a_z, a_l = ay[:, :D], ay[:, D]
        h = torch.cat([y[:, :D], t.reshape(-1, 1).expand(B, 1)], dim=1)
        hs, gs, g2s = [h], [], []
        for l, (wT, b) in enumerate(layers):
            zp = _dot_in_order(wT, h) + b
            if l < L - 1:
                a = act(zp)
                gs.append(actg(zp, a))
                g2s.append(actg2(zp, a, gs[-1]))
                h = a
            else:
                h = zp
            hs.append(h)
        # The divergence: D forward-mode passes.
        us, vs, div = [], [], None
        for i0 in range(D):
            u, u_l, v_l = None, [], []
            for l in range(L):
                v = (layers[0][0][:, i0].expand(B, -1) if l == 0
                     else _dot_in_order(layers[l][0], u))
                u = gs[l] * v if l < L - 1 else v
                u_l.append(u)
                v_l.append(v)
            us.append(u_l)
            vs.append(v_l)
            div = u[:, i0] if div is None else div + u[:, i0]
        F = torch.cat([h, -div[:, None]], dim=1)
        # Part A: the f-VJP with a_z (the last layer is linear).
        dzA, dz = [None] * L, a_z
        for l in range(L - 1, -1, -1):
            dzA[l] = dz
            dh = _dot_t_in_order(layers[l][0], dz)
            if l > 0:
                dz = gs[l - 1] * dh
        v_z_A, v_t_A = dh[:, :D], dh[:, D]
        # Part B: the divergence's VJP with a_l, pass by pass.
        rows = torch.arange(D, device=y.device)
        vbs, zbar = [[None] * L for _ in range(D)], [None] * L
        for i0 in range(D):
            ub = None
            for l in range(L - 1, -1, -1):
                if l == L - 1:
                    vb = torch.where(rows == i0, a_l[:, None],
                                     torch.zeros_like(a_z))
                else:
                    vb = gs[l] * ub
                    zb = g2s[l] * vs[i0][l] * ub
                    zbar[l] = zb if zbar[l] is None else zbar[l] + zb
                vbs[i0][l] = vb
                if l > 0:
                    ub = _dot_t_in_order(layers[l][0], vb)
        # ... then zbar through the primal backward.
        deltas, delta = [None] * L, None
        v_z_B, v_t_B = torch.zeros_like(a_z), torch.zeros_like(a_l)
        for l in range(L - 2, -1, -1):
            delta = zbar[l] if delta is None else delta + zbar[l]
            deltas[l] = delta
            dh = _dot_t_in_order(layers[l][0], delta)
            if l > 0:
                delta = gs[l - 1] * dh
            else:
                v_z_B = v_z_B + dh[:, :D]
                v_t_B = v_t_B + dh[:, D]
        v_y = torch.cat([v_z_A - v_z_B, torch.zeros_like(a_l)[:, None]],
                        dim=1)
        parts = []
        for l, (wT, _) in enumerate(layers):
            dout, din = wT.shape
            A = dzA[l][:, :, None] * hs[l][:, None, :]
            if l == 0:
                xB = torch.zeros_like(A)
                for i0 in range(D):
                    xB[:, :, i0] = vbs[i0][0]
            else:
                xB = None
                for i0 in range(D):
                    term = vbs[i0][l][:, :, None] * us[i0][l - 1][:, None, :]
                    xB = term if xB is None else xB + term
            if l < L - 1:
                xB = xB + deltas[l][:, :, None] * hs[l][:, None, :]
            parts.append((A - xB).reshape(B, -1))
            parts.append(dzA[l] - deltas[l] if l < L - 1 else dzA[l])
        return F, v_y, torch.cat(parts, dim=1), v_t_A - v_t_B

    return aug


def _combine(dth: Tensor, ks, coeffs):
    """sum_j (dth * c_j) * k_j over the nonzero c_j, in stage order."""
    acc = None
    for c, k in zip(coeffs, ks):
        if c != 0.0:
            term = (dth * c) * k
            acc = term if acc is None else acc + term
    return acc


def _sq_scaled(e: Tensor, v0: Tensor, v1: Tensor, rtol, atol) -> Tensor:
    esc = e / (atol + rtol * torch.maximum(torch.abs(v0), torch.abs(v1)))
    return esc * esc


def mlp_adjoint_solve_plain(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                            tau: Tensor, dt0, rtol, atol, sign, *,
                            activation: str = "tanh",
                            final_activation: str = "identity",
                            input_power: int = 1, time_input: bool = False,
                            seminorm: bool = False, method: str = "dopri5",
                            safety: float = 0.9, ifactor: float = 10.0,
                            dfactor: float = 0.2,
                            max_steps: int = 2 ** 31 - 1, rhs: str = "mlp",
                            n_blocks: int = None
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K3: a host loop of attempts that mirrors
    `csrc/adjoint_kernel.cu` line for line, its sums in the order of a grid
    of `n_blocks` blocks (None: the kernel's grid for ys' device,
    `cuda_kernels.solve_blocks`; one block on the CPU). Same contract as
    `mlp_adjoint_solve`."""
    if _check_rhs(rhs):
        time_input = True
        aug = _cnf_aug_eval_plain(warrays, dims, activation)
    else:
        aug = _aug_eval_plain(warrays, dims, activation, final_activation,
                              input_power, time_input)
    ay0, aw, at, _, stats = adjoint_sweep_plain(
        lambda t, y, ay: aug(t, y, ay) + (None,), warrays.shape[0],
        time_input, 0, ys, g, tau, dt0, rtol, atol, sign,
        seminorm=seminorm, method=method, safety=safety, ifactor=ifactor,
        dfactor=dfactor, max_steps=max_steps, n_blocks=n_blocks)
    return ay0, aw, at, stats


def adjoint_sweep_plain(aug, n_w: int, time_input: bool, n_ps: int,
                        ys: Tensor, g: Tensor, tau: Tensor, dt0, rtol, atol,
                        sign, *, seminorm: bool = False,
                        method: str = "dopri5", safety: float = 0.9,
                        ifactor: float = 10.0, dfactor: float = 0.2,
                        max_steps: int = 2 ** 31 - 1, n_blocks: int = None):
    """K3's engine (csrc/rk_adjoint.cuh) in plain PyTorch, on a right-hand
    side `aug(t, y, a_y)` -> (f, v_y [B, D], xw [B, n_w]: each sample's
    cotangent term of every shared quadrature, v_t [B] or None, xs
    [B, n_ps] or None: the per-sample quadratures' terms). The shared
    quadratures are summed over the batch a stage in the order of a grid of
    `n_blocks` blocks: each block's lane sums over its own samples
    (`_block_lane_sums`), the partials then added in block order
    (`_merge_blocks`); so is the error norm, each block's share its
    samples' terms and then its parameters' (`_block_owned_sums`). The
    per-sample quadratures are integrated a sample each, and join the error
    norm after the sample's (y, a_y) (unless `seminorm`). n_blocks = 1 is
    the one-block order (`_lane_sums`); None the kernel's grid for ys'
    device (`solve_blocks`: one block on the CPU).

    Returns (ay0 [B, D], aw [n_w], at (0-d), aps [B, n_ps], stats)."""
    tab = TABLEAUS_BY_NAME[method]
    dev, dtype = ys.device, ys.dtype
    T, B, D = ys.shape
    S = tab.stages
    _check_blocks(n_blocks)
    n_blocks = n_blocks or solve_blocks(B, dev)
    lanes_of = _block_index(B, n_blocks, LANES, dev)
    samples_of = _block_index(B, n_blocks, ADJOINT_THREADS, dev)
    params_of = _block_index(n_w, n_blocks, ADJOINT_THREADS, dev)
    tau_h, dt_min, dt0, _ = _solve_setup(tau, dt0, dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    rtol, atol, sf = on(rtol), on(atol), on(sign)
    sigma = on(-tau_h)
    n_el = (2.0 * D * B if seminorm
            else 2.0 * D * B + n_w + int(time_input) + float(n_ps) * B)
    denom = torch.tensor(n_el, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    ay = torch.zeros((B, D), dtype=dtype, device=dev)
    aw = torch.zeros(n_w, dtype=dtype, device=dev)
    aps = torch.zeros((B, n_ps), dtype=dtype, device=dev)
    at = zero
    dt, dt_min = on(dt0), on(dt_min)
    nfe = nacc = nrej = status = 0
    for i in range(T - 1, 0, -1):
        y = ys[i]
        ay = ay + g[i]
        cy = torch.zeros_like(y)
        cay = torch.zeros_like(y)
        s, s_end = sigma[i], sigma[i - 1]
        s_h, s_end_h = -float(tau_h[i]), -float(tau_h[i - 1])
        while s_h < s_end_h and status == 0:
            rem = s_end - s
            s1 = torch.where(dt >= rem, s_end, s + torch.minimum(dt, rem))
            dth = s1 - s
            ky, kay, kw, kps = [], [], [], []
            for st in range(S):
                yi, ayi = y, ay
                if st > 0:
                    for aij, kyj, kayj in zip(tab.a[st - 1], ky, kay):
                        if aij != 0.0:
                            yi = yi + (dth * aij) * kyj
                            ayi = ayi + (dth * aij) * kayj
                f, v_y, xw, v_t, xs = aug((-sf) * (s + tab.c[st] * dth), yi,
                                          ayi)
                ky.append((-sf) * f)
                kay.append(sf * v_y)
                if time_input:
                    xw = torch.cat([xw, v_t[:, None]], dim=1)
                kw.append(_block_lane_sums(xw, lanes_of))
                if n_ps:
                    kps.append(sf * xs)
            # The grid meets: each stage's partials added in block order.
            kw = list(sf * _merge_blocks(torch.stack(kw, dim=1)))
            dy = _combine(dth, ky, tab.b_sol)
            day = _combine(dth, kay, tab.b_sol)
            y1, ay1 = y + dy, ay + day
            sq = [_sq_scaled(_combine(dth, ky, tab.b_err), y, y1, rtol,
                             atol),
                  _sq_scaled(_combine(dth, kay, tab.b_err), ay, ay1,
                             rtol, atol)]
            dps = None
            if n_ps:
                dps = _combine(dth, kps, tab.b_sol)
                if not seminorm:
                    sq.append(_sq_scaled(_combine(dth, kps, tab.b_err), aps,
                                         aps + dps, rtol, atol))
            ss = _block_owned_sums(torch.cat(sq, dim=1), samples_of)
            dw = _combine(dth, [k[:n_w] for k in kw], tab.b_sol)
            if not seminorm:
                ew = _combine(dth, [k[:n_w] for k in kw], tab.b_err)
                ss = _block_owned_sums(_sq_scaled(ew, aw, aw + dw, rtol,
                                                  atol)[:, None],
                                       params_of, ss)
            # The grid meets again: the blocks' shares in block order.
            total = _merge_blocks(_tree_sum(ss))
            d_at = zero
            if time_input:
                d_at = _combine(dth, [k[n_w] for k in kw], tab.b_sol)
                if not seminorm:
                    e_at = _combine(dth, [k[n_w] for k in kw],
                                    tab.b_err)
                    total = total + _sq_scaled(e_at, at, at + d_at, rtol,
                                               atol)
            ratio = torch.sqrt(total / denom)
            fin = (torch.isfinite(total) & torch.all(torch.isfinite(y1))
                   & torch.all(torch.isfinite(ay1)))
            # The attempt's one synchronisation.
            acc_h, fin_h, s1_h = torch.stack([
                ((ratio <= 1.0) & fin).to(torch.float64),
                fin.to(torch.float64), s1.to(torch.float64)]).tolist()
            accept, finite = bool(acc_h), bool(fin_h)
            fac = _controller_factor(ratio, finite, accept, safety, ifactor,
                                     dfactor, tab.order)
            dt_next = dth * fac
            if accept:
                adj = dy - cy
                y_new = y + adj
                cy = (y_new - y) - adj
                y = y_new
                adj = day - cay
                ay_new = ay + adj
                cay = (ay_new - ay) - adj
                ay = ay_new
                aw = aw + dw
                if n_ps:
                    aps = aps + dps
                at = at + d_at
                s, s_h = s1, s1_h
            n_att = nacc + nrej + 1
            if status == 0 and not accept and bool(dt_next < dt_min):
                status = 2
            if status == 0 and n_att >= max_steps and s1_h < s_end_h:
                status = 1
            dt = dt_next
            nfe += S
            nacc += int(accept)
            nrej += int(not accept)
    stats = torch.tensor([nfe, nacc, nrej, status], dtype=torch.int32,
                         device=dev)
    return ay + g[0], aw, at, aps, stats


def cnf_aug_row_values(dims) -> int:
    """csrc/lane_group.h cnf_aug_row_values: a sample's values of K7's
    rows in K3 (csrc/cnf_net.cuh CnfRows; CnfRowsAt lays them out
    row-major, each row's samples contiguous): the layers' inputs, part
    A's cotangents and the deltas of the layers' outputs, the passes' u and
    vb, v_t."""
    n_h = sum(din for din, _ in dims)
    n_z = sum(dout for _, dout in dims)
    return n_h + (2 + 2 * dims[-1][1]) * n_z + 1


def cnf_aug_slot_values(dims) -> int:
    """csrc/lane_group.h cnf_aug_slot_values: K7's slot in K3 (the stage
    state and two layer vectors, act' and act'' of the hidden outputs, the
    passes' products, zbar, part A's input cotangent, the trace terms)."""
    gw, n_hid, D = _net_widths(dims)
    return 4 * gw + (3 + D) * n_hid + 2 * D + 1


def _work_size(dims, S: int, B: int, D: int, cnf: bool = False) -> int:
    """csrc/adjoint_kernel.cu adjoint_work_size: state, compensation and
    increments of (y, a_y), S stage derivatives of each, and the per-stage
    reduction rows (layer inputs, pre-activations, their cotangents, v_t;
    for rhs='cnf' `cnf_aug_row_values` a sample)."""
    n_h = sum(din for din, _ in dims)
    n_z = sum(dout for _, dout in dims)
    rows = cnf_aug_row_values(dims) if cnf else 1 + n_h + 2 * n_z
    return (6 + 2 * S) * B * D + rows * B


def _shared_values(dims, S: int, time_input: bool, cnf: bool = False
                   ) -> int:
    """Shared memory K3's narrow route needs, in values: the weights (K7's
    flow twice, row-major and transposed), the parameter accumulator and
    its increment, every stage's cotangents, the block-sum scratch and one
    slot, the MLP walk's four vectors or K7's `cnf_aug_slot_values`
    (csrc/adjoint_kernel.cu launch_adjoint_route: the launch adds as many
    slots as the rest of MAX_WEIGHT_BYTES holds)."""
    n_w = sum(din * dout + dout for din, dout in dims)
    slot = cnf_aug_slot_values(dims) if cnf else 4 * _net_widths(dims)[0]
    return ((3 + S + int(cnf)) * n_w + S * int(time_input)
            + ADJOINT_THREADS + slot)


def _wide_work_size(n_w: int, S: int, time_input: bool) -> int:
    """csrc/adjoint_kernel.cu adjoint_pwork_size: the wide route's parameter
    accumulator, its increment and the stage cotangents."""
    return 2 * n_w + S * (n_w + int(time_input))


def _grid_work(S: int, n_blocks: int, n_red: int, dtype, device) -> Tensor:
    """K3's grid workspace (csrc/rk_adjoint.cuh rk_adjoint_grid_bytes): the
    meetings' counter, the stage partials and the error shares."""
    item = torch.empty((), dtype=dtype).element_size()
    n = 16 + (S * n_blocks * n_red + 2 * n_blocks) * item
    return torch.empty(n, dtype=torch.uint8, device=device)


def mlp_adjoint_solve(warrays: Tensor, dims, ys: Tensor, g: Tensor,
                      tau: Tensor, dt0, rtol, atol, sign, *,
                      activation: str = "tanh",
                      final_activation: str = "identity",
                      input_power: int = 1, time_input: bool = False,
                      seminorm: bool = False, method: str = "dopri5",
                      safety: float = 0.9, ifactor: float = 10.0,
                      dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1,
                      rhs: str = "mlp", n_blocks: int = None
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fused adjoint backward sweep of an MLP neural ODE, one launch.

    warrays/dims: from `pack_mlp_weights`. ys, g: [T, B, D] forward
    trajectory and output cotangents at the observation times tau ([T],
    increasing canonical times; sign as in `mlp_solve`). dt0: first
    backward step (in sigma = -tau), clamped to the span-scaled minimum.
    seminorm: leave the parameter and time quadratures out of the step
    control. time_input: the first layer's last input is t, and the sweep
    also integrates the a_t quadrature. `method`: one of the five adaptive
    tableaus; every attempt evaluates all its stages.

    Returns (ay0 [B, D] = dL/dy0, aw [n_w] = dL/dweights in
    `pack_mlp_weights`' layout (W^T then b per layer), at (0-d, the
    integrated a_t quadrature; 0 when autonomous), stats [4] int32: nfe,
    accepted, rejected, status (0 OK, 1 MAX_STEPS_REACHED, 2 DT_UNDERFLOW)).

    rhs='cnf' (K7's adjoint in K3, pallas_adjoint.py:1088-1131): the sweep
    of the augmented FFJORD system. ys and g are [T, B, D + 1] over the
    state [z; logp], dims the concat-t flow (D + 1 inputs, time last; D
    outputs); time_input is forced on (the a_t quadrature applies), and
    final_activation and input_power do not apply. The error norm counts
    2 (D + 1) B + n_w + 1 values, 2 (D + 1) B with the seminorm.

    n_blocks: the kernel's grid (None: `solve_blocks(B, device)`); every
    block is resident at once, or the launch raises. The sums' order, and
    so the float32 bits, depend on it; the plain version takes the same
    default (on the CPU, one block).
    """
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    _check_activations(activation, final_activation)
    if ys.ndim != 3 or g.shape != ys.shape:
        raise ValueError(f"ys and g must both be [T, B, D], got "
                         f"{tuple(ys.shape)} and {tuple(g.shape)}")
    cnf = _check_rhs(rhs)
    if cnf:
        _check_cnf("mlp_adjoint_solve", dims, ys.shape[2])
        time_input, final_activation, input_power = True, "identity", 1
    kw = dict(activation=activation, final_activation=final_activation,
              input_power=input_power, time_input=time_input,
              seminorm=seminorm, method=method, safety=safety,
              ifactor=ifactor, dfactor=dfactor, max_steps=max_steps,
              rhs=rhs)
    _check_blocks(n_blocks)
    if _device_kind(ys, g, warrays) == "cpu":
        return mlp_adjoint_solve_plain(warrays, dims, ys, g, tau, dt0, rtol,
                                       atol, sign, n_blocks=n_blocks, **kw)

    global mlp_adjoint_solve_launches, cnf_adjoint_launches
    global last_adjoint_layout
    dtype = ys.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_adjoint_solve takes float32 or float64, got "
                        f"{dtype}")
    T, B, D = ys.shape
    n_w = _check_mlp("mlp_adjoint_solve", warrays, dims, D - cnf,
                     time_input)
    S = TABLEAUS_BY_NAME[method].stages
    route = _route("mlp_adjoint_solve", dims,
                   _shared_values(dims, S, time_input, cnf),
                   ys.element_size())
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    for name, x in (("ys", ys), ("g", g), ("warrays", warrays)):
        _check_float(name, x, dtype)

    tau_h, dt_min, dt0, _ = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(ys.device)
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    c, a, b_sol, b_err = _tableau_args(tab)
    ay0 = torch.empty((B, D), dtype=dtype, device=ys.device)
    aw = torch.empty(n_w, dtype=dtype, device=ys.device)
    at = torch.empty((), dtype=dtype, device=ys.device)
    stats = torch.empty(4, dtype=torch.int32, device=ys.device)
    n_work = _work_size(dims, S, B, D, cnf)
    work = torch.empty(n_work, dtype=dtype, device=ys.device)
    n_pwork = (_wide_work_size(n_w, S, time_input) if route == ROUTE_WIDE
               else 0)
    pwork = torch.empty(n_pwork, dtype=dtype, device=ys.device)
    nb = n_blocks or solve_blocks(B, ys.device)
    gwork = _grid_work(S, nb, n_w + int(time_input), dtype, ys.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_adjoint_f32 if dtype == torch.float32
          else lib.tfd_mlp_adjoint_f64)
    reported = (ctypes.c_int * 4)()
    with torch.cuda.device(ys.device):
        err = fn(_ptr(tau_d), _ptr(ys), _ptr(g), _ptr(warrays), _ptr(ay0),
                 _ptr(aw), _ptr(at), _ptr(stats), _ptr(work), n_work, T, B,
                 D, ADJOINT_THREADS, float(dt0), float(rtol), float(atol),
                 float(dt_min), float(sign), float(safety), float(ifactor),
                 float(dfactor), int(min(max_steps, 2 ** 31 - 1)),
                 int(seminorm), len(dims), _dims_arg(dims),
                 _ACT_CODES[activation], _ACT_CODES[final_activation],
                 int(input_power), int(time_input), S, tab.order, c, a,
                 b_sol, b_err, route, _ptr(pwork), n_pwork, int(cnf),
                 _ptr(gwork), gwork.numel(), nb, reported,
                 _stream(ys.device))
    _build.check(err, "mlp_adjoint_solve launch")
    last_adjoint_layout = launch_layout(nb, reported, rows=True)
    mlp_adjoint_solve_launches += 1
    cnf_adjoint_launches += cnf
    return ay0, aw, at, stats
