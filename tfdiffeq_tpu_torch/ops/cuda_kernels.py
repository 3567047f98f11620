"""The fused tier's hand-written CUDA kernels: wrappers, launch counters
and plain PyTorch versions.

Counterpart of `tfdiffeq_tpu/ops/pallas_kernels.py` for the two kernels of
the main path (sources in `tfdiffeq_tpu_torch/csrc/`, built by `_build.py`):

- K1 `dopri5_mlp_step` (csrc/step_kernel.cu) replaces `_make_step_kernel`
  (pallas_kernels.py:614): one dopri5 step of the tanh-MLP neural ODE.
- K2 `mlp_solve` (csrc/solve_kernel.cu) replaces `_make_solve_kernel`
  (pallas_kernels.py:726): a whole adaptive RK solve of a general MLP
  neural ODE in one launch.
- K7's forward (csrc/cnf_net.cuh `cnf_eval_group`), inside K2 with
  `mlp_solve(rhs='cnf')`, replaces `_make_cnf_net` (pallas_kernels.py:442):
  the CNF right-hand side [f; -div f] with the exact divergence;
  `_cnf_net_plain` is its plain version.
- K4, the dot-precision tiers (csrc/dot_tiers.cuh), replaces `_mixed_dot`
  and the tiers of `_make_net` (pallas_kernels.py:361-439) inside K2, K8
  and K5 (its tile engine), and at a plan's tiered dots in the same three
  (`ops/cuda_plan.py`): `dot_tier_plain` is its plain version,
  `layer_tiers` the reference's per-layer choice (`_layer_uses_mxu`), and
  `tier_net`
  (csrc/tier_net_kernel.cu) one batch-wide evaluation with K4 alone.

The MLP kernels (K2, K3, K5, K6, K8, K9) take one of three routes
(`_route`): narrow (every layer at most NARROW_WIDTH wide and the weights in
shared memory, the main path), wide (layers up to MAX_WIDTH, the weights
read from global memory) and, for K2, K8 and K5 with a reduced tier,
batch (a stage evaluated batch-wide, layer by layer, the tier layers on
the tensor cores in float32; K5's on its tile engine).

Each wrapper takes the kernel's plain PyTorch version (`*_plain`, beside it
here) only for tensors on the CPU, where there is no kernel; a CUDA tensor
launches the kernel or raises, never falls back. The plain versions follow
the JAX kernels operation for operation, on the batch-major [B, D] layout
of the public functions: the TPU kernels' feature-major [D, B] layout and
their sublane packing, VMEM budgets, grid blocks (a controller a slice) and
streamed output are TPU machinery with no counterpart here.

K2 runs on a grid of `n_blocks` blocks, all resident together
(`solve_blocks`: one per SM, fewer for a small batch), each owning a
contiguous range of the samples, under ONE step controller: the blocks
meet once an attempt for the error sum, which they add in block order. Its
plain version takes that sum in the same order for the same n_blocks
(`_grid_sum`), one block on the CPU, so the two take the same steps.

`dopri5_mlp_step_launches` and `mlp_solve_launches` count kernel launches
(never plain-version calls), `cnf_solve_launches` the K2 launches with K7's
forward among them; `dot_tier_launches` counts the solves that ran K4's
tier layers (K2, K8 and K5, on the MLP routes and a plan's tile route),
and `tier_net_launches` the calls of K4
alone (`tier_net`); `reset_launch_counts()` zeroes them. A solve on the
batch route is two launches, the bf16 weight pack and the solve, and
counts one.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build
from .rk import interp_fit_cubic_hermite, interp_fit_quartic
from .tableaus import DOPRI5, TABLEAUS_BY_NAME, ButcherTableau

Tensor = torch.Tensor

#: Widest layer (state, state + time column, hidden) of the MLP kernels
#: and deepest MLP (csrc/mlp_rk.cuh kMaxWidth, kMaxLayers).
MAX_WIDTH = 512
MAX_LAYERS = 8
#: Widest layer of the narrow route (csrc/mlp_rk.cuh kNarrowWidth).
NARROW_WIDTH = 128
#: Routes of the MLP kernels (csrc/mlp_rk.cuh Route).
ROUTE_NARROW, ROUTE_WIDE, ROUTE_BATCH = 0, 1, 2
#: Widest state of K1 (csrc/step_kernel.cu kStepMaxD).
STEP_MAX_D = 16
#: Threads of a K1 block and most samples a block (csrc/lane_group.h
#: kStepBlock, kStepSamples); each block writes one partial error sum.
STEP_BLOCK = 512
STEP_SAMPLES = 32
#: Threads of each K2 block (at most csrc/rk_solve.cuh kSolveThreads).
SOLVE_THREADS = 512
#: Samples a unit of K2's batch-route grid: K4's tile rows (a block owns
#: whole tiles; csrc/solve_kernel.cu MlpSolveRhs::kUnit).
TILE_ROWS = 16
#: Shared memory a kernel may give the packed weights (the card has 227 KB
#: per block; 4 KB stay for the reduction and the tableau). An MLP kernel
#: whose narrow-route share does not fit takes the wide route.
MAX_WEIGHT_BYTES = 220 * 1024

dopri5_mlp_step_launches = 0
mlp_solve_launches = 0
dot_tier_launches = 0
tier_net_launches = 0
cnf_solve_launches = 0
#: The grouped walk that K2's last launch ran, as the launch reported it
#: (`launch_layout`); None before one.
last_solve_layout = None


def reset_launch_counts() -> None:
    global dopri5_mlp_step_launches, mlp_solve_launches, dot_tier_launches
    global tier_net_launches, cnf_solve_launches, last_solve_layout
    dopri5_mlp_step_launches = 0
    mlp_solve_launches = 0
    dot_tier_launches = 0
    tier_net_launches = 0
    cnf_solve_launches = 0
    last_solve_layout = None


def launch_layout(n_blocks: int, reported, rows: bool = False) -> dict:
    """The grouped walk of a K2 or K3 launch from the values the launch
    wrote (csrc/solve_kernel.cu launch_route, csrc/adjoint_kernel.cu
    launch_adjoint_route): blocks, samples a round of a block (`slots`),
    threads a sample and a slot's values, zeros on K2's batch route, which
    walks no sample with a group; for K3 (`rows`) also whether K7's rows
    sit in the block's shared memory."""
    lay = {"blocks": n_blocks, "slots": reported[0],
           "threads_a_sample": reported[1], "slot_values": reported[2]}
    if rows:
        lay["rows_in_shared_memory"] = bool(reported[3])
    return lay


def _elu(x: Tensor) -> Tensor:
    return torch.where(x > 0.0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _softplus(x: Tensor) -> Tensor:
    return (torch.clamp(x, min=0.0)
            + torch.log1p(torch.exp(-torch.abs(x))))


def _silu(x: Tensor) -> Tensor:
    return x / (1.0 + torch.exp(-x))


#: pallas_kernels.py:_ACTIVATIONS, the same formulas in PyTorch.
_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": lambda x: torch.clamp(x, min=0.0),
    "elu": _elu,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "softplus": _softplus,
    "silu": _silu,
    "swish": _silu,
}

def _sigmoid_of(z: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(-z))


def _silu_grad(z: Tensor, a: Tensor) -> Tensor:
    s = _sigmoid_of(z)
    return s * (1.0 + z * (1.0 - s))


#: pallas_kernels.py:_ACTIVATION_GRADS: act'(z) from z and a = act(z), the
#: same formulas (csrc/mlp_rk.cuh act_grad).
_ACTIVATION_GRADS = {
    "identity": lambda z, a: torch.ones_like(z),
    "linear": lambda z, a: torch.ones_like(z),
    "tanh": lambda z, a: 1.0 - a * a,
    "relu": lambda z, a: torch.where(z > 0.0, torch.ones_like(z),
                                     torch.zeros_like(z)),
    "elu": lambda z, a: torch.where(z > 0.0, torch.ones_like(a), a + 1.0),
    "sigmoid": lambda z, a: a * (1.0 - a),
    "softplus": lambda z, a: _sigmoid_of(z),
    "silu": _silu_grad,
    "swish": _silu_grad,
}


def _silu_grad2(z: Tensor, a: Tensor, g: Tensor) -> Tensor:
    s = _sigmoid_of(z)
    return s * (1.0 - s) * (2.0 + z * (1.0 - 2.0 * s))


#: pallas_kernels.py:_ACTIVATION_GRAD2: act''(z) from z, a = act(z) and
#: g = act'(z), the same formulas (csrc/mlp_rk.cuh act_grad2); the CNF
#: adjoint's divergence VJP needs them.
_ACTIVATION_GRAD2 = {
    "identity": lambda z, a, g: torch.zeros_like(z),
    "linear": lambda z, a, g: torch.zeros_like(z),
    "tanh": lambda z, a, g: -2.0 * a * g,
    "relu": lambda z, a, g: torch.zeros_like(z),
    "elu": lambda z, a, g: torch.where(z > 0.0, torch.zeros_like(a),
                                       a + 1.0),
    "sigmoid": lambda z, a, g: g * (1.0 - 2.0 * a),
    "softplus": lambda z, a, g: (lambda s: s * (1.0 - s))(_sigmoid_of(z)),
    "silu": _silu_grad2,
    "swish": _silu_grad2,
}

#: Activation name -> csrc/mlp_rk.cuh `Act` code.
_ACT_CODES = {"identity": 0, "linear": 0, "tanh": 1, "relu": 2, "elu": 3,
              "sigmoid": 4, "softplus": 5, "silu": 6, "swish": 6}


def _device_kind(*tensors: Tensor) -> str:
    dev = tensors[0].device
    for x in tensors[1:]:
        if x.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type


def _check_float(name: str, x: Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_activations(*names) -> None:
    for a in names:
        if a not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {a!r}; available: "
                             f"{sorted(_ACTIVATIONS)}")


def _increasing(x: Tensor) -> bool:
    """Whether the 1-D x increases strictly (trivially so below 2)."""
    return x.numel() < 2 or bool(torch.all(x[1:] > x[:-1]))


def _check_mlp(name: str, warrays: Tensor, dims, D: int,
               time_input: bool, tiers=None) -> int:
    """Raise on an MLP the kernels cannot take (depth, widths, a network
    that does not map the D-feature state to itself, a packed array of the
    wrong length, unknown tiers); returns the packed weight count."""
    widths = [w for dd in dims for w in dd]
    if tiers is not None and (len(tiers) != len(dims) or any(
            t not in _TIER_CODES for t in tiers)):
        raise ValueError(f"{name}: tiers {tiers} must name one of "
                         f"{sorted(_TIER_CODES)} for each of the "
                         f"{len(dims)} layers")
    if len(dims) > MAX_LAYERS:
        raise ValueError(f"{name} supports up to MAX_LAYERS={MAX_LAYERS} "
                         f"layers, got {len(dims)}")
    if max(widths) > MAX_WIDTH:
        raise ValueError(f"{name} supports layer widths up to "
                         f"MAX_WIDTH={MAX_WIDTH}, got {max(widths)}")
    if dims[0][0] != D + int(time_input) or dims[-1][1] != D:
        raise ValueError(f"MLP dims {dims} do not map a {D}-feature state "
                         f"(time_input={time_input}) to itself")
    n_w = sum(din * dout + dout for din, dout in dims)
    if tuple(warrays.shape) != (n_w,):
        raise ValueError(f"warrays has shape {tuple(warrays.shape)}, "
                         f"expected ({n_w},) for dims {dims}")
    return n_w


def _check_rhs(rhs: str) -> bool:
    """Whether `rhs` names the CNF right-hand side; raise on an unknown
    one."""
    if rhs not in ("mlp", "cnf"):
        raise ValueError(f"unknown rhs {rhs!r} (expected 'mlp' or 'cnf')")
    return rhs == "cnf"


def _check_cnf(name: str, dims, D_state: int) -> None:
    """Raise unless `dims` is a concat-t flow for the CNF state [z; logp]
    of D_state = D + 1 columns: D state features and the time in (time
    last), D outputs."""
    if dims[0][0] != D_state or dims[-1][1] != D_state - 1:
        raise ValueError(
            f"{name}(rhs='cnf'): the flow's dims {dims} must take the "
            f"{D_state - 1} features of z and the time ({D_state} inputs, "
            f"time last) and give {D_state - 1} outputs, for the "
            f"[B, {D_state}] state [z; logp]")


def _route(name: str, dims, net_values: int, itemsize: int, tiers=None,
           input_values: int = 0) -> int:
    """The route of an MLP kernel, from the network alone: batch when a
    layer has a reduced tier, narrow when every layer fits NARROW_WIDTH and
    the narrow route's shared memory for the network (`net_values` values
    of `itemsize` bytes: weights and fixed scratch) fits MAX_WEIGHT_BYTES,
    else wide. `input_values` (grid points, output times) sit in shared
    memory beside them on the narrow and wide routes; raise when they do
    not fit there, so that an input's length never changes the route. The
    batch route keeps them in global memory: K4's tiles take the shared
    memory there (at most 214016 bytes, at MAX_WIDTH)."""
    if tiers is not None and any(t != "highest" for t in tiers):
        route = ROUTE_BATCH
    elif (max(w for dd in dims for w in dd) <= NARROW_WIDTH
          and net_values * itemsize <= MAX_WEIGHT_BYTES):
        route = ROUTE_NARROW
    else:
        route = ROUTE_WIDE
    smem = 0 if route == ROUTE_BATCH else itemsize * (
        input_values + (net_values if route == ROUTE_NARROW else 0))
    if smem > MAX_WEIGHT_BYTES:
        raise ValueError(f"{name}: {input_values} grid points and output "
                         f"times need {smem} bytes of shared memory on its "
                         f"route, above the {MAX_WEIGHT_BYTES} the kernel "
                         "may use")
    return route


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _tier_work_bytes(dims, rows: int, itemsize: int) -> int:
    """csrc/dot_tiers.cuh batch_work_bytes: the bf16 weights
    ([pad16(dout)][pad16(din)] a layer, 256-byte aligned), then three
    [rows][ld] activation buffers."""
    n_w16 = sum(_pad16(o) * _pad16(i) for i, o in dims)
    ld = _pad16(max(w for dd in dims for w in dd))
    return -(-2 * n_w16 // 256) * 256 + 3 * rows * ld * itemsize


def _tiers_arg(tiers):
    """Per-layer tier names as the launch functions' int array (None when
    every layer is 'highest')."""
    if tiers is None or all(t == "highest" for t in tiers):
        return None
    return (ctypes.c_int * len(tiers))(*(_TIER_CODES[t] for t in tiers))


def _tableau_args(tab: ButcherTableau):
    """A tableau as the launch functions take it: c, a as a row-major
    [stages, stages] array, b_sol and b_err (zeros when the tableau has no
    error weights), each a ctypes double array."""
    S = tab.stages
    a = [0.0] * (S * S)
    for i, row in enumerate(tab.a, start=1):
        a[i * S:i * S + len(row)] = row
    dbl = lambda xs: (ctypes.c_double * len(xs))(*xs)
    return (dbl(tab.c), dbl(a), dbl(tab.b_sol),
            dbl(tab.b_err if tab.b_err else (0.0,) * S))


def _dims_arg(dims):
    """((din, dout), ...) as the launch functions' int array."""
    widths = [w for dd in dims for w in dd]
    return (ctypes.c_int * len(widths))(*widths)


def _ptr(x: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _tree_sum(v: Tensor) -> Tensor:
    """Sum the last axis (a power of two) in the kernels' fixed tree
    order (csrc/mlp_rk.cuh block_sum): red[i] += red[i + s] for s = n/2,
    n/4, ..., 1."""
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def _owned_sums(sq: Tensor, threads: int, acc: Tensor = None) -> Tensor:
    """Per-thread sums of sq [B, D] as the kernels take them: thread i
    owns samples i, i + threads, ... and adds their D values in order,
    from 0 (or from acc [threads]). Returns [threads]; missing samples add
    +0, which changes no bit."""
    B, D = sq.shape
    K = -(-B // threads)
    sq = torch.nn.functional.pad(sq, (0, 0, 0, K * threads - B))
    sq = sq.view(K, threads, D)
    if acc is None:
        acc = torch.zeros(threads, dtype=sq.dtype, device=sq.device)
    for k in range(K):
        for d in range(D):
            acc = acc + sq[k, :, d]
    return acc


# ---------------------------------------------------------------------------
# The grids of K2, K3 and K11: n_blocks blocks, block k owning a contiguous
# range of the items (samples, or K3's parameters), and the kernels' batch
# sums in their order: each block's own (its threads' in-order sums, then
# `_tree_sum`), the blocks' partials then added in block order.
# ---------------------------------------------------------------------------

def _block_bounds(n: int, n_blocks: int, unit: int = 1) -> list:
    """Ends of the kernel's ranges: block k owns items [e[k], e[k + 1]) with
    e[k] = min(n, unit (k U // n_blocks)), U = ceil(n / unit) units of
    `unit` items (samples and parameters alike; K2's batch route takes
    units of K4's 16-row tiles). unit = 1 gives e[k] = k n // n_blocks."""
    units = -(-n // unit)
    return [min(n, unit * (k * units // n_blocks))
            for k in range(n_blocks + 1)]


def _block_index(n: int, n_blocks: int, width: int, device,
                 unit: int = 1) -> Tensor:
    """[n_blocks, K, width] item indices: slot j of round m of block k holds
    item e[k] + j + width m, or n (a zero pad) past the block's range."""
    e = _block_bounds(n, n_blocks, unit)
    K = -(-max(e[k + 1] - e[k] for k in range(n_blocks)) // width)
    lo = torch.tensor(e[:-1]).view(-1, 1, 1)
    hi = torch.tensor(e[1:]).view(-1, 1, 1)
    idx = (lo + torch.arange(K).view(1, -1, 1) * width
           + torch.arange(width).view(1, 1, -1))
    return torch.where(idx < hi, idx, torch.full_like(idx, n)).to(device)


def _gather(x: Tensor, idx: Tensor) -> Tensor:
    """x [n, R] at idx, a zero row for the pad index n."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])[idx]


def _block_owned_sums(sq: Tensor, idx: Tensor, acc: Tensor = None
                      ) -> Tensor:
    """`_owned_sums` in every block: thread i of block k owns items
    e[k] + i, e[k] + i + threads, ... (idx from `_block_index(n, n_blocks,
    threads)`) and adds their values in order, from 0 or acc
    [n_blocks, threads]. Returns [n_blocks, threads]."""
    sp = _gather(sq, idx)                        # [n_blocks, K, threads, C]
    if acc is None:
        acc = sq.new_zeros(idx.shape[0], idx.shape[2])
    for k in range(idx.shape[1]):
        for d in range(sq.shape[1]):
            acc = acc + sp[:, k, :, d]
    return acc


def _merge_blocks(parts: Tensor) -> Tensor:
    """parts[0] + parts[1] + ... in block order (dim 0)."""
    acc = parts[0]
    for k in range(1, parts.shape[0]):
        acc = acc + parts[k]
    return acc


def _grid_sum(sq: Tensor, owned: Tensor) -> Tensor:
    """The sum of sq [B, C] in a grid's order (owned: `_block_index(B,
    n_blocks, threads)`): each block's `_block_owned_sums` and `_tree_sum`,
    then the blocks' shares in block order. At n_blocks = 1 it is
    `_tree_sum(_owned_sums(sq, threads))` to the bit. Returns 0-d.

    The shares are added one at a time in their dtype on the host (numpy's
    adds round as the card's do), one copy instead of a launch a share."""
    shares = _tree_sum(_block_owned_sums(sq, owned))
    if shares.shape[0] == 1:
        return shares[0]
    host = shares.cpu().numpy()
    acc = host[0]
    for v in host[1:]:
        acc = acc + v
    return torch.tensor(acc, dtype=shares.dtype, device=shares.device)


def _check_blocks(n_blocks) -> None:
    if n_blocks is not None and (not isinstance(n_blocks, int)
                                 or n_blocks < 1):
        raise ValueError(f"n_blocks must be a positive int, got "
                         f"{n_blocks!r}")


def solve_blocks(B: int, device, unit: int = 1) -> int:
    """The grid of K2, K3 and K11 on `device`'s card: one block per SM, or
    one a unit of `unit` samples (1; 16 on K2's batch route, K4's tiles)
    when the batch has fewer units than the card has SMs. On the CPU the
    plain versions' default, one block."""
    if torch.device(device).type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-B // unit), sms))


def _shares_work(n_blocks: int, n_values: int, dtype, device) -> Tensor:
    """A solve's grid workspace (csrc/grid_meet.cuh grid_shares_bytes): the
    meetings' counter and two buffers of n_values shares a block."""
    item = torch.empty((), dtype=dtype).element_size()
    return torch.empty(16 + 2 * n_blocks * n_values * item,
                       dtype=torch.uint8, device=device)


def _count(y: Tensor) -> Tensor:
    """y.numel() as a 0-d tensor on y's device: PyTorch's CUDA division by a
    host scalar multiplies by its reciprocal, which is not the division
    the kernels and the JAX reference perform. Filled on the device (no
    copy from the host, which would wait for the card)."""
    return torch.full((), float(y.numel()), dtype=y.dtype, device=y.device)


# ---------------------------------------------------------------------------
# The Pallas kernels' stage walk (pallas_kernels.py:_rk_stages), for the
# plain versions. It is not ops/rk.runge_kutta_step: the kernels accumulate
# each stage state term by term, the generic engine sums the terms first,
# and each side is held step for step to its own reference.
# ---------------------------------------------------------------------------

def _rk_stages(tab: ButcherTableau, f, y0: Tensor, f0: Tensor, dt: Tensor,
               t0=0.0):
    """All stages and the solution, error and midpoint combines, each
    stage state accumulated as yi + (dt * a_ij) * k_j. Returns
    (k, delta, err, y_mid) with y1 = y0 + delta; y_mid is None for
    tableaus without midpoint weights."""
    k = [f0]
    for i in range(1, tab.stages):
        yi = y0
        for aij, kj in zip(tab.a[i - 1], k):
            if aij != 0.0:
                yi = yi + (dt * aij) * kj
        k.append(f(t0 + tab.c[i] * dt, yi))

    def combine(coeffs, start):
        acc = start
        for c, kj in zip(coeffs, k):
            if c != 0.0:
                acc = (dt * c) * kj if acc is None else acc + (dt * c) * kj
        return acc

    delta = combine(tab.b_sol, None)
    err = combine(tab.b_err, None)
    y_mid = combine(tab.c_mid, y0) if tab.c_mid is not None else None
    return k, delta, err, y_mid


def _controller_factor(ratio, finite, accept, safety: float,
                       ifactor: float, dfactor: float, order: int):
    """pallas_kernels.py:_controller_factor: r ** (-1/order) as exp(log),
    clipped to [1, ifactor] on accept, [dfactor, 1] on reject. ratio is a
    tensor (0-d, or one ratio a sample); finite and accept are bools or
    bool tensors of its shape."""
    finite = torch.as_tensor(finite, device=ratio.device)
    accept = torch.as_tensor(accept, device=ratio.device)
    full = lambda v: torch.full_like(ratio, v)
    r = torch.maximum(torch.where(finite, ratio, full(2.0 ** 20)),
                      full(1e-38))
    fac = safety * torch.exp((-1.0 / float(order)) * torch.log(r))
    fac = torch.where(ratio <= 0.0, full(ifactor), fac)
    lo = torch.where(accept, full(1.0), full(dfactor))
    hi = torch.where(accept, full(ifactor), full(1.0))
    return torch.minimum(torch.maximum(fac, lo), hi)


# ---------------------------------------------------------------------------
# K1: one dopri5 step of the tanh-MLP (pallas_kernels.py:614)
# ---------------------------------------------------------------------------

def _mlp_tanh_plain(params: dict, y: Tensor) -> Tensor:
    """pallas_kernels.py:_make_mlp on [B, D]: the first layer sums its D
    input terms in order, the second sums over the hidden units."""
    w1, b1, w2, b2 = params["w1"], params["b1"], params["w2"], params["b2"]
    y3 = y * y * y
    acc = None
    for i in range(y.shape[1]):
        term = w1[i] * y3[:, i:i + 1]                       # [B, H]
        acc = term if acc is None else acc + term
    h = torch.tanh(acc + b1)
    # The hidden sum in the kernel's order (the reference leaves it to
    # jnp.sum), so that kernel and plain version agree to the bit.
    out = None
    for j in range(h.shape[1]):
        term = h[:, j:j + 1] * w2[j]                        # [B, D]
        out = term if out is None else out + term
    return out + b2


def _step_smem_values(D: int, H: int, samples: int) -> int:
    """csrc/lane_group.h step_smem_values: K1's shared memory in values,
    the weights, then each sample's slot (10 D + H) and error sum."""
    return 2 * D * H + H + D + samples * (10 * D + H + 1)


def step_samples(D: int, H: int, itemsize: int) -> int:
    """csrc/lane_group.h step_samples: the samples a K1 block (a power of
    two up to STEP_SAMPLES, STEP_BLOCK // samples threads each) whose
    shared memory fits MAX_WEIGHT_BYTES, or 0 when one does not. The
    partial error sums follow it: one a block of that many samples."""
    s = STEP_SAMPLES
    while s >= 1:
        if itemsize * _step_smem_values(D, H, s) <= MAX_WEIGHT_BYTES:
            return s
        s //= 2
    return 0


def _step_scalars(y: Tensor, dt, rtol, atol):
    as_t = lambda v: torch.as_tensor(v, dtype=y.dtype).to(y.device)
    return as_t(dt), as_t(rtol), as_t(atol)


def dopri5_mlp_step_plain(params: dict, y: Tensor, f0: Tensor, dt, rtol,
                          atol) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of K1. Same contract as `dopri5_mlp_step`."""
    dt, rtol, atol = _step_scalars(y, dt, rtol, atol)
    k, delta, err, y_mid = _rk_stages(
        DOPRI5, lambda t, yy: _mlp_tanh_plain(params, yy), y, f0, dt)
    y1 = y + delta
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
    esc = err / scale
    # Per-block partial sums in the kernel's order (each sample's squared
    # errors from 0 in feature order, then the block's samples in the
    # tree), +inf for a block whose sum or y1 is not finite
    # (pallas_kernels.py:646-648 per tile).
    # (A network too wide for the kernel's shared memory: a sample a block.)
    spb = step_samples(y.shape[1], params["w1"].shape[1],
                       y.element_size()) or 1
    n_blocks = -(-y.shape[0] // spb)
    part = _tree_sum(_owned_sums(esc * esc, n_blocks * spb)
                     .view(n_blocks, spb))
    bad = ~torch.isfinite(y1).all(dim=1)
    bad = torch.nn.functional.pad(bad, (0, n_blocks * spb - y.shape[0]))
    ok = torch.isfinite(part) & ~bad.view(n_blocks, spb).any(dim=1)
    part = torch.where(ok, part, torch.full_like(part, float("inf")))
    return y1, k[-1], torch.sqrt(torch.sum(part) / _count(y)), y_mid


def dopri5_mlp_step(params: dict, y: Tensor, f0: Tensor, dt, rtol, atol
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One fused dopri5 step of f(y) = tanh(y^3 W1 + b1) W2 + b2.

    params: {'w1': [D, H], 'b1': [H], 'w2': [H, D], 'b2': [D]}; y, f0:
    [B, D] state and its derivative (batch-major, where the JAX kernel is
    feature-major). Returns (y1, f1, err_ratio, y_mid): y1, the FSAL
    derivative f1 and the 4th-order midpoint are [B, D]; err_ratio is the
    0-d RMS of err / (atol + rtol max(|y0|, |y1|)), +inf when the step is
    not finite (accept iff <= 1).
    """
    kind = _device_kind(y, f0, *params.values())
    if kind == "cpu":
        return dopri5_mlp_step_plain(params, y, f0, dt, rtol, atol)
    global dopri5_mlp_step_launches
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dopri5_mlp_step takes float32 or float64, got "
                        f"{y.dtype}")
    if y.ndim != 2:
        raise ValueError(f"y must be [B, D], got {tuple(y.shape)}")
    B, D = y.shape
    H = params["w1"].shape[1]
    if D > STEP_MAX_D:
        raise ValueError(f"dopri5_mlp_step supports states up to "
                         f"STEP_MAX_D={STEP_MAX_D} features, got {D}")
    shapes = {"w1": (D, H), "b1": (H,), "w2": (H, D), "b2": (D,)}
    for name, shape in shapes.items():
        if tuple(params[name].shape) != shape:
            raise ValueError(f"params[{name!r}] has shape "
                             f"{tuple(params[name].shape)}, expected {shape}")
        _check_float(name, params[name], y.dtype)
    _check_float("y", y, y.dtype)
    _check_float("f0", f0, y.dtype)
    if f0.shape != y.shape:
        raise ValueError("f0 must have the shape of y")
    spb = step_samples(D, H, y.element_size())
    if spb == 0:
        smem = y.element_size() * _step_smem_values(D, H, 1)
        raise ValueError(f"dopri5_mlp_step: hidden width {H} needs {smem} "
                         f"bytes of shared memory, above {MAX_WEIGHT_BYTES}")
    lib = _build.library()
    y1 = torch.empty_like(y)
    f1 = torch.empty_like(y)
    ymid = torch.empty_like(y)
    n_blocks = -(-B // spb)
    partial = torch.empty(n_blocks, dtype=y.dtype, device=y.device)
    coeffs = [x for row in DOPRI5.a for x in row + (0.0,) * (6 - len(row))]
    coeffs += list(DOPRI5.b_sol) + list(DOPRI5.b_err) + list(DOPRI5.c_mid)
    coeffs = (ctypes.c_double * len(coeffs))(*coeffs)
    fn = (lib.tfd_dopri5_mlp_step_f32 if y.dtype == torch.float32
          else lib.tfd_dopri5_mlp_step_f64)
    with torch.cuda.device(y.device):
        err = fn(_ptr(y), _ptr(f0), _ptr(params["w1"]), _ptr(params["b1"]),
                 _ptr(params["w2"]), _ptr(params["b2"]), _ptr(y1), _ptr(f1),
                 _ptr(ymid), _ptr(partial), B, D, H, spb, float(dt),
                 float(rtol), float(atol), coeffs, _stream(y.device))
    _build.check(err, "dopri5_mlp_step launch")
    dopri5_mlp_step_launches += 1
    # RMS over the D * B elements; a +inf partial (non-finite block)
    # survives the sum.
    ratio = torch.sqrt(torch.sum(partial) / _count(y))
    return y1, f1, ratio, ymid


# ---------------------------------------------------------------------------
# K2: the whole adaptive solve of a general MLP (pallas_kernels.py:726)
# ---------------------------------------------------------------------------

def pack_mlp_weights(weights: Sequence[Tuple[Tensor, Tensor]],
                     dtype: torch.dtype, device=None
                     ) -> Tuple[Tensor, Tuple[Tuple[int, int], ...]]:
    """Pack an MLP weight list for K2 (counterpart of pad_mlp_weights).

    weights: [(W [din, dout], b [dout] or None), ...]. Returns (packed,
    dims): one contiguous tensor holding, layer after layer, W^T as
    [dout, din] row-major and then b (zeros for None), and the static
    ((din, dout), ...). Nothing is padded: the TPU's sublane tiles have no
    counterpart on the card.
    """
    parts, dims = [], []
    for W, b in weights:
        W = torch.as_tensor(W)
        din, dout = W.shape
        parts.append(W.to(device=device, dtype=dtype).t().reshape(-1))
        parts.append(torch.zeros(dout, dtype=dtype, device=device)
                     if b is None
                     else torch.as_tensor(b).to(device=device, dtype=dtype))
        dims.append((int(din), int(dout)))
    return torch.cat(parts).contiguous(), tuple(dims)


def _unpack(packed: Tensor, dims):
    layers, off = [], 0
    for din, dout in dims:
        wT = packed[off:off + din * dout].view(dout, din)
        off += din * dout
        layers.append((wT, packed[off:off + dout]))
        off += dout
    return layers


# ---------------------------------------------------------------------------
# K4: the dot-precision tiers (pallas_kernels.py:361-439)
# ---------------------------------------------------------------------------

#: Tier name -> csrc/dot_tiers.cuh `Tier` code.
_TIER_CODES = {"highest": 0, "mixed": 1, "bf16": 2}


def _layer_uses_mxu(matmul: str, din: int, dout: int) -> bool:
    """pallas_kernels.py:_layer_uses_mxu: which layers a reduced tier acts
    on. 'vpu': none; 'mxu': every layer; 'auto': a layer whose weight block
    is at least 32 wide both ways and 2048 values."""
    if matmul == "vpu":
        return False
    if matmul == "mxu":
        return True
    if matmul == "auto":
        return min(din, dout) >= 32 and din * dout >= 2048
    raise ValueError(f"matmul must be 'vpu', 'mxu' or 'auto', got "
                     f"{matmul!r}")


def layer_tiers(dims, matmul: str, dot_precision: str):
    """Each layer's tier: `dot_precision` where `_layer_uses_mxu` selects
    the layer, 'highest' elsewhere (pallas_kernels.py:403)."""
    return tuple(dot_precision if _layer_uses_mxu(matmul, din, dout)
                 else "highest" for din, dout in dims)


def _bf16(x: Tensor) -> Tensor:
    """x rounded to bf16 (nearest even; float64 through float32, as
    astype(bfloat16) does), back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _dot_in_order(wT: Tensor, h: Tensor) -> Tensor:
    """sum_i wT[:, i] h[:, i] over the inputs in order: [B, dout]."""
    acc = None
    for i in range(wT.shape[1]):
        term = wT[:, i] * h[:, i:i + 1]
        acc = term if acc is None else acc + term
    return acc


def dot_tier_plain(wT: Tensor, h: Tensor, tier: str) -> Tensor:
    """Plain PyTorch version of K4's layer product (pallas_kernels.py:
    _mixed_dot and the one-pass dot): h [B, din] times W [din, dout] given
    as wT [dout, din], with bf16-rounded weights and
    - 'mixed': activations split into h_hi = bf16(h) and h_lo = bf16(h -
      h_hi), acc = w16 . h_hi + w16 . h_lo;
    - 'bf16': acc = w16 . bf16(h).
    Each product of two bf16 values is exact in h's dtype; the sums run in
    input order. Returns acc [B, dout] (before the bias)."""
    w16 = _bf16(wT)
    h_hi = _bf16(h)
    if tier == "bf16":
        return _dot_in_order(w16, h_hi)
    if tier != "mixed":
        raise ValueError(f"no reduced tier {tier!r}")
    return _dot_in_order(w16, h_hi) + _dot_in_order(w16, _bf16(h - h_hi))


def _net_plain(packed: Tensor, dims, activation: str, final_activation: str,
               input_power: int, time_input: bool, tiers=None):
    """pallas_kernels.py:_make_net on [B, D]: each output sums its input
    terms in input order, then the time column, then the bias (a 'highest'
    layer); a layer with a reduced tier takes `dot_tier_plain` with the time
    column as its last input. Returns f(t, y)."""
    layers = _unpack(packed, dims)
    acts = ([_ACTIVATIONS[activation]] * (len(dims) - 1)
            + [_ACTIVATIONS[final_activation]])
    tiers = tiers or ("highest",) * len(dims)

    def f(t, y):
        h = y
        for _ in range(input_power - 1):
            h = h * y
        for l, (wT, b) in enumerate(layers):
            tcol = time_input and l == 0
            if tiers[l] != "highest":
                if tcol:
                    tt = torch.as_tensor(t, dtype=h.dtype).to(h.device)
                    h = torch.cat([h, tt.reshape(-1, 1).expand(
                        h.shape[0], 1)], dim=1)
                h = acts[l](dot_tier_plain(wT, h, tiers[l]) + b)
                continue
            n_state = wT.shape[1] - 1 if tcol else wT.shape[1]
            acc = _dot_in_order(wT[:, :n_state], h)
            if tcol:
                acc = acc + wT[:, n_state] * t
            h = acts[l](acc + b)
        return h

    return f


def _cnf_net_plain(packed: Tensor, dims, activation: str):
    """Plain version of K7's forward (pallas_kernels.py:_make_cnf_net) on
    the CNF state s = [z; logp], [B, D + 1]: the concat-t flow f(t, z)
    (hidden layers `activation`, the last layer linear) keeping each hidden
    layer's act'(z), then D forward-mode passes, pass i0 seeded with the
    first layer's column i0 (never the time column), and the divergence
    summed in i0 order. Each product sums its inputs in order, as
    `_net_plain` does. Returns F(t, s) = [f; -div f], [B, D + 1]."""
    layers = _unpack(packed, dims)
    L, D = len(dims), dims[-1][1]
    act, actg = _ACTIVATIONS[activation], _ACTIVATION_GRADS[activation]

    def f(t, s):
        h = s[:, :D]
        zs = []
        for l, (wT, b) in enumerate(layers):
            n_state = wT.shape[1] - 1 if l == 0 else wT.shape[1]
            acc = _dot_in_order(wT[:, :n_state], h)
            if l == 0:
                acc = acc + wT[:, n_state] * t
            zs.append(acc + b)
            h = act(zs[-1]) if l < L - 1 else zs[-1]
        gs = [actg(z, act(z)) for z in zs[:-1]]
        div = None
        for i0 in range(D):
            du = layers[0][0][:, i0].expand(s.shape[0], -1)
            if L > 1:
                du = gs[0] * du
            for l in range(1, L):
                v = _dot_in_order(layers[l][0], du)
                du = v if l == L - 1 else gs[l] * v
            div = du[:, i0] if div is None else div + du[:, i0]
        return torch.cat([h, -div[:, None]], dim=1)

    return f


#: Samples (rows) and threads of a tier_net block (csrc/tier_net_kernel.cu
#: kTierNetRows, kTierNetThreads: K8's batch-route block).
TIER_NET_ROWS = 16


def tier_net(warrays: Tensor, dims, x: Tensor, t=0.0, *, tiers,
             activation: str = "tanh", final_activation: str = "identity",
             input_power: int = 1, time_input: bool = False) -> Tensor:
    """K4 on its own: one evaluation f(t, x) of the MLP with each layer at
    its tier, batch-wide, as K2 and K8 evaluate a stage on their batch
    route (csrc/tier_net_kernel.cu). The solves never call it: it holds K4
    against its plain version and times it without a solve around it.

    warrays/dims: from `pack_mlp_weights`; x: [B, D]; tiers: each layer's
    dot precision (see `layer_tiers`). Returns f [B, D]. Two launches: the
    bf16 weight pack and the evaluation; `tier_net_launches` counts one.
    """
    _check_activations(activation, final_activation)
    if x.ndim != 2:
        raise ValueError(f"x must be [B, D], got {tuple(x.shape)}")
    if _device_kind(x, warrays) == "cpu":
        return _net_plain(warrays, dims, activation, final_activation,
                          input_power, time_input, tiers)(t, x)
    global tier_net_launches
    out = torch.empty_like(x)
    work = tier_net_work(dims, x)
    tier_net_parts(warrays, dims, x, t, out, work, tiers=tiers,
                   activation=activation, final_activation=final_activation,
                   input_power=input_power, time_input=time_input, mode=0)
    tier_net_launches += 1
    return out


def tier_net_work(dims, x: Tensor) -> Tensor:
    """The workspace of `tier_net_parts` for x [B, D] (bytes)."""
    rows = -(-x.shape[0] // TIER_NET_ROWS) * TIER_NET_ROWS
    return torch.empty(_tier_work_bytes(dims, rows, x.element_size()),
                       dtype=torch.uint8, device=x.device)


def tier_net_parts(warrays: Tensor, dims, x: Tensor, t, out: Tensor,
                   work: Tensor, *, tiers, activation: str = "tanh",
                   final_activation: str = "identity", input_power: int = 1,
                   time_input: bool = False, mode: int = 0) -> None:
    """K4's launches on the card, for `tier_net` and for timing its parts:
    mode 0 packs the bf16 weights into `work` and evaluates into `out`, 1
    only packs, 2 only evaluates (on a `work` packed before)."""
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tier_net takes float32 or float64, got {dtype}")
    B, D = x.shape
    _check_mlp("tier_net", warrays, dims, D, time_input, tiers)
    for name, v in (("x", x), ("warrays", warrays), ("out", out)):
        _check_float(name, v, dtype)
    fn = (_build.library().tfd_tier_net_f32 if dtype == torch.float32
          else _build.library().tfd_tier_net_f64)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(warrays), _ptr(out), B, D, len(dims),
                 _dims_arg(dims), _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), float(t), _tiers_arg(tiers), _ptr(work),
                 work.numel(), int(mode), _stream(x.device))
    _build.check(err, "tier_net launch")


def _net_widths(dims):
    """(gw, n_hid, D): the widest layer, the hidden layers' outputs and the
    last layer's outputs."""
    return (max(w for dd in dims for w in dd),
            sum(dout for _, dout in dims[:-1]), dims[-1][1])


def _solve_setup(tau: Tensor, dt0, dtype):
    """whole_solve_call's scalar prologue (pallas_kernels.py:1349-1388) on
    the host: the span-scaled dt_min, dt0 clamped to it, and whether tau
    increases strictly. Returns host 0-d tensors and a bool."""
    tau_h = tau.detach().to("cpu", dtype)
    span = torch.maximum(torch.maximum(torch.abs(tau_h[0]),
                                       torch.abs(tau_h[-1])),
                         torch.tensor(1.0, dtype=dtype))
    dt_min = torch.tensor(4.0 * torch.finfo(dtype).eps, dtype=dtype) * span
    # Straight to `dtype`: a Python float must not pass through float32.
    dt0 = torch.maximum(torch.abs(torch.as_tensor(
        dt0, dtype=dtype, device="cpu").detach()), dt_min)
    return tau_h, dt_min, dt0, _increasing(tau_h)


def mlp_solve_plain(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0,
                    rtol, atol, sign, *, f0: Tensor,
                    activation: str = "tanh",
                    final_activation: str = "identity",
                    input_power: int = 1, time_input: bool = False,
                    method: str = "dopri5", safety: float = 0.9,
                    ifactor: float = 10.0, dfactor: float = 0.2,
                    max_steps: int = 2 ** 31 - 1,
                    tiers=None, rhs: str = "mlp", n_blocks: int = None
                    ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2: a host loop of attempts that mirrors
    `_make_solve_kernel` line for line (one synchronisation per attempt),
    the error sum in the order of a grid of `n_blocks` blocks (None: the
    kernel's grid for y0's device, `solve_blocks`; one block on the CPU).
    Same contract as `mlp_solve`, except that f0 is required."""
    sign_d = torch.as_tensor(sign, dtype=y0.dtype).to(y0.device)
    if _check_rhs(rhs):
        raw_f = _cnf_net_plain(warrays, dims, activation)
    else:
        raw_f = _net_plain(warrays, dims, activation, final_activation,
                           input_power, time_input, tiers)

    def f(s, y):
        # Canonical dynamics: g(tau, y) = sign * f(sign * tau, y).
        return sign_d * raw_f(sign_d * s, y)

    return adaptive_solve_plain(
        f, y0, f0, tau, dt0, rtol, atol, TABLEAUS_BY_NAME[method],
        safety=safety, ifactor=ifactor, dfactor=dfactor,
        max_steps=max_steps, threads=SOLVE_THREADS, n_blocks=n_blocks,
        unit=_solve_unit(dims, y0, tiers))


def _solve_unit(dims, y0: Tensor, tiers) -> int:
    """Samples a unit of K2's grid on the wrapper's route: TILE_ROWS on the
    batch route, else 1."""
    n_w = sum(din * dout + dout for din, dout in dims)
    route = _route("mlp_solve", dims, n_w, y0.element_size(), tiers)
    return TILE_ROWS if route == ROUTE_BATCH else 1


def adaptive_solve_plain(f, y0: Tensor, f0: Tensor, tau: Tensor, dt0, rtol,
                         atol, tab: ButcherTableau, *, safety: float,
                         ifactor: float, dfactor: float, max_steps: int,
                         threads: int, n_blocks: int = None, unit: int = 1,
                         emit_dense: int = 0):
    """The whole-solve kernels' engine (`_make_solve_kernel`) as a host
    loop of attempts, one synchronisation each: f(s, y) is the canonical
    (signed) right-hand side on y0's [rows, D] layout. The error sum is
    taken in the order of K2's grid of `n_blocks` blocks, each of
    `threads` threads (`_grid_sum`): block k owns the rows [e[k], e[k + 1])
    of `_block_bounds(rows, n_blocks, unit)` and its thread i the rows
    e[k] + i, e[k] + i + threads, ...; n_blocks = 1 is the one-block order
    (K13 runs a controller a block: its plain version passes 1); None the
    kernel's grid for y0's device (`solve_blocks`: one block on the CPU).
    Returns (out [T, rows, D], stats [4] int32); with emit_dense = S > 0
    also K2's dense output (`csrc/rk_solve.cuh`): meta [S, 3] (t, t1, dt of
    each accepted step in tau, +inf rows past the last) and coef
    [S, 5, rows, D] (the drain's ca, cb, cc, df0, y0; zero rows past the
    last), the first S accepted steps."""
    dev, dtype = y0.device, y0.dtype
    T = tau.shape[0]
    _check_blocks(n_blocks)
    n_blocks = n_blocks or solve_blocks(y0.shape[0], dev, unit)
    owned = _block_index(y0.shape[0], n_blocks, threads, dev, unit)
    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    on = lambda v: torch.as_tensor(v, dtype=dtype).to(dev)
    tau_d = on(tau_h)
    rtol, atol = on(rtol), on(atol)

    out = torch.zeros((T,) + tuple(y0.shape), dtype=dtype, device=dev)
    out[0] = y0
    if emit_dense:
        meta = torch.full((emit_dense, 3), float("inf"), dtype=dtype,
                          device=dev)
        coef = torch.zeros((emit_dense, 5) + tuple(y0.shape), dtype=dtype,
                           device=dev)
    si = 0
    y, fy, comp = y0, f0, torch.zeros_like(y0)
    t_end, t_start = tau_d[T - 1], tau_d[0]
    t, dt = t_start, on(dt0)
    dt_min, denom = on(dt_min), _count(y0)
    oi, nfe, nacc, nrej = 1, 0, 0, 0
    status = 0 if (float(tau_h[-1]) > float(tau_h[0]) and valid) else 3
    t_h, t_end_h = float(tau_h[0]), float(tau_h[-1])
    while t_h < t_end_h and status == 0:
        rem = t_end - t
        dt_eff = torch.minimum(dt, rem)
        is_last = dt >= rem
        t1 = torch.where(is_last, t_end, t + dt_eff)
        dth = t1 - t

        k, delta, err, y_mid = _rk_stages(tab, f, y, fy, dth, t0=t)
        y1 = y + delta
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        esc = err / scale
        # The kernel's fixed reduction order, so that a float64 solve takes
        # the kernel's exact step sequence.
        ss = _grid_sum(esc * esc, owned)
        ratio = torch.sqrt(ss / denom)
        fin = torch.isfinite(ss) & torch.all(torch.isfinite(y1))
        # The attempt's one synchronisation.
        acc_h, fin_h, t1_h = torch.stack([
            ((ratio <= 1.0) & fin).to(torch.float64), fin.to(torch.float64),
            t1.to(torch.float64)]).tolist()
        accept, finite = bool(acc_h), bool(fin_h)

        fac = _controller_factor(ratio, finite, accept, safety, ifactor,
                                 dfactor, tab.order)
        dt_next = dth * fac
        f1 = k[-1] if tab.fsal else f(t1, y1)

        if accept:
            # pallas_kernels.py:_interp_coeffs is ops/rk's quartic (cubic
            # Hermite without a midpoint), operation for operation.
            if y_mid is not None:
                ca, cb, cc, df0, _ = interp_fit_quartic(y, y1, y_mid, k[0],
                                                        f1, dth)
            else:
                ca, cb, cc, df0, _ = interp_fit_cubic_hermite(y, y1, k[0],
                                                              f1, dth)
            if si < emit_dense:
                meta[si] = torch.stack([t, t1, dth])
                coef[si] = torch.stack([ca, cb, cc, df0, y])
                si += 1
            adj = delta - comp
            y_new = y + adj
            comp = (y_new - y) - adj
            # Drain every requested time in (t, t1], exactly y_new at t1.
            while oi < T and float(tau_h[oi]) <= t1_h:
                tj = tau_d[oi]
                x = (tj - t) / dth
                val = (((ca * x + cb) * x + cc) * x + df0) * x + y
                out[oi] = torch.where(tj == t1, y_new, val)
                oi += 1
            y, fy = y_new, f1

        n_att = nacc + nrej + 1
        if status == 0 and not accept and bool(dt_next < dt_min):
            status = 2
        if status == 0 and n_att >= max_steps and t1_h < t_end_h:
            status = 1
        if accept:
            t, t_h = t1, t1_h
        dt = dt_next
        nfe += tab.evals_per_step
        nacc += int(accept)
        nrej += int(not accept)
    stats = torch.tensor([nfe, nacc, nrej, status], dtype=torch.int32,
                         device=dev)
    if emit_dense:
        return out, stats, meta, coef
    return out, stats


def mlp_solve(warrays: Tensor, dims, y0: Tensor, tau: Tensor, dt0, rtol,
              atol, sign, *, f0: Tensor = None, activation: str = "tanh",
              final_activation: str = "identity", input_power: int = 1,
              time_input: bool = False, method: str = "dopri5",
              safety: float = 0.9, ifactor: float = 10.0,
              dfactor: float = 0.2, max_steps: int = 2 ** 31 - 1,
              tiers=None, rhs: str = "mlp", n_blocks: int = None
              ) -> Tuple[Tensor, Tensor]:
    """Whole-solve fused adaptive RK for a general MLP neural ODE: every
    stage evaluation, combine, error norm, controller decision and
    dense-output write of the solve runs in one kernel launch.

    warrays/dims: from `pack_mlp_weights` (any depth up to MAX_LAYERS,
    widths up to MAX_WIDTH, any activation in `_ACTIVATIONS`, the state
    entering as y ** input_power, an optional time column). `method`
    picks the tableau (dopri5, bosh3, adaptive_heun, tsit5, dopri8);
    tableaus that are not FSAL pay one more evaluation per attempt.
    tiers: each layer's dot precision ('highest', 'mixed' or 'bf16'; see
    `layer_tiers`), None for 'highest' everywhere; a reduced tier takes the
    batch route (K4's layer products on the tensor cores in float32), two
    launches: the bf16 weight pack, then the solve.

    y0: [B, D]; tau: [T] increasing canonical times (tau = sign * t);
    sign: +1 or -1; dt0: first step, clamped to the span-scaled minimum;
    f0: the signed derivative at (tau[0], y0), computed here when None.
    Returns (out [T, B, D], stats [4] int32 on y0's device: nfe, accepted,
    rejected, status). Status: 0 OK, 1 MAX_STEPS_REACHED, 2 DT_UNDERFLOW,
    3 INVALID_TIMES (tau not strictly increasing; the output is then zero
    beyond row 0).

    rhs='cnf' (K7's forward in K2, pallas_kernels.py:1291-1294): y0 is the
    CNF state [z; logp], [B, D + 1], and dims describe the concat-t flow
    (D + 1 inputs, time last; D outputs); each evaluation is the flow with
    its last layer linear (final_activation and input_power do not apply)
    and its exact divergence, F = [f; -div f]. The error norm and the dense
    output cover all D + 1 columns. f0 is required, as in the reference,
    and the layers take no reduced tier.

    n_blocks: the kernel's grid, each block a contiguous range of the
    samples (None: `solve_blocks`, one block per SM; on the batch route a
    block owns whole 16-row tiles, at most one block a tile). Every block
    takes the one controller's same decisions; the grid changes only the
    order of the error sum (the plain version repeats it for the same
    n_blocks). A grid that cannot be resident together raises.
    """
    if method not in TABLEAUS_BY_NAME:
        raise ValueError(f"unknown method {method!r}; available: "
                         f"{sorted(TABLEAUS_BY_NAME)}")
    _check_activations(activation, final_activation)
    if y0.ndim != 2:
        raise ValueError(f"y0 must be [B, D], got {tuple(y0.shape)}")
    dtype = y0.dtype
    cnf = _check_rhs(rhs)
    if cnf:
        if f0 is None:
            raise ValueError("rhs='cnf' needs an explicit f0 (the plain "
                             "network only covers the MLP right-hand side)")
        if tiers is not None and any(t != "highest" for t in tiers):
            raise ValueError(f"rhs='cnf' takes no reduced tier, got {tiers}")
        _check_cnf("mlp_solve", dims, y0.shape[1])
        tiers, time_input = None, True
        final_activation, input_power = "identity", 1
    if f0 is None:
        sgn = torch.as_tensor(sign, dtype=dtype).to(y0.device)
        tau0 = torch.as_tensor(tau[0], dtype=dtype).to(y0.device)
        f0 = sgn * _net_plain(warrays, dims, activation, final_activation,
                              input_power, time_input)(sgn * tau0, y0)
    _check_blocks(n_blocks)
    kind = _device_kind(y0, f0, warrays)
    if kind == "cpu":
        return mlp_solve_plain(
            warrays, dims, y0, tau, dt0, rtol, atol, sign, f0=f0,
            activation=activation, final_activation=final_activation,
            input_power=input_power, time_input=time_input, method=method,
            safety=safety, ifactor=ifactor, dfactor=dfactor,
            max_steps=max_steps, tiers=tiers, rhs=rhs, n_blocks=n_blocks)

    global mlp_solve_launches, dot_tier_launches, cnf_solve_launches
    global last_solve_layout
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mlp_solve takes float32 or float64, got {dtype}")
    B, D = y0.shape
    T = tau.shape[0]
    n_w = _check_mlp("mlp_solve", warrays, dims, D - cnf, time_input, tiers)
    route = _route("mlp_solve", dims, n_w, y0.element_size(), tiers)
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    for name, x in (("y0", y0), ("f0", f0), ("warrays", warrays)):
        _check_float(name, x, dtype)
    if f0.shape != y0.shape:
        raise ValueError("f0 must have the shape of y0")

    tau_h, dt_min, dt0, valid = _solve_setup(tau, dt0, dtype)
    tau_d = tau_h.to(y0.device)
    tab = TABLEAUS_BY_NAME[method]
    S = tab.stages
    c, a, b_sol, b_err = _tableau_args(tab)
    dims_c = _dims_arg(dims)
    out = torch.empty((T, B, D), dtype=dtype, device=y0.device)
    stats = torch.empty(4, dtype=torch.int32, device=y0.device)
    # (K7's walk keeps its values in the slots of its groups, in shared
    # memory: csrc/cnf_net.cuh cnf_eval_group.)
    work = torch.empty((S + 5) * D * B, dtype=dtype, device=y0.device)
    n_batch = (_tier_work_bytes(dims, _pad16(B), y0.element_size())
               if route == ROUTE_BATCH else 0)
    batch_work = torch.empty(n_batch, dtype=torch.uint8, device=y0.device)
    nb = n_blocks or solve_blocks(B, y0.device, TILE_ROWS
                                  if route == ROUTE_BATCH else 1)
    if route == ROUTE_BATCH and nb > -(-B // TILE_ROWS):
        raise ValueError(f"mlp_solve: the batch route takes at most one "
                         f"block a tile of {TILE_ROWS} samples, "
                         f"{-(-B // TILE_ROWS)} here; got n_blocks={nb}")
    gwork = _shares_work(nb, 2, dtype, y0.device)
    lib = _build.library()
    fn = (lib.tfd_mlp_solve_f32 if dtype == torch.float32
          else lib.tfd_mlp_solve_f64)
    c_mid = (None if tab.c_mid is None
             else (ctypes.c_double * S)(*tab.c_mid))
    reported = (ctypes.c_int * 4)()
    with torch.cuda.device(y0.device):
        err = fn(_ptr(tau_d), _ptr(y0), _ptr(f0), _ptr(warrays), _ptr(out),
                 _ptr(stats), _ptr(work), T, B, D, SOLVE_THREADS,
                 float(dt0), float(rtol), float(atol), float(dt_min),
                 float(sign), float(safety), float(ifactor), float(dfactor),
                 int(min(max_steps, 2 ** 31 - 1)), int(valid), len(dims),
                 dims_c, _ACT_CODES[activation],
                 _ACT_CODES[final_activation], int(input_power),
                 int(time_input), S, tab.order, int(tab.fsal), c, a, b_sol,
                 b_err, c_mid, route, _tiers_arg(tiers), _ptr(batch_work),
                 n_batch, int(cnf), _ptr(gwork), gwork.numel(), nb,
                 reported, _stream(y0.device))
    _build.check(err, "mlp_solve launch")
    last_solve_layout = launch_layout(nb, reported)
    mlp_solve_launches += 1
    dot_tier_launches += route == ROUTE_BATCH
    cnf_solve_launches += cnf
    return out, stats
