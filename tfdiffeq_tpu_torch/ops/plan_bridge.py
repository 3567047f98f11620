"""Capture plain PyTorch dynamics into a fusable plan, and the plan's plain
evaluator.

Counterpart of `tfdiffeq_tpu/ops/jaxpr_bridge.py`. A user's `func(t, y)`
over the batch-major state y [B, D], written in plain PyTorch, is traced
with `torch.fx.experimental.proxy_tensor.make_fx` on real tensors into an
aten graph, and the graph is lowered to the reference's plan ISA over the
feature-major [rows, B] layout:

- ``('litv', out, value)``, ``('un', out, a, op)``, ``('bin', out, a, b,
  op)``, ``('ipow', out, a, n)``, ``('clamp', out, lo, x, hi)``,
  ``('select', out, pred, c0, c1)``, ``('cast', out, a, from_bool)``,
  ``('bcast', out, a, kind)``, ``('reshape', out, a, kind)``,
  ``('concat', out, atoms)``, ``('slice', out, a, r0, r1)``,
  ``('rev', out, a, rows)``, ``('reduce', out, a, fn, to_scalar)``;
- the batch couplings ``('bsum', out, a, rows, to_scalar)`` and
  ``('bmax', out, a, rows, to_scalar, is_min)``;
- ``('dot', out, a, const_index, din, dout, mxu)`` against a constant
  weight.

An atom is ``('v', value_id)`` or ``('l', float)``. Anything outside the
subset raises `FusionError` (the front ends catch it and run the generic
engine), with the reference's rejections: computed dot weights, a constant
used both as a weight and elementwise, a batch size equal to a feature
dimension, slices and flips along the batch axis, float->int casts.

`eval_plan` is the plain PyTorch version of K14 (the reference's in-kernel
plan walk, `jaxpr_bridge.py:826`): it walks the instructions on [rows, B]
blocks in the order the generated CUDA code of `plan_codegen` does, each dot
summed in input order and each batch sum in the order of K2's block
(`cuda_kernels._owned_sums`, `_tree_sum`). `eval_plan_host` is f(t, y) on
the batch-major layout, for the front ends' f0 and initial-step probe.
The reference's lane padding and its pad-lane masks have no counterpart:
blocks here are exactly B wide.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, List, Sequence, Tuple

import torch

from .cuda_kernels import (SOLVE_THREADS, _layer_uses_mxu, _tree_sum,
                           dot_tier_plain)

Tensor = torch.Tensor


class FusionError(Exception):
    """Dynamics outside the fusable subset (callers fall back)."""


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Hashable program over the [rows, B] layout, static per (func
    structure, shapes): equal structures give equal plans.

    const_layouts, per traced constant: ``('wT', din, dout, transpose)``
    (a dot weight, stored [dout, din]), ``('col', d)``, ``('scalar',)``,
    ``('batch', d)`` and ``('bvec',)`` (per-sample, [d, B] and [1, B]) or
    ``('unused',)``.
    """
    instrs: tuple
    n_vals: int
    const_layouts: tuple
    const_val_ids: tuple
    t_id: int
    y_id: int
    out_id: int
    batch: int
    dim: int
    matmul: str = "auto"
    #: output rows; == dim for ODE right-hand sides.
    dim_out: int = -1
    #: the plan holds a batch coupling ('bsum' / 'bmax').
    batch_coupled: bool = False

    @property
    def out_rows(self) -> int:
        return self.dim if self.dim_out < 0 else self.dim_out


def _kind(shape: Tuple[int, ...], B: int):
    """A shape's block layout: 'scalar', (rows, cols) or 'mat'
    (jaxpr_bridge.py:201). Rank >= 3 batch-leading shapes flatten their
    trailing dims into rows."""
    if shape == ():
        return "scalar"
    if len(shape) == 1:
        return (1, B) if shape[0] == B else (shape[0], 1)
    if len(shape) == 2:
        if shape[0] == B:
            return (shape[1], B)
        if shape[0] == 1:
            return (shape[1], 1)
        if shape[1] == 1:
            return (shape[0], 1)
        return "mat"
    r = math.prod(shape[1:])
    if shape[0] == B:
        return (r, B)
    if shape[0] == 1:
        return (r, 1)
    raise FusionError(f"rank-{len(shape)} intermediate {shape} unsupported")


def _check_no_batch_collision(shape, B: int) -> None:
    """B may appear only as the leading (batch) axis."""
    if B == 1:
        return
    for i, d in enumerate(shape):
        if d == B and i != 0:
            raise FusionError(
                f"batch size {B} collides with feature dim in {shape}")


# ---------------------------------------------------------------------------
# Capture: make_fx graph -> plan
# ---------------------------------------------------------------------------

class _PlanBuilder:
    def __init__(self, B: int, dim: int, matmul: str):
        self.B = B
        self.dim = dim
        self.matmul = matmul
        self.instrs: List[tuple] = []
        self.n_vals = 0
        self.consts: List[Tensor] = []
        self.const_ids: List[int] = []
        self.const_layouts: List[Any] = []
        self.const_of_val = {}
        self.batch_coupled = False

    def new_val(self) -> int:
        self.n_vals += 1
        return self.n_vals - 1

    def add_const(self, value: Tensor) -> int:
        vid = self.new_val()
        self.consts.append(value)
        self.const_ids.append(vid)
        self.const_layouts.append(None)
        self.const_of_val[vid] = len(self.consts) - 1
        return vid

    def emit(self, op: str, *args) -> Tuple[str, int]:
        vid = self.new_val()
        self.instrs.append((op, vid) + args)
        return ("v", vid)

    def set_const_layout(self, idx: int, layout) -> None:
        cur = self.const_layouts[idx]
        if cur is None:
            self.const_layouts[idx] = layout
        elif cur != layout:
            raise FusionError(
                f"const used in conflicting roles: {cur} vs {layout}")

    def finalize_default_layouts(self, used_vids) -> None:
        """Constants no dot consumed take elementwise layouts from their
        shapes; constants no instruction reads are 'unused'."""
        for i, c in enumerate(self.consts):
            if self.const_layouts[i] is not None:
                continue
            if self.const_ids[i] not in used_vids:
                self.set_const_layout(i, ("unused",))
                continue
            if not torch.is_floating_point(c):
                raise FusionError(f"non-float const dtype {c.dtype}")
            k = _kind(tuple(c.shape), self.B)
            if k == "scalar":
                self.set_const_layout(i, ("scalar",))
            elif k == "mat":
                raise FusionError(
                    f"2-D const {tuple(c.shape)} used outside a dot")
            else:
                r, cols = k
                if cols == self.B and self.B != 1:
                    self.set_const_layout(
                        i, ("bvec",) if c.ndim == 1 else ("batch", r))
                else:
                    self.set_const_layout(i, ("col", r))


def _shape(x) -> Tuple[int, ...]:
    if isinstance(x, torch.fx.Node):
        val = x.meta.get("val")
        if not isinstance(val, Tensor):
            raise FusionError(f"node {x.name} carries no tensor")
        return tuple(val.shape)
    return ()


def _dtype(x):
    if isinstance(x, torch.fx.Node):
        return x.meta["val"].dtype
    return None


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _live_nodes(graph) -> set:
    """Nodes the output depends on (dead nodes are dropped)."""
    out = next(n for n in graph.nodes if n.op == "output")
    live, stack = set(), [out]
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(n.all_input_nodes)
    return live


class _Lowering:
    """Walks the aten graph and emits plan instructions."""

    def __init__(self, builder: _PlanBuilder, gm):
        self.b = builder
        self.gm = gm
        self.env = {}

    # ---- atoms ----
    def atom(self, x):
        if isinstance(x, torch.fx.Node):
            a = self.env[x]
            if isinstance(a, tuple) and a and a[0] in ("v", "l"):
                return a
            raise FusionError(f"{x.name} is not a single value")
        if isinstance(x, bool):
            return ("l", 1.0 if x else 0.0)
        if isinstance(x, (int, float)):
            return ("l", float(x))
        raise FusionError(f"unsupported argument {x!r}")

    def const_index(self, a):
        if a[0] == "v" and a[1] in self.b.const_of_val:
            return self.b.const_of_val[a[1]]
        return None

    def _lit_block(self, value: float, shape):
        k = _kind(tuple(shape), self.b.B)
        if k == "scalar":
            return ("l", float(value))
        if k == "mat":
            raise FusionError(f"literal block of shape {tuple(shape)}")
        return self.b.emit("bcast", ("l", float(value)), k)

    # ---- graph ----
    def run(self, t_id: int, y_id: int):
        graph = self.gm.graph
        live = _live_nodes(graph)
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        self.env[placeholders[0]] = ("v", t_id)
        self.env[placeholders[1]] = ("v", y_id)
        out = None
        for n in graph.nodes:
            if n not in live or n.op == "placeholder":
                continue
            if n.op == "get_attr":
                c = getattr(self.gm, n.target)
                if not isinstance(c, Tensor):
                    raise FusionError(f"attribute {n.target} is no tensor")
                if c.ndim == 0 and not c.requires_grad:
                    # A concrete scalar constant folds to a literal value;
                    # one that takes a gradient stays a 'scalar' constant
                    # (jaxpr_bridge.py:328-334), so that its value is data.
                    self.env[n] = self.b.emit("litv", float(c.detach()))
                else:
                    self.env[n] = ("v", self.b.add_const(c))
                continue
            if n.op == "output":
                res = n.args[0]
                if isinstance(res, (tuple, list)):
                    if len(res) != 1:
                        raise FusionError(
                            f"func must return one tensor, got {len(res)}")
                    res = res[0]
                out = res
                continue
            if n.op != "call_function":
                raise FusionError(f"graph node {n.op} unsupported")
            if n.target is operator.getitem:
                src, i = n.args
                self.env[n] = self.env[src][i]
                continue
            self.lower(n)
        if not isinstance(out, torch.fx.Node):
            raise FusionError("func must return a tensor computed from y")
        a = self.atom(out)
        if a[0] == "l":
            raise FusionError("literal output")
        return a[1], _shape(out)

    def lower(self, n) -> None:
        B = self.b.B
        for x in [n] + list(n.all_input_nodes):
            val = x.meta.get("val")
            if isinstance(val, Tensor):
                _check_no_batch_collision(tuple(val.shape), B)
        name = n.target.overloadpacket.__name__
        if name in _INPLACE_VIEWS:
            name = name[:-1]
        handler = _HANDLERS.get(name)
        if handler is None:
            raise FusionError(f"op {str(n.target)!r} not fusable")
        res = handler(self, n, *n.args, **n.kwargs)
        self.env[n] = res


# ---- handlers: each returns the node's atom (or a tuple of atoms) ----

#: In-place metadata ops that vmap leaves on fresh results; every other
#: in-place op is refused.
_INPLACE_VIEWS = ("squeeze_", "unsqueeze_")
_ALIAS = ("detach", "alias", "clone", "lift_fresh_copy", "contiguous",
          "lift_fresh", "positive")
_UN_ATEN = {"neg": "neg", "exp": "exp", "log": "log", "log1p": "log1p",
            "tanh": "tanh", "sigmoid": "logistic", "sin": "sin",
            "cos": "cos", "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs",
            "sign": "sign", "sgn": "sign", "floor": "floor", "ceil": "ceil",
            "expm1": "expm1", "cosh": "cosh", "sinh": "sinh",
            "logical_not": "not", "erf": "erf", "erfc": "erfc", "tan": "tan",
            "asinh": "asinh", "acosh": "acosh", "atanh": "atanh"}
_BIN_ATEN = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
             "true_divide": "div", "maximum": "max", "minimum": "min",
             "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
             "gt": "gt", "lt": "lt", "ge": "ge", "le": "le", "eq": "eq",
             "ne": "ne", "greater": "gt", "less": "lt"}


def _name(n) -> str:
    return n.target.overloadpacket.__name__


def _h_alias(L, n, x, *args, **kw):
    return L.atom(x)


def _h_un(L, n, x, *args, **kw):
    return L.b.emit("un", L.atom(x), _UN_ATEN[_name(n)])


def _h_round(L, n, x, *args, **kw):
    if args or kw.get("decimals", 0):
        raise FusionError("round(decimals=...) not fusable")
    return L.b.emit("un", L.atom(x), "round")


def _h_bin(L, n, a, b, *args, **kw):
    op = _BIN_ATEN[_name(n)]
    if op == "div" and kw.get("rounding_mode") is not None:
        raise FusionError("div with a rounding mode not fusable")
    bb = L.atom(b)
    alpha = kw.get("alpha", args[0] if args else 1)
    if op in ("add", "sub") and alpha != 1:
        bb = L.b.emit("bin", bb, ("l", float(alpha)), "mul")
    return L.b.emit("bin", L.atom(a), bb, op)


def _h_rsub(L, n, a, b, alpha=1):
    bb = L.atom(a)
    if alpha != 1:
        bb = L.b.emit("bin", bb, ("l", float(alpha)), "mul")
    return L.b.emit("bin", L.atom(b), bb, "sub")


def _h_pow(L, n, a, b):
    if isinstance(b, (int, float)) and not isinstance(b, bool) \
            and float(b).is_integer():
        return L.b.emit("ipow", L.atom(a), int(b))
    return L.b.emit("bin", L.atom(a), L.atom(b), "pow")


def _h_square(L, n, x):
    return L.b.emit("ipow", L.atom(x), 2)


def _h_reciprocal(L, n, x):
    return L.b.emit("bin", ("l", 1.0), L.atom(x), "div")


def _h_relu(L, n, x):
    return L.b.emit("bin", L.atom(x), ("l", 0.0), "max")


def _h_silu(L, n, x):
    a = L.atom(x)
    return L.b.emit("bin", a, L.b.emit("un", a, "logistic"), "mul")


def _h_gelu(L, n, x, approximate="none"):
    """PyTorch's own formulas: x * 0.5 * (1 + erf(x / sqrt 2)), or with
    approximate='tanh' 0.5 * x * (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3)))."""
    a, e = L.atom(x), L.b.emit
    if approximate == "none":
        s = e("bin", ("l", 1.0),
              e("un", e("bin", a, ("l", 0.7071067811865476), "mul"), "erf"),
              "add")
        return e("bin", e("bin", a, ("l", 0.5), "mul"), s, "mul")
    if approximate == "tanh":
        cube = e("bin", e("bin", a, a, "mul"), a, "mul")
        inner = e("bin", ("l", math.sqrt(2.0 / math.pi)),
                  e("bin", a, e("bin", ("l", 0.044715), cube, "mul"), "add"),
                  "mul")
        s = e("bin", ("l", 1.0), e("un", inner, "tanh"), "add")
        return e("bin", e("bin", ("l", 0.5), a, "mul"), s, "mul")
    raise FusionError(f"gelu(approximate={approximate!r}) not fusable")


def _h_softplus(L, n, x, beta=1, threshold=20):
    if beta != 1:
        raise FusionError("softplus(beta != 1) not fusable")
    a, e = L.atom(x), L.b.emit
    soft = e("un", e("un", a, "exp"), "log1p")
    return e("select", e("bin", a, ("l", float(threshold)), "gt"), soft, a)


def _h_elu(L, n, x, alpha=1, scale=1, input_scale=1):
    if (alpha, scale, input_scale) != (1, 1, 1):
        raise FusionError("elu with alpha/scale not fusable")
    a, e = L.atom(x), L.b.emit
    return e("select", e("bin", a, ("l", 0.0), "gt"), e("un", a, "expm1"), a)


def _h_leaky_relu(L, n, x, slope=0.01):
    a, e = L.atom(x), L.b.emit
    return e("select", e("bin", a, ("l", 0.0), "gt"),
             e("bin", a, ("l", float(slope)), "mul"), a)


def _h_clamp(L, n, x, lo=None, hi=None, **kw):
    lo, hi = kw.get("min", lo), kw.get("max", hi)
    a = L.atom(x)
    if lo is not None and hi is not None:
        return L.b.emit("clamp", L.atom(lo), a, L.atom(hi))
    if lo is not None:
        return L.b.emit("bin", a, L.atom(lo), "max")
    if hi is not None:
        return L.b.emit("bin", a, L.atom(hi), "min")
    return a


def _h_clamp_min(L, n, x, lo):
    return L.b.emit("bin", L.atom(x), L.atom(lo), "max")


def _h_clamp_max(L, n, x, hi):
    return L.b.emit("bin", L.atom(x), L.atom(hi), "min")


def _h_hardtanh(L, n, x, lo=-1.0, hi=1.0):
    return L.b.emit("clamp", ("l", float(lo)), L.atom(x), ("l", float(hi)))


def _h_where(L, n, cond, a, b):
    return L.b.emit("select", L.atom(cond), L.atom(b), L.atom(a))


def _h_to_copy(L, n, x, **kw):
    dst = n.meta["val"].dtype
    if not (dst.is_floating_point or dst == torch.bool):
        raise FusionError("float->int conversion")
    if dst == torch.bool:
        raise FusionError("cast to bool not fusable")
    return L.b.emit("cast", L.atom(x), _dtype(x) == torch.bool)


def _h_expand(L, n, x, *args, **kw):
    B = L.b.B
    to_shape = _shape(n)
    to_k = _kind(to_shape, B)
    if to_k == "mat":
        raise FusionError(f"broadcast to mat {to_shape}")
    src_shape = _shape(x)
    if len(to_shape) >= 3 or len(src_shape) >= 3:
        src_k = _kind(src_shape, B)
        src_rows = 0 if src_k == "scalar" else src_k[0]
        if src_k != "scalar" and src_rows not in (1, to_k[0]):
            raise FusionError(
                f"broadcast {src_shape} -> {to_shape} tiles feature rows "
                "(outside the flatten-to-features subset)")
    return L.b.emit("bcast", L.atom(x), to_k)


def _h_reshape(L, n, x, *args, **kw):
    B = L.b.B
    from_k = _kind(_shape(x), B)
    to_k = _kind(_shape(n), B)
    if from_k == "mat" or to_k == "mat":
        raise FusionError("reshape through mat layout")
    if from_k != "scalar" and to_k != "scalar" and from_k != to_k:
        raise FusionError(f"reshape {_shape(x)} -> {_shape(n)} changes "
                          "block layout")
    return L.b.emit("reshape", L.atom(x), to_k)


def _h_cat(L, n, tensors, dim=0):
    B = L.b.B
    shapes = [_shape(v) for v in tensors]
    rank = len(shapes[0]) if shapes else 1
    dim = _norm_dim(int(dim), rank)
    ok = all(len(s) >= 2 and s[0] == B for s in shapes) and dim == 1
    ok = ok or (all(len(s) == 1 and s[0] != B for s in shapes) and dim == 0)
    ok = ok or (B == 1 and dim == 1
                and all(len(s) >= 2 and s[0] == 1 for s in shapes))
    if not ok:
        raise FusionError(f"cat dim={dim} shapes={shapes}")
    return L.b.emit("concat", tuple(L.atom(v) for v in tensors))


def _slice_rows(L, x, dim: int, start: int, end: int):
    """Feature-axis row range [r0, r1) of a slice of x along `dim`, with
    the reference's rejections (jaxpr_bridge.py:544-589)."""
    B = L.b.B
    shape = _shape(x)
    k = _kind(shape, B)
    if k == "scalar" or k == "mat":
        raise FusionError(f"slice of {shape} unsupported")
    dim = _norm_dim(dim, len(shape))
    size = shape[dim]
    start = 0 if start is None else start
    end = size if end is None else end
    start = min(max(_norm_dim(start, size) if start < 0 else start, 0), size)
    end = min(max(_norm_dim(end, size) if end < 0 else end, 0), size)
    if (start, end) == (0, size):
        return None
    if len(shape) >= 3:
        if dim == 0 and B != 1:
            raise FusionError("slice along the batch axis")
        if dim != 1:
            raise FusionError(
                f"inner-axis slice of {shape} (flatten-to-features keeps "
                "rows contiguous only for outermost-feature slices)")
        inner = math.prod(shape[2:])
        return start * inner, end * inner
    if len(shape) == 1:
        if shape[0] == B and B != 1:
            raise FusionError("slice along the batch axis")
        return start, end
    if shape[0] == B and B != 1:
        if dim == 0:
            raise FusionError("slice along the batch axis")
        return start, end
    if shape[0] == 1:
        if dim == 0:
            raise FusionError(f"slice along axis 0 of {shape}")
        return start, end
    if dim == 1:
        raise FusionError(f"slice along axis 1 of {shape}")
    return start, end


def _h_slice(L, n, x, dim=0, start=None, end=None, step=1):
    if step != 1:
        raise FusionError("strided slice unsupported")
    a = L.atom(x)
    rows = _slice_rows(L, x, int(dim), start, end)
    if rows is None:
        return a
    if a[0] == "l":
        raise FusionError("slice of a literal")
    return L.b.emit("slice", a, rows[0], rows[1])


def _h_narrow(L, n, x, dim, start, length):
    return _h_slice(L, n, x, dim, start, int(start) + int(length))


def _h_select(L, n, x, dim, index):
    """x.select(dim, i) (y[:, i]): the row slice i:i+1, whose block is the
    result's."""
    shape = _shape(x)
    index = _norm_dim(int(index), shape[_norm_dim(int(dim), len(shape))])
    if len(_shape(n)) == 0:
        raise FusionError(f"select to a scalar from {shape}")
    return _h_slice(L, n, x, dim, index, index + 1)


def _h_flip(L, n, x, dims):
    B = L.b.B
    shape = _shape(x)
    dims = tuple(_norm_dim(int(d), len(shape)) for d in dims)
    if len(shape) >= 3:
        raise FusionError(f"flip of {shape} unsupported (a rank-3 axis flip "
                          "permutes flattened feature rows)")
    k = _kind(shape, B)
    if k == "scalar" or k == "mat":
        raise FusionError(f"flip of {shape} unsupported")
    if len(shape) == 1:
        feat = 0 if shape[0] != B or B == 1 else None
    elif shape[0] == B and B != 1:
        feat = 1
    elif shape[1] == 1:
        feat = 0
    else:
        feat = 1
    if feat is None or dims != (feat,):
        raise FusionError(f"flip over dims {dims} of {shape} (only "
                          "feature-axis flips fuse)")
    a = L.atom(x)
    if a[0] == "l":
        raise FusionError("flip of a literal")
    return L.b.emit("rev", a, k[0])


def _reduce(L, n, x, axes, prim: str, out_shape):
    """jaxpr_bridge.py:491-542 on aten's reductions; prim is 'sum', 'max'
    or 'min'."""
    B = L.b.B
    shape = _shape(x)
    k = _kind(shape, B)
    if k == "scalar" or k == "mat":
        raise FusionError(f"reduce over {shape}")
    if _kind(tuple(out_shape), B) == "mat":
        raise FusionError(f"reduce over {shape} axes {axes} leaves a "
                          "mat-layout result")
    r, c = k
    axes = tuple(_norm_dim(int(ax), len(shape)) for ax in axes)
    eff = tuple(ax for ax in axes if shape[ax] != 1)
    if len(shape) >= 3:
        lead = 1 if shape[0] in (B, 1) else 0
        feat = {i for i in range(lead, len(shape)) if shape[i] != 1}
        if eff and not feat.issubset(set(eff)):
            raise FusionError(f"partial feature reduce over {shape} axes "
                              f"{axes}")
    a = L.atom(x)
    if not eff:
        return a
    to_scalar = _kind(tuple(out_shape), B) == "scalar"
    if c == B and B != 1 and 0 in eff:
        L.b.batch_coupled = True
        if prim == "sum":
            return L.b.emit("bsum", a, r, to_scalar)
        return L.b.emit("bmax", a, r, to_scalar, prim == "min")
    return L.b.emit("reduce", a, prim, to_scalar)


def _axes(x, dims):
    rank = len(_shape(x))
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return tuple(range(rank))
    if isinstance(dims, int):
        return (dims,)
    return tuple(dims)


def _h_sum(L, n, x, dims=None, keepdim=False, **kw):
    if kw.get("dtype") is not None:
        raise FusionError("sum(dtype=...) not fusable")
    return _reduce(L, n, x, _axes(x, dims), "sum", _shape(n))


def _h_mean(L, n, x, dims=None, keepdim=False, **kw):
    if kw.get("dtype") is not None:
        raise FusionError("mean(dtype=...) not fusable")
    shape = _shape(x)
    axes = _axes(x, dims)
    count = math.prod(shape[_norm_dim(int(ax), len(shape))] for ax in axes)
    s = _reduce(L, n, x, axes, "sum", _shape(n))
    return L.b.emit("bin", s, ("l", float(count)), "div")


def _h_amax(L, n, x, dims=(), keepdim=False):
    return _reduce(L, n, x, _axes(x, dims), "max", _shape(n))


def _h_amin(L, n, x, dims=(), keepdim=False):
    return _reduce(L, n, x, _axes(x, dims), "min", _shape(n))


def _h_max(L, n, x, *args, **kw):
    return _h_extremum(L, n, x, "max", *args, **kw)


def _h_min(L, n, x, *args, **kw):
    return _h_extremum(L, n, x, "min", *args, **kw)


def _h_extremum(L, n, x, prim, *args, **kw):
    if args and isinstance(args[0], torch.fx.Node):       # max(a, b)
        return L.b.emit("bin", L.atom(x), L.atom(args[0]), prim)
    vals = n.meta["val"]
    if isinstance(vals, (tuple, list)):                    # max.dim
        for user in n.users:
            if user.target is operator.getitem and user.args[1] != 0 \
                    and user.users:
                raise FusionError(f"{prim}.dim indices not fusable")
        dim = args[0] if args else kw["dim"]
        v = _reduce(L, n, x, (dim,), prim, tuple(vals[0].shape))
        return (v, None)
    return _reduce(L, n, x, _axes(x, None), prim, _shape(n))


def _transposed_const(L, x):
    a = L.atom(x)
    ci = L.const_index(a)
    if ci is None:
        raise FusionError("transpose of a computed value unsupported (write "
                          "the contraction with @ against a weight)")
    return ("v", L.b.add_const(L.b.consts[ci].t()))


def _h_t(L, n, x):
    if len(_shape(x)) < 2:
        return L.atom(x)
    return _transposed_const(L, x)


def _h_transpose(L, n, x, d0, d1):
    rank = len(_shape(x))
    if rank != 2 or {_norm_dim(d0, 2), _norm_dim(d1, 2)} != {0, 1}:
        raise FusionError("transpose of rank != 2 unsupported")
    return _transposed_const(L, x)


def _h_permute(L, n, x, dims):
    if tuple(_norm_dim(int(d), 2) for d in dims) != (1, 0):
        raise FusionError(f"permute {dims} unsupported")
    return _transposed_const(L, x)


def _dot(L, lhs, rhs):
    """lhs [B, din] @ rhs, rhs a constant [din, dout] weight
    (jaxpr_bridge.py:641)."""
    B = L.b.B
    lshape, rshape = _shape(lhs), _shape(rhs)
    if not (len(lshape) == 2 and lshape[0] == B):
        raise FusionError(f"dot lhs {lshape} unsupported (need batch-major "
                          "[B, din] @ weights)")
    din = lshape[1]
    if len(rshape) != 2 or rshape[0] != din:
        raise FusionError(f"dot rhs {rshape} does not take {din} inputs")
    dout = rshape[1]
    ra = L.atom(rhs)
    ci = L.const_index(ra)
    if ci is None:
        raise FusionError("dot rhs must be a closed-over weight tensor "
                          "(computed weights unsupported)")
    L.b.set_const_layout(ci, ("wT", din, dout, True))
    la = L.atom(lhs)
    if la[0] == "l":
        raise FusionError("literal dot lhs")
    mxu = _layer_uses_mxu(L.b.matmul, din, dout)
    return L.b.emit("dot", la[1], ci, din, dout, mxu)


def _h_mm(L, n, a, b):
    return _dot(L, a, b)


def _h_addmm(L, n, bias, a, b, beta=1, alpha=1):
    if beta != 1 or alpha != 1:
        raise FusionError("addmm with beta/alpha not fusable")
    return L.b.emit("bin", _dot(L, a, b), L.atom(bias), "add")


def _h_full(L, n, size, value, **kw):
    return L._lit_block(float(value), _shape(n))


def _h_fill_like(value):
    def h(L, n, x, *args, **kw):
        return L._lit_block(value, _shape(n))
    return h


def _h_full_like(L, n, x, value, **kw):
    return L._lit_block(float(value), _shape(n))


def _h_const_shape(value):
    def h(L, n, size, *args, **kw):
        return L._lit_block(value, _shape(n))
    return h


def _h_scalar_tensor(L, n, value, **kw):
    return ("l", float(value))


_HANDLERS = {
    **{k: _h_alias for k in _ALIAS},
    **{k: _h_un for k in _UN_ATEN},
    **{k: _h_bin for k in _BIN_ATEN},
    "round": _h_round, "rsub": _h_rsub, "pow": _h_pow, "square": _h_square,
    "reciprocal": _h_reciprocal, "relu": _h_relu, "silu": _h_silu,
    "gelu": _h_gelu, "softplus": _h_softplus, "elu": _h_elu,
    "leaky_relu": _h_leaky_relu, "clamp": _h_clamp, "clip": _h_clamp,
    "clamp_min": _h_clamp_min, "clamp_max": _h_clamp_max,
    "hardtanh": _h_hardtanh, "where": _h_where, "_to_copy": _h_to_copy,
    "expand": _h_expand, "broadcast_to": _h_expand,
    "view": _h_reshape, "_unsafe_view": _h_reshape, "reshape": _h_reshape,
    "unsqueeze": _h_reshape, "squeeze": _h_reshape, "flatten": _h_reshape,
    "cat": _h_cat, "concat": _h_cat, "slice": _h_slice, "narrow": _h_narrow,
    "select": _h_select, "flip": _h_flip, "sum": _h_sum, "mean": _h_mean,
    "amax": _h_amax, "amin": _h_amin, "max": _h_max, "min": _h_min,
    "t": _h_t, "transpose": _h_transpose, "permute": _h_permute,
    "mm": _h_mm, "addmm": _h_addmm, "full": _h_full,
    "zeros_like": _h_fill_like(0.0), "ones_like": _h_fill_like(1.0),
    "full_like": _h_full_like, "zeros": _h_const_shape(0.0),
    "ones": _h_const_shape(1.0), "new_zeros": _h_fill_like(0.0),
    "new_ones": _h_fill_like(1.0), "scalar_tensor": _h_scalar_tensor,
}


def _used_vids(instrs, out_id: int) -> set:
    used = {out_id}
    for ins in instrs:
        if ins[0] == "dot":
            used.add(ins[2])
            continue
        for x in ins[2:]:
            if isinstance(x, tuple):
                if len(x) == 2 and x[0] == "v":
                    used.add(x[1])
                else:
                    for y in x:
                        if isinstance(y, tuple) and len(y) == 2 \
                                and y[0] == "v":
                            used.add(y[1])
    return used


def build_plan(func: Callable, t0, y0: Tensor, matmul: str = "auto",
               out_dim: int = None) -> Tuple[FusedPlan, list]:
    """Trace func(t, y) on the [B, D] batch-major state into a FusedPlan.

    Returns (plan, consts): the constants the function closes over, in
    plan order, each its differentiable source: the user's tensor itself
    (a module parameter, a captured tensor), or its `.t()` where the
    function transposes a weight. A 0-d tensor that requires grad is a
    'scalar' constant, every other 0-d tensor a literal of the plan.
    Raises FusionError when the dynamics fall outside the fusable subset.
    `out_dim` permits a rectangular plan (output [B, out_dim])."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if not isinstance(y0, Tensor) or y0.ndim != 2:
        raise FusionError(f"y0 must be [batch, dim], got "
                          f"{tuple(getattr(y0, 'shape', ()))}")
    if matmul not in ("vpu", "mxu", "auto"):
        raise ValueError(f"matmul must be 'vpu', 'mxu' or 'auto', got "
                         f"{matmul!r}")
    B, D = y0.shape
    y0 = y0.detach()
    t0 = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device).detach()
    try:
        with torch.no_grad():
            gm = make_fx(lambda tt, yy: func(tt, yy))(t0, y0)
    except FusionError:
        raise
    except Exception as e:                                 # noqa: BLE001
        raise FusionError(f"tracing failed: {e}") from e

    builder = _PlanBuilder(B, D, matmul)
    t_id = builder.new_val()
    y_id = builder.new_val()
    out_id, out_shape = _Lowering(builder, gm).run(t_id, y_id)
    D_out = D if out_dim is None else int(out_dim)
    if out_shape != (B, D_out):
        raise FusionError(f"func output shape {out_shape} != expected "
                          f"{(B, D_out)}")
    used = _used_vids(builder.instrs, out_id)
    for ci, lay in enumerate(builder.const_layouts):
        if (lay is not None and lay[0] == "wT"
                and builder.const_ids[ci] in used):
            raise FusionError("const used both as a dot weight and "
                              "elementwise; not fusable")
    builder.finalize_default_layouts(used)
    plan = FusedPlan(
        instrs=tuple(builder.instrs), n_vals=builder.n_vals,
        const_layouts=tuple(builder.const_layouts),
        const_val_ids=tuple(builder.const_ids), t_id=t_id, y_id=y_id,
        out_id=out_id, batch=B, dim=D, matmul=matmul,
        dim_out=(-1 if out_dim is None else D_out),
        batch_coupled=builder.batch_coupled)
    return plan, builder.consts


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

def pack_consts(plan: FusedPlan, consts: Sequence[Tensor], dtype,
                device=None, differentiable: bool = False) -> list:
    """The traced constants in the plan's layouts (jaxpr_bridge.py:764),
    unpadded: 'wT' [dout, din], 'col' [d, 1], 'scalar' 0-d, 'batch' [d, B],
    'bvec' [1, B], 'unused' an empty tensor.

    Detached, unless `differentiable`: then each packed constant keeps
    autograd's path back to its source in `consts`, so the cotangents of
    the packed constants (K15's dconsts) reach the user's tensors, and a
    tensor packed twice (a tied weight) sums its two cotangents, as JAX's
    transpose of the packing does in the reference."""
    out = []
    for layout, c in zip(plan.const_layouts, consts):
        c = torch.as_tensor(c)
        if not differentiable:
            c = c.detach()
        c = c.to(device=device, dtype=dtype)
        tag = layout[0]
        if tag == "wT":
            _, din, dout, transpose = layout
            out.append((c.t() if transpose else c).contiguous())
        elif tag == "col":
            out.append(c.reshape(layout[1], 1))
        elif tag == "scalar":
            out.append(c.reshape(()))
        elif tag == "bvec":
            out.append(c.reshape(1, -1))
        elif tag == "batch":
            out.append(c.reshape(c.shape[0], layout[1]).t().contiguous())
        elif tag == "unused":
            out.append(c.detach().new_zeros(0))
        else:                                      # pragma: no cover
            raise FusionError(f"unknown const layout {layout}")
    return out


# ---------------------------------------------------------------------------
# What K15 (the plan's reverse walk) takes
# ---------------------------------------------------------------------------

def _instr_in_vids(ins) -> list:
    """Value ids an instruction reads (not literals nor dot weights)."""
    op = ins[0]
    if op == "litv":
        return []
    if op == "dot":
        return [ins[2]]
    if op == "concat":
        return [a[1] for a in ins[2] if a[0] == "v"]
    return [x[1] for x in ins[2:]
            if isinstance(x, tuple) and len(x) == 2 and x[0] == "v"]


def plan_uses_t(plan: FusedPlan) -> bool:
    """Whether the plan's output depends on the time input (the adjoint
    then integrates the a_t quadrature; plan_adjoint.py:80)."""
    live = {plan.t_id}
    for ins in plan.instrs:
        if any(v in live for v in _instr_in_vids(ins)):
            live.add(ins[1])
    return plan.out_id in live


#: Unary ops whose gradient is zero (the reverse walk drops the cotangent).
ZERO_GRAD_UN = frozenset({"sign", "floor", "ceil", "round", "stop_gradient",
                          "not"})
#: Unary ops with a gradient rule (ops/plan_adjoint.py _UN_GRADS).
GRAD_UN = frozenset({"neg", "exp", "log", "log1p", "tanh", "logistic", "sin",
                     "cos", "sqrt", "rsqrt", "abs", "copy", "expm1", "cosh",
                     "sinh", "erf", "erfc", "tan", "asinh", "acosh",
                     "atanh"})
#: Comparisons and logical ops: no gradient flows.
NO_GRAD_BIN = frozenset({"and", "or", "xor", "gt", "lt", "ge", "le", "eq",
                         "ne"})


def check_plan_adjoint(plan: FusedPlan) -> None:
    """Raise FusionError when the plan holds an instruction the reverse
    walk cannot differentiate (plan_adjoint.py:126): a feature-axis max or
    min (argmax routing), a full (to-scalar) feature reduction, a unary op
    without a gradient rule. The front ends then fall back."""
    for ins in plan.instrs:
        op = ins[0]
        if op == "reduce" and ins[3] in ("max", "min"):
            raise FusionError(
                "fused adjoint through reduce_max/reduce_min is "
                "unsupported (argmax routing); use the generic backward")
        if op == "reduce" and ins[4]:
            raise FusionError(
                "fused adjoint through a full (to-scalar) reduction is "
                "unsupported; use the generic backward")
        if op == "un" and ins[3] not in GRAD_UN \
                and ins[3] not in ZERO_GRAD_UN:
            raise FusionError(
                f"fused adjoint has no gradient rule for {ins[3]!r}")


def _true_elems(plan: FusedPlan) -> int:
    """Elements of every constant's cotangent quadrature: the parameter
    share of the adjoint's error-norm denominator (plan_adjoint.py:444)."""
    n = 0
    for layout in plan.const_layouts:
        tag = layout[0]
        if tag == "wT":
            n += layout[1] * layout[2]
        elif tag == "col":
            n += layout[1]
        elif tag == "scalar":
            n += 1
        elif tag == "bvec":
            n += plan.batch
        elif tag == "batch":
            n += layout[1] * plan.batch
    return n


# ---------------------------------------------------------------------------
# K14's plain version
# ---------------------------------------------------------------------------

def _materialize(v: Tensor, rows: int, cols: int) -> Tensor:
    if v.ndim == 0:
        return v.expand(rows, cols)
    return v.expand(rows, max(cols, v.shape[1]))


def _batch_sums(v: Tensor, threads: int) -> Tensor:
    """Row sums of v [r, B] over the batch in K2's block order: thread i
    adds samples i, i + threads, ... from 0, then `_tree_sum` across the
    threads. Returns [r, 1]."""
    r, B = v.shape
    K = -(-B // threads)
    v = torch.nn.functional.pad(v, (0, K * threads - B)).view(r, K, threads)
    acc = torch.zeros((r, threads), dtype=v.dtype, device=v.device)
    for k in range(K):
        acc = acc + v[:, k, :]
    return _tree_sum(acc)[:, None]


def _row_fold(v: Tensor, fn) -> Tensor:
    """v's rows folded in row order: fn(fn(v0, v1), v2) ..., [1, cols]."""
    acc = v[0:1]
    for i in range(1, v.shape[0]):
        acc = fn(acc, v[i:i + 1])
    return acc


def eval_plan(plan: FusedPlan, cvals: Sequence[Tensor], t, y: Tensor,
              threads: int = SOLVE_THREADS,
              dot_precision: str = "highest") -> list:
    """Walk the plan on y [D, B] (feature-major) at time t (0-d, or a
    [1, B] row of per-sample times); returns the environment (value id ->
    0-d tensor or [rows, 1 or B] block). cvals: `pack_consts`' output.
    A batch sum adds in the order of a block of `threads` threads (K2's).
    Literals become 0-d tensors on y's device, so that PyTorch divides
    and compares as the kernels do. dot_precision ('mixed', 'bf16') is K4's
    tier at every dot whose `mxu` flag is set (`cuda_kernels.
    dot_tier_plain`, reference jaxpr_bridge.py:979-983); every other dot
    sums its inputs in order."""
    check_dot_precision(dot_precision)
    dev, dtype = y.device, y.dtype
    B = y.shape[1]
    lit = {}

    def get(a):
        if a[0] == "l":
            v = lit.get(a[1])
            if v is None:
                v = lit[a[1]] = torch.tensor(a[1], dtype=dtype, device=dev)
            return v
        return env[a[1]]

    env: List[Any] = [None] * plan.n_vals
    env[plan.t_id] = torch.as_tensor(t, dtype=dtype).to(dev)
    env[plan.y_id] = y
    for cidx, vid in enumerate(plan.const_val_ids):
        if plan.const_layouts[cidx][0] not in ("wT", "unused"):
            env[vid] = cvals[cidx]

    for ins in plan.instrs:
        op, out = ins[0], ins[1]
        if op == "litv":
            env[out] = torch.tensor(ins[2], dtype=dtype, device=dev)
        elif op == "un":
            env[out] = _UN_PLAIN[ins[3]](get(ins[2]))
        elif op == "bin":
            env[out] = _BIN_PLAIN[ins[4]](get(ins[2]), get(ins[3]))
        elif op == "ipow":
            x, m = get(ins[2]), abs(ins[3])
            if m == 0:
                env[out] = torch.ones_like(x)
                continue
            acc = x
            for _ in range(m - 1):
                acc = acc * x
            env[out] = get(("l", 1.0)) / acc if ins[3] < 0 else acc
        elif op == "clamp":
            lo, x, hi = get(ins[2]), get(ins[3]), get(ins[4])
            env[out] = torch.minimum(torch.maximum(x, lo), hi)
        elif op == "select":
            pred, c0, c1 = get(ins[2]), get(ins[3]), get(ins[4])
            env[out] = torch.where(pred != 0, c1, c0)
        elif op == "cast":
            v = get(ins[2])
            env[out] = v.to(dtype) if ins[3] else v
        elif op == "bcast":
            v, to_k = get(ins[2]), ins[3]
            if to_k == "scalar":
                env[out] = v
            else:
                rows, cols = to_k
                cols = B if cols == plan.batch and plan.batch != 1 else cols
                env[out] = _materialize(v.to(dtype), rows, cols)
        elif op == "reshape":
            v, to_k = get(ins[2]), ins[3]
            if to_k != "scalar" and v.ndim == 0:
                v = v.reshape(1, 1)
            env[out] = v
        elif op == "concat":
            blocks = [get(a) for a in ins[2]]
            blocks = [b.reshape(1, 1) if b.ndim == 0 else b for b in blocks]
            cols = max(b.shape[1] for b in blocks)
            env[out] = torch.cat([_materialize(b, b.shape[0], cols)
                                  for b in blocks], dim=0)
        elif op == "slice":
            env[out] = get(ins[2])[ins[3]:ins[4], :]
        elif op == "rev":
            env[out] = torch.flip(get(ins[2]), dims=(0,))
        elif op == "reduce":
            v = get(ins[2])
            fn = _FOLD[ins[3]]
            s = _row_fold(v, fn)
            env[out] = s.reshape(()) if ins[4] else s
        elif op == "bsum":
            v = _materialize(get(ins[2]), ins[3], B)
            s = _batch_sums(v, threads)
            env[out] = _row_fold(s, torch.add).reshape(()) if ins[4] else s
        elif op == "bmax":
            v = _materialize(get(ins[2]), ins[3], B)
            red = torch.amin if ins[5] else torch.amax
            s = red(v, dim=1, keepdim=True)
            env[out] = red(s).reshape(()) if ins[4] else s
        elif op == "dot":
            _, _, a_id, cidx, din, dout, mxu = ins
            wT = cvals[cidx]
            h = _materialize(env[a_id], din, 1)
            if mxu and dot_precision != "highest":
                env[out] = dot_tier_plain(wT, h.t(), dot_precision).t()
                continue
            acc = None
            for i in range(din):
                term = wT[:, i:i + 1] * h[i:i + 1, :]
                acc = term if acc is None else acc + term
            env[out] = acc
        else:                                      # pragma: no cover
            raise AssertionError(f"bad instr {op}")
    return env


def eval_plan_host(plan: FusedPlan, cvals: Sequence[Tensor], t,
                   y: Tensor, threads: int = SOLVE_THREADS,
                   dot_precision: str = "highest") -> Tensor:
    """f(t, y) of the plan on the batch-major y [B, D]: [B, out_rows] (the
    counterpart of `eval_plan_xla`, jaxpr_bridge.py:1013; the front ends'
    f0, first-step probe and the plain kernels' right-hand side). t is 0-d,
    or a [1, B] row of per-sample times; dot_precision as in
    `eval_plan`."""
    env = eval_plan(plan, cvals, t, y.t(), threads, dot_precision)
    return _materialize(env[plan.out_id], plan.out_rows, y.shape[0]).t()


def check_dot_precision(dot_precision: str) -> None:
    if dot_precision not in ("highest", "bf16", "mixed"):
        raise ValueError(f"dot_precision must be 'highest', 'bf16' or "
                         f"'mixed', got {dot_precision!r}")


def tiered_dots(plan: FusedPlan, dot_precision: str) -> int:
    """The dots a plan runs at a reduced tier: those whose `mxu` flag is
    set, none at 'highest'."""
    if dot_precision == "highest":
        return 0
    return sum(1 for ins in plan.instrs if ins[0] == "dot" and ins[6])


def _logistic(x: Tensor) -> Tensor:
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


def _as_value(fn):
    """A predicate as the kernels hold it: 1 or 0 in the state's dtype."""
    def op(*xs):
        dtype = next(x.dtype for x in xs if x.is_floating_point())
        return fn(*xs).to(dtype)
    return op


#: The plain versions of the unary ops: PyTorch's own functions.
_UN_PLAIN = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log,
    "log1p": torch.log1p, "tanh": torch.tanh, "logistic": _logistic,
    "sin": torch.sin, "cos": torch.cos, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "abs": torch.abs, "sign": torch.sign,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "stop_gradient": lambda x: x, "copy": lambda x: x,
    "expm1": torch.expm1, "cosh": torch.cosh, "sinh": torch.sinh,
    "not": _as_value(torch.logical_not), "erf": torch.erf,
    "erfc": torch.erfc, "tan": torch.tan, "asinh": torch.asinh,
    "acosh": torch.acosh, "atanh": torch.atanh,
}
_BIN_PLAIN = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "max": torch.maximum, "min": torch.minimum, "pow": torch.pow,
    **{k: _as_value(fn) for k, fn in (
        ("and", torch.logical_and), ("or", torch.logical_or),
        ("xor", torch.logical_xor), ("gt", torch.gt), ("lt", torch.lt),
        ("ge", torch.ge), ("le", torch.le), ("eq", torch.eq),
        ("ne", torch.ne))},
}
_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}
