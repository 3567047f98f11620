"""Generate K14's CUDA C++ from a plan: the right-hand side of the plan
hosts K2, K8, K5, K10, K11 and, two plans in one source, K12
(csrc/plan_rhs.cuh).

No reference counterpart: the reference interprets its plan inside the
Pallas kernel, and Mosaic unrolls the walk per plan structure
(`tfdiffeq_tpu/ops/jaxpr_bridge.py:826`). Here the walk is written out as
C++ once per structure and compiled with nvcc (`_build.plan_library`).

The plan (`plan_bridge.FusedPlan`) is cut into segments at its batch
couplings ('bsum', 'bmax'); a plan without one is one segment. Segment k is
a function `seg<k>(t, y, c, sc, b, B, live, red, out)` that evaluates the
plan for one sample b: every value of r rows is a local array `T v<id>[r]`
filled by loops of constant trip count; inputs are read where they lie
(y the sample's D inputs, the constants c, the per-sample constants sc as
[rows][B], the reduced values red); values that outlive their segment, and
each coupling's input rows, are stored to the workspace rows `live`
([rows][B]); the last segment writes the out_rows outputs. A segment holds
no shared memory, barrier or intrinsic, so it also compiles as host C++
(`host_source`, which the codegen tests load with ctypes). Dots sum
w[o][0] h[0] + w[o][1] h[1] + ... in input order (the reference's VPU
order, jaxpr_bridge.py:991-994; `--fmad=false` keeps each product and sum
separately rounded), reductions fold rows in order, exactly as
`plan_bridge.eval_plan` does.

Beside the segments, an uncoupled plan gets a group walk (`Plan::
group_walk`, `PlanAug::group_walk`): one sample's walk split over the gsz
members of its group in K5, K8, K6 and K9. Each value's rows lie in the
sample's scratch `gs`; row i of a value is computed by member i % gsz, by
the same expression as in the per-thread walk; a 1-row value, a reduction
and a fold into one row by member 0; a dot's outputs o = m, m + gsz, ...
(its weights read from a transposed copy of the constants) and a VJP
dot's inputs likewise, each the same sum in the same order. So every row
has the per-thread walk's bits. The walk is cut into phases, a group sync
between them, where an instruction reads a row that another member wrote
(the host's stage state counting as written); each phase is a function
of (m, gsz), so a host can run the members in turn. A value's region of
`gs` is reused by a later one once a sync separates their phases
(`_group_walk`).

The source depends on the plan's structure and literals alone: not on the
batch size (a runtime argument) nor on the constants' values (a runtime
array), so equal structures share one library at any B, unless the
function itself computes with B (a batch mean divides by it, a literal of
the plan).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Sequence, Tuple

import torch

from .plan_bridge import FusedPlan, FusionError

Tensor = torch.Tensor

#: Host kernels a plan runs in: K2 (one controller), K8 (fixed grid), K5
#: (a controller a sample), K10 (fixed-step Adams), K11 (VCABM); its
#: reverse walk (K15) in K3 (one controller), K6 (a controller a sample)
#: and K9 (fixed grid).
HOSTS = ("solve", "fixed", "perlane", "adams", "vcabm")
AUG_HOSTS = ("adjoint", "perlane_adjoint", "fixed_adjoint")
#: K12 (csrc/rk_hyper.cuh): two plans in one source, the dynamics `Plan`
#: and the correction net `PlanG`.
HYPER_HOST = "hyper"
#: The hosts that run a coupled plan, on one block: its segments batch-wide
#: with a block meet at each coupling (csrc/plan_rhs.cuh PlanBatchRhs in K2,
#: PlanBlockRhs in K8, K10 and K11; csrc/plan_aug.cuh PlanBatchAugRhs in K3
#: and K9). The group walks of K5, K6 and K12 take uncoupled plans only.
COUPLED_HOSTS = ("solve", "fixed", "adams", "vcabm", "adjoint",
                 "fixed_adjoint")
#: The hosts that run a plan at a reduced dot_precision, over tiles of 16
#: rows with K4's product at each tiered dot (csrc/plan_rhs.cuh
#: PlanTileRhs): K2, K8 and K5's tile engine.
TIER_HOSTS = ("solve", "fixed", "perlane")

_UN_FN = {"exp": "p_exp", "log": "p_log", "log1p": "p_log1p",
          "tanh": "p_tanh", "logistic": "p_logistic", "sin": "p_sin",
          "cos": "p_cos", "tan": "p_tan", "sqrt": "p_sqrt",
          "rsqrt": "p_rsqrt", "abs": "p_abs", "sign": "p_sign",
          "floor": "p_floor", "ceil": "p_ceil", "round": "p_round",
          "expm1": "p_expm1", "cosh": "p_cosh", "sinh": "p_sinh",
          "erf": "p_erf", "erfc": "p_erfc", "asinh": "p_asinh",
          "acosh": "p_acosh", "atanh": "p_atanh"}
_BIN_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
_BIN_CMP = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==",
            "ne": "!="}
_BIN_LOGIC = {"and": "&&", "or": "||", "xor": "!="}


@dataclasses.dataclass(frozen=True)
class PlanLayout:
    """What a launch sizes from the plan: the flat constants' count, the
    segments, the live rows of B values and the reduced values
    (csrc/plan_rhs.cuh PlanBatchRhs' workspace), and at a reduced tier the
    tiered dots and their bf16 weights (PlanTileRhs)."""
    n_consts: int
    segments: int
    live_rows: int
    red_values: int
    tier_dots: int = 0
    w16_values: int = 0


def value_rows(plan: FusedPlan) -> List[int]:
    """Rows of every value of the plan for one sample (1 for scalars)."""
    rows = [1] * plan.n_vals
    rows[plan.y_id] = plan.dim
    for cidx, vid in enumerate(plan.const_val_ids):
        lay = plan.const_layouts[cidx]
        rows[vid] = lay[1] if lay[0] in ("col", "batch") else 1

    def r(a):
        return 1 if a[0] == "l" else rows[a[1]]

    for ins in plan.instrs:
        op, out = ins[0], ins[1]
        if op == "litv" or op == "reduce":
            rows[out] = 1
        elif op in ("un", "ipow", "cast"):
            rows[out] = r(ins[2])
        elif op == "bin":
            rows[out] = max(r(ins[2]), r(ins[3]))
        elif op in ("clamp", "select"):
            rows[out] = max(r(ins[2]), r(ins[3]), r(ins[4]))
        elif op in ("bcast", "reshape"):
            rows[out] = r(ins[2]) if ins[3] == "scalar" else ins[3][0]
        elif op == "concat":
            rows[out] = sum(r(a) for a in ins[2])
        elif op == "slice":
            rows[out] = ins[4] - ins[3]
        elif op == "rev":
            rows[out] = ins[3]
        elif op in ("bsum", "bmax"):
            rows[out] = 1 if ins[4] else ins[3]
        elif op == "dot":
            rows[out] = ins[5]
        else:                                      # pragma: no cover
            raise AssertionError(f"bad instr {op}")
    return rows


def _const_layout(plan: FusedPlan):
    const_off, sample_off = {}, {}
    n, s = 0, 0
    for cidx, lay in enumerate(plan.const_layouts):
        tag = lay[0]
        if tag == "wT":
            const_off[cidx] = n
            n += lay[1] * lay[2]
        elif tag == "col":
            const_off[cidx] = n
            n += lay[1]
        elif tag == "scalar":
            const_off[cidx] = n
            n += 1
        elif tag == "batch":
            sample_off[cidx] = s
            s += lay[1]
        elif tag == "bvec":
            sample_off[cidx] = s
            s += 1
    return const_off, n, sample_off, s


def flat_consts(plan: FusedPlan, packed: Sequence[Tensor], B: int,
                transposed: bool = False) -> Tuple[Tensor, Tensor]:
    """`plan_bridge.pack_consts`' output as the kernels read it: one flat
    array of the shared constants (a weight [dout][din] row-major, a column,
    a scalar) and the per-sample constants as [rows, B]. Each has at least
    one element, so that its pointer is valid. With `transposed` (the group
    walks' constants) the flat array is followed by a copy of itself in
    which each weight is [din][dout] row-major, where a group's members,
    an output each, read neighbouring values."""
    ref = next((p for p in packed if p.numel()), None)
    dtype = ref.dtype if ref is not None else torch.float32
    dev = ref.device if ref is not None else None
    flat, rows = [], []
    for lay, p in zip(plan.const_layouts, packed):
        if lay[0] in ("wT", "col", "scalar"):
            flat.append(p.reshape(-1))
        elif lay[0] in ("batch", "bvec"):
            rows.append(p.reshape(-1, B))
    c = (torch.cat(flat) if flat
         else torch.zeros(1, dtype=dtype, device=dev))
    if transposed and flat:
        c = torch.cat([c] + [
            p.reshape(lay[2], lay[1]).t().reshape(-1) if lay[0] == "wT"
            else p.reshape(-1) for lay, p in zip(plan.const_layouts, packed)
            if lay[0] in ("wT", "col", "scalar")])
    sc = (torch.cat(rows, dim=0) if rows
          else torch.zeros((1, B), dtype=dtype, device=dev))
    return c.contiguous(), sc.contiguous()


class _Gen:
    """Emits the segments of one plan. With a reduced `dot_precision`, every
    dot whose `mxu` flag is set also ends a segment (a tile cut): the
    segment stores the dot's input rows to the live rows, the host's tile
    runs K4's product on them (csrc/dot_tiers.cuh plan_tile_dot) into the
    dot's own live rows, and later segments load its result from there."""

    def __init__(self, plan: FusedPlan, dot_precision: str = "highest"):
        self.plan = plan
        self.tier = dot_precision
        self.rows = value_rows(plan)
        self.const_off, self.n_consts, self.sample_off, _ = \
            _const_layout(plan)
        self.const_of_vid = {vid: ci
                             for ci, vid in enumerate(plan.const_val_ids)}
        # Segments and the cuts that end them: couplings and tiered dots.
        self.segs: List[List[tuple]] = [[]]
        self.cuts: List[tuple] = []
        for ins in plan.instrs:
            if ins[0] in ("bsum", "bmax") or (
                    ins[0] == "dot" and ins[6] and dot_precision != "highest"):
                self.cuts.append(ins)
                self.segs.append([])
            else:
                self.segs[-1].append(ins)
        self.couplings = [ins for ins in self.cuts if ins[0] != "dot"]
        self.tdots = [ins for ins in self.cuts if ins[0] == "dot"]
        self.dot_out = {ins[1] for ins in self.tdots}
        # Where each computed value is defined: its segment; a coupling's
        # result lies in `red` from the next segment on, a tiered dot's in
        # its live rows.
        self.seg_of: Dict[int, int] = {}
        self.red_off: Dict[int, int] = {}
        self.cin_row: List[int] = []
        red = 0
        for k, seg in enumerate(self.segs):
            for ins in seg:
                self.seg_of[ins[1]] = k
        for k, ins in enumerate(self.cuts):
            if ins[0] == "dot":
                self.seg_of[ins[1]] = k
                continue
            r, to_scalar = ins[3], ins[4]
            self.red_off[ins[1]] = red + (r if to_scalar else 0)
            red += r + (1 if to_scalar else 0)
        self.red_values = red
        # Values read in a later segment than their own get live rows (a
        # tiered dot's result always).
        uses: Dict[int, set] = {}
        for k, seg in enumerate(self.segs):
            for ins in seg:
                for vid in _operand_ids(ins):
                    uses.setdefault(vid, set()).add(k)
        for k, ins in enumerate(self.cuts):
            a = ("v", ins[2]) if ins[0] == "dot" else ins[2]
            if a[0] == "v":
                uses.setdefault(a[1], set()).add(k)
        uses.setdefault(plan.out_id, set()).add(len(self.segs) - 1)
        self.live_row: Dict[int, int] = {}
        live = 0
        for vid in sorted(set(uses) | self.dot_out):
            if vid in self.dot_out or (
                    vid in self.seg_of and any(k > self.seg_of[vid]
                                               for k in uses[vid])):
                self.live_row[vid] = live
                live += self.rows[vid]
        self.loads = [sorted(v for v in self.live_row
                             if k in uses.get(v, ()) and self.seg_of[v] < k)
                      for k in range(len(self.segs))]
        for ins in self.cuts:
            self.cin_row.append(live)
            live += ins[4] if ins[0] == "dot" else ins[3]
        self.live_rows = live
        # The tiered dots' bf16 weights, [pad16(dout)][pad16(din)] each.
        self.w16_off, n16 = [], 0
        for ins in self.tdots:
            self.w16_off.append(n16)
            n16 += _pad16(ins[5]) * _pad16(ins[4])
        self.n_w16 = n16

    def loop(self, n: int, stmt: str) -> str:
        """`_loop`, a long loop of a tiled plan unrolled by 8: its segments
        run a thread a sample, and the unrolled loads of the live rows keep
        several in flight."""
        return _loop(n, stmt, 8 if self.tdots else 1)

    # ---- expressions ----
    def ref(self, a, i: str) -> str:
        """Element i (a C expression) of atom a, broadcast from one row."""
        if a[0] == "l":
            return _lit(a[1])
        vid = a[1]
        plan = self.plan
        idx = i if self.rows[vid] > 1 else "0"
        if vid == plan.t_id:
            return "t"
        if vid == plan.y_id:
            return f"y[{idx}]"
        if vid in self.red_off:
            return f"red[{self.red_off[vid]} + {idx}]"
        ci = self.const_of_vid.get(vid)
        if ci is not None:
            tag = plan.const_layouts[ci][0]
            if tag in ("col", "scalar"):
                return f"c[{self.const_off[ci]} + {idx}]"
            if tag in ("batch", "bvec"):
                return (f"sc[long({self.sample_off[ci]} + {idx}) * B + b]")
            raise FusionError(f"constant {ci} ({tag}) read elementwise")
        return f"v{vid}[{idx}]"

    def segment(self, k: int, prefix: str = "plan") -> str:
        L = []
        emit = L.append
        for vid in self.loads[k]:
            r, row = self.rows[vid], self.live_row[vid]
            emit(f"  T v{vid}[{r}];")
            emit(self.loop(r, f"v{vid}[i] = live[long({row} + i) * B + b];"))
        for ins in self.segs[k]:
            self.instr(ins, emit)
        for vid in sorted(self.live_row):
            if self.seg_of[vid] == k and vid not in self.dot_out:
                r, row = self.rows[vid], self.live_row[vid]
                emit(self.loop(r, f"live[long({row} + i) * B + b] = "
                              f"v{vid}[i];"))
        if k < len(self.cuts):
            ins = self.cuts[k]
            a, r = ((("v", ins[2]), ins[4]) if ins[0] == "dot"
                    else (ins[2], ins[3]))
            emit(self.loop(r, f"live[long({self.cin_row[k]} + i) * B + b] "
                          f"= {self.ref(a, 'i')};"))
        if k == len(self.segs) - 1:
            out = ("v", self.plan.out_id)
            emit(self.loop(self.plan.out_rows,
                           f"out[i] = {self.ref(out, 'i')};"))
        body = "\n".join(L)
        return (f"template <typename T>\n"
                f"__host__ __device__ __forceinline__ void {prefix}_seg{k}(\n"
                f"    const T t, const T* __restrict__ y,\n"
                f"    const T* __restrict__ c, const T* __restrict__ sc,\n"
                f"    const int b, const int B, T* __restrict__ live,\n"
                f"    const T* __restrict__ red, T* __restrict__ out) {{\n"
                f"{body}\n}}\n")

    def elem(self, ins) -> str:
        """Row i's expression of an elementwise instruction (un, bin, ipow,
        clamp, select, cast, bcast, reshape, slice, rev)."""
        op = ins[0]
        ref = self.ref
        if op == "un":
            name, a = ins[3], ins[2]
            if name == "neg":
                return f"-{ref(a, 'i')}"
            if name in ("copy", "stop_gradient"):
                return ref(a, "i")
            if name == "not":
                return f"p_bool<T>({ref(a, 'i')} == T(0))"
            return f"{_UN_FN[name]}({ref(a, 'i')})"
        if op == "bin":
            name, a, b = ins[4], ref(ins[2], "i"), ref(ins[3], "i")
            if name in _BIN_INFIX:
                return f"{a} {_BIN_INFIX[name]} {b}"
            if name in _BIN_CMP:
                return f"p_bool<T>({a} {_BIN_CMP[name]} {b})"
            if name in _BIN_LOGIC:
                return (f"p_bool<T>(({a} != T(0)) {_BIN_LOGIC[name]} "
                        f"({b} != T(0)))")
            if name == "max":
                return f"p_max({a}, {b})"
            if name == "min":
                return f"p_min({a}, {b})"
            if name == "pow":
                return f"p_pow({a}, {b})"
            raise FusionError(f"binary op {name!r}")   # pragma: no cover
        if op == "ipow":
            x, n = ref(ins[2], "i"), ins[3]
            m = abs(n)
            e = "T(1)" if m == 0 else " * ".join([x] * m)
            return f"T(1) / ({e})" if n < 0 else e
        if op == "clamp":
            lo, x, hi = (ref(ins[j], "i") for j in (2, 3, 4))
            return f"p_min(p_max({x}, {lo}), {hi})"
        if op == "select":
            p, c0, c1 = (ref(ins[j], "i") for j in (2, 3, 4))
            return f"({p} != T(0)) ? {c1} : {c0}"
        if op in ("cast", "bcast", "reshape"):
            return ref(ins[2], "i")
        if op == "slice":
            return ref(ins[2], f"{ins[3]} + i")
        if op == "rev":
            return ref(ins[2], f"{ins[3] - 1} - i")
        raise AssertionError(f"bad instr {op}")       # pragma: no cover

    def _reduce_lines(self, ins) -> List[str]:
        a, fn, out = ins[2], ins[3], ins[1]
        r = 1 if a[0] == "l" else self.rows[a[1]]
        L = [f"  {{ T acc = {self.ref(a, '0')};"]
        step = {"sum": "acc + {x}", "max": "p_max(acc, {x})",
                "min": "p_min(acc, {x})"}[fn]
        if r > 1:
            L.append("#pragma unroll" if r <= _UNROLL_ROWS
                     else "#pragma unroll 1")
            L.append(f"    for (int i = 1; i < {r}; ++i) "
                     f"acc = {step.format(x=self.ref(a, 'i'))};")
        L.append(f"    v{out}[0] = acc; }}")
        return L

    def instr(self, ins, emit) -> None:
        op, out = ins[0], ins[1]
        R = self.rows[out]
        emit(f"  T v{out}[{R}];")
        if op == "litv":
            emit(f"  v{out}[0] = {_lit(ins[2])};")
        elif op == "concat":
            off = 0
            for a in ins[2]:
                r = 1 if a[0] == "l" else self.rows[a[1]]
                emit(self.loop(r, f"v{out}[{off} + i] = {self.ref(a, 'i')};"))
                off += r
        elif op == "reduce":
            for line in self._reduce_lines(ins):
                emit(line)
        elif op == "dot":
            _, _, a_id, cidx, din, dout, _mxu = ins
            w = self.const_off[cidx]
            h = self.ref(("v", a_id), "i")
            h0 = self.ref(("v", a_id), "0")
            # A product past _UNROLL_DOT weights runs as loops (its vectors
            # then live in local memory), which keeps ptxas quick.
            unroll = ("#pragma unroll" if din * dout <= _UNROLL_DOT
                      else "#pragma unroll 1")
            emit(unroll)
            emit(f"  for (int o = 0; o < {dout}; ++o) {{")
            emit(f"    const T* wr = c + {w} + o * {din};")
            emit(f"    T acc = wr[0] * {h0};")
            if din > 1:
                emit(unroll)
                emit(f"    for (int i = 1; i < {din}; ++i) "
                     f"acc = acc + wr[i] * {h};")
            emit(f"    v{out}[o] = acc;")
            emit("  }")
        else:
            emit(self.loop(R, f"v{out}[i] = {self.elem(ins)};"))

    def group_instr(self, ins) -> List["_GOp"]:
        """The instruction in the group walk: the same expression for
        every row as `instr`, each row computed by the member that owns
        it (row i: member i % gsz), a 1-row value and a reduction by
        member 0; a dot's outputs o = m, m + gsz, ... each the same sum in
        input order, its weights read from the transposed copy of the
        constants (`flat_consts(transposed=True)`) so that the members
        read neighbouring values."""
        op, out = ins[0], ins[1]
        R = self.rows[out]
        name = f"v{out}"
        if op == "litv":
            return [_GOp.rows(name, 0, 1, _lit(ins[2]), f"{name}[0]")]
        if op == "concat":
            ops, off = [], 0
            for a in ins[2]:
                r = 1 if a[0] == "l" else self.rows[a[1]]
                ops.append(_GOp.rows(name, off, r, self.ref(a, "i"),
                                     f"{name}[{off} + i]"))
                off += r
            return ops
        if op == "reduce":
            return [_GOp.member0(name, self._reduce_lines(ins))]
        if op == "dot":
            _, _, a_id, cidx, din, dout, _mxu = ins
            wt = self.n_consts + self.const_off[cidx]
            h = self.ref(("v", a_id), "i")
            h0 = self.ref(("v", a_id), "0")
            L = [f"  for (int o = m; o < {dout}; o += gsz) {{",
                 f"    const T* wr = c + {wt} + o;",
                 f"    T acc = wr[0] * {h0};"]
            if din > 1:
                L.append(("#pragma unroll" if din <= _UNROLL_ROWS
                          else "#pragma unroll 1"))
                L.append(f"    for (int i = 1; i < {din}; ++i) "
                         f"acc = acc + wr[i * {dout}] * {h};")
            L += [f"    {name}[o] = acc;", "  }"]
            return [_GOp(L, {name}, _GOp.reads(h0 + h) if din * dout > 1
                         else set())]
        return [_GOp.rows(name, 0, R, self.elem(ins), f"{name}[i]")]

    def meet(self) -> str:
        cases = []
        for k, ins in enumerate(self.cuts):
            if ins[0] == "dot":
                cases.append(f"    case {k}: m.dot({self.tdots.index(ins)});"
                             " break;")
                continue
            kind = 0 if ins[0] == "bsum" else (2 if ins[5] else 1)
            off = self.red_off[ins[1]] - (ins[3] if ins[4] else 0)
            cases.append(f"    case {k}: m({kind}, {self.cin_row[k]}, "
                         f"{ins[3]}, {off}, {int(ins[4])}); break;")
        body = "\n".join(cases) if cases else "    default: break;"
        return ("  template <class M>\n"
                "  __host__ __device__ static void meet(int k, M& m) {\n"
                "    switch (k) {\n" + body + "\n"
                "    default: break;\n    }\n  }\n") if cases else (
            "  template <class M>\n"
            "  __host__ __device__ static void meet(int, M&) {}\n")

    def layout(self) -> PlanLayout:
        return PlanLayout(self.n_consts, len(self.segs), self.live_rows,
                          self.red_values, len(self.tdots), self.n_w16)

    def tier_members(self) -> str:
        """The tiered dots' table (plan_ops.cuh TierDot) and the tier."""
        cases = "".join(
            f"      case {j}: return TierDot{{{ins[4]}, {ins[5]}, "
            f"{self.const_off[ins[3]]}, {self.w16_off[j]}, "
            f"{self.cin_row[self.cuts.index(ins)]}, "
            f"{self.live_row[ins[1]]}}};\n"
            for j, ins in enumerate(self.tdots))
        code = {"highest": 0, "mixed": 1, "bf16": 2}[self.tier]
        width = max([_pad16(max(ins[4], ins[5])) for ins in self.tdots],
                    default=16)
        return (f"  static constexpr int kCouplings = {len(self.couplings)};\n"
                f"  static constexpr int kTierDots = {len(self.tdots)};\n"
                f"  static constexpr int kTier = {code};\n"
                f"  static constexpr long kW16 = {self.n_w16};\n"
                f"  static constexpr int kTierWidth = {width};\n"
                "  __host__ __device__ static TierDot tier_dot(int j) {\n"
                "    switch (j) {\n" + cases +
                "      default: return TierDot{0, 0, 0, 0, 0, 0};\n"
                "    }\n  }\n")

    def group(self, prefix: str):
        """The forward group walk of an uncoupled plan (`_group_walk`):
        y the sample's kDim inputs, out its kOutRows outputs, gs the
        walk's kGroupValues values."""
        ops = []
        for ins in self.segs[0]:
            ops += self.group_instr(ins)
        ops.append(_GOp.rows("out", 0, self.plan.out_rows,
                             self.ref(("v", self.plan.out_id), "i"),
                             "out[i]"))
        return _group_walk(
            prefix, ops, lambda v: self.rows[int(v[1:])],
            "    const T t, const T* __restrict__ y, const T* __restrict__ c,"
            "\n    const T* __restrict__ sc, const int b, const int B,\n"
            "    T* __restrict__ gs, T* __restrict__ out",
            "t, y, c, sc, b, B, gs, out")

    def body(self, name: str = "Plan") -> str:
        """The segments and the plan's struct `name` (`Plan`; K12's
        correction net `PlanG`), inside namespace tfd."""
        plan = self.plan
        prefix = name.lower()
        segs = "\n".join(self.segment(k, prefix)
                         for k in range(len(self.segs)))
        gfuncs, gmembers = "", ("  static constexpr int kGroupValues = 0;\n"
                                "  static constexpr int kGroupPhases = 0;\n")
        if len(self.segs) == 1:
            gfuncs, gmembers, _, _ = self.group(prefix)
        calls = "\n".join(
            f"      case {k}: {prefix}_seg{k}(t, y, c, sc, b, B, live, red, "
            f"out); break;" for k in range(len(self.segs)))
        return (
            "namespace tfd {\n\n" + segs + "\n" + gfuncs + "\n"
            f"struct {name} {{\n"
            f"  static constexpr int kDim = {plan.dim};\n"
            f"  static constexpr int kOutRows = {plan.out_rows};\n"
            f"  static constexpr int kSegments = {len(self.segs)};\n"
            f"  static constexpr int kLiveRows = {self.live_rows};\n"
            f"  static constexpr int kRedValues = {self.red_values};\n"
            "  template <typename T>\n"
            "  __host__ __device__ static void seg(\n"
            "      int k, T t, const T* y, const T* c, const T* sc, int b,\n"
            "      int B, T* live, const T* red, T* out) {\n"
            "    switch (k) {\n" + calls + "\n"
            "      default: break;\n    }\n  }\n" + self.meet() + gmembers
            + self.tier_members() + "};\n\n}  // namespace tfd\n")


# ---------------------------------------------------------------------------
# K15: the plan's reverse walk (ops/plan_adjoint.py aug_terms)
# ---------------------------------------------------------------------------

#: d out / d x of the unary ops, from x (X) and out (O): the expressions of
#: plan_adjoint._un_grad.
_UN_GRAD = {
    "neg": "-T(1)", "exp": "{O}", "log": "T(1) / {X}",
    "log1p": "T(1) / (T(1) + {X})", "tanh": "T(1) - {O} * {O}",
    "logistic": "{O} * (T(1) - {O})", "sin": "p_cos({X})",
    "cos": "-p_sin({X})", "sqrt": "T(0.5) / {O}",
    "rsqrt": "(T(-0.5) * {O}) / {X}", "abs": "p_sign({X})", "copy": "T(1)",
    "expm1": "{O} + T(1)",
    "cosh": "T(0.5) * (p_exp({X}) - p_exp(-{X}))",
    "sinh": "T(0.5) * (p_exp({X}) + p_exp(-{X}))",
    "erf": "T(0x1.20dd750429b6dp+0) * p_exp(-({X} * {X}))",
    "erfc": "T(-0x1.20dd750429b6dp+0) * p_exp(-({X} * {X}))",
    "tan": "T(1) + {O} * {O}", "asinh": "T(1) / p_sqrt({X} * {X} + T(1))",
    "acosh": "T(1) / p_sqrt({X} * {X} - T(1))",
    "atanh": "T(1) / (T(1) - {X} * {X})",
}

_VAR = re.compile(r"\b([vg]\d+)\[")


def _qr(row: str) -> str:
    """Row `row` of sample b in the walk's quadrature rows, [kQRows][B]:
    K3's walk, a thread a sample, stores each row's 32 samples of a warp
    in one line. (Sample-major rows, which K3's batch sums would read in
    fewer lines, made K15 in K3 22% slower on the card: PERF.md §6.)"""
    return f"qr[long({row}) * B + b]"


@dataclasses.dataclass(frozen=True)
class AugLayout:
    """What a launch sizes from a plan's reverse walk
    (csrc/plan_aug.cuh): the shared quadratures (the flat constants, then
    a_t), the per-sample ones, the rows of the walk's per-sample outputs
    (`qr`), the segments, live rows and reduced values of a coupled walk."""
    n_quad: int
    time_input: int
    n_sample: int
    q_rows: int
    segments: int
    live_rows: int
    red_values: int


class _AugGen:
    """The reverse walk of a plan as CUDA C++ segments, in the order of
    plan_adjoint.aug_terms: the forward re-walk (the forward generator's
    instructions), then every cotangent in reverse instruction order, cut
    at each batch coupling and at each coupling's transpose, where the
    block meets."""

    def __init__(self, plan: FusedPlan):
        from .plan_bridge import (NO_GRAD_BIN, ZERO_GRAD_UN,
                                  check_plan_adjoint, plan_uses_t)
        check_plan_adjoint(plan)
        self.plan = plan
        self.fw = _Gen(plan)
        self.rows = self.fw.rows
        self.ops: List[tuple] = []       # ('code', lines, writes) / ('meet',)
        self.meets: List[List[tuple]] = []
        self.red = self.fw.red_values
        self.q_rows = 0
        self.has = set()
        self.sites: Dict[int, List[Tuple[int, int]]] = {}
        self.gops: List[_GOp] = []       # the group walk (uncoupled plans)
        self.dh_rows: Dict[str, int] = {}
        rows, fw = self.rows, self.fw

        # Forward re-walk.
        for ins in plan.instrs:
            if ins[0] in ("bsum", "bmax"):
                kind = 0 if ins[0] == "bsum" else (2 if ins[5] else 1)
                off = fw.red_off[ins[1]] - (ins[3] if ins[4] else 0)
                a = ins[2]
                self._meet([(kind, ins[3], off, int(ins[4]),
                             lambda i, a=a: fw.ref(a, i))])
            else:
                L = []
                fw.instr(ins, L.append)
                self.ops.append(("code", L, {f"v{ins[1]}"}))
                self.gops += fw.group_instr(ins)

        # Reverse walk.
        out = plan.out_id
        self._contrib(("v", out), plan.out_rows, lambda i: f"ay[{i}]")
        for ins in reversed(plan.instrs):
            op, o = ins[0], ins[1]
            if op == "litv" or o not in self.has:
                continue
            R = rows[o]
            c = lambda i, o=o: self._g(o, i)
            P = lambda a, i: fw.ref(a, i)
            if op == "un":
                if ins[3] in ZERO_GRAD_UN:
                    continue
                a = ins[2]
                grad = _UN_GRAD[ins[3]]
                self._contrib(a, R, lambda i: "(" + c(i) + ") * (" + grad.format(
                    X=P(a, i), O=P(("v", o), i)) + ")")
            elif op == "bin":
                name, a, b = ins[4], ins[2], ins[3]
                if name in NO_GRAD_BIN:
                    continue
                if name == "add":
                    self._contrib(a, R, c)
                    self._contrib(b, R, c)
                elif name == "sub":
                    self._contrib(a, R, c)
                    self._contrib(b, R, lambda i: f"-{c(i)}")
                elif name == "mul":
                    self._contrib(a, R, lambda i: f"{c(i)} * {P(b, i)}")
                    self._contrib(b, R, lambda i: f"{c(i)} * {P(a, i)}")
                elif name == "div":
                    self._contrib(a, R, lambda i: f"{c(i)} / {P(b, i)}")
                    self._contrib(b, R, lambda i: (
                        f"((-{c(i)}) * {P(a, i)}) / ({P(b, i)} * {P(b, i)})"))
                elif name in ("max", "min"):
                    cmp = ">" if name == "max" else "<"
                    w = lambda i: (f"({P(a, i)} == {P(b, i)} ? T(0.5) : "
                                   f"({P(a, i)} {cmp} {P(b, i)} ? T(1) : "
                                   f"T(0)))")
                    self._contrib(a, R, lambda i: f"{c(i)} * {w(i)}")
                    self._contrib(b, R, lambda i: f"{c(i)} * (T(1) - {w(i)})")
                elif name == "pow":
                    oo = lambda i: P(("v", o), i)
                    self._contrib(a, R, lambda i: (
                        f"(({c(i)} * {P(b, i)}) * {oo(i)}) / {P(a, i)}"))
                    self._contrib(b, R, lambda i: (
                        f"({c(i)} * {oo(i)}) * p_log({P(a, i)})"))
                else:                              # pragma: no cover
                    raise FusionError(f"binary op {name!r}")
            elif op == "ipow":
                n, a = ins[3], ins[2]
                if n == 0:
                    continue
                if n == 1:
                    self._contrib(a, R, c)
                elif n >= 2:
                    xp = lambda i: " * ".join([P(a, i)] * (n - 1))
                    self._contrib(a, R, lambda i: (
                        f"{c(i)} * ({_lit(float(n))} * ({xp(i)}))"))
                else:
                    self._contrib(a, R, lambda i: (
                        f"{c(i)} * (({_lit(float(n))} * {P(('v', o), i)}) / "
                        f"{P(a, i)})"))
            elif op == "clamp":
                lo, x, hi = ins[2], ins[3], ins[4]
                self._contrib(x, R, lambda i: (
                    f"(({P(x, i)} >= {P(lo, i)}) && ({P(x, i)} <= "
                    f"{P(hi, i)}) ? {c(i)} : T(0))"))
                self._contrib(lo, R, lambda i: (
                    f"({P(x, i)} < {P(lo, i)} ? {c(i)} : T(0))"))
                self._contrib(hi, R, lambda i: (
                    f"({P(x, i)} > {P(hi, i)} ? {c(i)} : T(0))"))
            elif op == "select":
                p, c0, c1 = ins[2], ins[3], ins[4]
                self._contrib(c1, R, lambda i: (
                    f"({P(p, i)} != T(0) ? {c(i)} : T(0))"))
                self._contrib(c0, R, lambda i: (
                    f"({P(p, i)} != T(0) ? T(0) : {c(i)})"))
            elif op == "cast":
                if not ins[3]:
                    self._contrib(ins[2], R, c)
            elif op in ("bcast", "reshape"):
                self._contrib(ins[2], R, c)
            elif op == "concat":
                off = 0
                for a in ins[2]:
                    r = 1 if a[0] == "l" else rows[a[1]]
                    self._contrib(a, r, lambda i, off=off: c(f"{off} + {i}"))
                    off += r
            elif op == "slice":
                a, r0, r1 = ins[2], ins[3], ins[4]
                self._contrib(a, rows[a[1]], lambda i: (
                    f"(({i}) >= {r0} && ({i}) < {r1} ? "
                    f"{c(f'({i}) - {r0}')} : T(0))"))
            elif op == "rev":
                self._contrib(ins[2], R, lambda i: c(f"{R - 1} - ({i})"))
            elif op == "reduce":
                a = ins[2]
                self._contrib(a, rows[a[1]], lambda i: c("0"))
            elif op == "bsum":
                off = self._new_red(R)
                self._meet([(0, R, off, 0, c)])
                self._contrib(ins[2], ins[3], lambda i: (
                    f"red[{off} + {i if R > 1 else 0}]"))
            elif op == "bmax":
                r, a = ins[3], ins[2]
                # Bound now: the meet writes its input after the walk.
                tie = (lambda i, a=a, o=o:
                       f"p_bool<T>({P(a, i)} == {P(('v', o), i)})")
                off_c = self._new_red(R)
                off_n = self._new_red(r + (1 if ins[4] else 0))
                self._meet([(0, R, off_c, 0, c),
                            (0, r, off_n, int(ins[4]), tie)])
                cnt = (lambda i: f"red[{off_n + r}]") if ins[4] else (
                    lambda i: f"red[{off_n} + {i}]")
                cc = (lambda i: f"red[{off_c} + {i}]") if R > 1 else (
                    lambda i: f"red[{off_c}]")
                self._contrib(a, r, lambda i: (
                    f"{tie(i)} * ({cc(i)} / {cnt(i)})"))
            elif op == "dot":
                _, _, a_id, cidx, din, dout, _mxu = ins
                w = fw.const_off[cidx]
                hrow, crow = self._new_q(din), self._new_q(dout)
                self.sites.setdefault(cidx, []).append((crow, hrow))
                hq = (_qr(f"{hrow} + i"), P(("v", a_id), "i"))
                cq = (_qr(f"{crow} + i"), c("i"))
                L = [_loop(din, f"{hq[0]} = {hq[1]};"),
                     _loop(dout, f"{cq[0]} = {cq[1]};")]
                tmp = f"dh{len(self.ops)}"
                unroll = ("#pragma unroll" if din * dout <= _UNROLL_DOT
                          else "#pragma unroll 1")
                # din[i] = sum_o w[o][i] c[o] in output order: a member an
                # input i in the group walk, the members reading
                # neighbouring weights.
                acc = [f"    T acc = c[{w} + i] * {c('0')};"]
                if dout > 1:
                    acc += [unroll,
                            f"    for (int o = 1; o < {dout}; ++o) acc = acc "
                            f"+ c[{w} + o * {din} + i] * {c('o')};"]
                acc += [f"    {tmp}[i] = acc;", "  }"]
                L += [f"  T {tmp}[{din}];", unroll,
                      f"  for (int i = 0; i < {din}; ++i) {{"] + acc
                self.ops.append(("code", L, set()))
                self.dh_rows[tmp] = din
                self.gops += [
                    _GOp.rows("qr", 0, din, hq[1], hq[0]),
                    _GOp.rows("qr", 0, dout, cq[1], cq[0]),
                    _GOp([f"  for (int i = m; i < {din}; i += gsz) {{"]
                         + acc, {tmp}, _GOp.reads(c("0") + c("o"))
                         if din * dout > 1 else set())]
                self._contrib(("v", a_id), din, lambda i: f"{tmp}[{i}]")
            else:                                  # pragma: no cover
                raise AssertionError(f"bad instr {op}")

        # The walk's outputs: f, v_y, and the rows of the quadratures.
        fo = fw.ref(("v", out), "i")
        vy = self._g(plan.y_id, "i") if plan.y_id in self.has else "T(0)"
        L = [_loop(plan.out_rows, f"f[i] = {fo};"),
             _loop(plan.dim, f"vy[i] = {vy};")]
        self.gops += [_GOp.rows("f", 0, plan.out_rows, fo, "f[i]"),
                      _GOp.rows("vy", 0, plan.dim, vy, "vy[i]")]
        self.final_row = {}
        for vid in [plan.t_id] + list(plan.const_val_ids):
            if vid in self.has and vid != plan.y_id:
                r = self.rows[vid]
                row = self.final_row[vid] = self._new_q(r)
                L.append(_loop(r, f"{_qr(f'{row} + i')} = "
                                  f"{self._g(vid, 'i')};"))
                self.gops.append(_GOp.rows(
                    "qr", 0, r, self._g(vid, "i"),
                    _qr(f"{row} + i")))
        self.ops.append(("code", L, set()))
        self.time_input = int(plan_uses_t(plan))
        self._segment()

    # ---- building blocks ----
    def _g(self, vid: int, i) -> str:
        return f"g{vid}[{i if self.rows[vid] > 1 else 0}]"

    def _new_red(self, n: int) -> int:
        off = self.red
        self.red += n
        return off

    def _new_q(self, n: int) -> int:
        row = self.q_rows
        self.q_rows += n
        return row

    def _meet(self, calls) -> None:
        self.ops.append(("meet", calls))

    def _contrib(self, a, R: int, expr) -> None:
        """Add the R-row contribution expr(i) to atom a's cotangent: the
        first assigns it, a later one adds; R rows into a one-row value
        fold in row order (plan_adjoint.aug_terms addct)."""
        if a[0] == "l":
            return
        vid = a[1]
        tr = self.rows[vid]
        name = f"g{vid}"
        first = vid not in self.has
        self.has.add(vid)
        L = [f"  T {name}[{tr}];"] if first else []
        if tr == R:
            rhs = expr("i") if first else f"{name}[i] + {expr('i')}"
            L.append(_loop(R, f"{name}[i] = {rhs};"))
            self.gops.append(_GOp.rows(name, 0, R, rhs, f"{name}[i]"))
        else:
            F = [f"  {{ T acc = {expr('0')};"]
            if R > 1:
                F.append("#pragma unroll" if R <= _UNROLL_ROWS
                         else "#pragma unroll 1")
                F.append(f"    for (int i = 1; i < {R}; ++i) "
                         f"acc = acc + {expr('i')};")
            F.append(f"    {name}[0] = " + ("acc" if first
                                            else f"{name}[0] + acc") + "; }")
            L += F
            self.gops.append(_GOp.member0(name, F))
        self.ops.append(("code", L, {name}))

    def _segment(self) -> None:
        """Cut the ops at the meets; give every variable that more than one
        segment touches live rows; write each meet's inputs to their rows at
        the end of the segment before it."""
        segs, meets = [[]], []
        for op in self.ops:
            if op[0] == "meet":
                meets.append(op[1])
                segs.append([])
            else:
                segs[-1].append(op)
        self.meets = meets
        decl = {}
        refs = []
        for k, seg in enumerate(segs):
            rk = set()
            for op in seg:
                for line in op[1]:
                    rk.update(_VAR.findall(line))
                for v in op[2]:
                    decl.setdefault(v, k)
            refs.append(rk)
        # The meets' inputs read variables at the end of their segment.
        self.cin = []
        live = 0
        meet_lines = []
        for k, calls in enumerate(meets):
            L, rows_k = [], []
            for kind, r, off, to_scalar, expr in calls:
                rows_k.append(live)
                L.append(_loop(r, f"live[long({live} + i) * B + b] = "
                                  f"{expr('i')};"))
                live += r
            self.cin.append(rows_k)
            meet_lines.append(L)
            for line in L:
                refs[k].update(_VAR.findall(line))
        nseg = len(segs)
        self.live_row = {}
        for v in sorted(decl, key=lambda v: (decl[v], v)):
            if any(v in refs[k] for k in range(decl[v] + 1, nseg)):
                self.live_row[v] = live
                live += self.rows[int(v[1:])]
        self.live_rows = live
        self.segments = []
        for k, seg in enumerate(segs):
            L = []
            for v in sorted(refs[k]):
                if decl.get(v, k) < k:
                    r, row = self.rows[int(v[1:])], self.live_row[v]
                    L.append(f"  T {v}[{r}];")
                    L.append(_loop(r, f"{v}[i] = live[long({row} + i) * B "
                                      f"+ b];"))
            for op in seg:
                L.extend(op[1])
            for v in sorted(refs[k]):
                if v in self.live_row and any(
                        v in refs[j] for j in range(k + 1, nseg)):
                    r, row = self.rows[int(v[1:])], self.live_row[v]
                    L.append(_loop(r, f"live[long({row} + i) * B + b] = "
                                      f"{v}[i];"))
            if k < len(meets):
                L.extend(meet_lines[k])
            self.segments.append(L)

    # ---- output ----
    def layout(self) -> AugLayout:
        plan = self.plan
        n_sample = sum(lay[1] if lay[0] == "batch" else 1
                       for lay in plan.const_layouts
                       if lay[0] in ("batch", "bvec"))
        return AugLayout(self.fw.n_consts, self.time_input, n_sample,
                         self.q_rows, len(self.segments), self.live_rows,
                         self.red)

    def quad_body(self) -> str:
        """quad_x(r): a shared quadrature's per-sample term; sample_x(j): a
        per-sample constant's cotangent (0 where nothing reaches it)."""
        plan, fw = self.plan, self.fw
        L = []
        for cidx, lay in enumerate(plan.const_layouts):
            tag = lay[0]
            if tag not in ("wT", "col", "scalar"):
                continue
            off = fw.const_off[cidx]
            n = lay[1] * lay[2] if tag == "wT" else (
                lay[1] if tag == "col" else 1)
            L.append(f"    if (r < {off + n}) {{")
            if tag == "wT":
                din = lay[1]
                L.append(f"      const int o = (r - {off}) / {din}, "
                         f"i = (r - {off}) % {din};")
                terms = [f"{_qr(f'{cr} + o')} * {_qr(f'{hr} + i')}"
                         for cr, hr in self.sites.get(cidx, [])]
                L.append("      T x = " + terms[0] + ";")
                for tm in terms[1:]:
                    L.append(f"      x = x + {tm};")
                L.append("      return x;")
            else:
                row = self.final_row.get(plan.const_val_ids[cidx])
                L.append("      return " + (
                    "T(0)" if row is None
                    else _qr(f"{row} + r - {off}")) + ";")
            L.append("    }")
        row = self.final_row.get(plan.t_id)
        L.append("    return " + ("T(0)" if row is None or not
                                  self.time_input
                                  else _qr(f"{row}")) + ";")
        S = []
        j = 0
        for cidx, lay in enumerate(plan.const_layouts):
            if lay[0] not in ("batch", "bvec"):
                continue
            r = lay[1] if lay[0] == "batch" else 1
            row = self.final_row.get(plan.const_val_ids[cidx])
            S.append(f"    if (j < {j + r}) return " + (
                "T(0)" if row is None
                else _qr(f"{row} + j - {j}")) + ";")
            j += r
        S.append("    return T(0);")
        return (
            "  template <typename T>\n"
            "  __host__ __device__ static T quad_x(int r, const T* qr, int B,"
            "\n                                       int b) {\n"
            + "\n".join(L) + "\n  }\n"
            "  template <typename T>\n"
            "  __host__ __device__ static T sample_x(int j, const T* qr, "
            "int B,\n                                         int b) {\n"
            + "\n".join(S) + "\n  }\n")

    def meet(self) -> str:
        cases = []
        for k, calls in enumerate(self.meets):
            body = " ".join(
                f"m({kind}, {row}, {r}, {off}, {ts});"
                for (kind, r, off, ts, _), row in zip(calls, self.cin[k]))
            cases.append(f"    case {k}: {body} break;")
        if not cases:
            return ("  template <class M>\n"
                    "  __host__ __device__ static void meet(int, M&) {}\n")
        return ("  template <class M>\n"
                "  __host__ __device__ static void meet(int k, M& m) {\n"
                "    switch (k) {\n" + "\n".join(cases) + "\n"
                "    default: break;\n    }\n  }\n")

    def group(self):
        """The reverse group walk of an uncoupled plan (`_group_walk`): y,
        ay the sample's stage state, f and vy its outputs, qr its quadrature
        rows ([kQRows][B], `_qr`), gs the walk's
        kGroupValues values."""
        size = lambda v: (self.dh_rows[v] if v.startswith("dh")
                          else self.rows[int(v[1:])])
        return _group_walk(
            "aug", self.gops, size,
            "    const T t, const T* __restrict__ y,\n"
            "    const T* __restrict__ ay, const T* __restrict__ c,\n"
            "    const T* __restrict__ sc, const int b, const int B,\n"
            "    T* __restrict__ qr, T* __restrict__ f, T* __restrict__ vy,\n"
            "    T* __restrict__ gs",
            "t, y, ay, c, sc, b, B, qr, f, vy, gs")

    def body(self) -> str:
        """The segments and the `PlanAug` struct, inside namespace tfd."""
        plan = self.plan
        lay = self.layout()
        gfuncs, gmembers = "", ("  static constexpr int kGroupValues = 0;\n"
                                "  static constexpr int kGroupPhases = 0;\n")
        if not self.meets:
            gfuncs, gmembers, _, _ = self.group()
        segs = []
        for k, L in enumerate(self.segments):
            segs.append(
                f"template <typename T>\n"
                f"__host__ __device__ __forceinline__ void aug_seg{k}(\n"
                f"    const T t, const T* __restrict__ y,\n"
                f"    const T* __restrict__ ay, const T* __restrict__ c,\n"
                f"    const T* __restrict__ sc, const int b, const int B,\n"
                f"    T* __restrict__ live, const T* __restrict__ red,\n"
                f"    T* __restrict__ qr, T* __restrict__ f,\n"
                f"    T* __restrict__ vy) {{\n" + "\n".join(L) + "\n}\n")
        calls = "\n".join(
            f"      case {k}: aug_seg{k}(t, y, ay, c, sc, b, B, live, red, "
            f"qr, f, vy); break;" for k in range(len(self.segments)))
        return (
            "namespace tfd {\n\n" + "\n".join(segs) + "\n" + gfuncs + "\n"
            "struct PlanAug {\n"
            f"  static constexpr int kDim = {plan.dim};\n"
            f"  static constexpr int kOutRows = {plan.out_rows};\n"
            f"  static constexpr int kSegments = {lay.segments};\n"
            f"  static constexpr int kLiveRows = {lay.live_rows};\n"
            f"  static constexpr int kRedValues = {lay.red_values};\n"
            f"  static constexpr int kQRows = {lay.q_rows};\n"
            f"  static constexpr int kNQuad = {lay.n_quad};\n"
            f"  static constexpr int kTimeInput = {lay.time_input};\n"
            f"  static constexpr int kNSample = {lay.n_sample};\n"
            "  template <typename T>\n"
            "  __host__ __device__ static void seg(\n"
            "      int k, T t, const T* y, const T* ay, const T* c,\n"
            "      const T* sc, int b, int B, T* live, const T* red, T* qr,\n"
            "      T* f, T* vy) {\n"
            "    switch (k) {\n" + calls + "\n"
            "      default: break;\n    }\n  }\n" + self.meet()
            + self.quad_body() + gmembers + "};\n\n}  // namespace tfd\n")


def _operand_ids(ins) -> List[int]:
    op = ins[0]
    if op == "dot":
        return [ins[2]]
    ids = []
    for x in ins[2:]:
        if isinstance(x, tuple):
            if len(x) == 2 and x[0] == "v" and isinstance(x[1], int):
                ids.append(x[1])
            else:
                ids.extend(y[1] for y in x if isinstance(y, tuple)
                           and len(y) == 2 and y[0] == "v")
    return ids


def _lit(v: float) -> str:
    """A literal, exact: a double hex float (or HUGE_VAL / NAN) cast to T,
    as torch.tensor(v, dtype) rounds it."""
    if v != v:
        return "T(NAN)"
    if v in (float("inf"), float("-inf")):
        return "T(HUGE_VAL)" if v > 0 else "T(-HUGE_VAL)"
    return f"T({float(v).hex()})"


#: Largest dot (weights) and value (rows) whose loops are unrolled.
_UNROLL_DOT = 4096
_UNROLL_ROWS = 128


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def _loop(n: int, stmt: str, long_unroll: int = 1) -> str:
    if n == 1:
        return "  { const int i = 0; (void)i; " + stmt + " }"
    unroll = ("#pragma unroll" if n <= _UNROLL_ROWS
              else f"#pragma unroll {long_unroll}")
    return f"{unroll}\n  for (int i = 0; i < {n}; ++i) {stmt}"


# ---------------------------------------------------------------------------
# The group walk: one sample's walk split over the gsz members of its group
# ---------------------------------------------------------------------------

#: A value of the group walk, read at row [index]: the plan's computed
#: values (v), their cotangents (g), a VJP dot's input cotangent (dh), and
#: the host's stage state (y, ay).
_SLOT = re.compile(r"\b((?:v|g|dh)\d+|y|ay)\[([^\[\]]*)\]")
#: The values that live in the walk's scratch (`gs`).
_SCRATCH = re.compile(r"(?:v|g|dh)\d+$")
#: What the host wrote before the walk, read by any member.
_HOST_ROWS = ("y", "ay")


def _gloop(off: int, n: int, stmt: str) -> str:
    """stmt for the rows off + i (i < n) that member m owns, (off + i) %
    gsz == m."""
    start = "m" if off == 0 else f"((m - {off}) % gsz + gsz) % gsz"
    return f"  for (int i = {start}; i < {n}; i += gsz) {stmt}"


@dataclasses.dataclass
class _GOp:
    """One instruction of the group walk: its lines, the values it writes,
    and the values it reads at rows that other members wrote (`cross`),
    which a group sync must precede once they were written in the walk."""
    lines: List[str]
    writes: set
    cross: set

    @staticmethod
    def reads(text: str) -> set:
        return {v for v, _ in _SLOT.findall(text)}

    @staticmethod
    def rows(name: str, off: int, n: int, expr: str, lhs: str) -> "_GOp":
        """Rows off + i of `name` (lhs, with i) set to expr (with i), each by
        its owner; a read is the member's own row where it is row i of
        an n-row output at off 0 (row 0 of a 1-row one)."""
        own = lambda idx: off == 0 and (idx == "i" or (n == 1 and idx == "0"))
        return _GOp([_gloop(off, n, f"{lhs} = {expr};")], {name},
                    {v for v, idx in _SLOT.findall(expr)
                     if not own(idx.strip())})

    @staticmethod
    def member0(name: str, lines: List[str]) -> "_GOp":
        """A 1-row result that member 0 computes (a reduction, a fold)."""
        return _GOp(["  if (m == 0) {"] + lines + ["  }"], {name},
                    {v for v, idx in _SLOT.findall("\n".join(lines))
                     if idx.strip() != "0"})

    def names(self) -> set:
        return self.writes | self.reads("\n".join(self.lines))


def _name_key(v: str):
    return (v.rstrip("0123456789"), int(v[len(v.rstrip("0123456789")):] or 0))


def _group_walk(prefix: str, ops: List[_GOp], size_of, params: str,
                args: str):
    """The group walk of `ops`: phases cut where an op reads a row that
    another member wrote in the walk (a group sync between phases, and one
    after the last), each value in a region of the scratch `gs` (a region
    reused by a later value once a sync separates their phases). Returns
    (the phase functions, the struct's members, values, phases)."""
    phases, dirty = [[]], set(_HOST_ROWS)
    for op in ops:
        if op.cross & dirty:
            phases.append([])
            dirty = set()
        phases[-1].append(op)
        dirty |= op.writes
    span: Dict[str, Tuple[int, int]] = {}
    for k, ph in enumerate(phases):
        for op in ph:
            for v in op.names():
                if _SCRATCH.match(v):
                    a, b = span.get(v, (k, k))
                    span[v] = (min(a, k), max(b, k))
    regions, off, total = [], {}, 0
    for v in sorted(span, key=lambda v: (span[v][0], _name_key(v))):
        n, (first, last) = size_of(v), span[v]
        for reg in regions:
            if reg[2] < first and reg[1] >= n:
                off[v] = reg[0]
                reg[2] = last
                break
        else:
            off[v] = total
            regions.append([total, n, last])
            total += n
    funcs, calls = [], []
    for k, ph in enumerate(phases):
        names = sorted({v for op in ph for v in op.names() if v in off},
                       key=_name_key)
        body = [f"  T* const {v} = gs + {off[v]};" for v in names]
        for op in ph:
            body += op.lines
        funcs.append(f"template <typename T>\n"
                     f"__host__ __device__ __forceinline__ void "
                     f"{prefix}_gph{k}(\n{params}, const int m,\n"
                     f"    const int gsz) {{\n" + "\n".join(body) + "\n}\n")
        calls.append(f"{prefix}_gph{k}<T>({args}, m, gsz);")
    cases = "\n".join(f"      case {k}: {c} break;"
                      for k, c in enumerate(calls))
    walk = "\n".join(f"    {c}\n    sync();" for c in calls)
    members = (
        f"  static constexpr int kGroupValues = {total};\n"
        f"  static constexpr int kGroupPhases = {len(phases)};\n"
        "  // Phase k of the group walk for member m of gsz (a host runs the\n"
        "  // members in turn, phase by phase).\n"
        "  template <typename T>\n"
        f"  __host__ __device__ static void group_phase(\n      int k, "
        f"{params.strip()},\n      int m, int gsz) {{\n"
        f"    switch (k) {{\n{cases}\n      default: break;\n    }}\n  }}\n"
        "  // The whole walk for member m, the group meeting at sync()\n"
        "  // between phases and after the last.\n"
        "  template <typename T, class Sync>\n"
        f"  __device__ static void group_walk(\n      {params.strip()},\n"
        f"      int m, int gsz, const Sync& sync) {{\n{walk}\n  }}\n")
    return "\n".join(funcs), members, total, len(phases)


_ENTRY = {"solve": "TFD_PLAN_SOLVE_ENTRY(tfd_plan_solve_{t}, {ct})",
          "fixed": "TFD_PLAN_FIXED_ENTRY(tfd_plan_fixed_{t}, {ct})",
          "perlane": "TFD_PLAN_PERLANE_ENTRY(tfd_plan_perlane_{t}, {ct})",
          "adams": "TFD_PLAN_ADAMS_ENTRY(tfd_plan_adams_{t}, {ct})",
          "vcabm": "TFD_PLAN_VCABM_ENTRY(tfd_plan_vcabm_{t}, {ct})",
          "hyper": "TFD_PLAN_HYPER_ENTRY(tfd_plan_hyper_{t}, {ct})",
          "adjoint": "TFD_PLAN_ADJOINT_ENTRY(tfd_plan_adjoint_{t}, {ct})",
          "perlane_adjoint": "TFD_PLAN_PERLANE_ADJOINT_ENTRY("
                             "tfd_plan_perlane_adjoint_{t}, {ct})",
          "fixed_adjoint": "TFD_PLAN_FIXED_ADJOINT_ENTRY("
                           "tfd_plan_fixed_adjoint_{t}, {ct})"}


def layout(plan: FusedPlan, dot_precision: str = "highest") -> PlanLayout:
    return _Gen(plan, dot_precision).layout()


def aug_layout(plan: FusedPlan) -> AugLayout:
    return _AugGen(plan).layout()


@functools.lru_cache(maxsize=256)
def group_values(plan: FusedPlan) -> int:
    """kGroupValues of an uncoupled plan's forward group walk."""
    return _Gen(plan).group("plan")[2]


@functools.lru_cache(maxsize=256)
def aug_group_values(plan: FusedPlan) -> int:
    """kGroupValues of an uncoupled plan's reverse group walk."""
    return _AugGen(plan).group()[2]


def _entries(host: str) -> str:
    return "\n".join(_ENTRY[host].format(t=t, ct=ct)
                     for t, ct in (("f32", "float"), ("f64", "double")))


def cuda_source(plan, host: str, dot_precision: str = "highest") -> str:
    """The CUDA source of one plan library: the plan's segments, `Plan`,
    and the float32 and float64 entry points of one host kernel
    (csrc/plan_rhs.cuh); for an adjoint host (`AUG_HOSTS`) the reverse
    walk's segments and `PlanAug` with the entry points of K3, K6 or K9
    (csrc/plan_aug.cuh); for K12 (`HYPER_HOST`) `plan` is the pair
    (dynamics, correction net), generated as `Plan` and `PlanG`. A reduced
    `dot_precision` cuts the plan at its tiered dots (`_Gen`) for the
    tile routes of `TIER_HOSTS`; the tier is part of the source, so a
    tiered and a 'highest' plan of one structure are two libraries."""
    if dot_precision != "highest" and (host == HYPER_HOST
                                       or host in AUG_HOSTS):
        raise ValueError(f"a reduced dot_precision runs on the hosts "
                         f"{TIER_HOSTS} only, not {host!r}")
    if host == HYPER_HOST:
        plan_f, plan_g = plan
        gens = (_Gen(plan_f), _Gen(plan_g))
        if any(len(g.segs) > 1 for g in gens):
            raise ValueError(f"a coupled plan runs on the hosts "
                             f"{COUPLED_HOSTS} only, not 'hyper'")
        return ("// K14 x 2: the dynamics and the correction net generated "
                "by\n// tfdiffeq_tpu_torch/ops/plan_codegen.py for the hyper "
                "host\n// (csrc/plan_rhs.cuh, csrc/rk_hyper.cuh).\n"
                "#include \"plan_rhs.cuh\"\n\n" + gens[0].body("Plan") + "\n"
                + gens[1].body("PlanG") + "\n" + _entries(host) + "\n")
    if host in AUG_HOSTS:
        aug = _AugGen(plan)
        if host not in COUPLED_HOSTS and len(aug.segments) > 1:
            raise ValueError(f"a coupled plan runs on the hosts "
                             f"{COUPLED_HOSTS} only, not {host!r}")
        entries = _entries(host)
        return ("// K15: a plan's reverse walk generated by tfdiffeq_tpu_"
                "torch/ops/\n// plan_codegen.py for the " + host + " host "
                "(csrc/plan_aug.cuh).\n#include \"plan_aug.cuh\"\n\n"
                + aug.body() + "\n" + entries + "\n")
    if host not in HOSTS:
        raise ValueError(f"host must be one of "
                         f"{HOSTS + AUG_HOSTS + (HYPER_HOST,)}, got "
                         f"{host!r}")
    gen = _Gen(plan, dot_precision)
    if host not in COUPLED_HOSTS and gen.couplings:
        raise ValueError(f"a coupled plan runs on the hosts "
                         f"{COUPLED_HOSTS} only, not {host!r}")
    if gen.tdots and host not in TIER_HOSTS:
        raise ValueError(f"a reduced dot_precision runs on the hosts "
                         f"{TIER_HOSTS} only, not {host!r}")
    entries = _entries(host)
    return ("// K14: a plan generated by tfdiffeq_tpu_torch/ops/"
            "plan_codegen.py\n// for the " + host + " host "
            "(csrc/plan_rhs.cuh).\n#include \"plan_rhs.cuh\"\n\n"
            + gen.body() + "\n" + entries + "\n")


def _host_evals(plan: FusedPlan, threads: int, name: str,
                tiled: bool = False) -> str:
    """`<name lower>_eval_f32` / `_f64`: a plain host evaluator of the
    generated struct `name` over the whole batch (`tiled`: a plan cut at
    its tiered dots, each product by `HostTileMeet`)."""
    D, R = plan.dim, plan.out_rows
    prefix = name.lower()
    evals = []
    for t, ct in (("f32", "float"), ("f64", "double")):
        meet = (f"tfd::HostTileMeet<{ct}, tfd::{name}> m{{{{live, red, B, "
                f"{threads}}}, c}};" if tiled
                else f"tfd::HostMeet<{ct}> m{{live, red, B, {threads}}};")
        evals.append(f"""
extern "C" void {prefix}_eval_{t}({ct} t, const {ct}* y, const {ct}* c,
                              const {ct}* sc, int B, {ct}* out, {ct}* live,
                              {ct}* red) {{
  {meet}
  for (int k = 0; k < tfd::{name}::kSegments; ++k) {{
    for (int b = 0; b < B; ++b)
      tfd::{name}::seg<{ct}>(k, t, y + long(b) * {D}, c, sc, b, B, live, red,
                           out + long(b) * {R});
    if (k + 1 < tfd::{name}::kSegments) tfd::{name}::meet(k, m);
  }}
}}""")
    return "\n".join(evals) + "\n"


_HOST_HEAD = ("#include <cstring>\n#include <vector>\n"
              "#include \"plan_ops.cuh\"\n\nnamespace tfd {\n")


def _host_group_evals(plan: FusedPlan) -> str:
    """`plan_group_f32` / `_f64`(t, y [B][D], c, sc, B, out [B][out_rows],
    gs [kGroupValues], gsz): the forward group walk of an uncoupled plan
    over the whole batch, phase by phase, the gsz members of a sample in
    turn; `plan_group_values()` the scratch values (kGroupValues)."""
    D, R = plan.dim, plan.out_rows
    evals = ['extern "C" int plan_group_values() '
             '{ return tfd::Plan::kGroupValues; }']
    for t, ct in (("f32", "float"), ("f64", "double")):
        evals.append(f"""
extern "C" void plan_group_{t}({ct} t, const {ct}* y, const {ct}* c,
                               const {ct}* sc, int B, {ct}* out, {ct}* gs,
                               int gsz) {{
  using P = tfd::Plan;
  for (int b = 0; b < B; ++b)
    for (int k = 0; k < P::kGroupPhases; ++k)
      for (int m = 0; m < gsz; ++m)
        P::group_phase<{ct}>(k, t, y + long(b) * {D}, c, sc, b, B, gs,
                             out + long(b) * {R}, m, gsz);
}}""")
    return "\n".join(evals) + "\n"


def host_source(plan: FusedPlan, threads: int,
                dot_precision: str = "highest") -> str:
    """Host C++ of the plan's segments with a plain host evaluator, for the
    codegen tests: `plan_eval_f32` / `plan_eval_f64`(t, y [B][D], c, sc,
    B, out [B][out_rows], live, red) evaluate the whole batch, each coupling
    reduced in the order of a K2 block of `threads` threads and, at a
    reduced `dot_precision`, each tiered dot by K4's arithmetic in input
    order (`HostTileMeet`, the float64 tile product's); for an uncoupled
    plan also its group walk (`_host_group_evals`). Include after a shim
    that defines __host__, __device__ and __forceinline__ empty."""
    gen = _Gen(plan, dot_precision)
    return (_HOST_HEAD + _HOST_MEET + _HOST_TILE_MEET
            + "}  // namespace tfd\n\n" + gen.body()
            + _host_evals(plan, threads, "Plan", bool(gen.tdots))
            + (_host_group_evals(plan) if len(gen.segs) == 1 else ""))


def host_hyper_source(plan_f: FusedPlan, plan_g: FusedPlan) -> str:
    """Host C++ of K12's two plans as the 'hyper' host generates them, one
    translation unit with `Plan` and `PlanG`, and their host evaluators
    `plan_eval_*` and `plang_eval_*` (`host_source`'s contract)."""
    return (_HOST_HEAD + _HOST_MEET + "}  // namespace tfd\n\n"
            + _Gen(plan_f).body("Plan") + _Gen(plan_g).body("PlanG")
            + _host_evals(plan_f, 1, "Plan") + _host_evals(plan_g, 1, "PlanG"))


def host_aug_source(plan: FusedPlan, threads: int) -> str:
    """Host C++ of the plan's reverse walk with a plain host evaluator, for
    the codegen tests: `aug_eval_f32` / `aug_eval_f64`(t, y [B][D], ay
    [B][D], c, sc, B, f [B][out_rows], vy [B][D], xq [kNQuad + kTimeInput]
    [B], xs [kNSample][B], live, red, qr) walk the whole batch, each meet
    in the order of a K3 block of `threads` threads, then gather each
    sample's quadrature terms (`quad_x`, `sample_x`). Include after the
    shim of `host_source`."""
    gen = _AugGen(plan)
    D, R = plan.dim, plan.out_rows
    evals = []
    for t, ct in (("f32", "float"), ("f64", "double")):
        evals.append(f"""
extern "C" void aug_eval_{t}({ct} t, const {ct}* y, const {ct}* ay,
                             const {ct}* c, const {ct}* sc, int B, {ct}* f,
                             {ct}* vy, {ct}* xq, {ct}* xs, {ct}* live,
                             {ct}* red, {ct}* qr) {{
  using P = tfd::PlanAug;
  tfd::HostMeet<{ct}> m{{live, red, B, {threads}}};
  for (int k = 0; k < P::kSegments; ++k) {{
    for (int b = 0; b < B; ++b)
      P::seg<{ct}>(k, t, y + long(b) * {D}, ay + long(b) * {R}, c, sc, b, B,
                   live, red, qr, f + long(b) * {R}, vy + long(b) * {D});
    if (k + 1 < P::kSegments) P::meet(k, m);
  }}
  for (int b = 0; b < B; ++b) {{
    for (int r = 0; r < P::kNQuad + P::kTimeInput; ++r)
      xq[long(r) * B + b] = P::quad_x<{ct}>(r, qr, B, b);
    for (int j = 0; j < P::kNSample; ++j)
      xs[long(j) * B + b] = P::sample_x<{ct}>(j, qr, B, b);
  }}
}}""")
    if not gen.meets:
        # The reverse group walk (aug_group_*: aug_eval_*'s contract, its
        # qr rows [kQRows][B], gs [kGroupValues], the gsz members of a
        # sample in turn as plan_group_* runs them).
        evals.append('extern "C" int aug_group_values() '
                     '{ return tfd::PlanAug::kGroupValues; }')
        for t, ct in (("f32", "float"), ("f64", "double")):
            evals.append(f"""
extern "C" void aug_group_{t}({ct} t, const {ct}* y, const {ct}* ay,
                              const {ct}* c, const {ct}* sc, int B, {ct}* f,
                              {ct}* vy, {ct}* xq, {ct}* xs, {ct}* qr,
                              {ct}* gs, int gsz) {{
  using P = tfd::PlanAug;
  for (int b = 0; b < B; ++b)
    for (int k = 0; k < P::kGroupPhases; ++k)
      for (int m = 0; m < gsz; ++m)
        P::group_phase<{ct}>(k, t, y + long(b) * {D}, ay + long(b) * {R}, c,
                             sc, b, B, qr, f + long(b) * {R},
                             vy + long(b) * {D}, gs, m, gsz);
  for (int b = 0; b < B; ++b) {{
    for (int r = 0; r < P::kNQuad + P::kTimeInput; ++r)
      xq[long(r) * B + b] = P::quad_x<{ct}>(r, qr, B, b);
    for (int j = 0; j < P::kNSample; ++j)
      xs[long(j) * B + b] = P::sample_x<{ct}>(j, qr, B, b);
  }}
}}""")
    return (_HOST_HEAD + _HOST_MEET + "}  // namespace tfd\n\n"
            + gen.body() + "\n".join(evals) + "\n")


#: A K2 block's meet on the host: each of `threads` threads folds its
#: samples in order, then a tree over the threads (block_fold's order).
_HOST_MEET = """
template <typename T>
struct HostMeet {
  const T* live;
  T* red;
  int B, threads;
  static T fold(int kind, T a, T b) {
    return kind == 0 ? a + b : (kind == 1 ? p_max(a, b) : p_min(a, b));
  }
  void operator()(int kind, int row, int rows, int off, int to_scalar) {
    const T init = kind == 0 ? T(0) : (kind == 1 ? -T(HUGE_VAL)
                                                 : T(HUGE_VAL));
    std::vector<T> p(threads);
    for (int r = 0; r < rows; ++r) {
      for (int i = 0; i < threads; ++i) {
        T v = init;
        for (int b = i; b < B; b += threads)
          v = fold(kind, v, live[long(row + r) * B + b]);
        p[i] = v;
      }
      for (int s = threads / 2; s > 0; s >>= 1)
        for (int i = 0; i < s; ++i) p[i] = fold(kind, p[i], p[i + s]);
      red[off + r] = p[0];
    }
    if (to_scalar) {
      T s = red[off];
      for (int r = 1; r < rows; ++r) s = fold(kind, s, red[off + r]);
      red[off + rows] = s;
    }
  }
};
"""

#: A tiled plan's cuts on the host: the couplings as HostMeet, each tiered
#: dot as K4's tier in input order (csrc/dot_tiers.cuh plan_dot_scalar):
#: the weights and the input rounded to bf16 (nearest even, a double
#: through float), the products and sums in T.
_HOST_TILE_MEET = """
inline float host_bf16(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    if (u & 0x7fffffu) u |= 0x400000u;
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
  }
  u &= 0xffff0000u;
  memcpy(&x, &u, 4);
  return x;
}
template <typename T>
T host_bf16_t(T x) { return T(host_bf16(float(x))); }

template <typename T, class P>
struct HostTileMeet : HostMeet<T> {
  const T* c;
  void dot(int j) {
    const TierDot d = P::tier_dot(j);
    const int B = this->B;
    T* live = const_cast<T*>(this->live);
    for (int b = 0; b < B; ++b)
      for (int o = 0; o < d.dout; ++o) {
        T hi = T(0), lo = T(0);
        for (int i = 0; i < d.din; ++i) {
          const T x = live[long(d.in_row + i) * B + b];
          const T w = host_bf16_t(c[d.w_off + long(o) * d.din + i]);
          const T h = host_bf16_t(x);
          const T th = w * h;
          hi = i == 0 ? th : hi + th;
          if (P::kTier == 1) {
            const T tl = w * host_bf16_t(x - h);
            lo = i == 0 ? tl : lo + tl;
          }
        }
        live[long(d.out_row + o) * B + b] = P::kTier == 1 ? hi + lo : hi;
      }
  }
};
"""
