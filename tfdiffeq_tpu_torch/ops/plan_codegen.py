"""Generate K14's CUDA C++ from a plan: the right-hand side of the plan
hosts K2, K8 and K5 (csrc/plan_rhs.cuh).

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

The source depends on the plan's structure and literals alone: not on the
batch size (a runtime argument) nor on the constants' values (a runtime
array), so equal structures share one library at any B, unless the
function itself computes with B (a batch mean divides by it, a literal of
the plan).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from .plan_bridge import FusedPlan, FusionError

Tensor = torch.Tensor

#: Host kernels a plan runs in: K2 (one controller), K8 (fixed grid), K5
#: (a controller a sample).
HOSTS = ("solve", "fixed", "perlane")

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
    (csrc/plan_rhs.cuh PlanBatchRhs' workspace)."""
    n_consts: int
    segments: int
    live_rows: int
    red_values: int


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


def flat_consts(plan: FusedPlan, packed: Sequence[Tensor], B: int
                ) -> Tuple[Tensor, Tensor]:
    """`plan_bridge.pack_consts`' output as the kernels read it: one flat
    array of the shared constants (a weight [dout][din] row-major, a column,
    a scalar) and the per-sample constants as [rows, B]. Each has at least
    one element, so that its pointer is valid."""
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
    sc = (torch.cat(rows, dim=0) if rows
          else torch.zeros((1, B), dtype=dtype, device=dev))
    return c.contiguous(), sc.contiguous()


class _Gen:
    """Emits the segments of one plan."""

    def __init__(self, plan: FusedPlan):
        self.plan = plan
        self.rows = value_rows(plan)
        self.const_off, self.n_consts, self.sample_off, _ = \
            _const_layout(plan)
        self.const_of_vid = {vid: ci
                             for ci, vid in enumerate(plan.const_val_ids)}
        # Segments and couplings.
        self.segs: List[List[tuple]] = [[]]
        self.couplings: List[tuple] = []
        for ins in plan.instrs:
            if ins[0] in ("bsum", "bmax"):
                self.couplings.append(ins)
                self.segs.append([])
            else:
                self.segs[-1].append(ins)
        # Where each computed value is defined: its segment; a coupling's
        # result lies in `red` from the next segment on.
        self.seg_of: Dict[int, int] = {}
        self.red_off: Dict[int, int] = {}
        self.cin_row: List[int] = []
        red = 0
        for k, seg in enumerate(self.segs):
            for ins in seg:
                self.seg_of[ins[1]] = k
        for k, ins in enumerate(self.couplings):
            r, to_scalar = ins[3], ins[4]
            self.red_off[ins[1]] = red + (r if to_scalar else 0)
            red += r + (1 if to_scalar else 0)
        self.red_values = red
        # Values read in a later segment than their own get live rows.
        uses: Dict[int, set] = {}
        for k, seg in enumerate(self.segs):
            for ins in seg:
                for vid in _operand_ids(ins):
                    uses.setdefault(vid, set()).add(k)
        for k, ins in enumerate(self.couplings):
            if ins[2][0] == "v":
                uses.setdefault(ins[2][1], set()).add(k)
        uses.setdefault(plan.out_id, set()).add(len(self.segs) - 1)
        self.live_row: Dict[int, int] = {}
        live = 0
        for vid in sorted(uses):
            if vid in self.seg_of and any(k > self.seg_of[vid]
                                          for k in uses[vid]):
                self.live_row[vid] = live
                live += self.rows[vid]
        self.loads = [sorted(v for v in self.live_row
                             if k in uses[v] and self.seg_of[v] < k)
                      for k in range(len(self.segs))]
        for ins in self.couplings:
            self.cin_row.append(live)
            live += ins[3]
        self.live_rows = live

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

    def segment(self, k: int) -> str:
        L = []
        emit = L.append
        for vid in self.loads[k]:
            r, row = self.rows[vid], self.live_row[vid]
            emit(f"  T v{vid}[{r}];")
            emit(_loop(r, f"v{vid}[i] = live[long({row} + i) * B + b];"))
        for ins in self.segs[k]:
            self.instr(ins, emit)
        for vid in sorted(self.live_row):
            if self.seg_of[vid] == k:
                r, row = self.rows[vid], self.live_row[vid]
                emit(_loop(r, f"live[long({row} + i) * B + b] = "
                              f"v{vid}[i];"))
        if k < len(self.couplings):
            ins = self.couplings[k]
            emit(_loop(ins[3], f"live[long({self.cin_row[k]} + i) * B + b] "
                               f"= {self.ref(ins[2], 'i')};"))
        if k == len(self.segs) - 1:
            out = ("v", self.plan.out_id)
            emit(_loop(self.plan.out_rows, f"out[i] = {self.ref(out, 'i')};"))
        body = "\n".join(L)
        return (f"template <typename T>\n"
                f"__host__ __device__ __forceinline__ void plan_seg{k}(\n"
                f"    const T t, const T* __restrict__ y,\n"
                f"    const T* __restrict__ c, const T* __restrict__ sc,\n"
                f"    const int b, const int B, T* __restrict__ live,\n"
                f"    const T* __restrict__ red, T* __restrict__ out) {{\n"
                f"{body}\n}}\n")

    def instr(self, ins, emit) -> None:
        op, out = ins[0], ins[1]
        R = self.rows[out]
        decl = f"  T v{out}[{R}];"
        ref = self.ref
        if op == "litv":
            emit(decl)
            emit(f"  v{out}[0] = {_lit(ins[2])};")
        elif op == "un":
            emit(decl)
            name, a = ins[3], ins[2]
            if name == "neg":
                e = f"-{ref(a, 'i')}"
            elif name in ("copy", "stop_gradient"):
                e = ref(a, "i")
            elif name == "not":
                e = f"p_bool<T>({ref(a, 'i')} == T(0))"
            else:
                e = f"{_UN_FN[name]}({ref(a, 'i')})"
            emit(_loop(R, f"v{out}[i] = {e};"))
        elif op == "bin":
            emit(decl)
            name, a, b = ins[4], ref(ins[2], "i"), ref(ins[3], "i")
            if name in _BIN_INFIX:
                e = f"{a} {_BIN_INFIX[name]} {b}"
            elif name in _BIN_CMP:
                e = f"p_bool<T>({a} {_BIN_CMP[name]} {b})"
            elif name in _BIN_LOGIC:
                e = (f"p_bool<T>(({a} != T(0)) {_BIN_LOGIC[name]} "
                     f"({b} != T(0)))")
            elif name == "max":
                e = f"p_max({a}, {b})"
            elif name == "min":
                e = f"p_min({a}, {b})"
            elif name == "pow":
                e = f"p_pow({a}, {b})"
            else:                                  # pragma: no cover
                raise FusionError(f"binary op {name!r}")
            emit(_loop(R, f"v{out}[i] = {e};"))
        elif op == "ipow":
            emit(decl)
            x, n = ref(ins[2], "i"), ins[3]
            m = abs(n)
            e = "T(1)" if m == 0 else " * ".join([x] * m)
            if n < 0:
                e = f"T(1) / ({e})"
            emit(_loop(R, f"v{out}[i] = {e};"))
        elif op == "clamp":
            emit(decl)
            lo, x, hi = (ref(ins[j], "i") for j in (2, 3, 4))
            emit(_loop(R, f"v{out}[i] = p_min(p_max({x}, {lo}), {hi});"))
        elif op == "select":
            emit(decl)
            p, c0, c1 = (ref(ins[j], "i") for j in (2, 3, 4))
            emit(_loop(R, f"v{out}[i] = ({p} != T(0)) ? {c1} : {c0};"))
        elif op in ("cast", "bcast", "reshape"):
            emit(decl)
            emit(_loop(R, f"v{out}[i] = {ref(ins[2], 'i')};"))
        elif op == "concat":
            emit(decl)
            off = 0
            for a in ins[2]:
                r = 1 if a[0] == "l" else self.rows[a[1]]
                emit(_loop(r, f"v{out}[{off} + i] = {ref(a, 'i')};"))
                off += r
        elif op == "slice":
            emit(decl)
            emit(_loop(R, f"v{out}[i] = {ref(ins[2], f'{ins[3]} + i')};"))
        elif op == "rev":
            emit(decl)
            emit(_loop(R, f"v{out}[i] = "
                          f"{ref(ins[2], f'{ins[3] - 1} - i')};"))
        elif op == "reduce":
            emit(decl)
            a, fn = ins[2], ins[3]
            r = 1 if a[0] == "l" else self.rows[a[1]]
            emit(f"  {{ T acc = {ref(a, '0')};")
            step = {"sum": "acc + {x}", "max": "p_max(acc, {x})",
                    "min": "p_min(acc, {x})"}[fn]
            if r > 1:
                emit("#pragma unroll" if r <= _UNROLL_ROWS
                     else "#pragma unroll 1")
                emit(f"    for (int i = 1; i < {r}; ++i) "
                     f"acc = {step.format(x=ref(a, 'i'))};")
            emit(f"    v{out}[0] = acc; }}")
        elif op == "dot":
            _, _, a_id, cidx, din, dout, _mxu = ins
            w = self.const_off[cidx]
            h = self.ref(("v", a_id), "i")
            h0 = self.ref(("v", a_id), "0")
            emit(decl)
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
        else:                                      # pragma: no cover
            raise AssertionError(f"bad instr {op}")

    def meet(self) -> str:
        cases = []
        for k, ins in enumerate(self.couplings):
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
                          self.red_values)

    def body(self) -> str:
        """The segments and the `Plan` struct, inside namespace tfd."""
        plan = self.plan
        segs = "\n".join(self.segment(k) for k in range(len(self.segs)))
        calls = "\n".join(
            f"      case {k}: plan_seg{k}(t, y, c, sc, b, B, live, red, "
            f"out); break;" for k in range(len(self.segs)))
        return (
            "namespace tfd {\n\n" + segs + "\n"
            "struct Plan {\n"
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
            "      default: break;\n    }\n  }\n" + self.meet() + "};\n\n"
            "}  // namespace tfd\n")


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


def _loop(n: int, stmt: str) -> str:
    if n == 1:
        return "  { const int i = 0; (void)i; " + stmt + " }"
    unroll = "#pragma unroll" if n <= _UNROLL_ROWS else "#pragma unroll 1"
    return f"{unroll}\n  for (int i = 0; i < {n}; ++i) {stmt}"


_ENTRY = {"solve": "TFD_PLAN_SOLVE_ENTRY(tfd_plan_solve_{t}, {ct})",
          "fixed": "TFD_PLAN_FIXED_ENTRY(tfd_plan_fixed_{t}, {ct})",
          "perlane": "TFD_PLAN_PERLANE_ENTRY(tfd_plan_perlane_{t}, {ct})"}


def layout(plan: FusedPlan) -> PlanLayout:
    return _Gen(plan).layout()


def cuda_source(plan: FusedPlan, host: str) -> str:
    """The CUDA source of one plan library: the plan's segments, `Plan`,
    and the float32 and float64 entry points of one host kernel
    (csrc/plan_rhs.cuh)."""
    if host not in HOSTS:
        raise ValueError(f"host must be one of {HOSTS}, got {host!r}")
    gen = _Gen(plan)
    if host != "solve" and len(gen.segs) > 1:
        raise ValueError(f"a coupled plan runs on the 'solve' host only, "
                         f"not {host!r}")
    entries = "\n".join(_ENTRY[host].format(t=t, ct=ct)
                        for t, ct in (("f32", "float"), ("f64", "double")))
    return ("// K14: a plan generated by tfdiffeq_tpu_torch/ops/"
            "plan_codegen.py\n// for the " + host + " host "
            "(csrc/plan_rhs.cuh).\n#include \"plan_rhs.cuh\"\n\n"
            + gen.body() + "\n" + entries + "\n")


def host_source(plan: FusedPlan, threads: int) -> str:
    """Host C++ of the plan's segments with a plain host evaluator, for the
    codegen tests: `plan_eval_f32` / `plan_eval_f64`(t, y [B][D], c, sc,
    B, out [B][out_rows], live, red) evaluate the whole batch, each coupling
    reduced in the order of a K2 block of `threads` threads. Include after
    a shim that defines __host__, __device__ and __forceinline__ empty."""
    gen = _Gen(plan)
    D, R = plan.dim, plan.out_rows
    evals = []
    for t, ct in (("f32", "float"), ("f64", "double")):
        evals.append(f"""
extern "C" void plan_eval_{t}({ct} t, const {ct}* y, const {ct}* c,
                              const {ct}* sc, int B, {ct}* out, {ct}* live,
                              {ct}* red) {{
  tfd::HostMeet<{ct}> m{{live, red, B, {threads}}};
  for (int k = 0; k < tfd::Plan::kSegments; ++k) {{
    for (int b = 0; b < B; ++b)
      tfd::Plan::seg<{ct}>(k, t, y + long(b) * {D}, c, sc, b, B, live, red,
                           out + long(b) * {R});
    if (k + 1 < tfd::Plan::kSegments) tfd::Plan::meet(k, m);
  }}
}}""")
    return ("#include <vector>\n#include \"plan_ops.cuh\"\n\n"
            "namespace tfd {\n" + _HOST_MEET + "}  // namespace tfd\n\n"
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
