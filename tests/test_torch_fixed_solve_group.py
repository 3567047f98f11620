"""PyTorch port: K8 with a group of threads a sample, what the CPU can hold.

K8 (the whole fixed-grid solve) walks each sample on its MLP routes with a
group of threads (16 on the narrow route, `cuda_fixed.FIXED_WIDE_GROUP` on
the wide one) in 512-thread blocks: the members split the stage states,
the Kahan update and the Hermite drain a feature a member, and each layer
of an evaluation an output a member, up to four outputs at a time in one
pass over the inputs, reading the weights transposed (csrc/mlp_rk.cuh
transpose_weights, mlp_eval_lanes). Each output stays the same sum in
input order, then the time column, then the bias, so the plain version
did not change. Held here, with no card:

- a Python mirror of the group walk (the transposed weights' index, which
  member computes which output and feature, each sum's order) against
  `cuda_kernels._net_plain`, the plain version's evaluation, for the
  narrow and wide groups and nets with and without a time column, in
  float32 and float64: bitwise;
- the block and workspace sizes the launch checks (csrc/lane_group.h,
  compiled as host C++ and called through ctypes) against their Python
  counterparts in `ops/cuda_fixed.py`, and the layout's constants against
  the wrapper's (skipped without a host compiler);
- `mlp_solve_fixed_plain` on a narrow net (B = 33), a narrow net with a
  time column (B = 100, reverse time) and a wide one past 128 (B = 1)
  against float64 fingerprints taken from the tree before the change;
- the same plain version against the reference in interpret mode
  (`pallas_fixed.mlp_solve_fixed`, pack=1) with the bar of
  tests/test_torch_fixed_fused.py: identical stats, float64 within 1e-12.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import pallas_fixed as JPF
from tfdiffeq_tpu.ops.pallas_kernels import pad_mlp_weights
from tfdiffeq_tpu_torch.ops import cuda_fixed as PFX, cuda_kernels as PK

F64, F32 = torch.float64, torch.float32
CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")
#: csrc/mlp_rk.cuh kLaneOuts: the outputs a member sums in one pass.
LANE_OUTS = 4


# ---------------------------------------------------------------------------
# The group walk, mirrored
# ---------------------------------------------------------------------------

def transpose_mirror(packed: np.ndarray, dims) -> np.ndarray:
    """csrc/mlp_rk.cuh transpose_weights, element by element: layer l's
    weight (o, i), packed at w_off + o din + i, goes to w_off + i dout + o;
    the biases stay where they were. Every position is written once."""
    wt = np.full_like(packed, np.nan)
    offs, off = [], 0
    for din, dout in dims:
        offs.append((off, off + din * dout))
        off += din * dout + dout
    written = np.zeros(packed.shape[0], dtype=int)
    for r in range(packed.shape[0]):
        l = 0
        while l + 1 < len(dims) and r >= offs[l + 1][0]:
            l += 1
        w_off, b_off = offs[l]
        at = r
        if r < b_off:
            din, dout = dims[l]
            idx = r - w_off
            at = w_off + (idx % din) * dout + idx // din
        wt[at] = packed[r]
        written[at] += 1
    assert (written == 1).all()
    return wt


def lanes_eval_mirror(wt: np.ndarray, dims, act, final_act, input_power,
                      time_input, t, y: np.ndarray, gsz: int):
    """mlp_eval_lanes for every sample of y [B, D] at once: member m of the
    gsz sums outputs o0 + j gsz (j < 4) of each pass o0 = m, m + 4 gsz,
    ..., each from the product with input 0, then inputs 1 .. in order,
    the time column, the bias; the activation on the layer's outputs
    (`act`, `final_act`: the plain version's functions). Returns [B, D]
    and the member that computed each output of each layer."""
    dt = y.dtype.type
    h = y.copy()
    for _ in range(input_power - 1):
        h = h * y
    owners = []
    off = 0
    for l, (din, dout) in enumerate(dims):
        W, bias = wt[off:off + din * dout], wt[off + din * dout:
                                                off + din * dout + dout]
        off += din * dout + dout
        tcol = time_input and l == 0
        n_state = din - 1 if tcol else din
        z = np.full((y.shape[0], dout), np.nan, dtype=y.dtype)
        owner = np.full(dout, -1)
        for m in range(gsz):
            for o0 in range(m, dout, LANE_OUTS * gsz):
                nj = min(LANE_OUTS, -(-(dout - o0) // gsz))
                for j in range(nj):
                    o = o0 + j * gsz
                    acc = W[o] * h[:, 0]
                    for i in range(1, n_state):
                        acc = acc + W[i * dout + o] * h[:, i]
                    if tcol:
                        acc = acc + W[n_state * dout + o] * dt(t)
                    assert owner[o] == -1
                    owner[o] = m
                    z[:, o] = acc + bias[o]
        assert (owner >= 0).all()
        owners.append(owner)
        fn = final_act if l == len(dims) - 1 else act
        h = fn(torch.from_numpy(z)).numpy()
    return h, owners


#: (dims, activation, input_power, time_input)
MIRROR_NETS = [
    (((2, 50), (50, 2)), "tanh", 3, False),            # the spiral
    (((3, 16), (16, 16), (16, 2)), "elu", 1, True),    # a time column
    (((5, 144), (144, 7)), "silu", 2, False),          # past the narrow
    (((4, 300), (300, 9)), "softplus", 1, True),       # odd wide outputs
]


@pytest.mark.parametrize("gsz", [16, 32, 64, 128])
@pytest.mark.parametrize("net", range(len(MIRROR_NETS)))
def test_group_walk_mirror_is_the_plain_evaluation(net, gsz):
    """The kernel's walk, written out, gives bitwise `_net_plain`'s
    outputs (the plain version's evaluation) in float32 and float64, and
    each output of each layer has exactly one member, m = o mod gsz."""
    dims, act, power, ti = MIRROR_NETS[net]
    rng = np.random.RandomState(net)
    W = [(rng.randn(a, b) * 0.5 / np.sqrt(a), rng.randn(b) * 0.1)
         for a, b in dims]
    y = rng.randn(9, dims[-1][1])
    for tdt, ndt in ((F64, np.float64), (F32, np.float32)):
        pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                      for a, b in W], tdt)
        wt = transpose_mirror(pw.numpy(), pd)
        got, owners = lanes_eval_mirror(
            wt, pd, PK._ACTIVATIONS[act], PK._ACTIVATIONS["identity"],
            power, ti, 0.375, y.astype(ndt), gsz)
        want = PK._net_plain(pw, pd, act, "identity", power, ti)(
            torch.tensor(0.375, dtype=tdt), torch.tensor(y, dtype=tdt))
        assert np.array_equal(got, want.numpy())
        for owner, (_, dout) in zip(owners, pd):
            assert np.array_equal(owner, np.arange(dout) % gsz)


# ---------------------------------------------------------------------------
# The block and the workspace: csrc/lane_group.h against ops/cuda_fixed.py
# ---------------------------------------------------------------------------

_SHIM = """#include "lane_group.h"
extern "C" int block() { return tfd::kGroupBlock; }
extern "C" int samples(int group) { return tfd::group_samples(group); }
extern "C" int group_ok(int group) { return tfd::group_size_ok(group); }
extern "C" long fixed_slot(int S, int D, int gw) {
  return tfd::fixed_solve_slot_values(S, D, gw);
}
extern "C" long perlane_slot(int S, int D, int gw) {
  return tfd::perlane_solve_slot_values(S, D, gw);
}
extern "C" long work_size(long slot, int B, int group, long n_wt) {
  return tfd::group_solve_work_size(slot, B, group, n_wt);
}
extern "C" long smem_bytes() { return tfd::kLaneSmemBytes; }
"""


def build_shim(tmp_path_factory):
    """csrc/lane_group.h compiled as host C++ into a ctypes library."""
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("solve_group")
    cpp, so = d / "solve_group.cpp", d / "solve_group.so"
    cpp.write_text(_SHIM)
    subprocess.run([CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_long, ctypes.c_int
    for name in ("fixed_slot", "perlane_slot"):
        getattr(lib, name).argtypes = [I, I, I]
        getattr(lib, name).restype = L
    lib.work_size.argtypes = [L, I, I, L]
    lib.work_size.restype = L
    lib.smem_bytes.restype = L
    return lib


@pytest.fixture(scope="module")
def solve_group(tmp_path_factory):
    return build_shim(tmp_path_factory)


# dims of MLPs: the spiral, a time column, the wide net, deep narrow.
NETS = [((2, 50), (50, 2)), ((3, 16), (16, 2)),
        ((128, 256), (256, 256), (256, 128)),
        ((4, 8), (8, 8), (8, 8), (8, 4))]


@pytest.mark.parametrize("dims", NETS)
def test_block_and_work_size_match_the_launch(solve_group, dims):
    """K8's block, samples a block, slot and workspace (what the wrapper
    allocates) equal csrc/lane_group.h's (what the launch checks), on both
    MLP routes, for ragged B; the wrapper's groups are ones the launch
    takes."""
    D = dims[-1][1]
    gw = max(w for dd in dims for w in dd)
    n_w = sum(i * o + o for i, o in dims)
    assert solve_group.block() == PFX.FIXED_GROUP_THREADS == 512
    assert PFX.fixed_group(PK.ROUTE_NARROW) == PFX.FIXED_GROUP == 16
    assert PFX.fixed_group(PK.ROUTE_WIDE) == PFX.FIXED_WIDE_GROUP
    for route in (PK.ROUTE_NARROW, PK.ROUTE_WIDE):
        group = PFX.fixed_group(route)
        assert solve_group.group_ok(group)
        assert solve_group.samples(group) * group == PFX.FIXED_GROUP_THREADS
        for S in (1, 2, 4):
            slot = PFX._fixed_slot_values(S, D, dims)
            assert solve_group.fixed_slot(S, D, gw) == slot
            for B in (1, 33, 100, 4096, 4097):
                n_wt = PFX._wt_values(route, n_w)
                assert n_wt == (n_w if route == PK.ROUTE_WIDE else 0)
                assert solve_group.work_size(slot, B, group, n_wt) == \
                    PFX._solve_work_size(slot, B, group, n_wt)
    # The spiral's 32 slots take about 15 KB of shared memory in float32.
    if dims == NETS[0]:
        assert 32 * 4 * PFX._fixed_slot_values(4, 2, dims) < 16 * 1024
    assert solve_group.smem_bytes() == PK.MAX_WEIGHT_BYTES
    for bad in (0, 8, 24, 1024):
        assert not solve_group.group_ok(bad)


# ---------------------------------------------------------------------------
# The plain version: fingerprints and the reference
# ---------------------------------------------------------------------------

def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()[:16]


# name: (dims, activation, input_power, time_input, method, B, sign,
#        grid points)
K8_CASES = {
    "narrow": ((2, 16, 2), "tanh", 3, False, "rk4", 33, 1.0, 17),
    "narrow_time": ((3, 12, 12, 2), "elu", 1, True, "rk4_38", 100, -1.0,
                    None),
    "wide": ((2, 160, 2), "tanh", 1, False, "midpoint", 1, 1.0, 9),
}

#: sha256 prefixes of the output and the stats of the plain K8 before the
#: change, float64.
FINGERPRINTS = {
    "narrow": ("2add4d5f07034d47", [65, 16, 0, 0]),
    "narrow_time": ("fe411a26d3940a05", [25, 6, 0, 0]),
    "wide": ("abb12ffab028bfe2", [17, 8, 0, 0]),
}


def _k8_case(name):
    dims, act, power, ti, method, B, sign, n_grid = K8_CASES[name]
    rng = np.random.RandomState(31)
    W = [(rng.randn(a, b) * 0.4 / np.sqrt(a), rng.randn(b) * 0.05)
         for a, b in zip(dims[:-1], dims[1:])]
    y0 = np.random.RandomState(32).randn(B, dims[-1])
    t = np.array([0.0, 0.3, 0.55, 1.0, 1.7, 2.0, 2.25])
    tau = t if sign > 0 else (-t)[::-1].copy()
    grid = tau if n_grid is None else np.linspace(tau[0], tau[-1], n_grid)
    kw = dict(activation=act, input_power=power, time_input=ti,
              method=method)
    return W, y0, tau, grid, sign, kw


def _plain(name):
    W, y0, tau, grid, sign, kw = _k8_case(name)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    return PFX.mlp_solve_fixed(pw, pd, torch.tensor(y0), torch.tensor(tau),
                               torch.tensor(grid), sign, **kw)


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_plain_version_keeps_its_bits(name):
    """The plain K8 (the wrapper on CPU tensors) gives bitwise its results
    before the kernel took a group of threads a sample."""
    out, st = _plain(name)
    assert (_digest(out), st.tolist()) == FINGERPRINTS[name]


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_plain_version_matches_reference(name):
    """The plain K8 against the reference's `mlp_solve_fixed` in interpret
    mode with pack=1: identical stats, float64 within 1e-12."""
    W, y0, tau, grid, sign, kw = _k8_case(name)
    jw, jd = pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                              for a, b in W], jnp.float64)
    jo, js = JPF.mlp_solve_fixed(jw, jd, jnp.asarray(y0.T),
                                 jnp.asarray(tau), jnp.asarray(grid),
                                 jnp.asarray(sign), interpret=True, pack=1,
                                 **kw)
    out, st = _plain(name)
    assert st.tolist() == [int(x) for x in js] and st[3].item() == 0
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jo).transpose(0, 2, 1), rtol=0,
                               atol=1e-12)
