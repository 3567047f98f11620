"""Butcher tableaus for explicit Runge–Kutta methods.

Counterpart of `tfdiffeq_tpu/ops/tableaus.py`, which is numpy-only already:
the coefficients here are the same exact rationals rounded to Python floats
(tests/test_torch_tableaus.py holds the two modules equal). The solvers of
this package read them as plain floats; `ops/cuda_kernels.py` hands them to
the whole-solve kernel as launch arguments, so one binary serves every
tableau.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction as Fr
from typing import Optional, Tuple

import numpy as np


def _f(x) -> float:
    return float(x)


def derive_c_mid(c, a, theta: float = 0.5) -> Tuple[float, ...]:
    """Derive 4th-order dense-output midpoint weights for an explicit RK
    tableau by solving the 8 order conditions for a continuous extension
    b(theta) at theta (see Hairer–Nørsett–Wanner II.6):

        sum b = th; sum b c = th^2/2; sum b c^2 = th^3/3; sum b (A c) = th^3/6;
        sum b c^3 = th^4/4; sum b c(Ac) = th^4/8; sum b (A c^2) = th^4/12;
        sum b (A A c) = th^4/24.

    Solved by least squares; callers must only use the result if the residual
    is ~0 (i.e. the tableau admits a 4th-order interpolant), which is checked
    here with an assertion. Validated against dopri5's published DPS_C_MID
    (residual ~1e-17)."""
    c = np.asarray(c, dtype=np.float64)
    S = c.shape[0]
    A = np.zeros((S, S))
    for i, row in enumerate(a):
        A[i + 1, : len(row)] = row
    Ac = A @ c
    M = np.stack([np.ones(S), c, c ** 2, Ac, c ** 3, c * Ac,
                  A @ (c ** 2), A @ Ac])
    th = theta
    rhs = np.array([th, th ** 2 / 2, th ** 3 / 3, th ** 3 / 6,
                    th ** 4 / 4, th ** 4 / 8, th ** 4 / 12, th ** 4 / 24])
    sol, _, _, _ = np.linalg.lstsq(M, rhs, rcond=None)
    resid = float(np.abs(M @ sol - rhs).max())
    assert resid < 1e-10, f"tableau admits no 4th-order interpolant ({resid})"
    return tuple(float(x) for x in sol)


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit RK tableau.

    Attributes:
      name: method name.
      c: stage times, length S (c[0] == 0).
      a: lower-triangular stage coefficients; a[i] has length i (rows 1..S-1).
      b_sol: solution weights, length S.
      b_err: embedded error weights (b_sol - b_hat), length S. Empty tuple for
        fixed-step tableaus with no embedded estimate.
      c_mid: optional dense-output midpoint weights (length S): the 4th-order
        interpolant's y_mid = y0 + dt * sum(c_mid[i] * k[i]). When absent the
        solver falls back to a 3rd-order cubic-Hermite interpolant.
      order: order of the solution polynomial (used for step-size exponents,
        matching the reference's `_optimal_step_size(..., order=...)`).
      fsal: first-same-as-last — the final stage equals f(t1, y1), so the next
        step reuses it (dopri5/bosh3/tsit5 in the reference).
    """

    name: str
    c: Tuple[float, ...]
    a: Tuple[Tuple[float, ...], ...]
    b_sol: Tuple[float, ...]
    b_err: Tuple[float, ...]
    order: int
    fsal: bool
    c_mid: Optional[Tuple[float, ...]] = None

    @property
    def stages(self) -> int:
        return len(self.c)

    @property
    def evals_per_step(self) -> int:
        """Fresh func evaluations per step, given an FSAL/f0 cache."""
        return self.stages - 1 if self.fsal else self.stages


# ---------------------------------------------------------------------------
# Dormand–Prince 5(4) with Shampine's dense-output midpoint.
# Reference: upstream `tfdiffeq/dopri5.py` (SURVEY.md §2); coefficients are
# the public Dormand & Prince (1980) / Shampine values.
# ---------------------------------------------------------------------------
_DP5_B_SOL = (Fr(35, 384), Fr(0), Fr(500, 1113), Fr(125, 192),
              Fr(-2187, 6784), Fr(11, 84), Fr(0))
_DP5_B_HAT = (Fr(5179, 57600), Fr(0), Fr(7571, 16695), Fr(393, 640),
              Fr(-92097, 339200), Fr(187, 2100), Fr(1, 40))

DOPRI5 = ButcherTableau(
    name="dopri5",
    c=(0.0, _f(Fr(1, 5)), _f(Fr(3, 10)), _f(Fr(4, 5)), _f(Fr(8, 9)), 1.0, 1.0),
    a=(
        (_f(Fr(1, 5)),),
        (_f(Fr(3, 40)), _f(Fr(9, 40))),
        (_f(Fr(44, 45)), _f(Fr(-56, 15)), _f(Fr(32, 9))),
        (_f(Fr(19372, 6561)), _f(Fr(-25360, 2187)), _f(Fr(64448, 6561)),
         _f(Fr(-212, 729))),
        (_f(Fr(9017, 3168)), _f(Fr(-355, 33)), _f(Fr(46732, 5247)),
         _f(Fr(49, 176)), _f(Fr(-5103, 18656))),
        (_f(Fr(35, 384)), 0.0, _f(Fr(500, 1113)), _f(Fr(125, 192)),
         _f(Fr(-2187, 6784)), _f(Fr(11, 84))),
    ),
    b_sol=tuple(_f(x) for x in _DP5_B_SOL),
    b_err=tuple(_f(s - h) for s, h in zip(_DP5_B_SOL, _DP5_B_HAT)),
    order=5,
    fsal=True,
    # Shampine's midpoint coefficients for the 4th-order interpolant
    # (upstream DPS_C_MID in `tfdiffeq/dopri5.py`).
    c_mid=(
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ),
)

# ---------------------------------------------------------------------------
# Bogacki–Shampine 3(2). Reference: upstream `tfdiffeq/bosh3.py`.
# ---------------------------------------------------------------------------
_BS3_B_SOL = (Fr(2, 9), Fr(1, 3), Fr(4, 9), Fr(0))
_BS3_B_HAT = (Fr(7, 24), Fr(1, 4), Fr(1, 3), Fr(1, 8))

BOSH3 = ButcherTableau(
    name="bosh3",
    c=(0.0, 0.5, 0.75, 1.0),
    a=(
        (0.5,),
        (0.0, 0.75),
        (_f(Fr(2, 9)), _f(Fr(1, 3)), _f(Fr(4, 9))),
    ),
    b_sol=tuple(_f(x) for x in _BS3_B_SOL),
    b_err=tuple(_f(s - h) for s, h in zip(_BS3_B_SOL, _BS3_B_HAT)),
    order=3,
    fsal=True,
)

# ---------------------------------------------------------------------------
# Adaptive Heun 2(1). Reference: upstream `tfdiffeq/adaptive_heun.py`.
# Not FSAL: the second stage point (y0 + dt*k1) is not the solution point.
# ---------------------------------------------------------------------------
ADAPTIVE_HEUN = ButcherTableau(
    name="adaptive_heun",
    c=(0.0, 1.0),
    a=((1.0,),),
    b_sol=(0.5, 0.5),
    b_err=(0.5, -0.5),  # b_sol - b_hat with b_hat = (1, 0) (Euler)
    order=2,
    fsal=False,
)

# ---------------------------------------------------------------------------
# Tsitouras 5(4) [Tsitouras 2011], the coefficients in common public use
# (e.g. OrdinaryDiffEq.jl / torchdiffeq's tsit5). Reference capability:
# upstream `tfdiffeq/tsit5.py` (SURVEY.md §2, [MED]).
# ---------------------------------------------------------------------------
_TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)

TSIT5 = ButcherTableau(
    name="tsit5",
    c=_TSIT5_C,
    a=_TSIT5_A,
    b_sol=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
           -3.290069515436081, 2.324710524099774, 0.0),
    # b_sol - b_hat (the published btilde error weights).
    b_err=(-0.00178001105222577714, -0.0008164344596567469,
           0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
           -0.45808210592918697, 0.015151515151515152),
    order=5,
    fsal=True,
    c_mid=derive_c_mid(_TSIT5_C, _TSIT5_A),
)

# Fixed-grid tableaus (no embedded error estimate). Reference:
# upstream `tfdiffeq/fixed_grid.py` Euler/Midpoint/RK4 (SURVEY.md §2).
EULER = ButcherTableau(
    name="euler", c=(0.0,), a=(), b_sol=(1.0,), b_err=(), order=1, fsal=False)

MIDPOINT = ButcherTableau(
    name="midpoint", c=(0.0, 0.5), a=((0.5,),), b_sol=(0.0, 1.0), b_err=(),
    order=2, fsal=False)

RK4 = ButcherTableau(
    name="rk4",
    c=(0.0, 0.5, 0.5, 1.0),
    a=((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b_sol=(_f(Fr(1, 6)), _f(Fr(1, 3)), _f(Fr(1, 3)), _f(Fr(1, 6))),
    b_err=(),
    order=4,
    fsal=False,
)

# The 3/8-rule variant the reference uses as `rk4_alt_step_func`
# (upstream `tfdiffeq/fixed_grid.py`).
RK4_38 = ButcherTableau(
    name="rk4_38",
    c=(0.0, _f(Fr(1, 3)), _f(Fr(2, 3)), 1.0),
    a=((_f(Fr(1, 3)),), (_f(Fr(-1, 3)), 1.0), (1.0, -1.0, 1.0)),
    b_sol=(_f(Fr(1, 8)), _f(Fr(3, 8)), _f(Fr(3, 8)), _f(Fr(1, 8))),
    b_err=(),
    order=4,
    fsal=False,
)


# ---------------------------------------------------------------------------
# Prince–Dormand 8(7) "13M" (Prince & Dormand 1981), 13 stages. Reference
# capability: upstream `tfdiffeq/dopri8.py` (SURVEY.md §2, [MED]). The
# rational coefficients below are the published PD8(7)13M values; order
# conditions are asserted numerically at import (`_check_tableau`).
# Dense output: 4th-order midpoint weights derived from the order conditions
# (derive_c_mid), matching the reference family's 4th-order interpolant.
# ---------------------------------------------------------------------------
_DP8_C = (
    Fr(0), Fr(1, 18), Fr(1, 12), Fr(1, 8), Fr(5, 16), Fr(3, 8),
    Fr(59, 400), Fr(93, 200), Fr(5490023248, 9719169821), Fr(13, 20),
    Fr(1201146811, 1299019798), Fr(1), Fr(1),
)
_DP8_A = (
    (Fr(1, 18),),
    (Fr(1, 48), Fr(1, 16)),
    (Fr(1, 32), Fr(0), Fr(3, 32)),
    (Fr(5, 16), Fr(0), Fr(-75, 64), Fr(75, 64)),
    (Fr(3, 80), Fr(0), Fr(0), Fr(3, 16), Fr(3, 20)),
    (Fr(29443841, 614563906), Fr(0), Fr(0), Fr(77736538, 692538347),
     Fr(-28693883, 1125000000), Fr(23124283, 1800000000)),
    (Fr(16016141, 946692911), Fr(0), Fr(0), Fr(61564180, 158732637),
     Fr(22789713, 633445777), Fr(545815736, 2771057229),
     Fr(-180193667, 1043307555)),
    (Fr(39632708, 573591083), Fr(0), Fr(0), Fr(-433636366, 683701615),
     Fr(-421739975, 2616292301), Fr(100302831, 723423059),
     Fr(790204164, 839813087), Fr(800635310, 3783071287)),
    (Fr(246121993, 1340847787), Fr(0), Fr(0),
     Fr(-37695042795, 15268766246), Fr(-309121744, 1061227803),
     Fr(-12992083, 490766935), Fr(6005943493, 2108947869),
     Fr(393006217, 1396673457), Fr(123872331, 1001029789)),
    (Fr(-1028468189, 846180014), Fr(0), Fr(0), Fr(8478235783, 508512852),
     Fr(1311729495, 1432422823), Fr(-10304129995, 1701304382),
     Fr(-48777925059, 3047939560), Fr(15336726248, 1032824649),
     Fr(-45442868181, 3398467696), Fr(3065993473, 597172653)),
    (Fr(185892177, 718116043), Fr(0), Fr(0), Fr(-3185094517, 667107341),
     Fr(-477755414, 1098053517), Fr(-703635378, 230739211),
     Fr(5731566787, 1027545527), Fr(5232866602, 850066563),
     Fr(-4093664535, 808688257), Fr(3962137247, 1805957418),
     Fr(65686358, 487910083)),
    (Fr(403863854, 491063109), Fr(0), Fr(0), Fr(-5068492393, 434740067),
     Fr(-411421997, 543043805), Fr(652783627, 914296604),
     Fr(11173962825, 925320556), Fr(-13158990841, 6184727034),
     Fr(3936647629, 1978049680), Fr(-160528059, 685178525),
     Fr(248638103, 1413531060), Fr(0)),
)
_DP8_B_SOL = (
    Fr(14005451, 335480064), Fr(0), Fr(0), Fr(0), Fr(0),
    Fr(-59238493, 1068277825), Fr(181606767, 758867731),
    Fr(561292985, 797845732), Fr(-1041891430, 1371343529),
    Fr(760417239, 1151165299), Fr(118820643, 751138087),
    Fr(-528747749, 2220607170), Fr(1, 4),
)
_DP8_B_HAT = (
    Fr(13451932, 455176623), Fr(0), Fr(0), Fr(0), Fr(0),
    Fr(-808719846, 976000145), Fr(1757004468, 5645159321),
    Fr(656045339, 265891186), Fr(-3867574721, 1518517206),
    Fr(465885868, 322736535), Fr(53011238, 667516719), Fr(2, 45), Fr(0),
)


def _check_tableau(c, a, b_sol, b_hat, order_sol: int, order_hat: int):
    """Order-condition checks catching transcription typos: row-sum
    consistency (sum a[i] ~= c[i]) and the quadrature conditions
    sum b c^m ~= 1/(m+1) for m < order for both weight vectors. The
    published PD coefficients are rational approximations accurate to
    ~1e-18, so compare in float with a tight tolerance."""
    tol = 5e-15
    for i, row in enumerate(a):
        assert abs(float(sum(row) - c[i + 1])) < tol, f"row {i + 1} sum != c"
    for m in range(order_sol):
        r = float(sum(b * ci ** m for b, ci in zip(b_sol, c)) - Fr(1, m + 1))
        assert abs(r) < tol, f"b_sol fails quadrature order {m}: {r}"
    for m in range(order_hat):
        r = float(sum(b * ci ** m for b, ci in zip(b_hat, c)) - Fr(1, m + 1))
        assert abs(r) < tol, f"b_hat fails quadrature order {m}: {r}"


_check_tableau(_DP8_C, _DP8_A, _DP8_B_SOL, _DP8_B_HAT, 8, 7)

DOPRI8 = ButcherTableau(
    name="dopri8",
    c=tuple(_f(x) for x in _DP8_C),
    a=tuple(tuple(_f(x) for x in row) for row in _DP8_A),
    b_sol=tuple(_f(x) for x in _DP8_B_SOL),
    b_err=tuple(_f(s - h) for s, h in zip(_DP8_B_SOL, _DP8_B_HAT)),
    order=8,
    fsal=False,
    c_mid=derive_c_mid(tuple(float(x) for x in _DP8_C),
                       tuple(tuple(float(x) for x in row) for row in _DP8_A)),
)


# Single source of truth for the adaptive method name -> tableau map
# (odeint.py, ops/cuda_kernels.py and the fast.py front-ends all resolve
# through this).
TABLEAUS_BY_NAME = {
    "dopri5": DOPRI5,
    "bosh3": BOSH3,
    "adaptive_heun": ADAPTIVE_HEUN,
    "tsit5": TSIT5,
    "dopri8": DOPRI8,
}

# ... and of the fixed-grid one (the reference keeps it in
# ops/pallas_fixed.py:51-56).
FIXED_TABLEAUS_BY_NAME = {
    "euler": EULER,
    "midpoint": MIDPOINT,
    "rk4": RK4,
    "rk4_38": RK4_38,
}
