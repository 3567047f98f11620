"""Analytic operation counts of the port's workloads, and the H100 peaks
to divide them by.

Counterpart of `tfdiffeq_tpu/utils/flops.py`, with the reference's
counting conventions, so every count equals the reference's for the same
dims: a product [m, k] @ [k, n] counts 2 m k n, an elementwise add or
multiply 1 an element, a transcendental function (tanh, exp, erf)
`TRANSCENDENTAL_FLOPS` = 8 an element. What differs is the split by unit,
which follows the port's routes: a layer's product runs on the tensor cores
only where K4 takes it (a reduced dot tier, 'mixed' or 'bf16', on a layer
that `matmul` selects: `ops/cuda_kernels.layer_tiers`); every other
operation, the 'highest' tier's products and the ODE-Net's convolutions
(K13) included, runs on the CUDA cores.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power
limit; the card this port is measured on reports `NVIDIA H100 80GB HBM3,
700.00 W` to `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`), the figures PERF.md's kernel table and
chip_smoke.py's bounds divide by:

- `PEAK_F32_CUDA` = 67e12 FLOP/s: float32 on the CUDA cores.
- `PEAK_F64_CUDA` = 34e12 FLOP/s: float64 on the CUDA cores (the float64
  tier, `ops/doublefloat.py`, and every float64 solve).
- `PEAK_F64_TENSOR` = 67e12 FLOP/s: float64 products on the tensor cores
  (full float64 precision). The port's float64 kernels run their products
  on the CUDA cores, but a float64 bound (`float64_ops_s`) counts them at
  this rate, the card's fastest for the type.
- `PEAK_BF16_TENSOR` = 989e12 FLOP/s: dense bf16 on the tensor cores (K4's
  tier products; 'mixed' makes two bf16 passes of each product, counted
  once here, as the reference counts its passes once).
- `PEAK_HBM_BYTES` = 3.35e12 B/s: HBM3.

A card set below 700 W runs slower under load than these peaks assume.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

PEAK_F32_CUDA = 67e12
PEAK_F64_CUDA = 34e12
PEAK_F64_TENSOR = 67e12
PEAK_BF16_TENSOR = 989e12
PEAK_HBM_BYTES = 3.35e12
TRANSCENDENTAL_FLOPS = 8


@dataclasses.dataclass(frozen=True)
class FlopCount:
    """Operations of ONE dynamics evaluation (NFE) at batch B, split by the
    unit that executes them in the port's kernels."""
    tensor: float       # K4's tier products on the tensor cores
    cuda: float         # everything else, on the CUDA cores

    @property
    def total(self) -> float:
        return self.tensor + self.cuda

    def achieved(self, nfe_per_sec: float,
                 dtype: torch.dtype = torch.float32) -> dict:
        """FLOP/s and the share of each unit's peak at a measured NFE/s:
        the tensor cores against the bf16 peak, the CUDA cores against the
        peak of `dtype` (float32 or float64)."""
        cuda_peak = PEAK_F64_CUDA if dtype == torch.float64 else PEAK_F32_CUDA
        tensor_fs = self.tensor * nfe_per_sec
        cuda_fs = self.cuda * nfe_per_sec
        return {
            "flops_per_nfe_tensor": round(self.tensor, 1),
            "flops_per_nfe_cuda": round(self.cuda, 1),
            "achieved_tensor_flop_per_sec": round(tensor_fs, 1),
            "achieved_cuda_flop_per_sec": round(cuda_fs, 1),
            "tensor_util_bf16_pct": round(100 * tensor_fs / PEAK_BF16_TENSOR,
                                          3),
            "cuda_util_pct": round(100 * cuda_fs / cuda_peak, 3),
        }


def float64_ops_s(products: float, other: float) -> float:
    """Seconds the card needs at least for float64 work: its products
    (a multiply and an add a weight) at `PEAK_F64_TENSOR` plus its other
    operations at `PEAK_F64_CUDA`."""
    return products / PEAK_F64_TENSOR + other / PEAK_F64_CUDA


def mlp_flops_per_nfe(dims: Sequence[Tuple[int, int]], B: int, *,
                      input_power: int = 1, time_input: bool = False,
                      matmul: str = "auto",
                      dot_precision: str = "highest") -> FlopCount:
    """Operations of one MLP dynamics evaluation f(t, y) at batch B.

    dims: [(din, dout), ...] a layer (din includes the t column when
    time_input). A layer's product counts on the tensor cores where
    `layer_tiers(dims, matmul, dot_precision)` gives it a reduced tier,
    else on the CUDA cores; at the default 'highest' tier every operation
    is a CUDA-core one."""
    from ..ops.cuda_kernels import layer_tiers

    tiers = layer_tiers(tuple(dims), matmul, dot_precision)
    tensor = 0.0
    cuda = (input_power - 1) * dims[0][0] * B          # y**p input transform
    for li, ((din, dout), tier) in enumerate(zip(dims, tiers)):
        flops = 2.0 * din * dout * B                   # the product
        if tier != "highest":
            tensor += flops
        else:
            cuda += flops
        cuda += dout * B                               # + bias
        if li != len(dims) - 1:
            cuda += TRANSCENDENTAL_FLOPS * dout * B    # activation
    return FlopCount(tensor=tensor, cuda=float(cuda))


def solver_overhead_flops_per_step(D: int, B: int, *,
                                   n_stages: int = 7) -> float:
    """CUDA-core operations of ONE dopri5 attempt's solver arithmetic over
    a [B, D] state (stage combines, y1 and error sums, the error scale and
    norm, the interpolant fit), the part a whole-solve kernel fuses; the
    reference's count."""
    per_elem = (sum(2 * i for i in range(1, n_stages)) +   # stage combines
                2 * 2 * n_stages +                          # y1 + err sums
                8 +                                         # scale/norm
                20)                                         # interp fit
    return float(per_elem * D * B)


def conv_ode_flops_per_nfe(H: int, W: int, C: int, B: int, *,
                           groups: int = 32) -> FlopCount:
    """Operations of one ODE-Net block evaluation (GroupNorm -> relu ->
    ConcatConv3x3, twice, -> GroupNorm) at [B, C, H, W], the reference's
    count: each conv (C + 1 input channels with the t map, C outputs) as
    2 * 9 (C + 1) C a position, three GroupNorms at 4 C a position, two
    relus. K13 runs all of it on the CUDA cores."""
    npix = H * W * B
    conv = 2.0 * 9 * (C + 1) * C * npix
    gn = 3 * (4.0 * C * npix)
    relu = 2 * C * npix
    return FlopCount(tensor=0.0, cuda=2 * conv + gn + relu)
