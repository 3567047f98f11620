"""PyTorch port: `utils/flops.py` against the JAX package's.

The port keeps the reference's counting conventions, so every count equals
the reference's for the same dims: the totals always; and where a layer
runs a reduced dot tier on K4 (the tensor cores), the tensor-core share
equals the reference's MXU share and the CUDA-core share its VPU share,
since both route a layer by the same `_layer_uses_mxu` rule. At the default
'highest' tier every operation is a CUDA-core one. The peaks are the
H100's published figures, and the utilisations divide by them.
"""

import pytest
import torch

from tfdiffeq_tpu.utils import flops as JF
from tfdiffeq_tpu_torch.utils import flops as PF

NETS = {
    "spiral": ([(2, 50), (50, 2)], 4096, 3),
    "wide": ([(128, 256), (256, 256), (256, 128)], 1024, 1),
    "cnf": ([(3, 32), (32, 32), (32, 2)], 4096, 1),
    "latent": ([(4, 20), (20, 20), (20, 4)], 1000, 1),
}


@pytest.mark.parametrize("matmul", ["auto", "vpu", "mxu"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_mlp_counts_match_the_reference(name, matmul):
    dims, B, power = NETS[name]
    ref = JF.mlp_flops_per_nfe(dims, B, input_power=power, matmul=matmul)
    for tier in ("mixed", "bf16"):
        got = PF.mlp_flops_per_nfe(dims, B, input_power=power,
                                   matmul=matmul, dot_precision=tier)
        assert (got.tensor, got.cuda) == (ref.mxu, ref.vpu)
    got = PF.mlp_flops_per_nfe(dims, B, input_power=power, matmul=matmul)
    assert got.tensor == 0.0 and got.cuda == ref.total == got.total


@pytest.mark.parametrize("D, B, stages", [(2, 4096, 7), (128, 1024, 7),
                                          (3, 4096, 4)])
def test_solver_overhead_matches_the_reference(D, B, stages):
    assert PF.solver_overhead_flops_per_step(D, B, n_stages=stages) == \
        JF.solver_overhead_flops_per_step(D, B, n_stages=stages)


@pytest.mark.parametrize("B", [128, 256])
def test_conv_counts_match_the_reference(B):
    ref = JF.conv_ode_flops_per_nfe(7, 7, 64, B)
    got = PF.conv_ode_flops_per_nfe(7, 7, 64, B)
    assert got.total == ref.total and got.tensor == 0.0


def test_peaks_and_utilisation():
    """The H100 SXM peaks PERF.md and chip_smoke.py divide by, and each
    unit's share of its own peak (float64 on the CUDA cores at 34e12)."""
    assert (PF.PEAK_F32_CUDA, PF.PEAK_F64_CUDA, PF.PEAK_F64_TENSOR,
            PF.PEAK_BF16_TENSOR, PF.PEAK_HBM_BYTES) == \
        (67e12, 34e12, 67e12, 989e12, 3.35e12)
    c = PF.FlopCount(tensor=989e9, cuda=67e9)
    a = c.achieved(10.0)
    assert a["tensor_util_bf16_pct"] == 1.0 and a["cuda_util_pct"] == 1.0
    a64 = PF.FlopCount(tensor=0.0, cuda=34e9).achieved(
        10.0, dtype=torch.float64)
    assert a64["cuda_util_pct"] == 1.0
    assert a["flops_per_nfe_cuda"] == 67e9


@pytest.mark.parametrize("products, other, want", [
    (67e12, 0.0, 1.0), (0.0, 34e12, 1.0), (67e12, 34e12, 2.0),
    (0.0, 0.0, 0.0)])
def test_float64_ops_s(products, other, want):
    """A float64 bound counts products at the FP64 tensor cores' 67e12 and
    every other operation at the CUDA cores' 34e12, the two added."""
    assert PF.float64_ops_s(products, other) == want
