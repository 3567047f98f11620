"""PyTorch port: the ODE-Net MNIST classifier (`models/odenet.py`,
`examples/odenet_mnist.py`) against the JAX package's flax modules and
example.

Parameters come from flax `init` and are carried across as numpy by
`convert.odenet_from_flax`; inputs are drawn with numpy and transposed from
the reference's NHWC to the port's NCHW. Tolerances are the JAX tests' own
(tests/test_conv_ode.py): logits within 1e-4, the fused block within 1e-4
of the generic one, adjoint gradients within 1e-4 + 5e-2 max|g| (the
solves run at tol 1e-3, so two solvers' gradients differ at that level).
"""

import gzip
import struct
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples import odenet_mnist as JX  # noqa: E402
from tfdiffeq_tpu.models import odenet as JM  # noqa: E402
from tfdiffeq_tpu_torch import convert  # noqa: E402
from tfdiffeq_tpu_torch.examples import odenet_mnist as PX  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(y):
    return np.moveaxis(np.asarray(y), 1, -1)


@pytest.mark.parametrize("network", ["odenet", "resnet"])
def test_logits_match_flax(network):
    """ODENetMNIST (features 32, B = 2, 28x28) through the generic ODE
    block, or two ResBlocks: logits within 1e-4 of flax's, and the block's
    NFE reported."""
    kw = dict(n_res_blocks=2) if network == "resnet" else {}
    model = JM.ODENetMNIST(features=32, network=network, **kw)
    x = np.random.RandomState(0).randn(2, 28, 28, 1).astype(np.float32)
    vs = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, _ = model.apply(vs, jnp.asarray(x), mutable=["diagnostics"])
    port = convert.odenet_from_flax(_np(vs))
    assert port.network == network
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert (port.nfe > 0) == (network == "odenet")


@pytest.mark.parametrize("size", [28, 14])
def test_stride_two_stem_conv_is_flax_same(size):
    """The stem's 4x4 stride-2 convs: nn.Conv2d(padding=1) is flax's SAME
    padding for 28 -> 14 and 14 -> 7."""
    conv = nn.Conv(8, (4, 4), strides=(2, 2), padding="SAME")
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    vs = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(conv.apply(vs, jnp.asarray(x)))
    port = torch.nn.Conv2d(3, 8, 4, stride=2, padding=1)
    convert._load_conv(port, vs["params"], None, torch.float32)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape == (2, size // 2, size // 2, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _block_case():
    x = (np.random.RandomState(4).randn(2, 7, 7, 16) * 0.5) \
        .astype(np.float32)
    blk = JM.ODEBlock(features=16, tol=1e-3, adjoint=True)
    vs = _np(blk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return blk, vs, x


def test_fused_block_matches_generic():
    """ODEBlock(features=16, fused=True) (K13's plain version here, 16
    groups: min(32, features)) against the generic block, within 1e-4."""
    _, vs, x = _block_case()
    generic = convert.odenet_from_flax(vs)
    fused = convert.odenet_from_flax(vs, fused=True)
    assert fused.func.groups == 16
    with torch.no_grad():
        a, b = generic(_nchw(x)), fused(_nchw(x))
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    assert fused.nfe > 0 and generic.nfe > 0


def _grads(block, x):
    block.zero_grad()
    torch.sum(block(_nchw(x)) ** 2).backward()
    return {n: p.grad.clone() for n, p in block.named_parameters()}


def test_fused_adjoint_gradients():
    """ODEBlock(adjoint=True, fused=True) (K13 forward, generic adjoint
    backward): gradients against the all-generic adjoint block and against
    the JAX adjoint block's, d < 1e-4 + 5e-2 max|g|; the NFEMeter records
    the forward and backward solves."""
    from tfdiffeq_tpu_torch import NFEMeter
    blk, vs, x = _block_case()

    def loss(p):
        y, _ = blk.apply({"params": p}, jnp.asarray(x),
                         mutable=["diagnostics"])
        return jnp.sum(y ** 2)

    jg = _np(jax.grad(loss)(vs["params"]))["ODEConvFunc_0"]
    meter = NFEMeter()
    fused = _grads(convert.odenet_from_flax(vs, adjoint=True, fused=True,
                                            nfe_meter=meter), x)
    generic = _grads(convert.odenet_from_flax(vs, adjoint=True), x)
    assert meter.f_calls == 1 and meter.b_calls == 1 and meter.b_nfe > 0
    ref = {}
    for i, name in enumerate(("norm1", "norm2", "norm3")):
        g = jg[f"GroupNorm_{i}"]
        ref[f"func.{name}.weight"], ref[f"func.{name}.bias"] = \
            g["scale"], g["bias"]
    for i, name in enumerate(("conv1", "conv2")):
        g = jg[f"ConcatConv2d_{i}"]["Conv_0"]
        ref[f"func.{name}.conv.weight"] = np.transpose(g["kernel"],
                                                       (3, 2, 0, 1))
        ref[f"func.{name}.conv.bias"] = g["bias"]
    assert set(ref) == set(fused)
    for name, want in ref.items():
        for got in (fused[name].numpy(), generic[name].numpy()):
            d = np.abs(got - want).max()
            assert d < 1e-4 + 5e-2 * np.abs(want).max(), (name, d)
        d = np.abs(fused[name].numpy() - generic[name].numpy()).max()
        assert d < 1e-4 + 5e-2 * np.abs(generic[name].numpy()).max()


@pytest.mark.parametrize("gen", ["synthetic_mnist", "synthetic_digits"])
def test_synthetic_data_is_the_reference(gen):
    got = getattr(PX, gen)(n_train=24, n_test=8, seed=3)
    want = getattr(JX, gen)(n_train=24, n_test=8, seed=3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_idx_loader_reads_local_files(tmp_path):
    """load_mnist on four tiny idx files (two gzipped) that the test
    writes: the arrays come back as written, as the reference reads them."""
    rng = np.random.RandomState(0)
    arrays = {"train-images-idx3-ubyte": rng.randint(0, 256, (3, 28, 28)),
              "train-labels-idx1-ubyte": rng.randint(0, 10, 3),
              "t10k-images-idx3-ubyte": rng.randint(0, 256, (2, 28, 28)),
              "t10k-labels-idx1-ubyte": rng.randint(0, 10, 2)}
    for k, (name, a) in enumerate(arrays.items()):
        a = a.astype(np.uint8)
        blob = (struct.pack(">I", 0x0800 | a.ndim)
                + struct.pack(">" + "I" * a.ndim, *a.shape) + a.tobytes())
        if k % 2:
            with gzip.open(tmp_path / (name + ".gz"), "wb") as f:
                f.write(blob)
        else:
            (tmp_path / name).write_bytes(blob)
    got = PX.load_mnist(str(tmp_path))
    want = JX.load_mnist(str(tmp_path))
    for g, w, a in zip(got, want, arrays.values()):
        assert np.array_equal(g, a) and np.array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        PX.load_mnist(str(tmp_path / "missing"))


def test_main_trains_fused_adjoint(monkeypatch, capsys):
    """Two SGD steps of the example with --synthetic --adjoint --fused on
    the CPU (K13's plain version forward, the generic adjoint backward):
    a finite loss, the weights moved, one epoch line with f-NFE and b-NFE.
    Evaluation is cut to 8 test samples."""
    monkeypatch.setattr(PX, "EVAL_SAMPLES", 8)
    argv = ["--synthetic", "--adjoint", "--fused", "--limit_batches", "2",
            "--nepochs", "1", "--batch_size", "8", "--device", "cpu"]
    out = PX.main(argv)
    assert np.isfinite(out["loss"]) and 0.0 <= out["acc"] <= 1.0
    start = PX.build_model(PX.parse_args(argv))
    moved = max(float((p - q).detach().abs().max()) for p, q in
                zip(out["model"].parameters(), start.parameters()))
    assert moved > 0.0
    line = capsys.readouterr().out
    assert "Epoch 001" in line and "f-nfe" in line and "b-nfe" in line


def test_main_refusals(monkeypatch, tmp_path, capsys):
    # --train_dir (once refused here, ROADMAP item 19) saves an epoch and
    # resumes from it (tests/test_torch_checkpoint.py holds the bits).
    monkeypatch.setattr(PX, "EVAL_SAMPLES", 8)
    argv = ["--train_dir", str(tmp_path), "--synthetic", "--nepochs", "1",
            "--batch_size", "8", "--limit_batches", "1", "--device", "cpu"]
    PX.main(argv)
    PX.main(argv)
    assert "at epoch 1" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--adjoint"):
        PX.main(["--fused", "--synthetic", "--device", "cpu"])
    assert PX.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        PX.main(["--synthetic"])
