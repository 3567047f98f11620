"""PyTorch port: `utils/device.py` (`move_to_device`, `cast_double`,
`func_cast_double`) against the JAX package's `utils/device.py`.

The same numpy nests go to both; the JAX package casts under x64 (on in
the tests' conftest), so both give float64 leaves with the same values and
keep the other leaves. The port's own contract: every device spec the
reference parses ('cpu', '/device:CPU:0', 'CPU:0', a `torch.device`, None)
places the tensors, and an unknown kind or a card that is not there raises
ValueError instead of falling back to another device. A gradient flows
back through `cast_double` into the tensor's own dtype.
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.utils import device as JD
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch.utils import device as PD

_rng = np.random.RandomState(0)
NEST = {"w": _rng.randn(3, 2).astype(np.float32),
        "pair": (_rng.randn(4).astype(np.float16),
                 np.arange(3, dtype=np.int32)),
        "flag": np.array([True, False])}


def _torch_nest():
    return {"w": torch.tensor(NEST["w"]),
            "pair": (torch.tensor(NEST["pair"][0]),
                     torch.tensor(NEST["pair"][1])),
            "flag": torch.tensor(NEST["flag"]),
            "note": "kept", "count": 3}


def test_cast_double_matches_the_reference():
    got = P.cast_double(_torch_nest())
    ref = JD.cast_double({"w": jnp.asarray(NEST["w"]),
                          "pair": tuple(jnp.asarray(x)
                                        for x in NEST["pair"]),
                          "flag": jnp.asarray(NEST["flag"])})
    for a, b in ((got["w"], ref["w"]), (got["pair"][0], ref["pair"][0]),
                 (got["pair"][1], ref["pair"][1]),
                 (got["flag"], ref["flag"])):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["note"] == "kept" and got["count"] == 3


def test_cast_double_keeps_the_gradient_path_and_named_tuples():
    Pair = namedtuple("Pair", "a b")
    w = torch.ones(3, requires_grad=True)
    out = P.cast_double(Pair(w, [w * 2]))
    assert isinstance(out, Pair) and out.a.dtype == torch.float64
    (out.a.sum() + out.b[0].sum()).backward()
    assert w.grad.dtype == torch.float32
    assert torch.equal(w.grad, torch.full((3,), 3.0))


def test_func_cast_double_matches_the_reference():
    seen = []

    def f(t, y, scale=None):
        seen.append((t.dtype, y.dtype, scale.dtype))
        return y * scale

    out = P.func_cast_double(f)(torch.tensor(0.5), torch.ones(2),
                                scale=torch.tensor(2.0))
    assert seen == [(torch.float64,) * 3] and out.dtype == torch.float64
    ref = JD.func_cast_double(lambda t, y, scale: y * scale)(
        jnp.asarray(0.5, jnp.float32), jnp.ones(2, jnp.float32),
        scale=jnp.asarray(2.0, jnp.float32))
    assert str(ref.dtype) == "float64"
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert f.__name__ == P.func_cast_double(f).__name__


@pytest.mark.parametrize("spec", ["cpu", "CPU:0", "/device:CPU:0", "/cpu:0",
                                  torch.device("cpu")])
def test_move_to_device_parses_the_reference_specs(spec):
    nest = _torch_nest()
    out = P.move_to_device(nest, spec)
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["pair"][1], nest["pair"][1])
    assert out["note"] == "kept"
    assert PD._parse_device(spec) == torch.device("cpu", 0) or \
        PD._parse_device(spec) == torch.device("cpu")
    # The reference resolves the same strings to its CPU device.
    if isinstance(spec, str):
        assert JD._parse_device(spec).platform == "cpu"


def test_move_to_device_none_is_the_identity():
    nest = _torch_nest()
    assert P.move_to_device(nest, None) is nest


@pytest.mark.parametrize("spec, match", [
    ("tpu:0", "unknown device kind"),
    ("warp", "unknown device kind"),
    ("cpu:x", "bad device index"),
    (3, "must be a string"),
])
def test_move_to_device_refuses_what_it_cannot_parse(spec, match):
    with pytest.raises(ValueError, match=match):
        P.move_to_device(torch.ones(2), spec)


@pytest.mark.parametrize("spec", ["cuda", "gpu", "/device:GPU:0", "cuda:1",
                                  torch.device("cuda", 0)])
def test_a_missing_card_raises(monkeypatch, spec):
    """Without a card (forced here, so the test means the same on the
    machine with one) a CUDA spec raises; nothing lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        P.move_to_device(torch.ones(2), spec)


def test_an_index_past_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PD._parse_device("gpu:0") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match=r"no CUDA device 1 \(1 available"):
        PD._parse_device("/device:GPU:1")
