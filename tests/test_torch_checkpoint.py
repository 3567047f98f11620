"""PyTorch port: checkpoint and resume of the example trainers
(`tfdiffeq_tpu_torch/examples/ckpt.py`), the counterparts of
tests/test_checkpoint.py:25 and :53 on the port's examples, on the CPU at
tiny sizes.

A rerun with the same `--train_dir` prints `resumed ... at iter N` (or
`at epoch N`), and the resumed parameters are bitwise equal to what the
first run saved. The port also saves the generators' states, so a latent
ODE run resumed at iteration 4 and carried to 6 is bitwise equal to an
uninterrupted run of 6; only the newest two checkpoints stay, and a
checkpoint is written under a temporary name and renamed.
"""

import os

import pytest
import torch

from tfdiffeq_tpu_torch.examples import ckpt
from tfdiffeq_tpu_torch.examples import latent_ode as PL
from tfdiffeq_tpu_torch.examples import odenet_mnist as PX


def _tiny_args(train_dir, niters):
    args = ["--nspiral", "4", "--ntimes", "40", "--nsample", "8",
            "--latent_dim", "3", "--nhidden", "8", "--rnn_nhidden", "8",
            "--niters", str(niters), "--save_every", "2", "--device", "cpu"]
    return args + (["--train_dir", train_dir] if train_dir else [])


def _params(nets):
    return [p.detach().clone() for m in nets for p in m.parameters()]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_latent_ode_checkpoint_resume(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    p1 = _params(PL.main(_tiny_args(d, 4)))
    assert sorted(os.listdir(d)) == ["ckpt_2.pt", "ckpt_4.pt"]
    saved = ckpt.restore_latest(ckpt.make_manager(d))[1]
    assert saved["step"] == 4 and set(saved["model"]) == {"rec", "dyn",
                                                          "dec"}

    # The second invocation finds the iteration-4 checkpoint: no new
    # iteration, the parameters bitwise equal to the first run's.
    p2 = _params(PL.main(_tiny_args(d, 4)))
    out = capsys.readouterr().out
    assert "resumed" in out and "at iter 4" in out
    assert _equal(p1, p2)

    # Extending the run resumes at 4 and trains on: the parameters move,
    # and equal an uninterrupted run of 6 bit for bit.
    p3 = _params(PL.main(_tiny_args(d, 6)))
    assert not _equal(p1, p3)
    assert _equal(p3, _params(PL.main(_tiny_args("", 6))))
    assert sorted(os.listdir(d)) == ["ckpt_4.pt", "ckpt_6.pt"]


def test_odenet_mnist_checkpoint_resume(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(PX, "EVAL_SAMPLES", 8)
    d = str(tmp_path / "ckpt_mnist")

    def argv(nepochs):
        return ["--synthetic", "--nepochs", str(nepochs), "--batch_size",
                "8", "--limit_batches", "1", "--tol", "1e-1", "--device",
                "cpu", "--train_dir", d]

    first = [p.detach().clone() for p in PX.main(argv(1))["model"]
             .parameters()]
    # A rerun to the same epoch resumes and trains nothing: the resumed
    # parameters are the saved ones, bit for bit.
    again = PX.main(argv(1))
    assert again["loss"] is None
    assert _equal(first, list(again["model"].parameters()))
    # One more epoch resumes at epoch 1.
    PX.main(argv(2))
    out = capsys.readouterr().out
    assert "resumed" in out and "at epoch 1" in out
    assert sorted(os.listdir(d)) == ["ckpt_1.pt", "ckpt_2.pt"]
    state = ckpt.restore_latest(ckpt.make_manager(d))[1]
    assert state["step"] == 2 and "scheduler" in state


def test_manager_keeps_the_newest_and_renames(tmp_path, monkeypatch):
    m = ckpt.make_manager(str(tmp_path / "m"), max_to_keep=2)
    assert ckpt.restore_latest(m, "template") == (None, "template")
    for step in (1, 10, 2):
        ckpt.save(m, step, {"step": step, "w": torch.full((2,), step)})
    assert m.steps() == [2, 10]
    step, state = ckpt.restore_latest(m)
    assert step == 10 and torch.equal(state["w"], torch.full((2,), 10))

    # A save that fails while writing leaves the last checkpoint whole.
    def broken(obj, path):
        with open(path, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        ckpt.save(m, 11, {"step": 11})
    assert m.steps() == [2, 10] and ckpt.restore_latest(m)[0] == 10
