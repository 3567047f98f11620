"""ODE-Net MNIST classifier (PyTorch port).

Counterpart of the repository's `examples/odenet_mnist.py` (upstream
`examples/odenet_mnist.py`): a conv stem down to 7x7 -> ODEBlock (conv
dynamics with a concatenated time channel and GroupNorm, dopri5 at
tol = 1e-3 over [0, 1]) -> linear head, trained with SGD (momentum 0.9,
lr 0.1 decayed tenfold at epochs 60, 100 and 140) on cross-entropy; per
epoch it logs the last loss, the accuracy on the first 2048 test samples
(batches of 256), f-NFE and b-NFE.

    python -m tfdiffeq_tpu_torch.examples.odenet_mnist --synthetic_hard \\
        [--adjoint [--fused]] [--fused_eval] [--device cpu]

Data: MNIST from local idx(.gz) or mnist.npz files under `--data_dir`
(nothing is downloaded), or the generated stand-ins `--synthetic`
(prototype blobs) and `--synthetic_hard` (augmented procedural glyphs).

`--fused` (with `--adjoint`) trains through one K13 launch forward
(`fast.solve_conv_ode`) and the generic O(1)-memory adjoint backward;
`--fused_eval` evaluates through K13. The default device is the card;
without one the example raises unless `--device cpu` is given.

Differences from the reference: images are NCHW [B, 1, 28, 28]; parameters
take PyTorch's default initialisation drawn from `--seed`; batches are
permuted with numpy's RandomState(seed), as the reference does.

`--train_dir` keeps a checkpoint after every epoch (`examples/ckpt.py`: the
model, SGD's momentum, the learning-rate schedule and the epoch); a rerun
with the same directory resumes from the newest and prints `resumed from
... at epoch N`. As in the reference, the resumed run permutes its batches
with RandomState(seed + N).
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.odenet import ODENetMNIST
from ..utils.nfe import NFEMeter
from . import ckpt, resolve_device

#: Test samples evaluated per epoch, in batches of EVAL_BATCH.
EVAL_SAMPLES, EVAL_BATCH = 2048, 256


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--network", choices=["odenet", "resnet"],
                   default="odenet")
    p.add_argument("--adjoint", action="store_true")
    p.add_argument("--tol", type=float, default=1e-3)
    # The reference trains 160 epochs with decay at 60/100/140; shorter
    # runs simply never reach the decay boundaries.
    p.add_argument("--nepochs", type=int, default=160)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--data_dir", default="data/mnist")
    p.add_argument("--synthetic", action="store_true",
                   help="use generated data (no MNIST files needed)")
    p.add_argument("--synthetic_hard", action="store_true",
                   help="non-saturating generated data: affine-augmented "
                        "procedural digit glyphs (regression signal)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit_batches", type=int, default=0,
                   help="debug: cap batches per epoch")
    p.add_argument("--train_dir", default="",
                   help="checkpoint directory: save there after each "
                        "epoch, and resume from its newest checkpoint")
    p.add_argument("--fused_eval", action="store_true",
                   help="evaluate through the fused conv-ODE kernel "
                        "(fast.solve_conv_ode; inference only)")
    p.add_argument("--fused", action="store_true",
                   help="TRAIN with the fused conv-ODE forward + generic "
                        "O(1)-memory backward (requires --adjoint)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a "
                        "card unless --device cpu is given)")
    return p.parse_args(argv)


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def load_mnist(data_dir):
    """Load MNIST from local idx(.gz) or mnist.npz files."""
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        return (d["x_train"], d["y_train"], d["x_test"], d["y_test"])
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    found = []
    for n in names:
        for cand in (os.path.join(data_dir, n),
                     os.path.join(data_dir, n + ".gz")):
            if os.path.exists(cand):
                found.append(cand)
                break
    if len(found) == 4:
        return tuple(_read_idx(f) for f in found)
    raise FileNotFoundError(
        f"No MNIST files under {data_dir}; pass --synthetic to run with "
        "generated data.")


def synthetic_mnist(n_train=8192, n_test=1024, seed=0):
    """Structured stand-in: each class is a distinct blob pattern + noise —
    learnable by a convnet, zero external data needed."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(10, 28, 28) > 0.72
    protos = protos.astype(np.float32)

    def make(n):
        ys = rng.randint(0, 10, n)
        xs = protos[ys] * 0.9
        xs += rng.randn(n, 28, 28).astype(np.float32) * 0.25
        return np.clip(xs * 255, 0, 255).astype(np.uint8), ys

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


# 5x7 bitmap glyphs for 0-9 (classic dot-matrix font, rows top->bottom).
_GLYPHS = [
    ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],  # 0
    ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],  # 1
    ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],  # 2
    ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],  # 3
    ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],  # 4
    ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],  # 5
    ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],  # 6
    ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],  # 7
    ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],  # 8
    ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],  # 9
]


def synthetic_digits(n_train=8192, n_test=1024, seed=0):
    """Non-saturating MNIST stand-in: procedurally rendered digit glyphs
    under per-sample affine augmentation (rotation, scale, subpixel shift),
    a low-frequency warp, stroke dropout, blur and noise; class identity
    survives only through spatially-varying shape, so accuracy climbs over
    many epochs and stays below 100%."""
    rng = np.random.RandomState(seed)
    glyphs = np.asarray([[[c == "1" for c in row] for row in g]
                         for g in _GLYPHS], np.float32)   # [10, 7, 5]

    # output pixel grid, centered
    jj, ii = np.meshgrid(np.arange(28, dtype=np.float32),
                         np.arange(28, dtype=np.float32))
    base = np.stack([ii - 13.5, jj - 13.5], -1)           # [28, 28, 2] (y, x)

    def make(n):
        ys = rng.randint(0, 10, n)
        ang = rng.uniform(-0.52, 0.52, n)                 # +-30 deg
        scale = rng.uniform(2.0, 3.2, n)
        shift = rng.uniform(-3.5, 3.5, (n, 2))
        # elastic-ish warp: low-frequency sinusoidal coordinate offsets
        wamp = rng.uniform(0.3, 0.9, (n, 2))
        wfreq = rng.uniform(0.25, 0.6, (n, 2))
        wph = rng.uniform(0, 2 * np.pi, (n, 2))
        imgs = np.empty((n, 28, 28), np.float32)
        for k in range(n):
            g = glyphs[ys[k]]
            ca, sa = np.cos(ang[k]), np.sin(ang[k])
            # inverse map: output px -> glyph coords (rows x cols = 7 x 5)
            pt = base - shift[k]
            gy = (ca * pt[..., 0] + sa * pt[..., 1]) / scale[k] + 3.0
            gx = (-sa * pt[..., 0] + ca * pt[..., 1]) / (0.9 * scale[k]) + 2.0
            gy = gy + wamp[k, 0] * np.sin(wfreq[k, 0] * pt[..., 1]
                                          + wph[k, 0])
            gx = gx + wamp[k, 1] * np.sin(wfreq[k, 1] * pt[..., 0]
                                          + wph[k, 1])
            y0f, x0f = np.floor(gy), np.floor(gx)
            wy, wx = gy - y0f, gx - x0f
            y0i, x0i = y0f.astype(int), x0f.astype(int)

            def at(yi, xi):
                ok = (yi >= 0) & (yi < 7) & (xi >= 0) & (xi < 5)
                return np.where(ok, g[np.clip(yi, 0, 6),
                                      np.clip(xi, 0, 4)], 0.0)

            img = ((1 - wy) * (1 - wx) * at(y0i, x0i)
                   + (1 - wy) * wx * at(y0i, x0i + 1)
                   + wy * (1 - wx) * at(y0i + 1, x0i)
                   + wy * wx * at(y0i + 1, x0i + 1))
            imgs[k] = img
        # stroke dropout: kill 12% of lit pixels per sample
        imgs *= (rng.rand(n, 28, 28) > 0.12 * (imgs > 0.3))
        # cheap 3x3 blur (separable box, applied once)
        blur = imgs.copy()
        blur[:, 1:-1, :] = (imgs[:, :-2, :] + imgs[:, 1:-1, :]
                            + imgs[:, 2:, :]) / 3.0
        blur[:, :, 1:-1] = (blur[:, :, :-2] + blur[:, :, 1:-1]
                            + blur[:, :, 2:]) / 3.0
        # per-sample contrast jitter + pixel noise
        blur *= rng.uniform(0.7, 1.1, (n, 1, 1)).astype(np.float32)
        blur += rng.randn(n, 28, 28).astype(np.float32) * 0.18
        return (np.clip(blur, 0, 1) * 255).astype(np.uint8), ys

    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return xtr, ytr, xte, yte


def load_data(args, **sizes):
    """(x_train, y_train, x_test, y_test): images as normalised float32
    NCHW [N, 1, 28, 28], labels as int64; `sizes` (n_train, n_test) go to
    the generators."""
    if args.synthetic_hard:
        data = synthetic_digits(seed=args.seed, **sizes)
    elif args.synthetic:
        data = synthetic_mnist(seed=args.seed, **sizes)
    else:
        data = load_mnist(args.data_dir)
    x_train, y_train, x_test, y_test = data

    def prep(x):
        return ((x.astype(np.float32) / 255.0 - 0.1307) / 0.3081)[:, None]

    return (prep(x_train), np.asarray(y_train, np.int64), prep(x_test),
            np.asarray(y_test, np.int64))


def build_model(args, device=None, nfe_meter=None,
                fused_inference: bool = False):
    """The classifier at the flags of `args`, with PyTorch's default
    initialisation drawn from `args.seed` (the global RNG is left as it
    was). fused_inference: the `--fused_eval` model instead, its ODE block
    one K13 launch without the adjoint."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = ODENetMNIST(
            network=args.network, tol=args.tol, nfe_meter=nfe_meter,
            adjoint=args.adjoint and not fused_inference,
            fused=args.fused or fused_inference)
    return model.to(device)


def make_optimizer(args, model, steps_per_epoch: int):
    """SGD with momentum 0.9 and the reference's piecewise decay (x0.1 at
    epochs 60, 100 and 140), stepped once a batch."""
    opt = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, [steps_per_epoch * e for e in (60, 100, 140)], gamma=0.1)
    return opt, sched


def make_train_step(model, opt, sched):
    """train_step(xb, yb) -> the batch's cross-entropy (detached) after one
    optimizer step."""
    def train_step(xb, yb):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    return train_step


def evaluate(model, x_test, y_test, device):
    """(accuracy, NFE of the last batch) over the first EVAL_SAMPLES test
    samples, in batches of EVAL_BATCH."""
    hits, n = 0, 0
    with torch.no_grad():
        for i in range(0, min(len(x_test), EVAL_SAMPLES), EVAL_BATCH):
            xb = torch.from_numpy(x_test[i:i + EVAL_BATCH]).to(device)
            yb = torch.from_numpy(y_test[i:i + EVAL_BATCH]).to(device)
            hits += int((torch.argmax(model(xb), dim=-1) == yb).sum())
            n += yb.shape[0]
    return hits / n, model.nfe


def main(argv=None):
    args = parse_args(argv)
    if args.fused and not args.adjoint:
        raise SystemExit("--fused trains through the fused forward + "
                         "adjoint backward; add --adjoint")
    device = resolve_device(args.device)
    x_train, y_train, x_test, y_test = load_data(args)

    # f-NFE and b-NFE of the adjoint solves (the upstream example logs
    # both per step); without the adjoint, the forward NFE is model.nfe.
    meter = NFEMeter() if args.adjoint else None
    model = build_model(args, device, nfe_meter=meter)
    steps_per_epoch = len(x_train) // args.batch_size
    if steps_per_epoch == 0:
        raise SystemExit(f"batch_size {args.batch_size} exceeds the "
                         f"training set ({len(x_train)} examples)")
    opt, sched = make_optimizer(args, model, steps_per_epoch)
    train_step = make_train_step(model, opt, sched)
    # The same parameters, the ODE block's solve through K13.
    eval_model = (build_model(args, device, fused_inference=True)
                  if args.fused_eval and args.network == "odenet"
                  else model)

    # Checkpoint and resume: the whole training state, per epoch.
    mngr, start_epoch = None, 0
    if args.train_dir:
        mngr = ckpt.make_manager(args.train_dir)
        step, state = ckpt.restore_latest(mngr)
        if step is not None:
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optimizer"])
            sched.load_state_dict(state["scheduler"])
            start_epoch = step
            print(f"resumed from {args.train_dir} at epoch {step}")

    rng = np.random.RandomState(args.seed + start_epoch)
    loss = acc = None
    for epoch in range(start_epoch + 1, args.nepochs + 1):
        perm = rng.permutation(len(x_train))
        t0 = time.time()
        if meter is not None:
            meter.reset()
        n_batches = steps_per_epoch
        if args.limit_batches:
            n_batches = min(n_batches, args.limit_batches)
        for i in range(n_batches):
            idx = perm[i * args.batch_size:(i + 1) * args.batch_size]
            loss = train_step(torch.from_numpy(x_train[idx]).to(device),
                              torch.from_numpy(y_train[idx]).to(device))
        if eval_model is not model:
            eval_model.load_state_dict(model.state_dict())
        acc, nfe = evaluate(eval_model, x_test, y_test, device)
        nfe_str = f"nfe {nfe}"
        if meter is not None:
            s = meter.snapshot()
            nfe_str = (f"f-nfe {s['f_nfe'] / max(1, s['f_calls']):.0f} | "
                       f"b-nfe {s['b_nfe'] / max(1, s['b_calls']):.0f}")
        print(f"Epoch {epoch:03d} | loss {float(loss):.4f} | "
              f"test acc {acc:.4f} | {nfe_str} | "
              f"{time.time() - t0:.1f}s")
        if mngr is not None:
            ckpt.save(mngr, epoch, {
                "model": model.state_dict(), "optimizer": opt.state_dict(),
                "scheduler": sched.state_dict(), "step": epoch})
    return {"model": model, "loss": None if loss is None else float(loss),
            "acc": acc}


if __name__ == "__main__":
    main()
