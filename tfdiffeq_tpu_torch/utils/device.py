"""Device and dtype helpers.

Counterpart of `tfdiffeq_tpu/utils/device.py` (upstream `tfdiffeq/misc.py`:
`move_to_device(x, device)`, `cast_double(x)`, `@func_cast_double`). Each
takes a nest: a tensor, or tuples, lists and dicts of them, whose other
leaves (numbers, strings, None) are kept as they are.

`move_to_device` places every tensor of a nest on a device named as the
reference names them ('cuda', 'cuda:1', 'gpu', '/device:GPU:0', 'cpu') or
by a `torch.device`. A kind it does not know, or a card that is not there,
raises ValueError: nothing falls back to another device. `cast_double`
casts the floating tensors to float64, which torch has on every device, so
unlike the reference there is nothing to warn about. `cast_double` and
`func_cast_double` are how a float32 model reaches the float64 tier
(`ops/doublefloat.py`) on its generic route.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Union

import torch

_KINDS = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def _map_tensors(fn: Callable[[torch.Tensor], Any], x: Any) -> Any:
    """x with fn applied to each tensor of the nest, the rest kept."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return type(x)((k, _map_tensors(fn, v)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):    # a NamedTuple
        return type(x)(*(_map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return x


def _parse_device(device: Union[str, torch.device, None]):
    """The `torch.device` a spec names, or None for None. Strings follow
    the reference (`utils/device.py:24`): case and a leading '/' or
    'device:' are ignored, 'gpu' is 'cuda', the index defaults to 0."""
    if device is None:
        return None
    if isinstance(device, str):
        spec = device.lower().strip().lstrip("/").replace("device:", "")
        kind, _, idx = spec.partition(":")
        if kind not in _KINDS:
            raise ValueError(f"unknown device kind {kind!r} in {device!r} "
                             f"(expected one of {sorted(_KINDS)})")
        try:
            index = int(idx) if idx else 0
        except ValueError:
            raise ValueError(f"bad device index in {device!r}") from None
        device = torch.device(_KINDS[kind], index)
    elif not isinstance(device, torch.device):
        raise ValueError(f"device must be a string, a torch.device or None, "
                         f"got {type(device).__name__}")
    if device.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = 0 if device.index is None else device.index
        if index >= n:
            raise ValueError(f"no CUDA device {index} ({n} available)")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device type {device.type!r}")
    return device


def move_to_device(x: Any, device: Union[str, torch.device, None]) -> Any:
    """The nest x with every tensor on `device` (reference
    `move_to_device`); None leaves x as it is."""
    d = _parse_device(device)
    if d is None:
        return x
    return _map_tensors(lambda l: l.to(d), x)


def cast_double(x: Any) -> Any:
    """The nest x with its floating tensors cast to float64 (inside
    autograd's graph: a gradient comes back in the tensor's own dtype);
    integer, bool and complex tensors and non-tensor leaves are kept."""
    return _map_tensors(
        lambda l: l.to(torch.float64) if l.is_floating_point() else l, x)


def func_cast_double(func: Callable) -> Callable:
    """Decorator: cast every argument's floating tensors to float64 before
    calling func (reference `@func_cast_double`)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*cast_double(args), **cast_double(kwargs))

    return wrapper
