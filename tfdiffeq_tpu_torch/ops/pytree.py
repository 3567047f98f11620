"""Tuple and dict states.

Counterpart of `tfdiffeq_tpu/ops/pytree.py`. A state may be one tensor or a
nest of tuples, lists and dicts of tensors (the reference's tuple-of-tensors
capability). The nest is flattened ONCE per solve into a flat [N] vector,
in the order `jax.tree_util` uses (dict keys sorted), so every solver
operation is one elementwise pass.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Tensor = torch.Tensor


def tree_leaves(tree: Any) -> List[Tensor]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for x in tree for l in tree_leaves(x)]
    return [torch.as_tensor(tree)]


def _rebuild(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def flatten_state(y0: Any) -> Tuple[Tensor, Callable[[Tensor], Any]]:
    """Ravel a nested state into a flat 1-D vector of the promoted dtype.

    Returns ``(flat, unravel)``. ``unravel`` maps a tensor of shape
    [..., N] back to the nest, each leaf of shape [..., *leaf_shape] in its
    own dtype, so it serves one state and a whole trajectory alike.
    """
    leaves = tree_leaves(y0)
    if not leaves:
        raise ValueError("empty state")
    dtype = leaves[0].dtype
    for l in leaves[1:]:
        dtype = torch.promote_types(dtype, l.dtype)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])

    def unravel(x: Tensor) -> Any:
        lead = x.shape[:-1]
        parts = torch.split(x, sizes, dim=-1)
        out = [p.reshape(lead + s).to(d)
               for p, s, d in zip(parts, shapes, dtypes)]
        return _rebuild(y0, iter(out))

    return flat, unravel


def flat_ode_func(func: Callable, unravel: Callable[[Tensor], Any],
                  dtype: torch.dtype) -> Callable[[Tensor, Tensor], Tensor]:
    """Wrap ``func(t, y_nest) -> dy_nest`` to map flat vectors to flat
    vectors."""

    def f(t: Tensor, y_flat: Tensor) -> Tensor:
        dy = tree_leaves(func(t, unravel(y_flat)))
        return torch.cat([l.reshape(-1).to(dtype) for l in dy])

    return f
