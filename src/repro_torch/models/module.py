"""Minimal functional module system (port of the reference
``models/module.py``).

A model is described by a tree (dicts, lists, tuples) of ``P`` descriptors
(shape + sharding names + initializer). ``materialize`` turns it into a tree
of tensors; ``params_from_numpy`` carries the reference's parameter tree,
given as numpy arrays, across bit for bit. The sharding names are kept so
the trees stay comparable; on one card they are not read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any

# logical mesh axes, as in the reference (not read on one card)
FSDP = "fsdp"
TENSOR = "tensor"
DATA = "data_b"


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter descriptor."""
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    init: str = "normal"               # normal | zeros | ones | embed
    scale_axis: int = 0                # fan-in axis for "normal"
    dtype: Any = torch.bfloat16


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf by leaf over trees of one structure (dicts, lists,
    tuples; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def materialize(tree: Tree, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Tree:
    """Parameter tensors for a descriptor tree, with the reference's rules:
    ones, zeros, ``0.02``·N(0, 1) for embeddings and ``fan_in**-0.5``·N(0, 1)
    otherwise, drawn in f32 from ``generator`` (which must live on
    ``device``) in the reference's leaf order, then cast to the descriptor's
    dtype. The numbers differ from the reference's PRNG; the distribution
    does not."""
    dev = resolve_device(device)

    def make(p: P) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=dev)
        fan_in = p.shape[p.scale_axis] if p.shape else 1
        std = 0.02 if p.init == "embed" else fan_in ** -0.5
        arr = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                          device=dev)
        return (arr * std).to(p.dtype)

    # draw in the reference's leaf order (dict keys sorted)
    return _unflatten(tree, iter([make(p) for p in tree_leaves(tree)]))


def _unflatten(tree: Tree, it) -> Tree:
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def params_from_numpy(tree: Tree, device: str | torch.device = "cuda") -> Tree:
    """The reference's parameter tree, as numpy arrays, as tensors on
    ``device``, bit for bit. bfloat16 arrays (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` rejects) go through their uint16 bits."""
    dev = resolve_device(device)

    def conv(a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(dev)

    return tree_map(conv, tree)


def stack(tree: Tree, n: int) -> Tree:
    """Stack a block descriptor tree over ``n`` layers: (n, *shape), with the
    layer dim unsharded."""
    return tree_map(
        lambda p: P((n,) + p.shape, (None,) + p.spec, p.init,
                    p.scale_axis + 1, p.dtype), tree)


def param_count(tree: Tree) -> int:
    total = 0
    for p in tree_leaves(tree):
        k = 1
        for s in p.shape:
            k *= s
        total += k
    return total
