"""Frozen dataclasses of tensors (the role of mom6_tpu/framework/pytree.py).

Fields that hold tensors, and fields that hold a dict of tensors (the
passive tracers of the state), move with ``.to(device, dtype)``; every
other field (sizes, flags, Python scalars) is carried as is.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TensorDataclass", "tensor_fields", "fields_equal", "tree_map"]


class TensorDataclass:
    """Mixin for ``@dataclasses.dataclass(frozen=True)`` containers."""

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def to(self, device=None, dtype=None):
        """A copy with every floating-point tensor field on ``device``
        (and cast to ``dtype`` when given)."""
        def move(t):
            return t.to(device=device,
                        dtype=dtype if t.is_floating_point() else None)

        upd = {name: move(t) for name, t in tensor_fields(self).items()}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                upd[f.name] = {k: move(t) for k, t in v.items()}
        return dataclasses.replace(self, **upd)


def tensor_fields(obj) -> dict:
    """{name: tensor} of the dataclass fields that hold a tensor."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def fields_equal(a, b) -> bool:
    """Whether two dataclasses of one type hold equal fields, tensors to
    the bit (for ``__eq__`` of parameter containers that hold tensors)."""
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and torch.equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def tree_map(fn, *trees):
    """``fn`` over the tensors of like containers (dataclasses,
    NamedTuples, dicts, tuples and lists); None stays None and any other
    leaf is the first tree's."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{
            f.name: tree_map(fn, *(getattr(x, f.name) for x in trees))
            for f in dataclasses.fields(t) if f.init})
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return t
