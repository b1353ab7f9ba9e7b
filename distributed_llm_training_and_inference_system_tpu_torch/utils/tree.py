"""Helpers over a model's parameters (the JAX package's ``utils/tree.py``,
where a parameter tree is a pytree; here it is a module or a sequence of
tensors)."""

from __future__ import annotations

from typing import Iterable, Union

import torch
from torch import nn

Tensors = Union[nn.Module, Iterable[torch.Tensor]]


def _tensors(tree: Tensors) -> list[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    return list(tree)


def param_count(tree: Tensors) -> int:
    """Total number of scalars."""
    return sum(t.numel() for t in _tensors(tree))


def global_norm(tree: Tensors) -> torch.Tensor:
    """L2 norm over all tensors: the sum of squares in fp32 (0-dim, on the
    tensors' device; no host synchronisation)."""
    ts = _tensors(tree)
    total = sum(t.float().square().sum() for t in ts)
    return torch.sqrt(total)
