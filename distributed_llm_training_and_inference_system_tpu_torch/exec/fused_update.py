"""Fused AdamW apply: clip + moments + bias correction + decay + param write
in one pass over device memory per parameter leaf, in place.

Counterpart of the JAX package's ``exec/fused_update.py``. Two
implementations of the same per-leaf function:

- ``_leaf_math``, the plain PyTorch version in optax's op order: ``b1*mu``
  in mu's dtype, division by ``(1 - b^t)`` rather than multiplication by
  its reciprocal, ``wd*p`` added after the adaptive term. Every op is its
  own eager kernel, so each result is rounded once.
- the hand-written CUDA kernel (``ops/adamw_cuda.py``), bitwise equal to
  ``_leaf_math`` on the card.

``fused_adamw_apply`` sends each leaf with ndim >= 2 and >= 65536 elements
that lies on a card to the kernel, all of them in one multi-leaf call (one
launch per (mu, nu) dtype pair), and the rest (norm scales, biases, and
every leaf on the CPU) to ``_leaf_math``. A sharded step passes
``kernel_mask``: the rule taken on each GLOBAL leaf (the JAX package's
choice), so the set that goes to the kernel does not change with the mesh
while each rank updates its shard. The scalars (lr, 1 - b1^t,
1 - b2^t, clip scale) stay on the device: nothing waits for the host.
Unlike the JAX function, which returns new trees, this one updates
``params``, ``mu`` and ``nu`` in place (no second copy of the state).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.adamw_cuda import adamw_multi_kernel

KERNEL_MIN_ELEMENTS = 1 << 16


def kernel_eligible(shape) -> bool:
    """The kernel's leaves: ndim >= 2 and >= 65536 elements."""
    return len(shape) >= 2 and int(np.prod(shape)) >= KERNEL_MIN_ELEMENTS


def _leaf_math(p, g, mu, nu, lr, om1, om2, clip_scale, *, b1, b2, eps, wd,
               mu_dtype, nu_dtype=torch.float32):
    """The shared fp32 update formula; returns (new_p, new_mu, new_nu).
    ``lr``/``om1``/``om2``/``clip_scale`` are 0-dim fp32 tensors on the
    leaf's device (a true division by a device tensor, as the kernel)."""
    g32 = g.float() * clip_scale
    # b1*mu in mu's own dtype with b1 rounded to that dtype first, as
    # optax's update_moment multiplies by a weak-typed scalar
    mu32 = (1.0 - b1) * g32 + float(torch.tensor(b1, dtype=mu.dtype)) * mu
    nu32 = (1.0 - b2) * (g32 * g32) + b2 * nu.float()
    mu_hat = mu32 / om1
    nu_hat = nu32 / om2
    upd = mu_hat / (torch.sqrt(nu_hat) + eps)
    p32 = p.float()
    if wd:
        upd = upd + wd * p32
    new_p = (p32 - lr * upd).to(p.dtype)
    return new_p, mu32.to(mu_dtype), nu32.to(nu_dtype)


def adam_scalars(count: torch.Tensor, lr: torch.Tensor, b1: float, b2: float,
                 clip_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's fp32[4] (lr, 1 - b1^t, 1 - b2^t, clip scale) with
    t = count + 1, computed on count's device."""
    t = (count + 1).float()

    def base(b):       # a fill on the device, not a host-to-device copy
        return torch.full((), b, dtype=torch.float32, device=t.device)
    om1 = 1.0 - base(b1).pow(t)
    om2 = 1.0 - base(b2).pow(t)
    return torch.stack([lr.float().reshape(()), om1, om2,
                        clip_scale.float().reshape(())])


@torch.no_grad()
def fused_adamw_apply(params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor],
                      mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                      count: torch.Tensor, *, lr: torch.Tensor, b1: float,
                      b2: float, eps: float, weight_decay: float,
                      decay_mask: Sequence[bool], clip_scale: torch.Tensor,
                      use_kernel: bool = True,
                      kernel_mask: Optional[Sequence[bool]] = None) -> None:
    """Apply one AdamW step to every leaf, in place.

    ``count`` is the step count BEFORE this update (bias correction uses
    count + 1, as optax.scale_by_adam). ``clip_scale`` is the global-norm
    clip factor (1.0 = no clip); ``decay_mask`` a bool per leaf (True =
    weight decay applies). ``use_kernel=False`` takes ``_leaf_math`` for
    every leaf (the unfused update). ``kernel_mask`` (a bool per leaf)
    replaces the size rule: which leaves on a card go to the kernel."""
    scalars = adam_scalars(count, lr, b1, b2, clip_scale)
    s_lr, om1, om2, s_clip = scalars.unbind()
    if kernel_mask is None:
        kernel_mask = [kernel_eligible(p.shape) for p in params]
    kernel_leaves = []
    for p, g, m, v, decayed, eligible in zip(params, grads, mu, nu,
                                             decay_mask, kernel_mask,
                                             strict=True):
        wd = weight_decay if decayed else 0.0
        if use_kernel and p.is_cuda and eligible:
            kernel_leaves.append((p, g, m, v, wd))
            continue
        new_p, new_m, new_v = _leaf_math(
            p, g, m, v, s_lr, om1, om2, s_clip, b1=b1, b2=b2, eps=eps, wd=wd,
            mu_dtype=m.dtype, nu_dtype=v.dtype)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
    if kernel_leaves:
        ps, gs, ms, vs, wds = zip(*kernel_leaves)
        adamw_multi_kernel(ps, gs, ms, vs, scalars, b1=b1, b2=b2, eps=eps,
                           wds=wds)
