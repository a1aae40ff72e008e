"""Rank-ordered collectives over a ``torch.distributed`` process group.

The JAX package reduces over a mesh axis with ``lax.psum``.  Here every
rank's tensor is gathered and the parts are summed in rank order, so the sum
is bit-identical on every rank and from run to run (NCCL's ``all_reduce``
fixes no summation order).  The registration loops (``ops/registration.py``)
and the scale-out layer (``parallel/``) both reduce through this module.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _gather(t: torch.Tensor, group: Optional[dist.ProcessGroup]):
    # The list form: gloo has no all_gather_into_tensor.
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def gather_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group``, in rank order:
    ((t_0 + t_1) + t_2) + ...  Bit-identical on every rank; with one rank,
    a copy of ``t``.  The collective runs whatever the group's size."""
    parts = _gather(t, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def gather_cat(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The ranks' ``t`` concatenated on the leading axis, in rank order
    (every rank's ``t`` has the same shape)."""
    return torch.cat(_gather(t, group), dim=0)
