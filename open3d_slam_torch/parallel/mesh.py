"""Device mesh and the rank-ordered collectives of the scale-out layer.

Port of ``open3d_slam_tpu.parallel.mesh``.  The JAX package lays its devices
out on two axes:
  * ``data``  — independent work items (scan pairs, sequences, graphs);
  * ``block`` — point shards of one registration, whose normal equations
    are summed over the axis on every Gauss-Newton iteration.

Here the axes are those of a ``torch.distributed`` ``DeviceMesh`` over the
processes of the default group (one process per card, as ``torchrun``
starts them; ``multihost.initialize`` makes the group).  The JAX package
places a batch on the ``data`` axis with ``device_put`` and a
``NamedSharding``; here each process takes its own slice of the batch
(``shard_batch``) and runs it, and results come back through
``gather_cat``.  ``psum`` becomes ``gather_sum``: every rank's tensor is
gathered and the parts are summed in rank order, so the sum is
bit-identical on every rank and from run to run (NCCL's ``all_reduce``
fixes no summation order).  Both live in ``utils/collectives.py``, which
the registration loops import too, and are re-exported here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from open3d_slam_torch.utils.collectives import gather_cat, gather_sum  # noqa: F401

AXES = ("data", "block")


def collective_device(group: Optional[dist.ProcessGroup] = None) -> torch.device:
    """The device a group's collectives take their tensors on: the current
    CUDA device under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = AXES):
    """(data, block) ``DeviceMesh`` over every process of the default group
    (``multihost.initialize`` first).  Default shape: (world, 1), all
    processes on the data axis; (2, 4) splits 8 into 2-way batch x 4-way
    point-shard parallelism.  Rank r sits at (r // block, r % block).  The
    mesh's device type is the one the group's backend takes
    (``collective_device``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} processes")
    return init_device_mesh(collective_device().type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def data_group(mesh) -> dist.ProcessGroup:
    """The ranks that share this rank's block coordinate."""
    return mesh.get_group(mesh.mesh_dim_names[0])


def block_group(mesh) -> dist.ProcessGroup:
    """The ranks that share this rank's data coordinate: the point shards of
    one registration."""
    return mesh.get_group(mesh.mesh_dim_names[1])


def map_tensors(fn, tree):
    """``fn`` applied to every tensor of ``tree`` (a tensor, a dataclass
    such as ``PointCloud`` or ``HashGrid``, a tuple, list or dict of them);
    anything else is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(mesh, tree):
    """This rank's contiguous slice, on the ``data`` axis, of the leading
    axis of every tensor in ``tree``: data coordinate i of n takes rows
    [i B / n, (i + 1) B / n), as JAX's ``P("data")`` splits a batch.  The
    batch must divide evenly."""
    axis = mesh.mesh_dim_names[0]
    n, i = mesh.size(0), mesh.get_local_rank(axis)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over {n} data ranks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return map_tensors(take, tree)


def replicated(mesh, tree):
    """Every rank holds all of ``tree``: the identity (the counterpart of
    the JAX package's ``replicated`` sharding)."""
    return tree
