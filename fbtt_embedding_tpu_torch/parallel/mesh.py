"""Device meshes over the ranks of a ``torch.distributed`` world.

Counterpart of ``fbtt_embedding_tpu.parallel.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (``init_device_mesh``): one
rank per device, laid out row-major over the world's ranks, so on a
``("dp", "mp")`` mesh ``mp`` is the inner axis and its ranks are neighbours
(within one host under ``torchrun``): the table-parallel all_to_all rides
the inner axis, the gradient all-reduce the outer one. Each axis's process
group comes from :func:`axis_group`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def default_mesh_shape(n: int, num_axes: int = 2) -> Tuple[int, ...]:
    """The JAX package's default layout of ``n`` devices: ``(n,)`` for one
    axis, else ``(n // mp, mp)`` with ``mp`` the largest power of two that
    divides ``n`` and is at most ``sqrt(n) + 1``."""
    if num_axes == 1:
        return (n,)
    mp = 1
    while mp * 2 <= int(np.sqrt(n)) + 1 and n % (mp * 2) == 0:
        mp *= 2
    return (n // mp, mp)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp", "mp"),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the initialised world (see
    ``parallel.multihost.initialize_distributed``), ``shape`` by default
    :func:`default_mesh_shape` of the world size; its axes are the first
    ``len(shape)`` of ``axis_names``. Raises RuntimeError without a world
    and ValueError when ``shape`` does not cover it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed world "
            "(initialize_distributed, or torchrun)")
    n = dist.get_world_size()
    if shape is None:
        shape = default_mesh_shape(n, len(axis_names))
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover the world's "
                         f"{n} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def axis_size(mesh, axis: str) -> int:
    """Ranks along mesh axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axes):
    """The process group of mesh axis ``axes`` (a name), or of several
    axes together: a tuple naming every axis of the mesh is the world's
    group (ranks in row-major mesh order); another tuple raises
    ValueError."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if list(axes) != list(mesh.mesh_dim_names):
        raise ValueError(f"axes {axes}: a group of several axes must name "
                         f"all of {mesh.mesh_dim_names}, in order")
    if mesh.size() != dist.get_world_size():
        raise ValueError("a group of every mesh axis needs the mesh to "
                         "cover the world")
    return dist.group.WORLD


def batch_index(mesh, axes) -> Tuple[int, int]:
    """``(index, count)`` of this rank's block of a dimension sharded over
    ``axes`` (a name or a tuple of names, major first): the index runs
    row-major over the named axes."""
    if isinstance(axes, str):
        axes = (axes,)
    idx, count = 0, 1
    for a in axes:
        n = axis_size(mesh, a)
        idx, count = idx * n + axis_index(mesh, a), count * n
    return idx, count
