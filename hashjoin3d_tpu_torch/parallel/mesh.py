"""Device meshes over ``torch.distributed``.

Port of ``hashjoin3d_tpu/parallel/mesh.py``.  The JAX package's ``Mesh``
with one logical axis ``'x'`` becomes a ``DeviceMesh``
(``torch.distributed.device_mesh``) with ``mesh_dim_names=("x",)``: one
process a rank, each rank owning one hash partition of the build table,
every collective on the axis's process group.  NCCL carries it on GPUs,
gloo on the CPU (several processes stand in for several chips).

A user with one card needs no launcher: with no process group yet,
:func:`make_mesh` on ``cuda`` starts a 1-rank NCCL group (on ``cpu`` a
1-rank gloo group) over an in-process store.  More ranks come from a
launcher (``torchrun``, whose environment :func:`make_mesh` reads) or
from the caller's own ``init_process_group``; the mesh then spans the
group.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.layout import key_column, resolve_device

SHARD_AXIS = "x"


def _backend_device(device) -> torch.device:
    """The mesh's device, with a process group started if none exists
    (NCCL for ``cuda``, gloo for ``cpu``): from a launcher's environment
    (``torchrun`` sets ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; each
    rank then takes card ``LOCAL_RANK``), else one rank over an
    in-process store.  Checked against the group's backend: NCCL carries
    CUDA tensors only; gloo either kind."""
    dev = resolve_device("cuda" if device is None else device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
                torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the process group is NCCL, which carries CUDA "
                         f"tensors only; device {dev} asked for")
    return dev


def make_mesh(n_devices: int | None = None, device=None,
              axis: str = SHARD_AXIS) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks of the
    process group (default: all of them; every rank calls this, and a
    rank past ``n_devices`` holds no shard and calls no step), on
    ``device`` ("cuda" by default).  Starts a 1-rank group when there is
    none; raises when more ranks are asked for than the group has, or
    when the device and the group's backend disagree."""
    dev = _backend_device(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def axis_info(mesh: DeviceMesh, axis: str):
    """``(process group, size, this rank's index)`` of one mesh axis."""
    if mesh.mesh_dim_names is None or axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r} "
                         f"(axes {mesh.mesh_dim_names})")
    dim = mesh.mesh_dim_names.index(axis)
    return (mesh.get_group(axis), mesh.size(dim),
            mesh.get_local_rank(axis))


def block_index(mesh: DeviceMesh, axis=SHARD_AXIS) -> tuple[int, int]:
    """``(this rank's block, number of blocks)`` of a column split over
    one axis or, row-major, over several (``("host", "chip")``)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    idx, count = 0, 1
    for a in axes:
        _, size, rank = axis_info(mesh, a)
        idx, count = idx * size + rank, count * size
    return idx, count


def shard_axis(mesh: DeviceMesh, column, axis=SHARD_AXIS) -> torch.Tensor:
    """This rank's contiguous block of a global column (the split a JAX
    ``NamedSharding(mesh, P(axis))`` makes), on the mesh's device: a host
    integer column as its key carrier (``layout.key_column``), a tensor
    moved as it is.  The column's length must divide by the blocks."""
    idx, count = block_index(mesh, axis)
    n = len(column)
    if n % count:
        raise ValueError(f"a column of {n} rows does not split into "
                         f"{count} equal blocks")
    lo, hi = idx * n // count, (idx + 1) * n // count
    dev = torch.device(mesh.device_type)
    if isinstance(column, torch.Tensor):
        return column[lo:hi].to(dev)
    block = np.asarray(column)[lo:hi]
    if block.dtype.kind in "iu":
        return key_column(block, dev)
    return torch.from_numpy(np.ascontiguousarray(block)).to(dev)
