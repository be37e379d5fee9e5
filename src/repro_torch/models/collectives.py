"""The port's device mesh and its collectives over one mesh axis — the
counterparts of ``lax.psum``, ``lax.pmax``, ``lax.all_gather(tiled=
True)`` and ``lax.axis_index`` inside the reference's ``shard_map``
bodies, and of the resharding GSPMD inserts around them.

A ``Mesh`` names the axes of a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks of the default process group, row-major
(rank = sum of coordinate x stride), and adds the ``shape`` dict of axis
sizes the rule tables read (``models/sharding.py``, ``launch/mesh.py``).
Each rank is one process; the collectives run over the DeviceMesh's
group of the ranks that differ only in the named axis.

Only ``all_reduce`` (SUM, MAX) and the list ``all_gather`` are used:
what gloo takes on CUDA tensors as well as on CPU tensors (four ranks
sharing one card: ``scripts/gloo_cuda_probe.py``), and NCCL on CUDA
tensors.  Every function is the identity on an axis of size 1 (or
an empty tuple of axes) and outside a mesh, so model code calls them
unconditionally.  An axis argument is an axis name, a tuple of names
(major to minor, as a spec entry lists them) or None.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[None, str, Tuple[str, ...]]


class Mesh:
    """Named axes over the default process group's ranks, row-major."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_type: str):
        from torch.distributed.device_mesh import DeviceMesh
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axes)}")
        n = math.prod(shape)
        if dist.get_world_size() != n:
            raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                             f"process group has {dist.get_world_size()}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.device_type = device_type
        self.rank = dist.get_rank()
        self.device_mesh = DeviceMesh(
            device_type, torch.arange(n).reshape(tuple(shape)),
            mesh_dim_names=self.axis_names)
        self.coords: Dict[str, int] = {}
        rest = self.rank
        for a in reversed(self.axis_names):
            self.coords[a] = rest % self.shape[a]
            rest //= self.shape[a]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, coords {self.coords}, "
                f"{self.device_type})")


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.models.sharding import current_mesh
    return current_mesh()


def axes_of(entry: Axes, mesh=None) -> Tuple[str, ...]:
    """A spec entry as the tuple of its axes of size > 1 in the mesh."""
    mesh = _mesh(mesh)
    if entry is None or mesh is None:
        return ()
    names = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in names if mesh.shape.get(a, 1) > 1)


def axis_size(entry: Axes, mesh=None) -> int:
    mesh = _mesh(mesh)
    return math.prod(mesh.shape[a] for a in axes_of(entry, mesh))


def axis_index(entry: Axes, mesh=None) -> int:
    """This rank's index along the axes (major to minor), ``lax.
    axis_index``; 0 outside a mesh."""
    mesh = _mesh(mesh)
    idx = 0
    for a in axes_of(entry, mesh):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def _reduce(x: torch.Tensor, entry: Axes, op, mesh) -> torch.Tensor:
    mesh = _mesh(mesh)
    axes = axes_of(entry, mesh)
    if not axes:
        return x
    y = x.contiguous().clone()
    for a in axes:
        dist.all_reduce(y, op=op, group=mesh.group(a))
    return y


def psum(x: torch.Tensor, entry: Axes, mesh=None) -> torch.Tensor:
    """Sum over the ranks along the axes (a new tensor)."""
    return _reduce(x, entry, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, entry: Axes, mesh=None) -> torch.Tensor:
    """Elementwise max over the ranks along the axes (a new tensor)."""
    return _reduce(x, entry, dist.ReduceOp.MAX, mesh)


def all_gather(x: torch.Tensor, entry: Axes, dim: int,
               mesh=None) -> torch.Tensor:
    """The ranks' tensors along the axes concatenated on ``dim`` in axis
    order (``lax.all_gather(..., tiled=True)``)."""
    mesh = _mesh(mesh)
    axes = axes_of(entry, mesh)
    for a in reversed(axes):               # minor axis first
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[a])]
        dist.all_gather(parts, x, group=mesh.group(a))
        x = torch.cat(parts, dim=dim)
    return x


def local_slice(x: torch.Tensor, entry: Axes, dim: int,
                mesh=None) -> torch.Tensor:
    """This rank's block of ``dim`` when it is cut along the axes (a view;
    no communication): the inverse of ``all_gather``."""
    n = axis_size(entry, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    step = x.shape[dim] // n
    return x.narrow(dim, axis_index(entry, mesh) * step, step)


def reshard_dim(x: torch.Tensor, dim: int, have: Axes, want: Axes,
                mesh=None) -> torch.Tensor:
    """Re-lay ``dim`` from cut along ``have`` to cut along ``want``:
    gathered whole when the two differ, then cut (a view)."""
    if axes_of(have, mesh) == axes_of(want, mesh):
        return x
    return local_slice(all_gather(x, have, dim, mesh), want, dim, mesh)


def reshard(x: torch.Tensor, have: Sequence[Axes], want: Sequence[Axes],
            mesh=None) -> torch.Tensor:
    """``reshard_dim`` over every dim of a spec (missing entries: whole)."""
    pad = (None,) * x.dim()
    for d, (h, w) in enumerate(zip(tuple(have) + pad, tuple(want) + pad)):
        if d >= x.dim():
            break
        x = reshard_dim(x, d, h, w, mesh)
    return x


def psum_many(xs: Sequence[torch.Tensor], entry: Axes,
              mesh=None) -> list:
    """``psum`` of tensors that share every dim but the last, in one
    all-reduce."""
    if not axes_of(entry, mesh):
        return list(xs)
    sizes = [x.shape[-1] for x in xs]
    return list(psum(torch.cat(xs, dim=-1), entry, mesh).split(sizes, -1))


def gather_last_many(xs: Sequence[torch.Tensor], entry: Axes,
                     mesh=None) -> list:
    """``all_gather`` on the last dim of tensors that share every other
    dim, in one collective."""
    if not axes_of(entry, mesh):
        return list(xs)
    sizes = [x.shape[-1] for x in xs]
    g = all_gather(torch.cat(xs, dim=-1).unsqueeze(0), entry, 0, mesh)
    return [p.movedim(0, -2).reshape(*p.shape[1:-1], -1)
            for p in g.split(sizes, -1)]
