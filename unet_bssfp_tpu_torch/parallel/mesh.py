"""Device mesh, sharded values and the three primitives the mesh path is
built from (counterpart of ``unet_bssfp_tpu/parallel/mesh.py``).

The mesh is single-controller, as the JAX package's is: one process holds
every shard. A :class:`Mesh` is an array of ``torch.device`` s over the axes
``data`` (dim 0 of a batch) and, optionally, ``space`` (dim 1, the volume's
d), **in which one device may appear more than once**: several positions on
one card (or on the CPU, as the tests have them) run one after the other on
that device; positions on different cards run on their own. Where the JAX
package lets ``jit`` place collectives from sharding annotations, the port
spells them out on a :class:`Sharded` value (the per-position tensors plus
the mesh):

- :meth:`Sharded.map`: a local op on every shard;
- :meth:`Sharded.halo_d`: every shard gets its ``space`` neighbours' edge d
  slices, zeros at the volume's two ends (the SAME pad of a 3³ conv);
- :meth:`Sharded.all_sum`: the sum of a small tensor over one mesh axis,
  or over both (the whole mesh), in a fixed order, so every position holds
  the same bits.

All three are plain tensor ops (slice, copy, cat, add), so autograd runs
through them: the backward of the halo exchange is the reverse exchange,
with the neighbours' edge gradients added.

Parameters are replicated once per distinct device (:func:`replicate`),
not once per position; :func:`local` picks a module's replica on a device.
Training takes a mesh whose positions all lie on one device
(:func:`training_device`): its shards share the modules' parameters, so
autograd sums their gradients, and one optimizer step follows.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

AXES = ("data", "space")


def as_device(d: Union[str, torch.device]) -> torch.device:
    """``d`` with its index spelled out, or a ``ValueError`` if this machine
    has no such device."""
    try:
        dev = torch.device(d)
    except RuntimeError as e:
        raise ValueError(f"unknown device {d!r}: {e}") from None
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unknown device {d!r}: a mesh takes cpu and cuda devices")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    idx = dev.index if dev.index is not None else 0
    if idx >= n:
        raise ValueError(f"unknown device {d!r}: {n} CUDA device(s) visible")
    return torch.device("cuda", idx)


def same_device(a: Union[str, torch.device], b: Union[str, torch.device]) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is ``cuda:0``)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class Mesh:
    """``devices[i][j]``: the device of data position i, space position j (a
    mesh without a ``space`` axis has one column)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Sequence[str]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(row) for row in devices)
        self.axis_names = tuple(axis_names)

    def size(self, axis: str) -> int:
        """Positions along ``axis``; 1 for an axis the mesh does not have."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")
        return len(self.devices) if axis == "data" else len(self.devices[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.size(a) for a in self.axis_names)

    @property
    def positions(self) -> int:
        return self.size("data") * self.size("space")

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in order of first appearance."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))

    def data_only(self) -> "Mesh":
        """The mesh's first ``space`` column: the batch split, d whole."""
        return Mesh([row[:1] for row in self.devices], self.axis_names)

    def plan(self, batch: int, d: int) -> Optional["Mesh"]:
        """The mesh a (batch, d, ...) tensor is really split over (the JAX
        package's ``_active_conv_mesh``): this one if ``data`` divides the
        batch and ``space`` divides d; its data-only part if only d does
        not divide; ``None`` (unsplit) if the batch does not divide."""
        if batch % self.size("data"):
            return None
        if d % self.size("space"):
            return self.data_only() if self.size("data") > 1 else None
        return self

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, devices={self.devices})"


def make_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device) with the
    axes ``('data',)`` or ``('data', 'space')``. ``shape`` defaults to all
    positions on ``data``; where it has more positions than there are
    devices, the devices repeat in turn (position k on device k mod n), so
    ``make_mesh(['cuda:0'], ('data', 'space'), (1, 2))`` puts both halves of
    a volume on one card. A device this machine does not have raises."""
    axes = tuple(axes)
    if axes not in (AXES[:1], AXES):
        raise ValueError(f"mesh axes {axes} not in {(AXES[:1], AXES)}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; name the "
                               "devices (e.g. ['cpu'] * 8) to build a mesh elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [as_device(d) for d in devices]
    if not devs:
        raise ValueError("make_mesh: no device given")
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n_data, n_space = shape[0], (shape[1] if len(shape) > 1 else 1)
    grid = [[devs[(i * n_space + j) % len(devs)] for j in range(n_space)]
            for i in range(n_data)]
    return Mesh(grid, axes)


class Sharded:
    """One tensor per mesh position, ``parts[i][j]`` on ``mesh.devices[i][j]``:
    a (B, D, ...) value whose dim 0 is split over ``data`` and dim 1 over
    ``space``. Every shard has the same shape; ``shape`` and ``dtype`` are a
    shard's."""

    __slots__ = ("mesh", "parts")

    def __init__(self, mesh: Mesh, parts: Sequence[Sequence[torch.Tensor]]):
        self.mesh = mesh
        self.parts = tuple(tuple(row) for row in parts)
        if (len(self.parts) != mesh.size("data")
                or any(len(row) != mesh.size("space") for row in self.parts)):
            raise ValueError(f"{len(self.parts)} rows of parts do not fit {mesh}")

    @property
    def shape(self) -> torch.Size:
        return self.parts[0][0].shape

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    def map(self, fn: Callable[..., torch.Tensor], *others: "Sharded") -> "Sharded":
        """``fn(shard, *other_shards)`` at every position."""
        return Sharded(self.mesh, [
            [fn(t, *(o.parts[i][j] for o in others)) for j, t in enumerate(row)]
            for i, row in enumerate(self.parts)])

    def halo_d(self, n: int = 1) -> "Sharded":
        """Every shard (B, D, ...) → (B, D + 2n, ...): below it the last
        ``n`` d slices of its lower ``space`` neighbour, above it the first
        ``n`` of its upper one, zeros where the volume ends. A slice is
        copied across devices where the neighbour lies on another one (on
        the current streams, so after its producer), in its own dtype."""
        def one(row, j):
            t = row[j]
            edge = t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))
            lo = row[j - 1][:, -n:].to(t.device) if j > 0 else edge
            hi = row[j + 1][:, :n].to(t.device) if j + 1 < len(row) else edge
            return torch.cat([lo, t, hi], dim=1)

        return Sharded(self.mesh, [[one(row, j) for j in range(len(row))]
                                   for row in self.parts])

    def all_sum(self, axis: Union[str, Tuple[str, ...]] = "space") -> "Sharded":
        """Every position gets the sum of its group's shards along ``axis``
        (for ``space``: the positions of its data row; for ``AXES``, both
        axes: every position of the mesh, row by row), added in position
        order on every member, so all hold the same bits. Meant for small
        tensors (moments): every shard is copied to every member."""
        nd, ns = self.mesh.size("data"), self.mesh.size("space")
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if not axes or any(a not in AXES for a in axes):
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES} or both")

        def one(i, j):
            rows = range(nd) if "data" in axes else (i,)
            cols = range(ns) if "space" in axes else (j,)
            group = [self.parts[k][m] for k in rows for m in cols]
            dev = self.parts[i][j].device
            total = group[0].to(dev)
            for t in group[1:]:
                total = total + t.to(dev)
            return total

        return Sharded(self.mesh, [[one(i, j) for j in range(ns)] for i in range(nd)])


def apply_local(fn: Callable[..., torch.Tensor], x, *others):
    """``fn`` on a tensor, or on every shard of a :class:`Sharded` value."""
    if isinstance(x, Sharded):
        return x.map(fn, *others)
    return fn(x, *others)


def shard_batch(mesh: Mesh, batch):
    """Split a (B, D, ...) tensor, or every tensor of a dict, list or tuple,
    over the mesh: dim 0 over ``data`` and, when the mesh has that axis, dim
    1 (d) over ``space``; each shard is moved to its position's device. A
    dim its axis does not divide raises a ``ValueError`` naming the shape."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    nd, ns = mesh.size("data"), mesh.size("space")
    if batch.ndim < 2 or batch.shape[0] % nd or batch.shape[1] % ns:
        raise ValueError(
            f"shard_batch: shape {tuple(batch.shape)} does not split over {mesh}: "
            f"dim 0 must be a multiple of {nd} and dim 1 of {ns}")
    b, d = batch.shape[0] // nd, batch.shape[1] // ns
    return Sharded(mesh, [
        [batch[i * b:(i + 1) * b, j * d:(j + 1) * d].to(mesh.devices[i][j]).contiguous()
         for j in range(ns)] for i in range(nd)])


def gather_batch(x: Sharded, device: Union[str, torch.device, None] = None
                 ) -> torch.Tensor:
    """The inverse of :func:`shard_batch`: one tensor on ``device`` (default:
    the mesh's first device)."""
    return torch.cat(gather_rows(x, device), dim=0)


def gather_rows(x: Sharded, device: Union[str, torch.device, None] = None
                ) -> Tuple[torch.Tensor, ...]:
    """One tensor per ``data`` row of ``x`` (its ``space`` shards joined on
    d), each on ``device`` (default: the mesh's first device)."""
    dev = torch.device(device) if device is not None else x.mesh.devices[0][0]
    return tuple(torch.cat([t.to(dev) for t in row], dim=1) for row in x.parts)


def training_device(mesh: Mesh, what: str = "training") -> torch.device:
    """The one device every position of ``mesh`` lies on. A mesh over
    several distinct devices raises ``NotImplementedError``: training there
    needs the replicas' gradients reduced and their weights and BatchNorm
    buffers re-broadcast after each step, which the port does not do
    (serving on such a mesh works)."""
    if len(mesh.distinct) > 1:
        raise NotImplementedError(
            f"{what} on {mesh}: a training mesh must lie on one device; across "
            f"{len(mesh.distinct)} devices the replicas' gradients would need a reduce")
    return mesh.distinct[0]


def replicate(module: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """Move ``module`` to the mesh's first device and put one deep copy of
    it on every other distinct device; every submodule then finds its twin
    on a device through :func:`local`. Returns ``{device: replica}``,
    ``module`` itself first. Replicas are copies: after loading other
    weights into ``module``, replicate again."""
    first, *rest = mesh.distinct
    module.to(first)
    for m in module.modules():
        m.__dict__.pop("_replicas", None)
    replicas = {first: module}
    for dev in rest:
        replicas[dev] = copy.deepcopy(module).to(dev)
    if rest:
        for group in zip(*(r.modules() for r in replicas.values())):
            table = dict(zip(replicas, group))
            for m in group:
                m.__dict__["_replicas"] = table
    return replicas


def replicas(module: nn.Module) -> Tuple[nn.Module, ...]:
    """``module`` and its twins on the other devices, if it was replicated."""
    return tuple(module.__dict__.get("_replicas", {None: module}).values())


def local(module: nn.Module, device: torch.device) -> nn.Module:
    """``module``'s replica on ``device``: itself unless :func:`replicate`
    spread it over several devices."""
    table = module.__dict__.get("_replicas")
    if table is None:
        return module
    if device not in table:
        raise ValueError(f"no replica of {type(module).__name__} on {device}; "
                         f"it was replicated to {tuple(table)}")
    return table[device]
