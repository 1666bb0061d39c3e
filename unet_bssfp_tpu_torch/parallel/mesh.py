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
Inside :meth:`Sharded.map` the lookup takes the position's mesh entry
(:func:`place`), not its shard's ``t.device``: the two differ only where a
mesh names the host twice, ``cpu`` and ``cpu:0``, which is how the CPU tests
hold two real replicas in one process.

Training on a mesh runs each position on its device's replica. Where the
positions share one device, they share its parameters and autograd sums
their gradients. Over several devices the first device's modules are the
masters and alone have optimizers: after the backward
:func:`reduce_gradients` sums every replica's gradients onto the master's,
in the mesh's device order (a sum: the loss is already the global batch's),
one optimizer step follows, and :func:`broadcast` copies the master's
parameters and buffers into every replica in place. :func:`default_mesh` is
the mesh the loops train on when the caller names no device: every visible
card that the batch divides.

Across processes (``parallel.distributed``) each process holds its own
mesh, or none, over its own devices, and the group spans the processes:
:meth:`Sharded.all_sum` over ``data`` (or both axes) adds the other
processes' sums, :func:`reduce_gradients` sums the masters' gradients over
the processes after the local sum, :func:`broadcast` stays local, the
dropout seeds take the replica's index over every process
(:func:`replica_seed`), and :func:`default_mesh` is none: each process
trains on its own card.
"""

from __future__ import annotations

import contextvars
import copy
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from unet_bssfp_tpu_torch.parallel import distributed

AXES = ("data", "space")
_PLACE = contextvars.ContextVar("mesh_place", default=None)


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
        """``fn(shard, *other_shards)`` at every position, :func:`place`
        naming the position's mesh entry while ``fn`` runs."""
        def at(i, j):
            token = _PLACE.set(self.mesh.devices[i][j])
            try:
                return fn(self.parts[i][j], *(o.parts[i][j] for o in others))
            finally:
                _PLACE.reset(token)

        return Sharded(self.mesh, [[at(i, j) for j in range(len(row))]
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
        tensors (moments): every shard is copied to every member. In a
        process group the ``data`` axis spans the processes: a sum over it
        adds the other processes' group sums (``distributed.all_sum``,
        through autograd), taken once per group and copied to its
        members."""
        nd, ns = self.mesh.size("data"), self.mesh.size("space")
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if not axes or any(a not in AXES for a in axes):
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES} or both")

        def one(i, j, dev):
            rows = range(nd) if "data" in axes else (i,)
            cols = range(ns) if "space" in axes else (j,)
            group = [self.parts[k][m] for k in rows for m in cols]
            total = group[0].to(dev)
            for t in group[1:]:
                total = total + t.to(dev)
            return total

        if "data" not in axes or distributed.process_count() == 1:
            return Sharded(self.mesh, [[one(i, j, self.parts[i][j].device) for j in range(ns)]
                                       for i in range(nd)])
        # a data column's sum, or the whole mesh's, over every process
        totals = {j: distributed.all_sum(one(0, j, self.parts[0][j].device))
                  for j in (range(ns) if "space" not in axes else (0,))}
        return Sharded(self.mesh, [[totals[j if "space" not in axes else 0].to(
            self.parts[i][j].device) for j in range(ns)] for i in range(nd)])


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


def replicate(module: nn.Module, mesh: Mesh) -> Dict[torch.device, nn.Module]:
    """Move ``module`` to the mesh's first device and put one deep copy of
    it on every other distinct device; every submodule then finds its twin
    on a device through :func:`local`. Returns ``{device: replica}``,
    ``module`` itself first. Replicas are copies: after loading other
    weights into ``module``, :func:`broadcast` them (or replicate again, and
    bind the copies' dropout generators anew)."""
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


def place(t: torch.Tensor) -> torch.device:
    """Where ``t``'s replicas are looked up: inside :meth:`Sharded.map`, the
    mesh entry of the position whose shard ``t`` is; elsewhere
    ``t.device``."""
    entry = _PLACE.get()
    return t.device if entry is None else entry


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


def each_replica(module: nn.Module, method: str, *args) -> None:
    """``method(*args)`` on ``module`` and on each of its replicas (train or
    eval mode, ``requires_grad_``, ``zero_grad``)."""
    for twin in replicas(module):
        getattr(twin, method)(*args)


def check_replicas(mesh: Mesh, module: nn.Module, what: str) -> None:
    """``module`` must lie on ``mesh``'s first device, as the master of its
    replicas, and have a replica on every other device of the mesh (built
    with ``mesh=``); otherwise a ``ValueError``."""
    first, table = mesh.devices[0][0], module.__dict__.get("_replicas")
    have = next(module.parameters()).device
    if not same_device(have, first) or (table is not None and next(iter(table)) != first):
        raise ValueError(f"{what}: {type(module).__name__} lies on {have}, not on the "
                         f"first device of {mesh}; build it with mesh=")
    missing = [str(d) for d in mesh.distinct[1:] if table is None or d not in table]
    if missing:
        raise ValueError(f"{what}: {type(module).__name__} has no replica on "
                         f"{', '.join(missing)} of {mesh}; build it with mesh=")


def reduce_gradients(module: nn.Module) -> None:
    """Each parameter's gradient summed over ``module``'s replicas onto the
    master's (the first device's), in the mesh's device order; the
    replicas' gradients are cleared. In a process group the masters'
    gradients are then summed over the processes, in one ``all_reduce`` of
    a flat bucket, so every process holds the same sums. Without replicas
    or a group, nothing."""
    master, *rest = replicas(module)
    with torch.no_grad():
        for p, *twins in (zip(master.parameters(), *(r.parameters() for r in rest))
                          if rest else ()):
            total = p.grad
            for twin in twins:
                if twin.grad is not None:
                    g = twin.grad.to(p.device)
                    total = g if total is None else total + g
                    twin.grad = None
            p.grad = total
        grads = [p.grad for p in master.parameters() if p.grad is not None]
        if distributed.process_count() > 1 and grads:
            flat = distributed.sum_in_place(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def broadcast(module: nn.Module) -> None:
    """The master's parameters and buffers copied into each replica of
    ``module`` in place (``copy_``), so the replica table stays valid."""
    master, *rest = replicas(module)
    with torch.no_grad():
        for twin in rest:
            for a, b in zip(twin.parameters(), master.parameters()):
                a.copy_(b)
            for a, b in zip(twin.buffers(), master.buffers()):
                a.copy_(b)


def replica_seed(seed: int, k: int) -> int:
    """The dropout seed of replica ``k``, counted over every process's
    replicas, rank-major (a process's ``j``-th distinct device is ``rank ·
    replicas + j``): ``seed`` itself for the first (so one device draws as
    before), a seed derived from ``(seed, k)`` for the others."""
    if k == 0:
        return seed
    return int(np.random.SeedSequence([seed, k]).generate_state(1, np.uint32)[0])


def default_mesh(batch_size: int) -> Optional[Mesh]:
    """The mesh the training loops take when the caller names neither a
    device nor a mesh, as the JAX package's loops build theirs: with more
    than one CUDA device visible, a ``data`` axis over ``cuda:0`` …
    ``cuda:k-1``, ``k = gcd(batch_size, device count)``, printing the JAX
    package's line where ``k`` falls short of the count. ``None`` (train on
    ``cuda``) with one card or none, or where ``k`` is 1; ``None`` in a
    process group too: each process trains on its own card
    (``distributed.device``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= 1 or distributed.process_count() > 1:
        return None
    usable = math.gcd(batch_size, n)
    if usable != n:
        print(f"batch_size {batch_size} not divisible by {n} devices; using a "
              f"{usable}-device mesh (set batch_size to a multiple of the device count "
              f"to use all devices)")
    return make_mesh([f"cuda:{i}" for i in range(usable)]) if usable > 1 else None
