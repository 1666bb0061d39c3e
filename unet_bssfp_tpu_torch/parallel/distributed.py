"""Training across processes: one process per card (counterpart of
``jax.distributed`` and of the JAX package's multi-process data feeding,
``parallel/mesh.py:shard_batch`` through
``make_array_from_process_local_data``).

Each process holds its own share of the global batch (``DataConfig.
process_split``: its stride-slice of the sample lists) and, optionally, a
local mesh over its own devices. A training step then takes the global
batch's losses and gradients from the processes' shares:

- BatchNorm's train-mode moments are the global batch's: each process's
  moments are combined exactly (Chan et al., every share of one size) by
  :func:`all_sum`, an ``all_reduce`` that autograd runs through (its
  backward is the ``all_reduce`` of the gradients);
- each process backpropagates its share of a batch mean (:func:`shares`:
  its own batch's mean over the process count), the gradients are summed
  over processes (``mesh.reduce_gradients``) and every process takes the
  same AdamW step on the same sums;
- the metrics are the sums of the shares (:func:`global_metrics`).

Every cross-process operation is an ``all_reduce`` or a ``broadcast``:
gloo supports only these two on CUDA tensors, and NCCL refuses two
processes on one card, so one code path serves NCCL over several cards and
gloo on one. A gather is an ``all_reduce`` of a zero-filled buffer in which
each process writes its own slot (exact: adding zeros is exact). Every
collective and the rendezvous carry the group's timeout, so a mismatch
fails instead of hanging.

:func:`initialize` takes the coordinator's address (``tcp://host:port``,
``host:port`` or ``file:///path``), the process count and this process's
index from the caller; nothing is discovered. The backend follows one rule,
printed at start: NCCL where every process runs on a CUDA card of its own,
gloo where a process runs on the CPU or two processes share a card.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import json
import os
import socket
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

#: Seconds the rendezvous and every collective wait before failing.
DEFAULT_TIMEOUT_S = 600.0
_KEY = "unet_bssfp_tpu_torch"
_SPLIT = contextvars.ContextVar("split_batch", default=False)


_device: Optional[torch.device] = None  # this process's, while the group is up


def _store(address: str, num_processes: int, process_id: int, timeout: datetime.timedelta):
    """The rendezvous store at ``address``: a ``FileStore`` for
    ``file://``, else a ``TCPStore`` that process 0 hosts (a client only
    where ``torchrun``'s agent already hosts it)."""
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], num_processes)
        store.set_timeout(timeout)
        return store
    hostport = address[len("tcp://"):] if address.startswith("tcp://") else address
    host, sep, port = hostport.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: expected tcp://host:port, "
                         f"host:port or file:///path")
    agent = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0 and not agent, timeout=timeout)


def _process_device(device, local_rank: int, num_processes: int) -> torch.device:
    """The device named by the caller, or the process's own card,
    ``cuda:{local_rank}``; without a card, or with fewer cards than
    processes, a process that names no device raises."""
    from unet_bssfp_tpu_torch.parallel.mesh import as_device

    if device is not None:
        return as_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; name the device (cpu) to run "
                           "processes on the CPU")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise ValueError(
            f"process with local rank {local_rank} has no card of its own: {n} card(s) "
            f"visible to {num_processes} process(es); name the device (cpu, or a card "
            f"that processes share)")
    return torch.device("cuda", local_rank)


def _backend_rule(places: Sequence[str]):
    """``(backend, reason)`` for the processes' ``host|device`` places."""
    if any(not p.split("|", 1)[1].startswith("cuda") for p in places):
        return "gloo", "a process runs on the CPU"
    if len(set(places)) < len(places):
        return "gloo", "processes share a card"
    return "nccl", "one card per process"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device=None,
               local_rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the group of ``num_processes`` processes as ``process_id``
    (``jax.distributed.initialize``'s arguments). ``device``: the device
    this process trains on (default: its own card, ``cuda:{local_rank}``,
    ``local_rank`` defaulting to ``process_id``). The processes exchange
    their devices through the store and take the backend by the module's
    rule; a ``backend`` the rule does not allow (NCCL on the CPU or on a
    shared card) raises. Returns the backend."""
    global _device
    if _device is not None or dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r} not in ('gloo', 'nccl')")
    local_rank = process_id if local_rank is None else local_rank
    dev = _process_device(device, local_rank, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(coordinator_address, num_processes, process_id, timeout)
    store.set(f"{_KEY}/place/{process_id}", f"{socket.gethostname()}|{dev}")
    places = [store.get(f"{_KEY}/place/{r}").decode() for r in range(num_processes)]
    rule, reason = _backend_rule(places)
    if backend == "nccl" and rule != "nccl":
        raise ValueError(f"backend nccl asked for, but {reason}: {places}")
    backend = backend or rule
    print(f"torch.distributed: process {process_id} of {num_processes} on {dev}, backend "
          f"{backend} ({'named by the caller' if backend != rule else reason})", flush=True)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=timeout)
    _device = dev
    return backend


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    global _device
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def device() -> torch.device:
    """The device this process trains on (``initialize``'s)."""
    if _device is None:
        raise RuntimeError("no process group: call parallel.distributed.initialize")
    return _device


# ------------------------------------------------------------- collectives
class _AllSum(torch.autograd.Function):
    """The SUM ``all_reduce`` of a tensor; its backward is the SUM
    ``all_reduce`` of the gradients (each process's loss depends on every
    process's input)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes, through autograd; ``t`` itself
    without a group."""
    return _AllSum.apply(t) if process_count() > 1 else t


def sum_in_place(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced by its sum over the processes (no autograd)."""
    if process_count() > 1:
        dist.all_reduce(t)
    return t


def gather(t: torch.Tensor) -> torch.Tensor:
    """The processes' ``t`` s (one shape everywhere) joined on dim 0 in
    rank order, on every process, exactly: the ``all_reduce`` of a zero
    buffer holding each process's ``t`` in its slot. No autograd."""
    n = process_count()
    if n == 1:
        return t
    with torch.no_grad():
        buf = t.new_zeros((n,) + tuple(t.shape))
        buf[process_index()] = t
        dist.all_reduce(buf)
    return buf.reshape((n * t.shape[0],) + tuple(t.shape[1:]))


def _host_tensor_device() -> torch.device:
    return _device if _device is not None else torch.device("cpu")


def barrier() -> None:
    """Wait until every process reaches this point (an ``all_reduce``)."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1, device=_host_tensor_device()))


def on_first(fn: Callable[[], Any]) -> Any:
    """``fn()`` run on process 0 alone, its result (JSON-able) broadcast
    to every process: one decision the processes share (a run's name, the
    checkpoint to resume, early stopping)."""
    if process_count() == 1:
        return fn()
    dev = _host_tensor_device()
    data = json.dumps(fn()).encode() if process_index() == 0 else b""
    size = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(size, 0)
    buf = torch.zeros(int(size), dtype=torch.uint8, device=dev)
    if process_index() == 0:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return json.loads(bytes(buf.cpu().tolist()).decode())


def check_same(what: str, values: Sequence[int]) -> None:
    """Every process must hold the same ``values`` (counts that decide how
    many collectives follow); otherwise a ``RuntimeError`` on every
    process, naming each process's values, before any of them waits on a
    collective the others never reach."""
    n = process_count()
    if n == 1:
        return
    mine = torch.tensor(list(values), dtype=torch.int64)
    every = gather(mine[None].to(_host_tensor_device())).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"{what} differ between processes: "
                           f"{dict(enumerate(every.tolist()))}")


# -------------------------------------------------- the global batch's losses
@contextlib.contextmanager
def split_batch():
    """Inside it (in a group), the tensors a loss sees are this process's
    share of a batch split over the processes: a whole-tensor moment
    (``ops.metrics.znorm``) is taken over every process's share."""
    token = _SPLIT.set(process_count() > 1)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def batch_is_split() -> bool:
    return _SPLIT.get()


def moments(xf: torch.Tensor, dims) -> tuple:
    """``(mean, biased var)`` over ``dims`` (size-1 dims kept) of the union
    of the processes' ``xf`` s, all of one shape, through autograd: each
    process's own, combined exactly (Chan et al.): ``mean = Σ mean_i /
    n``, ``var = Σ (var_i + (mean_i - mean)²) / n``."""
    var, mean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    n = process_count()
    if n == 1:
        return mean, var
    mean_g = all_sum(mean) / n
    return mean_g, all_sum(var + (mean - mean_g) ** 2) / n


def shares(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each batch mean of this process's batch as its share of the global
    batch's: over the process count (every process's batch has one size,
    ``global_metrics`` checks it). Without a group, the losses as given."""
    n = process_count()
    return losses if n == 1 else {k: v / n for k, v in losses.items()}


def global_metrics(metrics: Dict[str, torch.Tensor], batch: int
                   ) -> Dict[str, torch.Tensor]:
    """The shares of ``metrics`` (0-d tensors of one device) summed over the
    processes, in f64, back in each one's dtype, in one ``all_reduce``
    that also sums the local ``batch`` sizes: sizes that differ raise on
    every process."""
    n = process_count()
    if n == 1:
        return metrics
    keys = list(metrics)
    dev = metrics[keys[0]].device
    flat = torch.stack([metrics[k].detach().to(dev, torch.float64).reshape(())
                        for k in keys] + [torch.tensor(float(batch), dtype=torch.float64,
                                                       device=dev)])
    dist.all_reduce(flat)
    if float(flat[-1]) != n * batch:
        raise RuntimeError(f"process {process_index()}: local batch {batch}, but the "
                           f"processes' batches sum to {int(flat[-1])}: every process's "
                           f"batch must have one size")
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}

