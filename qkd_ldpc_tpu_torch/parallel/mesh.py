"""Device meshes, placement helpers and process-group bring-up.

Counterpart of ``qkd_ldpc_tpu/parallel/mesh.py``.  The reference's whole
parallelism is a CPU thread pool fork-joined over Monte-Carlo trials
(``BS::thread_pool``, ``src/simulation.cpp:230-250``).  Two axes replace it:

- ``trial`` — data parallelism over independent trials.  Each trial shard
  decodes its own lanes of a global batch; the only communication is the
  seven partial sums a chunk, merged on the host.
- ``node`` — one frame's variable nodes split across the devices of a row
  (``parallel/node_sharded.py``), with per-check reductions across them.

JAX's mesh is one program over a grid of devices that may span processes.
The port keeps that model with a small :class:`Mesh`: a grid
``[n_trial, n_node]`` of this process's ``torch.device``s (a device may
repeat: four shards on one card, or eight on the CPU), the axis names, and
the process's place in a ``torch.distributed`` group.  The trial axis counts
the shards of every process: global trial shard ``g = process_index *
n_local + local_index``, and every process holds the same number of them.
A node axis that spans processes would need device collectives and is not
part of the port yet (ROADMAP item 11c).
"""

from __future__ import annotations

import atexit
import datetime
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from qkd_ldpc_tpu_torch.utils import canonical_device

TRIAL_AXIS = "trial"
NODE_AXIS = "node"

# How long a collective (the rendezvous included) waits for the other
# processes before it raises.
_GROUP_TIMEOUT_S = 600

NODE_ACROSS_PROCESSES = (
    "a node axis that spans processes needs device collectives (NCCL) and "
    "is not ported yet: ROADMAP items 11b/11c"
)


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Mesh:
    """A ``[n_trial, n_node]`` grid of this process's devices with named axes.

    ``devices`` holds the local devices only; ``shape`` maps each axis name
    to its size, the trial axis counted over every process, so
    ``mesh.shape[TRIAL_AXIS]`` reads as in JAX.  ``axis_names`` is
    ``("trial",)``, ``("node",)`` or ``("trial", "node")``; an absent axis
    has size 1 in ``devices``.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if axis_names not in ((TRIAL_AXIS,), (NODE_AXIS,), (TRIAL_AXIS, NODE_AXIS)):
            raise ValueError(f"mesh axes must be ({TRIAL_AXIS!r},), ({NODE_AXIS!r},) or "
                             f"({TRIAL_AXIS!r}, {NODE_AXIS!r}), got {axis_names}")
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a mesh over axes {axis_names} needs a non-empty "
                             f"{len(axis_names)}-D grid of devices, got shape {grid.shape}")
        grid = grid.reshape(1, -1) if axis_names == (NODE_AXIS,) else grid.reshape(len(grid), -1)
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = canonical_device(d)
        self.axis_names = axis_names
        self.process_index = process_index()
        self.process_count = process_count()
        n_local = self.devices.shape[0]
        if self.process_count > 1:
            if NODE_AXIS in axis_names and TRIAL_AXIS not in axis_names:
                raise NotImplementedError(NODE_ACROSS_PROCESSES)
            counts = _all_gather_ints([n_local])
            if len({int(c[0]) for c in counts}) != 1:
                raise ValueError(
                    "every process must hold the same number of trial shards; "
                    f"the processes hold {[int(c[0]) for c in counts]}")
        self.shape = {}
        if TRIAL_AXIS in axis_names:
            self.shape[TRIAL_AXIS] = n_local * self.process_count
        if NODE_AXIS in axis_names:
            self.shape[NODE_AXIS] = self.devices.shape[1]

    @property
    def local_trial_shards(self) -> int:
        return self.devices.shape[0]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, process={self.process_index}/"
                f"{self.process_count}, devices={self.devices.tolist()})")


def _devices_or_cards(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices=[torch.device('cpu')] * k explicitly "
            "to build a mesh on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_trial_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible card; raises without
    one): pure trial parallelism."""
    return Mesh(_devices_or_cards(devices), (TRIAL_AXIS,))


def make_mesh(n_trial: int | None = None, n_node: int = 1, devices=None) -> Mesh:
    """2-D ``(trial, node)`` mesh: ``n_node`` devices cooperate on one frame,
    the other factor runs independent trial shards.  ``n_trial`` counts the
    trial shards of every process, as the trial axis of the mesh does."""
    devices = _devices_or_cards(devices)
    count = process_count()
    n = len(devices) * count
    if n % n_node:
        raise ValueError(f"n_node={n_node} does not divide device count {n}")
    n_trial = n_trial if n_trial is not None else n // n_node
    if n_trial * n_node != n:
        raise ValueError(f"{n_trial} x {n_node} != {n} devices")
    if count > 1 and len(devices) % n_node:
        raise NotImplementedError(NODE_ACROSS_PROCESSES)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(-1, n_node), (TRIAL_AXIS, NODE_AXIS))


class TrialShard(NamedTuple):
    """One trial shard of this process: its global index, its row of devices
    (one per node shard) and its lanes of a global batch."""

    index: int
    devices: tuple
    lanes: range

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def trial_sharding(mesh: Mesh, batch: int) -> list[TrialShard]:
    """Where each local trial shard of ``mesh`` runs and which lanes of a
    global ``batch`` it takes: shard ``g`` takes ``[g*b, (g+1)*b)`` with
    ``b = batch / mesh.shape["trial"]`` (``batch`` a multiple of it).  The
    torch meaning of JAX's leading-axis ``NamedSharding``."""
    n_shards = mesh.shape.get(TRIAL_AXIS, 1)
    if batch % n_shards:
        raise ValueError(f"batch {batch} is not a multiple of the {n_shards} trial shards")
    b = batch // n_shards
    first = mesh.process_index * mesh.local_trial_shards
    return [
        TrialShard(first + t, tuple(mesh.devices[t]), range((first + t) * b, (first + t + 1) * b))
        for t in range(mesh.local_trial_shards)
    ]


def replicated(mesh: Mesh) -> list[torch.device]:
    """The distinct devices of ``mesh``, in order: each needs one copy of
    the code's index tensors (``LDPCCode.to_device`` caches it there).  The
    torch meaning of JAX's replicated ``NamedSharding``."""
    return list(dict.fromkeys(mesh.devices.reshape(-1)))


def run_on_shards(fn: Callable, shards: Sequence[TrialShard]) -> list:
    """``[fn(shard) for shard in shards]``, in shard order.

    Shards on distinct cards run in one host thread per card (the decode
    loop fetches a flag every iteration, so one thread would run the cards
    in turn); shards that share a card, and CPU shards, run in turn in the
    caller's thread.  An exception of any shard is raised here.
    """
    cards = list(dict.fromkeys(s.device for s in shards))
    if len(cards) < 2 or any(c.type != "cuda" for c in cards):
        return [fn(s) for s in shards]

    def run_card(card):
        with torch.cuda.device(card):
            return {i: fn(s) for i, s in enumerate(shards) if s.device == card}

    done = {}
    with ThreadPoolExecutor(max_workers=len(cards)) as pool:
        for f in [pool.submit(run_card, c) for c in cards]:
            done.update(f.result())
    return [done[i] for i in range(len(shards))]


def _all_gather_ints(values: Sequence[int] | torch.Tensor) -> list[torch.Tensor]:
    """Every process's int64 tensor of the same shape, in rank order (one
    gloo ``all_gather`` of CPU tensors); this process's alone without a
    group."""
    import torch.distributed as dist

    local = torch.as_tensor(values, dtype=torch.int64).cpu().contiguous()
    if process_count() == 1:
        return [local]
    out = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(out, local)
    return out


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's ``[k, ...]`` int64 rows in rank order, which
    is global trial-shard order."""
    return torch.cat(_all_gather_ints(local), dim=0)


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int) -> None:
    """Join a ``torch.distributed`` group of ``num_processes`` processes with
    rank ``process_id``, rendezvous at ``tcp://coordinator_address``.

    The backend is gloo: the trial axis moves only seven partial sums a
    chunk, which the host merges anyway, and gloo on CPU tensors works on a
    host without a card and for two processes that share one card (NCCL
    refuses two ranks on one GPU).  A second call in an initialised process
    is a no-op; every other failure (a bad address, a port in use, a
    mismatched group size) surfaces — carrying on as independent
    single-process runs would repeat the whole sweep in each.
    """
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this PyTorch build")
    if dist.is_initialized():
        return
    if num_processes is None or num_processes < 1:
        raise ValueError("a multi-process run needs --num-processes >= 1")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id must lie in [0, {num_processes}), got {process_id}")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S),
    )
    # A group still up when the interpreter tears down aborts the process
    # (gloo's threads are destroyed while joinable); leave it at exit, as
    # jax.distributed does.
    atexit.register(shutdown_distributed)


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
