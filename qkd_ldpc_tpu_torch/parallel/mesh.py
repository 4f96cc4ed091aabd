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
The port keeps that model with a small :class:`Mesh`: a grid ``[n_trial,
n_node]`` over the devices of every process, the axis names, and the
process's place in a ``torch.distributed`` group.  Each process names its
own ``torch.device``s (a device may repeat: four shards on one card, or
eight on the CPU), and every process holds the same number ``L`` of them.
The global device list is JAX's: device ``g = rank * L + l`` is local
device ``l`` of process ``rank``, and the grid is that list reshaped, so row
``r`` holds global devices ``r * n_node ... (r + 1) * n_node - 1``.  A row may
therefore lie wholly in one process (``L % n_node == 0``), span whole
processes (``n_node % L == 0``) or both (a process holding whole rows and
part of another).  A row's shards exchange their per-check partials through
:func:`row_gather`: copies within a process, a gloo ``all_gather`` over a
subgroup of the row's processes across them.
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


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class Row(NamedTuple):
    """One row of a mesh (one trial shard, ``n_node`` node shards) as this
    process sees it."""

    index: int  # the row's place on the trial axis
    n_node: int
    nodes: tuple  # node positions of this process's shards of the row, ascending
    devices: tuple  # their devices
    spans: tuple  # (rank, shards held) of every process holding shards of the row
    group: object = None  # gloo subgroup over those ranks; None for a local row

    @property
    def leader(self) -> bool:
        """This process holds the row's first shard: it alone reports the
        row's results where every process's are gathered."""
        return self.nodes[0] == 0


class Mesh:
    """A ``[n_trial, n_node]`` grid over every process's devices, named axes.

    ``devices`` is the global grid: this process's ``torch.device``s where
    it holds the shard, ``None`` where another process does.  ``shape`` maps
    each axis name to its size, so ``mesh.shape[TRIAL_AXIS]`` reads as in
    JAX.  ``axis_names`` is ``("trial",)``, ``("node",)`` or ``("trial",
    "node")``.  ``rows`` lists the rows this process holds shards of, in
    ascending order.

    ``devices`` (this process's) may be a ``[k, n_node]`` grid, which fixes
    ``n_node`` for a 2-D mesh; else pass ``n_node``.  A trial-only mesh has
    ``n_node = 1``, a node-only mesh one row over every device of every
    process.  Constructing a mesh in a process group is collective: every
    process constructs the same mesh, in the same order as its other meshes.
    """

    def __init__(self, devices, axis_names: Sequence[str], n_node: int | None = None):
        axis_names = tuple(axis_names)
        if axis_names not in ((TRIAL_AXIS,), (NODE_AXIS,), (TRIAL_AXIS, NODE_AXIS)):
            raise ValueError(f"mesh axes must be ({TRIAL_AXIS!r},), ({NODE_AXIS!r},) or "
                             f"({TRIAL_AXIS!r}, {NODE_AXIS!r}), got {axis_names}")
        grid = np.asarray(devices, dtype=object)
        if grid.size == 0:
            raise ValueError(f"a mesh over axes {axis_names} needs at least one device")
        local = [canonical_device(d) for d in grid.reshape(-1)]
        self.axis_names = axis_names
        self.process_index = process_index()
        self.process_count = process_count()
        L = len(local)
        if self.process_count > 1:
            counts = _all_gather_ints([L])
            if len({int(c[0]) for c in counts}) != 1:
                raise ValueError(
                    "every process must hold the same number of trial shards and devices; "
                    f"the processes hold {[int(c[0]) for c in counts]} devices")
        n = L * self.process_count
        if axis_names == (TRIAL_AXIS,):
            n_node = 1
        elif axis_names == (NODE_AXIS,):
            n_node = n
        elif n_node is None:
            if grid.ndim != 2:
                raise ValueError("a (trial, node) mesh needs a [k, n_node] grid of "
                                 "devices or n_node")
            n_node = grid.shape[1]
        if n % n_node:
            raise ValueError(f"n_node={n_node} does not divide device count {n}")
        n_trial = n // n_node
        self.shape = {}
        if TRIAL_AXIS in axis_names:
            self.shape[TRIAL_AXIS] = n_trial
        if NODE_AXIS in axis_names:
            self.shape[NODE_AXIS] = n_node

        me = self.process_index
        self.devices = np.empty((n_trial, n_node), dtype=object)
        for g in range(me * L, (me + 1) * L):
            self.devices[g // n_node, g % n_node] = local[g - me * L]
        self.rows = []
        for r in range(n_trial):
            held = range(r * n_node, (r + 1) * n_node)
            ranks = sorted({g // L for g in held})
            spans = tuple((k, sum(1 for g in held if g // L == k)) for k in ranks)
            # new_group is collective over the world: every process creates
            # every spanning row's group, in row order.
            group = _new_group(ranks) if len(ranks) > 1 else None
            if me in ranks:
                nodes = tuple(c for c in range(n_node) if self.devices[r, c] is not None)
                self.rows.append(Row(r, n_node, nodes, tuple(self.devices[r, c] for c in nodes),
                                     spans, group))

    @property
    def local_devices(self) -> list[torch.device]:
        """This process's devices, in global order."""
        return [d for d in self.devices.reshape(-1) if d is not None]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, process={self.process_index}/"
                f"{self.process_count}, devices={self.devices.tolist()})")


def _new_group(ranks):
    import torch.distributed as dist

    return dist.new_group(ranks, timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S),
                          backend="gloo")


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
    trial shards of every process, as the trial axis of the mesh does; a row
    of ``n_node`` devices may span processes (see the module docstring)."""
    devices = _devices_or_cards(devices)
    n = len(devices) * process_count()
    if n % n_node:
        raise ValueError(f"n_node={n_node} does not divide device count {n}")
    n_trial = n_trial if n_trial is not None else n // n_node
    if n_trial * n_node != n:
        raise ValueError(f"{n_trial} x {n_node} != {n} devices")
    return Mesh(devices, (TRIAL_AXIS, NODE_AXIS), n_node=n_node)


class TrialShard(NamedTuple):
    """One trial shard (mesh row) this process holds shards of: its global
    index, this process's devices of the row, its lanes of a global batch,
    and the row itself."""

    index: int
    devices: tuple
    lanes: range
    row: Row

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def trial_sharding(mesh: Mesh, batch: int) -> list[TrialShard]:
    """Where each trial shard this process holds runs and which lanes of a
    global ``batch`` it takes: shard ``g`` takes ``[g*b, (g+1)*b)`` with
    ``b = batch / mesh.shape["trial"]`` (``batch`` a multiple of it).  The
    torch meaning of JAX's leading-axis ``NamedSharding``."""
    n_shards = mesh.shape.get(TRIAL_AXIS, 1)
    if batch % n_shards:
        raise ValueError(f"batch {batch} is not a multiple of the {n_shards} trial shards")
    b = batch // n_shards
    return [TrialShard(r.index, r.devices, range(r.index * b, (r.index + 1) * b), r)
            for r in mesh.rows]


def replicated(mesh: Mesh) -> list[torch.device]:
    """The distinct devices of ``mesh`` in this process, in order: each needs
    one copy of the code's index tensors (``LDPCCode.to_device`` caches it
    there).  The torch meaning of JAX's replicated ``NamedSharding``."""
    return list(dict.fromkeys(mesh.local_devices))


def run_on_shards(fn: Callable, shards: Sequence[TrialShard]) -> list:
    """``[fn(shard) for shard in shards]``, in shard order.

    Shards on distinct cards run in one host thread per card (a call waits
    for its result, and the eager loops fetch from the card, so one thread
    would run the cards in turn; a card's captured decode graphs
    are shared by the threads that use it, see
    ``decoder.device_loop.run_graph``); shards that share a card, and CPU
    shards, run in turn in the caller's thread, and so do all shards where a
    row spans processes: its blocking collectives pair up only if every
    process runs its rows in ascending order.  An exception of any shard is
    raised here.
    """
    cards = list(dict.fromkeys(s.device for s in shards))
    if (len(cards) < 2 or any(c.type != "cuda" for c in cards)
            or any(s.row.group is not None for s in shards)):
        return [fn(s) for s in shards]

    def run_card(card):
        with torch.cuda.device(card):
            return {i: fn(s) for i, s in enumerate(shards) if s.device == card}

    done = {}
    with ThreadPoolExecutor(max_workers=len(cards)) as pool:
        for f in [pool.submit(run_card, c) for c in cards]:
            done.update(f.result())
    return [done[i] for i in range(len(shards))]


def row_gather(row: Row, parts: Sequence[torch.Tensor], devices=None) -> dict:
    """Every shard's partial of ``row``, in node order, on each device.

    ``parts`` are this process's shards' partials (``row.devices`` order),
    all of one shape and dtype; ``devices`` (default: this process's
    devices of the row) are where the whole list is wanted.  Returns
    ``{device: [partial of node 0, ..., of node n_node - 1]}``.  Within a
    process a partial is copied to each device (no copy where shards share
    one); across processes the row's processes exchange host copies of
    their partials' bytes in one gloo ``all_gather`` over the row's group,
    so every process receives the same bits and reduces them in the same
    order as one process would.
    """
    devices = dict.fromkeys(row.devices if devices is None else devices)
    if row.group is None:
        return {d: [p.to(d) for p in parts] for d in devices}
    import torch.distributed as dist

    shape, dtype = parts[0].shape, parts[0].dtype
    width = max(k for _, k in row.spans)
    local = torch.stack([p.detach().cpu() for p in parts]).reshape(len(parts), -1)
    local = local.view(torch.uint8)
    if len(parts) < width:
        local = torch.cat([local, local.new_zeros((width - len(parts), local.shape[1]))])
    out = [torch.empty_like(local) for _ in row.spans]
    dist.all_gather(out, local.contiguous(), group=row.group)
    full = torch.cat([o[:k] for o, (_, k) in zip(out, row.spans)])
    full = full.view(dtype).reshape(row.n_node, *shape)
    return {d: list(full.to(d).unbind(0)) for d in devices}


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


def all_gather_cat(local: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's tensor concatenated along ``dim`` in rank order (gloo
    ``all_gather``s of CPU copies); the sizes along ``dim`` may differ
    between processes, the other sizes and the dtype may not.  A bool tensor
    travels as uint8."""
    local = local.detach().cpu()
    if process_count() == 1:
        return local
    sizes = [int(c[0]) for c in _all_gather_ints([local.shape[dim]])]
    wire = local.to(torch.uint8) if local.dtype == torch.bool else local
    pad = list(wire.shape)
    pad[dim] = max(sizes) - wire.shape[dim]
    wire = torch.cat([wire, wire.new_zeros(pad)], dim=dim).contiguous()
    import torch.distributed as dist

    out = [torch.empty_like(wire) for _ in sizes]
    dist.all_gather(out, wire)
    full = torch.cat([o.narrow(dim, 0, k) for o, k in zip(out, sizes)], dim=dim)
    return full.to(torch.bool) if local.dtype == torch.bool else full


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's ``[k, ...]`` int64 rows in rank order, which
    is global trial-shard order where each process gives the rows it leads
    (``Row.leader``: a row's first shard lies on the lowest of its ranks)."""
    return all_gather_cat(torch.as_tensor(local, dtype=torch.int64))


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
