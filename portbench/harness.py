"""What every traffic driver shares: the run's context, the measured
window, host spans, seeds, and the program's code and decoder options built
from a configuration."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch

from portbench.reference import threefry

ROOT = Path(__file__).resolve().parent
UNIT_KEYS = 4096


@dataclasses.dataclass
class Context:
    """One run: the cell's file, its configuration, the seed, the device
    and, for a control run, the program's storage type switched."""

    cell: dict
    config: dict
    seed: int
    device: torch.device
    storage: str  # the message storage the program runs with
    base: Path = ROOT  # where the cell's files lie

    def __post_init__(self):
        # the keys of the first units, made in set-up in one call, so that no
        # key is derived inside the window
        self._keys = threefry.fold_in(threefry.key(self.seed),
                                      torch.arange(UNIT_KEYS, dtype=torch.int64))

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def key(self, index: int) -> torch.Tensor:
        """The int64 ``[2]`` threefry key of unit ``index`` of this run."""
        if index < UNIT_KEYS:
            return self._keys[index]
        return threefry.fold_in(threefry.key(self.seed), index)

    def word(self, index: int) -> int:
        """A 32-bit word of unit ``index`` (a sweep pass's seed)."""
        return int(self.key(index)[1])


def now() -> float:
    return time.perf_counter()


class Window:
    """The measured window: it opens, counts units of work as they complete,
    and closes at the first completion ``seconds`` or more after it opened,
    so that a rate is whole units over all of their time.  A tracer's slice
    opens with it and ends after ``slice_s`` at a unit's completion."""

    def __init__(self, seconds: float, tracer=None):
        self.seconds, self.tracer = seconds, tracer
        self.t0 = self.t_end = None

    def open(self) -> float:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t0 = now()
        if self.tracer is not None:
            self.tracer.begin(self.t0)
        return self.t0

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    def unit_done(self, t: float) -> None:
        if self.tracer is not None:
            self.tracer.unit_done(t)
        if t - self.t0 >= self.seconds:
            self.t_end = t

    def close(self, t: float) -> None:
        self.t_end = t

    @property
    def length(self) -> float:
        return self.t_end - self.t0


@contextlib.contextmanager
def span(name: str, into: list):
    """A host span: a profiler range of ``name`` (seen in a traced run) and
    ``(start, end)`` appended to ``into``."""
    with torch.autograd.profiler.record_function(name):
        t = now()
        try:
            yield
        finally:
            into.append((t, now()))


def decode_options(ctx: Context, **schedule):
    """The program's ``DecodeOptions`` of the configuration's decoder."""
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions

    d = ctx.config["decoder"]
    return DecodeOptions(
        max_iterations=d["max_iterations"], clip_messages=d["clip_messages"],
        message_threshold=d["message_threshold"], algorithm=d["algorithm"],
        message_dtype=ctx.storage, **schedule)


def program_code(ctx: Context):
    """The program's code of the configuration (its own construction)."""
    from qkd_ldpc_tpu_torch.codes import load_code, make_qc_code

    spec = ctx.config["code"]
    if spec["kind"] == "qc":
        return make_qc_code(z=spec["z"], nb=spec["nb"], mb=spec["mb"], dv=spec["dv"],
                            seed=spec["seed"])
    return load_code(ctx.base / "configs" / spec["file"])


def reference_decoder(ctx: Context):
    """The reference decoder at the configuration's stated storage."""
    from portbench.reference.decode import Decoder

    d = ctx.config["decoder"]
    return Decoder(max_iterations=d["max_iterations"], threshold=d["message_threshold"],
                   clip=d["clip_messages"], storage=d["storage"])


def reference_graph(ctx: Context):
    from portbench.reference import codes

    return codes.on_device(codes.build(ctx.config["code"], ctx.base / "configs"), ctx.device)


def free_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader is given after the window."""

    ctx: Context
    units: list  # the driver's completed units of work, in order
    trace: object = None  # trace.TraceData of the slice, or None
    slice_end: float | None = None  # host clock at the slice's end

    def units_in_slice(self) -> list:
        if self.slice_end is None:
            return []
        return [u for u in self.units if u["t1"] <= self.slice_end]
