"""The traced run: ``torch.profiler`` started before set-up captures the
program's CUDA graphs (so the kernels inside their loop bodies are seen),
and read over one bounded steady slice of the window.

The slice begins when the window opens and ends at the first unit of work
completed ``slice_s`` later; the profiler stops there, so a long window
writes no long trace.  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench import arith

SLICE = "portbench.slice"
SPAN_PREFIX = "portbench."  # the benchmark's own ranges (a GPU-side copy of each is no operation)


@dataclasses.dataclass
class TraceData:
    """What the readers take from a trace, in seconds on one timeline."""

    lo: float  # the slice
    hi: float
    device: list  # (start, end, name) of every device operation
    host: list  # (start, end, name) of every host-side event

    def device_intervals(self):
        return [(s, e) for s, e, _ in self.device]

    def busy_s(self) -> float:
        return arith.busy(self.device_intervals(), self.lo, self.hi)

    def top_ops(self, n: int = 10):
        """The device operations that took most time in the slice."""
        by = {}
        for s, e, name in self.device:
            d = min(e, self.hi) - max(s, self.lo)
            if d > 0:
                by[name] = by.get(name, 0.0) + d
        return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest idle stretches of the slice, each named by the
        innermost host event open at its middle."""
        host = sorted(self.host)
        out = []
        for s, e in arith.gaps(self.device_intervals(), self.lo, self.hi):
            mid = (s + e) / 2
            name, start = "host: outside any traced call", None
            for hs, he, hn in host:
                if hs > mid:
                    break
                if he >= mid and (start is None or hs >= start):
                    name, start = hn, hs
            out.append([name, e - s])
        return sorted(out, key=lambda r: -r[1])[:n]


class Tracer:
    """One profiler session: :meth:`start` before set-up, :meth:`begin`
    when the window opens, :meth:`unit_done` after each unit of work (it ends
    the slice once ``slice_s`` has passed), :meth:`data` after the window."""

    def __init__(self, slice_s: float):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.slice_s = slice_s
        self.t0 = None
        self.marker = None
        self.running = False
        self.host_end = None  # host clock at the slice's end

    def start(self) -> None:
        self.prof.__enter__()
        self.running = True

    def begin(self, now: float) -> None:
        self.t0 = now
        self.marker = torch.autograd.profiler.record_function(SLICE)
        self.marker.__enter__()

    def unit_done(self, now: float) -> None:
        if self.running and self.t0 is not None and now - self.t0 >= self.slice_s:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.marker is not None:
            self.marker.__exit__(None, None, None)
        self.host_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.running = False

    def data(self) -> TraceData | None:
        """The slice's events, or None where the trace holds no slice.  Read
        from the profiler's raw events (no event tree is built)."""
        self.stop()
        from torch.autograd import DeviceType

        lo = hi = None
        device, host = [], []
        gc_was = gc.isenabled()
        gc.disable()
        try:
            for ev in self.prof.profiler.kineto_results.events():
                name = ev.name()
                s = ev.start_ns() * 1e-9
                e = s + ev.duration_ns() * 1e-9
                if name == SLICE and ev.device_type() == DeviceType.CPU:
                    lo, hi = s, e
                elif ev.device_type() == DeviceType.CUDA:
                    if not (ev.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                        device.append((s, e, name))
                else:
                    host.append((s, e, name))
        finally:
            if gc_was:
                gc.enable()
        if lo is None:
            return None
        return TraceData(lo=lo, hi=hi, device=device, host=host)
