"""Build and load the port's CUDA kernels; count their launches; build the
native C++ ingest library.

The sources in ``csrc/`` have a plain C interface (raw pointers, sizes,
the stream), so each compiles in seconds with ``nvcc`` alone and is
loaded with ``ctypes`` — no PyTorch headers.  Libraries are built at
first use into ``_build/`` beside this file (ignored by git), each under a
name that carries the hash of its source, the shared header, the flags
and its defines, all ``nvcc`` processes started together.  A build or
launch failure raises; nothing falls back to the plain PyTorch versions,
which run only for tensors that lie on the CPU (or on request,
``backend="xla"``).

The native ingest library (alist loader and graph builder,
``native/qkd_ldpc_native.cpp`` at the repository root, a plain C interface
shared with the JAX package's sources) is built the same way with ``g++``
into ``_build/`` under a name that carries the hash of its source and flags
(:func:`build_native`); ``codes/_native.py`` loads it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).parent / "csrc"
_OUT = Path(__file__).parent / "_build"

# No --use_fast_math, and no contraction of a*b+c into fma: the kernels'
# float arithmetic must round where the plain versions round.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# library name -> (source file, extra defines).  The two decoder sources are
# built once per message storage type so their builds run side by side.
STORAGE_DEFINES = {"float32": "-DSTORAGE=0", "bfloat16": "-DSTORAGE=1", "int8": "-DSTORAGE=2"}
LIBRARIES = {
    "threefry_words": ("threefry_words.cu", ()),
    "kth_smallest": ("kth_smallest.cu", ()),
    "device_loop": ("device_loop.cu", ()),
    "continuation": ("continuation.cu", ()),
    **{
        f"{stem}_{storage}": (f"{stem}.cu", (define,))
        for stem in ("check_update", "layered_sweep")
        for storage, define in STORAGE_DEFINES.items()
    },
}

NATIVE_SOURCE = Path(__file__).resolve().parent.parent / "native" / "qkd_ldpc_native.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_loaded: dict[tuple[str, str], object] = {}
_launches: dict[str, int] = {}
# Launches that a CUDA graph makes on the card without passing a wrapper:
# (kernel names, an int64 device counter of how often they ran).  A WHILE
# body's bookkeeping kernel adds one to its counter on every pass.
_device_counters: list[tuple[tuple[str, ...], torch.Tensor]] = []
# Per host thread: the lists that launches are recorded into instead of
# being counted (a capture's or a warm-up's), innermost last.
_recording = threading.local()
# Shards of a mesh on distinct cards launch from one host thread each: the
# first build (its temporary files are named by the process alone), the
# table of loaded functions and the launch counts are changed under this lock.
_lock = threading.RLock()
build_seconds = 0.0  # wall time of the nvcc runs this process started


def use_kernel(backend: str, device: torch.device) -> bool:
    """The one backend rule of the port: ``"xla"`` = plain PyTorch,
    ``"pallas"`` = the hand-written kernel (raises for a CPU tensor),
    ``"auto"`` = the kernel for a CUDA tensor, plain for a CPU tensor.
    The two names are the JAX package's, kept so one config runs on both."""
    if backend == "xla":
        return False
    if backend == "pallas":
        if device.type != "cuda":
            raise ValueError(
                "backend='pallas' selects the CUDA kernel and needs a CUDA "
                f"tensor, got one on {device}"
            )
        return True
    if backend == "auto":
        return device.type == "cuda"
    raise ValueError(f"Unknown backend {backend!r}")


def nvcc_path() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        exe = str(cand)
    return exe


def library_path(name: str) -> Path:
    """Where the built library ``name`` lies: the file name carries the hash
    of everything the build depends on, so a changed source, header, flag or
    define is another file and never a stale one."""
    src, defines = LIBRARIES[name]
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in [_CSRC / src, *sorted(_CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _OUT / f"lib{Path(src).stem}.{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` (with ``ptxas -v``) said when it built library ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def build_all() -> None:
    """Compile every missing library, all nvcc processes in parallel."""
    with _lock:
        _build_missing()


def _build_missing() -> None:
    global build_seconds
    todo = [n for n in LIBRARIES if not library_path(n).exists()]
    if not todo:
        return
    _OUT.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        src, defines = LIBRARIES[name]
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(_CSRC / src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def function(library: str, name: str, argtypes: list):
    """The C function ``name`` of ``library`` with its ctypes signature set
    (pointers and the stream as ``c_void_p``, or ctypes would cut them to 32
    bits).  The library is built first if it is not there yet; every kernel
    entry returns ``cudaGetLastError()`` as an int."""
    fn = _loaded.get((library, name))
    if fn is None:
        with _lock:
            fn = _loaded.get((library, name))
            if fn is None:
                if library not in LIBRARIES:
                    raise KeyError(library)
                build_all()
                lib = ctypes.CDLL(str(library_path(library)))
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _loaded[(library, name)] = fn
    return fn


def constant(library: str, name: str) -> int:
    """The value of the argument-free C function ``name`` of ``library`` (a
    width compiled into it), asked once."""
    key = (library, name + "()")
    if key not in _loaded:
        with _lock:
            if key not in _loaded:
                _loaded[key] = function(library, name, [])()
    return _loaded[key]


def check_launch(kernel: str, err: int) -> None:
    """Raise on a refused launch (``cudaGetLastError`` != 0); count the
    launch otherwise, or list it where :func:`recording` is open.  This and
    a graph's replay (:func:`count_replay`) are the only places the counts
    change."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: error {err}")
    stack = getattr(_recording, "stack", None)
    if stack:
        stack[-1].append(kernel)
        return
    with _lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


@contextlib.contextmanager
def recording():
    """Inside, this thread's launches are listed in the yielded list and not
    counted: a graph capture lists the kernel nodes it records (each counted
    at every replay), a warm-up its throwaway launches."""
    stack = getattr(_recording, "stack", None)
    if stack is None:
        stack = _recording.stack = []
    names: list[str] = []
    stack.append(names)
    try:
        yield names
    finally:
        stack.pop()


def count_replay(names) -> None:
    """One replay of a graph whose outer kernel nodes are ``names``."""
    with _lock:
        for kernel in names:
            _launches[kernel] = _launches.get(kernel, 0) + 1


def add_device_counter(names, counter: torch.Tensor) -> None:
    """Count ``names`` once for every unit the int64 device scalar
    ``counter`` holds: the passes of a WHILE body, which the card runs
    without the host."""
    with _lock:
        _device_counters.append((tuple(names), counter))


def fold_device_counters(counters) -> None:
    """Stop reading ``counters`` (device counters of a graph about to be
    dropped, its replays finished): what they hold joins the host's
    counts."""
    with _lock:
        mine = [e for e in _device_counters if any(e[1] is c for c in counters)]
        _device_counters[:] = [e for e in _device_counters if not any(e is m for m in mine)]
        for names, counter in mine:
            passes = int(counter)
            for kernel in names:
                if passes:
                    _launches[kernel] = _launches.get(kernel, 0) + passes


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset.  Reading the graphs'
    device counters synchronises with the card (one read a device)."""
    with _lock:
        counts = dict(_launches)
        counters = list(_device_counters)
    by_device: dict = {}
    for names, counter in counters:
        by_device.setdefault(counter.device, []).append((names, counter))
    for entries in by_device.values():
        passes = torch.stack([c for _, c in entries]).tolist()
        for (names, _), n in zip(entries, passes):
            for kernel in names:
                if n:
                    counts[kernel] = counts.get(kernel, 0) + n
    return counts


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()
        for _, counter in _device_counters:
            counter.zero_()


def native_library_path() -> Path:
    """Where the built native ingest library lies (hash of source and flags)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(NATIVE_SOURCE.read_bytes())
    return _OUT / f"libqkd_ldpc_native.{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile the native ingest library with ``g++`` if it is missing and
    return its path; raises when the source or the compiler is missing or
    the build fails."""
    with _lock:
        return _build_native()


def _build_native() -> Path:
    out = native_library_path()
    if out.exists():
        return out
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {NATIVE_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
