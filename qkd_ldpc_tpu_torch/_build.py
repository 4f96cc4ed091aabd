"""Build and load the port's CUDA kernels; count their launches.

The sources in ``csrc/`` have a plain C interface (raw pointers, sizes,
the stream), so each compiles in seconds with ``nvcc`` alone and is
loaded with ``ctypes`` — no PyTorch headers.  Libraries are built at
first use into ``_build/<hash of sources and flags>/`` beside this file
(ignored by git), all ``nvcc`` processes started together.  A build or
launch failure raises; nothing falls back to the plain PyTorch versions,
which run only for tensors that lie on the CPU (or on request,
``backend="xla"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    **{
        f"{stem}_{storage}": (f"{stem}.cu", (define,))
        for stem in ("check_update", "layered_sweep")
        for storage, define in STORAGE_DEFINES.items()
    },
}

_loaded: dict[tuple[str, str], object] = {}
_launches: dict[str, int] = {}
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


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(sorted(LIBRARIES.items())).encode())
    return _OUT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library, all nvcc processes in parallel."""
    global build_seconds
    out = build_dir()
    todo = [n for n in LIBRARIES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        src, defines = LIBRARIES[name]
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(_CSRC / src)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def function(library: str, name: str, argtypes: list):
    """The C function ``name`` of ``library`` with its ctypes signature set
    (pointers and the stream as ``c_void_p``, or ctypes would cut them to 32
    bits).  The library is built first if it is not there yet; every kernel
    entry returns ``cudaGetLastError()`` as an int."""
    fn = _loaded.get((library, name))
    if fn is None:
        if library not in LIBRARIES:
            raise KeyError(library)
        lib = ctypes.CDLL(str(build_all() / f"lib{library}.so"))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[(library, name)] = fn
    return fn


def check_launch(kernel: str, err: int) -> None:
    """Raise on a refused launch (``cudaGetLastError`` != 0); count the
    launch otherwise.  This is the only place the counts change."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: error {err}")
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()
