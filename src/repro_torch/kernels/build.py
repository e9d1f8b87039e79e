"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
Builds happen at first use, all sources in parallel (one ``nvcc`` each),
into ``build/repro_torch/`` at the repository root, which ``.gitignore``
lists.  A library's file name carries a hash of its sources and flags,
so an edited kernel is rebuilt and a stale one is never loaded.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing and returns ``cudaGetLastError()``; the
wrappers raise on a non-zero code (``check``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ragged_lora", "ragged_bwd", "fused_lora", "grouped",
           "flash_attention", "dequant")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the wall seconds per built source (0.0 when a
    current library was already there).  Each compiler's output (with
    ``-Xptxas -v``: registers, shared memory, spills) is kept beside its
    library as ``<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        try:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        except OSError:
            log.close()
            raise
        procs[name] = (proc, log, tmp, out)
    secs = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)       # atomic: a concurrent loader never
        #                            sees a half-written library
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return secs


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use).
    Threads that launch their first kernels at the same time (a
    controller's chunk pumps) wait on one lock, so each library is built
    and loaded once."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LIBS:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` counter, under a lock:
    the wrappers launch from several threads at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of *device* (the current one when it
    carries no index)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def require_vectors(tensors, *extents: int) -> None:
    """The LoRA kernels stage operands with 16-byte loads: every base
    pointer 16-byte aligned, every stride, width and extent a multiple of
    8 bf16 elements."""
    require(all(t.data_ptr() % 16 == 0 for t in tensors)
            and all(e % 8 == 0 for e in extents),
            "the LoRA kernels need 16-byte aligned operands and dims, "
            f"strides and rank widths that are multiples of 8 (got {extents})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
