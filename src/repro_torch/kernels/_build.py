"""Build the port's CUDA sources into plain C libraries and load them.

Each kernel lives in one file, ``csrc/<name>.cu``, that includes no PyTorch
header (only the shared ``csrc/*.cuh``) and exports a plain C interface.
:func:`load` compiles it with ``nvcc`` for ``sm_90a`` into
``build/torch_ext/`` at the repository root (once per process, and only when
no library built from the same sources and flags is there yet) and opens it
with ``ctypes``.  :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them, so a caller that
needs every kernel pays for the slowest build, not the sum.  Nothing is
compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils import cpp_extension

    return os.path.join(cpp_extension.CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to: the file name carries a digest
    of the source, the shared headers and the flags, so an edited source or
    header is rebuilt."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path]":
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
         str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)              # atomic: a concurrent process sees all or nothing


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every named source that is not built yet, all ``nvcc`` runs at
    once, then load each.  Returns the wall seconds until each was loaded."""
    names = list(names)
    t0 = time.monotonic()
    with _lock:
        started = {n: _start(n) for n in names
                   if n not in _libs and not library_path(n).exists()}
        errors = []
        for n, job in started.items():        # wait for every nvcc, even after a failure
            try:
                _finish(n, *job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    seconds = {}
    for n in names:
        load(n)
        seconds[n] = time.monotonic() - t0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                _finish(name, *_start(name))
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and no later synchronisation reports it)."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.repro_cuda_error_string(rc).decode()}")


def refuse_autograd(what: str, plain: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record a launch of ``what``: a kernel
    launched through ``ctypes`` returns a tensor with no ``grad_fn``, so
    the graph would be cut without an error and every parameter before the
    call would get no gradient.  ``plain`` names the plain version, which
    autograd can differentiate."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward; call it under torch.no_grad(), or "
            f"use {plain} where gradients are needed")
