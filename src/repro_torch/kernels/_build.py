"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points (device pointers and
sizes in, ``cudaGetLastError()`` out).  On first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/``
next to this file — named by a digest of the source, so an edited kernel
is never served from a stale library — and loaded with ``ctypes``.
Nothing here runs at import time: CPU-only installs import the package
and never reach ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them, which is how ``chip_smoke.py`` and the first CUDA call pay the
build cost.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"{name}-{digest[:12]}.so"


def _start(name: str):
    """Popen of the nvcc build of one source, or None when it is built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: concurrent builders never see
                                # a half-written library


def build_all(names=None) -> None:
    """Compile every kernel source (or ``names``) in parallel."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        _finish(n, job)


class CudaKernel:
    """One C entry point of one ``csrc`` source, with a launch counter.

    ``launches`` counts the calls of ``launch`` that reached the card: the
    one place a kernel of this package is launched, so a run can show
    which kernels its path went through."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            build_all([self.source])
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, PTR]      # + the stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Launch on PyTorch's current stream; raise if CUDA refused it."""
        import torch
        fn = self._bind()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed to launch "
                               f"(cudaError {rc})")
        self.launches += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_int32(*tensors) -> None:
    """The kernels take contiguous int32 tensors on one CUDA device."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
