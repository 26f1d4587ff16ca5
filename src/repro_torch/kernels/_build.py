"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points (device pointers and
sizes in, ``cudaGetLastError()`` out).  On first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``build/``
next to this file — named by a digest of the source and of the shared
``csrc/*.cuh`` headers, so an edited kernel is never served from a stale
library — and loaded with ``ctypes``.
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

class KernelError(RuntimeError):
    """A CUDA kernel of this package did not build or did not launch.

    Its own type, so that callers that recover from other errors (the
    serving tier's retry and degradation ladder) let it through: a query
    is never answered by a plain version on the card in a kernel's
    place."""


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise KernelError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _lib_path(name: str) -> Path:
    # the shared headers count too: a source that includes one is rebuilt
    # when it changes
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
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
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
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
    """The C entry points of one ``csrc`` source, with one launch counter.

    ``launches`` counts the calls of ``launch`` that reached the card: the
    one place a kernel of this package is launched, so a run can show
    which kernels its path went through.  A source may export further
    entry points (``entries``: symbol -> argtypes); they count as launches
    of the same kernel, and ``entry_launches`` counts each entry apart."""

    def __init__(self, source: str, symbol: str, argtypes: list,
                 entries: dict | None = None):
        self.source = source
        self.symbol = symbol
        self.entries = {symbol: argtypes, **(entries or {})}
        self._fns = {}
        self.reset()

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.entries, 0)

    def _bind(self, symbol: str):
        if symbol not in self._fns:
            build_all([self.source])
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            fn = getattr(lib, symbol)
            fn.argtypes = [*self.entries[symbol], PTR]   # + the stream
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def launch(self, *args, symbol: str | None = None) -> None:
        """Launch entry ``symbol`` (the first by default) on PyTorch's
        current stream; raise if CUDA refused it."""
        import torch
        symbol = symbol or self.symbol
        fn = self._bind(symbol)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise KernelError(f"CUDA kernel {symbol} failed to launch "
                               f"(cudaError {rc})")
        self.launches += 1
        self.entry_launches[symbol] += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def upload(words, device):
    """int32 ``words`` (a NumPy array or sequence) as a tensor on
    ``device``.  On CUDA through pinned host memory, with the copy queued
    on the stream: the host does not wait for the device, as a copy from
    pageable memory makes it wait."""
    import numpy as np
    import torch
    host = torch.from_numpy(np.ascontiguousarray(words, dtype=np.int32))
    device = torch.device(device)
    if device.type != "cuda" or host.numel() == 0:
        return host.to(device)
    pinned = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


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
