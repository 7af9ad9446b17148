"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so <name>.cu

Every kernel builds with these same flags: K1's grid-wide barrier
(``cooperative_groups`` ``grid.sync()`` under a cooperative launch) needs
no ``-rdc``.

The library lands in ``build/torch_kernels/`` beside the package (the file
name carries a hash of the source, so an edited source rebuilds), at the
first call that needs it.  Nothing here runs at import time.

`Entry` is the lean launch path of a C entry point: resolved and bound
once, then each call passes the pointers, the sizes and the current stream
of the tensors' device, and raises on a nonzero return.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / spill report) of each build in this process
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from torch's CUDA_HOME (which reads the
    CUDA_HOME / CUDA_PATH variables and falls back to /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name: str, src: Path | None = None) -> ctypes.CDLL:
    """Compile csrc/<name>.cu, or the source at `src`, once (cached by
    content hash) into lib<name> and load it."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: concurrent builds
        # (several test workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
        build_logs[name] = proc.stderr
    _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]


class Entry:
    """The C function `symbol` of csrc/<lib>.cu, whose last parameter is a
    cudaStream_t and which returns cudaGetLastError() after its launches.
    Built, resolved and given its argtypes (those before the stream) at the
    first call; `entry(device, *args)` then launches on the current stream
    of `device`, entering that device only when it is not the current one,
    and raises RuntimeError on a nonzero return."""

    def __init__(self, lib: str, symbol: str, argtypes):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None

    def _bind(self):
        fn = getattr(load(self.lib), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._fn or self._bind()
        idx = device.index
        if idx == torch._C._cuda_getDevice():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        else:
            with torch.cuda.device(idx):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {rc}")
