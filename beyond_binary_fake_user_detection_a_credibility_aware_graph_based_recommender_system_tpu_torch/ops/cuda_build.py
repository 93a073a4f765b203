"""Build, load and launch a hand-written CUDA kernel with a plain C interface.

Each kernel source under ``csrc/`` exports one ``extern "C"`` function that
launches its kernel on the given stream and returns the ``cudaError_t`` of
the launch.  :class:`CudaKernel` compiles the source with ``nvcc`` for
``sm_90a`` at first use into ``build/torch_kernels/`` (named by the hash of
the source and the flags, so an edited source is rebuilt), loads it with
``ctypes`` and counts its launches in ``launches``; two objects of one
source (``name`` tells them apart) share the library and count apart.
Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels under csrc/")
    return str(cand)


class CudaKernel:
    """One compiled source, its C entry point ``symbol`` (returning an
    ``int`` error code) with ``argtypes``, and its launch counter, known by
    ``name`` (the symbol unless given)."""

    def __init__(self, source: Path, symbol: str, argtypes: Sequence,
                 name: str = ""):
        self.source = source
        self.symbol = symbol
        self.name = name or symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}_{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless this source's library already exists."""
        lib = self.library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(self.source)], capture_output=True,
                              text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, lib)
        return lib

    def _function(self):
        with self._lock:
            if self._fn is None:
                fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def _launch(self, *args) -> None:
        """Call the entry point; raise on a refused launch, else count it."""
        rc = self._function()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1
