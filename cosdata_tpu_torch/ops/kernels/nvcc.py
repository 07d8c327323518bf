"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``cosdata_tpu_torch/csrc/`` with a
plain C interface: ``<name>_launch`` (returns a ``cudaError_t``) and
``<name>_error_string``. ``nvcc`` compiles it for ``sm_90a`` into
``cosdata_tpu_torch/build/lib<name>.so`` at first use (or again when the
source is newer), and ctypes loads it. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xptxas", "-v"]


class CudaLibrary:
    """One kernel source, its shared library and its launch function."""

    def __init__(self, name: str, launch_argtypes: list):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.library = BUILD_DIR / f"lib{name}.so"
        self._argtypes = launch_argtypes
        self._lib: ctypes.CDLL | None = None
        #: serving threads may reach the first launch together: one builds
        #: and loads, the others wait (the temp file name is per process)
        self._load_lock = threading.Lock()

    def build(self) -> str:
        """Compile the kernel from the checkout's source; returns nvcc's output."""
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: the {self.name} kernel needs the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, self.library)
        return res.stdout + res.stderr

    def _load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._load_lock:
            if self._lib is None:
                if not self.library.exists() or self.library.stat().st_mtime < self.source.stat().st_mtime:
                    self.build()
                lib = ctypes.CDLL(str(self.library))
                launch = getattr(lib, f"{self.name}_launch")
                launch.argtypes = self._argtypes
                launch.restype = ctypes.c_int
                err_string = getattr(lib, f"{self.name}_error_string")
                err_string.argtypes = [ctypes.c_int]
                err_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def launch(self, *args) -> None:
        """Call ``<name>_launch`` and raise if the launch was refused."""
        lib = self._load()
        err = getattr(lib, f"{self.name}_launch")(*args)
        if err:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg}")
