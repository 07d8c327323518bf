"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``cosdata_tpu_torch/csrc/`` with a
plain C interface: one or more entry points ``<name>_<entry>`` (each
returns a ``cudaError_t``; most kernels have only ``<name>_launch``) and
``<name>_error_string``; the ``.cuh`` headers beside it are shared.
``nvcc`` compiles it for ``sm_90a`` into
``cosdata_tpu_torch/build/lib<name>.so`` at first use (or again when the
source or any header is newer), and ctypes loads it. Nothing is built at
import.
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


def needs_build(library: Path, sources: list[Path]) -> bool:
    """True when ``library`` is missing or older than any of ``sources``."""
    if not library.exists():
        return True
    built = library.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources)


class CudaLibrary:
    """One kernel source, its shared library and its entry points.

    ``entries`` maps each entry point's suffix (``"launch"`` for
    ``<name>_launch``) to its ctypes argument types. ``source`` and
    ``library`` default to ``csrc/<name>.cu`` and ``build/lib<name>.so``; a
    copy of the sources elsewhere builds into a library beside it."""

    def __init__(self, name: str, entries: dict[str, list], source: Path | None = None,
                 library: Path | None = None):
        self.name = name
        self.entries = entries
        self.source = source or _PKG / "csrc" / f"{name}.cu"
        self.library = library or BUILD_DIR / f"lib{name}.so"
        self._lib: ctypes.CDLL | None = None
        #: serving threads may reach the first launch together: one builds
        #: and loads, the others wait (the temp file name is per process)
        self._load_lock = threading.Lock()

    def inputs(self) -> list[Path]:
        """The files the library is built from: its source and every shared header."""
        return [self.source, *sorted(self.source.parent.glob("*.cuh"))]

    def build(self) -> str:
        """Compile the kernel from its source; returns nvcc's output."""
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: the {self.name} kernel needs the CUDA toolkit")
        self.library.parent.mkdir(parents=True, exist_ok=True)
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
                if needs_build(self.library, self.inputs()):
                    self.build()
                lib = ctypes.CDLL(str(self.library))
                for entry, argtypes in self.entries.items():
                    fn = getattr(lib, f"{self.name}_{entry}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                err_string = getattr(lib, f"{self.name}_error_string")
                err_string.argtypes = [ctypes.c_int]
                err_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def launch(self, *args, entry: str = "launch") -> None:
        """Call ``<name>_<entry>`` and raise if the launch was refused."""
        lib = self._load()
        err = getattr(lib, f"{self.name}_{entry}")(*args)
        if err:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name}_{entry} failed: {msg}")
