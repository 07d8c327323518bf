"""Build, load and call the port's native text pipeline.

``cosdata_tpu_torch/csrc/text_pipeline.cpp`` does the whole BM25 text path
of one text in one call: tokenize, lowercase, stopword filter, Snowball
stem, xxhash32 term id and BM25 tf. It gives what the plain Python path
(``text/processing.py``'s ``*_plain`` functions) gives, bit for bit, on
every input.

Its Unicode tables (the ``\\w`` set, the per-code-point ``str.lower()``
mapping and the Final_Sigma context classes) are generated here from the
running interpreter, so they cannot drift from the plain path; the
library's file name carries ``unicodedata.unidata_version``, so a library
built under one Python is never loaded under another.

``g++`` builds it at first use, never at import, into
``cosdata_tpu_torch/build/`` (again when the source or this file is newer
than the library), through a per-process temporary file renamed into
place; threads of one process wait for one build. A build or load failure
raises. The library runs on the host, whatever device the index is on.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
import unicodedata
from pathlib import Path

from cosdata_tpu_torch.ops.kernels.nvcc import BUILD_DIR, needs_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "text_pipeline.cpp"
LIBRARY_PATH = BUILD_DIR / f"libtext_pipeline_u{unicodedata.unidata_version}.so"
#: no -ffast-math, and no fused multiply-add: the tf must be Python's double
#: arithmetic bit for bit on x86-64 and on aarch64
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-ffp-contract=off", "-shared"]

_SIGMA = "Σ"


def _ranges(cps: list[int]) -> list[tuple[int, int]]:
    """Sorted code points as closed [lo, hi] ranges."""
    out: list[list[int]] = []
    for c in cps:
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [(lo, hi) for lo, hi in out]


def unicode_tables() -> str:
    """The C++ header of the interpreter's tables, over the word characters
    (``str.isalnum()`` or ``"_"``, what ``re``'s ``\\w`` matches):

    - ``TP_WORD``: the word characters, as ranges;
    - ``TP_LOWER`` / ``TP_LOWER_MULTI``: each word character whose
      ``str.lower()`` differs from it, to one code point or to several
      (``"İ"`` lowers to ``"i̇"``); U+03A3 is left to the Final_Sigma rule;
    - ``TP_IGNORABLE``: word characters that are case-ignorable, and
      ``TP_CASED``: the other word characters that are cased. Both are read
      off ``str.lower()`` itself: ``("AΣ" + c).lower()`` keeps a final
      sigma unless c is cased and not ignorable, and ``("AΣ" + c +
      "A").lower()`` gives a final sigma only when c is neither.

    Raises where the interpreter breaks what the library assumes: that
    lowering a lowered token changes nothing, and that only U+03A3 lowers
    by its context."""
    word = [c for c in range(0x110000) if chr(c).isalnum() or c == 0x5F]
    lower, multi, ignorable, cased = [], [], [], []
    for c in word:
        ch = chr(c)
        low = ch.lower()
        if _SIGMA in low or low.lower() != low or len(low) > 3:
            raise RuntimeError(f"str.lower() of U+{c:04X} is {low!r}: the text library cannot mirror it")
        if c != 0x3A3 and low != ch:
            if len(low) == 1:
                lower.append((c, ord(low)))
            else:
                multi.append((c, len(low), *(ord(x) for x in low), *([0] * (3 - len(low)))))
        open_end = ("A" + _SIGMA + ch).lower()[1]
        closed = ("A" + _SIGMA + ch + "A").lower()[1]
        if open_end == "σ" and closed == "σ":
            cased.append(c)
        elif open_end == "ς" and closed == "σ":
            ignorable.append(c)
        elif not (open_end == "ς" and closed == "ς"):
            raise RuntimeError(f"U+{c:04X} gives no Final_Sigma class ({open_end!r}, {closed!r})")
    if ("A" + _SIGMA).lower() != "aς" or _SIGMA.lower() != "σ":
        raise RuntimeError("str.lower() has no Final_Sigma rule")

    def table(name: str, rows: list[tuple], width: int) -> str:
        rows = rows or [(0x110000,) * width]  # a row no code point reaches
        body = ",\n".join("  {" + ", ".join(str(v) for v in r) + "}" for r in rows)
        return f"static const uint32_t {name}[{len(rows)}][{width}] = {{\n{body}\n}};\n"

    return (
        f"// generated from Python's str methods (Unicode {unicodedata.unidata_version})\n"
        "#define TP_TABLES 1\n#include <cstdint>\n"
        + table("TP_WORD", _ranges(word), 2)
        + table("TP_LOWER", lower, 2)
        + table("TP_LOWER_MULTI", multi, 5)
        + table("TP_IGNORABLE", _ranges(ignorable), 2)
        + table("TP_CASED", _ranges(cased), 2)
    )


class _Out(ctypes.Structure):
    """``TpOut`` of ``text_pipeline.cpp``: one thread's buffers and state."""

    _fields_ = [
        ("ids", ctypes.POINTER(ctypes.c_uint32)),
        ("tfs", ctypes.POINTER(ctypes.c_double)),
        ("cap", ctypes.c_int64),
        ("doc_len", ctypes.c_int64),
        ("state", ctypes.c_void_p),
    ]


class _ThreadOut:
    """One thread's output buffers and pipeline state (its stem cache),
    freed with the thread's ``threading.local``."""

    def __init__(self, lib: ctypes.CDLL, cap: int):
        self._free = lib.tp_state_free
        self.out = _Out(state=lib.tp_state_new())
        self.addr = ctypes.addressof(self.out)  # passed as a plain address: the cheapest argument
        self.grow(cap)

    def grow(self, cap: int) -> None:
        self.ids = (ctypes.c_uint32 * cap)()
        self.tfs = (ctypes.c_double * cap)()
        self.out.ids, self.out.tfs, self.out.cap = self.ids, self.tfs, cap

    def __del__(self):
        self._free(self.out.state)


class TextLibrary:
    """The text pipeline's shared library: built, loaded and bound once."""

    def __init__(self, source: Path = SOURCE, library: Path = LIBRARY_PATH):
        self.source = source
        self.library = library
        self._lib: ctypes.CDLL | None = None
        self._load_lock = threading.Lock()
        self._tls = threading.local()

    def inputs(self) -> list[Path]:
        """The files the library is built from: its source and its table generator."""
        return [self.source, Path(__file__).resolve()]

    def build(self) -> float:
        """Generate the tables and compile the library; returns the seconds taken."""
        t0 = time.perf_counter()
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the text pipeline library needs a C++ compiler")
        self.library.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        header = self.library.with_suffix(f".{os.getpid()}.h")
        header.write_text(unicode_tables())
        try:
            cmd = [cxx, *CXX_FLAGS, "-include", str(header), "-o", str(tmp), str(self.source)]
            res = subprocess.run(cmd, capture_output=True, text=True)
        finally:
            header.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {self.source.name} ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, self.library)
        return time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._load_lock:
            if self._lib is None:
                if needs_build(self.library, self.inputs()):
                    self.build()
                lib = ctypes.CDLL(str(self.library))
                lib.tp_state_new.argtypes = []
                lib.tp_state_new.restype = ctypes.c_void_p
                lib.tp_state_free.argtypes = [ctypes.c_void_p]
                lib.tp_state_free.restype = None
                lib.tp_text_terms.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ]
                lib.tp_text_terms.restype = ctypes.c_int64
                self._lib = lib
        return self._lib

    def terms(self, text: str, max_token_len: int, want_terms: bool, avg_doc_len: float = 1.0,
              k1: float = 1.2, b: float = 0.75) -> tuple[int, list[int], list[float]]:
        """(doc_len, term ids, tfs) of ``text``; the terms are empty unless ``want_terms``."""
        lib = self.load()
        data = text.encode("utf-8", "surrogatepass")
        # tokens are separated by at least one code point: a text of n code
        # points holds at most ceil(n / 2) tokens, so every term fits
        need = (len(text) + 1) // 2
        tout = getattr(self._tls, "out", None)
        if tout is None:
            tout = self._tls.out = _ThreadOut(lib, max(need, 1024))
        elif tout.out.cap < need:
            tout.grow(max(need, 2 * tout.out.cap))
        n = lib.tp_text_terms(tout.addr, data, len(data), max_token_len, want_terms, avg_doc_len, k1, b)
        if n < 0:
            raise ZeroDivisionError("float division by zero")
        return tout.out.doc_len, tout.ids[:n], tout.tfs[:n]


#: the library every caller of ``text/processing.py`` shares
LIBRARY = TextLibrary()
