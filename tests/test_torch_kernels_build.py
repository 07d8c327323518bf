"""The kernel build helper's staleness rule (ops/kernels/nvcc.py), on
temporary files and without nvcc: a library is rebuilt when it is missing
or older than its ``.cu`` source or any shared ``.cuh`` header."""

import os
import shutil
from pathlib import Path

import pytest

from cosdata_tpu_torch.ops.kernels import nvcc, subbyte_scan, u8_scan


def _touch(path: Path, mtime: float) -> Path:
    path.write_text(path.name)
    os.utime(path, (mtime, mtime))
    return path


@pytest.fixture
def files(tmp_path):
    src = _touch(tmp_path / "k.cu", 1000.0)
    header = _touch(tmp_path / "shared.cuh", 1000.0)
    return tmp_path / "libk.so", src, header


def test_missing_library_is_built(files):
    lib, src, header = files
    assert nvcc.needs_build(lib, [src, header])


def test_library_newer_than_every_input_is_kept(files):
    lib, src, header = files
    _touch(lib, 2000.0)
    assert not nvcc.needs_build(lib, [src, header])
    _touch(lib, 1000.0)  # as old as its inputs: kept, as before headers counted
    assert not nvcc.needs_build(lib, [src, header])


@pytest.mark.parametrize("newer", ["source", "header"])
def test_newer_source_or_header_rebuilds(files, newer):
    lib, src, header = files
    _touch(lib, 2000.0)
    _touch(src if newer == "source" else header, 3000.0)
    assert nvcc.needs_build(lib, [src, header])


@pytest.mark.parametrize("library", [u8_scan.LIBRARY, subbyte_scan.LIBRARY], ids=lambda lib: lib.name)
def test_kernels_count_the_shared_header(library):
    """Both kernels include csrc/hopper_mma.cuh, and their inputs list it."""
    inputs = library.inputs()
    assert inputs[0] == library.source and library.source.exists()
    header = library.source.parent / "hopper_mma.cuh"
    assert header in inputs[1:]
    assert '#include "hopper_mma.cuh"' in library.source.read_text()


def test_library_built_from_a_copy_of_the_sources(tmp_path):
    """A copy of csrc (as the kernel-variants tool makes) builds into a
    library beside it, and counts the copy's headers, not the package's."""
    src = tmp_path / "csrc"
    shutil.copytree(subbyte_scan.LIBRARY.source.parent, src)
    lib = nvcc.CudaLibrary("subbyte_code_scores", subbyte_scan.LIBRARY.entries,
                           source=src / "subbyte_code_scores.cu", library=tmp_path / "libv.so")
    assert lib.inputs()[0] == src / "subbyte_code_scores.cu"
    assert src / "hopper_mma.cuh" in lib.inputs()[1:]
    assert all(path.parent == src for path in lib.inputs())
    assert nvcc.needs_build(lib.library, lib.inputs())


@pytest.mark.parametrize("library", [u8_scan.LIBRARY, subbyte_scan.LIBRARY], ids=lambda lib: lib.name)
def test_every_entry_point_is_in_the_source(library):
    """Each entry point the wrapper binds is an extern "C" function of the
    source, with as many parameters as the wrapper passes."""
    text = library.source.read_text()
    for entry, argtypes in library.entries.items():
        head = f'extern "C" int {library.name}_{entry}('
        assert head in text, head
        params = text[text.index(head) + len(head) :].split(")", 1)[0]
        assert len(params.split(",")) == len(argtypes), entry
