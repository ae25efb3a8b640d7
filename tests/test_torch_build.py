"""ops/_build.py: the library name follows the source, the headers it
includes and the flags, so an edited header can never load a stale
library.  Runs no compiler: `library_path` only hashes files."""

from pathlib import Path

import pytest

from madqp_tpu_torch.ops import _build
from madqp_tpu_torch.ops import pallas_chol as K1
from madqp_tpu_torch.ops import syrk as K8


@pytest.fixture
def kernel_dir(tmp_path):
    (tmp_path / "tile.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("constexpr int X = 1;\n")
    (tmp_path / "unused.cuh").write_text("constexpr int Y = 1;\n")
    source = tmp_path / "k.cu"
    source.write_text('#include <cuda_runtime.h>\n#include "tile.cuh"\n'
                      'int f() { return X; }\n')
    return source


def test_sources_follow_includes(kernel_dir):
    names = [p.name for p in _build.sources(kernel_dir)]
    assert names == ["k.cu", "tile.cuh", "inner.cuh"]


@pytest.mark.parametrize("edited,changes", [
    ("tile.cuh", True), ("inner.cuh", True), ("k.cu", True),
    ("unused.cuh", False),
])
def test_library_name_changes_with_included_header(kernel_dir, edited, changes):
    before = _build.library_path(kernel_dir)
    target = kernel_dir.parent / edited
    target.write_text(target.read_text() + "// edited\n")
    after = _build.library_path(kernel_dir)
    assert (after != before) is changes
    assert after.parent == _build.BUILD_DIR and after.name.startswith("libmadqp_k_")


@pytest.mark.parametrize("module", [K1, K8])
def test_kernels_include_the_tile_header(module):
    names = [p.name for p in _build.sources(module.SOURCE)]
    assert names == [Path(module.SOURCE).name, "syrk_tile.cuh"]


def test_flags_are_fixed_and_verbose():
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast" in f or f in ("-G", "-g") for f in _build.NVCC_FLAGS)


def test_build_log_is_empty_without_a_build(kernel_dir):
    assert _build.build_log(kernel_dir) == ""
