"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` file has a plain C interface and is compiled on its own
with `nvcc` into a shared library under `madqp_tpu_torch/_build/`, at first
use, and loaded with ctypes.  The library's name carries a hash of the
source, of every `csrc/` header it includes (`#include "name.cuh"`,
followed through the headers), and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  The flags are
fixed: a debug or fast-math build can never be cached under the release
build's name.  They include `-Xptxas -v`, which changes no code: ptxas's
report of each kernel's registers, shared memory and spills is kept beside
the library (`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_loaded: dict = {}  # source path -> ctypes.CDLL, loaded once per process


def nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME / $CUDA_PATH, or the
    toolkit's default location."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        f"{CSRC_DIR} at first use (set CUDA_HOME or put nvcc on PATH)")


def sources(source: Path) -> list:
    """`source` and every header beside it that it includes, directly or
    through another header, in the order first met."""
    found = [source]
    for path in found:
        for name in _INCLUDE.findall(path.read_text()):
            header = path.parent / name
            if header.is_file() and header not in found:
                found.append(header)
    return found


def library_path(source: Path) -> Path:
    """Where the library for `source` at the current contents of it and
    its headers, and the flags, lives."""
    key = hashlib.sha256()
    for path in sources(source):
        key.update(path.name.encode() + b"\0" + path.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmadqp_{source.stem}_{key.hexdigest()[:16]}.so"


def build_log(source: Path) -> str:
    """nvcc's output (ptxas's per-kernel report) from building the current
    library of `source`; empty if it was not built by this checkout."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(source: Path) -> Path:
    """Compile `source` with NVCC_FLAGS into BUILD_DIR (skipped when the
    library for this source already exists).  The library is written
    under a temporary name and renamed, so a concurrent or interrupted
    build never leaves a partial file under the final name."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(source: Path, signatures: dict, check=None) -> ctypes.CDLL:
    """Build `source` if needed and load it once per process.

    `signatures` maps each exported C function to (argtypes, restype); they
    are declared on first load, so a pointer is never passed as a 32-bit
    int.  `check(lib)`, if given, runs once on first load and raises if
    the library does not fit its wrapper; a library that fails it is not
    kept."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        if check is not None:
            check(lib)
        _loaded[source] = lib
    return lib
