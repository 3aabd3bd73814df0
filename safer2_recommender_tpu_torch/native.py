"""Build-at-first-use of the port's native libraries, loaded with ctypes.

The libraries built here all come from sources in the repository:

* the CSV reader, from the port's own ``csrc/csv_reader.cc`` (a copy of
  the JAX package's ``native/csv_reader.cc``: the port builds, opens and
  reads nothing under the JAX package);
* the CUDA kernels under ``csrc/``, each compiled with ``nvcc`` for
  ``sm_90a`` into a shared library of its own with a plain C interface
  (``chol_inverse.cu``, ``bdot.cu``).

Each library lands in ``.build/torch_kernels/<name>-<hash>/`` beside the
package (git-ignored), keyed by a hash of its sources and build command,
so an edited source rebuilds and an unchanged one is reused. The
compiler writes to a name unique to its process and thread that is
published with an atomic rename: a concurrent process or thread never
loads a half-written file, so builds need no lock and run side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_DIR = os.path.dirname(_PKG_DIR)
BUILD_DIR = os.path.join(_REPO_DIR, ".build", "torch_kernels")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
CSV_READER_SRC = os.path.join(CSRC_DIR, "csv_reader.cc")
CSV_READER_FLAGS = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-lpthread"]


class BuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


def _digest(sources: Sequence[str], cmd: Sequence[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(cmd).encode())
    return h.hexdigest()[:16]


def build_shared(name: str, sources: Sequence[str],
                 compiler: List[str]) -> str:
    """Compile ``sources`` with ``compiler + ['-o', out] + sources`` into
    ``lib<name>.so`` under ``BUILD_DIR`` unless an identical build exists;
    return its path. Raises ``BuildError`` with the compiler's output."""
    for src in sources:
        if not os.path.isfile(src):
            raise BuildError(f"{name}: source {src} not found")
    out_dir = os.path.join(BUILD_DIR, f"{name}-{_digest(sources, compiler)}")
    out = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = list(compiler) + ["-o", tmp] + list(sources)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"{name}: {' '.join(cmd)} failed: {e}") from e
    if res.returncode != 0:
        raise BuildError(
            f"{name}: {' '.join(cmd)} exited {res.returncode}:\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_cuda(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build (or reuse) a CUDA shared library for sm_90a and load it."""
    flags = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
    return ctypes.CDLL(build_shared(name, sources, flags))


_csv_lib = None
_csv_tried = False


def load_csv_reader():
    """The native CSV reader, or None when no C++ toolchain can build it
    (callers then read with pandas or numpy, as the JAX package does)."""
    global _csv_lib, _csv_tried
    if _csv_tried:
        return _csv_lib
    _csv_tried = True
    try:
        path = build_shared("frt_io", [CSV_READER_SRC], CSV_READER_FLAGS)
        lib = ctypes.CDLL(path)
    except (BuildError, OSError):
        return None
    lib.frt_csv_count.restype = ctypes.c_int64
    lib.frt_csv_count.argtypes = [ctypes.c_char_p]
    lib.frt_csv_read.restype = ctypes.c_int64
    lib.frt_csv_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    _csv_lib = lib
    return _csv_lib
