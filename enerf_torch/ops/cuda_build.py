"""Build and load the port's CUDA sources (csrc/*.cu) at first use.

Each source is compiled by nvcc into a shared library with a plain C
interface (no PyTorch headers, so nvcc compiles only the kernel) and loaded with
ctypes.  Libraries go to build/enerf_torch/ at the repository root, named
by a hash of the source, so an edited source is rebuilt and a concurrent
build never leaves a half-written file to load (tmp + rename).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "enerf_torch"
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_loaded = {}      # source stem -> ctypes.CDLL
BUILD_LOGS = {}   # source stem -> nvcc output (-Xptxas -v: registers, smem, spills)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build enerf_torch's kernels")
    return path


def compile_library(name):
    """Compile csrc/<name>.cu (if not built yet); returns the .so path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}_{digest}.so"
    if out.exists():
        BUILD_LOGS.setdefault(name, "(cached build)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}")
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return out


def load_library(name):
    """ctypes handle of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(compile_library(name)))
        return _loaded[name]
