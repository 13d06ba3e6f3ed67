"""Build the hand-written kernels from this package's sources, on first use.

CUDA C++ (``csrc/*.cu``, plain C interface) is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``BUILD_DIR`` and loaded with
``ctypes``: a few seconds per file, where a build through
``torch.utils.cpp_extension`` (PyTorch's headers) takes minutes. Libraries
are named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header rebuilds.

Each library has its own lock, so :func:`build_libraries` runs one ``nvcc``
per source, all at once. Every kernel of the port is one of these
libraries; ``BUILD_DIR`` is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
# ptxas assembles a file's kernels on every core (--split-compile=0): the
# same SASS as on one thread, in a third of the time
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-Xptxas", "--split-compile=0")

# the CUDA sources under csrc/, one library each
CUDA_LIBRARIES = ("group_norm_fwd", "group_norm_bwd", "flash_attention_fwd",
                  "flash_attention_bwd")
# name -> {"seconds": build seconds (0.0 if already built), "log": nvcc's stderr}
BUILD_INFO: dict = {}
_LIBS: dict = {}
_LOCKS = {name: threading.Lock() for name in CUDA_LIBRARIES}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source on first use")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _LOCKS[name]:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_CSRC, name + ".cu")
        h = hashlib.sha256()
        for path in [src, *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        info = {"seconds": 0.0, "log": ""}
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
            info = {"seconds": time.perf_counter() - t0, "log": res.stderr}
        lib = ctypes.CDLL(out)
        BUILD_INFO[name] = info
        _LIBS[name] = lib
        return lib


def build_libraries(names=CUDA_LIBRARIES) -> None:
    """Build and load the named libraries, one ``nvcc`` process each, all
    started together; raises the first build's error."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(load_library, n) for n in names]:
            fut.result()

