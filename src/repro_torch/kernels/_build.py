"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`.  No PyTorch
header is compiled, which keeps the build to seconds.

The library lands in ``kernels/_build/`` (listed in ``.gitignore``)
under a name that hashes the sources and flags, so an edited kernel is
rebuilt and a stale one is never loaded.  Nothing here runs at import
time: `load` is called by the first wrapper that launches a kernel.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` turns a non-zero code into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("restoration.cu", "compact.cu", "gather_expand.cu",
           "layer_fused.cu", "traversal_fused.cu", "sell_expand.cu",
           "sell_layer_fused.cu", "sell_traversal_fused.cu", "measure.cu",
           "gather_relax.cu", "sell_relax.cu", "frontier_expand.cu",
           "plan_union.cu", "apportion.cu", "rowsweep.cu")
HEADERS = ("bfs_common.cuh", "fused_phases.cuh", "sell_phases.cuh",
           "traversal_loop.cuh", "relax_common.cuh", "union_phases.cuh",
           "counters.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)

#: C signatures: name -> argument types (every function returns int)
SIGNATURES = {
    "repro_restoration": (_P, _P, _P, _LL, _I, _P),
    "repro_compact": (_P,) * 8 + (_I,) * 6 + (_P,),
    "repro_gather_expand": (_P,) * 9 + (_I,) * 10 + (_P,),
    "repro_layer_fused_grid": (_I,) * 4 + (_P,),
    "repro_layer_fused": (_P,) * 17 + (_I,) * 11 + (_P,),
    "repro_traversal_fused_grid": (_I,) * 4 + (_P,),
    "repro_traversal_fused": (_P,) * 28 + (_I,) * 11 + (_F,) * 3
    + (_I, _P),
    "repro_sell_expand": (_P,) * 9 + (_I,) * 8 + (_P,),
    "repro_sell_layer_fused_grid": (_I,) * 3 + (_P,),
    "repro_sell_layer_fused": (_P,) * 14 + (_I,) * 9 + (_P,),
    "repro_sell_traversal_fused_grid": (_I, _I, _I, _P),
    "repro_sell_traversal_fused": (_P,) * 24 + (_I,) * 9 + (_F,) * 3
    + (_I, _P),
    "repro_measure": (_P,) * 11 + (_LL,) + (_I,) * 5 + (_F,) * 3
    + (_I, _P),
    "repro_apportion": (_P,) * 9 + (_I,) * 4 + (_P,),
    "repro_gather_relax": (_P,) * 9 + (_I,) * 11 + (_P,),
    "repro_sell_relax": (_P,) * 9 + (_I,) * 9 + (_P,),
    "repro_frontier_expand": (_P,) * 7 + (_I, _LL) + (_I,) * 5 + (_P,),
    "repro_plan_union_csr": (_P,) * 10 + (_I,) * 6 + (_P,),
    "repro_plan_union_sell": (_P,) * 8 + (_I,) * 7 + (_P,),
    "repro_rowsweep": (_P,) * 5 + (_I,) * 5 + (_P,),
}

_LIB = None
_LOCK = threading.Lock()
BUILD_LOG: list[str] = []     # nvcc output of the last build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels build from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the shared library's path.

    ``-Xptxas -v`` changes no code; it puts each kernel's register and
    shared-memory report into `BUILD_LOG`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        BUILD_LOG.clear()
        failed = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG.append(f"== {name}\n{out}")
            if proc.returncode:
                failed.append(f"{name} (exit {proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


def load():
    """The loaded kernel library (built at the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc:
        msg = _LIB.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {rc} "
                           f"({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
