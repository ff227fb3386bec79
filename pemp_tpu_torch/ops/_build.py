"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``build/pemp_tpu_torch/`` beside the package (or
``$PEMP_TORCH_BUILD_DIR``), named by a hash of their source and the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_step", "fused_step_bwd", "typed_message", "attn_aggregate", "blocked_attn",
           "gather_rows")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    default = CSRC.parent.parent / "build" / "pemp_tpu_torch"
    return Path(os.environ.get("PEMP_TORCH_BUILD_DIR", default))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library, one nvcc per source, all at once.

    Returns {name: {"seconds": wall time, "log": nvcc's ptxas report}}
    (seconds 0.0 and an empty log where the library was already built).
    Raises RuntimeError with nvcc's output if a build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        target = lib_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, with its argument
    types declared and an int (cudaError_t) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
