"""Correlation clustering (multicut) on the host: GAEC, GAEC with
Kernighan-Lin moves, and the mutex watershed (counterpart of
pemp_tpu.cluster.api's ``cluster_labels``).

``multicut.cpp`` (a copy of pemp_tpu/cluster/native/multicut.cpp) is
compiled by ``g++`` at first use into the port's build directory
(``ops._build.build_dir()``), named by a hash of its source, and bound with
ctypes. Nothing falls back: a failed build or solve raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from pemp_tpu_torch.ops._build import build_dir

SOURCE = Path(__file__).resolve().parent / "multicut.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
METHODS = {"GAEC": 0, "KL": 1, "MUT": 2}

_LIB = None


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return build_dir() / f"libmulticut_{digest}.so"


def build() -> Path:
    """Compiles the library if it is missing; raises RuntimeError with the
    compiler's output if that fails."""
    target = lib_path()
    if target.exists():
        return target
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the correlation clustering library needs a C++ "
                           "compiler")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for multicut.cpp:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)
    return target


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.multicut_labels.restype = ctypes.c_int
        lib.multicut_labels.argtypes = [i64p, i64p, ctypes.POINTER(ctypes.c_double),
                                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i64p]
        _LIB = lib
    return _LIB


def cluster_labels(edges, weights, num_nodes: int, method: str = "GAEC") -> np.ndarray:
    """Each node's cluster, named by one of its nodes (int64, (num_nodes,)).

    ``edges`` (2, E) node ids, ``weights`` (E,): positive joins, negative
    cuts (the decode passes edge probability - 0.5). ``method``: ``GAEC``,
    ``KL`` or ``MUT``.
    """
    if method not in METHODS:
        raise ValueError(f"clustering method {method!r}: one of {sorted(METHODS)}")
    edges = np.asarray(edges, dtype=np.int64).reshape(2, -1)
    src = np.ascontiguousarray(edges[0])
    dst = np.ascontiguousarray(edges[1])
    w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64).reshape(-1))
    if len(w) != edges.shape[1]:
        raise ValueError(f"{edges.shape[1]} edges but {len(w)} weights")
    if edges.size and (edges.min() < 0 or edges.max() >= num_nodes):
        raise ValueError(f"edge ends outside [0, {num_nodes})")
    out = np.zeros(num_nodes, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = _load().multicut_labels(
        src.ctypes.data_as(i64p), dst.ctypes.data_as(i64p),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(w), int(num_nodes),
        METHODS[method], out.ctypes.data_as(i64p),
    )
    if rc != 0:
        raise RuntimeError(f"multicut_labels failed ({rc}) on {num_nodes} nodes")
    return out
