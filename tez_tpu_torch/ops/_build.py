"""Build and load the hand-written CUDA kernels of ``tez_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
on first use into ``tez_tpu_torch/_build/lib<name>-<hash>.so``, then loaded
with ctypes.  The file name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
a stale library is never loaded.  Nothing
here runs at import time: a host without nvcc can import the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("fnv_hash", "merge_rank", "merge_path")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine that has the card (set NVCC or PATH)")


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(SRC_DIR, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the shared headers too: an edited header rebuilds every kernel
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(SRC_DIR, h) for h in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one nvcc process
    per source, all started together.  Returns {name: {"path", "seconds",
    "log"}}; "log" holds nvcc's output (ptxas register and spill report)
    for libraries built by this call.  Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[tuple] = []
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            out[name] = {"path": lib, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = {"path": lib, "seconds": time.perf_counter() - t0,
                     "log": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(names: Iterable[str] = KERNELS) -> None:
    """Build the missing libraries of `names` (in parallel) and load
    them."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        if todo:
            for name, info in build(todo).items():
                _loaded[name] = ctypes.CDLL(info["path"])


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    load([name])
    return _loaded[name]
