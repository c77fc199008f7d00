"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``lib<name>-<digest>.so``), loaded through
``ctypes``. Sources never include PyTorch's headers, so a build takes
seconds, and every source builds in its own ``nvcc`` process, all started
together. Libraries land in ``ops/_build/`` (git-ignored), keyed by a digest
of the sources and flags, so an edited source never loads a stale library.

Nothing here runs at import: the CPU tests import every module, and this
host may have no ``nvcc``. A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
KERNELS = ("pe_block", "mha", "max_pool", "fused_stem", "consensus_heads")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built on this host"
        )
    return found


def _sources(name: str):
    return [os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(CSRC_DIR, "common.cuh")]


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that has no library yet, one ``nvcc`` per
    source, all at once. Returns {name: seconds} for the ones built; the
    ptxas report (registers, spills) goes to ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _sources(name)[0]]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            out,
        )
    seconds, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        with open(f"{out}.log", "wb") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """The ptxas lines (registers, shared memory, spills) of a built kernel."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path, errors="replace") as fh:
        return "".join(line for line in fh if "ptxas" in line)
