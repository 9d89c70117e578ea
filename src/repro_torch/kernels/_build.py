"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch header, so
``nvcc`` turns it into a shared library in seconds (with PyTorch's headers,
through ``torch.utils.cpp_extension``, a build takes minutes). Libraries go to
``kernels/build/`` (git-ignored), named by a hash of the flags, the source and
the headers it includes (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library never loads.
Nothing here runs at import: the CPU-only test run imports every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("rae_encode", "l2_topk", "graph_beam", "topk_merge", "pq_adc",
           "graph_beam_q", "embedding_bag", "flash_decode",
           "embedding_bag_bwd")
#: kernels that live in another kernel's source (one library for both)
_SOURCE = {"embedding_bag_bwd": "embedding_bag"}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ``nvcc`` processes started and libraries loaded in this process: what a
#: cold path pays once (``analysis.runtime.no_retrace`` reads it)
_cold_events = 0
_COLD_LOCK = threading.Lock()


def _count_cold() -> None:
    global _cold_events
    with _COLD_LOCK:
        _cold_events += 1


def cold_events() -> int:
    """Kernel builds (``nvcc`` processes) and library loads so far in this
    process; monotonic, so only differences mean something."""
    return _cold_events


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the port's "
                           "CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return path


def source_of(name: str) -> str:
    """The ``csrc/<source>.cu`` a kernel is built from."""
    return _SOURCE.get(name, name)


def sources(name: str) -> list[Path]:
    """The kernel's ``csrc/<source>.cu`` and every header it includes with
    quotes, read recursively (each once)."""
    out, todo = [], [CSRC / f"{source_of(name)}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / m.group(1) for m in
                 _INCLUDE.finditer(path.read_text())]
    return out


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the flags, the source and the
    headers it includes: editing a shared header rebuilds every kernel that
    includes it."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{source_of(name)}-{h.hexdigest()[:12]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as ``.log``.
    Raises with the log when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    jobs, started = [], set()
    for name, lib in out.items():
        if lib.exists() or lib in started:
            continue
        started.add(lib)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        log = open(lib.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC / f"{source_of(name)}.cu")]
        _count_cold()
        jobs.append((name, lib, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + lib.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (once a
    process: later calls return the loaded library)."""
    path = build((name,))[name]
    _count_cold()
    return ctypes.CDLL(str(path))


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``. The sharded search launches kernels
    from a thread pool, so the count is taken under a lock."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
