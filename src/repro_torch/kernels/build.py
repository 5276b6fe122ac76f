"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch
headers), so one ``nvcc`` call takes seconds.  The shared library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source, every shared header ``csrc/*.cuh`` and the flags: a changed source
or header is rebuilt, an unchanged one is loaded as it is.  Builds happen
at first use, never at import.  A build writes to a private temporary name
and renames it into place, so processes that build the same source at once
never load a half-written library.  Within one process, :func:`build` and
:func:`load` run under one lock, so two threads that meet a kernel first
at the same moment make one build and one load.  ``BUILDS`` and ``LOADS``
count the nvcc builds and ``ctypes`` loads per source, so a warmed server
can check that live traffic built and loaded nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("segvis", "label_join", "segvis_tiles")

_LOADED: dict[str, ctypes.CDLL] = {}
# serialises build() and load() across threads (the adaptive manager's
# build thread warms kernels beside the serving threads); a plain lock, as
# it guards no serving state and nests under none
_LOCK = threading.Lock()
BUILDS: dict[str, int] = {}     # source name -> nvcc builds in this process
LOADS: dict[str, int] = {}      # source name -> ctypes loads in this process


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, every header
    in ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every named source not yet built, all nvcc calls at once.

    Returns {name: compiler output} (``-Xptxas -v`` register and shared
    memory report) for the sources built by this call; raises with the
    compiler's output when a build fails.
    """
    with _LOCK:
        return _build(names)


def _build(names) -> dict[str, str]:
    jobs = {n: job for n in names if (job := _start(n)) is not None}
    for n in jobs:
        BUILDS[n] = BUILDS.get(n, 0) + 1
    logs = {n: proc.communicate()[0] for n, (proc, _, _) in jobs.items()}
    failed = [n for n, (proc, _, _) in jobs.items() if proc.returncode != 0]
    for name, (proc, tmp, out) in jobs.items():
        if name in failed:
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}.cu\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                _build((name,))
                lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
                LOADS[name] = LOADS.get(name, 0) + 1
    return lib
