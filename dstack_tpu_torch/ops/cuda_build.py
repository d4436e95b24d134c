"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` at the
root of the checkout (or the directory :func:`set_build_dir` names: the
server's ``--compile-cache``, ``DSTACK_TPU_COMPILE_CACHE``, a volume that
outlives the process) and loaded with ``ctypes``. The library's file name
carries a hash of its sources and flags, so an edited source rebuilds
and a stale library is never loaded. :func:`build_all` starts one
``nvcc`` per source, all at once, so a cold build costs the slowest
file, not the sum.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNEL_SOURCES = ("flash_fwd", "flash_fwd_mla", "flash_decode", "flash_bwd_dq", "flash_bwd_dkv", "w8_matmul",
                  "adam8")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}  # name → ctypes.CDLL, loaded once per process


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from dstack_tpu_torch/csrc at first use"
    )


def set_build_dir(path) -> Path:
    """Build and load the libraries under ``path`` from now on (a library
    already loaded in this process stays loaded) → the directory."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve()
    return BUILD_DIR


def library_path(name: str) -> Path:
    """``BUILD_DIR/<name>-<hash>.so`` for the current sources."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every listed source whose library is missing, one
    ``nvcc`` per source in parallel → {name: seconds} (0.0 when the
    library was already built). Raises with the compiler's output when
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # write beside the target, then rename: a concurrent loader
        # never sees a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{name}.ptxas.log").write_text(log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher (a
    refused launch never runs, and a later synchronise does not say so)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
