"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Nothing is built at
import: the first wrapper call on a CUDA tensor builds what is missing, all
sources at once (one ``nvcc`` process per source, started together).  A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is never served a
stale build.  The builds land in
``build/torch_kernels/`` at the root of the checkout.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# chain_probe is a latency microbenchmark (chip_smoke.py), not a codec kernel
SOURCES = ("rans_encode", "rans_decode", "rans_decode_flat", "turbo_fse_decode",
           "fse_encode", "fse_decode", "huf_encode", "huf_decode", "chain_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, in parallel.

    Returns {name: {"path", "seconds", "ptxas"}} for the sources built by
    this call (ptxas lines list registers, shared memory, stack and spills
    per kernel).
    Raises RuntimeError with nvcc's output when a build fails."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
        built[name] = {"path": str(library_path(name)),
                       "seconds": time.perf_counter() - t0,
                       "ptxas": [ln.strip() for ln in log.splitlines()
                                 if "ptxas info" in ln or "stack frame" in ln]}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if missing."""
    if name not in _libs:
        if not library_path(name).exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]
