"""Join a worker thread to the profiler that runs on another thread.

torch.profiler records the record_function ranges of the thread it was
started on, and of threads that carry that thread's ATen thread-local
state; a plain Python thread (a ThreadPoolExecutor worker) carries none, so
its spans are dropped.  ``csrc/profiler_tls.cpp`` hands the state over in
four C calls over ``at::ThreadLocalState`` / ``at::ThreadLocalStateGuard``:

    state = capture()            # on the thread under the profiler
    with joined(state):          # on a worker: its spans are recorded
        ...
    release(state)

The library is built with the host C++ compiler (``$CXX``, else ``c++``)
against torch's headers, never at import: on CUDA, turbo/_build.py's
build_all builds it beside the kernels; elsewhere the first capture()
does.  It lands in ``build/host/`` at the root of the checkout under a name
that hashes the source, the flags and torch's version, and is loaded with
ctypes.  When it cannot be built or loaded, capture() returns None,
joined(None) does nothing, and debuglog says so once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

from .debug import debuglog

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "profiler_tls.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
_CXXFLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}")
_lib = None
_tried = False
_lock = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX") or "c++"


def library_path() -> Path:
    """The built library's path: it changes with the source, the compiler,
    the flags and the torch it is built against."""
    key = " ".join((_cxx(), *_CXXFLAGS, torch.__version__,
                    str(Path(torch.__file__).parent)))
    tag = hashlib.sha1(_SRC.read_bytes() + key.encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libprofiler_tls-{tag}.so"


def _compile(lib: Path) -> None:
    """Compile into a temporary file and move it into place with os.replace,
    so no process loads a half-written library.  The caller holds the lock."""
    from torch.utils.cpp_extension import include_paths, library_paths

    incs = [f"-I{p}" for p in include_paths()]
    libs = [f for p in library_paths() for f in (f"-L{p}", f"-Wl,-rpath,{p}")]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([_cxx(), *_CXXFLAGS, *incs, "-o", str(tmp), str(_SRC),
                        *libs, "-lc10", "-ltorch_cpu"],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def build() -> Path:
    """The library's path, built first if missing (one process builds;
    the others wait on the lock file).  Raises when the build fails."""
    path = library_path()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / "libprofiler_tls.lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                _compile(path)
    return path


def _load():
    """The loaded library, built first if missing; None when it cannot be
    had (tried once a process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.PyDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            debuglog(1, "profiler_tls unavailable (%s %s); pool threads run "
                     "outside the profiler", e, detail.decode(errors="replace"))
            return None
        for fn in ("capture", "enter"):
            getattr(lib, fn).restype = ctypes.c_void_p
        for fn in ("enter", "release", "leave"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.capture.argtypes = []
        _lib = lib
        return _lib


def capture():
    """The calling thread's ATen state (its profiler among it), to hand to
    joined(); None when the library cannot be had."""
    lib = _load()
    return None if lib is None else lib.capture()


def release(state) -> None:
    """Free a state from capture()."""
    if state is not None:
        _lib.release(state)


@contextmanager
def joined(state):
    """Run the enclosed code in state's ATen thread-local state, then give
    the thread its own back; with state None, as it is."""
    if state is None:
        yield
        return
    guard = _lib.enter(state)
    try:
        yield
    finally:
        _lib.leave(guard)
