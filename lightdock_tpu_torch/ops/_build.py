"""Build and load the sources under ``csrc/`` with ctypes: the CUDA
kernels (``*.cu``) with nvcc, the host IO library (``io_native.cpp``) with
the host C++ compiler.

Each source is compiled at first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``lightdock_tpu_torch/build/`` and keyed by a hash of the source, the
shared headers (``csrc/*.cuh``, for the ``.cu`` sources) and the flags, so
an edited source is rebuilt and an unchanged one is reused.  A failed
build raises with the compiler's log; nothing falls back.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of lightdock_tpu_torch are built with it at first use")


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (set CXX or put g++ on PATH); "
                           "lightdock_tpu_torch builds its IO library "
                           "csrc/io_native.cpp with it at first use")
    return cxx


class BuiltLibrary:
    """A loaded kernel library with what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path,
                 build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when reused from disk
        self.log = log


_loaded: dict[str, BuiltLibrary] = {}


def _target(name: str):
    """(source, library path, compiler lookup, flags): a
    ``csrc/<name>.cpp`` is host code, else ``csrc/<name>.cu``."""
    src = CSRC_DIR / f"{name}.cpp"
    if src.is_file():
        compiler, flags, headers = find_cxx, CXX_FLAGS, b""
    else:
        src = CSRC_DIR / f"{name}.cu"
        compiler, flags = find_nvcc, NVCC_FLAGS
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()
                         ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so", compiler, flags


def load_all(names) -> dict[str, BuiltLibrary]:
    """Compile each ``csrc/<name>.cu`` or ``.cpp`` of ``names`` that is not
    built yet, one compiler process per source, all started together, and
    load them (once a process).  A failed build kills the others and
    raises."""
    pending = {}
    try:
        for name in names:
            if name in _loaded or name in pending:
                continue
            src, out, compiler, flags = _target(name)
            if out.exists():
                pending[name] = (None, out, out, 0.0)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            command = [compiler(), *flags, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(command, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in pending.items():
            log, seconds = "", 0.0
            if proc is not None:
                log = proc.communicate(timeout=600)[0]
                seconds = time.perf_counter() - t0  # until collected
                if proc.returncode != 0:
                    raise RuntimeError(f"{' '.join(proc.args)} failed:\n{log}")
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            _loaded[name] = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
    finally:
        for proc, *_ in pending.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: _loaded[name] for name in names}


def load(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` if needed and load it (once a
    process)."""
    built = _loaded.get(name)   # the common case, a dictionary lookup a launch
    return built if built is not None else load_all([name])[name]
