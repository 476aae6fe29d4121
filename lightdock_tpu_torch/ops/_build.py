"""Build and load the CUDA sources under ``csrc/`` with nvcc and ctypes.

Each source is compiled at first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``lightdock_tpu_torch/build/`` and keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused.
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
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def load_all(names) -> dict[str, BuiltLibrary]:
    """Compile each ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one nvcc process per source, all started together, and load them (once
    a process).  A failed build kills the others and raises."""
    pending = {}
    try:
        for name in names:
            if name in _loaded or name in pending:
                continue
            src, out = _target(name)
            if out.exists():
                pending[name] = (None, out, out, 0.0)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in pending.items():
            log, seconds = "", 0.0
            if proc is not None:
                log = proc.communicate(timeout=600)[0]
                seconds = time.perf_counter() - t0  # until collected
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            _loaded[name] = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
    finally:
        for proc, *_ in pending.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: _loaded[name] for name in names}


def load(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it (once a process)."""
    built = _loaded.get(name)   # the common case, a dictionary lookup a launch
    return built if built is not None else load_all([name])[name]
