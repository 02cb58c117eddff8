"""Build the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, which ``ctypes`` loads. All
sources that still need building are compiled together (one ``nvcc`` per
source, started at once). Libraries land in ``build/kernels/`` at the root
of the checkout, named by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. A missing ``nvcc`` or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling in this process and each library's ptxas report
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; return name -> path."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: (src, _lib_path(src)) for src in sources}
    todo = [(name, src, lib) for name, (src, lib) in targets.items()
            if not lib.exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs: List = []
        try:
            for name, src, lib in todo:
                tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((name, lib, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failures = []
            for name, lib, tmp, proc in procs:
                log, _ = proc.communicate()
                BUILD_LOG[name] = log
                if proc.returncode != 0:
                    failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                                    f"{log}")
                    continue
                os.replace(tmp, lib)
        finally:
            for _, _, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
        elapsed = time.perf_counter() - t0
        for name, _, _ in todo:
            BUILD_SECONDS[name] = elapsed
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return {name: lib for name, (_, lib) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(str(paths[name]))
        return _LIBS[name]
