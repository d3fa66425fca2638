"""Build a CUDA C++ source with nvcc into a shared library and load it
with ctypes.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds. It lands in `basicrenderer_tpu_torch/_build/` (listed in
.gitignore) under a name keyed on the source's hash and the flags, so a
fresh checkout builds at first use and an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # Kernels spell out every fused multiply-add they want; no
              # other expression may be contracted behind their back.
              "--fmad=false",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


class CudaLibrary:
    """A built and loaded kernel library: `lib` (ctypes.CDLL), `path`, and
    the compiler's resource report `build_log` (empty when the library was
    already built)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_log: str):
        self.lib = lib
        self.path = path
        self.build_log = build_log


_loaded: Dict[Path, CudaLibrary] = {}


def nvcc_path() -> str:
    """The nvcc to build with: CUDA_HOME's, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _start_build(source: Path, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(source: Path, out: Path, proc, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                           f"{source.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(sources) -> Dict[Path, CudaLibrary]:
    """Build every missing library of `sources` with one nvcc each, all
    started together, then load them all. Raises on the first failure."""
    sources = [Path(s).resolve() for s in sources]
    jobs = []
    for src in sources:
        out = _library_path(src)
        if src not in _loaded and not out.exists():
            jobs.append((src, out) + _start_build(src, out))
    try:
        logs = {src: _finish_build(src, out, proc, tmp)
                for src, out, proc, tmp in jobs}
    finally:
        for _src, _out, proc, _tmp in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for src in sources:
        if src not in _loaded:
            out = _library_path(src)
            _loaded[src] = CudaLibrary(ctypes.CDLL(str(out)), out,
                                       logs.get(src, ""))
    return {src: _loaded[src] for src in sources}


def load(source: Path) -> CudaLibrary:
    """Build `source` if its library is missing, load it once per process."""
    return build_all([source])[Path(source).resolve()]
