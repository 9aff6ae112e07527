"""nvcc builds of the port's hand-written kernels (`csrc/*.cu`).

Each source is compiled at first use by `nvcc` for sm_90a into a shared
library with a plain C interface under `build/` at the checkout root,
named after the source and a hash of its bytes (an edited source is
rebuilt; a library of the same hash is reused), and loaded with ctypes
by its wrapper (`qp_cuda.build`, `sfc_cuda.build`). `build_log` keeps,
per source compiled in this process, nvcc's wall time and its output
(with `-Xptxas -v`: registers and spills).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

build_log = {}  # source file name -> (nvcc seconds, nvcc output), for builds run in this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return str(path)


def library_path(source: Path) -> Path:
    """build/lib<stem>_<12 hex digits of the source's sha256>.so"""
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def compile_source(source: Path, verbose: bool = False) -> Path:
    """The library of `source`, compiled first if it is missing (into a
    temporary file, renamed when nvcc succeeds); raises RuntimeError
    with nvcc's output if the build fails."""
    source = Path(source)
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    build_log[source.name] = (time.perf_counter() - t0, log)
    if res.returncode != 0:
        raise RuntimeError(f"{source.name}: nvcc failed ({res.returncode}):\n{log}")
    if verbose:
        print(f"nvcc {source.name} ({build_log[source.name][0]:.2f} s)\n{log}")
    tmp.replace(lib)
    return lib
