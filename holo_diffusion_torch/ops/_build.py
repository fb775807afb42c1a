"""Build the port's native libraries at first use and load them.

Each `csrc/<name>.cu` (a CUDA kernel, compiled by `nvcc`) or
`csrc/<name>.cpp` (host code of the data loader, compiled by `g++`) exposes
a plain C interface and is compiled on its own into
`build/holo_diffusion_torch/lib<name>-<digest>.so` beside the package (the
digest covers the source and the flags, and for a `.cu` every header under
`csrc/`, so an edited source, or an edited header, rebuilds). The library
is loaded with `ctypes`. Nothing is built at import time, and a failed
build raises with the compiler's output.
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
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "holo_diffusion_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
SOURCES = ("fused_decode", "fused_decode_bwd", "fused_decode_c128", "kron_sample", "fused_render", "view_sample")
HOST_SOURCES = ("preprocess",)

_loaded: Dict[str, ctypes.CDLL] = {}
# one `load` at a time in a process: threads that first ask for the same
# library build it once
_load_lock = threading.Lock()


def nvcc_path() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = shutil.which("nvcc", path=os.path.join(cuda_home, "bin"))
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the data loader's C++ library cannot be built")
    return path


def _source(name: str) -> Path:
    """`csrc/<name>.cu`, else `csrc/<name>.cpp`."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(HOST_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES + HOST_SOURCES) -> Dict[str, float]:
    """Compile every library of `names` that is not built yet, one compiler
    per source (`nvcc` for a `.cu`, `g++` for a `.cpp`), all started
    together. Returns {name: seconds} for the sources compiled now; the
    compiler's output (for a kernel, the `-Xptxas -v` resource report) is
    kept in `<library>.log`. Raises with the compiler's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        # one temporary file per process and thread; os.replace publishes it
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        src = _source(name)
        if src.suffix == ".cu":
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        else:
            cmd = [gxx_path(), *HOST_FLAGS, str(src), "-o", str(tmp)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("the build failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name)
    log = path.with_name(path.name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` or `.cpp`, built first if
    needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib
