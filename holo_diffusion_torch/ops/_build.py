"""Build the port's native libraries at first use, load them, and launch
their kernels.

Each `csrc/<name>.cu` (a CUDA kernel, compiled by `nvcc`) or
`csrc/<name>.cpp` (host code of the data loader, compiled by `g++`) exposes
a plain C interface and is compiled on its own into
`build/holo_diffusion_torch/lib<name>-<digest>.so` beside the package (the
digest covers the source and the flags, and for a `.cu` every header under
`csrc/`, so an edited source, or an edited header, rebuilds). The library
is loaded with `ctypes`. Nothing is built at import time, and a failed
build raises with the compiler's output.

`KERNELS` declares each entry point of the CUDA libraries: its C function
(by channel count where that picks the library), its argument types, and
the device kernel names a trace shows for it. `launch` calls an entry
point on a device's current stream and counts it (`launch_counts`);
`traced_launch_counts` counts the same launches from a device trace's
kernel names, replays of a CUDA graph included. `on_cpu` is the ops
modules' one device rule: the plain versions on the CPU, the kernels on
CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

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


# ---- the kernels' entry points

_ptr, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# n, points a ray, D, H, W, C, j_pad, hidden, pe_dim
_DECODE_DIMS = (_i64, _i32, _i32, _i32, _i32, _i32, _i32, _i32, _i32)
# n, D, H, W, C, log2 of the lanes a point (K5: of its run), voxel size
_SAMPLE_GEOM = (_i64, _i32, _i32, _i32, _i32, _i32, _f32)
# the maps' table and its length, xy and its three strides, S, N,
# align_corners, the rows and their first two strides
_VIEW_ARGS = (ctypes.POINTER(_i64), _i32, _ptr, _i64, _i64, _i64, _i64, _i64, _i32, _ptr, _i64, _i64)


class Kernel(NamedTuple):
    """An entry point of the CUDA libraries. `functions`: its (library,
    C symbol) by channel count, or under None at every C. `argtypes`: the
    ctypes types of its arguments; every one also takes the stream last and
    returns a cudaError_t as int. `traced`: the device kernel names a trace
    shows for it, as (pattern, C), where a group C of the pattern holds the
    channel count and otherwise the C given does, if any."""

    functions: Dict[Optional[int], Tuple[str, str]]
    argtypes: Tuple
    traced: Tuple[Tuple[str, Optional[int]], ...]


KERNELS: Dict[str, Kernel] = {
    "fused_decode_fwd": Kernel(
        {32: ("fused_decode", "fused_decode_fwd"), 64: ("fused_decode", "fused_decode_fwd"),
         128: ("fused_decode_c128", "decode_c128_fwd")},
        (*[_ptr] * 8, *_DECODE_DIMS, _f32, _f32),
        ((r"fused_decode_kernel<(?P<C>\d+), ?false>", None), (r"decode_c128_fwd_kernel<false>", 128))),
    "fused_decode_fwd_normals": Kernel(
        {32: ("fused_decode", "fused_decode_fwd_normals"), 64: ("fused_decode", "fused_decode_fwd_normals"),
         128: ("fused_decode_c128", "decode_c128_fwd_normals")},
        (*[_ptr] * 9, *_DECODE_DIMS, _f32, _f32),
        ((r"fused_decode_kernel<(?P<C>\d+), ?true>", None), (r"decode_c128_fwd_kernel<true>", 128))),
    "fused_decode_bwd": Kernel(
        {32: ("fused_decode_bwd", "fused_decode_bwd"), 64: ("fused_decode_bwd", "fused_decode_bwd"),
         128: ("fused_decode_c128", "decode_c128_bwd")},
        (*[_ptr] * 12, *_DECODE_DIMS, _f32),
        ((r"fused_decode_bwd_kernel<(?P<C>\d+)>", None), (r"decode_c128_bwd_kernel", 128))),
    "kron_sample_fwd": Kernel({None: ("kron_sample", "kron_sample_fwd")}, (_ptr, _ptr, _ptr, *_SAMPLE_GEOM),
                              ((r"kron_sample_fwd_kernel", None),)),
    # K5 takes log2 of its tile last
    "kron_sample_dgrid": Kernel({None: ("kron_sample", "kron_sample_dgrid")}, (_ptr, _ptr, _ptr, *_SAMPLE_GEOM, _i32),
                                ((r"kron_sample_dgrid_kernel", None),)),
    # K6 takes D / extent last
    "kron_sample_dpoints": Kernel({None: ("kron_sample", "kron_sample_dpoints")},
                                  (_ptr, _ptr, _ptr, _ptr, *_SAMPLE_GEOM, _f32),
                                  ((r"kron_sample_dpoints_kernel", None),)),
    "trilinear_sample_onehot": Kernel({None: ("fused_render", "trilinear_sample_onehot")},
                                      (_ptr, _ptr, _ptr, *_SAMPLE_GEOM),
                                      ((r"trilinear_sample_onehot_kernel", None),)),
    "view_sample_fwd": Kernel({None: ("view_sample", "view_sample_fwd")}, _VIEW_ARGS,
                              ((r"view_sample_fwd_kernel", None),)),
    "view_sample_bwd": Kernel({None: ("view_sample", "view_sample_bwd")}, _VIEW_ARGS,
                              ((r"view_sample_bwd_kernel", None),)),
}

# (entry point, C) -> its C function, argument types bound
_bound: Dict[Tuple[str, Optional[int]], Callable[..., int]] = {}
# launches since the last reset, keyed "<entry point>" and "<entry point>@C<C>"
_launches: Counter = Counter()


def _add(counts: Counter, entry: str, C) -> None:
    counts[entry] += 1
    if C is not None:
        counts[f"{entry}@C{C}"] += 1


def _bind(entry: str, C: Optional[int]) -> Callable[..., int]:
    kernel = KERNELS[entry]
    library, symbol = kernel.functions.get(C) or kernel.functions[None]
    f = getattr(load(library), symbol)
    f.argtypes = [*kernel.argtypes, _ptr]
    f.restype = _i32
    _bound[(entry, C)] = f
    return f


def launch(entry: str, *args, device: torch.device, C: Optional[int] = None) -> None:
    """Call entry point `entry` (its function at C channels, where that
    depends on C) with `args` and `device`'s current stream. Raises on a
    CUDA error. Counts the launch under `entry`, and with C under
    "<entry>@C<C>", unless the stream is capturing a CUDA graph: the kernel
    then launches at each replay, which a device trace sees
    (`traced_launch_counts`) and these counters do not."""
    f = _bound.get((entry, C)) or _bind(entry, C)
    with torch.cuda.device(device):
        err = f(*args, torch.cuda.current_stream(device).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    if not capturing:
        _add(_launches, entry, C)


def launch_counts() -> Dict[str, int]:
    """The launches since the last reset: every entry point of `KERNELS`
    (0 where none), and "<entry>@C<C>" for those launched at C channels."""
    return {**dict.fromkeys(KERNELS, 0), **_launches}


def reset_launch_counts() -> None:
    _launches.clear()


_TRACED = [(re.compile(pattern), entry, C) for entry, kernel in KERNELS.items() for pattern, C in kernel.traced]
# a device kernel of csrc/ holds the first two words of an entry point's C
# symbol in its name (fused_decode, decode_c128, kron_sample, ...)
_KERNEL_STEMS = sorted({"_".join(symbol.split("_")[:2])
                        for kernel in KERNELS.values() for _, symbol in kernel.functions.values()})


def traced_launch_counts(names: Iterable[str]) -> Dict[str, int]:
    """{entry point: launches} of the device kernels named `names` (a
    trace's kernel names), and "<entry>@C<C>" where the name or the pattern
    gives the channel count; other device work is not counted. Raises on a
    kernel of csrc/ that no pattern of `KERNELS` names."""
    counts: Counter = Counter()
    for name in names:
        for pattern, entry, C in _TRACED:
            found = pattern.search(name)
            if found:
                _add(counts, entry, found.groupdict().get("C") or C)
                break
        else:
            if any(stem in name for stem in _KERNEL_STEMS):
                raise AssertionError(f"device kernel {name!r} matches no traced pattern of KERNELS")
    return dict(counts)


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain versions), False for a CUDA one (the
    kernels); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no kernel of csrc/ for {t.device}")
    return t.device.type == "cpu"
