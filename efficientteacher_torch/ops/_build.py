"""Build the package's CUDA kernels (`csrc/*.cu`) with nvcc at first use,
and its host library (`csrc/loader_core.cpp`) with the host compiler.

The sources have a plain C interface and are compiled into one shared
library, loaded with ctypes (no PyTorch headers, so a build takes seconds,
not minutes). The library goes into `efficientteacher_torch/_build/`, keyed
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one is loaded as it is.

Flags: `sm_90a` (Hopper); `--fmad=false` because the NMS kernel's IoU must
round exactly as the plain PyTorch version does (an FMA-contracted
`area1 + area2 - w*h` flips `iou > thr` on boundary pairs); never
`--use_fast_math`. `-Xptxas -v` puts each kernel's registers and shared
memory into the build log.

Every C entry returns `cudaGetLastError()` after its launches; `check`
turns a non-zero code into an exception.

`host_library` builds the loader core the same way (hashed over
`loader_core.cpp` and the headers it includes, atomic rename) with `c++`.
It links nothing but the C++ runtime: the JPEG decoder and writer are the
core's own (`csrc/jpeg_decode.h`, `csrc/jpeg_encode.h`), as are the
per-pixel stages of PNG, BMP and TIFF (`csrc/raster_decode.h`; zlib is
Python's). `-ffp-contract=off`
keeps the compiler from fusing a multiply and an add on its own: the
augmentation's pixel operations (`csrc/pixel_ops.h`) are bit-equal to
cv2 only with a fused multiply-add exactly where they call `std::fma`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types; pointers and the stream as c_void_p so ctypes
# never truncates them to 32 bits
_SIGNATURES = {
    # boxes, valid, keep, B, K, tile, iou_thres, stop_at (-1: none),
    # spill scratch (or null), spill rows, stream
    "et_nms_keep": (_P, _P, _P, _I, _I, _I, _F, _I, _P, _I, _P),
    "et_nms_list_cap": (),
    # scores, B, N, tau_lo, tau_hi, ticket + look-back scratch, cap,
    # out_scores, out_idx, stream
    "et_threshold_compact": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P),
    "et_compact_chunk": (),
    # scores, B, N, taus, T, counts, stream
    "et_count_ge": (_P, _I, _I, _P, _I, _P, _P),
    "et_count_ge_max_t": (),
}


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    sources: tuple
    seconds: float  # nvcc time in this process; 0.0 when loaded as built
    log: str        # nvcc's output (ptxas registers / shared memory)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


@functools.cache
def library() -> Built:
    """Build (if needed) and load the kernels' shared library."""
    sources = tuple(sorted(CSRC.glob("*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    so = BUILD_DIR / f"libet_kernels_{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        seconds, log = _compile(
            [_nvcc(), *NVCC_FLAGS, *map(str, sources), "-o"], so, "nvcc")
        log_path.write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.et_error_string.argtypes = [ctypes.c_int]
    lib.et_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return Built(lib, so, sources, seconds, log)


HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
HOST_SOURCES = ("loader_core.cpp", "h264_decode.h", "h264_tables.h",
                "jpeg_decode.h", "jpeg_encode.h", "mjpeg_decode.h", "mpeg4_decode.h", "pixel_ops.h",
                "raster_decode.h", "text_render.h", "video_dsp.h",
                "webp_decode.h", "webp_encode.h")


def _compile(cmd, so: Path, what: str) -> tuple:
    """Run `cmd` (which writes `so`'s temporary name last in its argument
    list), publish `so` atomically; returns (seconds, log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [*cmd, str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return seconds, proc.stdout + proc.stderr


@functools.cache
def host_library() -> Built:
    """Build (if needed) and load `csrc/loader_core.cpp`."""
    sources = tuple(CSRC / name for name in HOST_SOURCES)
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    so = BUILD_DIR / f"libet_loader_{digest.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (c++ or g++) on PATH")
        seconds, log = _compile(
            [cxx, *HOST_FLAGS, str(sources[0]), "-o"], so, "c++")
        log_path.write_text(log)
    lib = ctypes.CDLL(str(so))
    log = log_path.read_text() if log_path.exists() else ""
    return Built(lib, so, sources, seconds, log)


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = library().lib.et_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
