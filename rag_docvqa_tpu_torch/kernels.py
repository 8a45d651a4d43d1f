"""Build, load and count the port's hand-written CUDA kernels.

Every source in `csrc/` is compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface under `build/torch_kernels/` at the repo
root, at first use and again whenever the sources change (the library's
name carries their hash). It is loaded with `ctypes`; every pointer and the
stream pass as `c_void_p`. Each C entry point returns `cudaGetLastError()`
after its launch and `check` raises on anything but 0.

`LAUNCHES` counts, per kernel, the launches made through the wrappers in
`ops/`: each wrapper adds one where it launches, and nowhere else. It and
the loaded library are this package's only module-level state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

# kept in step with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

LAUNCHES: Dict[str, int] = {
    "t5_rms_norm": 0,      # K1 (a), csrc/t5_layer.cu
    "t5_gemm": 0,          # K1 (b), csrc/t5_layer.cu
    "flash_fwd": 0,        # K2, csrc/flash_fwd.cu (also K1 (c))
    "decode_cross_attention": 0,  # K3, csrc/decode_attention.cu
}

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_P] * 7 + [_I] * 6 + [_LL] * 6 + [_I] * 3 + [_F, _I, _F, _P],
    "t5_rms_norm": [_P] * 3 + [_I, _I, _F, _I, _I, _P],
    "t5_gemm": [_P] * 4 + [_I] * 5 + [_P],
    "decode_cross_attention": [_P] * 5 + [_I] * 5 + [_P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> Path:
    """Compile csrc/ into build/torch_kernels/libtorch_kernels_<hash>.so
    unless that file exists; returns its path."""
    lib_path = BUILD_DIR / f"libtorch_kernels_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor, allowed) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"dtype {t.dtype} not supported here (takes {allowed})")
    return DTYPE_CODES[t.dtype]


def require(cond: bool, msg: str) -> None:
    """Wrapper argument check that survives `python -O`."""
    if not cond:
        raise ValueError(msg)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device (launch the kernel),
    False when all are on the CPU (run the plain version); raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return True
    raise ValueError(f"tensors on devices {sorted(map(str, devs))}: need all on the CPU or all on one CUDA device")
