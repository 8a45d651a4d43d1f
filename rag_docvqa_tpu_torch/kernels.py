"""Build, load and count the port's hand-written CUDA kernels.

Every source in `csrc/` is compiled by `nvcc` for `sm_90a`, one process per
source, all started together, and linked into one shared library with a
plain C interface under `build/torch_kernels/` at the repo root, at first
use and again whenever the sources change (the library's name carries
their hash). It is loaded with `ctypes`; every pointer and the stream pass
as `c_void_p`. Each C entry point returns `cudaGetLastError()` after its
launch and `check` raises on anything but 0.

`LAUNCHES` counts, per kernel, the launches made through the wrappers in
`ops/`: each wrapper adds one where it launches, and nowhere else;
`FORM_LAUNCHES` counts, at the same places, the launches of a kernel's
form that a path must be shown to reach (K2 at dh 256, the gated product
over an expert layer's rows). They, the loaded
library and the answers `resident` keeps are this package's only
module-level state.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

# kept in step with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

LAUNCHES: Dict[str, int] = {
    "t5_rms_norm": 0,      # K1 (a), csrc/t5_layer.cu
    "t5_gemm": 0,          # K1 (b), csrc/t5_layer.cu
    "flash_fwd": 0,        # K2, csrc/flash_fwd.cu (also the attention of K1 and K13)
    "decode_cross_attention": 0,  # K3, csrc/decode_attention.cu
    "flash_bwd": 0,        # K6, csrc/flash_bwd.cu (also the attention of K8)
    "t5_gemm_bwd": 0,      # K7/K8 products, csrc/t5_layer_bwd.cu
    "t5_rms_bwd": 0,       # K7/K8 norm backward, csrc/t5_layer_bwd.cu
    "topk_fused": 0,       # K4, csrc/topk_fused.cu
    "topk_segmax": 0,      # K5, csrc/topk_segmax.cu
    "topk_segmax_int8": 0,  # K11, csrc/topk_segmax.cu
    "topk_segmax_int4": 0,  # K12, csrc/topk_segmax.cu
    "bert_gemm": 0,        # K9 products with a bias, csrc/bert_layer.cu
    "bert_layer_norm": 0,  # K9 LayerNorm, csrc/bert_layer.cu
    "bert_gemm_bwd": 0,    # K10 products, csrc/bert_layer_bwd.cu
    "bert_ln_bwd": 0,      # K10 LayerNorm backward, csrc/bert_layer_bwd.cu
    "bert_col_sum": 0,     # K10 bias gradients, csrc/bert_layer_bwd.cu
    "vit_layer_norm": 0,   # K14 LayerNorm over the compute dtype, csrc/vit_layer.cu
    "vit_gemm": 0,         # K14 products, csrc/vit_layer.cu
    "vit_attention": 0,    # K14 attention, csrc/vit_layer.cu
    "maxsim": 0,           # K15, csrc/maxsim.cu
    "lm_add_rms_norm": 0,  # causal-LM glue: residual add + RMSNorm, csrc/lm_glue.cu
    "lm_bias_rope": 0,     # causal-LM glue: q/k/v biases + rotary, csrc/lm_glue.cu
    "lm_glu": 0,           # causal-LM glue: the gated MLP's product, csrc/lm_glue.cu
}
# launches of one form of a kernel, counted besides the kernel's own count
FORM_LAUNCHES: Dict[str, int] = {
    "flash_fwd_dh256": 0,  # K2 at a head dim above 128 (the 256-wide instantiation)
    "lm_glu_rows": 0,      # lm_glu over the expert layer's [gate | up] rows, a live count on the device
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
    "decode_cross_attention": [_P] * 8 + [_I] * 8 + [_P],
    "flash_bwd": [_P] * 14 + [_I] * 6 + [_LL] * 12 + [_I] * 3 + [_F, _I, _F, _P],
    "t5_gemm_bwd": [_P] * 7 + [_I] * 6 + [_P, _I, _P],
    "t5_rms_bwd": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _P],
    "topk_fused": [_P] * 6 + [_I] * 8 + [_P],
    "topk_segmax": [_P] * 4 + [_I] * 9 + [_P],
    "topk_segmax_int8": [_P] * 4 + [_I] * 7 + [_P],
    "topk_segmax_int4": [_P] * 4 + [_I] * 7 + [_P],
    "bert_gemm": [_P] * 5 + [_I] * 5 + [_P],
    "bert_layer_norm": [_P] * 3 + [_I, _I, _F, _I, _P],
    "bert_gemm_bwd": [_P] * 5 + [_I] * 6 + [_P],
    "bert_ln_bwd": [_P] * 7 + [_I, _I, _I, _F, _I, _P],
    "bert_col_sum": [_P] * 3 + [_I] * 4 + [_P],
    "vit_layer_norm": [_P] * 3 + [_I, _I, _F, _I, _P],
    "vit_gemm": [_P] * 6 + [_I] * 5 + [_P],
    "vit_attention": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    "maxsim": [_P] * 6 + [_I] * 6 + [_P],
    "lm_add_rms_norm": [_P] * 5 + [_I, _I, _F, _I, _I, _P],
    "lm_bias_rope": [_P] * 8 + [_I] * 5 + [_LL, _LL, _I, _P],
    "lm_glu": [_P] * 3 + [_LL] * 3 + [_P, _I, _I, _P],
}
# occupancy queries (no launch, no counter): the blocks of a kernel an SM
# holds at once, into the last pointer; asked through `resident`
_QUERY_SIGNATURES = {
    "topk_fused_resident": [_I] * 3 + [_P],
    "topk_segmax_resident": [_I] * 2 + [_P],
    "topk_segmax_int8_resident": [_I] * 2 + [_P],
    "topk_segmax_int4_resident": [_I] * 2 + [_P],
}
_resident: Dict[tuple, int] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def counted(launches: dict, fn, *args, **kw):
    """fn(*args, **kw), its kernel launches (LAUNCHES) added to `launches`:
    the counts of the calls passed through here alone, not of the runs they
    are held to. Resets the counts first."""
    reset_launch_counts()
    out = fn(*args, **kw)
    for name, n in LAUNCHES.items():
        launches[name] = launches.get(name, 0) + n
    return out


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
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = [p.communicate()[0] for p in procs]
    failed = [f"{p.args[-1]} ({p.returncode}):\n{out}" for p, out in zip(procs, outputs) if p.returncode != 0]
    tmp = lib_path.with_name(f"{lib_path.name}.{tag}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in {**_SIGNATURES, **_QUERY_SIGNATURES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def resident(entry: str, device: torch.device, *args: int) -> int:
    """What the occupancy query `entry` (a `*_resident` entry point) reports
    for `args` on `device`: the blocks of one kernel an SM holds at once, 0
    where the kernel has no such form. Asked once per device and arguments."""
    key = (entry, device.index, args)
    if key not in _resident:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(entry, getattr(library(), entry)(*args, ctypes.byref(blocks)))
        _resident[key] = blocks.value
    return _resident[key]


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
