"""ctypes bindings for the native host kernels (native/fastops.cpp).

The port's own copy of `rag_docvqa_tpu/native.py`; both load the one
library built from `native/fastops.cpp`.

Compiled lazily on first use with g++ (-O3 -shared -fPIC) into
native/build/; every entry point has a pure-Python fallback so environments
without a toolchain still work. metrics/anls.py routes through here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "fastops.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libfastops.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> Optional[str]:
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.levenshtein.restype = ctypes.c_int
        lib.levenshtein.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
        lib.best_substring_ratio.restype = ctypes.c_double
        lib.best_substring_ratio.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int]
        lib.levenshtein_batch.restype = None
        lib.levenshtein_batch.argtypes = [u32p, i32p, u32p, i32p, ctypes.c_int, i32p]
        _lib = lib
    return _lib


def _codepoints(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)


def levenshtein(a: str, b: str) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ca, cb = _codepoints(a), _codepoints(b)
    return int(lib.levenshtein(ca, len(ca), cb, len(cb)))


def best_substring_ratio(a: str, b: str) -> Optional[float]:
    """Max difflib ratio of b against len(b)-windows of a (both lowercased by
    the caller). None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ca, cb = _codepoints(a), _codepoints(b)
    return float(lib.best_substring_ratio(ca, len(ca), cb, len(cb)))
