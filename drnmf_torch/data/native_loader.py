"""ctypes bindings for the native batch wav reader ``native/wavio.cpp``
(counterpart of ``drnmf_tpu/data/native_loader.py``).

The library is built from the checkout's ``native/wavio.cpp`` with ``$CXX``
(else ``g++``) into ``build/drnmf_native/`` at the root of the checkout,
named by a hash of the source and the flags, as ``ops.build`` does for the
CUDA kernels; nothing is written under ``native/``.  Nothing is built or
loaded when the module is imported.  Where no compiler or no source is
found, :func:`native_available` is False and the callers read wavs with
scipy.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drnmf_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_lib_failed = False  # a failed build is not retried in this process


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdrnmfio-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/wavio.cpp`` unless a library of this exact source
    and flags exists; returns its path.  Raises where it cannot build."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX or g++) for the wav reader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) for "
                           f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def get_lib():
    """The loaded library, or None where it cannot be built."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        print(f"WARNING: native wav reader unavailable ({e}); using scipy",
              flush=True)
        _lib_failed = True
        return None
    _bind(lib)
    _lib = lib
    return lib


def _bind(lib):
    lib.wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.wav_info.restype = ctypes.c_int
    for name, ctype in (("wav_read_batch", ctypes.c_float),
                        ("wav_read_batch_i16", ctypes.c_int16)):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.POINTER(ctype),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        fn.restype = ctypes.c_int


def native_available() -> bool:
    return SOURCE.is_file() and get_lib() is not None


def wav_info(path):
    """-> (samples a channel, channels, sample rate)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native wav reader not built")
    nsampl = ctypes.c_int64()
    nch = ctypes.c_int32()
    fs = ctypes.c_int32()
    rc = lib.wav_info(path.encode(), ctypes.byref(nsampl), ctypes.byref(nch),
                      ctypes.byref(fs))
    if rc != 0:
        raise IOError(f"wav_info failed ({rc}) for {path}")
    return int(nsampl.value), int(nch.value), int(fs.value)


def _read(fn_name, dtype, ctype, paths, n_threads):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native wav reader not built")
    n = len(paths)
    max_len = max((wav_info(p)[0] for p in paths), default=0)
    data = np.zeros((n, max_len), dtype)
    lengths = np.zeros(n, np.int64)
    rcs = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bad = getattr(lib, fn_name)(
        c_paths, n, data.ctypes.data_as(ctypes.POINTER(ctype)), max_len,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if bad:
        failed = [paths[i] for i in range(n) if rcs[i] != 0]
        raise IOError(f"{bad} wav decodes failed, first: {failed[:3]}")
    return data, lengths


def read_batch(paths, n_threads=0):
    """Decode channel 0 of many wav files in parallel threads.

    Returns (data (n, max_len) float32 scaled by 1/32768, zero-padded;
    lengths (n,) int64)."""
    return _read("wav_read_batch", np.float32, ctypes.c_float, paths,
                 n_threads)


def read_batch_i16(paths, n_threads=0):
    """As :func:`read_batch`, but the raw PCM16 samples (int16)."""
    return _read("wav_read_batch_i16", np.int16, ctypes.c_int16, paths,
                 n_threads)
