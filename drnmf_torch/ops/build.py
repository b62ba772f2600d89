"""Build a CUDA source of this package into a shared library at first use,
and check a wrapper's operands before their pointers go to it.

Route: ``nvcc`` for ``sm_90a`` into a library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library goes to ``build/drnmf_torch_kernels/`` at the root of the checkout,
named by a hash of the source, every header of ``csrc/`` (``*.cuh``) and
the flags, so a changed source or header rebuilds.  Nothing is built or
loaded when a module is imported."""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drnmf_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a hash
    of the source, of every ``csrc/*.cuh`` (a source may include any of
    them) and of the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of this exact source and
    flags exists; returns its path.  nvcc's output (ptxas's register and
    spill counts) is kept beside it, see :func:`build_log`."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_log(source: str) -> str:
    """nvcc's output from the build of ``csrc/<source>``."""
    return library_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))


def check_operand(name, t, shape, dtype, device):
    """Raise unless ``t`` is a contiguous tensor of this shape, dtype and
    device: what a kernel's pointer arithmetic assumes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
