"""Build a CUDA source of this package into a shared library at first use.

Route: ``nvcc`` for ``sm_90a`` into a library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library goes to ``build/drnmf_torch_kernels/`` at the root of the checkout,
named by a hash of the source and the flags, so a changed source rebuilds.
Nothing is built or loaded when a module is imported."""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

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
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
