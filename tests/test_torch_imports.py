"""The port stands alone: importing every drnmf_torch module loads neither
jax nor drnmf_tpu, and its entry points never fall back to the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import drnmf_torch
names = ["drnmf_torch"] + [m.name for m in pkgutil.walk_packages(
    drnmf_torch.__path__, "drnmf_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "drnmf_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_or_reference_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15


def _call_entry_point(name, tmp_path):
    from drnmf_torch import enhance_wav
    from drnmf_torch.convert import init_drnmf_params, params_from_numpy
    from drnmf_torch.enhance import enhance_signals, make_enhancer
    from drnmf_torch.models.drnmf import DRNMFConfig

    cfg = DRNMFConfig(input_dim=5, r=2, output_dim=5, K_layers=1)
    w = np.full((5, 4), 0.5, np.float32)
    if name == "make_enhancer":
        make_enhancer(cfg)
    elif name == "enhance_signals":
        enhance_signals({}, cfg, [np.zeros(100, np.float32)])
    elif name == "params_from_numpy":
        params_from_numpy({"a": w})
    elif name == "init_drnmf_params":
        init_drnmf_params(cfg, w)
    else:
        wav = tmp_path / "x.wav"
        wav.write_bytes(b"")
        enhance_wav.main(["-c", "c.yaml", "-m", "m.npz", "-o", "out",
                          str(wav)])


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Called without device='cpu' on a host without CUDA, the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("make_enhancer", "enhance_signals", "params_from_numpy",
                 "init_drnmf_params", "enhance_wav"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _call_entry_point(name, tmp_path)
