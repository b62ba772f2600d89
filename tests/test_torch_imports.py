"""The port stands alone: importing every drnmf_torch module loads neither
jax nor drnmf_tpu (nor h5py, which only the HDF5 cache of the data layer
imports, where it is used), and its entry points never fall back to the
CPU."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "drnmf_tpu", "h5py"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_or_reference_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 59  # the parallel package and memplan included
    # the multi-rank modules in one process
    multi = ("drnmf_torch.parallel, drnmf_torch.parallel.mesh, "
             "drnmf_torch.parallel.tensor_parallel, "
             "drnmf_torch.metrics.sharded, drnmf_torch.utils.memplan")
    for name in ("drnmf_torch.streaming", "drnmf_torch.serve",
                 "drnmf_torch.cli", "drnmf_torch.__main__",
                 "drnmf_torch.score_audio", "drnmf_torch.metrics.engine",
                 multi):
        probe = subprocess.run(
            [sys.executable, "-c",
             f"import sys, {name}; assert all(n in sys.modules for n in "
             f"'{name}'.split(', ')); "
             "assert not [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'drnmf_tpu')]"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert probe.returncode == 0, name + probe.stdout + probe.stderr


def _call_entry_point(name, tmp_path):
    from drnmf_torch import cli, enhance_wav, pipeline, score_audio, serve
    from drnmf_torch.metrics import bss_eval_sdr, score_taskfiles
    from drnmf_torch.metrics.engine import score_all_packed
    from drnmf_torch.data import AudioDataset, compute_stfts
    from drnmf_torch.dsp.phase import aug_stft
    from drnmf_torch.models.lstm import LSTMConfig, init_lstm_params
    from drnmf_torch.streaming import MultiStreamEnhancer, StreamingEnhancer
    from drnmf_torch.convert import init_drnmf_params, params_from_numpy
    from drnmf_torch.enhance import enhance_signals, make_enhancer
    from drnmf_torch.models import snmf_infer_irm
    from drnmf_torch.models.drnmf import DRNMFConfig
    from drnmf_torch.ops.snmf import SNMFParams, sparse_nmf
    from drnmf_torch.train.snmf_recipe import train_snmf

    cfg = DRNMFConfig(input_dim=5, r=2, output_dim=5, K_layers=1)
    w = np.full((5, 4), 0.5, np.float32)
    snmf = SNMFParams(r=2, cf="ed", max_iter=1)
    if name == "make_enhancer":
        make_enhancer(cfg)
    elif name == "enhance_signals":
        enhance_signals({}, cfg, [np.zeros(100, np.float32)])
    elif name == "params_from_numpy":
        params_from_numpy({"a": w})
    elif name == "init_drnmf_params":
        init_drnmf_params(cfg, w)
    elif name == "sparse_nmf":
        sparse_nmf(w, snmf)
    elif name == "train_snmf":
        train_snmf(w, w, snmf, path_dicts=str(tmp_path), verbose=False)
    elif name == "snmf_infer_irm":
        snmf_infer_irm(w, w, snmf)
    elif name == "StreamingEnhancer":
        StreamingEnhancer({}, cfg)
    elif name == "MultiStreamEnhancer":
        MultiStreamEnhancer({}, cfg, 2)
    elif name == "serve":
        serve.main(["-c", "c.yaml", "-m", "m.npz", "--port", "0"])
    elif name == "cli":
        cli.main(["-c", "params_lstm.yaml", "-d", "d.yaml", "--no-score"])
    elif name in ("run_unfolded_snmf", "run_lstm", "run_snmf"):
        getattr(pipeline, name)({}, {}, str(tmp_path / "exp"),
                                flag_score=False)
    elif name == "predict_irm":
        pipeline.predict_irm(None, {}, np.zeros((1, 2, 5), np.float32))
    elif name == "compute_stfts":
        compute_stfts([], {"N": 16, "hop": 4})
    elif name == "AudioDataset":
        AudioDataset(str(tmp_path / "x.txt"), str(tmp_path / "y.txt"))
    elif name == "init_lstm_params":
        init_lstm_params(LSTMConfig())
    elif name == "aug_stft":
        aug_stft(np.zeros(64, np.float32), 16, 4)
    elif name == "score_audio":
        score_audio.main(["--enh", "e.txt", "--ref", "r.txt"])
    elif name == "score_all_packed":
        score_all_packed([np.zeros(600, np.float32)],
                         [np.zeros(600, np.float32)])
    elif name == "score_taskfiles":
        score_taskfiles(["e.wav"], ["r.wav"])
    elif name == "bss_eval_sdr":
        bss_eval_sdr(np.zeros(600, np.float32), np.zeros(600, np.float32))
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
                 "init_drnmf_params", "enhance_wav", "sparse_nmf",
                 "train_snmf", "snmf_infer_irm", "StreamingEnhancer",
                 "MultiStreamEnhancer", "serve", "cli", "run_unfolded_snmf",
                 "run_lstm", "run_snmf", "predict_irm", "compute_stfts",
                 "AudioDataset", "init_lstm_params", "aug_stft",
                 "score_audio", "score_all_packed", "score_taskfiles",
                 "bss_eval_sdr"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _call_entry_point(name, tmp_path)
