"""The port's batch enhancer (drnmf_torch.enhance) against the JAX
package's on the CPU: same signals (as tests/test_pipeline.py builds them),
same parameters.  Tolerance rtol 1e-4 / atol 1e-5 on waveforms: f32 FFTs,
recurrence and overlap-add on both sides, in different summation orders."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from drnmf_tpu.enhance import enhance_signals as jax_enhance_signals
from drnmf_tpu.models import DRNMFConfig as JaxConfig
from drnmf_tpu.models import init_drnmf_params as jax_init
from drnmf_tpu.train.checkpoint import save_checkpoint as jax_save
from drnmf_torch.config import drnmf_config_from_params
from drnmf_torch.convert import params_from_numpy
from drnmf_torch.dsp.wav import wavread, wavwrite
from drnmf_torch.enhance import enhance_signals, stage_clock
from drnmf_torch.enhance_wav import ENHANCE_STAGES
from drnmf_torch.models.drnmf import DRNMFConfig
from drnmf_torch.ops.drnmf_scan import drnmf_scan_factored_reference
from drnmf_torch.train.checkpoint import load_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FFT, HOP = 256, 64
F = N_FFT // 2 + 1
MODEL = dict(K_layers=2, r=8, alph=10.0, lam1=0.5,
             params_untied=["log_D", "log_alph"],
             params_trainable=["log_D", "log_alph"])
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def model(rng):
    w = rng.uniform(0.05, 1.0, (F, 16)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    kw = dict(input_dim=F, r=8, output_dim=F, K_layers=2, alph=10.0,
              lam1=0.5, params_untied=("log_D", "log_alph"),
              params_trainable=("log_D", "log_alph"))
    jcfg = JaxConfig(matmul_precision="highest", **kw)
    params = {k: np.asarray(v) for k, v in jax_init(jcfg, w).items()}
    return jcfg, DRNMFConfig(**kw), params


def _signals(rng):
    return [(rng.standard_normal(rng.integers(2000, 4000)) * 0.2)
            .astype(np.float32) for _ in range(3)]


def test_enhance_signals_and_checkpoint_match_jax(rng, model, tmp_path):
    jcfg, tcfg, params = model
    sigs = _signals(rng)
    for batch_size in (1, 2, 3):
        ref = jax_enhance_signals(params, jcfg, sigs, N_FFT, HOP,
                                  batch_size=batch_size)
        out = enhance_signals(params_from_numpy(params, "cpu"), tcfg, sigs,
                              N_FFT, HOP, batch_size=batch_size, device="cpu")
        assert [len(o) for o in out] == [len(s) for s in sigs]
        for o, r in zip(out, ref):
            assert o.dtype == np.float32
            np.testing.assert_allclose(o, np.asarray(r),
                                       err_msg=f"batch_size={batch_size}",
                                       **TOL)

    # JAX save_checkpoint -> port load_checkpoint -> params_from_numpy gives
    # the same enhancement; the port's own save loads back equal
    path = str(tmp_path / "model.npz")
    jax_save(path, params, meta={"epoch": 3})
    loaded, meta = load_checkpoint(path[:-4])
    assert set(loaded) == set(params) and int(meta["epoch"]) == 3
    for k in params:
        np.testing.assert_array_equal(loaded[k], params[k])
    direct = enhance_signals(params, tcfg, sigs, N_FFT, HOP, device="cpu")
    via = enhance_signals(params_from_numpy(loaded, "cpu"), tcfg, sigs,
                          N_FFT, HOP, device="cpu")
    for a, b in zip(direct, via):
        np.testing.assert_array_equal(a, b)
    path2 = str(tmp_path / "again.npz")
    save_checkpoint(path2, params_from_numpy(loaded, "cpu"), meta)
    again, meta2 = load_checkpoint(path2)
    assert int(meta2["epoch"]) == 3
    for k in params:
        np.testing.assert_array_equal(again[k], params[k])


def test_enhance_signals_laps_and_scan_fn(rng, model):
    """``lap`` is called after each stage of each batch, in order;
    ``scan_fn`` takes the recurrence, once per batch, and the plain version
    passed there gives the output the default gives (on CPU tensors the
    wrapper runs that same plain version)."""
    _, tcfg, params = model
    params = params_from_numpy(params, "cpu")
    sigs = _signals(rng)
    names, scanned = [], []

    def scan(*args):
        scanned.append(tuple(args[0].shape))
        return drnmf_scan_factored_reference(*args)

    out = enhance_signals(params, tcfg, sigs, N_FFT, HOP, batch_size=2,
                          device="cpu", scan_fn=scan, lap=names.append)
    assert names == list(ENHANCE_STAGES) * 2
    assert len(scanned) == 2 and scanned[0][0] == 2 and scanned[1][0] == 1
    ref = enhance_signals(params, tcfg, sigs, N_FFT, HOP, batch_size=2,
                          device="cpu")
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)

    stages = {}
    lap = stage_clock(stages, "cpu")
    for name in ("a", "b", "a"):
        lap(name)
    assert list(stages) == ["a", "b"]
    assert all(v >= 0.0 for v in stages.values())


def test_enhance_wav_cli_on_cpu(rng, model, tmp_path):
    """python -m drnmf_torch.enhance_wav --device cpu on two wavs writes
    the enhanced wavs that enhance_signals gives for the same input."""
    _, tcfg, params = model
    cfg_path, ckpt = tmp_path / "params_unfolded_snmf_t.yaml", tmp_path / "m.npz"
    cfg_path.write_text(yaml.safe_dump(MODEL))
    save_checkpoint(str(ckpt), params)
    wavs = []
    for i, s in enumerate(_signals(rng)[:2]):
        p = tmp_path / f"noisy{i}.wav"
        wavwrite(str(p), 16000, s[None])
        wavs.append(str(p))
    out_dir = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "drnmf_torch.enhance_wav", "-c", str(cfg_path),
         "-m", str(ckpt), "--n-fft", str(N_FFT), "--hop", str(HOP),
         "--device", "cpu", "-o", str(out_dir), *wavs],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "enhance:" in proc.stdout and "device: cpu" in proc.stdout
    for name in ("load", "read", *ENHANCE_STAGES, "write"):
        assert f"  {name}: " in proc.stdout, name
    cfg = drnmf_config_from_params(yaml.safe_load(cfg_path.read_text()), F)
    assert cfg == tcfg
    sigs = [wavread(w)[0] for w in wavs]
    ref = enhance_signals(params, cfg, sigs, N_FFT, HOP, device="cpu")
    for w, r in zip(wavs, ref):
        got = wavread(str(out_dir / os.path.basename(w)))[0]
        assert got.shape == r.shape
        # int16 quantisation of the written wav: one step is 1/32768
        np.testing.assert_allclose(got, r, rtol=0, atol=2.0 / 32768)
