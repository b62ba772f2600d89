"""The port's DSP (drnmf_torch.dsp) against the JAX package's, on the CPU.

Both sides run an f32 FFT (pocketfft-family on each) in a different
summation order; with inputs of unit scale the transforms agree to a few
ulps of their largest value, so spectra and waveforms are held to
atol 1e-5 / rtol 1e-5 (about 100 ulps of the values compared).

Each test loops over its cases and names the case in a failure message:
the port's tests are kept to a few items so that they move pytest-xdist's
split of the rest of the suite as little as they can (ROADMAP.md, queue C,
caveats 5 and 6)."""

import importlib

import numpy as np
import pytest
import torch

from drnmf_tpu.dsp import windows as jwin
from drnmf_torch.dsp import windows as twin

# the packages export a function named stft, which hides the module
jstft_mod = importlib.import_module("drnmf_tpu.dsp.stft")
tstft_mod = importlib.import_module("drnmf_torch.dsp.stft")

TOL = dict(rtol=1e-5, atol=1e-5)
# (n_fft, hop, signal length); 10/3 is a hop that does not divide n_fft
STFT_CASES = [(512, 128, 3001), (256, 64, 3001), (320, 160, 3001),
              (10, 3, 301)]
OLA_CASES = [(8, 2), (10, 3), (12, 4), (512, 128)]


def test_windows_and_length_helpers_match_jax(rng):
    for n in (64, 256, 320, 512, 1024):
        np.testing.assert_array_equal(twin.hann_periodic(n),
                                      jwin.hann_periodic(n), err_msg=str(n))
        np.testing.assert_array_equal(twin.sqrt_hann_periodic(n),
                                      jwin.sqrt_hann_periodic(n),
                                      err_msg=str(n))

    assert tstft_mod.SAMPLE_BUCKET == jstft_mod.SAMPLE_BUCKET
    for n_fft, hop in [(512, 128), (256, 64), (320, 160), (10, 3)]:
        for nsampl in [1, 127, 128, 129, 2000, 9001, 128000, 16000 * 30,
                       16000 * 200]:
            for fn in ("padded_length", "bucket_total", "n_frames_for_length"):
                ours = getattr(tstft_mod, fn)(nsampl, n_fft, hop)
                theirs = getattr(jstft_mod, fn)(nsampl, n_fft, hop)
                assert type(ours) is int and ours == theirs, (
                    fn, n_fft, hop, nsampl)

    x = rng.standard_normal((2, 1001)).astype(np.float32)
    ours = tstft_mod.pad_signal(torch.from_numpy(x), 256, 64, total=2048)
    theirs = np.asarray(jstft_mod.pad_signal(x, 256, 64, total=2048))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    with pytest.raises(ValueError):
        tstft_mod.pad_signal(torch.from_numpy(x), 256, 64, total=1024)


def test_stft_istft_and_overlap_add_match_jax(rng):
    """Framing, rFFT and the inverse with its overlap-add, on a batch of two
    signals; then overlap-add alone."""
    for n_fft, hop, nsampl in STFT_CASES:
        case = f"n_fft={n_fft} hop={hop}"
        x = (rng.standard_normal((2, nsampl)) * 0.3).astype(np.float32)
        spec_t = tstft_mod.stft(torch.from_numpy(x), n_fft, hop)
        spec_j = np.asarray(jstft_mod.stft(x, n_fft, hop))
        assert spec_t.dtype == torch.complex64
        np.testing.assert_allclose(spec_t.numpy(), spec_j, err_msg=case, **TOL)
        y_t = tstft_mod.istft(spec_t, n_fft, hop, nsampl=nsampl).numpy()
        y_j = np.asarray(jstft_mod.istft(spec_j, n_fft, hop, nsampl=nsampl))
        assert y_t.shape == y_j.shape == (2, nsampl), case
        np.testing.assert_allclose(y_t, y_j, err_msg=case, **TOL)

    for n_fft, hop in OLA_CASES:
        frames = rng.standard_normal((3, 7, n_fft)).astype(np.float32)
        ours = tstft_mod.overlap_add(torch.from_numpy(frames), hop).numpy()
        theirs = np.asarray(jstft_mod.overlap_add(frames, hop))
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6,
                                   err_msg=f"n_fft={n_fft} hop={hop}")
