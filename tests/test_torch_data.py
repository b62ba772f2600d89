"""The data layer of the port (drnmf_torch.data, drnmf_torch.dsp.phase)
against the JAX package's, on the CPU.

The same wav corpus (``make_synthetic_corpus`` from a seed; both packages
write the same bytes) goes through both.  Tolerances: the native reader and
the batching functions exactly; STFT stacks rtol 1e-5 / atol 1e-6 of the
stack's peak (rFFTs of two libraries); with the hop phases removed, each
entry within ``_phase_tol``: the phase there is the unwrapped phase less
2*pi*(f/N)*(t*hop), which reaches pi*hop*T radians (3.8e4 at 190 frames of
hop 64), so float32 holds it only to a unit in the last place of that size
(0.004 rad) in either package, and their sums of the unwrap's corrections
run in other orders (JAX's cumsum is a tree on the CPU); the port is held
as tightly against a float64 numpy evaluation of the same algorithm.  The
hop-phase functions and the augmented STFT on operands whose phases stay
small rtol 1e-5 / atol 1e-6 (the augmented STFT with its hop phases
removed or added back within ``_phase_tol``, its waveform within 4 units in
the last place of the largest phase, of its peak); reconstructed audio one
int16 step, or 1e-5 of its peak.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import drnmf_tpu.data as jdata
from drnmf_tpu.data import native_loader as jnative
from drnmf_tpu.dsp import phase as jphase
import drnmf_torch.data as tdata
from drnmf_torch.data import native_loader as tnative
from drnmf_torch.dsp import phase as tphase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STFT = {"N": 256, "hop": 64, "nch": 1}


def _corpus(tmp_path, n_files=6):
    jtf = jdata.make_synthetic_corpus(str(tmp_path / "jax"), n_files=n_files,
                                      min_sec=0.5, max_sec=0.9)
    ttf = tdata.make_synthetic_corpus(str(tmp_path / "port"),
                                      n_files=n_files, min_sec=0.5,
                                      max_sec=0.9)
    return jtf, ttf


def _files(taskfile):
    with open(taskfile) as f:
        return f.read().split()


def _close_of_peak(got, want, msg):
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * peak,
                               err_msg=msg)


def _phase_tol(spec, n_frames, hop):
    """|spec| times 4 float32 units in the last place of the largest hop
    phase, pi*hop*(n_frames - 1): the precision both packages hold the
    phase to."""
    ulp = float(np.spacing(np.float32(np.pi * hop * max(n_frames - 1, 1))))
    return 4.0 * ulp * np.abs(spec) + 1e-6 * float(np.abs(spec).max())


def _remove_hop_phase_f64(spec, n_fft, hop):
    """``remove_hop_phase`` in float64 numpy: the reference algorithm
    without float32's rounding."""
    ang = np.angle(spec.astype(np.complex128))
    phase = np.unwrap(ang, axis=-2)
    phase = phase - (np.angle(np.exp(1j * phase)) - ang)
    t = np.arange(spec.shape[-2])[:, None] * hop
    f = np.arange(spec.shape[-1])[None, :] / n_fft
    phase = phase - 2.0 * np.pi * t * f
    return np.abs(spec) * np.exp(1j * phase)


def test_corpus_reader_and_stfts_match_jax(tmp_path, monkeypatch):
    """The synthetic corpus byte for byte, the WSJ0-like lengths, the
    native reader (built under build/, never under native/) against the
    JAX package's, and ``compute_stfts`` through the native and the scipy
    reader, with and without the hop phases removed, and on a two-channel
    corpus, against the JAX stack and ``fidx``."""
    jtf, ttf = _corpus(tmp_path)
    for name in ("noisy", "clean"):
        jf, tf = _files(jtf[name]), _files(ttf[name])
        assert [os.path.relpath(p, tmp_path / "jax") for p in jf] == \
            [os.path.relpath(p, tmp_path / "port") for p in tf]
        for a, b in zip(jf, tf):
            assert filecmp.cmp(a, b, shallow=False), (a, b)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(tdata.wsj0_like_lengths(rng_a, 40),
                                  jdata.synthetic.wsj0_like_lengths(rng_b,
                                                                    40))

    files = _files(jtf["noisy"])
    assert tnative.native_available()
    lib = tnative.library_path()
    assert lib.is_file() and lib.parent == \
        tnative.BUILD_DIR and str(lib).startswith(os.path.join(REPO, "build"))
    assert tnative.SOURCE == tnative.Path(REPO) / "native" / "wavio.cpp"
    for f in files:
        assert tnative.wav_info(f) == jnative.wav_info(f)
    for reader in ("read_batch", "read_batch_i16"):
        want = getattr(jnative, reader)(files)
        got = getattr(tnative, reader)(files)
        assert got[0].dtype == want[0].dtype, reader
        np.testing.assert_array_equal(got[0], want[0], err_msg=reader)
        np.testing.assert_array_equal(got[1], want[1], err_msg=reader)

    # a two-channel corpus goes through scipy in both packages
    stereo = []
    rng = np.random.default_rng(11)
    for i, n in enumerate((7000, 9100, 5300)):
        path = str(tmp_path / f"stereo{i}.wav")
        pcm = (rng.uniform(-0.5, 0.5, (n, 2)) * 32767).astype(np.int16)
        scipy.io.wavfile.write(path, 16000, pcm)
        stereo.append(path)

    for label, wavs, stft, native in (
            ("native", files, STFT, True), ("scipy", files, STFT, False),
            ("two channels", stereo, {**STFT, "nch": 2}, True)):
        monkeypatch.setattr(tnative, "native_available", lambda: native)
        for unwrap in (False, True):
            want, want_fidx = jdata.compute_stfts(wavs, stft,
                                                  flag_unwrap_phase=unwrap)
            got, fidx = tdata.compute_stfts(wavs, stft,
                                            flag_unwrap_phase=unwrap,
                                            device="cpu")
            msg = f"{label} unwrap={unwrap}"
            np.testing.assert_array_equal(fidx, want_fidx, err_msg=msg)
            assert got.shape == want.shape and got.dtype == np.float32, msg
            if not unwrap:
                _close_of_peak(got, want, msg)
                continue
            half = got.shape[0] // 2
            n_frames = int(np.max(fidx[:, 1] - fidx[:, 0]))
            want_c = want[:half] + 1j * want[half:]
            got_c = got[:half] + 1j * got[half:]
            tol = _phase_tol(want_c, n_frames, stft["hop"])
            assert (np.abs(got_c - want_c) <= tol).all(), msg
            # magnitudes do not depend on the phase: tight
            _close_of_peak(np.abs(got_c), np.abs(want_c), msg)
            # the port against float64, file by file
            plain, _ = tdata.compute_stfts(wavs, stft, device="cpu")
            nch, f_bins = stft["nch"], stft["N"] // 2 + 1
            for i in range(len(wavs)):
                cols = slice(fidx[i, 0], fidx[i, 1])
                # channel-major rows -> (nch, frames, F) and back
                spec = (plain[:half, cols] + 1j * plain[half:, cols]).reshape(
                    nch, f_bins, -1).transpose(0, 2, 1)
                f64 = _remove_hop_phase_f64(spec, stft["N"], stft["hop"])
                f64 = f64.transpose(0, 2, 1).reshape(half, -1)
                assert (np.abs(got_c[:, cols] - f64)
                        <= _phase_tol(f64, n_frames, stft["hop"])).all(), \
                    (msg, i)


def test_dataset_batching_and_phase_match_jax(tmp_path):
    """``AudioDataset`` (x clipped to y, the HDF5 ``datafile`` round trip
    and its refusals, reconstruction and the NMSE test mode), ``load_split``
    at maxlen 60 and None, the batching functions exactly, and the
    hop-phase functions and augmented STFT against the JAX package's."""
    jtf, _ = _corpus(tmp_path)
    # x one file longer than its y (the reference clips x to y)
    noisy, clean = _files(jtf["noisy"]), _files(jtf["clean"])
    fs, longer = scipy.io.wavfile.read(noisy[0])
    scipy.io.wavfile.write(noisy[0], fs, np.concatenate(
        [longer, longer[:700]]))

    jds = jdata.AudioDataset(jtf["noisy"], jtf["clean"], params_stft=STFT)
    tds = tdata.AudioDataset(jtf["noisy"], jtf["clean"], params_stft=STFT,
                             device="cpu")
    np.testing.assert_array_equal(tds.fidx, jds.fidx)
    _close_of_peak(tds.x_stack, jds.x_stack, "x_stack")
    _close_of_peak(tds.y_stack, jds.y_stack, "y_stack")
    assert tds.x_wavfiles == jds.x_wavfiles and tds.fs == jds.fs == 16000

    h5py = pytest.importorskip("h5py")
    datafile = str(tmp_path / "cache.h5")
    made = tdata.AudioDataset(jtf["noisy"], jtf["clean"], datafile=datafile,
                              params_stft=STFT, device="cpu")
    for ds in (tdata.AudioDataset(jtf["noisy"], jtf["clean"],
                                  datafile=datafile, params_stft=STFT,
                                  device="cpu"),
               jdata.AudioDataset(jtf["noisy"], jtf["clean"],
                                  datafile=datafile, params_stft=STFT)):
        for key in ("x_stack", "y_stack", "fidx"):
            np.testing.assert_array_equal(getattr(ds, key),
                                          getattr(made, key), err_msg=key)
        assert ds.y_wavfiles == made.y_wavfiles
    with h5py.File(datafile, "r") as f:
        assert dict(f["stft"].attrs) == {"N": 256, "hop": 64, "nch": 1,
                                         "unwrap": 0, "downsample": 1}
    with pytest.raises(ValueError, match="hop=64, requested hop=32"):
        tdata.AudioDataset(jtf["noisy"], jtf["clean"], datafile=datafile,
                           params_stft={**STFT, "hop": 32}, device="cpu")
    with pytest.raises(ValueError, match="downsample=1, requested"):
        tdata.AudioDataset(jtf["noisy"], jtf["clean"], datafile=datafile,
                           params_stft=STFT, downsample=2, device="cpu")
    reordered = tmp_path / "reordered.txt"
    reordered.write_text("\n".join(noisy[::-1]) + "\n")
    with pytest.raises(ValueError, match="do not match"):
        tdata.AudioDataset(str(reordered), jtf["clean"], datafile=datafile,
                           params_stft=STFT, device="cpu")

    for maxlen in (60, None):
        for tx, ty in (("mag", "mag"), ("logmag", "mag"), ("none", "none"),
                       ("mag", "logmag")):
            want = jdata.load_split(jds, tx, ty, maxlen=maxlen)
            got = tdata.load_split(tds, tx, ty, maxlen=maxlen)
            for g, w, name in zip(got, want, ("x", "y", "mask")):
                msg = f"maxlen={maxlen} {tx}/{ty} {name}"
                assert g.shape == w.shape and g.dtype == w.dtype, msg
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6
                                           * float(np.abs(w).max()),
                                           err_msg=msg)
    # on equal stacks the batching functions are equal exactly
    for maxlen in (60, 37, None):
        for tx in ("mag", "logmag", "identity"):
            want = jdata.reshape_and_pad_stacks(
                jds.x_stack, jds.y_stack, jds.fidx,
                jdata.make_transform(tx), jdata.make_transform(tx),
                pad_value=jdata.get_mask_value(tx, tx), maxlen=maxlen)
            got = tdata.reshape_and_pad_stacks(
                jds.x_stack, jds.y_stack, jds.fidx,
                tdata.make_transform(tx), tdata.make_transform(tx),
                pad_value=tdata.get_mask_value(tx, tx), maxlen=maxlen)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{maxlen} {tx}")
    for tx, ty in (("mag", "none"), ("none", "logmag"), ("none", "none")):
        assert tdata.get_mask_value(tx, ty) == jdata.get_mask_value(tx, ty)
    with pytest.raises(ValueError):
        tdata.make_transform("cube")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for axis, n in ((0, 5), (1, 3), (2, 9)):
        np.testing.assert_array_equal(tdata.pad_axis_to_n(a, axis, n, -1.0),
                                      jdata.pad_axis_to_n(a, axis, n, -1.0))
    np.testing.assert_array_equal(
        tdata.clip_x_to_y(jds.y_stack, jds.y_stack, jds.fidx, jds.fidx),
        jdata.clip_x_to_y(jds.y_stack, jds.y_stack, jds.fidx, jds.fidx))

    # reconstruction: enhanced wavs with the same mask, and the NMSE mode
    x, _, mask = jdata.load_split(jds, maxlen=None)
    irm = np.random.default_rng(5).uniform(0, 1, x.shape).astype(np.float32)
    jds.reconstruct_audio("jaxdesc", irm=irm, mask=mask)
    tds.reconstruct_audio("portdesc", irm=irm, mask=mask)
    for j in range(len(clean)):
        want = scipy.io.wavfile.read(jds.enhanced_path(j, "jaxdesc"))[1]
        got = scipy.io.wavfile.read(tds.enhanced_path(j, "portdesc"))[1]
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, j
    # the unmasked round trip: an NMSE of float32 rounding (about 1e-14) in
    # both (file 0's noisy wav is longer than its frames: the test mode, as
    # the reference's, needs equal lengths)
    got = tds.reconstruct_audio("t", idx=[1, 2, 5], test=True)
    want = jds.reconstruct_audio("t", idx=[1, 2, 5], test=True)
    assert len(got) == 3 and max(got) < 1e-12 and max(want) < 1e-12
    for j in (0, 3):
        _close_of_peak(tds.reconstruct_y(j), np.asarray(jds.reconstruct_y(j)),
                       f"reconstruct_y {j}")
    with pytest.raises(ValueError, match="maxlen=None"):
        tds.reconstruct_audio("bad", irm=irm[:2], mask=mask[:2])

    # hop phases on operands whose phases stay small (6 frames of hop 4)
    rng = np.random.default_rng(9)
    spec = (rng.standard_normal((2, 6, 9))
            + 1j * rng.standard_normal((2, 6, 9))).astype(np.complex64)
    for name in ("remove_hop_phase", "add_hop_phase"):
        want = np.asarray(getattr(jphase, name)(jnp.asarray(spec), 16, 4))
        got = getattr(tphase, name)(torch.from_numpy(spec), 16, 4).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    sig = rng.standard_normal(200).astype(np.float32)
    for unwrap in (False, True):
        want = jphase.aug_stft(sig, 16, 4, unwrap)
        got = tphase.aug_stft(sig, 16, 4, unwrap, device="cpu")
        msg = f"aug_stft {unwrap}"
        if unwrap:  # 55 frames: hop phases up to 680 rad
            want_c, got_c = want[:9] + 1j * want[9:], got[:9] + 1j * got[9:]
            assert (np.abs(got_c - want_c)
                    <= _phase_tol(want_c, want.shape[1], 4)).all(), msg
        else:
            _close_of_peak(got, want, msg)
        for nsrc in (1, 2):
            # nsrc sources: every real part, then every imaginary part
            stacked = np.concatenate([want[:9]] * nsrc + [want[9:]] * nsrc)
            w = jphase.iaug_stft(stacked, 9, nsrc, unwrap, hop=4)
            g = tphase.iaug_stft(stacked, 9, nsrc, unwrap, hop=4,
                                 device="cpu")
            msg = f"iaug_stft {unwrap} nsrc={nsrc}"
            assert g.shape == w.shape, msg
            if unwrap:  # the phases' precision, of the waveform's peak
                ulp = np.spacing(np.float32(np.pi * 4 * want.shape[1]))
                assert np.abs(g - w).max() <= 4 * ulp * np.abs(w).max(), msg
            else:
                _close_of_peak(g, w, msg)
