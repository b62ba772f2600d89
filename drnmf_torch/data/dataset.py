"""Audio dataset: taskfiles -> STFT stacks (counterpart of
``drnmf_tpu/data/dataset.py``; the reference's ``AudioDataset``,
audio_dataset.py:172-435, and ``compute_STFTs``, util.py:310-352).

* paired noisy (x) / clean (y) taskfiles; ``downsample`` keeps every nth
  file;
* per-file STFTs concatenated into a real-composite stack of shape
  ``(2*nch*F, total_frames)`` (real over imaginary) with per-file frame
  ranges ``fidx`` (n_files, 2);
* input lengths clipped to output lengths where they disagree;
* an optional HDF5 cache of the stacks (``datafile``; ``h5py`` is imported
  only there);
* masked reconstruction: the ratio mask tiled over the real/imag halves,
  applied to the complex STFT, inverse STFT, a peak-safe wav write with the
  'scaled' -> 'enhanced_<desc>' path substitution.

Wavs are decoded on the host (the native reader for one channel, else
scipy); framing and rFFT run on ``device`` in batches of at most
``FEAT_CHUNK`` files of one length bucket (``dsp.stft.bucket_total``), which
bounds the host and device memory a batch takes.
"""

import os

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.stft import bucket_total, istft, n_frames_for_length, stft_frames
from ..dsp.wav import wavread, wavread_fs, wavwrite
from ..dsp.windows import sqrt_hann_periodic

FEAT_CHUNK = 64  # files a featurization batch


def compute_stfts(wavfiles, params_stft, verbose=False,
                  flag_unwrap_phase=False, device="cuda"):
    """Featurize a list of wav files.

    Returns (stack, fidx): stack the real-composite (2*nch*F, total_frames)
    float32 array, fidx (n_files, 2) int32 frame ranges, the layout of the
    reference's ``compute_STFTs``.  With ``flag_unwrap_phase`` the
    window-hop phases are removed file by file (``dsp.phase``)."""
    device = resolve_device(device)
    n_fft = int(params_stft["N"])
    hop = int(params_stft["hop"])
    nch = int(params_stft.get("nch", 1))
    window = params_stft.get("window")
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    window = torch.as_tensor(np.asarray(window, np.float32), device=device)
    f_bins = n_fft // 2 + 1

    wavfiles = list(wavfiles)
    use_native = False
    if nch == 1:
        from .native_loader import native_available

        use_native = native_available()
    if use_native:
        # lengths from the headers; each batch decodes its own files
        from .native_loader import read_batch, wav_info

        signals = None
        lengths = [wav_info(wf)[0] for wf in wavfiles]
    else:
        # scipy (multichannel, or no native reader) has no header-only read
        signals = [wavread(wf)[:nch] for wf in wavfiles]
        lengths = [s.shape[1] for s in signals]
    nframes = [n_frames_for_length(n, n_fft, hop) for n in lengths]

    stack = np.empty((2 * nch * f_bins, int(np.sum(nframes))), np.float32)
    fidx = np.zeros((len(wavfiles), 2), np.int32)
    fidx[:, 1] = np.cumsum(nframes)
    fidx[1:, 0] = fidx[:-1, 1]

    buckets = {}
    for i, length in enumerate(lengths):
        buckets.setdefault(bucket_total(length, n_fft, hop), []).append(i)

    for total_len, idxs in sorted(buckets.items()):
        for pos in range(0, len(idxs), FEAT_CHUNK):
            chunk = idxs[pos: pos + FEAT_CHUNK]
            # the reference's padding: n_fft zeros left, zeros to the
            # bucket's length right
            batch = np.zeros((len(chunk), nch, total_len), np.float32)
            if use_native:
                data, lens = read_batch([wavfiles[i] for i in chunk])
                for row in range(len(chunk)):
                    n = int(lens[row])
                    batch[row, 0, n_fft: n_fft + n] = data[row, :n]
            else:
                for row, i in enumerate(chunk):
                    x = signals[i]
                    batch[row, :, n_fft: n_fft + x.shape[-1]] = x
            spec = stft_frames(torch.from_numpy(batch).to(device), window,
                               n_fft, hop)  # (b, nch, frames, F)
            if flag_unwrap_phase:
                from ..dsp.phase import remove_hop_phase

                # causal along the frames (the unwrap is a cumsum from
                # frame 0), so a file's first nf frames of its padded row
                # are the reference's per-file result
                spec = remove_hop_phase(spec, n_fft, hop)
            # (b, nch, frames, F) -> (b, nch*F, frames), channel-major rows
            spec = spec.transpose(-1, -2).reshape(len(chunk), nch * f_bins,
                                                  -1).cpu().numpy()
            for row, i in enumerate(chunk):
                s = spec[row, :, :nframes[i]]
                stack[: nch * f_bins, fidx[i, 0]: fidx[i, 1]] = s.real
                stack[nch * f_bins:, fidx[i, 0]: fidx[i, 1]] = s.imag
        if verbose:
            print(f"  featurized {len(idxs)} files at bucket {total_len}")
    return stack, fidx


def clip_x_to_y(x_stack, y_stack, x_fidx, y_fidx):
    """Clip each utterance's input frames to its output's length
    (audio_dataset.py:90-104)."""
    y_lens = y_fidx[:, 1] - y_fidx[:, 0]
    out = np.empty((x_stack.shape[0], int(np.sum(y_lens))), x_stack.dtype)
    idx = 0
    for i in range(x_fidx.shape[0]):
        xcur = x_stack[:, x_fidx[i, 0]: x_fidx[i, 1]]
        out[:, idx: idx + y_lens[i]] = xcur[:, : y_lens[i]]
        idx += y_lens[i]
    return out


def _read_taskfile(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class AudioDataset:
    """Paired noisy/clean STFT dataset with an optional HDF5 cache.

    ``params_stft`` keys 'N', 'hop', 'nch' (a periodic sqrt-Hann window is
    always used); ``downsample`` keeps every nth taskfile line.  The STFTs
    and the inverse STFTs of reconstruction run on ``device``."""

    def __init__(self, taskfile_input, taskfile_output, datafile=None,
                 params_stft=None, downsample=1, verbose=False,
                 flag_unwrap_phase=False, device="cuda"):
        if params_stft is None:
            params_stft = {"N": 512, "hop": 128, "nch": 1}
        self.device = resolve_device(device)
        self.taskfile_input = taskfile_input
        self.taskfile_output = taskfile_output
        self.datafile = datafile
        self.params_stft = dict(params_stft)
        self.params_stft["window"] = sqrt_hann_periodic(int(params_stft["N"]))
        self.downsample = downsample
        self.verbose = verbose
        self.flag_unwrap_phase = flag_unwrap_phase
        self._fs = None
        if datafile is not None and os.path.isfile(datafile):
            self._load_datafile()
        else:
            self._featurize()

    @property
    def fs(self):
        """The corpus sample rate, read once from the first clean wav; 16
        kHz (CHiME2's) where no wav is reachable, as for a dataset restored
        from an HDF5 cache built elsewhere."""
        if self._fs is None:
            try:
                self._fs = int(wavread_fs(self.y_wavfiles[0])[1])
            except (OSError, IndexError, ValueError):
                self._fs = 16000
        return self._fs

    def _cache_attrs(self):
        return {"N": int(self.params_stft["N"]),
                "hop": int(self.params_stft["hop"]),
                "nch": int(self.params_stft.get("nch", 1)),
                "unwrap": int(bool(self.flag_unwrap_phase)),
                "downsample": int(self.downsample)}

    def _load_datafile(self):
        import h5py

        datafile = self.datafile
        with h5py.File(datafile, "r") as f:
            if "stft" in f:
                # a cache built with another featurization under this name
                # must not load silently
                for key, want in self._cache_attrs().items():
                    if key not in f["stft"].attrs:
                        if key in ("unwrap", "downsample"):
                            continue  # a cache older than the attribute
                        cached = -1
                    else:
                        cached = int(f["stft"].attrs[key])
                    if cached != want:
                        raise ValueError(
                            f"datafile {datafile} was built with "
                            f"{key}={cached}, requested {key}={want}; "
                            "delete the cache or use a different "
                            "datafile name")
            self.x_stack = f["x_stack"][:]
            self.y_stack = f["y_stack"][:]
            self.fidx = f["fidx"][:]
            self.x_wavfiles = [s.decode() if isinstance(s, bytes) else s
                               for s in f["x_wavfiles"][:]]
            self.y_wavfiles = [s.decode() if isinstance(s, bytes) else s
                               for s in f["y_wavfiles"][:]]
        # where the taskfiles are reachable, the files they select must be
        # the files the cache holds
        try:
            want_x = _read_taskfile(self.taskfile_input)[:: self.downsample]
        except (OSError, TypeError):
            want_x = None
        if want_x is not None and want_x != self.x_wavfiles:
            raise ValueError(
                f"datafile {datafile} holds {len(self.x_wavfiles)} files "
                f"that do not match the {len(want_x)} selected by "
                f"{self.taskfile_input} at downsample={self.downsample}; "
                "delete the cache or use a different datafile name")

    def _featurize(self):
        x_wavfiles = _read_taskfile(self.taskfile_input)[:: self.downsample]
        y_wavfiles = _read_taskfile(self.taskfile_output)[:: self.downsample]
        kw = dict(verbose=self.verbose,
                  flag_unwrap_phase=self.flag_unwrap_phase,
                  device=self.device)
        x_stack, x_fidx = compute_stfts(x_wavfiles, self.params_stft, **kw)
        y_stack, y_fidx = compute_stfts(y_wavfiles, self.params_stft, **kw)
        if not np.array_equal(x_fidx, y_fidx):
            if np.all(x_fidx[:, 1] - x_fidx[:, 0]
                      >= y_fidx[:, 1] - y_fidx[:, 0]):
                x_stack = clip_x_to_y(x_stack, y_stack, x_fidx, y_fidx)
            else:
                raise ValueError(
                    "Not all input files are at least as long as the outputs")
        self.x_stack, self.y_stack, self.fidx = x_stack, y_stack, y_fidx
        self.x_wavfiles, self.y_wavfiles = x_wavfiles, y_wavfiles

        if self.datafile is not None:
            import h5py

            with h5py.File(self.datafile, "w") as f:
                f.create_dataset("x_stack", data=x_stack)
                f.create_dataset("y_stack", data=y_stack)
                f.create_dataset("fidx", data=y_fidx)
                f.create_dataset("x_wavfiles",
                                 data=np.array(x_wavfiles, dtype="S"))
                f.create_dataset("y_wavfiles",
                                 data=np.array(y_wavfiles, dtype="S"))
                grp = f.create_group("stft")
                for key, value in self._cache_attrs().items():
                    grp.attrs[key] = value

    # -- reconstruction ----------------------------------------------------

    def _reconstruct(self, stack, idx, mask=None):
        n_fft = int(self.params_stft["N"])
        hop = int(self.params_stft["hop"])
        seg = stack[:, self.fidx[idx, 0]: self.fidx[idx, 1]]
        if mask is not None:
            if mask.shape[0] < seg.shape[0]:
                mask = np.tile(mask, (seg.shape[0] // mask.shape[0], 1))
            seg = mask * seg
        half = seg.shape[0] // 2
        spec = seg[:half] + 1j * seg[half:]  # (nch*F, nfram)
        f_bins = n_fft // 2 + 1
        nch = half // f_bins
        spec = spec.reshape(nch, f_bins, -1).transpose(0, 2, 1)  # (nch, T, F)
        window = torch.as_tensor(self.params_stft["window"],
                                 device=self.device)
        spec = torch.from_numpy(np.ascontiguousarray(
            spec.astype(np.complex64))).to(self.device)
        return istft(spec, n_fft, hop, window).cpu().numpy()  # (nch, nsampl)

    def reconstruct_x(self, idx, mask=None):
        return self._reconstruct(self.x_stack, idx, mask)

    def reconstruct_y(self, idx, mask=None):
        return self._reconstruct(self.y_stack, idx, mask)

    def enhanced_path(self, idx, description):
        return self.y_wavfiles[idx].replace("scaled",
                                            f"enhanced_{description}")

    def reconstruct_audio(self, description, irm=None, mask=None, idx=None,
                          test=False, fs=None):
        """Write enhanced wavs (or return each file's NMSE with ``test``).

        ``irm`` is (n_seq, T, F) with a matching binary ``mask`` (one row a
        file), or a per-utterance (F, n_frames) array where ``idx`` is one
        int.  ``fs`` defaults to the corpus rate."""
        if fs is None:
            fs = self.fs
        if idx is None:
            idx = list(range(len(self.x_wavfiles)))
        if irm is not None and mask is not None and \
                len(irm) != len(self.x_wavfiles):
            # row j must be utterance j: tensors cut by maxlen would mask
            # the wrong files
            raise ValueError(
                f"irm has {len(irm)} sequence rows but the corpus has "
                f"{len(self.x_wavfiles)} files; tensors built with maxlen "
                "chunking cannot drive reconstruction -- rebuild them with "
                "maxlen=None (one full-length row per wav file, as "
                "pipeline.reconstruct_split does)")
        if isinstance(idx, (list, tuple, np.ndarray)):
            results = []
            for j in idx:
                m = None
                if irm is not None and mask is not None:
                    m = irm[j, : int(np.sum(mask[j])), :].T
                    nf = int(self.fidx[j, 1] - self.fidx[j, 0])
                    if m.shape[1] != nf:
                        raise ValueError(
                            f"mask row {j} covers {m.shape[1]} frames but "
                            f"utterance {j} has {nf}: the tensors were "
                            "built with a truncating maxlen; rebuild with "
                            "maxlen=None for reconstruction")
                yest = self.reconstruct_x(j, mask=m)
                if test:
                    x = wavread(self.x_wavfiles[j])[0:1]
                    yest_c = yest[:, : x.shape[1]]
                    results.append(float(np.mean((x - yest_c) ** 2)
                                         / np.mean(x**2)))
                else:
                    out = self.enhanced_path(j, description)
                    os.makedirs(os.path.dirname(out), exist_ok=True)
                    wavwrite(out, fs, yest)
            return results if test else None
        yest = self.reconstruct_x(idx, mask=irm)
        out = self.enhanced_path(idx, description)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        wavwrite(out, fs, yest)

    # -- tensors -----------------------------------------------------------

    def get_padded_data_matrix(self, transform_x=None, transform_y=None,
                               pad_value=0.0, maxlen=None):
        from .batching import reshape_and_pad_stacks

        return reshape_and_pad_stacks(
            self.x_stack, self.y_stack, self.fidx,
            transform_x=transform_x, transform_y=transform_y,
            pad_value=pad_value, maxlen=maxlen)
