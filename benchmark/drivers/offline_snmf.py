"""Offline enhancement of a corpus with the sparse-NMF baseline: each call
takes one call's signals through the program's STFT
(``drnmf_torch.dsp.stft``), the frame stack of their magnitudes
(``data.masked_seqs_to_frames``), ``models.snmf_enhancer.snmf_infer_irm``
(MU iterations with the dictionary frozen, kernels B4/B5, one chunk), the
mask on the complex STFT and the iSTFT, and trims each waveform, as
``pipeline._snmf_enhance`` and ``pipeline.reconstruct_split`` do, without
the files."""

import numpy as np
import torch

from drnmf_torch.config import snmf_params_from_config
from drnmf_torch.data.batching import masked_seqs_to_frames
from drnmf_torch.dsp.stft import bucket_total, istft_frames, stft_frames
from drnmf_torch.dsp.windows import sqrt_hann_periodic
from drnmf_torch.models import snmf_enhancer

from ..reference import dsp as ref_dsp
from ..reference import snmf as ref_snmf
from ..yardstick.bounds import snmf_bounds, snmf_model_flops
from ..yardstick.corpus import (dictionary, frames_of, offline_corpus,
                                pick_sample)
from .offline_drnmf import compare

FAMILY = "snmf"
RATE = "enhance_audio_s_per_s"


class Driver:
    def __init__(self, config, traffic, seed, device, trace):
        rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.config = config
        self.n_fft, self.hop = config["n_fft"], config["hop"]
        self.f = self.n_fft // 2 + 1
        self.n2r = 2 * int(config["r"])
        gen = torch.Generator(device=self.device).manual_seed(
            int(rng.integers(2 ** 62)))
        self.w = dictionary(gen, self.f, self.n2r, self.device,
                            config["dictionary_power"])
        self.w_host = self.w.cpu().numpy()
        self.params = snmf_params_from_config(config)
        self.iters = int(config["infer_max_iter"])
        self.window = torch.as_tensor(sqrt_hann_periodic(self.n_fft),
                                      device=self.device)
        fs = config["fs"]
        per_call = int(traffic["signals_per_call"][FAMILY])
        self.corpus = offline_corpus(traffic, per_call,
                                     int(traffic["distinct_calls"][FAMILY]),
                                     fs, rng, gen, self.device)
        self.audio_s = [sum(len(s) for s in c) / fs for c in self.corpus]
        self.frames = [frames_of([len(s) for s in c], self.n_fft, self.hop)
                       for c in self.corpus]
        self.sample = pick_sample(self.corpus,
                                  int(traffic["sample_per_call"][FAMILY]),
                                  rng)
        self.kept = {key: [] for key in self.sample}
        self.ran = set()  # the calls the window ran
        self.counters = {"calls": 0,
                         "model_flops": 0.0, "b4_bound_s": 0.0,
                         "b5_bound_s": 0.0}
        seen = set()
        for c in range(len(self.corpus)):  # each padded shape once
            shape = (len(self.corpus[c]), int(self.frames[c].sum()))
            if shape not in seen:
                seen.add(shape)
                self._enhance(c)

    def _enhance(self, c):
        signals, frames = self.corpus[c], self.frames[c]
        n_fft, hop = self.n_fft, self.hop
        total = max(bucket_total(len(s), n_fft, hop) for s in signals)
        batch = np.zeros((len(signals), total), np.float32)
        for row, s in enumerate(signals):
            batch[row, n_fft:n_fft + len(s)] = s
        wav = torch.from_numpy(batch).to(self.device)
        spec = stft_frames(wav, self.window, n_fft, hop)  # (B, T, F)
        t_idx = torch.arange(spec.shape[1], device=self.device)
        valid = t_idx[None, :] < torch.as_tensor(frames,
                                                 device=self.device)[:, None]
        x_frames = masked_seqs_to_frames(spec.abs(), valid[..., None])
        irm_frames, _ = snmf_enhancer.snmf_infer_irm(
            x_frames, self.w_host, self.params, max_iter=self.iters,
            frame_chunk=int(self.config["frame_chunk"]), device=self.device)
        # the frame stack back into the (B, T, F) layout
        irm = torch.zeros((self.f, valid.numel()), device=self.device)
        irm[:, valid.reshape(-1)] = torch.from_numpy(irm_frames).to(
            self.device)
        irm = irm.view(self.f, *valid.shape).permute(1, 2, 0)
        y = istft_frames(spec * irm, self.window, n_fft, hop)
        y = y.cpu().numpy()
        # the length of the per-signal iSTFT of its frames, edges cut
        return [y[row, n_fft:n_fft + hop * (frames[row] - 1) - n_fft]
                for row in range(len(signals))]

    def call(self, i):
        c = i % len(self.corpus)
        out = self._enhance(c)
        self.ran.add(c)
        for key in self.kept:
            if key[0] == c:
                self.kept[key].append(out[key[1]])
        n = int(self.frames[c].sum())
        bounds = snmf_bounds(self.f, self.n2r, n)
        cn = self.counters
        cn["calls"] += 1
        cn["model_flops"] += snmf_model_flops(n, self.f, self.n2r,
                                              self.iters)
        cn["b4_bound_s"] += self.iters * bounds["pass1"]["bound_s"]
        cn["b5_bound_s"] += self.iters * bounds["pass2"]["bound_s"]
        return self.audio_s[c]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def initial_h(self, c):
        """The program's initial activations of call ``c``: its first draw
        from a generator on the device seeded with the configuration's
        ``random_seed`` (``ops.snmf._prepare``), (2r, frames of the call)."""
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.params.random_seed))
        return torch.rand((self.n2r, int(self.frames[c].sum())),
                          generator=gen, device=self.device)

    def due(self):
        """The sampled signals of the calls the window ran."""
        return [key for key in self.sample if key[0] in self.ran]

    def answers(self):
        """(call, position) -> the waveforms the window produced for it."""
        return {key: self.kept[key] for key in self.due()}

    def reference_answers(self, precision="f32"):
        """(call, position) -> the reference's waveform, from the same
        initial activations, each frame's own column."""
        out = {}
        sparsity = float(self.params.sparsity)
        due = self.due()
        with torch.no_grad():
            for c in sorted({c for c, _ in due}):
                h_call = self.initial_h(c)
                for key in [k for k in due if k[0] == c]:
                    p = key[1]
                    s = self.corpus[c][p]
                    start = int(self.frames[c][:p].sum())
                    n = int(self.frames[c][p])
                    spec = ref_dsp.stft([s], self.n_fft, self.hop,
                                        self.device)[0]
                    h = ref_snmf.infer(spec.abs().T, self.w,
                                       h_call[:, start:start + n], sparsity,
                                       self.iters, precision)
                    irm = ref_snmf.ratio_mask(self.w, h, precision).T
                    wav = ref_dsp.istft((spec * irm)[None], self.n_fft,
                                        self.hop)
                    out[key] = wav[0, :self.hop * (n - 1)
                                   - self.n_fft].cpu().numpy()
                del h_call
        return out

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision="f32"):
        """``wave_rel_l2``: as for the DR-NMF enhancer."""
        self.release()
        return compare(self.answers(), self.reference_answers(precision))
