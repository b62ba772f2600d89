"""Offline enhancement of a corpus with DR-NMF: each call hands one call's
signals to ``drnmf_torch.enhance.enhance_signals`` with its own defaults
(batches of 128, padded on the host to the longest signal's bucket, STFT,
the recurrence on kernel B1, heads and mask, iSTFT, trimmed waveforms back
on the host).  The corpus is made at set-up and cycled through."""

import numpy as np
import torch

from drnmf_torch import enhance
from drnmf_torch.dsp.stft import bucket_total
from drnmf_torch.config import drnmf_config_from_params
from drnmf_torch.convert import init_drnmf_params

from ..reference import drnmf as ref_drnmf
from ..reference import dsp as ref_dsp
from ..yardstick.bounds import drnmf_model_flops, factored_bounds
from ..yardstick.compare import waveform_gap
from ..yardstick.corpus import (dictionary, frames_of, offline_corpus,
                                pick_sample)

FAMILY = "drnmf"
RATE = "enhance_audio_s_per_s"
REFERENCE_ROWS = 8  # signals the reference runs at once


def model(config, seed_rng, device):
    """(program config, parameters on ``device``, dictionary, log_h0 draw):
    a model that starts from a random unit-norm dictionary drawn on the
    device, through the program's own initialisation."""
    f = config["n_fft"] // 2 + 1
    cfg = drnmf_config_from_params(config, f, config["mask_value"])
    gen = torch.Generator(device=device).manual_seed(
        int(seed_rng.integers(2 ** 62)))
    w = dictionary(gen, f, cfg.hidden_dim, device,
                   config["dictionary_power"])
    # the program draws its initial state's uniform(0, 1) values on the
    # host from the generator it is handed; the reference draws the same
    h0_seed = int(seed_rng.integers(2 ** 62))
    u_h0 = torch.rand((cfg.hidden_dim,),
                      generator=torch.Generator().manual_seed(h0_seed))
    params = init_drnmf_params(
        cfg, w.cpu().numpy(), generator=torch.Generator().manual_seed(h0_seed),
        device=device)
    return cfg, params, w, u_h0


class Driver:
    def __init__(self, config, traffic, seed, device, trace):
        rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.config = config
        self.cfg, self.params, self.w, self.u_h0 = model(config, rng,
                                                         self.device)
        fs = config["fs"]
        gen = torch.Generator(device=self.device).manual_seed(
            int(rng.integers(2 ** 62)))
        per_call = int(traffic["signals_per_call"][FAMILY])
        self.corpus = offline_corpus(traffic, per_call,
                                     int(traffic["distinct_calls"][FAMILY]),
                                     fs, rng, gen, self.device)
        self.audio_s = [sum(len(s) for s in c) / fs for c in self.corpus]
        self.frames = [int(frames_of([len(s) for s in c], config["n_fft"],
                                     config["hop"]).sum())
                       for c in self.corpus]
        self.sample = pick_sample(self.corpus,
                                  int(traffic["sample_per_call"][FAMILY]),
                                  rng)
        self.kept = {key: [] for key in self.sample}
        self.ran = set()  # the calls the window ran
        self.trace = trace
        self.stages = {}  # seconds by stage of the traced window's calls
        self.lap = None
        self.counters = {"calls": 0,
                         "stages": self.stages, "model_flops": 0.0,
                         "b1_bound_s": 0.0}
        self._warm()

    def _enhance(self, signals, lap=None):
        return enhance.enhance_signals(
            self.params, self.cfg, signals, self.config["n_fft"],
            self.config["hop"], device=self.device, lap=lap)

    def _warm(self):
        """One call on each padded shape that the corpus's batches take."""
        batch = 128  # enhance_signals' default
        seen = set()
        for signals in self.corpus:
            for b0 in range(0, len(signals), batch):
                chunk = signals[b0:b0 + batch]
                shape = (len(chunk), bucket_total(
                    max(len(s) for s in chunk), self.config["n_fft"],
                    self.config["hop"]))
                if shape not in seen:
                    seen.add(shape)
                    self._enhance(chunk)

    def call(self, i):
        c = i % len(self.corpus)
        if self.trace:
            if self.lap is None:  # the clock starts with the window
                self.lap = enhance.stage_clock(self.stages, self.device)
            self.lap("between_calls")
        out = self._enhance(self.corpus[c], self.lap)
        self.ran.add(c)
        for key in self.kept:
            if key[0] == c:
                self.kept[key].append(out[key[1]])
        signals = self.corpus[c]
        n2r, k = self.cfg.hidden_dim, self.cfg.K_layers
        f = self.cfg.input_dim
        cn = self.counters
        cn["calls"] += 1
        cn["model_flops"] += drnmf_model_flops(self.frames[c], f, n2r, k)
        cn["b1_bound_s"] += factored_bounds(len(signals), self.frames[c], f,
                                            n2r, k)["bound_s"]
        return self.audio_s[c]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def due(self):
        """The sampled signals of the calls the window ran."""
        return [key for key in self.sample if key[0] in self.ran]

    def answers(self):
        """(call, position) -> the waveforms the window produced for it."""
        return {key: self.kept[key] for key in self.due()}

    def reference_answers(self, precision="f32"):
        """(call, position) -> the reference's waveform."""
        n_fft, hop = self.config["n_fft"], self.config["hop"]
        params = ref_drnmf.init_params(self.config, self.w, self.u_h0)
        out = {}
        due = self.due()
        with torch.no_grad():
            for b0 in range(0, len(due), REFERENCE_ROWS):
                keys = due[b0:b0 + REFERENCE_ROWS]
                signals = [self.corpus[c][p] for c, p in keys]
                spec = ref_dsp.stft(signals, n_fft, hop, self.device)
                irm = ref_drnmf.ratio_mask(params, self.config, spec.abs(),
                                           precision)
                wav = ref_dsp.istft(spec * irm, n_fft, hop).cpu().numpy()
                for j, (key, s) in enumerate(zip(keys, signals)):
                    out[key] = wav[j, :len(s)]
        return out

    def release(self):
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision="f32"):
        self.release()
        return compare(self.answers(), self.reference_answers(precision))


def compare(got, want):
    """``wave_rel_l2``: the widest relative L2 gap between a waveform the
    window produced and the reference's, over every sampled signal and
    every call of the window that enhanced it; inf where a sampled signal
    has no answer."""
    pairs = [(g, want[key]) for key in want for g in got.get(key, [])]
    if any(not got.get(key) for key in want):
        return {"wave_rel_l2": float("inf")}
    return {"wave_rel_l2": waveform_gap([g for g, _ in pairs],
                                        [w for _, w in pairs])}
