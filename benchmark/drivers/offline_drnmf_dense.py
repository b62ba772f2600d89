"""Offline enhancement with a DR-NMF whose recurrence U was trained (dense
U, kernel B3): the DR-NMF offline driver (``offline_drnmf.py``) with the
seeded U of ``reference/drnmf_dense.py`` handed to the program and drawn
again by the reference.  Its calls go through
``drnmf_torch.enhance.enhance_signals`` as that driver's do (batches of
128 padded to the longest signal's bucket); the model's ``log_U1`` and
``log_Uk`` are trainable, so the recurrence runs on B3, never B1.  It reads
the traffic's ``drnmf`` keys and counts the dense model's operations and
B3's least time (``yardstick/dense_bounds.py``)."""

import numpy as np
import torch

from drnmf_torch import enhance

from ..reference import drnmf as ref_drnmf
from ..reference import dsp as ref_dsp
from ..reference.drnmf_dense import draw_log_u
from ..yardstick.corpus import frames_of
from ..yardstick.dense_bounds import dense_bounds, dense_model_flops
from . import offline_drnmf

RATE = offline_drnmf.RATE
BATCH = 128  # enhance_signals' default
U_STREAM = 0x55  # the seed's stream for U, apart from the parent's draws
compare = offline_drnmf.compare  # control.py reads the driver's compare


class Driver(offline_drnmf.Driver):
    def __init__(self, config, traffic, seed, device, trace):
        self.u_seed = int(np.random.default_rng([seed, U_STREAM]).integers(
            2 ** 62))
        super().__init__(config, traffic, seed, device, trace)
        f, n2r, k = self.cfg.input_dim, self.cfg.hidden_dim, self.cfg.K_layers
        self.b3_bound_s = [self._b3_bound_s(signals)
                           for signals in self.corpus]
        self.model_flops = [dense_model_flops(n, f, n2r, k)
                            for n in self.frames]
        del self.counters["b1_bound_s"]
        self.counters["b3_bound_s"] = 0.0

    def _warm(self):
        """The trained U goes in first; then the parent's warm-up, one
        call on each padded shape."""
        log_u1, log_uk = draw_log_u(self.config, self.u_seed)
        self.params["log_U1"] = log_u1.to(self.device)
        self.params["log_Uk"] = log_uk.to(self.device)
        super()._warm()

    def _b3_bound_s(self, signals):
        """B3's least time for a call of ``signals``: one launch a batch."""
        n_fft, hop = self.config["n_fft"], self.config["hop"]
        f, n2r, k = self.cfg.input_dim, self.cfg.hidden_dim, self.cfg.K_layers
        total = 0.0
        for b0 in range(0, len(signals), BATCH):
            frames = frames_of([len(s) for s in signals[b0:b0 + BATCH]],
                               n_fft, hop)
            total += dense_bounds(len(frames), int(frames.max()),
                                  int(frames.sum()), f, n2r, k)["bound_s"]
        return total

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
        cn = self.counters
        cn["calls"] += 1
        cn["model_flops"] += self.model_flops[c]
        cn["b3_bound_s"] += self.b3_bound_s[c]
        return self.audio_s[c]

    def reference_answers(self, precision="f32"):
        """(call, position) -> the reference's waveform, with the U drawn
        again on the reference's side."""
        n_fft, hop = self.config["n_fft"], self.config["hop"]
        params = ref_drnmf.init_params(self.config, self.w, self.u_h0)
        log_u1, log_uk = draw_log_u(self.config, self.u_seed)
        params["log_U1"] = log_u1.to(self.device)
        params["log_Uk"] = log_uk.to(self.device)
        out = {}
        due = self.due()
        with torch.no_grad():
            rows = offline_drnmf.REFERENCE_ROWS
            for b0 in range(0, len(due), rows):
                keys = due[b0:b0 + rows]
                signals = [self.corpus[c][p] for c, p in keys]
                spec = ref_dsp.stft(signals, n_fft, hop, self.device)
                irm = ref_drnmf.ratio_mask(params, self.config, spec.abs(),
                                           precision)
                wav = ref_dsp.istft(spec * irm, n_fft, hop).cpu().numpy()
                for j, (key, s) in enumerate(zip(keys, signals)):
                    out[key] = wav[j, :len(s)]
        return out
