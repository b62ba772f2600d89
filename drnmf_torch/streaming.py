"""Streaming (online) enhancement: feed audio chunks, get enhanced audio out
(counterpart of ``drnmf_tpu/streaming.py``).

The DR-NMF recurrence carries one (2r,) state vector per stream, so the
model serves online with bounded latency:

    enh = StreamingEnhancer(params, config)
    for chunk in microphone():          # arbitrary chunk sizes
        play(enh.process(chunk))
    play(enh.flush())

The streamer replays the offline pipeline in blocks, so its output equals
``enhance_signals`` on the same signal up to f32 summation order:

* the sample buffer is primed with ``n_fft`` zeros (the reference's leading
  edge pad), so streamed frames equal offline frames;
* each block step processes ``block_frames`` frames: window -> rFFT ->
  magnitude -> the recurrence from the carried state, through
  ``models.drnmf.make_scan`` and so through kernel B1 (frozen-U model) or B3
  (dense-U model) on the card -> heads -> ratio mask -> irFFT -> overlap-add
  onto a carried (n_fft,) accumulator;
* a frame's overlap-add contribution is final ``hop`` samples at a time, so
  each block emits ``block_frames*hop`` samples; the first ``n_fft`` emitted
  samples are skipped (the reference's edge trim);
* ``flush`` zero-pads to a whole block.  Zero frames are not masked steps
  (``mask_value`` is -1): they run through the recurrence and, having a zero
  spectrum, add nothing to the overlap-add.

State lives where it is used: ``h`` and the accumulator stay tensors on the
device between steps; sample buffers and counters stay numpy on the host.

Latency: ``n_fft - hop`` samples of framing lookahead plus one block
(``block_frames * hop`` samples).  Lower ``block_frames`` for latency, raise
it for throughput.
"""

import time

import numpy as np
import torch

from .device import params_on_device, resolve_device
from .dsp.stft import overlap_add
from .dsp.windows import sqrt_hann_periodic
from .models.drnmf import DRNMFConfig, _h0, _heads, _ratio_mask, make_scan


def _make_block_step_multi(params, config: DRNMFConfig, n_fft: int, hop: int,
                           device, scan_fn=None):
    """Batched block step: (frames (S, k, n_fft), h (S, 2r), acc (S, n_fft),
    active (S,) bool or None) -> (out (S, k*hop), h', acc').  The S streams
    advance in lockstep through one recurrence launch.  ``active`` gates the
    state update per row: rows are independent, so inactive rows keep their
    h and acc bit for bit (and emit zeros) while active rows compute what an
    all-active step computes.  The model's matrices are prepared once."""
    window = torch.as_tensor(sqrt_hann_periodic(n_fft), device=device)
    syn = window * float(np.float32(2.0 / (n_fft / hop)))
    scan = make_scan(params, config)
    n2r = config.hidden_dim

    @torch.no_grad()
    def step(frames, h, acc, active=None):
        n_streams, k = frames.shape[0], frames.shape[1]
        spec = torch.fft.rfft(frames * window, dim=-1).to(torch.complex64)
        mag = spec.abs()  # (S, k, F)
        # every frame is a valid step: magnitudes never equal mask_value
        valid = torch.ones((n_streams, k), dtype=torch.bool, device=mag.device)
        hs = scan(mag, valid, scan_fn=scan_fn, state=h)
        h_fin = hs[:, -1, -n2r:]
        clean_est, noise_est = _heads(params, config, hs)
        irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)
        xr = torch.fft.irfft(spec * irm.to(spec.dtype), n=n_fft, dim=-1)
        # overlap-add the block in one pass, the carried accumulator added
        # at the front; the last n_fft - hop samples are not final yet and
        # become the new accumulator
        y = overlap_add(xr.to(torch.float32) * syn, hop)
        y[:, :n_fft] += acc
        out = y[:, : k * hop]
        acc_new = torch.nn.functional.pad(y[:, k * hop:], (0, hop))
        if active is None:
            return out, h_fin, acc_new
        m = active[:, None]
        return (torch.where(m, out, torch.zeros_like(out)),
                torch.where(m, h_fin, h), torch.where(m, acc_new, acc))

    return step


def _make_block_step(params, config: DRNMFConfig, n_fft: int, hop: int,
                     device, scan_fn=None):
    """One stream's block step: (frames (k, n_fft), h (2r,), acc (n_fft,))
    -> (out (k*hop,), h', acc')."""
    multi = _make_block_step_multi(params, config, n_fft, hop, device,
                                   scan_fn)

    def step(frames, h, acc):
        out, h, acc = multi(frames[None], h[None], acc[None])
        return out[0], h[0], acc[0]

    return step


def _frame_index(k: int, n_fft: int, hop: int):
    return np.arange(k)[:, None] * hop + np.arange(n_fft)[None, :]


def _check_inference(config: DRNMFConfig):
    if config.dropout_W or config.dropout_U:
        raise NotImplementedError(
            "streaming is an inference path; dropout configs are "
            "training-only")


class MultiStreamEnhancer:
    """Batched online enhancement of S independent streams in lockstep.

    Each stream has the semantics of :class:`StreamingEnhancer` (same edge
    pads, trims, carried state); the S per-block steps collapse into one.
    Each ``step`` consumes ``block_frames * hop`` samples from every ACTIVE
    stream (the ``active`` mask lets a server step only the streams with a
    block queued; the rest keep their state exactly) and returns the
    per-stream samples that became final.  A finished stream is drained with
    :meth:`flush_stream` (any trailing partial block goes in its ``tail``),
    which also recycles the slot for a new stream.

    ``device``: "cuda" (default; raises without a card) or "cpu".
    ``scan_fn`` replaces the recurrence's kernel wrapper (see
    ``models.drnmf._scan_hidden``).
    """

    def __init__(self, params, config: DRNMFConfig, n_streams: int,
                 n_fft: int = 512, hop: int = 128, block_frames: int = 16,
                 device="cuda", scan_fn=None):
        _check_inference(config)
        self.device = resolve_device(device)
        self.params = params_on_device(params, self.device)
        self.config = config
        self.n_streams = n_streams
        self.n_fft, self.hop, self.block = n_fft, hop, block_frames
        self._scan_fn = scan_fn
        self._step = _make_block_step_multi(self.params, config, n_fft, hop,
                                            self.device, scan_fn)
        self._h0 = _h0(self.params, config)
        self._h = self._h0[None, :].repeat(n_streams, 1)
        self._acc = torch.zeros((n_streams, n_fft), device=self.device)
        self._pinned = self.device.type == "cuda"
        # per-stream host state, exactly StreamingEnhancer.reset()'s
        self._buf = [np.zeros(n_fft, np.float32) for _ in range(n_streams)]
        self._skip = np.full(n_streams, n_fft, np.int64)
        self._n_in = np.zeros(n_streams, np.int64)
        self._emitted = np.zeros(n_streams, np.int64)
        self._idx = _frame_index(block_frames, n_fft, hop)
        self._single = None  # single-stream step for flush_stream, lazily

    @property
    def block_samples(self) -> int:
        return self.block * self.hop

    @torch.no_grad()
    def reset_stream(self, i: int):
        self._h[i] = self._h0  # in-place row writes
        self._acc[i] = 0.0
        self._buf[i] = np.zeros(self.n_fft, np.float32)
        self._skip[i] = self.n_fft
        self._n_in[i] = 0
        self._emitted[i] = 0

    def step(self, samples: np.ndarray, active=None):
        """samples: (S, block_frames*hop) new input per stream.  Returns a
        list of S arrays with each stream's enhanced samples that became
        final this step (shorter during the initial latency fill, exactly
        like StreamingEnhancer.process).

        ``active``: optional (S,) bool mask.  Inactive streams consume no
        input (their ``samples`` rows are ignored), keep their carried
        state exactly, and get ``None`` in the returned list; active rows'
        outputs are those of an all-active step."""
        return self.step_fetch(self.step_dispatch(samples, active))

    def step_dispatch(self, samples: np.ndarray, active=None):
        """First half of :meth:`step`: frame the input, queue the device
        step and advance all host-side bookkeeping.  Returns an opaque
        handle for :meth:`step_fetch`.

        On the card nothing here waits for the device: the frames go in
        from a pinned host buffer with a non-blocking copy, the step is
        queued, its output is copied into a pinned buffer and an event is
        recorded behind it, so a serving coordinator can gather the next
        batch meanwhile.  State is advanced here: exactly one
        ``step_fetch`` per dispatch, in dispatch order.  On the CPU the
        step runs in line."""
        S, n_fft, hop, k = self.n_streams, self.n_fft, self.hop, self.block
        if active is None:
            active = np.ones(S, bool)
        else:
            active = np.asarray(active, bool).reshape(S)
        samples = np.asarray(samples, np.float32).reshape(S, k * hop)
        need = (k - 1) * hop + n_fft
        frames_host = torch.zeros((S, k, n_fft), pin_memory=self._pinned)
        frames = frames_host.numpy()
        for s in range(S):
            if not active[s]:
                continue
            self._buf[s] = np.concatenate([self._buf[s], samples[s]])
            if len(self._buf[s]) < need:
                raise RuntimeError(f"stream {s} holds {len(self._buf[s])} "
                                   f"samples, a block needs {need}")
            frames[s] = self._buf[s][:need][self._idx]
            self._buf[s] = self._buf[s][k * hop:]
        active_dev = torch.from_numpy(active)
        if self._pinned:
            active_dev = active_dev.pin_memory()
        out, self._h, self._acc = self._step(
            frames_host.to(self.device, non_blocking=True), self._h,
            self._acc, active_dev.to(self.device, non_blocking=True))
        event = None
        if self._pinned:
            out_host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            out_host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            out_host = out
        self._n_in += np.where(active, k * hop, 0)
        cuts = np.full(S, -1, np.int64)  # -1: inactive
        L = k * hop  # static per-stream output length
        for s in range(S):
            if not active[s]:
                continue
            cut = int(min(self._skip[s], L))
            self._skip[s] -= cut
            self._emitted[s] += L - cut
            cuts[s] = cut
        return out_host, event, cuts

    def step_fetch(self, handle):
        """Second half of :meth:`step`: wait for the device result of a
        :meth:`step_dispatch` handle (its event, from any thread) and return
        the per-stream finals list (``None`` for streams inactive in that
        dispatch)."""
        out_host, event, cuts = handle
        if event is not None:
            event.synchronize()
        out = out_host.numpy()
        return [None if cuts[s] < 0 else out[s][cuts[s]:].copy()
                for s in range(self.n_streams)]

    def flush_stream(self, i: int, tail=None) -> np.ndarray:
        """Drain stream ``i``: emit exactly what the offline pipeline would
        produce for its signal (``ceil(n/hop)*hop`` samples total, minus
        what :meth:`step` already returned for it), exactly like
        :meth:`StreamingEnhancer.flush`.  ``tail`` carries the stream's
        final partial block (``step`` only accepts whole blocks).  The slot
        is reset afterwards, ready for a new stream."""
        n_fft, hop, k = self.n_fft, self.hop, self.block
        if self._single is None:
            self._single = _make_block_step(self.params, self.config, n_fft,
                                            hop, self.device, self._scan_fn)
        buf = self._buf[i]
        n_in = int(self._n_in[i])
        if tail is not None:
            tail = np.asarray(tail, np.float32).reshape(-1)
            buf = np.concatenate([buf, tail])
            n_in += len(tail)
        target = (-(-n_in // hop)) * hop if n_in else 0
        h, acc = self._h[i], self._acc[i]
        skip, emitted = int(self._skip[i]), int(self._emitted[i])
        need = (k - 1) * hop + n_fft
        outs = []
        while emitted < target:
            buf = np.concatenate([buf, np.zeros(k * hop, np.float32)])
            while len(buf) >= need and emitted < target:
                frames = torch.from_numpy(buf[:need][self._idx])
                out, h, acc = self._single(frames.to(self.device), h, acc)
                buf = buf[k * hop:]
                out = out.cpu().numpy()
                cut = min(skip, len(out))
                out, skip = out[cut:], skip - cut
                if out.size:
                    take = out[: target - emitted]
                    emitted += len(take)
                    outs.append(take)
        self.reset_stream(i)
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)


class StreamingEnhancer:
    """Stateful online enhancer over a trained DR-NMF model.

    ``process`` accepts float32 mono samples of any length and returns the
    enhanced samples that became final; ``flush`` drains the tail.  The
    concatenated output equals the offline mask-and-iSTFT pipeline on the
    same signal.  ``device`` and ``scan_fn``: see
    :class:`MultiStreamEnhancer`.
    """

    def __init__(self, params, config: DRNMFConfig, n_fft: int = 512,
                 hop: int = 128, block_frames: int = 64, device="cuda",
                 scan_fn=None):
        _check_inference(config)
        self.device = resolve_device(device)
        self.params = params_on_device(params, self.device)
        self.config = config
        self.n_fft, self.hop, self.block = n_fft, hop, block_frames
        self._step = _make_block_step(self.params, config, n_fft, hop,
                                      self.device, scan_fn)
        self._h0 = _h0(self.params, config)
        self._idx = _frame_index(block_frames, n_fft, hop)
        self.reset()

    def reset(self):
        n_fft = self.n_fft
        self._buf = np.zeros(n_fft, np.float32)  # leading edge pad
        self._h = self._h0
        self._acc = torch.zeros((n_fft,), device=self.device)
        self._to_skip = n_fft  # trailing counterpart of the edge pad trim
        self._n_in = 0
        self._emitted = 0
        self._finished = False

    @property
    def latency_samples(self) -> int:
        """Worst-case samples buffered before output emerges."""
        return (self.block - 1) * self.hop + self.n_fft

    def _run_blocks(self):
        hop, k = self.hop, self.block
        need = (k - 1) * hop + self.n_fft
        outs = []
        while len(self._buf) >= need:
            frames = torch.from_numpy(self._buf[:need][self._idx])
            out, self._h, self._acc = self._step(
                frames.to(self.device), self._h, self._acc)
            self._buf = self._buf[k * hop:]
            out = out.cpu().numpy()
            if self._to_skip:
                cut = min(self._to_skip, len(out))
                out = out[cut:]
                self._to_skip -= cut
            if out.size:
                self._emitted += len(out)
                outs.append(out)
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)

    def process(self, samples) -> np.ndarray:
        if self._finished:
            raise RuntimeError("stream flushed; call reset() to reuse")
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._n_in += len(samples)
        self._buf = np.concatenate([self._buf, samples])
        return self._run_blocks()

    def flush(self) -> np.ndarray:
        """Drain: emit exactly what the offline pipeline would produce for
        the signal seen so far (ceil(n/hop)*hop samples total, minus what
        ``process`` already emitted).  The stream is finished afterwards;
        ``reset()`` before reuse."""
        if self._finished:
            return np.zeros(0, np.float32)
        self._finished = True
        hop = self.hop
        n_blocks = -(-self._n_in // hop) if self._n_in else 0
        total_target = n_blocks * hop  # offline trimmed output length
        # pad with zeros until every needed frame has been processed; zero
        # frames contribute nothing (mask * 0 spectrum == 0)
        outs = []
        while self._emitted < total_target:
            deficit = total_target - self._emitted
            self._buf = np.concatenate(
                [self._buf, np.zeros(self.block * hop, np.float32)])
            out = self._run_blocks()
            if out.size:
                outs.append(out[:deficit])
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# server-internal paced-load harness
# ---------------------------------------------------------------------------

def paced_load(multi, seconds: float = 20.0, fs: int = 16000,
               gather_frac: float = 0.25, seed: int = 7654):
    """Paced real-time load generated inside the calling process: no
    sockets, no per-client threads or processes.

    Arrival times are computed from each stream's capture schedule (stream
    i's block k is fully captured at ``t0 + phase_i + (k+1) * block_dur``)
    instead of delivered through the OS, so the only wall-clock consumers
    are this loop and the device step, the quantity under test.  The
    batching policy is the event-loop server's coordinator
    (``serve.SelectorStreamServer``): step as soon as every live stream has
    a block, else wait up to ``gather_frac`` blocks for near-simultaneous
    arrivals, one block per stream per step, backlogged streams catching up
    one block per step.

    Returns (lat, taken): ``lat[i]`` is stream i's per-block reply latency
    list in seconds (completion wall time minus the block's capture time),
    ``taken[i]`` the number of blocks served.
    """
    S = multi.n_streams
    blk = multi.block_samples
    block_dur = blk / fs
    n_blocks = max(2, int(round(seconds / block_dur)))
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, block_dur, S)
    chunks = 0.1 * rng.standard_normal((S, blk)).astype(np.float32)

    # warm-up and latency fill outside the paced clock
    multi.step(chunks, np.ones(S, bool))
    multi.step(chunks)

    taken = np.zeros(S, np.int64)
    lat = [[] for _ in range(S)]
    t0 = time.monotonic() + 0.01

    def arrival(i, k):
        return t0 + phase[i] + (k + 1) * block_dur

    deadline = None
    while np.any(taken < n_blocks):
        now = time.monotonic()
        avail = np.floor((now - t0 - phase) / block_dur).astype(np.int64)
        avail = np.minimum(avail, n_blocks)
        live = taken < n_blocks
        ready = (avail > taken) & live
        if not ready.any():
            deadline = None
            nxt = min(arrival(i, taken[i]) for i in np.nonzero(live)[0])
            time.sleep(max(0.0, min(nxt - time.monotonic(), 0.25)))
            continue
        if ready.sum() < live.sum():
            # the server's gather window: near-simultaneous arrivals ride
            # one full-batch step instead of splitting across two
            if deadline is None:
                deadline = now + gather_frac * block_dur
            if now < deadline:
                time.sleep(min(2e-3, deadline - now))
                continue
        deadline = None
        active = ready.copy()
        multi.step(chunks, active)
        done_t = time.monotonic()
        for i in np.nonzero(active)[0]:
            lat[i].append(done_t - arrival(i, int(taken[i])))
            taken[i] += 1
    return lat, taken


def paced_stats(lat, block_dur: float):
    """Summary of :func:`paced_load` latencies: percentiles (ms), mean
    drift between the 2nd and last quarter of each stream's run (ms;
    positive = falling behind), and whether the load keeps up (latency
    stationary to within a quarter block)."""
    all_lat = np.concatenate([np.asarray(v[1:]) for v in lat if len(v) > 1])
    p50, p95, p99 = np.percentile(all_lat, [50, 95, 99]) * 1e3
    drifts = []
    for v in lat:
        a = np.asarray(v[1:])
        q = len(a) // 4
        if q >= 1:
            drifts.append(a[-q:].mean() - a[q : 2 * q].mean())
    drift = float(np.mean(drifts)) * 1e3 if drifts else 0.0
    return {
        "p50_ms": round(float(p50), 1),
        "p95_ms": round(float(p95), 1),
        "p99_ms": round(float(p99), 1),
        "drift_ms_per_quarter": round(drift, 1),
        "keeps_up": bool(drift < 0.25 * block_dur * 1e3),
    }
