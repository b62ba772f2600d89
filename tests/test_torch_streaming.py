"""The port's online path (drnmf_torch.streaming, drnmf_torch.serve) on the
CPU: against the port's offline ``enhance_signals`` and against the JAX
package's streamers, same signals and same parameters, for a frozen-U model
(recurrence through B1's plain version) and a dense-U model (through B3's).

Tolerance rtol 1e-4 / atol 1e-5 on waveforms, as tests/test_torch_enhance.py:
f32 FFTs, recurrence and overlap-add on both sides in different summation
orders (the streamer adds a block's frames first and the carry after).
Every socket and join has a timeout."""

import dataclasses
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from drnmf_tpu.models import DRNMFConfig as JaxConfig
from drnmf_tpu.models import init_drnmf_params as jax_init
from drnmf_tpu.streaming import MultiStreamEnhancer as JaxMulti
from drnmf_tpu.streaming import StreamingEnhancer as JaxStreaming
from drnmf_torch import MultiStreamEnhancer, StreamingEnhancer, serve
from drnmf_torch.convert import params_from_numpy
from drnmf_torch.enhance import enhance_signals
from drnmf_torch.models.drnmf import DRNMFConfig, ensure_fold_valid
from drnmf_torch.ops import drnmf_scan
from drnmf_torch.streaming import paced_load, paced_stats
from drnmf_torch.train.checkpoint import save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FFT, HOP = 64, 16
F, R = N_FFT // 2 + 1, 4
TOL = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(K_layers=2, r=R, alph=10.0, lam1=0.5,
             params_untied=["log_D", "log_alph"],
             params_trainable=["log_D", "log_alph"])


def _model(kind, seed=7654):
    """(JAX config, port config, params as numpy).  ``dense``: U trains and
    has left its init form, so the port routes the recurrence to B3's
    function; ``frozen``: the shipped configuration, B1's."""
    rng = np.random.default_rng(seed)
    kw = dict(input_dim=F, output_dim=F, **MODEL)
    kw["params_untied"] = tuple(kw["params_untied"])
    kw["params_trainable"] = tuple(kw["params_trainable"])
    if kind == "dense":
        kw["params_trainable"] += ("log_U1", "log_Uk")
    w = rng.uniform(0.05, 1.0, (F, 2 * R)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    jcfg = JaxConfig(matmul_precision="highest", **kw)
    params = {k: np.array(v) for k, v in jax_init(jcfg, w).items()}
    if kind == "dense":
        for name in ("log_U1", "log_Uk"):
            params[name] = params[name] + rng.uniform(
                0.0, 0.5, params[name].shape).astype(np.float32)
    return jcfg, DRNMFConfig(**kw), params


def _offline(tcfg, params, x):
    return enhance_signals(params_from_numpy(params, "cpu"), tcfg, [x],
                           N_FFT, HOP, device="cpu")[0]


def _chunks(x, sizes=(7, 250, 1, 999, 123, 800)):
    out, i = [], 0
    for size in sizes:
        out.append(x[i:i + size])
        i += size
    out.append(x[i:])
    return out


@pytest.mark.parametrize("kind", ["frozen", "dense"])
@pytest.mark.parametrize("block_frames", [1, 4, 16])
def test_streaming_matches_offline_and_jax(kind, block_frames):
    """Odd chunk sizes through ``StreamingEnhancer``: the concatenated
    output equals the port's offline enhancer and the JAX streamer."""
    jcfg, tcfg, params = _model(kind)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(3000) * 0.2).astype(np.float32)
    scanned = []
    plain = (drnmf_scan.drnmf_scan_dense_reference if kind == "dense"
             else drnmf_scan.drnmf_scan_factored_reference)

    def scan(*args):  # the route's function, one call per block
        scanned.append(tuple(args[0].shape))
        return plain(*args)

    enh = StreamingEnhancer(params, tcfg, N_FFT, HOP,
                            block_frames=block_frames, device="cpu",
                            scan_fn=scan)
    ref = JaxStreaming(params, jcfg, N_FFT, HOP, block_frames=block_frames)
    got, want = [], []
    for c in _chunks(x):
        got.append(enh.process(c))
        want.append(ref.process(c))
        assert len(got[-1]) == len(want[-1])
    got.append(enh.flush())
    want.append(ref.flush())
    got, want = np.concatenate(got), np.concatenate(want)
    assert scanned and set(scanned) == {(1, block_frames, F)}
    assert got.dtype == np.float32 and len(got) == len(want)
    np.testing.assert_allclose(got, want, **TOL)
    offline = _offline(tcfg, params, x)
    assert len(got) >= len(offline)
    np.testing.assert_allclose(got[:len(offline)], offline, **TOL)

    # the default route (no scan_fn) gives the same samples on the CPU
    enh2 = StreamingEnhancer(params, tcfg, N_FFT, HOP,
                             block_frames=block_frames, device="cpu")
    again = np.concatenate([enh2.process(x), enh2.flush()])
    np.testing.assert_allclose(again, got, rtol=0, atol=2e-6)


def test_streaming_reset_flush_latency_and_short_signal():
    jcfg, tcfg, params = _model("frozen")
    rng = np.random.default_rng(2)
    enh = StreamingEnhancer(params, tcfg, N_FFT, HOP, block_frames=8,
                            device="cpu")
    assert enh.latency_samples == 7 * HOP + N_FFT
    # a dribble below the latency bound emits nothing
    assert enh.process(np.zeros(HOP, np.float32)).size == 0
    enh.reset()

    x = (rng.standard_normal(1200) * 0.2).astype(np.float32)
    a = np.concatenate([enh.process(x), enh.flush()])
    assert enh.flush().size == 0  # a second flush emits nothing
    with pytest.raises(RuntimeError, match="reset"):
        enh.process(x)
    enh.reset()
    b = np.concatenate([enh.process(x), enh.flush()])
    np.testing.assert_array_equal(a, b)

    # shorter than one block: flush alone gives the offline output
    short = (rng.standard_normal(50) * 0.2).astype(np.float32)
    enh.reset()
    out = np.concatenate([enh.process(short), enh.flush()])
    offline = _offline(tcfg, params, short)
    assert len(out) == -(-50 // HOP) * HOP >= len(offline)
    np.testing.assert_allclose(out[:len(offline)], offline, **TOL)
    ref = JaxStreaming(params, jcfg, N_FFT, HOP, block_frames=8)
    np.testing.assert_allclose(
        out, np.concatenate([ref.process(short), ref.flush()]), **TOL)

    # an empty stream flushes to nothing; dropout configs are refused
    enh.reset()
    assert enh.flush().size == 0
    with pytest.raises(NotImplementedError):
        StreamingEnhancer(params, dataclasses.replace(tcfg, dropout_U=0.1),
                          device="cpu")


@pytest.mark.parametrize("kind", ["frozen", "dense"])
def test_multistream_equals_per_stream_and_jax(kind):
    """Streams advanced under a rotating ``active`` schedule, then drained
    with ``flush_stream`` and a tail, equal dedicated ``StreamingEnhancer``s
    and the JAX ``MultiStreamEnhancer``; inactive rows keep ``h`` and
    ``acc`` bit for bit; a recycled slot restarts exactly."""
    jcfg, tcfg, params = _model(kind)
    rng = np.random.default_rng(3)
    S, block = 3, 4
    blk = block * HOP
    n_blocks, tails = [5, 3, 4], [7, 0, 2 * HOP + 3]
    sigs = [rng.uniform(-0.5, 0.5, (nb * blk + tl,)).astype(np.float32)
            for nb, tl in zip(n_blocks, tails)]
    multi = MultiStreamEnhancer(params, tcfg, S, n_fft=N_FFT, hop=HOP,
                                block_frames=block, device="cpu")
    ref = JaxMulti(params, jcfg, S, n_fft=N_FFT, hop=HOP, block_frames=block)
    assert multi.block_samples == blk
    got, want = [[] for _ in range(S)], [[] for _ in range(S)]
    fed = [0] * S
    schedule = [(0,), (1, 2), (0, 2), (0, 1), (2,), (0, 1), (2,), (0,)]
    for round_streams in schedule:
        act = np.zeros(S, bool)
        samples = np.zeros((S, blk), np.float32)
        for s in round_streams:
            if fed[s] < n_blocks[s]:
                act[s] = True
                samples[s] = sigs[s][fed[s] * blk:(fed[s] + 1) * blk]
                fed[s] += 1
        h_before, acc_before = multi._h.clone(), multi._acc.clone()
        # dispatch and fetch apart, as a serving coordinator calls them
        handle = multi.step_dispatch(samples, active=act)
        outs = multi.step_fetch(handle)
        ref_outs = ref.step(samples, active=act)
        idle = torch.from_numpy(~act)
        assert torch.equal(multi._h[idle], h_before[idle])
        assert torch.equal(multi._acc[idle], acc_before[idle])
        for s in range(S):
            assert (outs[s] is None) == (not act[s])
            if act[s]:
                got[s].append(outs[s])
                want[s].append(np.asarray(ref_outs[s]))
    assert fed == n_blocks
    for s in range(S):
        tail = sigs[s][n_blocks[s] * blk:]
        got[s].append(multi.flush_stream(s, tail=tail))
        want[s].append(ref.flush_stream(s, tail=tail))

    for s in range(S):
        single = StreamingEnhancer(params, tcfg, n_fft=N_FFT, hop=HOP,
                                   block_frames=block, device="cpu")
        alone = np.concatenate([single.process(sigs[s]), single.flush()])
        gs, ws = np.concatenate(got[s]), np.concatenate(want[s])
        assert len(gs) == len(alone) == len(ws)
        np.testing.assert_allclose(gs, alone, rtol=0, atol=2e-6,
                                   err_msg=f"stream {s}")
        np.testing.assert_allclose(gs, ws, err_msg=f"stream {s}", **TOL)
        offline = _offline(tcfg, params, sigs[s])
        np.testing.assert_allclose(gs[:len(offline)], offline,
                                   err_msg=f"stream {s}", **TOL)

    # flush_stream recycled every slot: a new stream starts from h0
    outs = multi.step(np.stack([sig[:blk] for sig in sigs]))
    fresh = StreamingEnhancer(params, tcfg, n_fft=N_FFT, hop=HOP,
                              block_frames=block, device="cpu")
    np.testing.assert_allclose(outs[1], fresh.process(sigs[1][:blk]),
                               rtol=0, atol=2e-6)
    multi.reset_stream(1)
    assert torch.equal(multi._h[1], multi._h0)
    assert not multi._acc[1].any()


def test_paced_load_on_stub():
    """paced_load against a stub enhancer: every stream's every block is
    served exactly once, one block per stream per step, and reply latencies
    are positive.  Timing bounds are loose: the tests share their host."""
    calls = []

    class Stub:
        n_streams = 4
        block_samples = 1024  # 64 ms at 16 kHz

        def step(self, samples, active=None):
            if active is None:
                active = np.ones(self.n_streams, bool)
            calls.append(np.asarray(active).copy())
            time.sleep(0.002)
            return [samples[i] if active[i] else None
                    for i in range(self.n_streams)]

    lat, taken = paced_load(Stub(), seconds=1.5, fs=16000)
    n_blocks = int(round(1.5 / (1024 / 16000.0)))
    assert list(taken) == [n_blocks] * 4
    assert all(len(v) == n_blocks for v in lat)
    assert all(x > 0 for v in lat for x in v)  # replies after capture
    st = paced_stats(lat, 1024 / 16000.0)
    assert set(st) == {"p50_ms", "p95_ms", "p99_ms", "drift_ms_per_quarter",
                       "keeps_up"}
    assert st["p95_ms"] >= st["p50_ms"] and st["p99_ms"] >= st["p95_ms"]
    assert 2 < len(calls) - 2 <= 4 * n_blocks  # paced, not full speed


def _recv_reply(sock):
    (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
    return np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")


def _client(sock, x, chunk):
    outs = []
    for i in range(0, len(x), chunk):
        part = np.asarray(x[i:i + chunk], np.float32)
        sock.sendall(struct.pack("<i", part.size) + part.tobytes())
        outs.append(_recv_reply(sock))
    sock.sendall(struct.pack("<i", 0))  # flush request
    outs.append(_recv_reply(sock))
    return np.concatenate(outs)


def _start_server(tmp_path, params, extra):
    """``python -m drnmf_torch.serve --device cpu --port 0`` in a process of
    its own; returns (process, port) once it prints where it listens."""
    cfg_path, ckpt = tmp_path / "params_unfolded_snmf_t.yaml", tmp_path / "m.npz"
    cfg_path.write_text(yaml.safe_dump(MODEL))
    save_checkpoint(str(ckpt), params)
    proc = subprocess.Popen(
        [sys.executable, "-m", "drnmf_torch.serve", "-c", str(cfg_path),
         "-m", str(ckpt), "--n-fft", str(N_FFT), "--hop", str(HOP),
         "--block-frames", "4", "--port", "0", "--device", "cpu", *extra],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(120, proc.kill)
    watchdog.daemon = True
    watchdog.start()
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("serving on "):
            port = int(line.split()[2].rsplit(":", 1)[1])
            return proc, port, watchdog
    proc.wait(timeout=10)
    raise AssertionError("server did not start:\n" + "".join(lines))


def _stop_server(proc, watchdog):
    try:
        proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    assert proc.returncode == 0


def test_serve_sequential_protocol_matches_offline(tmp_path):
    """The server's sequential mode, through ``main``: a dense-U checkpoint
    (``ensure_fold_valid`` turns the fold off) streamed in protocol chunks;
    the replies equal the offline pipeline."""
    _, tcfg, params = _model("frozen")
    rng = np.random.default_rng(4)
    params["log_U1"][0, 1] += 0.5  # the checkpoint breaks the fold
    tcfg = ensure_fold_valid(tcfg, params, verbose=False)
    assert not tcfg.fold_frozen_U
    x = (rng.standard_normal(2500) * 0.2).astype(np.float32)
    proc, port, watchdog = _start_server(tmp_path, params,
                                         ["--max-connections", "1"])
    try:
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=60) as sock:
            streamed = _client(sock, x, 600)
    finally:
        _stop_server(proc, watchdog)
    offline = _offline(tcfg, params, x)
    assert len(streamed) >= len(offline)
    np.testing.assert_allclose(streamed[:len(offline)], offline, **TOL)

    # the same protocol over a socket pair, in this process
    srv_sock, cli_sock = socket.socketpair()
    cli_sock.settimeout(60)
    err = []

    def run():
        try:
            serve.serve_connection(
                srv_sock, lambda: StreamingEnhancer(
                    params, tcfg, N_FFT, HOP, block_frames=8, device="cpu"),
                timeout=60)
        except Exception as e:  # surfaced below
            err.append(e)
        finally:
            srv_sock.close()

    th = threading.Thread(target=run)
    th.start()
    try:
        again = _client(cli_sock, x, 333)
    finally:
        cli_sock.close()
        th.join(timeout=60)
    assert not th.is_alive() and not err, err
    np.testing.assert_allclose(again[:len(offline)], offline, **TOL)


def test_serve_concurrent_clients_match_offline(tmp_path):
    """``--streams 3`` through ``main``: three concurrent clients with
    different lengths and chunk sizes through the event-loop server
    (``SelectorStreamServer``); each gets the offline pipeline's output for
    its own signal."""
    _, tcfg, params = _model("frozen")
    rng = np.random.default_rng(5)
    sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (2500, 1200, 3100)]
    chunks = [600, 257, 911]  # deliberately not block multiples
    proc, port, watchdog = _start_server(
        tmp_path, params, ["--streams", "3", "--max-connections", "3"])
    results, errs = [None] * 3, []

    def client(c):
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=60) as sock:
                results[c] = _client(sock, sigs[c], chunks[c])
        except Exception as e:  # surfaced below
            errs.append((c, e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        _stop_server(proc, watchdog)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    for c in range(3):
        offline = _offline(tcfg, params, sigs[c])
        assert results[c] is not None and len(results[c]) >= len(offline), c
        np.testing.assert_allclose(results[c][:len(offline)], offline,
                                   err_msg=f"client {c}", **TOL)
