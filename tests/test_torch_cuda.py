"""Kernels B1 to B5, the enhancers (batch and streaming) and sparse NMF on
the card, against their plain versions and the CPU.

These are the port's card checks over grids of shapes; ``chip_smoke.py``
times the kernels at the paths' own shapes, holds only what belongs to
those shapes (the kernels at 256 x 1,021 rows x steps, the SNMF passes
over 140,000 frames, the train step at 32 x 500) and drives the paths.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither jax nor drnmf_tpu, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-5 on hidden states: f32 on both sides, the
kernel summing the thin products in another order than cuBLAS.  B4/B5:
rtol 1e-4 of each output's largest entry (f32 on both sides, sums over up
to 4,099 frames in another order).  B3: operands drawn so that every term
moves the output; rtol 1e-4 / atol 1e-5 as B1 (three TF32 products a term,
the tensor cores' sums promoted to f32 every 128 terms: f32-class, summed
in another order than cuBLAS).  B2 against B1: rtol 1e-4 / atol 1e-5
(they sum in different orders; B2 as B3 on the tensor cores); a repeat of
B1, B2 or B3 is bit-equal.  Training: the backward kernel against its
plain version on the same layer stack at rtol 1e-4 / atol 1e-5 (f32 on
both sides, its products summed in another order than cuBLAS); the
model's gradients through the kernels within 1e-4 of each gradient's
largest entry of those through the plain versions.  Each test walks its
cases and names them in a failure message.
"""

import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from drnmf_torch.convert import init_drnmf_params
from drnmf_torch.enhance import enhance_signals
from drnmf_torch.models import batched_grad, drnmf
from drnmf_torch.ops import drnmf_scan, snmf, snmf_mu
from drnmf_torch.train.losses import masked_mse_signal_approx
from drnmf_torch.streaming import MultiStreamEnhancer, StreamingEnhancer

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel B1 has no CPU mode)")
    return torch.device("cuda")


def _model(seed, f, r, K, device, **overrides):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = drnmf.DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                            **{"alph": 10.0, "lam1": 0.5, **overrides})
    params = init_drnmf_params(cfg, w,
                               generator=torch.Generator().manual_seed(seed),
                               device=device)
    return cfg, params, rng


SHAPES = [  # (B, T, F, r)
    (1, 1, 9, 8),  # one row, one step
    (1, 11, 9, 8),
    (2, 11, 9, 8),
    (3, 11, 9, 8),  # the Pallas hold-out shape, one row masked
    (5, 13, 9, 8),  # odd B: the last block has a row past the batch
    (4, 9, 17, 12),
    (3, 7, 33, 7),  # odd 2r
    (6, 4, 65, 100),
    (9, 5, 129, 64),
    (33, 3, 257, 50),
    (7, 6, 257, 1000),  # flagship widths
    (256, 3, 257, 1000),  # flagship batch
    # flagship widths at B2's plans: chain B empty, one row a chain, 8-
    # column tiles with chains of 9 and 8 rows, 32 rows a chain, 7 tiles
    (1, 4, 257, 1000),
    (2, 4, 257, 1000),
    (17, 3, 257, 1000),
    (64, 3, 257, 1000),
    (100, 2, 257, 1000),
]


def _kernel_matches_plain_version(device):
    for shape in SHAPES:
        for K in (1, 2, 3, 5):
            for untie_alph in (False, True):
                case = "B%d_T%d_F%d_r%d" % shape + f" K={K} untied={untie_alph}"
                bsz, t_len, f, r = shape
                cfg, params, rng = _model(0, f, r, K, device,
                                          untie_alph=untie_alph)
                x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
                # a row held from step 7
                x[bsz // 2, min(7, t_len - 1):] = cfg.mask_value
                x = torch.from_numpy(x).to(device)
                args = drnmf.factored_scan_operands(
                    params, cfg, x,
                    drnmf.step_mask_from_input(x, cfg.mask_value))
                before = dict(drnmf_scan.LAUNCHES)
                out = drnmf_scan.drnmf_scan_factored(*args)
                again = drnmf_scan.drnmf_scan_factored(*args)
                inter = drnmf_scan.drnmf_scan_factored(*args, interleave=True)
                inter_again = drnmf_scan.drnmf_scan_factored(*args,
                                                             interleave=True)
                torch.cuda.synchronize()
                assert drnmf_scan.LAUNCHES == {
                    **before, "factored": before["factored"] + 2,
                    "interleaved": before["interleaved"] + 2}, case
                assert torch.equal(out, again), case  # fixed summation order
                assert torch.equal(inter, inter_again), f"B2 {case}"
                ref = drnmf_scan.drnmf_scan_factored_reference(*args)
                for name, got in (("B1", out), ("B2", inter)):
                    np.testing.assert_allclose(
                        got.cpu().numpy(), ref.cpu().numpy(),
                        err_msg=f"{name} {case}", **TOL)
                # B2 sums in another order than B1
                np.testing.assert_allclose(inter.cpu().numpy(),
                                           out.cpu().numpy(),
                                           err_msg=f"B2 vs B1 {case}", **TOL)


def _row_bits_do_not_depend_on_the_batch(device):
    """At the flagship widths, the first 64 rows of a 256-row call run as a
    64-row call, and rows 0, 63 and 255 run alone, equal the same rows of
    the 256-row call bit for bit (B1's sums do not depend on the tile)."""
    cfg, params, rng = _model(0, 257, 1000, 5, device)
    x = rng.uniform(0, 1, (256, 6, 257)).astype(np.float32)
    x[63, 4:] = cfg.mask_value  # a held row among them
    x = torch.from_numpy(x).to(device)
    args = drnmf.factored_scan_operands(
        params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
    full = drnmf_scan.drnmf_scan_factored(*args)

    def rows(sel):
        return [a[sel].contiguous() if i in (0, 1, 2) else a
                for i, a in enumerate(args)]

    assert torch.equal(drnmf_scan.drnmf_scan_factored(*rows(slice(0, 64))),
                       full[:64])
    for row in (0, 63, 255):
        alone = drnmf_scan.drnmf_scan_factored(*rows(slice(row, row + 1)))
        assert torch.equal(alone, full[row:row + 1]), row


class Refusing:
    """A kernel library whose entry ``name`` returns ``code``."""

    def __init__(self, lib, name, code):
        self.lib, self.name, self.code = lib, name, code

    def __getattr__(self, name):
        if name == self.name:
            return lambda *a: self.code
        return getattr(self.lib, name)


def _refused_launch_raises(device, kernel="factored"):
    """A launch the gate refuses (a device without cooperative launch, or
    an error from the launch itself) raises with the shapes, counts no
    launch and never runs the plain version: B1 (``factored``), B2
    (``interleaved``) or B3 (``dense``)."""
    kwargs = {}
    if kernel == "dense":
        args = _dense_args(np.random.default_rng(1), 3, 5, 9, 8, 3, device)
        name, library, entry = ("drnmf_scan_dense", "_dense_library",
                                "drnmf_scan_dense")
    else:
        cfg, params, rng = _model(1, 9, 8, 3, device)
        x = torch.from_numpy(rng.uniform(0, 1, (3, 5, 9)).astype(np.float32))
        x = x.to(device)
        args = drnmf.factored_scan_operands(
            params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
        name, library, entry = ("drnmf_scan_factored", "_library",
                                "drnmf_scan_factored")
        if kernel == "interleaved":
            library, entry = ("_interleaved_library",
                              "drnmf_scan_factored_interleaved")
            kwargs = {"interleave": True}
    wrapper = functools.partial(getattr(drnmf_scan, name), **kwargs)
    real = getattr(drnmf_scan, library)
    plain = getattr(drnmf_scan, name + "_reference")

    def must_not_run(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    setattr(drnmf_scan, name + "_reference", must_not_run)
    try:
        for refused, code, match in (
                (entry + "_capacity", 0, "no cooperative launch"),
                (entry, 9, "B=3, T=5, F=9, 2r=16, K=3")):
            refusing = Refusing(real(), refused, code)
            setattr(drnmf_scan, library, lambda: refusing)
            before = dict(drnmf_scan.LAUNCHES)
            with pytest.raises(RuntimeError, match=match):
                wrapper(*args)
            assert drnmf_scan.LAUNCHES == before, refused
            setattr(drnmf_scan, library, real)
    finally:
        setattr(drnmf_scan, library, real)
        setattr(drnmf_scan, name + "_reference", plain)


def _wrapper_rejects_malformed_operands(device):
    cfg, params, rng = _model(1, 9, 8, 3, device)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 5, 9)).astype(np.float32))
    x = x.to(device)
    good = drnmf.factored_scan_operands(
        params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
    for bad in ("dtype", "contiguity", "shape", "mask_dtype", "device"):
        args = list(good)
        if bad == "dtype":
            args[0] = args[0].double()
        elif bad == "contiguity":
            args[0] = x.transpose(0, 1).contiguous().transpose(0, 1)
        elif bad == "shape":
            args[6] = args[6][:, :-1]
        elif bad == "mask_dtype":
            args[1] = args[1].float()
        else:
            args[2] = args[2].cpu()
        before = dict(drnmf_scan.LAUNCHES)
        with pytest.raises((TypeError, ValueError)):
            drnmf_scan.drnmf_scan_factored(*args)
        with pytest.raises((TypeError, ValueError)):
            drnmf_scan.drnmf_scan_factored(*args, interleave=True)
        assert drnmf_scan.LAUNCHES == before, bad


def _enhance_matches_cpu(device):
    """enhance_signals on the card (B1) against the same call on the CPU
    (plain version): waveforms within rtol 1e-4 / atol 1e-5."""
    for n_fft, hop in ((256, 64), (512, 128)):
        for K in (1, 2):
            cfg, params, rng = _model(2, n_fft // 2 + 1, 8, K, device)
            sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                    for n in (2000, 3500, 2999)]
            before = drnmf_scan.LAUNCHES["factored"]
            on_card = enhance_signals(params, cfg, sigs, n_fft, hop,
                                      batch_size=2)
            assert drnmf_scan.LAUNCHES["factored"] == before + 2
            on_cpu = enhance_signals({k: v.cpu() for k, v in params.items()},
                                     cfg, sigs, n_fft, hop, batch_size=2,
                                     device="cpu")
            for a, b in zip(on_card, on_cpu):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{n_fft}/{hop} K={K}")


def _other_configs_run_plain_loop(device):
    """Configurations no kernel computes run the plain time loop on the
    card (counted as ``time_loop``), launch no kernel, and agree with the
    CPU."""
    for overrides in (
            dict(activation="tanh"), dict(factored_S=False),
            dict(activation="tanh", params_trainable=("log_D", "log_U1")),
            dict(return_all_hidden=True), dict(connect_input_to_layers=False)):
        cfg, params, rng = _model(3, 17, 12, 3, device, **overrides)
        x = torch.from_numpy(rng.uniform(0, 1, (3, 9, 17)).astype(np.float32))
        before = dict(drnmf_scan.LAUNCHES)
        on_card = drnmf.drnmf_forward(params, cfg, x.to(device),
                                      return_parts=True)
        torch.cuda.synchronize()
        assert drnmf_scan.LAUNCHES == {
            **before, "time_loop": before["time_loop"] + 1}, overrides
        on_cpu = drnmf.drnmf_forward({k: v.cpu() for k, v in params.items()},
                                     cfg, x, return_parts=True)
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       err_msg=str(overrides), **TOL)


DENSE_SHAPES = [  # (B, T, F, r); B3's batch tile after the #
    (1, 1, 9, 8),
    (3, 11, 9, 8),  # ragged everywhere: F=9, 2r=16, B=3, T=11
    (2, 9, 24, 4),
    (5, 7, 33, 7),  # odd 2r = 14: the weights' rows padded to 16
    (17, 5, 65, 50),  # # 32, 15 rows short
    (33, 4, 129, 64),  # # 64, 31 rows short
    (64, 3, 257, 100),
    (130, 2, 257, 200),  # three batch tiles, the last 2 rows wide
    (1, 3, 257, 1000),  # flagship widths: one stream, # 8
    (2, 3, 257, 1000),
    (12, 2, 257, 1000),  # # 16
    (17, 2, 257, 1000),  # # 32
    (64, 2, 257, 1000),  # the 64-stream step, # 64
    (100, 2, 257, 1000),  # the last tile 28 rows short
    (256, 2, 257, 1000),  # flagship widths and batch
]


def _dense_args(rng, bsz, t_len, f, r, K, device):
    """Operands of B3 at a scale where every term moves the output: U and
    S uniform in [0, 1/2r] (the state stays bounded), W unit-column / 10."""
    n2r = 2 * r

    def uniform(hi, *shape):
        return torch.from_numpy(
            rng.uniform(0.0, hi, shape).astype(np.float32)).to(device)

    x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
    if t_len > 1:
        x[bsz // 2, min(6, t_len - 1):] = -1.0  # a row held from step 6
    x = torch.from_numpy(x).to(device)
    w = uniform(1.0, K, f, n2r) + 0.05
    w = w / (w * w).sum(dim=1, keepdim=True).sqrt() / 10.0
    uk = uniform(1.0 / n2r, n2r, n2r)
    if K == 1:
        uk = torch.zeros_like(uk)
    return (x, drnmf.step_mask_from_input(x, -1.0),
            uniform(0.5, bsz, n2r), uniform(1.0 / n2r, n2r, n2r), uk,
            uniform(1.0 / n2r, max(1, K - 1), n2r, n2r), w,
            -uniform(0.05, K, n2r))


def _dense_kernel_matches_plain_version(device):
    rng = np.random.default_rng(6)
    for shape in DENSE_SHAPES:
        for K in (1, 2, 3, 5):
            if K == 5 and shape[3] == 1000 and shape[0] not in (1, 64, 256):
                continue  # 106 MB of weights: at the paths' batches
            case = "B%d_T%d_F%d_r%d" % shape + f" K={K}"
            args = _dense_args(rng, *shape, K, device)
            before = dict(drnmf_scan.LAUNCHES)
            out = drnmf_scan.drnmf_scan_dense(*args)
            again = drnmf_scan.drnmf_scan_dense(*args)
            torch.cuda.synchronize()
            assert drnmf_scan.LAUNCHES == {
                **before, "dense": before["dense"] + 2}, case
            assert torch.equal(out, again), case  # fixed summation order
            ref = drnmf_scan.drnmf_scan_dense_reference(*args)
            np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                       err_msg=case, **TOL)
            if K > 1:  # a dropped operand would show
                for drop in (4, 5):
                    cut = list(args)
                    cut[drop] = torch.zeros_like(cut[drop])
                    moved = drnmf_scan.drnmf_scan_dense_reference(*cut) - ref
                    assert moved.abs().max().item() > 1e-3, (case, drop)

    good = _dense_args(rng, 3, 5, 9, 8, 3, device)
    for bad in ("dtype", "contiguity", "shape", "device"):
        args = list(good)
        if bad == "dtype":
            args[3] = args[3].double()
        elif bad == "contiguity":
            args[3] = args[3].T
        elif bad == "shape":
            args[5] = args[5][:1]
        else:
            args[4] = args[4].cpu()
        before = dict(drnmf_scan.LAUNCHES)
        with pytest.raises((TypeError, ValueError)):
            drnmf_scan.drnmf_scan_dense(*args)
        assert drnmf_scan.LAUNCHES == before, bad


def _dense_model_and_streaming_match_cpu(device):
    """A dense-U model (trainable U, perturbed from the init form) and a
    frozen-U model: ``drnmf_forward`` and ``enhance_signals`` on the card
    launch B3 (B1) and agree with the CPU; so do ``StreamingEnhancer`` and
    ``MultiStreamEnhancer`` under an ``active`` mask, whose inactive rows
    keep their state bit for bit."""
    n_fft, hop, block = 64, 16, 4
    for dense in (True, False):
        over = (dict(params_trainable=("log_D", "log_alph", "log_U1",
                                       "log_Uk")) if dense else {})
        cfg, params, rng = _model(7, n_fft // 2 + 1, 6, 3, device, **over)
        if dense:
            for name in ("log_U1", "log_Uk"):
                params[name] = params[name] + torch.from_numpy(
                    rng.uniform(0.0, 0.5, params[name].shape)
                    .astype(np.float32)).to(device)
        which = "dense" if dense else "factored"
        cpu_params = {k: v.cpu() for k, v in params.items()}
        sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                for n in (900, 1500, 1201)]

        before = drnmf_scan.LAUNCHES[which]
        on_card = enhance_signals(params, cfg, sigs, n_fft, hop)
        assert drnmf_scan.LAUNCHES[which] == before + 1, which
        on_cpu = enhance_signals(cpu_params, cfg, sigs, n_fft, hop,
                                 device="cpu")
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=which)

        enh = StreamingEnhancer(params, cfg, n_fft, hop, block_frames=block)
        before = drnmf_scan.LAUNCHES[which]
        got = np.concatenate([enh.process(sigs[0][:333]),
                              enh.process(sigs[0][333:]), enh.flush()])
        assert drnmf_scan.LAUNCHES[which] > before, which
        np.testing.assert_allclose(got[:len(sigs[0])], on_cpu[0], rtol=1e-4,
                                   atol=1e-5, err_msg=which)

        blk = block * hop
        multis = [MultiStreamEnhancer(p, cfg, 3, n_fft, hop, block, device=d)
                  for p, d in ((params, device), (cpu_params, "cpu"))]
        outs = [[[] for _ in sigs] for _ in multis]
        fed = [0, 0, 0]
        for rnd in range(16):
            active = np.array([(rnd + s) % 3 != 0
                               and (fed[s] + 1) * blk <= len(sigs[s])
                               for s in range(3)])
            if not active.any():
                continue
            samples = np.zeros((3, blk), np.float32)
            for s in np.nonzero(active)[0]:
                samples[s] = sigs[s][fed[s] * blk:(fed[s] + 1) * blk]
                fed[s] += 1
            h_before = multis[0]._h.clone()
            acc_before = multis[0]._acc.clone()
            for m, o in zip(multis, outs):
                for s, y in enumerate(m.step(samples, active)):
                    assert (y is None) == (not active[s])
                    if y is not None:
                        o[s].append(y)
            idle = torch.from_numpy(~active).to(device)
            assert torch.equal(multis[0]._h[idle], h_before[idle])
            assert torch.equal(multis[0]._acc[idle], acc_before[idle])
        for m, o in zip(multis, outs):
            for s in range(3):
                o[s].append(m.flush_stream(s, tail=sigs[s][fed[s] * blk:]))
        for s in range(3):
            a, b = (np.concatenate(o[s]) for o in outs)
            assert len(a) == len(b) >= len(sigs[s])
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{which} stream {s}")
            np.testing.assert_allclose(a[:len(sigs[s])], on_cpu[s],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{which} stream {s}")


@pytest.mark.cuda
def test_dense_and_streaming_on_card(cuda):
    """B3 against its plain version over a grid of shapes (every batch
    tile, ragged edges, K = 1 with the dummy S, odd 2r, the flagship widths
    at 1, 2, 64 and 256 rows, K = 5 at 1, 64 and 256), each of uk and S
    moving the output, bit for bit reproducible; the wrapper's
    checks and a refused launch; a dense-U and a frozen-U model through the
    batch and the streaming enhancers against the CPU."""
    _dense_kernel_matches_plain_version(cuda)
    _refused_launch_raises(cuda, kernel="dense")
    _dense_model_and_streaming_match_cpu(cuda)


@pytest.mark.cuda
def test_on_card(cuda):
    """B1 and B2 against their plain version and each other over a grid of
    shapes (one row, one step, odd B and 2r, K = 1 with the dummy dkT, the
    flagship widths at 1, 2, 7, 17, 64, 100 and 256 rows; tied and untied
    alph), a bit-equal repeat of each, B1's row bits independent of its
    batch; the wrapper's checks and a refused launch of each; the enhancer
    on the card against the CPU; and the configurations that stay off every
    kernel."""
    _kernel_matches_plain_version(cuda)
    _row_bits_do_not_depend_on_the_batch(cuda)
    _wrapper_rejects_malformed_operands(cuda)
    _refused_launch_raises(cuda)
    _refused_launch_raises(cuda, kernel="interleaved")
    _enhance_matches_cpu(cuda)
    _other_configs_run_plain_loop(cuda)


SNMF_SHAPES = [  # (m, r, n)
    (17, 6, 40),  # the Pallas hold-out shape
    (1, 1, 1),
    (64, 64, 64),  # exactly one tile
    (65, 63, 129),  # one past / short of the tile everywhere
    (257, 100, 4099),  # F=257 and a ragged frame edge, n = 3 mod 4
    (8, 8, 130),  # m of one instruction column group, n = 2 mod 4
    (264, 50, 1030),  # m = 3 x 88 exactly, r not a multiple of 8
    (265, 129, 257),  # one past three 88-column tiles, 128 rows, 2 x 64
    (257, 2000, 1000),  # the dictionary's width
    (257, 2000, 4099),  # and a ragged frame edge
]


def _max_rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _snmf_passes_match_plain(device):
    rng = np.random.default_rng(4)
    for m, r, n in SNMF_SHAPES:
        for sparsity in (0.0, 0.7):
            case = f"m={m} r={r} n={n} sparsity={sparsity}"
            v = torch.from_numpy(
                rng.uniform(0.01, 1.0, (m, n)).astype(np.float32)).to(device)
            w = torch.from_numpy(
                rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)).to(device)
            w = w / (w * w).sum(dim=0, keepdim=True).sqrt()
            h = torch.from_numpy(
                rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)).to(device)
            before = dict(snmf_mu.LAUNCHES)
            out = snmf_mu.snmf_mu_pass1(v, h, w, sparsity)
            again = snmf_mu.snmf_mu_pass1(v, h, w, sparsity)
            div = snmf_mu.snmf_mu_pass2(v, out[0], w)
            div_again = snmf_mu.snmf_mu_pass2(v, out[0], w)
            torch.cuda.synchronize()
            assert snmf_mu.LAUNCHES == {"pass1": before["pass1"] + 2,
                                        "pass2": before["pass2"] + 2}, case
            for o, a in zip(out + (div,), again + (div_again,)):
                assert torch.equal(o, a), case  # no atomics: bit for bit
            ref = snmf_mu.snmf_mu_pass1_reference(v, h, w, sparsity)
            for name, o, rf in zip(("h_new", "a", "b", "sp_sum"), out, ref):
                assert o.shape == rf.shape, case
                if sparsity or name != "sp_sum":
                    assert _max_rel(o, rf) <= 1e-4, f"{case} {name}"
            # the divergence of an exact fit (m = r = n = 1) is the square
            # of lam's roundoff, so its floor is that of a lam off by 1e-5
            # of v: 1e-10 of sum(v^2)
            div_floor = 1e-10 * float((v * v).sum())
            div_ref = snmf_mu.snmf_mu_pass2_reference(v, out[0], w)
            assert float((div - div_ref).abs()) <= (
                1e-4 * float(div_ref) + div_floor), case

            # one whole iteration with half of W frozen
            w_mask = torch.arange(r, device=device) < r // 2
            it = snmf_mu.mu_ed_iteration(v, h, w, sparsity, w_mask)
            plain = snmf_mu.mu_ed_iteration(v, h, w, sparsity, w_mask,
                                            passes=snmf_mu.PLAIN_PASSES)
            for name, o, rf in zip(("h", "w", "div", "cost"), it, plain):
                floor = div_floor if name in ("div", "cost") else 0.0
                assert float((o - rf).abs().max()) <= (
                    1e-4 * float(rf.abs().max()) + floor), (
                        f"{case} iteration {name}")

    v = torch.rand((9, 20), device=device)
    h = torch.rand((4, 20), device=device)
    w = torch.rand((9, 4), device=device)
    for bad in ((v, h.cpu(), w), (v.double(), h, w), (v, h, w[:, :3]),
                (v, h.T.contiguous().T, w)):
        before = dict(snmf_mu.LAUNCHES)
        with pytest.raises((TypeError, ValueError)):
            snmf_mu.snmf_mu_pass1(*bad, 0.5)
        with pytest.raises((TypeError, ValueError)):
            snmf_mu.snmf_mu_pass2(*bad)
        assert snmf_mu.LAUNCHES == before

    # a launch the card refuses (here: a library that reports
    # cudaErrorInvalidConfiguration, as the kernels' own gate does) raises
    # with the shape, counts no launch and never runs the plain version
    class Refusing:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            if name in ("snmf_mu_pass1", "snmf_mu_pass2"):
                return lambda *args: 9
            return getattr(self.lib, name)

    real, plain = snmf_mu._library, (snmf_mu.snmf_mu_pass1_reference,
                                     snmf_mu.snmf_mu_pass2_reference)

    def must_not_run(*args):
        raise AssertionError("the plain version ran for a CUDA tensor")

    refusing = Refusing(real())
    snmf_mu._library = lambda: refusing
    snmf_mu.snmf_mu_pass1_reference = must_not_run
    snmf_mu.snmf_mu_pass2_reference = must_not_run
    try:
        before = dict(snmf_mu.LAUNCHES)
        with pytest.raises(RuntimeError, match="m=9, r=4, n=20"):
            snmf_mu.snmf_mu_pass1(v, h, w, 0.5)
        with pytest.raises(RuntimeError, match="m=9, r=4, n=20"):
            snmf_mu.snmf_mu_pass2(v, h, w)
        assert snmf_mu.LAUNCHES == before
    finally:
        snmf_mu._library = real
        (snmf_mu.snmf_mu_pass1_reference,
         snmf_mu.snmf_mu_pass2_reference) = plain


def _snmf_frozen_route_matches_by_hand(device):
    """With every column of W frozen ``sparse_nmf_ed`` takes the frozen
    route: one B4 and one B5 launch an iteration, and ``h``, the divergences
    and the costs bit-equal to the general route's launches
    (``snmf_mu_pass1`` then ``snmf_mu_pass2``) looped by hand on the same
    padded operands, since every value read comes from the same product
    instance in the same order; a repeat is bit-equal.  The frozen passes
    alone on frames not padded to four equal the general passes too."""
    rng = np.random.default_rng(6)
    iters = 4

    def uniform(lo, shape):
        return torch.from_numpy(
            rng.uniform(lo, 1.0, shape).astype(np.float32)).to(device)

    for m, r, n in SNMF_SHAPES:
        for sparsity in (0.0, 0.7):
            case = f"m={m} r={r} n={n} sparsity={sparsity}"
            v, w0, h0 = (uniform(0.01, (m, n)), uniform(0.1, (m, r)),
                         uniform(0.1, (r, n)))
            frozen = torch.zeros(r, dtype=torch.bool, device=device)
            before = dict(snmf_mu.LAUNCHES)
            runs = [snmf_mu.sparse_nmf_ed(v, w0, h0, sparsity, frozen, iters,
                                          0.0) for _ in range(2)]
            torch.cuda.synchronize()
            assert snmf_mu.LAUNCHES == {k: before[k] + 2 * iters
                                        for k in before}, case
            w, h, divs, costs, n_iter = runs[0]
            assert n_iter == runs[1][4] == iters, case
            for a, b in zip(runs[0][:4], runs[1][:4]):
                assert torch.equal(a, b), case  # no atomics: bit for bit

            wn = (w0 * w0).sum(dim=0).sqrt()
            w_start = (w0 / wn[None, :]).contiguous()
            assert torch.equal(w, w_start), case
            v_pad = snmf_mu.pad_rows(v)
            h_hand = snmf_mu.pad_rows(h0 * wn[:, None])
            for it in range(iters):
                h_hand, _, _, sp_sum = snmf_mu.snmf_mu_pass1(
                    v_pad, h_hand, w_start, sparsity)
                div = snmf_mu.snmf_mu_pass2(v_pad, h_hand, w_start)
                assert torch.equal(divs[it], div), f"{case} div {it}"
                assert torch.equal(costs[it], div + sp_sum), \
                    f"{case} cost {it}"
            assert torch.equal(h, h_hand[:, :n]), case

    # n = 0, 1, 2, 3 mod 4 (3: the narrow copies of h)
    for m, r, n, sparsity in ((17, 6, 40, 0.7), (65, 63, 129, 0.0),
                              (8, 8, 130, 0.3), (264, 50, 1030, 0.0),
                              (257, 100, 4099, 0.7), (257, 2000, 4099, 1.0)):
        case = f"unpadded m={m} r={r} n={n} sparsity={sparsity}"
        v, w = uniform(0.01, (m, n)), uniform(0.1, (m, r))
        h = uniform(0.1, (r, n))
        w = w / (w * w).sum(dim=0, keepdim=True).sqrt()
        state, h_frozen, h_general = snmf_mu.FrozenW(), h, h
        before = dict(snmf_mu.LAUNCHES)
        snmf_mu.snmf_mu_frozen_init(v, h, w, state)
        assert snmf_mu.LAUNCHES == before  # once a solve: no launch
        for it in range(3):
            h_frozen, sp_frozen = snmf_mu.snmf_mu_frozen_pass1(
                h_frozen, sparsity, state)
            div_frozen = snmf_mu.snmf_mu_frozen_pass2(v, h_frozen, state)
            h_general, _, _, sp_general = snmf_mu.snmf_mu_pass1(
                v, h_general, w, sparsity)
            div_general = snmf_mu.snmf_mu_pass2(v, h_general, w)
            for name, a, b in (("h", h_frozen, h_general),
                               ("sp_sum", sp_frozen, sp_general),
                               ("div", div_frozen, div_general)):
                assert torch.equal(a, b), f"{case} {name} {it}"
        # lam's rows padded with flr to a multiple of four frames
        assert state.lam.shape == (m, -(-n // 4) * 4), case
        assert bool((state.lam[:, n:] == snmf_mu.FLR).all()), case

    # a state that does not hold the h, or holds other shapes, raises
    # before any launch
    before = dict(snmf_mu.LAUNCHES)
    with pytest.raises(ValueError):
        snmf_mu.snmf_mu_frozen_pass1(h, 0.7, state)
    with pytest.raises(ValueError):
        snmf_mu.snmf_mu_frozen_pass2(v, h, snmf_mu.FrozenW())
    with pytest.raises(ValueError):
        snmf_mu.snmf_mu_frozen_pass2(v[:, :8].contiguous(),
                                     h[:, :8].contiguous(), state)
    assert snmf_mu.LAUNCHES == before


def _sparse_nmf_matches_cpu(device):
    """``sparse_nmf`` on the card against the CPU from the same start: the
    ED route through B4/B5 (one launch each per iteration) and the KL route
    through the plain core; W and H within rtol 1e-4 / atol 1e-5, costs
    rtol 1e-4 after 10 iterations."""
    rng = np.random.default_rng(5)
    m, r, n = 33, 12, 500
    v = rng.uniform(0.01, 1.0, (m, n)).astype(np.float32)
    for cf in ("ed", "kl"):
        params = snmf.SNMFParams(
            r=r, cf=cf, sparsity=0.3, max_iter=10, conv_eps=0.0,
            init_w=rng.uniform(0.1, 1.0, (m, r)).astype(np.float32),
            init_h=rng.uniform(0.1, 1.0, (r, n)).astype(np.float32),
            w_update_ind=np.arange(r) >= r // 2)
        before = dict(snmf_mu.LAUNCHES)
        on_card = snmf.sparse_nmf(v, params, device=device)
        routed = 10 if cf == "ed" else 0
        assert snmf_mu.LAUNCHES == {k: before[k] + routed
                                    for k in before}, cf
        on_cpu = snmf.sparse_nmf(v, params, device="cpu")
        np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4,
                                   atol=1e-5, err_msg=cf)
        np.testing.assert_allclose(on_card.h, on_cpu.h, rtol=1e-4,
                                   atol=1e-5, err_msg=cf)
        np.testing.assert_allclose(on_card.cost, on_cpu.cost, rtol=1e-4,
                                   err_msg=cf)


@pytest.mark.cuda
def test_snmf_on_card(cuda):
    """B4 and B5 against their plain versions over a grid of shapes that
    cut every tile, with sparsity 0 and 0.7 and half of W frozen, bit for
    bit reproducible; the wrappers' checks; ``sparse_nmf`` on the card
    against the CPU."""
    _snmf_passes_match_plain(cuda)
    _sparse_nmf_matches_cpu(cuda)


@pytest.mark.cuda
def test_snmf_frozen_route_on_card(cuda):
    """The frozen-dictionary route of ``sparse_nmf_ed`` against the general
    route's launches by hand, bit for bit, with its launch counts; its
    passes alone on frames not padded (n = 0, 1, 2, 3 mod 4) equal to the
    general passes, lam's padding held at flr."""
    _snmf_frozen_route_matches_by_hand(cuda)


def _memcpy_bytes(prof, tmp_path):
    """(kind, bytes) of every memcpy in a profiler's exported trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"].split()[1], e["args"]["bytes"]) for e in events
            if e.get("cat") == "gpu_memcpy"]


def _infer_irm_keeps_h_on_card(device, tmp_path):
    """``snmf_infer_irm`` on the card against the route that fetched H and
    sent it back (``sparse_nmf_chunked(..., save_h=True)``, H to the card,
    the same products): at one chunk the mask is bit-equal, H is a tensor
    on the card, the call records ``snmf.mask_to_host`` alone with the
    counter ``snmf.h_kept_on_device`` at every frame, and no copy of H's
    size is made either way while the mask's is.  Over three chunks H is
    gathered on the host bit-equal to the old route's, and the mask, whose
    products are taken a chunk at a time, within 1e-6 of it."""
    from drnmf_torch.models.snmf_enhancer import snmf_infer_irm
    from drnmf_torch.utils.profiling import tally

    rng = np.random.default_rng(9)
    f, r, n, iters = 33, 12, 3000, 20  # h's bytes (24 x n) differ from F's
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (f, n)).astype(np.float32)
    params = snmf.SNMFParams(r=r, cf="ed", sparsity=0.1)
    infer = snmf.SNMFParams(r=2 * r, cf="ed", sparsity=0.1, init_w=w,
                            w_update_ind=np.zeros(2 * r, bool),
                            max_iter=iters)
    w_t = torch.from_numpy(w).to(device)
    for frame_chunk in (None, 1000):
        case = f"frame_chunk={frame_chunk}"
        gen = torch.Generator(device=device).manual_seed(7)
        old = snmf.sparse_nmf_chunked(x, infer, generator=gen,
                                      frame_chunk=frame_chunk, device=device)
        h_old = torch.from_numpy(old.h).to(device)
        clean_est = w_t[:, :r] @ h_old[:r]
        noise_est = w_t[:, r:] @ h_old[r:]
        irm_old = (clean_est / (1e-9 + clean_est + noise_est)).cpu().numpy()

        gen = torch.Generator(device=device).manual_seed(7)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            irm, h = snmf_infer_irm(x, w, params, max_iter=iters,
                                    frame_chunk=frame_chunk, generator=gen,
                                    device=device)
            torch.cuda.synchronize()
        got = tally()
        copies = _memcpy_bytes(prof, tmp_path)
        chunk = frame_chunk or n
        assert ("DtoH", 4 * f * chunk) in copies, (case, copies)
        assert all(b != 4 * 2 * r * n for kind, b in copies
                   if kind in ("DtoH", "HtoD")), (case, copies)
        np.testing.assert_array_equal(h.cpu().numpy(), old.h, err_msg=case)
        spans = {k: v["count"] for k, v in got["spans"].items()}
        if frame_chunk is None:
            assert h.device.type == "cuda", case
            np.testing.assert_array_equal(irm, irm_old, err_msg=case)
            assert spans == {"snmf.call": 1, "snmf.mask_to_host": 1}, spans
            assert got["counters"]["snmf.h_kept_on_device"] == n
        else:
            assert h.device.type == "cpu", case
            np.testing.assert_allclose(irm, irm_old, rtol=1e-6, atol=0,
                                       err_msg=case)
            assert spans == {"snmf.call": 1, "snmf.mask_to_host": 3,
                             "snmf.h_to_host": 3}, spans
            assert "snmf.h_kept_on_device" not in got["counters"]


@pytest.mark.cuda
def test_snmf_infer_irm_on_card(cuda, tmp_path):
    """The ratio mask from the solve's own H on the card (see
    ``_infer_irm_keeps_h_on_card``)."""
    _infer_irm_keeps_h_on_card(cuda, tmp_path)


TRAIN_SHAPES = [  # (B, T, F, r, K)
    (1, 1, 9, 8, 1),  # one row, one step
    (3, 11, 9, 8, 2),
    (5, 13, 9, 8, 5),  # odd B: rows past the batch
    (3, 7, 33, 7, 2),  # odd 2r and F
    (17, 9, 65, 50, 5),  # a 32-row tile, 15 rows past the batch
    (1, 6, 257, 1000, 5),  # flagship widths, one row
    (32, 6, 257, 1000, 5),  # flagship widths at the training batch
    (33, 4, 257, 1000, 1),  # K = 1: no back-projection, dummy weights
    (65, 4, 33, 20, 3),  # the backward's four 32-row tiles, three stripes
]


def _train_operands(shape, device, alph=10.0):
    """B1's operands for a model of this shape, with a masked tail and a
    masked step mid-sequence, and a gradient of the output g.  At alph =
    2000 every layer is active at these shapes (at 10 the wide ones have
    dead layers, whose deltas are zero)."""
    bsz, t_len, f, r, K = shape
    cfg, params, rng = _model(4, f, r, K, device, alph=alph)
    x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
    x[bsz // 2, min(3, t_len - 1):] = cfg.mask_value
    if t_len > 2:
        x[-1, t_len // 2] = cfg.mask_value
    x = torch.from_numpy(x).to(device)
    args = drnmf.factored_scan_operands(
        params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
    g = torch.from_numpy(rng.standard_normal((bsz, t_len, 2 * r))
                         .astype(np.float32)).to(device)
    return args, g


def _training_kernels_match_plain(device):
    """B1 with every layer kept (top output bit-equal to B1 without the
    flag, the layer stack against the plain loop's) and the backward
    kernel against its plain version on that stack; a repeat bit-equal;
    padded columns zero.  Where K >= 3, also with every layer active
    (alph = 2000), and the streamed instance (forced) bit-equal to the
    plan's on both."""
    for shape, alph in [(s, a) for s in TRAIN_SHAPES
                        for a in ((10.0, 2000.0) if s[4] >= 3 else (10.0,))]:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + f" alph={alph}"
        args, g = _train_operands(shape, device, alph)
        bsz = shape[0]
        before = dict(drnmf_scan.LAUNCHES)
        out = drnmf_scan.drnmf_scan_factored(*args)
        kept, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
        back_args = (g, args[1], h_all, *args[3:8])
        grads = drnmf_scan.drnmf_scan_factored_backward(*back_args)
        again = drnmf_scan.drnmf_scan_factored_backward(*back_args)
        torch.cuda.synchronize()
        assert drnmf_scan.LAUNCHES == {
            **before, "factored": before["factored"] + 2,
            "factored_backward": before["factored_backward"] + 2}, case
        assert torch.equal(kept, out), case
        _, ref_h = drnmf_scan.drnmf_scan_factored_reference(*args,
                                                            keep_layers=True)
        np.testing.assert_allclose(h_all[..., :bsz].cpu().numpy(),
                                   ref_h.cpu().numpy(), err_msg=case, **TOL)
        ref = drnmf_scan.drnmf_scan_factored_backward_reference(*back_args)
        for name, got, rep, want in zip(("delta", "p", "gamma"), grads, again,
                                        ref):
            assert torch.equal(got, rep), f"{name} repeat {case}"
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       err_msg=f"{name} {case}", **TOL)
            if name != "gamma":
                assert not got[..., bsz:].any(), f"{name} padded {case}"
        if alph == 2000.0:
            assert all(ref[0][k].any() for k in range(shape[4])), case
        if shape[4] >= 3:
            before = dict(drnmf_scan.BACKWARD_INSTANCES)
            with drnmf_scan.streamed_backward():
                streamed = drnmf_scan.drnmf_scan_factored_backward(
                    *back_args)
            assert drnmf_scan.BACKWARD_INSTANCES == {
                **before, "streamed": before["streamed"] + 1}, case
            for name, a, b in zip(("delta", "p", "gamma"), streamed, grads):
                assert torch.equal(a, b), f"{name} streamed {case}"


def _training_rows_do_not_depend_on_the_batch(device, alph):
    """At the flagship widths and the training batch (32 rows), rows 0-15
    as a 16-row call and rows 0 and 31 alone give the same layer stack and
    the same deltas, p and gamma as those rows of the 32-row call, bit for
    bit; the plan keeps the weights resident, and the streamed instance
    gives the same bits."""
    args, g = _train_operands((32, 6, 257, 1000, 5), device, alph)
    _, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
    full = drnmf_scan.drnmf_scan_factored_backward(g, args[1], h_all,
                                                   *args[3:8])
    for sel in (slice(0, 16), slice(0, 1), slice(31, 32)):
        rows = [a[sel].contiguous() if i < 3 else a
                for i, a in enumerate(args)]
        n = sel.stop - sel.start
        _, h_rows = drnmf_scan.drnmf_scan_factored(*rows, keep_layers=True)
        assert torch.equal(h_rows[..., :n], h_all[..., sel]), sel
        got = drnmf_scan.drnmf_scan_factored_backward(
            g[sel].contiguous(), rows[1], h_rows, *rows[3:8])
        assert torch.equal(got[0][..., :n], full[0][..., sel]), sel
        assert torch.equal(got[1][..., :n], full[1][..., sel]), sel
        assert torch.equal(got[2], full[2][sel]), sel
    # the backward's two instances: at the training batch the plan keeps
    # the weights resident; refused that, it streams them, with the same
    # bits
    plan = drnmf_scan.drnmf_scan_factored_backward_plan(32, 257, 2000, 5)
    assert plan.resident and plan.syncs_per_step == 9, plan
    assert plan.smem == 210_752, plan  # the kernel's layout, as planned
    with drnmf_scan.streamed_backward():
        assert not drnmf_scan.drnmf_scan_factored_backward_plan(
            32, 257, 2000, 5).resident
        before = dict(drnmf_scan.BACKWARD_INSTANCES)
        streamed = drnmf_scan.drnmf_scan_factored_backward(
            g, args[1], h_all, *args[3:8])
        assert drnmf_scan.BACKWARD_INSTANCES == {
            **before, "streamed": before["streamed"] + 1}
    for name, a, b in zip(("delta", "p", "gamma"), streamed, full):
        assert torch.equal(a, b), f"streamed against resident: {name} {alph}"


def _training_refusals_raise(device):
    """The backward kernel refused (no cooperative launch, a launch error
    of the resident or the streamed instance, too little free memory)
    raises with the shapes, counts no launch and never runs its plain
    version; the training scan refuses residuals past its budget."""
    args, g = _train_operands((3, 5, 9, 8, 3), device)
    _, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
    back_args = (g, args[1], h_all, *args[3:8])
    real = drnmf_scan._backward_library
    plain = drnmf_scan.drnmf_scan_factored_backward_reference
    free = drnmf_scan.free_bytes

    def must_not_run(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    drnmf_scan.drnmf_scan_factored_backward_reference = must_not_run
    try:
        for refused, code, match in (
                ("drnmf_scan_factored_backward_capacity", 0,
                 "no cooperative launch"),
                ("drnmf_scan_factored_backward", 9,
                 "B=3, T=5, F=9, 2r=16, K=3")):
            for instance in (contextlib.nullcontext,
                             drnmf_scan.streamed_backward):
                refusing = Refusing(real(), refused, code)
                drnmf_scan._backward_library = lambda: refusing
                before = (dict(drnmf_scan.LAUNCHES),
                          dict(drnmf_scan.BACKWARD_INSTANCES))
                with instance(), pytest.raises(RuntimeError, match=match):
                    drnmf_scan.drnmf_scan_factored_backward(*back_args)
                assert (drnmf_scan.LAUNCHES,
                        drnmf_scan.BACKWARD_INSTANCES) == before, refused
            drnmf_scan._backward_library = real
        drnmf_scan.free_bytes = lambda dev: 0
        with pytest.raises(RuntimeError, match="free"):
            drnmf_scan.drnmf_scan_factored_backward(*back_args)
    finally:
        drnmf_scan._backward_library = real
        drnmf_scan.drnmf_scan_factored_backward_reference = plain
        drnmf_scan.free_bytes = free
    budget = batched_grad.residual_budget
    batched_grad.residual_budget = lambda dev: 0
    try:
        args[3].requires_grad_(True)
        with pytest.raises(RuntimeError, match="cut the batch size"):
            batched_grad.scan_factored_train(*args)
    finally:
        batched_grad.residual_budget = budget


def _training_function_matches_plain(device):
    """The masked-MSE loss's gradients through the model on the card (the
    Function: B1 with every layer kept, the backward kernel, the products)
    against the same loss with the scan forced to the Function's plain
    versions and to autograd through the plain loop: within rtol 1e-4 of
    each gradient's largest entry; the route launches B1 and the backward
    kernel once and no time loop."""
    for K in (1, 3):
        cfg, params, rng = _model(5, 17, 12, K, device)
        trains = drnmf.drnmf_trainable_mask(cfg, params)
        for name, v in params.items():
            v.requires_grad_(trains[name])
        x = rng.uniform(0, 1, (5, 9, 17)).astype(np.float32)
        x[2, 6:] = cfg.mask_value
        y = torch.from_numpy(rng.uniform(0, 1, x.shape).astype(np.float32))
        x, y = torch.from_numpy(x).to(device), y.to(device)
        mask = drnmf.step_mask_from_input(x, cfg.mask_value).float()
        names = sorted(k for k in params if trains[k])

        def grads(scan_fn):
            irm = drnmf.drnmf_forward(params, cfg, x, scan_fn=scan_fn)
            loss = masked_mse_signal_approx(irm, x, y, mask)
            return torch.autograd.grad(loss, [params[k] for k in names])

        before = dict(drnmf_scan.LAUNCHES)
        got = grads(None)
        torch.cuda.synchronize()
        assert drnmf_scan.LAUNCHES == {
            **before, "factored": before["factored"] + 1,
            "factored_backward": before["factored_backward"] + 1}, K
        for scan_fn in (batched_grad.scan_factored_train_reference,
                        drnmf_scan.drnmf_scan_factored_reference):
            for name, a, b in zip(names, got, grads(scan_fn)):
                err = (a - b).abs().max().item()
                assert err <= 1e-4 * b.abs().max().item() + 1e-12, (
                    K, name, scan_fn.__name__, err)


@pytest.mark.cuda
def test_training_on_card(cuda):
    """Training's kernels on the card: B1 with every layer kept and the
    backward kernel against their plain versions over a grid of shapes
    (K = 1, 2, 3, 5, odd B, F and 2r, masked tails and steps, 65 rows, the
    flagship widths at 1, 32 and 33 rows; where K >= 3 also with every
    layer active), a bit-equal repeat, rows run alone equal to the same
    rows of the batch bit for bit, the backward's streamed instance
    bit-equal to the plan's, refused launches of either instance and
    gates that raise, and the model's gradients through them against the
    plain versions."""
    _training_kernels_match_plain(cuda)
    for alph in (10.0, 2000.0):
        _training_rows_do_not_depend_on_the_batch(cuda, alph)
    _training_refusals_raise(cuda)
    _training_function_matches_plain(cuda)


# the scoring engine on the card against the same engine on the CPU: SDR,
# SNR and segmental SNR within 1e-3 dB, PESQ within 2e-3 MOS, STOI within
# 1e-3 (tests/test_torch_metrics.py's tolerances against the JAX package);
# an SDR further apart only where the two devices kept different ridges of
# the escalation, and then equal within 1e-3 dB at every ridge where both
# are finite; delays equal; a repeat on the card bit-equal
SCORE_TOLS = (1e-3, 1e-3, 1e-3, 1e-3, 2e-3, 1e-3)


def _score_battery(seed=11, fs=16000):
    """PCM16 pairs: corpus-like (drnmf_torch.data.synthetic's speech and
    noise) at five lengths (one too short for PESQ and STOI), two
    near-periodic AM sinusoids (bench.py::bench_score's), white noise with
    a constant delay of 800 samples."""
    from drnmf_torch.data import synthetic

    rng = np.random.default_rng(seed)

    def pcm16(x):
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    ests, refs = [], []
    for k, n in enumerate((700, 9000, 17000, 23000, 40000)):
        clean = synthetic._synthetic_speech(rng, n, fs)
        noise = synthetic._synthetic_noise(rng, n, fs)
        noise *= np.sqrt(np.mean(clean**2) / np.mean(noise**2)) * 0.5
        refs.append(pcm16(clean))
        ests.append(pcm16(clean + noise))
    for i, n in enumerate((11000, 20000)):
        t = np.arange(n) / fs
        ref = (0.1 * np.sin(2 * np.pi * (120 + 40 * i) * t)
               * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t)))
        refs.append(pcm16(ref))
        ests.append(pcm16(ref + 0.02 * rng.standard_normal(n)))
    ref = 0.1 * rng.standard_normal(14000)
    est = np.concatenate([np.zeros(800), ref[:-800]]) \
        + 0.02 * rng.standard_normal(14000)
    refs.append(pcm16(ref))
    ests.append(pcm16(est))
    return ests, refs


def hold_scores(got, want, ridges_got, ridges_want):
    """Rows of two score tables against each other (SCORE_TOLS; SDR by
    ridge where the devices kept different ridges).  Returns the largest
    difference by column and the rows whose kept ridge differs."""
    worst = np.zeros(6)
    other_ridge = []
    for i in range(len(got)):
        for col, tol in enumerate(SCORE_TOLS):
            a, b = got[i, col], want[i, col]
            if a == b or (np.isnan(a) and np.isnan(b)):
                continue
            diff = abs(a - b)
            if col == 0 and diff > tol:
                ra, rb = ridges_got[i], ridges_want[i]
                first = [int(np.argmax(np.isfinite(r))) for r in (ra, rb)]
                assert first[0] != first[1], (i, a, b, ra, rb)
                both = np.isfinite(ra) & np.isfinite(rb)
                assert np.all(np.abs(ra - rb)[both] <= tol), (i, ra, rb)
                other_ridge.append(i)
                continue
            assert diff <= tol, (i, col, a, b)
            worst[col] = max(worst[col], diff)
    return worst, other_ridge


@pytest.mark.cuda
def test_scoring_engine_on_card(cuda):
    """``score_all_packed`` on the card against the same engine on the CPU
    (int16 buffers, the delay guard, the ridge escalation of the
    near-periodic rows), its delays equal, a repeat bit-equal; PESQ with
    the float64 host model on every row."""
    from drnmf_torch.metrics import _pesq_model, engine

    ests, refs = _score_battery()
    got, delays = engine.score_all_packed(ests, refs, device="cuda")
    again, delays2 = engine.score_all_packed(ests, refs, device="cuda")
    want, want_delays = engine.score_all_packed(ests, refs, device="cpu")
    np.testing.assert_array_equal(again, got)
    np.testing.assert_array_equal(delays2, delays)
    np.testing.assert_array_equal(delays, want_delays)
    assert delays[-1] != 0 and not delays[:-1].any()
    assert np.isfinite(got[1:]).all() and np.isfinite(got[0, :4]).all()
    hold_scores(got, want, engine.sdr_at_ridges(ests, refs, device="cuda"),
                engine.sdr_at_ridges(ests, refs, device="cpu"))
    for i in range(len(ests) - 1):  # the delayed row is compensated
        host = _pesq_model.pesq_mos_aligned(refs[i] / 32768.0,
                                            ests[i] / 32768.0)
        assert abs(got[i, 4] - host) <= SCORE_TOLS[4] or (
            np.isnan(host) and np.isnan(got[i, 4])), (i, got[i, 4], host)


# two ranks of one gloo group sharing the card (parallel.mesh): a fit and
# sparse NMF against one process on the card
def _parallel_fit(mesh, cfg, params, data, tc):
    from drnmf_torch.train import train_model

    def loss(p, x, y, mask):
        return masked_mse_signal_approx(drnmf.drnmf_forward(p, cfg, x), x, y,
                                        mask)

    best, hist = train_model(params, loss, data, data, tc,
                             trainable_mask=drnmf.drnmf_trainable_mask(
                                 cfg, params), device="cuda", mesh=mesh)
    return best, hist.history


def _parallel_rank(rank, cfg, params, data, tc, v, snmf_params):
    from drnmf_torch.parallel import make_mesh, sparse_nmf_sharded

    mesh = make_mesh()
    for counts in (drnmf_scan.LAUNCHES, snmf_mu.LAUNCHES):
        for k in counts:
            counts[k] = 0
    fit = _parallel_fit(mesh, cfg, params, data, tc)
    res = sparse_nmf_sharded(v, snmf_params, mesh)
    return (fit, (res.w, res.h, res.cost), mesh.backend,
            dict(drnmf_scan.LAUNCHES), dict(snmf_mu.LAUNCHES))


@pytest.mark.cuda
def test_parallel_on_card(cuda):
    """A 2-rank gloo group on the card (``parallel.run_ranks``): data
    parallel ``train_model`` (B1 with every layer kept and the backward
    kernel on each rank's rows, 7 rows in batches of 4 so the last batch
    leaves rank 1 padding only) and ``sparse_nmf_sharded`` (B4/B5 on each
    rank's 101 or 102 frames) against one process on the card: losses rtol
    1e-4, parameters 1e-4 / 1e-6, W, H and the costs within 1e-4 of each
    one's largest entry; each rank launched the kernels."""
    from drnmf_torch.ops.snmf import SNMFParams, sparse_nmf
    from drnmf_torch.parallel import run_ranks
    from drnmf_torch.train import TrainConfig

    cfg, params, rng = _model(3, 33, 24, 3, cuda,
                              params_untied=("log_D", "log_alph"))
    params = {k: v.cpu().numpy() for k, v in params.items()}
    y = rng.uniform(0.0, 1.0, (7, 40, 33)).astype(np.float32)
    x = y + rng.uniform(0.0, 1.0, (7, 40, 33)).astype(np.float32)
    mask = np.ones((7, 40, 1), np.float32)
    mask[2, 30:] = 0
    x[2, 30:] = y[2, 30:] = -1.0
    tc = TrainConfig(epochs=2, batch_size=4, learning_rate=1e-3,
                     clipnorm=0.02, verbose=False)
    v = rng.uniform(0.0, 1.0, (40, 203)).astype(np.float32)
    snmf_params = SNMFParams(r=12, cf="ed", sparsity=0.3, max_iter=15,
                             random_seed=5)

    one_best, one_hist = _parallel_fit(None, cfg, params, (x, y, mask), tc)
    one_snmf = sparse_nmf(v, snmf_params, device="cuda")
    ranks = run_ranks(_parallel_rank, 2,
                      args=(cfg, params, (x, y, mask), tc, v, snmf_params),
                      device="cuda", timeout_s=120.0, deadline_s=300.0)
    for rank, ((best, hist), (w, h, cost), backend, scan, mu) in enumerate(
            ranks):
        msg = f"rank {rank}"
        assert backend == "gloo", msg
        assert scan["factored"] > 0 and scan["factored_backward"] > 0, msg
        assert mu["pass1"] == mu["pass2"] == 15, msg
        for where in ("on_batch_end", "on_epoch_end"):
            for key, want in one_hist[where].items():
                np.testing.assert_allclose(hist[where][key], want, rtol=1e-4,
                                           err_msg=f"{msg} {key}")
        for k, want in one_best.items():
            np.testing.assert_allclose(best[k], want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{msg} {k}")
        for name, got, want in (("w", w, one_snmf.w), ("h", h, one_snmf.h),
                                ("cost", cost, one_snmf.cost)):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-4, (msg, name, err)


# the sequence-pipelined recurrence: two ranks of one gloo group sharing the
# card, each running its time chunk through B1 (frozen U) or B3 (dense U)
def _seq_rank(rank, cases):
    from drnmf_torch.parallel import drnmf_scan_seq_pipelined, make_mesh

    mesh = make_mesh()
    out = []
    for cfg, params, x, n_groups in cases:
        for k in drnmf_scan.LAUNCHES:
            drnmf_scan.LAUNCHES[k] = 0
        x = torch.from_numpy(x).cuda()
        got = drnmf_scan_seq_pipelined(
            params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value),
            mesh, n_groups=n_groups)
        out.append((got.cpu().numpy(), dict(drnmf_scan.LAUNCHES),
                    mesh.staged))
    return out


@pytest.mark.cuda
def test_seq_pipelined_on_card(cuda):
    """``drnmf_scan_seq_pipelined`` over 2 ranks on the card, G = 2 and 4
    groups, frozen U (B1) and dense U (B3), a masked tail, against one
    process's ``make_scan`` on the card at rtol 1e-4 / atol 1e-5 (the
    kernels' tolerance: the same kernel on the same rows, the chunks
    started from a carried state); each rank launches its kernel once a
    group and stages the carry through host memory (gloo)."""
    from drnmf_torch.parallel import run_ranks

    cfg, params, rng = _model(3, 33, 24, 3, cuda)
    host = {k: v.cpu().numpy() for k, v in params.items()}
    dense_cfg = dataclasses.replace(
        cfg, params_trainable=cfg.params_trainable + ("log_U1", "log_Uk"))
    dense = dict(host)
    dense["log_U1"] = host["log_U1"] - rng.uniform(
        0.0, 0.2, host["log_U1"].shape).astype(np.float32)
    cases, wants = [], []
    for model_cfg, model_params, kernel in ((cfg, host, "factored"),
                                            (dense_cfg, dense, "dense")):
        for n_groups in (2, 4):
            x = rng.uniform(0.0, 1.0, (8, 20, 33)).astype(np.float32)
            x[3, 13:] = model_cfg.mask_value
            cases.append((model_cfg, model_params, x, n_groups))
            xc = torch.from_numpy(x).cuda()
            run = drnmf.make_scan({k: torch.from_numpy(v).cuda()
                                   for k, v in model_params.items()},
                                  model_cfg)
            wants.append((run(xc, drnmf.step_mask_from_input(
                xc, model_cfg.mask_value)).cpu().numpy(), kernel))
    ranks = run_ranks(_seq_rank, 2, args=(cases,), device="cuda",
                      timeout_s=120.0, deadline_s=300.0)
    for rank, outs in enumerate(ranks):
        for (got, launches, staged), (want, kernel), case in zip(
                outs, wants, cases):
            msg = f"rank {rank} {kernel} G={case[3]}"
            np.testing.assert_allclose(got, want, **TOL, err_msg=msg)
            assert launches[kernel] == case[3], (msg, launches)
            assert staged > 0, msg
