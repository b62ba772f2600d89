"""The port's sparse-NMF stage (drnmf_torch.ops.snmf, ops.snmf_mu,
train.snmf_recipe, models.snmf_enhancer) against the JAX package's on the
CPU.  Both sides get the same numpy inputs and the same initial W and H.

Tolerances, f32 on both sides with sums taken in other orders: W and H
rtol 2e-5 / atol 1e-6 and costs rtol 2e-4 over up to 10 iterations (the
JAX package's own Pallas-vs-XLA test, tests/test_pallas_kernels.py:169-190);
iteration counts of a conv_eps stop within 1 (the cost's roundoff at the
threshold).  Kernels B4/B5 themselves are held against their plain versions
in tests/test_torch_cuda.py, which needs a card; what their wrappers
prepare (padded operands) and the split arithmetic they do are tested here."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from drnmf_tpu.data.batching import masked_seqs_to_frames as jax_frames
from drnmf_tpu.models import snmf_infer_irm as jax_infer_irm
from drnmf_tpu.ops import snmf as jsnmf
from drnmf_tpu.ops.pallas import snmf_mu as jmu
from drnmf_tpu.train import snmf_recipe as jrecipe
from drnmf_tpu.utils.cache import snmf_cache_path as jax_cache_path
from drnmf_tpu.utils.config import config_hash as jax_config_hash
from drnmf_torch import config as tconfig
from drnmf_torch.data import masked_seqs_to_frames
from drnmf_torch.models import snmf_infer_irm
from drnmf_torch.ops import snmf as tsnmf
from drnmf_torch.ops import snmf_mu as tmu
from drnmf_torch.train import snmf_recipe as trecipe
from drnmf_torch.utils.cache import snmf_cache_path

WH_TOL = dict(rtol=2e-5, atol=1e-6)
COST_TOL = dict(rtol=2e-4)
T = torch.from_numpy


def _close(out, ref, tol, msg):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), err_msg=msg, **tol)


def _nmf_inputs(rng, m, r, n, zeros=False):
    v = rng.uniform(0.01, 1.0, (m, n)).astype(np.float32)
    if zeros:
        v[rng.uniform(size=v.shape) < 0.1] = 0.0
    w0 = rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (r, n)).astype(np.float32)
    return v, w0, h0


def test_core_matches_jax_core(rng):
    """The plain core against ``_sparse_nmf_core`` for beta in {0, 1, 2,
    1.5}, scalar and per-atom sparsity, partial W and H masks, and conv_eps
    stops."""
    m, r, n = 13, 5, 30
    cases = [(beta, per_atom, masks, 0.0, 10)
             for beta in (0.0, 1.0, 2.0, 1.5)
             for per_atom, masks in ((False, False), (True, True))]
    cases += [(2.0, False, False, 1e-3, 200), (1.0, True, False, 1e-3, 200)]
    for beta, per_atom, masks, conv_eps, max_iter in cases:
        case = f"beta={beta} per_atom={per_atom} masks={masks} eps={conv_eps}"
        v, w0, h0 = _nmf_inputs(rng, m, r, n, zeros=beta != 2.0)
        sparsity = (rng.uniform(0.1, 0.5, (r, 1)).astype(np.float32)
                    if per_atom else np.float32(0.3))
        w_mask = np.array([True, False, True, True, False] if masks
                          else [True] * r)
        h_mask = np.array([True, True, False, True, True] if masks
                          else [True] * r)
        ref = jsnmf._sparse_nmf_core(
            jnp.asarray(v), jnp.asarray(w0), jnp.asarray(h0),
            jnp.asarray(sparsity), jnp.asarray(w_mask), jnp.asarray(h_mask),
            beta=beta, max_iter=max_iter, conv_eps=conv_eps)
        w, h, divs, costs, n_iter = tsnmf._sparse_nmf_core(
            T(v), T(w0), T(h0), torch.as_tensor(sparsity), T(w_mask),
            T(h_mask), beta, max_iter, conv_eps)
        n_ref = int(ref[4])
        assert abs(n_iter - n_ref) <= 1, case
        k = min(n_iter, n_ref)
        _close(costs[:k], np.asarray(ref[3])[:k], COST_TOL, case)
        _close(divs[:k], np.asarray(ref[2])[:k], COST_TOL, case)
        if n_iter == n_ref:
            _close(w, ref[0], WH_TOL, case)
            _close(h, ref[1], WH_TOL, case)


def _pallas_pass1(v, h, w, sparsity, tn):
    """The JAX package's B4 (``_pass1_kernel``) in interpret mode, over
    n // tn frame tiles, as ``_mu_ed_iteration`` calls it."""
    (m, n), r = v.shape, h.shape[0]

    def tile(rows):
        return pl.BlockSpec((rows, tn), lambda i: (0, i),
                            memory_space=pltpu.VMEM)

    def whole(shape):
        return pl.BlockSpec(shape, lambda i: (0, 0), memory_space=pltpu.VMEM)

    return pl.pallas_call(
        partial(jmu._pass1_kernel, sparsity=float(sparsity), bf16=False),
        grid=(n // tn,),
        in_specs=[tile(m), tile(r), whole((m, r))],
        out_specs=[tile(r), whole((m, r)), whole((m, r)),
                   pl.BlockSpec((1, 1), lambda i: (0, 0),
                                memory_space=pltpu.SMEM)],
        out_shape=[jax.ShapeDtypeStruct((r, n), jnp.float32),
                   jax.ShapeDtypeStruct((m, r), jnp.float32),
                   jax.ShapeDtypeStruct((m, r), jnp.float32),
                   jax.ShapeDtypeStruct((1, 1), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((m, r), jnp.float32),
                        pltpu.VMEM((m, r), jnp.float32),
                        pltpu.SMEM((1,), jnp.float32)],
        interpret=True,
    )(jnp.asarray(v), jnp.asarray(h), jnp.asarray(w))


def test_mu_passes_and_ed_solver_match_pallas(rng):
    """B4's and B5's plain versions and ``sparse_nmf_ed`` against the JAX
    package's Pallas kernels in interpret mode (f32), at the shapes of
    tests/test_pallas_kernels.py:97-166; and the wrappers on CPU tensors
    run the plain versions and count no launch."""
    for m, r, n, tn, sparsity in ((17, 6, 40, 8, 0.7), (9, 4, 20, 20, 0.0)):
        case = f"m={m} r={r} n={n}"
        v, w, h = _nmf_inputs(rng, m, r, n)
        w /= np.sqrt((w**2).sum(axis=0))
        ref = _pallas_pass1(v, h, w, sparsity, tn)
        out = tmu.snmf_mu_pass1_reference(T(v), T(h), T(w), sparsity)
        for o, rf in zip(out, ref):
            _close(o, np.asarray(rf).reshape(o.shape), WH_TOL, case)

        w_mask = np.arange(r) < r // 2
        j_it = jmu._mu_ed_iteration(jnp.asarray(v), jnp.asarray(h),
                                    jnp.asarray(w), sparsity,
                                    jnp.asarray(w_mask), interpret=True,
                                    bf16=False, tile_n=tn)
        t_it = tmu.mu_ed_iteration(T(v), T(h), T(w), sparsity, T(w_mask),
                                   passes=tmu.PLAIN_PASSES)
        for o, rf in zip(t_it, j_it):
            _close(o, rf, WH_TOL, case)
        _close(tmu.snmf_mu_pass2_reference(T(v), t_it[0], t_it[1]), j_it[2],
               COST_TOL, case)

        before = dict(tmu.LAUNCHES)
        for o, p in zip(tmu.snmf_mu_pass1(T(v), T(h), T(w), sparsity), out):
            assert torch.equal(o, p), case
        assert torch.equal(tmu.snmf_mu_pass2(T(v), T(h), T(w)),
                           tmu.snmf_mu_pass2_reference(T(v), T(h), T(w)))
        assert tmu.LAUNCHES == before

    # the whole solver: half of W frozen, and a conv_eps stop
    for m, r, n, sp, w_mask, max_iter, conv_eps in (
            (17, 6, 40, 0.7, [True] * 3 + [False] * 3, 8, 0.0),
            (9, 4, 20, 0.0, [True] * 4, 200, 1e-3)):
        case = f"solver m={m} r={r} n={n} eps={conv_eps}"
        v, w0, h0 = _nmf_inputs(rng, m, r, n)
        ref = jmu.sparse_nmf_ed_pallas(v, w0, h0, sp, jnp.asarray(w_mask),
                                       max_iter=max_iter, conv_eps=conv_eps,
                                       interpret=True, bf16=False)
        w, h, divs, costs, n_iter = tmu.sparse_nmf_ed(
            T(v), T(w0), T(h0), sp, torch.tensor(w_mask), max_iter,
            conv_eps)
        n_ref = int(ref[4])
        assert abs(n_iter - n_ref) <= 1, case
        k = min(n_iter, n_ref)
        _close(costs[:k], np.asarray(ref[3])[:k], COST_TOL, case)
        if n_iter == n_ref:
            _close(w, ref[0], WH_TOL, case)
            _close(h, ref[1], WH_TOL, case)


@pytest.mark.parametrize("m,r,n,sparsity,conv_eps",
                         [(17, 6, 40, 0.7, 0.0), (9, 4, 22, 0.0, 1e-3)])
def test_frozen_route_matches_pallas(rng, m, r, n, sparsity, conv_eps):
    """With every column of W frozen, ``sparse_nmf_ed`` (the frozen route:
    W^T v once, B4 as the H update alone, B5 handing lam on; here their
    plain versions) against the JAX package's ``sparse_nmf_ed_pallas``, and
    bit for bit against the general route's passes looped by hand on the
    same padded operands: the same arithmetic for every value read."""
    case = f"m={m} r={r} n={n} sparsity={sparsity}"
    v, w0, h0 = _nmf_inputs(rng, m, r, n)
    frozen = np.zeros(r, bool)
    max_iter = 8 if conv_eps == 0 else 200
    ref = jmu.sparse_nmf_ed_pallas(v, w0, h0, sparsity, jnp.asarray(frozen),
                                   max_iter=max_iter, conv_eps=conv_eps,
                                   interpret=True, bf16=False)
    w, h, divs, costs, n_iter = tmu.sparse_nmf_ed(
        T(v), T(w0), T(h0), sparsity, torch.from_numpy(frozen), max_iter,
        conv_eps)
    n_ref = int(ref[4])
    assert abs(n_iter - n_ref) <= 1 and n_iter > 1, case
    k = min(n_iter, n_ref)
    _close(costs[:k], np.asarray(ref[3])[:k], COST_TOL, case)
    _close(divs[:k], np.asarray(ref[2])[:k], COST_TOL, case)
    _close(w, ref[0], WH_TOL, case)
    if n_iter == n_ref:
        _close(h, ref[1], WH_TOL, case)

    wn = (T(w0) * T(w0)).sum(dim=0).sqrt()
    w_start = (T(w0) / wn[None, :]).contiguous()
    assert torch.equal(w, w_start), case
    v_pad, h_by_hand = tmu.pad_rows(T(v)), tmu.pad_rows(T(h0) * wn[:, None])
    for it in range(n_iter):
        h_by_hand, _, _, sp_sum = tmu.snmf_mu_pass1_reference(
            v_pad, h_by_hand, w_start, sparsity)
        div = tmu.snmf_mu_pass2_reference(v_pad, h_by_hand, w_start)
        assert torch.equal(divs[it], div), f"{case} iteration {it}"
        assert torch.equal(costs[it], div + sp_sum), f"{case} iteration {it}"
    assert torch.equal(h, h_by_hand[:, :n]), case


def test_route_follows_the_mask_and_counts_frozen_iterations(rng):
    """The frozen route runs where no column of W updates and the general
    route where any does, whatever else is asked; traced, the counter
    ``snmf.mu_iters_frozen_w`` adds a frozen solve's iterations once and a
    general solve adds nothing to it."""
    from drnmf_torch.utils.profiling import span, tally

    m, r, n = 11, 6, 30
    v, w0, h0 = _nmf_inputs(rng, m, r, n)
    calls = {}

    def spy(name, fn):
        def counted(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return counted

    passes = tmu.Passes(*(spy(name, fn) for name, fn in
                          zip(tmu.Passes._fields, tmu.PLAIN_PASSES)))
    for mask, iters, route in (
            (np.zeros(r, bool), 7, {"frozen_init": 1, "frozen_pass1": 7,
                                    "frozen_pass2": 7}),
            (np.arange(r) < r // 2, 5, {"pass1": 5, "pass2": 5}),
            (np.ones(r, bool), 3, {"pass1": 3, "pass2": 3})):
        calls.clear()
        # the span opens a window of its own, so the tally holds this solve
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                span("test.solve"):
            tmu.sparse_nmf_ed(T(v), T(w0), T(h0), 0.2, torch.from_numpy(mask),
                              iters, 0.0, passes=passes)
        counters = tally()["counters"]
        assert calls == route, mask
        if "frozen_init" in route:
            assert counters == {"snmf.mu_iters_frozen_w": iters}
        else:
            assert "snmf.mu_iters_frozen_w" not in counters, mask


def test_frozen_state_serves_only_its_own_tensors(rng):
    """A :class:`FrozenW` holds W^T v and lam of one v, W and h: handed to
    ``mu_ed_iteration`` with its own h it carries lam over, and with another
    h or W, or its h changed in place, it is filled again; either way the
    iteration equals one on a new state.  Its B4 on an h whose lam it does
    not hold raises."""
    m, r, n = 10, 5, 24
    v, w0, h0 = (T(a) for a in _nmf_inputs(rng, m, r, n))
    w = w0 / (w0 * w0).sum(dim=0, keepdim=True).sqrt()
    w_other = (w * T(rng.uniform(0.5, 1.5, (m, r)).astype(np.float32)))
    w_other = w_other / (w_other * w_other).sum(dim=0, keepdim=True).sqrt()
    none = torch.zeros(r, dtype=torch.bool)

    def iteration(h, w, state):
        return tmu.mu_ed_iteration(v, h, w, 0.3, none, tmu.PLAIN_PASSES,
                                   False, None, state)

    state = tmu.FrozenW()
    h1 = iteration(h0, w, state)[0]
    assert state.holds(v, h1, w)
    # the state's own h first (lam carried over), then others
    for h, ww in ((h1, w), (h0, w), (h1, w_other), (h0.clone(), w)):
        got, fresh = iteration(h, ww, state), iteration(h, ww, None)
        for a, b in zip(got, fresh):
            assert torch.equal(a, b)
    h2 = h1.clone()
    iteration(h2, w, state)
    h2.mul_(2.0)  # in place: the state no longer holds it
    assert not state.holds(v, h2, w)
    for a, b in zip(iteration(h2, w, state), iteration(h2, w, None)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tmu.snmf_mu_frozen_pass1(h0, 0.3, state)
    with pytest.raises(ValueError):
        tmu.snmf_mu_frozen_pass1(h0, 0.3, tmu.FrozenW())


def test_sparse_nmf_routing_and_chunking(rng, monkeypatch):
    """``sparse_nmf`` routes ED / all-H / scalar sparsity to the MU solver
    and the rest to the plain core, agreeing with the JAX package's
    ``sparse_nmf``; ``sparse_nmf_chunked`` over several chunks with a wider
    ``init_w`` agrees with the JAX package's; ``masked_seqs_to_frames`` and
    ``default_frame_chunk`` equal the JAX package's."""
    calls = []
    ed = tsnmf.sparse_nmf_ed
    monkeypatch.setattr(tsnmf, "sparse_nmf_ed",
                        lambda *a, **k: calls.append(1) or ed(*a, **k))
    m, r, n = 11, 4, 30
    for cf, sparsity, h_ind, routed in (
            ("ed", 0.3, None, True),
            ("ed", np.array([0.1, 0.2, 0.3, 0.4], np.float32), None, False),
            ("ed", 0.3, np.array([True, False, True, True]), False),
            ("kl", 0.3, None, False)):
        case = f"cf={cf} sparsity={sparsity} h_ind={h_ind}"
        v, w0, h0 = _nmf_inputs(rng, m, r, n)
        kw = dict(r=r, cf=cf, sparsity=sparsity, max_iter=5, conv_eps=0.0,
                  init_w=w0, init_h=h0, h_update_ind=h_ind)
        ref = jsnmf.sparse_nmf(v, jsnmf.SNMFParams(**kw))
        calls.clear()
        res = tsnmf.sparse_nmf(v, tsnmf.SNMFParams(**kw), device="cpu")
        assert len(calls) == int(routed), case
        assert res.n_iter == ref.n_iter, case
        _close(res.w, ref.w, WH_TOL, case)
        _close(res.h, ref.h, WH_TOL, case)
        _close(res.cost, ref.cost, COST_TOL, case)
        dev = tsnmf.sparse_nmf(v, tsnmf.SNMFParams(**kw), device="cpu",
                               device_output=True)
        assert isinstance(dev.w, torch.Tensor), case
        np.testing.assert_array_equal(dev.w.numpy(), res.w)

    # several chunks; init_w wider than r (r adopts its width), an explicit
    # init_h sliced per chunk, the speech half frozen; and H left out
    m, r, n = 9, 3, 100
    v, _, _ = _nmf_inputs(rng, m, r, n)
    init_w = rng.uniform(0.1, 1.0, (m, 5)).astype(np.float32)
    init_h = rng.uniform(0.1, 1.0, (5, n)).astype(np.float32)
    w_ind = np.array([False, False, True, True, True])
    for save_h in (True, False):
        kw = dict(r=r, cf="ed", sparsity=0.2, max_iter=6, conv_eps=0.0,
                  init_w=init_w, init_h=init_h, w_update_ind=w_ind)
        ref = jsnmf.sparse_nmf_chunked(v, jsnmf.SNMFParams(**kw),
                                       frame_chunk=32, save_h=save_h)
        res = tsnmf.sparse_nmf_chunked(v, tsnmf.SNMFParams(**kw),
                                       frame_chunk=32, save_h=save_h,
                                       device="cpu")
        _close(res.w, ref.w, WH_TOL, f"chunked save_h={save_h}")
        _close(res.cost, ref.cost, COST_TOL, f"chunked save_h={save_h}")
        _close(res.div, ref.div, COST_TOL, f"chunked save_h={save_h}")
        assert res.n_iter == ref.n_iter
        if save_h:
            assert res.h.shape == (5, n)
            _close(res.h, ref.h, WH_TOL, "chunked H")
        else:
            assert res.h is None and ref.h is None
    # a tensor input is sliced on its device, with the same result
    res_t = tsnmf.sparse_nmf_chunked(T(v), tsnmf.SNMFParams(**kw),
                                     frame_chunk=32, save_h=False,
                                     device="cpu")
    np.testing.assert_array_equal(res_t.w, res.w)

    for r_ in (100, 200, 1000, 2000):
        assert tsnmf.default_frame_chunk(r_) == jsnmf.default_frame_chunk(r_)
    x = rng.uniform(0, 1, (3, 7, 5)).astype(np.float32)
    mask = (rng.uniform(size=(3, 7, 1)) < 0.6).astype(np.float32)
    np.testing.assert_array_equal(masked_seqs_to_frames(T(x), T(mask)).numpy(),
                                  jax_frames(x, mask))


def test_train_snmf_matches_jax(rng, tmp_path, monkeypatch):
    """The two-stage recipe against the JAX package's, with the port's noise
    half patched to the JAX package's ``PRNGKey(seed + 1)`` numbers: the
    same dictionary, the same artifact names, the speech half equal to
    stage 1's W within the renorm's roundoff; a rerun loads the cache."""
    f, r, n = 9, 3, 60
    clean = rng.uniform(0.01, 1.0, (f, n)).astype(np.float32)
    noisy = clean + rng.uniform(0.0, 0.5, (f, n)).astype(np.float32)
    model = {"r": r, "lam1": 0.5, "snmf_max_iter": 6, "snmf_conv_eps": 0.0,
             "random_seed": 11}
    params_t = tconfig.snmf_params_from_config(model)
    params_j = jsnmf.SNMFParams(r=r, cf="ed", sparsity=0.5, max_iter=6,
                                conv_eps=0.0, random_seed=11)
    assert snmf_cache_path(params_t, "d") == jax_cache_path(params_j, "d")
    for cfg in ({"a": np.float32(0.5), "b": np.arange(3), "c": np.int64(2)},
                {"r": 1000, "cf": "ed", "beta": None}):
        assert tconfig.config_hash(cfg) == jax_config_hash(cfg)

    # deterministic stage-1 start on both sides (excluded from the hash)
    w1 = rng.uniform(0.1, 1.0, (f, r)).astype(np.float32)
    params_t.init_w, params_t.init_h = w1, "ones"
    params_j.init_w, params_j.init_h = w1, "ones"
    monkeypatch.setattr(trecipe, "noise_half", lambda shape, seed: np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), shape), np.float32))
    dir_t, dir_j = str(tmp_path / "t"), str(tmp_path / "j")
    w_t, h_t, obj_t = trecipe.train_snmf(clean, noisy, params_t, dir_t,
                                         verbose=False, device="cpu")
    w_j, _, obj_j = jrecipe.train_snmf(clean, noisy, params_j, dir_j,
                                       verbose=False)
    assert sorted(os.listdir(dir_t)) == sorted(os.listdir(dir_j))
    assert w_t.shape == (f, 2 * r) and h_t is None
    _close(w_t, w_j, WH_TOL, "train_snmf W")
    _close(obj_t["cost"], obj_j["cost"], COST_TOL, "train_snmf cost")
    w_clean = np.load(snmf_cache_path(params_t, dir_t, "clean"))["W"]
    np.testing.assert_allclose(w_t[:, :r], w_clean, rtol=0, atol=1e-6)

    def must_not_run(*args, **kwargs):
        raise AssertionError("the cached dictionary was recomputed")

    monkeypatch.setattr(trecipe, "sparse_nmf_chunked", must_not_run)
    w_again, _, _ = trecipe.train_snmf(clean, noisy, params_t, dir_t,
                                       verbose=False, device="cpu")
    np.testing.assert_array_equal(w_again, w_t)


def test_snmf_infer_irm_matches_jax(rng):
    """``snmf_infer_irm`` (W frozen, H from ones) against the JAX package's
    after 100 iterations: the mask within rtol 2e-5 / atol 1e-6 (measured
    2.7e-6 relative; W stays exactly as given on both sides, so only H's
    per-iteration roundoff compounds), in [0, 1]; H of shape (2r, n) within
    rtol 1e-4 / atol 1e-5 (measured 1.2e-5 relative)."""
    f, r, n = 16, 4, 60
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt((w**2).sum(axis=0))
    x = (w @ np.abs(rng.standard_normal((2 * r, n)))).astype(np.float32)
    kw = dict(r=r, cf="ed", sparsity=0.1, max_iter=100, init_h="ones")
    irm_j, h_j = jax_infer_irm(x, w, jsnmf.SNMFParams(**kw), max_iter=100)
    irm, h = snmf_infer_irm(x, w, tsnmf.SNMFParams(**kw), max_iter=100,
                            device="cpu")
    assert irm.shape == (f, n) and h.shape == (2 * r, n)
    assert np.all(irm >= 0) and np.all(irm <= 1)
    np.testing.assert_allclose(irm, irm_j, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(h, h_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("frame_chunk", [None, 20])
def test_snmf_infer_irm_builds_the_mask_from_the_solves_h(rng, monkeypatch,
                                                         frame_chunk):
    """``snmf_infer_irm`` at one chunk and over three (20 frames of 50)
    against the route that fetched H and sent it back: ``sparse_nmf_chunked
    (..., save_h=True)``, H to the device, the same products.  The mask is
    bit-equal, and H equal; with one chunk H is the very tensor the solve
    left on the device.  ``save_h=True`` and ``save_h=False`` still give
    numpy W and H, and None for H."""
    f, r, n, iters = 16, 4, 50, 30
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (f, n)).astype(np.float32)
    params = tsnmf.SNMFParams(r=r, cf="ed", sparsity=0.1)
    infer = tsnmf.SNMFParams(r=2 * r, cf="ed", sparsity=0.1, init_w=w,
                             w_update_ind=np.zeros(2 * r, bool),
                             max_iter=iters)

    def generator():
        return torch.Generator().manual_seed(7)

    old = tsnmf.sparse_nmf_chunked(x, infer, generator=generator(),
                                   frame_chunk=frame_chunk, device="cpu")
    assert isinstance(old.w, np.ndarray) and isinstance(old.h, np.ndarray)
    h_old = torch.from_numpy(old.h)
    w_t = torch.from_numpy(w)
    clean_est = w_t[:, :r] @ h_old[:r]
    noise_est = w_t[:, r:] @ h_old[r:]
    irm_old = (clean_est / (1e-9 + clean_est + noise_est)).numpy()

    solved = []
    real = tsnmf.sparse_nmf

    def spy(*args, **kwargs):
        solved.append(real(*args, **kwargs))
        return solved[-1]

    monkeypatch.setattr(tsnmf, "sparse_nmf", spy)
    irm, h = snmf_infer_irm(x, w, params, max_iter=iters,
                            frame_chunk=frame_chunk, generator=generator(),
                            device="cpu")
    assert len(solved) == (1 if frame_chunk is None else 3)
    assert all(isinstance(s.h, torch.Tensor) for s in solved)
    assert isinstance(irm, np.ndarray) and irm.shape == (f, n)
    np.testing.assert_array_equal(irm, irm_old)
    assert isinstance(h, torch.Tensor) and h.shape == (2 * r, n)
    np.testing.assert_array_equal(h.numpy(), old.h)
    assert (h is solved[0].h) == (frame_chunk is None)
    monkeypatch.undo()

    dropped = tsnmf.sparse_nmf_chunked(x, infer, generator=generator(),
                                       frame_chunk=frame_chunk,
                                       save_h=False, device="cpu")
    assert dropped.h is None and isinstance(dropped.w, np.ndarray)
    np.testing.assert_array_equal(dropped.w, old.w)
    np.testing.assert_array_equal(dropped.cost, old.cost)
    np.testing.assert_array_equal(dropped.div, old.div)


def test_pass_wrappers_reject_malformed_operands(rng):
    v, w, h = (T(a) for a in _nmf_inputs(rng, 9, 4, 20))
    for bad in ("dtype", "contiguity", "shape", "rank", "sparsity", "bool",
                "not_tensor"):
        args = [v, h, w]
        sparsity = 0.5
        if bad == "dtype":
            args[0] = v.double()
        elif bad == "contiguity":
            args[1] = h.T.contiguous().T
        elif bad == "shape":
            args[2] = w[:-1]
        elif bad == "rank":
            args[1] = h[None]
        elif bad == "sparsity":
            sparsity = torch.tensor(0.5)
        elif bad == "bool":
            sparsity = True
        else:
            args[0] = v.numpy()
        with pytest.raises((TypeError, ValueError)):
            tmu.snmf_mu_pass1(*args, sparsity)
        if bad not in ("sparsity", "bool"):
            with pytest.raises((TypeError, ValueError)):
                tmu.snmf_mu_pass2(*args)


def test_frozen_dictionary_stays_bit_equal(rng):
    """With every column of W frozen the solver leaves W exactly as it was
    after the initial normalisation (no update, no renorm), as the JAX
    package's default route does; ``snmf_infer_irm`` runs that case.  With
    some columns frozen every column is still renormalised."""
    for m, r, n, iters in ((16, 8, 60, 50), (9, 5, 33, 7)):
        case = f"m={m} r={r} n={n}"
        v, w0, h0 = _nmf_inputs(rng, m, r, n)
        w0 /= np.sqrt((w0**2).sum(axis=0))
        frozen = torch.zeros(r, dtype=torch.bool)
        w, h, _, costs, n_iter = tmu.sparse_nmf_ed(
            T(v), T(w0), T(h0), 0.1, frozen, iters, 0.0)
        start = T(w0) / (T(w0) * T(w0)).sum(dim=0).sqrt()[None, :]
        assert n_iter == iters and torch.equal(w, start), case
        assert costs[-1] < costs[0], case
        # one iteration hands the same tensor back, whoever knows the mask
        for update_w in (None, False):
            out = tmu.mu_ed_iteration(T(v), T(h0), start, 0.1, frozen,
                                      update_w=update_w)
            assert out[1] is start, case
        half = torch.arange(r) < r // 2
        w_half = tmu.sparse_nmf_ed(T(v), T(w0), T(h0), 0.1, half, 5, 0.0)[0]
        assert not torch.equal(w_half[:, :r // 2], start[:, :r // 2]), case
        _close((w_half * w_half).sum(dim=0), np.ones(r), WH_TOL, case)
        _close(w_half[:, r // 2:], start[:, r // 2:], WH_TOL, case)


def _truncate_tf32(x):
    """float32 ``x`` with its low 13 mantissa bits cleared: how the tensor
    cores read an operand that was not rounded beforehand."""
    return (x.view(np.int32) & ~0x1FFF).view(np.float32)


def test_tf32_split_padding_and_three_term_product(rng):
    """What the wrappers prepare for B4/B5 and the arithmetic the kernels
    do on it.  ``tf32_split``: ``hi + lo == x`` exactly and ``hi`` has its
    low 13 mantissa bits zero, for W and for W^T padded by ``pad_rows``
    (padding zero, rows a multiple of four floats, 16-byte aligned).  The
    three-term product ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` on positive
    operands at K = 257 and K = 2000 stays within 5e-6 relative of the
    float64 product (a single TF32 product is off by about 1e-3), which is
    why the kernels' tolerance of 1e-4 of the largest entry can stay."""
    for m, r in ((257, 2000), (17, 6), (9, 5), (8, 8)):
        case = f"m={m} r={r}"
        w = rng.uniform(0.1, 1.0, (m, r)).astype(np.float32)
        w /= np.sqrt((w**2).sum(axis=0))
        for x, cols in ((T(w), r), (T(w).T, m)):
            padded = tmu.pad_rows(x)
            assert padded.shape == (x.shape[0], -(-cols // 4) * 4), case
            assert padded.is_contiguous() and padded.data_ptr() % 16 == 0
            assert torch.equal(padded[:, :cols], x), case
            assert not padded[:, cols:].any(), case
            if cols % 4 == 0 and x.is_contiguous():
                assert padded is x, case
            hi, lo = tmu.tf32_split(padded)
            assert torch.equal(hi + lo, padded), case
            assert not (hi.view(torch.int32) & 0x1FFF).any(), case
            assert not hi[:, cols:].any() and not lo[:, cols:].any(), case
            # round to nearest: the tail is at most half a TF32 ulp
            assert (lo.abs() <= padded.abs() * 2.0**-11).all(), case

    for k in (257, 2000):
        a = rng.uniform(0.01, 1.0, (64, k)).astype(np.float32)
        b = rng.uniform(0.1, 1.0, (k, 33)).astype(np.float32)
        exact = a.astype(np.float64) @ b.astype(np.float64)
        a_hi, a_lo = (t.numpy() for t in tmu.tf32_split(T(a)))
        b_hi, b_lo = (t.numpy() for t in tmu.tf32_split(T(b)))
        a_lo, b_lo = _truncate_tf32(a_lo), _truncate_tf32(b_lo)
        f64 = np.float64
        three = (a_lo.astype(f64) @ b_hi.astype(f64)
                 + a_hi.astype(f64) @ b_lo.astype(f64)
                 + a_hi.astype(f64) @ b_hi.astype(f64)).astype(np.float32)
        one = a_hi.astype(f64) @ b_hi.astype(f64)
        err3 = np.abs(three - exact).max() / np.abs(exact).max()
        err1 = np.abs(one - exact).max() / np.abs(exact).max()
        assert err3 <= 5e-6, f"K={k}: {err3}"
        assert err1 > 10 * err3, f"K={k}: {err1} against {err3}"
