"""The plain versions and wrappers of kernels B1, B2 and B3
(drnmf_torch.ops.drnmf_scan) against the TPU kernels they replace,
``drnmf_scan_pallas_factored`` (plain and interleaved) and
``drnmf_scan_pallas``, run in interpret mode, with inputs built as
tests/test_pallas_kernels.py builds them.

Tolerance rtol 1e-5 / atol 1e-6 (B1, B3, and the kernels' orders of
arithmetic: B1's back-projection split over the 2r axis, B2's two chains
and its stretches of 2r and F, B3's contraction cut into fixed
stretches) and rtol 1e-6 / atol 1e-6 (B2's plain version,
as the JAX test of the interleaved kernel): f32 on both sides, different
summation order in the products.  B3's plain version against the JAX
model's XLA scan: rtol 1e-4 / atol 1e-5, as the JAX test holds its Pallas
kernel.  The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
from drnmf_tpu.models.drnmf import (_effective_matrices, _scan_hidden,
                                    step_mask_from_input)
from drnmf_tpu.ops.pallas import drnmf_scan_pallas, drnmf_scan_pallas_factored
from drnmf_torch.ops import drnmf_scan as tscan

TOL = dict(rtol=1e-5, atol=1e-6)


def _operands(rng, bsz, t_len, f, r, K, untie_alph=False):
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                      alph=10.0, lam1=0.5, untie_alph=untie_alph,
                      params_untied=("log_D", "log_alph"),
                      params_trainable=("log_D", "log_alph"),
                      matmul_precision="highest")
    params = init_drnmf_params(cfg, w)
    x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
    if bsz > 1:
        x[1, 7:] = cfg.mask_value  # one row masked after step 7
    x = jnp.asarray(x)
    sm = step_mask_from_input(x, cfg.mask_value)
    U, S, W, b = _effective_matrices(params, cfg, fold_u=True, factor_s=True)
    dkt = (jnp.stack([s[0].T for s in S]) if S
           else jnp.zeros((1, 2 * r, f), jnp.float32))
    dka = jnp.stack([W[0]] + [s[1] for s in S])
    h0 = jnp.broadcast_to(jax.nn.softplus(params["log_h0"])[None, :],
                          (bsz, 2 * r))
    return (x, sm, h0, U.diag1, U.off1, U.c, dkt, dka, jnp.stack(b))


def _to_torch(args, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in args)


CASES = [  # (B, T, F, r, K)
    (3, 11, 9, 8, 3),  # the Pallas hold-out shape
    (5, 13, 9, 8, 3),  # odd B
    (3, 11, 9, 8, 1),  # K = 1 with the dummy dkT
    (4, 9, 17, 12, 5),
    (1, 5, 9, 8, 2),  # one row
    (2, 1, 9, 8, 3),  # one step
]


def test_reference_matches_pallas_factored(rng):
    for shape, untie_alph in [(c, False) for c in CASES] + [(CASES[0], True)]:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + (" untied" if untie_alph else "")
        args = _operands(rng, *shape, untie_alph=untie_alph)
        ref = np.asarray(drnmf_scan_pallas_factored(*args, interpret=True))
        out = tscan.drnmf_scan_factored_reference(*_to_torch(args)).numpy()
        assert out.shape == ref.shape, case
        np.testing.assert_allclose(out, ref, err_msg=case, **TOL)


def _split_order_scan(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                      dka_stack, b_stack, split):
    """Kernel B1's order of arithmetic in plain PyTorch: each rowsum as
    partial sums of 16 columns added in group order, and each
    back-projection as S partials over ``split`` rows of its contraction,
    subtracted from x_t in split order."""
    n2r = h0.shape[-1]
    group = tscan.FACTORED_GROUP
    h, outs = h0, []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        rs = torch.zeros_like(h[:, :1])
        for g0 in range(0, n2r, group):
            rs = rs + h[:, g0:g0 + group].sum(dim=1, keepdim=True)
        hidden = torch.relu(h * (diag1 - off1) + off1 * rs
                            + x_t @ dka_stack[0] + b_stack[0])
        for k in range(1, dka_stack.shape[0]):
            resid = x_t
            for s0 in range(0, n2r, split):
                resid = resid - (hidden[:, s0:s0 + split]
                                 @ dkt_stack[k - 1, s0:s0 + split])
            hidden = torch.relu(c_uk * rs + hidden + resid @ dka_stack[k]
                                + b_stack[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    return torch.stack(outs, dim=1)


def test_split_order_matches_pallas_factored(rng):
    """The split of B1's back-projection computes the TPU kernel's function:
    at a split of 8 rows (S > 1 at every shape of CASES) and at the kernel's
    own split with 2r > 2L, so S = 3."""
    cases = [(c, 8) for c in CASES] + [((2, 3, 33, 300, 2),
                                        tscan.FACTORED_SPLIT)]
    for shape, split in cases:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + f" L={split}"
        args = _operands(rng, *shape)
        assert -(-2 * shape[3] // split) > 1, case
        ref = np.asarray(drnmf_scan_pallas_factored(*args, interpret=True))
        out = _split_order_scan(*_to_torch(args), split).numpy()
        np.testing.assert_allclose(out, ref, err_msg=case, **TOL)


def test_factored_scan_plan_covers_every_output_and_fixes_the_bits():
    """B1's plan: the tiles of each phase, mapped from work items as the
    kernel maps them, cover every output exactly once; L is a multiple of
    the kernel's contraction chunk (32) and the splits cover [0, 2r); L, S
    and G depend on neither the batch nor the card (SMs, capacity)."""
    for f, n2r in ((9, 16), (257, 2000), (33, 14)):
        fixed = set()
        for bsz in (1, 3, 64, 256, 257):
            for n_sm, capacity in ((132, 264), (132, 1), (8, 24)):
                case = f"F={f} 2r={n2r} B={bsz} sm={n_sm} cap={capacity}"
                plan = tscan.factored_scan_plan(bsz, f, n2r, n_sm, capacity)
                fixed.add((plan.split, plan.splits, plan.groups))
                assert plan.bp % plan.tm == 0, case
                assert bsz <= plan.bp < bsz + plan.tm, case
                assert 1 <= plan.grid <= capacity, case
                assert plan.split % 32 == 0, case
                splits = np.zeros(n2r, int)
                for s in range(plan.splits):
                    splits[s * plan.split:(s + 1) * plan.split] += 1
                assert (splits == 1).all(), case
                # rowsum groups of 16 columns: each inside one output tile
                assert plan.groups == -(-n2r // 16), case
                assert plan.tn % 16 == 0, case
                # projections: tile -> (m0, n0)
                col_tiles = -(-n2r // plan.tn)
                hits = np.zeros((plan.bp, n2r), int)
                for tile in range(plan.bp // plan.tm * col_tiles):
                    m0 = tile // col_tiles * plan.tm
                    n0 = tile % col_tiles * plan.tn
                    hits[m0:m0 + plan.tm, n0:n0 + plan.tn] += 1
                assert (hits == 1).all(), case
                # back-projection: item -> (split, F-column tile, row tile)
                f_tiles = -(-f // plan.tf)
                hits = np.zeros((plan.splits, plan.bp, f), int)
                for item in range(plan.bp // plan.tm * f_tiles * plan.splits):
                    s = item % plan.splits
                    f0 = item // plan.splits % f_tiles * plan.tf
                    m0 = item // (plan.splits * f_tiles) * plan.tm
                    hits[s, m0:m0 + plan.tm, f0:f0 + plan.tf] += 1
                assert (hits == 1).all(), case
        assert len(fixed) == 1, (f, n2r, fixed)
    # the tiles keep the card busy at the main path's shapes
    assert tscan.factored_scan_plan(256, 257, 2000, 132, 264)[:3] == (64, 64,
                                                                     32)
    assert tscan.factored_scan_plan(64, 257, 2000, 132, 264)[:3] == (64, 16,
                                                                    32)
    assert tscan.factored_scan_plan(1, 257, 2000, 132, 264)[:3] == (16, 16, 32)


def _backward_smem_bytes(rt, resident, f, stripes, k_layers, subs):
    """The backward kernel's shared memory a block (its ``layout_floats``,
    which the card's plan asks the library for): a p tile (F x rt) or the
    row totals (S x rt), the sub-stretch partials, the chunk partials,
    four W x rt tiles, two rt vectors, the step's mask (rt bytes in rt
    floats' room), the stripe's diag1, and one layer's weight stripes (dk
    and dka^T, W x F and W x Fp) streamed, or every later layer's
    resident."""
    w, fp = tscan.BACKWARD_STRIPE, -(-f // 4) * 4
    n = (max(f, stripes) * rt + subs * w * rt
         + tscan.BACKWARD_MAX_CHUNKS * rt + 4 * w * rt + 3 * rt + w)
    pair = f * w + w * fp
    if k_layers > 1:
        n += (k_layers - 1) * pair if resident else pair
    return 4 * n


def test_backward_plan_covers_every_output_and_fixes_the_bits():
    """The backward kernel's plan: the blocks, walking their stripes and
    row tiles as the kernel does, cover every (row, column of 2r) once;
    the sub-stretches cover F once and the chunks the stripes once, at
    most BACKWARD_MAX_CHUNKS of them; W, S, the sub-stretches and the
    chunks depend on (F, 2r) alone, not on the batch, the card's shared
    memory or its capacity; the resident instance is chosen only where
    K > 1, its bytes fit and its grid covers every stripe, and the
    shared memory is that of the chosen instance."""
    h100 = 232_448

    def capacities(per_instance):
        return lambda rt, resident, smem: per_instance[resident]

    for f, n2r in ((9, 16), (257, 2000), (33, 14), (65, 100), (9, 9000)):
        fixed = set()
        for bp in (16, 32, 64, 128):
            for k in (1, 2, 5):
                for max_smem, per_instance in ((h100, {True: 132, False: 132}),
                                               (h100, {True: 0, False: 132}),
                                               (h100, {True: 64, False: 64}),
                                               (60_000, {True: 132,
                                                         False: 132}),
                                               (h100, {True: -1, False: 0})):
                    case = (f"F={f} 2r={n2r} Bp={bp} K={k} smem={max_smem} "
                            f"cap={per_instance}")
                    plan = tscan.backward_plan(bp, f, n2r, k, max_smem,
                                               capacities(per_instance),
                                               _backward_smem_bytes)
                    fixed.add((plan.stripe, plan.stripes, plan.fp, plan.sub,
                               plan.subs, plan.chunk, plan.chunks))
                    assert plan.rt in (16, 32) and bp % plan.rt == 0, case
                    assert plan.stripes == -(-n2r // plan.stripe), case
                    assert plan.fp % 4 == 0 and f <= plan.fp < f + 4, case
                    assert plan.syncs_per_step == 1 + 2 * (k - 1), case
                    smem = {res: _backward_smem_bytes(
                        plan.rt, res, f, plan.stripes, k, plan.subs)
                        for res in (True, False)}
                    fits = smem[True] <= max_smem
                    covers = per_instance[True] >= plan.stripes
                    assert plan.resident == (k > 1 and fits and covers), case
                    assert plan.smem == smem[plan.resident], case
                    assert plan.capacity == per_instance[plan.resident], case
                    assert 1 <= plan.grid <= plan.stripes, case
                    if plan.capacity >= 1:
                        assert plan.grid == min(plan.stripes,
                                                plan.capacity), case
                    if plan.resident:
                        assert plan.grid == plan.stripes, case
                    # block b: stripes b, b + grid, ..., each over every
                    # row tile
                    hits = np.zeros((bp, plan.stripes * plan.stripe), int)
                    for b in range(plan.grid):
                        for st in range(b, plan.stripes, plan.grid):
                            for rt0 in range(0, bp, plan.rt):
                                hits[rt0:rt0 + plan.rt,
                                     st * plan.stripe:(st + 1)
                                     * plan.stripe] += 1
                    assert (hits == 1).all(), case
                    cover = np.zeros(f, int)
                    for u in range(plan.subs):
                        cover[u * plan.sub:(u + 1) * plan.sub] += 1
                    assert (cover == 1).all(), case
                    cover = np.zeros(plan.stripes, int)
                    for ch in range(plan.chunks):
                        cover[ch * plan.chunk:(ch + 1) * plan.chunk] += 1
                    assert (cover == 1).all(), case
                    assert plan.chunks <= tscan.BACKWARD_MAX_CHUNKS, case
                    assert plan.subs <= tscan.BACKWARD_SUBS, case
        assert len(fixed) == 1, (f, n2r, fixed)
    # the training batch on an H100: 125 stripes of 16, one block each, the
    # weights resident (210,752 bytes of shared memory), 9 syncs a step
    plan = tscan.backward_plan(32, 257, 2000, 5, h100,
                               capacities({True: 132, False: 132}),
                               _backward_smem_bytes)
    assert plan[:3] == (32, 16, 125) and plan.resident, plan
    assert (plan.grid, plan.smem, plan.syncs_per_step) == (125, 210_752, 9)


def test_wrapper_on_cpu_runs_plain_version_and_rejects_malformed(rng):
    good = _to_torch(_operands(rng, 3, 11, 9, 8, 3))
    before = dict(tscan.LAUNCHES)
    out = tscan.drnmf_scan_factored(*good)
    assert tscan.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(), tscan.drnmf_scan_factored_reference(*good).numpy())

    for bad in ("dtype", "contiguity", "shape", "mask_dtype", "scalar",
                "x_rank", "h0_shape"):
        args = list(good)
        if bad == "dtype":
            args[0] = args[0].double()
        elif bad == "contiguity":
            args[7] = args[7].transpose(1, 2).contiguous().transpose(1, 2)
        elif bad == "shape":
            args[6] = args[6][:, :-1]
        elif bad == "mask_dtype":
            args[1] = args[1].float()
        elif bad == "scalar":
            args[4] = 0.5
        elif bad == "x_rank":
            args[0] = args[0][0]
        else:
            args[2] = args[2][:-1]
        with pytest.raises((TypeError, ValueError)):
            tscan.drnmf_scan_factored(*args)


@pytest.mark.parametrize("bsz", [4, 5])
def test_interleaved_matches_pallas_interleaved(rng, bsz):
    """``interleave=True`` on the CPU computes the function of the JAX
    interleaved entry; at an odd B that entry takes its plain kernel."""
    for K in (1, 3):
        args = _operands(rng, bsz, 9, 9, 8, K)
        ref = np.asarray(drnmf_scan_pallas_factored(*args, interpret=True,
                                                    interleave=True))
        before = dict(tscan.LAUNCHES)
        out = tscan.drnmf_scan_factored(*_to_torch(args), interleave=True)
        assert tscan.LAUNCHES == before
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6,
                                   err_msg=f"B={bsz} K={K}")


def _dense_operands(rng, bsz, t_len, f, r, K, init_form=False):
    """Operands of the dense recurrence.  U, S and W are drawn at a scale
    where every term moves the output (uniform in [0, 1/2r] keeps the state
    bounded); ``init_form`` takes them from an initialised model instead,
    as the JAX tests do.  Also returns that model for the XLA scan."""
    n2r = 2 * r
    w = rng.uniform(0.05, 1.0, (f, n2r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                      alph=10.0, lam1=0.3, params_untied=("log_D",),
                      params_trainable=("log_D", "log_U1", "log_Uk"),
                      matmul_precision="highest")
    params = init_drnmf_params(cfg, w)
    if not init_form:
        params = dict(params)
        for name in ("log_U1", "log_Uk"):
            params[name] = jnp.log(jnp.asarray(
                rng.uniform(1e-3, 1.0 / n2r, (n2r, n2r)).astype(np.float32)))
    x = rng.uniform(0.0, 2.0, (bsz, t_len, f)).astype(np.float32)
    x[0, 6:] = cfg.mask_value  # masked tail
    x = jnp.asarray(x)
    sm = step_mask_from_input(x, cfg.mask_value)
    U, S, W, b = _effective_matrices(params, cfg)
    h0 = jnp.broadcast_to(jax.nn.softplus(params["log_h0"])[None, :],
                          (bsz, n2r))
    s_stack = jnp.stack(S) if S else jnp.zeros((1, n2r, n2r), jnp.float32)
    uk = U[1] if K > 1 else jnp.zeros_like(U[0])
    args = (x, sm, h0, U[0], uk, s_stack, jnp.stack(W), jnp.stack(b))
    return args, cfg, params


@pytest.mark.parametrize("K", [1, 2, 3])
def test_dense_reference_matches_pallas_dense_and_xla(rng, K):
    for shape, init_form in (((2, 9, 24, 4), False), ((3, 11, 9, 8), False),
                             ((2, 11, 16, 4), True)):
        case = "B%d_T%d_F%d_r%d" % shape + f" K={K} init={init_form}"
        args, cfg, params = _dense_operands(rng, *shape, K,
                                            init_form=init_form)
        targs = _to_torch(args)
        before = dict(tscan.LAUNCHES)
        out = tscan.drnmf_scan_dense(*targs)  # on the CPU: the plain version
        assert tscan.LAUNCHES == before
        np.testing.assert_array_equal(
            out.numpy(), tscan.drnmf_scan_dense_reference(*targs).numpy())
        for block_t in (1, 4):
            ref = np.asarray(drnmf_scan_pallas(*args, interpret=True,
                                               block_t=block_t))
            assert out.shape == ref.shape, case
            np.testing.assert_allclose(out.numpy(), ref, err_msg=case, **TOL)
        xla = np.asarray(_scan_hidden(params, cfg, args[0], args[1]))
        np.testing.assert_allclose(out.numpy(), xla, rtol=1e-4, atol=1e-5,
                                   err_msg=case)
        if not init_form and K > 1:
            # every operand shows: without uk (or S) the output moves
            for drop in (4, 5):
                cut = list(targs)
                cut[drop] = torch.zeros_like(cut[drop])
                moved = (tscan.drnmf_scan_dense_reference(*cut) - out).abs()
                assert moved.max() > 1e-3, (case, drop)


def _dense_split_order_scan(x, step_mask, h0, u1, uk, s_stack, w_stack,
                            b_stack, split):
    """Kernel B3's order of arithmetic in plain PyTorch: each layer's
    contraction [h | hid | x_t] against [U_k ; S_{k-1} ; W_k] (no hid at
    layer 0), every segment zero-padded to a multiple of 4 depths, taken as
    one axis and cut into stretches of ``split`` depths; the stretches'
    partials added in order, then the bias, then relu."""
    n2r, f = h0.shape[-1], x.shape[-1]
    ld, fp = -(-n2r // 4) * 4, -(-f // 4) * 4

    def depth_pad(a, n, dim):  # zeros after the real depths
        pad = [0, 0] * (a.dim() - 1 - dim % a.dim()) + [0, n - a.shape[dim]]
        return torch.nn.functional.pad(a, pad)

    h, outs = h0, []
    for t in range(x.shape[1]):
        x_t = depth_pad(x[:, t], fp, -1)
        hidden = None
        for k in range(w_stack.shape[0]):
            acts = [depth_pad(h, ld, -1)]
            wts = [depth_pad(u1 if k == 0 else uk, ld, 0)]
            if k > 0:
                acts.append(depth_pad(hidden, ld, -1))
                wts.append(depth_pad(s_stack[k - 1], ld, 0))
            acts = torch.cat(acts + [x_t], dim=1)
            wts = torch.cat(wts + [depth_pad(w_stack[k], fp, 0)], dim=0)
            parts = [acts[:, v:v + split] @ wts[v:v + split]
                     for v in range(0, acts.shape[1], split)]
            pre = parts[0]
            for part in parts[1:]:
                pre = pre + part
            hidden = torch.relu(pre + b_stack[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    return torch.stack(outs, dim=1)


def test_dense_split_order_matches_pallas_dense(rng):
    """B3's fixed stretches compute the TPU kernel's function: at L = 8
    over the shapes of the dense reference test (4 to 7 stretches a layer,
    some across a segment's end) and K = 1, 2, 3, and at the plan's own L
    with 2r > 2L (8 stretches, L = 320 at 2r = 1200)."""
    cases = [(shape + (K,), init_form, 8)
             for shape, init_form in (((2, 9, 24, 4), False),
                                      ((3, 11, 9, 8), False),
                                      ((2, 11, 16, 4), True))
             for K in (1, 2, 3)]
    big = tscan.dense_scan_plan(2, 33, 1200, 264)
    assert 1200 > 2 * big.split and big.stretches == tscan.DENSE_STRETCHES
    # U from the initialised model: the scaled draw needs 2r < 1000
    cases.append(((2, 3, 33, 600, 2), True, big.split))
    for shape, init_form, split in cases:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + f" L={split}"
        args, _, _ = _dense_operands(rng, *shape, init_form=init_form)
        ref = np.asarray(drnmf_scan_pallas(*args, interpret=True))
        out = _dense_split_order_scan(*_to_torch(args), split).numpy()
        np.testing.assert_allclose(out, ref, err_msg=case, **TOL)


def test_dense_wrapper_rejects_malformed_and_picks_tiles(rng):
    good = _to_torch(_dense_operands(rng, 3, 5, 9, 8, 3)[0])
    for bad in ("dtype", "contiguity", "s_shape", "mask_dtype", "x_rank",
                "uk_shape"):
        args = list(good)
        if bad == "dtype":
            args[3] = args[3].double()
        elif bad == "contiguity":
            args[3] = args[3].T
        elif bad == "s_shape":
            args[5] = args[5][:1]
        elif bad == "mask_dtype":
            args[1] = args[1].float()
        elif bad == "x_rank":
            args[0] = args[0][0]
        else:
            args[4] = args[4][:-1]
        with pytest.raises((TypeError, ValueError)):
            tscan.drnmf_scan_dense(*args)

    # B3's plan: the items, mapped as the kernel maps them, cover every
    # (stretch, row of 2r, batch column) once; the stretches cover a
    # layer's contraction axis [h | hid | x_t] once; L, the stretch count
    # and the padded widths depend on (F, 2r) alone; Bp and Fp are
    # multiples of the batch tile and of 4
    for f, n2r in ((9, 16), (257, 2000), (33, 14)):
        fixed = set()
        for bsz in (1, 3, 64, 256, 257):
            for capacity in (264, 1, 24):
                case = f"F={f} 2r={n2r} B={bsz} cap={capacity}"
                plan = tscan.dense_scan_plan(bsz, f, n2r, capacity)
                fixed.add((plan.m_tile, plan.split, plan.stretches, plan.fp,
                           plan.ld))
                assert plan.ni in tscan.DENSE_BATCH_TILES, case
                assert plan.bp % plan.ni == 0 and plan.bp % 4 == 0, case
                assert bsz <= plan.bp < bsz + plan.ni, case
                assert plan.fp % 4 == 0 and f <= plan.fp < f + 4, case
                assert plan.ld % 4 == 0 and n2r <= plan.ld < n2r + 4, case
                assert plan.split % 16 == 0, case
                assert plan.stretches <= tscan.DENSE_STRETCHES, case
                assert 1 <= plan.grid <= min(capacity, plan.items), case
                for depths in (plan.ld + plan.fp, 2 * plan.ld + plan.fp):
                    cover = np.zeros(depths, int)
                    for v in range(0, depths, plan.split):
                        cover[v:v + plan.split] += 1
                    assert (cover == 1).all(), case
                assert plan.stretches == -(-(2 * plan.ld + plan.fp)
                                           // plan.split), case
                # a later layer's products: item -> (stretch, row tile,
                # batch tile), the batch tile fastest
                mt = -(-n2r // plan.m_tile)
                bt = plan.bp // plan.ni
                assert plan.items == plan.stretches * mt * bt, case
                hits = np.zeros((plan.stretches, mt * plan.m_tile, plan.bp),
                                np.uint8)
                for item in range(plan.items):
                    col0 = item % bt * plan.ni
                    row0 = item // bt % mt * plan.m_tile
                    s = item // (bt * mt)
                    hits[s, row0:row0 + plan.m_tile, col0:col0 + plan.ni] += 1
                assert (hits == 1).all(), case
        assert len(fixed) == 1, (f, n2r, fixed)
    # the paths' shapes on an H100 (132 SMs, two blocks an SM): one row
    # and 64 rows a later layer of 128 items, one an SM; 256 rows two
    # rounds of the resident blocks
    for bsz, ni, items in ((1, 8, 128), (64, 64, 128), (256, 64, 512)):
        plan = tscan.dense_scan_plan(bsz, 257, 2000, 264)
        assert (plan.ni, plan.items) == (ni, items), (bsz, plan)


def _interleaved_order_scan(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                            dka_stack, b_stack, split):
    """Kernel B2's order of arithmetic in plain PyTorch: rows [0, ceil(B/2))
    and the rest as two chains, each run on its own; each rowsum as
    partial sums of 16 columns added in group order; each back-projection
    as partials over ``split`` rows of 2r subtracted from x_t in stretch
    order; each projection whole, added to the epilogue's other terms
    before the bias."""
    n2r = h0.shape[-1]
    group = tscan.FACTORED_GROUP

    def chain(x, step_mask, h):
        outs = []
        for t in range(x.shape[1]):
            x_t = x[:, t]
            rs = torch.zeros_like(h[:, :1])
            for g0 in range(0, n2r, group):
                rs = rs + h[:, g0:g0 + group].sum(dim=1, keepdim=True)
            hidden = torch.relu(h * (diag1 - off1) + off1 * rs
                                + x_t @ dka_stack[0] + b_stack[0])
            for k in range(1, dka_stack.shape[0]):
                resid = x_t
                for s0 in range(0, n2r, split):
                    resid = resid - (hidden[:, s0:s0 + split]
                                     @ dkt_stack[k - 1, s0:s0 + split])
                hidden = torch.relu(c_uk * rs + hidden
                                    + resid @ dka_stack[k] + b_stack[k])
            h = torch.where(step_mask[:, t, None], hidden, h)
            outs.append(h)
        return torch.stack(outs, dim=1)

    half = -(-x.shape[0] // 2)
    chains = [chain(x[rows], step_mask[rows], h0[rows])
              for rows in (slice(0, half), slice(half, None))
              if x[rows].shape[0]]
    return torch.cat(chains, dim=0)


def test_interleaved_order_matches_pallas_interleaved(rng):
    """B2's chains, stretches and summed residual compute the TPU
    interleaved kernel's function: at stretches of 8 rows of 2r (S > 1 at
    every shape of CASES, B = 1 with an empty chain B, odd B with chains
    of unequal length), and at the plan's own stretches with 2r > 2L
    (S = 13 at 2r = 600)."""
    cases = [(c, 8) for c in CASES]
    own = tscan.interleaved_scan_plan(4, 65, 600, 132, 396)
    assert own.splits > 2
    cases.append(((4, 3, 65, 300, 2), own.split))
    for shape, split in cases:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + f" L={split}"
        args = _operands(rng, *shape)
        assert -(-2 * shape[3] // split) > 1
        ref = np.asarray(drnmf_scan_pallas_factored(*args, interpret=True,
                                                    interleave=True))
        out = _interleaved_order_scan(*_to_torch(args), split).numpy()
        np.testing.assert_allclose(out, ref, err_msg=case, **TOL)


def test_interleaved_scan_plan_covers_every_output_and_fixes_the_bits():
    """B2's plan: chain A holds rows [0, ceil(B/2)), chain B the rest, each
    padded to the same multiple of the batch tile; the items of each
    phase, mapped as the kernel maps them, cover every (stretch, output
    row of the weights, scratch row of both chains) once; the stretches
    cover 2r once and are multiples of the 16-deep stage; L, S, G and the
    padded widths depend on neither the batch nor the card;
    and the projection has as many items as the card has SMs wherever the
    batch allows."""
    cards = ((132, 396), (132, 1), (8, 24))
    for f, n2r in ((9, 16), (257, 2000), (33, 14)):
        fixed = set()
        for bsz in (1, 2, 3, 64, 256, 257):
            for n_sm, capacity in cards:
                case = f"F={f} 2r={n2r} B={bsz} sm={n_sm} cap={capacity}"
                plan = tscan.interleaved_scan_plan(bsz, f, n2r, n_sm,
                                                   capacity)
                fixed.add((plan.split, plan.splits, plan.groups, plan.fp,
                           plan.ld))
                assert plan.mt == tscan.INTERLEAVED_M_TILE, case
                assert plan.ni in tscan.INTERLEAVED_BATCH_TILES, case
                assert plan.half == -(-bsz // 2), case
                assert plan.bpc % plan.ni == 0, case
                assert plan.half <= plan.bpc < plan.half + plan.ni, case
                assert plan.fp % 4 == 0 and f <= plan.fp < f + 4, case
                assert plan.ld % 4 == 0 and n2r <= plan.ld < n2r + 4, case
                assert 1 <= plan.grid <= capacity, case
                assert plan.grid == min(capacity,
                                        max(plan.p_items, plan.bp_items))
                assert plan.groups == -(-n2r // 16), case
                assert plan.mt % 16 == 0, case  # a rowsum group in a tile
                assert plan.split % 16 == 0, case
                cover = np.zeros(n2r, int)
                for s in range(plan.splits):
                    cover[s * plan.split:(s + 1) * plan.split] += 1
                assert (cover == 1).all(), case
                # scratch rows: chain A [0, bpc), chain B [bpc, 2 bpc)
                rows = 2 * plan.bpc
                batch_of = [r if r < plan.half else -1
                            for r in range(plan.bpc)]
                batch_of += [plan.half + i if plan.half + i < bsz else -1
                             for i in range(plan.bpc)]
                assert sorted(b for b in batch_of if b >= 0) == list(
                    range(bsz)), case
                bt = plan.bpc // plan.ni
                for out_rows, stretches, items in (
                        (n2r, 1, plan.p_items),
                        (plan.fp, plan.splits, plan.bp_items)):
                    mt = -(-out_rows // plan.mt)
                    assert items == stretches * mt * bt, case
                    hits = np.zeros((stretches, mt * plan.mt, rows), np.uint8)
                    for item in range(items):
                        col0 = item % bt * plan.ni
                        row0 = item // bt % mt * plan.mt
                        s = item // (bt * mt)
                        for c0 in (col0, plan.bpc + col0):
                            hits[s, row0:row0 + plan.mt,
                                 c0:c0 + plan.ni] += 1
                    assert (hits == 1).all(), case
                if n_sm == 132 and f == 257 and bsz >= 64:
                    assert plan.p_items >= 128, case
        assert len(fixed) == 1, (f, n2r, fixed)
    # the paths' shapes on an H100: 8 columns a chain at a few rows and at
    # 64 rows (128 items, where 16 columns would give 64), 16 at 256 rows
    for bsz, tiles in ((1, (64, 8)), (64, (64, 8)), (256, (64, 16))):
        plan = tscan.interleaved_scan_plan(bsz, 257, 2000, 132, 396)
        assert (plan.mt, plan.ni) == tiles, (bsz, plan)
