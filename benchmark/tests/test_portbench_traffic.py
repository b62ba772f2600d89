"""The traffic generators repeat exactly from a seed; another seed keeps the
set of sizes and changes only their order and the audio."""

import numpy as np
import torch

from benchmark.tests.tiny import LENGTHS, TINY_OFFLINE, TINY_TRAIN
from benchmark.yardstick import corpus


def test_quantile_lengths_are_the_distribution_as_a_fixed_set():
    secs = corpus.quantile_lengths(2001)
    assert np.all(np.diff(secs) >= 0)
    assert abs(np.median(secs) - 7.0) < 1e-9
    assert secs.min() >= 2.5 and secs.max() == 16.0
    draws = corpus.wsj0_like_lengths(np.random.default_rng(0), 200_000)
    assert abs(np.mean(secs) - np.mean(draws)) < 0.02


def test_synth_pairs_repeat_from_a_seed():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return corpus.synth_pairs(gen, [300, 500, 411], [-6, 0, 9], 2000,
                                  "cpu")

    (c1, n1), (c2, n2), (c3, _) = draw(5), draw(5), draw(6)
    assert torch.equal(c1, c2) and torch.equal(n1, n2)
    assert not torch.equal(c1, c3)
    assert torch.all(c1[0, 300:] == 0) and torch.all(n1[2, 411:] == 0)
    assert n1.abs().max() <= 1.0
    # the SNR of the first signal is -6 dB
    noise = (n1[0, :300] - c1[0, :300]).double()
    snr = 10 * torch.log10((c1[0, :300].double() ** 2).sum()
                           / (noise ** 2).sum())
    assert abs(float(snr) + 6.0) < 1e-3


def _corpus(seed):
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    return corpus.offline_corpus(TINY_OFFLINE, 5, 2, 2000, rng, gen, "cpu")


def test_offline_corpus_repeats_and_keeps_its_lengths_across_seeds():
    a, b, c = _corpus(11), _corpus(11), _corpus(12)
    assert all(np.array_equal(x, y) for ca, cb in zip(a, b)
               for x, y in zip(ca, cb))
    lens = [sorted(len(s) for s in call) for call in a + c]
    assert all(ln == lens[0] for ln in lens)
    assert [len(s) for s in a[0]] != [len(s) for s in c[0]] or not all(
        np.array_equal(x, y) for x, y in zip(a[0], c[0]))


def test_train_split_repeats_from_a_seed_and_masks_each_tail():
    def split(seed):
        return corpus.train_split(TINY_TRAIN, 32, 8, 2000, -1.0,
                                  np.random.default_rng(seed),
                                  torch.Generator().manual_seed(seed), "cpu")

    x1, y1, m1, v1 = split(3)
    x2, y2, m2, v2 = split(3)
    _, _, _, v3 = split(4)
    assert torch.equal(x1, x2) and torch.equal(y1, y2) and torch.equal(m1, m2)
    assert x1.shape == (16, 16, 17) and m1.shape == (16, 16, 1)
    assert np.array_equal(v1, m1[..., 0].sum(dim=1).numpy())
    masked = m1[..., 0] == 0
    assert torch.all(x1[masked] == -1.0) and torch.all(y1[masked] == -1.0)
    assert torch.all(x1[~masked] >= 0)
    assert sorted(v1.tolist()) == sorted(v3.tolist()) or abs(
        v1.sum() - v3.sum()) <= TINY_TRAIN["maxlen"] * 2
    assert LENGTHS["max_s"] * 2000 / 8 + 5 >= v1.max()
