"""The scoring engine with each bucket's files split over ranks
(counterpart of ``drnmf_tpu/metrics/sharded.py``).

The reference scored files with a MATLAB ``parfor`` pool
(score_audio.m:72-98); the engine (``engine.py``) scores each
power-of-two bucket as one batched pass on one device.  Here every rank
of a group takes its share of each bucket's rows:

- rows are dealt to ranks longest-first (greedy LPT on samples), so the
  ranks' packed buffers balance; each rank packs and uploads only its
  rows;
- the ladder (ridge escalation, the exact host SDR fallback) is the
  engine's own ``_score_pass``, its device passes swapped for a pass over
  this rank's rows whose (rows, 7) results are gathered over the group,
  so every rank commits the same rows and takes the same retries;
- ``align="guard"`` rows with a nonzero delay are rescored through the
  single-process engine (``score_all_packed``, on every rank: rare, the
  mask pipeline is sample-aligned).

Every rank returns the whole (n_files, 6) scores and delays.
"""

import numpy as np
import torch

from .bss_eval import FLEN, _next_pow2
from .engine import (_as_f32, _engine_bucket, _fused_packed_any,
                     _score_pass, score_all_packed)
from .fused import pack_pair, to_device


def deal_rows(idxs, lens, n_shards):
    """The rows ``idxs`` dealt to ``n_shards`` ranks longest-first, each to
    the rank with the fewest samples so far (the first of equals)."""
    shards = [[] for _ in range(n_shards)]
    load = np.zeros(n_shards, np.int64)
    for i in sorted(idxs, key=lambda i: -lens[i]):
        s = int(np.argmin(load))
        shards[s].append(int(i))
        load[s] += lens[i]
    return shards


def score_all_sharded(est_list, ref_list, mesh, axis="dp", fs: int = 16000,
                      compute_pesq: bool = True, flen: int = FLEN,
                      tf: float = 0.01, align: str = "guard"):
    """(n_files, 6) scores and (n_files,) delays, as
    ``engine.score_all_packed`` gives them, each bucket's rows split over
    the ranks of ``mesh``'s ``axis`` (module docstring); every rank calls
    it with the same lists."""
    if align not in ("guard", "off"):
        raise ValueError(f"align must be guard/off, got {align!r}")
    device = mesh.device
    n_shards, me = mesh.size(axis), mesh.index(axis)
    n_files = len(est_list)
    S = np.zeros((n_files, 6), np.float64)
    delays = np.zeros(n_files, np.int64)
    frame_len = int(round(tf * fs))
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    is_i16 = all(np.asarray(x).dtype == np.int16 for x in est_list) and all(
        np.asarray(x).dtype == np.int16 for x in ref_list)
    pack_dtype = np.int16 if is_i16 else np.float32

    # items as the engine's, with this rank's buffers in place of the
    # bucket's and the dealt shards last; idxs in the gathered row order
    work = []
    for nfft, idxs in sorted(buckets.items()):
        shards = deal_rows(idxs, lens, n_shards)
        mine = shards[me]
        args = None
        if mine:
            est_c, ref_c, offsets = pack_pair(
                est_list, ref_list, mine, lens, pack_dtype,
                convert=None if is_i16 else _as_f32)
            off = to_device(offsets, device)
            args = (to_device(est_c, device), to_device(ref_c, device), off,
                    off, to_device(lens[mine], device))
        order = np.asarray([i for shard in shards for i in shard])
        work.append([nfft, order, args, np.ones(len(order), bool), None,
                     None, shards])

    def gathered(w, local, width):
        if local is None:
            local = torch.zeros((0, width), dtype=torch.float32,
                                device=device)
        return mesh.gather_uneven(local, [len(s) for s in w[6]], axis=axis)

    def bucket_fn(w, ridge):
        local = (_engine_bucket(w, ridge, flen, frame_len, fs, compute_pesq)
                 if w[2] is not None else None)
        return gathered(w, local, 7)

    def fused_fn(w, ridge):
        local = (_fused_packed_any(w, ridge, flen, frame_len)
                 if w[2] is not None else None)
        return gathered(w, local, 4)

    _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn=lambda i: (_as_f32(est_list[i], lens[i]),
                                    _as_f32(ref_list[i], lens[i])),
                commit_delay=True, device=device, bucket_fn=bucket_fn,
                fused_fn=fused_fn)

    if align == "guard":
        shifted = np.nonzero(delays != 0)[0]
        if len(shifted):
            S2, d2 = score_all_packed(
                [est_list[int(i)] for i in shifted],
                [ref_list[int(i)] for i in shifted],
                fs, compute_pesq=compute_pesq, flen=flen, tf=tf,
                align="guard", device=device)
            S[shifted] = S2
            delays[shifted] = d2
    return S, delays
