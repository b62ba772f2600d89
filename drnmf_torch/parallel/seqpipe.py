"""Sequence-parallel DR-NMF recurrence: the time axis split over ranks and
run as a wavefront pipeline (counterpart of
``drnmf_tpu/parallel/seqpipe.py``).

The recurrence carries one (2r,) state a sequence, so exact sequence
parallelism is a pipeline: rank ``p`` of ``P`` owns the contiguous time
chunk ``[p T/P, (p+1) T/P)`` and starts it from the state rank ``p - 1``
ended its chunk with, handed over by ``Mesh.shift``.  One sequence would
leave every rank but one idle, so the batch is split into G groups (default
P): at wave ``s`` rank ``p`` runs group ``g = s - p`` through its chunk,
G + P - 1 waves in all, each rank busy G of them.

Each chunk runs on the port's own recurrence: ``make_scan(params,
config)`` is prepared once and called with the carried state
(``state=``), so a chunk is one launch of kernel B1 (U frozen and folded)
or B3 (U dense) on the card, counted in ``ops.drnmf_scan.LAUNCHES``.  A
chunk's final state is its last output row, since masked steps hold the
carry.  The result is gathered over the ranks, so each holds the (B, T,
2r) hidden states.  Inference only (the JAX package's tests use it so).
"""

import torch

from .mesh import Mesh


def check_seq_pipelined(config, shape, n_ranks: int, n_groups=None) -> int:
    """The refusals of ``drnmf_tpu/parallel/seqpipe.py:59-70`` for an input
    of ``shape`` (B, T, F) over ``n_ranks``; returns the number of groups."""
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError(
            "sequence-pipelined scan supports the inference cell only "
            "(no return_all_hidden, no dropout); use the single-device scan")
    bsz, t_total = shape[0], shape[1]
    if t_total % n_ranks:
        raise ValueError(f"T={t_total} not divisible by sp={n_ranks}")
    n_groups = n_groups or n_ranks
    if bsz % n_groups:
        raise ValueError(f"B={bsz} not divisible by n_groups={n_groups}")
    return n_groups


def drnmf_scan_seq_pipelined(params, config, x, step_mask, mesh: Mesh,
                             n_groups=None):
    """Hidden states (B, T, 2r) of the recurrence with the time axis split
    over the ranks of the group.  ``x`` (B, T, F) and ``step_mask`` (B, T)
    are whole and the same on every rank (each takes its chunk), on the
    rank's device; ``params``: name -> array or tensor.  T must be
    divisible by the ranks and B by ``n_groups`` (default: the ranks).
    Equal to the single-process scan: the pipeline reorders where chunks
    run, not the arithmetic of a row."""
    from ..device import params_on_device
    from ..models.drnmf import make_scan

    n_sp = mesh.world
    n_groups = check_seq_pipelined(config, tuple(x.shape), n_sp, n_groups)
    p = mesh.rank
    bsz, t_total = x.shape[0], x.shape[1]
    gsz, t_loc = bsz // n_groups, t_total // n_sp
    chunk = slice(p * t_loc, (p + 1) * t_loc)
    with torch.no_grad():
        run = make_scan(params_on_device(params, x.device), config)
        x_loc = x[:, chunk]
        m_loc = step_mask[:, chunk]
        out = x.new_zeros((bsz, t_loc, config.hidden_dim))
        carry = x.new_zeros((gsz, config.hidden_dim))
        for s in range(n_groups + n_sp - 1):
            # the state rank p - 1 ended group s - p's chunk with
            recv = mesh.shift(carry)
            g = s - p
            if not 0 <= g < n_groups:
                continue  # a bubble: nothing of this rank's to run
            rows = slice(g * gsz, (g + 1) * gsz)
            hs = run(x_loc[rows], m_loc[rows],
                     state=None if p == 0 else recv)
            out[rows] = hs
            carry = hs[:, -1]
        return mesh.gather(out, "world", dim=1)
