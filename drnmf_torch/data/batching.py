"""Sequence tensorization: frame stacks -> padded batch tensors
(counterpart of ``drnmf_tpu/data/batching.py``).

* ``reshape_and_pad_stacks``: (2F, total_frames) stacks + fidx -> padded
  (n_seq, maxlen, F') arrays, utterances longer than ``maxlen`` cut into
  several sequences with the reference's cursor semantics
  (audio_dataset.py:116-169), plus the binary validity mask.
* transforms: 'mag' = sqrt(re^2+im^2) of the real-composite stack,
  'logmag' = log(1+mag); mask value -1 for 'mag'/'logmag' else 0.
* ``masked_seqs_to_frames``: (B, T, F) + mask -> (F, n_valid_frames), the
  flattening that feeds NMF training (util.py:19-27).

These run in numpy on the host, as in the JAX package, except
``masked_seqs_to_frames``, which takes tensors on any device.
"""

import numpy as np
import torch


def get_mask_value(transform_x: str, transform_y: str) -> float:
    """-1 for the nonnegative feature transforms ('mag' >= 0 and
    'logmag' = log(1 + mag) >= 0, so -1 is unattainable for both), 0
    otherwise.  Fixes rather than copies the reference quirk where
    transform_x's branch inspected config['transform_y'] for 'logmag'
    (audio_dataset.py:24); identical for every configuration the reference
    ships (mag/mag)."""
    if transform_x in ("mag", "logmag") or transform_y in ("mag", "logmag"):
        return -1.0
    return 0.0


def make_transform(name: str):
    """Stack transform: operates on the real-composite (2F', n) layout."""
    if name == "mag":
        return lambda s: np.sqrt(
            s[: s.shape[0] // 2] ** 2 + s[s.shape[0] // 2 :] ** 2
        )
    if name == "logmag":
        return lambda s: np.log(
            np.float32(1.0)
            + np.sqrt(s[: s.shape[0] // 2] ** 2 + s[s.shape[0] // 2 :] ** 2)
        )
    if name in (None, "none", "identity"):
        return lambda s: s
    raise ValueError(f"unknown transform '{name}'")


def reshape_and_pad_stacks(x_stack, y_stack, fidx, transform_x=None,
                           transform_y=None, pad_value=0.0, maxlen=None):
    """Chunk utterances into <=maxlen-frame sequences and pad.

    Returns (x, y, mask) with shapes (n_seq, maxlen, d), mask (n_seq, maxlen, 1).
    """
    if transform_x is None:
        transform_x = lambda s: s
    if transform_y is None:
        transform_y = lambda s: s
    fidx = np.asarray(fidx)
    lens = fidx[:, 1] - fidx[:, 0]
    maxseq = int(np.max(lens))
    if maxlen is None or maxlen > maxseq:
        maxlen = maxseq
    d = transform_x(x_stack[:, 0:1]).shape[0]

    if maxlen == maxseq:
        n_seq = fidx.shape[0]
    else:
        n_seq = int(np.sum(np.ceil(lens / maxlen)))

    x = np.full((n_seq, maxlen, d), pad_value, dtype=np.float32)
    y = np.full((n_seq, maxlen, d), pad_value, dtype=np.float32)
    mask = np.zeros((n_seq, maxlen, 1), dtype=np.float32)

    t = 0
    i_wav = 0
    for i in range(n_seq):
        t_end = t + maxlen
        bump = False
        if t_end >= fidx[i_wav, 1]:
            t_end = int(fidx[i_wav, 1])
            bump = True
        x[i, : t_end - t] = transform_x(x_stack[:, t:t_end]).T
        y[i, : t_end - t] = transform_y(y_stack[:, t:t_end]).T
        mask[i, : t_end - t] = 1.0
        if bump and i < n_seq - 1:
            i_wav += 1
            t = int(fidx[i_wav, 0])
        else:
            t += maxlen
    return x, y, mask


def pad_axis_to_n(x, axis, n, constant):
    """Pad one axis up to length n with a constant (util.py:355-374)."""
    spec = [(0, 0)] * x.ndim
    spec[axis] = (0, n - x.shape[axis])
    return np.pad(x, spec, mode="constant", constant_values=constant)


def load_split(dataset, transform_x="mag", transform_y="mag", maxlen=None):
    """Build (x, y, mask) tensors for one split (load_data semantics,
    audio_dataset.py:20-87): transform, chunk, pad to common maxseq."""
    mask_value = get_mask_value(transform_x, transform_y)
    tx = make_transform(transform_x)
    ty = make_transform(transform_y)
    x, y, mask = dataset.get_padded_data_matrix(
        transform_x=tx, transform_y=ty, pad_value=mask_value, maxlen=maxlen
    )
    return x, y, mask


def masked_seqs_to_frames(x, mask):
    """(B, T, F) sequences + (B, T, 1) binary mask -> (F, n_valid) frame
    matrix, frames in (b, t) order.  Tensors (on any device) or arrays;
    the result is a tensor on ``x``'s device."""
    x = torch.as_tensor(x)
    mask = torch.as_tensor(mask).to(x.device)
    b, t, f = x.shape
    flat = x.permute(2, 0, 1).reshape(f, b * t)
    mflat = mask.permute(2, 0, 1).reshape(b * t)
    return flat[:, mflat > 0]
