"""STFT / iSTFT primitives, windows and wav I/O (reference: util.py)."""

from .stft import (SAMPLE_BUCKET, bucket_total, istft, istft_frames,
                   n_frames_for_length, overlap_add, pad_signal,
                   padded_length, stft, stft_frames)
from .wav import wavread, wavread_fs, wavwrite
from .windows import hann_periodic, sqrt_hann_periodic

__all__ = [
    "SAMPLE_BUCKET", "bucket_total", "istft", "istft_frames",
    "n_frames_for_length", "overlap_add", "pad_signal", "padded_length",
    "stft", "stft_frames", "wavread", "wavread_fs", "wavwrite",
    "hann_periodic", "sqrt_hann_periodic",
]
