"""Shape bucketing, copied from ``funasr_tpu/utils/bucket.py``.

PyTorch needs no fixed shapes, but the buckets set every output shape of the decode
(the waveform bucket sets the frame count, the frame bucket the encoder T and with it
the decoder token budget), so the port pads exactly as the JAX package does.
"""

from __future__ import annotations

import math

import torch


def bucket_length(n: int, *, minimum: int = 16, ratio: float = 1.25,
                  multiple: int = 16) -> int:
    """Smallest grid value >= n: geometric grid (factor ``ratio``) snapped up to
    ``multiple``."""
    n = max(int(n), 1)
    b = minimum
    while b < n:
        b = int(math.ceil(b * ratio))
    return ((b + multiple - 1) // multiple) * multiple


def bucket_batch(b: int) -> int:
    """Next power of two >= b."""
    return 1 << max(int(b) - 1, 0).bit_length()


def bucket_frames(t: int, multiple: int = 128) -> int:
    """Encoder frame-count bucket: snap up to a multiple of 128."""
    return max(multiple, -(-int(t) // multiple) * multiple)


def pad_feats_bucketed(speech, lengths, t_multiple: int = 128):
    """Pad a (B, T, D) feature batch to (bucket_batch(B), bucket_frames(T), D).

    Extra batch rows replicate row 0 (a fully-masked row would softmax over an
    empty set); extra frames are zeros (masked off by ``lengths``). Returns
    (speech_padded, lengths_padded int32, real_b), on speech's device.
    """
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=speech.device)
    b, t = speech.shape[0], speech.shape[1]
    bb, tb = bucket_batch(b), bucket_frames(t, t_multiple)
    if tb > t:
        speech = torch.nn.functional.pad(speech, (0, 0) * (speech.ndim - 2) + (0, tb - t))
    if bb > b:
        speech = torch.cat([speech, speech[:1].expand((bb - b,) + speech.shape[1:])])
        lengths = torch.cat([lengths, lengths[:1].expand(bb - b)])
    return speech, lengths, b
