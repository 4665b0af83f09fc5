"""Kaldi-compatible log-mel filterbank in PyTorch (counterpart of ``funasr_tpu/ops/fbank.py``).

Same pipeline as the JAX version (behaviour of ``torchaudio.compliance.kaldi.fbank`` as
the reference frontend uses it: hamming 25 ms / 10 ms, snip_edges, remove_dc_offset,
preemphasis 0.97, power spectrum, kaldi mel banks from 20 Hz):

    frame -> dc removal -> preemph -> window -> real DFT (512) -> |.|^2 -> mel -> log

The real DFT is a fp32 matmul against ``_dft_matrix``, as in the JAX package, which runs
it at HIGHEST precision (``fbank.py:180-184``); the package turns TF32 off
(``funasr_tpu_torch/__init__.py``) so the CUDA matmul stays full fp32.
Dither (kaldi's gaussian noise on the frames) applies only with a ``generator``, the
training step's, as the JAX package applies it only with a key.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # float32 eps, the kaldi/torchaudio log floor
PREEMPHASIS = 0.97


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(
    num_bins: int = 80,
    padded_window_size: int = 512,
    sample_freq: float = 16000.0,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel bank matrix, shape (padded_window_size//2 + 1, num_bins).

    Last fft bin (nyquist) row is zero, matching kaldi's bank computed over nfft/2 bins.
    """
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = high_freq + nyquist
    fft_bin_width = sample_freq / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    fft_mels = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up = (fft_mels - left_mel) / (center_mel - left_mel)
    down = (right_mel - fft_mels) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up, down))
    banks = np.concatenate([banks, np.zeros((num_bins, 1))], axis=1)  # nyquist bin
    return np.ascontiguousarray(banks.T.astype(np.float32))  # (nfft//2+1, num_bins)


def feature_window(window_type: str, size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    a = 2.0 * math.pi / (size - 1)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(size)
    elif window_type == "blackman":
        blackman_coeff = 0.42
        w = (
            blackman_coeff
            - 0.5 * np.cos(a * n)
            + (0.5 - blackman_coeff) * np.cos(2 * a * n)
        )
    else:
        raise ValueError(f"unknown window type {window_type}")
    return w.astype(np.float32)


def num_frames(num_samples: int, frame_length: int = 400, frame_shift: int = 160,
               snip_edges: bool = True) -> int:
    if snip_edges:
        if num_samples < frame_length:
            return 0
        return 1 + (num_samples - frame_length) // frame_shift
    return (num_samples + frame_shift // 2) // frame_shift


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=4)
def _dft_matrix(nfft: int, frame_length: int):
    """(frame_length, 2*(nfft//2+1)) real-DFT matrix [cos | -sin].

    Row k of rfft(pad(x, nfft)) equals x @ cos_k - i * (x @ sin_k); only the
    first ``frame_length`` rows are kept since the pad region contributes 0."""
    nbins = nfft // 2 + 1
    n = np.arange(nfft, dtype=np.float64)[:, None]
    k = np.arange(nbins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    m = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return m[:frame_length].astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(fn, args, device):
    """A numpy constant table moved to ``device`` once per (table, device)."""
    return torch.from_numpy(fn(*args)).to(device)


def fbank(
    waveform,
    *,
    num_mel_bins: int = 80,
    frame_length: int = 400,
    frame_shift: int = 160,
    sample_frequency: float = 16000.0,
    window_type: str = "hamming",
    snip_edges: bool = True,
    dither: float = 0.0,
    generator=None,
):
    """waveform (..., N) float32 (already scaled, e.g. *32768) -> (..., T, num_mel_bins).

    Leading axes are a batch: ``fbank_batch`` passes (B, N) in one call. DC removal,
    preemphasis 0.97, the power spectrum and mel banks from 20 Hz to Nyquist are the
    reference frontend's fixed settings. ``dither`` (kaldi's gaussian noise on each
    frame's samples, ``funasr_tpu/ops/fbank.py:164-165``) applies only when a
    ``generator`` (on the waveform's device) is given: the training path's.
    """
    n = waveform.shape[-1]
    dev = waveform.device
    t = num_frames(n, frame_length, frame_shift, snip_edges)
    if t == 0:
        return torch.zeros(waveform.shape[:-1] + (0, num_mel_bins), device=dev)
    w = waveform.float()
    rows_per_frame = -(-frame_length // frame_shift)
    pad_n = (t - 1 + rows_per_frame) * frame_shift
    if pad_n > n:
        w = torch.nn.functional.pad(w, (0, pad_n - n))
    frames = w.unfold(-1, frame_length, frame_shift)[..., :t, :]  # (..., T, L)
    if dither != 0.0 and generator is not None:
        frames = frames + dither * torch.randn(frames.shape, generator=generator, device=dev)

    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * prev
    frames = frames * _on_device(feature_window, (window_type, frame_length), dev)

    nfft = _next_pow2(frame_length)
    spec2 = torch.matmul(frames, _on_device(_dft_matrix, (nfft, frame_length), dev))
    nbins = nfft // 2 + 1
    power = spec2[..., :nbins].square() + spec2[..., nbins:].square()
    banks = _on_device(kaldi_mel_banks, (num_mel_bins, nfft, sample_frequency), dev)
    mel = torch.matmul(power, banks)
    return torch.log(torch.clamp_min(mel, EPSILON))


def fbank_batch(waveforms, lengths, **kwargs):
    """(B, N) waveforms + (B,) sample lengths -> ((B, T, M) feats, (B,) frame lengths).

    Frames whose window crosses a row's sample length are garbage for that row; the
    returned frame lengths mask them. T comes from the padded N.
    """
    feats = fbank(waveforms, **kwargs)
    frame_length = kwargs.get("frame_length", 400)
    frame_shift = kwargs.get("frame_shift", 160)
    flens = torch.where(lengths < frame_length, 0,
                        1 + (lengths - frame_length) // frame_shift)
    return feats, flens.to(torch.int32)
