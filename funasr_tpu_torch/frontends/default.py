"""Espnet-style log-mel frontend (STFT -> power -> slaney mel -> log), a copy of
``funasr_tpu/frontends/default.py`` for the PyTorch port.

Host numpy DSP, as in the JAX package, so the features are bit-equal to its own on the
same waves. ``extract(audio_list, device=None)`` is the port's batched form
(``utils/load_utils.py::extract_fbank``): numpy without a device, tensors on the device
with one. The cmvn file is read with the port's own ``ops/lfr.py::load_cmvn``.
"""

from __future__ import annotations

import numpy as np

from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import as_unit_f32


def slaney_mel_banks(n_mels: int, n_fft: int, fs: int, fmin: float = 0.0,
                     fmax: float = None) -> np.ndarray:
    """librosa-convention (slaney-normalized) triangular mel filterbank
    (n_mels, n_fft//2+1)."""
    fmax = fmax or fs / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0)
                       / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((m - 15.0) * (np.log(6.4) / 27.0)),
                     f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, fs / 2.0, n_fft // 2 + 1)
    banks = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / max(freqs[i + 1] - freqs[i], 1e-9)
        upper = (freqs[i + 2] - fft_freqs) / max(freqs[i + 2] - freqs[i + 1], 1e-9)
        banks[i] = np.maximum(0.0, np.minimum(lower, upper))
        # slaney normalization: constant energy per channel
        banks[i] *= 2.0 / max(freqs[i + 2] - freqs[i], 1e-9)
    return banks.astype(np.float32)


def apply_lfr(feats: np.ndarray, lfr_m: int, lfr_n: int) -> np.ndarray:
    """(T, D) -> (ceil(T/n), m*D): the clamped gather of ``funasr_tpu/ops/lfr.py::
    apply_lfr`` in numpy (a gather: the same values)."""
    t, d = feats.shape
    t_lfr = -(-t // lfr_n)
    idx = np.arange(t_lfr)[:, None] * lfr_n + np.arange(lfr_m)[None, :] - (lfr_m - 1) // 2
    return feats[np.clip(idx, 0, t - 1)].reshape(t_lfr, lfr_m * d)


def pad_batch(feats, device=None):
    """Per-utterance (T_i, D) features -> ((B, T, D) zero-padded, (B,) int32 lengths):
    numpy without ``device``, tensors on ``device`` with one."""
    lens = np.asarray([f.shape[0] for f in feats], np.int32)
    maxlen = max(1, int(lens.max()) if len(lens) else 1)
    out = np.zeros((len(feats), maxlen, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        out[i, : f.shape[0]] = f
    if device is None:
        return out, lens
    import torch
    return torch.from_numpy(out).to(device), torch.from_numpy(lens).to(device)


@tables.register("frontend_classes", "DefaultFrontend")
@tables.register("frontend_classes", "EspnetFrontend")
class DefaultFrontend:
    """``__call__(waveform (n,)) -> (frames, n_mels * lfr_m)`` log-mel, host numpy."""

    def __init__(self, fs: int = 16000, n_fft: int = 512, hop_length: int = 160,
                 win_length: int = 400, n_mels: int = 80, fmin: float = 0.0,
                 fmax: float = None, lfr_m: int = 1, lfr_n: int = 1,
                 cmvn_file: str = None, **kwargs):
        self.fs = fs
        self.n_fft = n_fft
        self.hop = hop_length
        self.win = win_length
        self.n_mels = n_mels
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        self.frame_shift_ms = hop_length * 1000.0 / fs
        self.frame_shift = hop_length * 1000 // fs
        self.banks = slaney_mel_banks(n_mels, n_fft, fs, fmin, fmax)
        self.window = np.hanning(win_length + 1)[:-1].astype(np.float32)
        self.cmvn = None
        if cmvn_file:
            from funasr_tpu_torch.ops.lfr import load_cmvn
            self.cmvn = load_cmvn(cmvn_file)

    def output_size(self) -> int:
        return self.n_mels * self.lfr_m

    def __call__(self, waveform: np.ndarray) -> np.ndarray:
        x = np.asarray(waveform, np.float32)
        if x.ndim > 1:
            x = x[:, 0]
        n_frames = 1 + max(0, (len(x) - self.win)) // self.hop
        if n_frames < 1:
            return np.zeros((0, self.output_size()), np.float32)
        idx = (np.arange(self.win)[None, :]
               + np.arange(n_frames)[:, None] * self.hop)
        frames = x[idx] * self.window
        if self.win < self.n_fft:
            frames = np.pad(frames, ((0, 0), (0, self.n_fft - self.win)))
        spec = np.abs(np.fft.rfft(frames, self.n_fft, axis=1)) ** 2
        mel = spec @ self.banks.T
        feats = np.log(np.maximum(mel, 1e-10)).astype(np.float32)
        if self.lfr_m > 1 or self.lfr_n > 1:
            feats = apply_lfr(feats, self.lfr_m, self.lfr_n)
        if self.cmvn is not None:
            means, istd = self.cmvn
            feats = (feats + means) * istd
        return feats

    def extract(self, audio_list, device=None):
        """Waveforms (int16 PCM taken as x / 32768, as ``extract_fbank`` hands a frontend
        without a PCM16 path) -> (feats (B, T, D) f32, lens (B,) i32)."""
        return pad_batch([self(as_unit_f32(w)) for w in audio_list], device)
