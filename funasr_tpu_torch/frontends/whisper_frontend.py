"""Whisper log-mel frontend in PyTorch (counterpart of
``funasr_tpu/frontends/whisper_frontend.py``; FunASR ``funasr/frontends/whisper_frontend.py``):
n_fft 400, hop 160, a Hann window, the power spectrum without its last frame, slaney
mel filters computed in code (no ``mel_filters.npz``), log10 clamped at 1e-10 and to
8 below the maximum, then (x + 4) / 4.

The STFT is ``torch.fft.rfft`` in fp32 and the mel product an fp32 matmul; TF32 stays off
(``funasr_tpu_torch/__init__.py`` turns it off for matmuls), as the JAX package computes
at fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from funasr_tpu_torch.register import tables


@functools.lru_cache(maxsize=4)
def slaney_mel_filters(n_mels: int = 80, n_fft: int = 400, sr: int = 16000):
    """librosa-style slaney mel filterbank (what whisper ships as mel_filters.npz):
    (n_mels, n_fft // 2 + 1) float32; a copy of the JAX package's function."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3.0 * f / 200.0
        log_region = f >= 1000.0
        mel = np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / np.log(6.4) * 27.0, mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)
        return f

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@tables.register("frontend_classes", "WhisperFrontend")
class WhisperFrontend:
    def __init__(self, fs: int = 16000, n_mels: int = 80, n_fft: int = 400,
                 hop_length: int = 160, whisper_model: str = "large-v3",
                 do_pad_trim: bool = True, pad_samples: int = 480000, **kwargs):
        self.fs = fs
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.frame_shift_ms = hop_length * 1000 // fs
        self.lfr_n = 1
        self.do_pad_trim = do_pad_trim
        self.pad_samples = pad_samples

    def output_size(self):
        return self.n_mels

    def log_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (N,) float in [-1, 1] -> (T, n_mels) whisper log-mel, on wav's device."""
        dev = wav.device
        window = torch.from_numpy(np.hanning(self.n_fft + 1)[:-1].astype(np.float32)).to(dev)
        pad = self.n_fft // 2
        x = torch.nn.functional.pad(wav.float()[None, None], (pad, pad), mode="reflect")[0, 0]
        frames = x.unfold(0, self.n_fft, self.hop_length) * window
        spec = torch.fft.rfft(frames, dim=-1)
        mag = spec.abs().square()[:-1]  # whisper drops the last frame
        filters = torch.from_numpy(slaney_mel_filters(self.n_mels, self.n_fft, self.fs)).to(dev)
        log_spec = torch.log10(torch.clamp_min(mag @ filters.T, 1e-10))
        log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
        return (log_spec + 4.0) / 4.0

    def extract(self, waveforms, device=None):
        """Waveforms -> ((B, T, n_mels) log-mel, (B,) lengths): numpy on the host, or
        tensors on ``device``. Int16 PCM is scaled to [-1, 1) (the JAX ``extract_fbank``
        does that for frontends without a PCM16 path); each waveform is then padded or cut
        to ``pad_samples``."""
        from funasr_tpu_torch.utils.load_utils import as_unit_f32

        feats = []
        for w in waveforms:
            w = np.asarray(as_unit_f32(np.asarray(w)), np.float32)
            if self.do_pad_trim:
                w = w[: self.pad_samples]
                if w.shape[0] < self.pad_samples:
                    w = np.pad(w, (0, self.pad_samples - w.shape[0]))
            feats.append(self.log_mel(torch.from_numpy(w).to(device or "cpu")))
        lens = [f.shape[0] for f in feats]
        out = torch.zeros(len(feats), max(lens), self.n_mels, device=feats[0].device)
        for i, f in enumerate(feats):
            out[i, : f.shape[0]] = f
        if device is None:
            return out.numpy(), np.asarray(lens, np.int32)
        return out, torch.tensor(lens, dtype=torch.int32, device=out.device)
