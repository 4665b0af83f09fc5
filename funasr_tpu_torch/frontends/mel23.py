"""WavFrontendMel23: 23-mel log-STFT features for EEND diarization, a copy of
``funasr_tpu/frontends/mel23.py`` for the PyTorch port.

Centered STFT (periodic hann, reflect pad, fft = next pow2 of the window), slaney-scale /
slaney-norm mel filterbank, log10 with a 1e-10 floor, per-utterance mean subtraction,
+/-lfr_m frame splicing and 1/lfr_n subsampling (FunASR ``frontends/wav_frontend.py:
665-726`` and ``eend_ola_feature.py``). Host numpy, bit-equal to the JAX package's
features; ``extract(audio_list, device=None)`` returns numpy, or tensors on ``device``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from funasr_tpu_torch.frontends.default import pad_batch
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import as_unit_f32


def slaney_mel_bank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel defaults: slaney scale + slaney area norm."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f * 3.0 / 200.0
        log_region = f >= 1000.0
        return np.where(log_region,
                        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        hz = m * 200.0 / 3.0
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((m - 15.0)
                                                    * (np.log(6.4) / 27.0)), hz)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                    n_mels + 2))
    weights = np.zeros((n_mels, n_bins))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney area normalization
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_centered(wav: np.ndarray, frame_size: int, frame_shift: int):
    """librosa.stft conventions -> complex (T, n_fft//2+1); drops the last frame when
    len(wav) is a multiple of frame_shift (``eend_ola_feature.stft:60-73``)."""
    n_fft = 1 << (frame_size - 1).bit_length()
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_size) / frame_size)
    pad_w = (n_fft - frame_size) // 2
    window = np.zeros(n_fft, np.float64)
    window[pad_w: pad_w + frame_size] = win

    padded = np.pad(wav.astype(np.float64), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // frame_shift
    idx = (np.arange(n_fft)[None, :]
           + frame_shift * np.arange(n_frames)[:, None])
    frames = padded[idx] * window[None, :]
    spec = np.fft.rfft(frames, axis=1)
    if len(wav) % frame_shift == 0:
        spec = spec[:-1]
    return spec


def mel23_features(wav: np.ndarray, fs: int = 8000, frame_length: int = 200,
                   frame_shift: int = 80, lfr_m: int = 7,
                   lfr_n: int = 10) -> np.ndarray:
    """One waveform -> (T, 23*(2*lfr_m+1)) spliced log-mel with mean norm."""
    spec = stft_centered(wav, frame_length, frame_shift)
    n_fft = 2 * (spec.shape[1] - 1)
    bank = slaney_mel_bank(fs, n_fft, 23)
    power = np.abs(spec) ** 2
    mel = power @ bank.T
    logmel = np.log10(np.maximum(mel, 1e-10))
    logmel = (logmel - logmel.mean(axis=0)).astype(np.float32)
    t, d = logmel.shape
    padded = np.pad(logmel, [(lfr_m, lfr_m), (0, 0)])
    spliced = np.concatenate([padded[i: i + t] for i in range(2 * lfr_m + 1)],
                             axis=1)
    return spliced[::lfr_n]


@tables.register("frontend_classes", "WavFrontendMel23")
class WavFrontendMel23:
    def __init__(self, fs: int = 8000, frame_length: int = 25,
                 frame_shift: int = 10, lfr_m: int = 7, lfr_n: int = 10,
                 frame_length_samples: int = None,
                 frame_shift_samples: int = None, **kwargs):
        self.fs = fs
        # configs give sample counts (200 / 80 for 25 ms / 10 ms at 8 kHz), which the
        # reference passes straight to its sample-domain stft
        self.frame_length = frame_length_samples or frame_length
        self.frame_shift = frame_shift_samples or frame_shift
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        self.n_mels = 23

    def output_size(self) -> int:
        return self.n_mels * (2 * self.lfr_m + 1)

    def extract(self, waveforms: List[np.ndarray], device=None):
        """Waveforms (int16 PCM taken as x / 32768, as ``extract_fbank`` hands a frontend
        without a PCM16 path) -> (feats (B, T, 345) f32, lens (B,) i32)."""
        feats = [mel23_features(as_unit_f32(w), fs=self.fs, frame_length=self.frame_length,
                                frame_shift=self.frame_shift, lfr_m=self.lfr_m,
                                lfr_n=self.lfr_n)
                 for w in waveforms]
        return pad_batch(feats, device)

    def forward(self, waveforms, lengths):
        wavs = [np.asarray(waveforms[i][: int(lengths[i])])
                for i in range(len(lengths))]
        return self.extract(wavs)
