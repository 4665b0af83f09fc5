"""WavFrontend in PyTorch: kaldi fbank + LFR + CMVN over a bucketed (B, N) batch
(counterpart of ``funasr_tpu/frontends/wav_frontend.py::WavFrontend``).

Same math as the reference frontend (FunASR ``funasr/frontends/wav_frontend.py:89-258``:
waveform * 2^15, hamming 25/10 ms fbank, LFR m/n stack, CMVN add-shift/rescale), run
as batched tensor ops on the device the caller names. The waveform is padded to the
JAX package's geometric bucket, which fixes the frame count and with it every shape
downstream. ``WavFrontendOnline`` (the VAD's chunked frontend) carries sample and LFR
caches across chunks.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from funasr_tpu_torch.ops.fbank import fbank, fbank_batch, num_frames
from funasr_tpu_torch.ops.lfr import apply_cmvn, apply_lfr_batch, load_cmvn
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


@tables.register("frontend_classes", "wav_frontend")
@tables.register("frontend_classes", "WavFrontend")
class WavFrontend:
    def __init__(self, cmvn_file: Optional[str] = None, fs: int = 16000,
                 window: str = "hamming", n_mels: int = 80, frame_length: int = 25,
                 frame_shift: int = 10, lfr_m: int = 1, lfr_n: int = 1,
                 dither: float = 1.0, snip_edges: bool = True,
                 upsacle_samples: bool = True, **kwargs):
        self.fs = fs
        self.window = window
        self.n_mels = n_mels
        self.frame_shift_ms = frame_shift
        self.frame_length = int(frame_length * fs / 1000)
        self.frame_shift = int(frame_shift * fs / 1000)
        self.lfr_m = lfr_m
        self.lfr_n = lfr_n
        # dither acts on the training path only (``forward`` with a generator); inference
        # is deterministic without it
        self.dither = dither
        self.snip_edges = snip_edges
        self.upsacle_samples = upsacle_samples
        self.cmvn = load_cmvn(cmvn_file) if cmvn_file else None

    def output_size(self) -> int:
        return self.n_mels * self.lfr_m

    def forward(self, waveforms, lengths, generator=None):
        """(B, N) float32 or int16 PCM tensor + (B,) sample lengths ->
        ((B, T, D) fp32 feats, (B,) int32 frame lengths), on the input's device.
        ``generator``: the training step's, which turns ``dither`` on."""
        if waveforms.dtype == torch.int16:
            # PCM16: int16 -> f32 is lossless and (i/2^15)*2^15 == i in f32, so the
            # features are bit-identical to the float path's
            waveforms = waveforms.float()
            scale = 1.0 if self.upsacle_samples else 1.0 / float(1 << 15)
        else:
            scale = float(1 << 15) if self.upsacle_samples else 1.0
        feats, flens = fbank_batch(
            waveforms * scale, lengths,
            num_mel_bins=self.n_mels,
            frame_length=self.frame_length,
            frame_shift=self.frame_shift,
            sample_frequency=float(self.fs),
            window_type=self.window,
            snip_edges=self.snip_edges,
            dither=self.dither,
            generator=generator,
        )
        if self.lfr_m != 1 or self.lfr_n != 1:
            feats, flens = apply_lfr_batch(feats, flens, self.lfr_m, self.lfr_n)
        if self.cmvn is not None:
            cmvn = torch.from_numpy(self.cmvn).to(feats.device)
            feats = apply_cmvn(feats, cmvn[0], cmvn[1])
        return feats, flens

    def extract(self, waveforms: List[np.ndarray], device=None):
        """list of float32 [-1, 1) (or raw int16 PCM) waveforms ->
        (feats (B, T, D), lens (B,) int32).

        ``device=None``: computed on the CPU, returned as numpy trimmed to the batch's
        longest row. A device: computed there and returned as tensors left at the
        waveform bucket's frame count (the decode pads to its own (B, T) bucket).
        """
        b = len(waveforms)
        maxn = max(max(int(w.shape[0]) for w in waveforms), self.frame_length)
        n_bucket = bucket_length(maxn, minimum=self.fs // 4, multiple=self.frame_shift)
        # if every input is int16, keep int16 (half the upload bytes, bit-exact)
        dtype = (np.int16 if all(np.asarray(w).dtype == np.int16 for w in waveforms)
                 else np.float32)
        batch = np.zeros((b, n_bucket), dtype)
        lens = np.zeros((b,), np.int32)
        for i, w in enumerate(waveforms):
            # ultra-short clips are right-padded with zeros to one full window
            w = np.asarray(w)
            if dtype == np.float32 and w.dtype == np.int16:
                w = w.astype(np.float32) / 32768.0  # mixed batch: rescale
            n = int(w.shape[0])
            batch[i, :n] = w
            lens[i] = max(n, self.frame_length)
        dev = torch.device("cpu") if device is None else torch.device(device)
        feats, flens = self.forward(torch.from_numpy(batch).to(dev),
                                    torch.from_numpy(lens).to(dev))
        if device is not None:
            return feats, flens
        feats, flens = feats.numpy(), flens.numpy()
        t = int(flens.max()) if len(flens) else 0
        return feats[:, :t], flens


@tables.register("frontend_classes", "WavFrontendOnline")
class WavFrontendOnline(WavFrontend):
    """Streaming frontend (``funasr_tpu/frontends/wav_frontend.py::WavFrontendOnline``):
    carries sample + LFR splice caches across chunks so the concatenated streaming
    output matches the offline pipeline.

    Cache dict: {"waveform": leftover raw samples not yet fully framed,
                 "consumed_samples", "raw_frames": raw fbank frames emitted so far,
                 "lfr_ctx": raw frames kept as LFR left context,
                 "lfr_out": LFR frames emitted so far}
    (role of reference ``input_cache``/``lfr_splice_cache``, ``wav_frontend.py:261-662``)
    """

    def init_cache(self):
        return {
            "waveform": np.zeros((0,), np.float32),
            "consumed_samples": 0,   # samples fully consumed into emitted fbank frames
            "raw_frames": 0,          # total raw fbank frames emitted so far
            "lfr_ctx": np.zeros((0, self.n_mels), np.float32),  # raw frames kept for lfr
            "lfr_out": 0,             # LFR frames emitted so far
        }

    def forward_streaming(self, waveforms: List[np.ndarray], cache=None,
                          is_final: bool = False, device=None):
        """Accumulate chunk, emit all complete LFR frames; on final, flush tail.

        The fbank of the buffered samples runs on ``device`` (the CPU when None); the
        LFR splice and CMVN stay on the host. Returns numpy (feats (1, T, D), lens (1,)),
        possibly T = 0.
        """
        assert cache is not None
        if "waveform" not in cache:
            cache.update(self.init_cache())
        chunk = np.concatenate([cache["waveform"]] + [w.astype(np.float32) for w in waveforms])
        # raw fbank frames available in buffered samples
        total = chunk.shape[0]
        t_raw = num_frames(total, self.frame_length, self.frame_shift)
        if t_raw == 0 and not is_final:
            cache["waveform"] = chunk
            return np.zeros((1, 0, self.output_size()), np.float32), np.zeros((1,), np.int32)

        feats_new = np.zeros((0, self.n_mels), np.float32)
        if t_raw > 0:
            scale = float(1 << 15) if self.upsacle_samples else 1.0
            wav = torch.from_numpy(chunk * scale).to(device or "cpu")
            feats_new = fbank(
                wav, num_mel_bins=self.n_mels, frame_length=self.frame_length,
                frame_shift=self.frame_shift, sample_frequency=float(self.fs),
                window_type=self.window, snip_edges=self.snip_edges).cpu().numpy()
        # keep unconsumed samples: frames consume t_raw*shift samples; window overhang stays
        consumed = t_raw * self.frame_shift
        cache["waveform"] = chunk[consumed:]

        # assemble raw-frame stream for LFR: previously kept context + new frames
        stream = np.concatenate([cache["lfr_ctx"], feats_new], axis=0)
        ctx_left = (self.lfr_m - 1) // 2

        if self.lfr_m == 1 and self.lfr_n == 1:
            out = stream
            cache["lfr_ctx"] = np.zeros((0, self.n_mels), np.float32)
        else:
            first_emitted = cache["lfr_out"]  # absolute LFR index of next output
            abs_start_of_stream = cache["raw_frames"] - cache["lfr_ctx"].shape[0]
            total_raw = cache["raw_frames"] + feats_new.shape[0]
            outs = []
            i = first_emitted
            while True:
                # window covers raw frames [i*n - ctx_left, i*n - ctx_left + m)
                w_beg = i * self.lfr_n - ctx_left
                w_end = w_beg + self.lfr_m
                if w_end > total_raw and not is_final:
                    break
                if is_final and i * self.lfr_n >= total_raw:
                    break
                idx = np.clip(np.arange(w_beg, w_end), 0, total_raw - 1)
                rel = idx - abs_start_of_stream
                if rel.min() < 0:
                    rel = np.clip(rel, 0, None)  # clamped-first-frame semantics
                rel = np.clip(rel, 0, stream.shape[0] - 1)
                outs.append(stream[rel].reshape(-1))
                i += 1
            out = (np.stack(outs, axis=0) if outs
                   else np.zeros((0, self.output_size()), np.float32))
            cache["lfr_out"] = i
            # keep raw frames still needed by future windows
            next_need = i * self.lfr_n - ctx_left
            keep_from = max(next_need - abs_start_of_stream, 0)
            cache["lfr_ctx"] = stream[keep_from:]

        cache["raw_frames"] += feats_new.shape[0]
        if self.cmvn is not None and out.shape[0] > 0:
            out = (out + self.cmvn[0]) * self.cmvn[1]
        return out[None].astype(np.float32), np.asarray([out.shape[0]], np.int32)
