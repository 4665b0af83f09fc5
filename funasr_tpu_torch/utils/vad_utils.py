"""VAD segment slicing and merging, copied from ``funasr_tpu/utils/vad_utils.py``
(behavioural port of FunASR ``funasr/utils/vad_utils.py``: ``slice_padding_audio_samples:28``
16 samples/ms slicing, ``merge_vad:54`` boundary-grid merge up to max_length)."""

from __future__ import annotations

from typing import List

import numpy as np


def slice_padding_audio_samples(speech: np.ndarray, speech_length: int, vad_segments):
    """vad_segments: [(segment [start_ms, end_ms], orig_index), ...] ->
    (list of waveforms, list of lengths)."""
    out, out_lens = [], []
    for segment in vad_segments:
        beg = int(segment[0][0] * 16)
        end = min(int(segment[0][1] * 16), speech_length)
        out.append(speech[beg:end])
        out_lens.append(end - beg)
    return out, out_lens


def slice_padding_fbank(feats: np.ndarray, feat_length: int, vad_segments,
                        frame_ms: int = 10):
    """Per-segment fbank slices padded to a common length."""
    rows, lens = [], []
    for segment in vad_segments:
        beg = int(segment[0][0] // frame_ms)
        end = min(int(segment[0][1] // frame_ms), feat_length)
        rows.append(feats[beg:end])
        lens.append(end - beg)
    maxlen = max(lens) if lens else 0
    pad = np.zeros((len(rows), maxlen, feats.shape[-1]), feats.dtype)
    for i, r in enumerate(rows):
        pad[i, : r.shape[0]] = r
    return pad, np.asarray(lens, np.int32)


def merge_vad(vad_result: List[List[int]], max_length: int = 15000,
              min_length: int = 0) -> List[List[int]]:
    """Concatenate adjacent segments (on the sorted boundary grid) until the next
    boundary would exceed ``max_length``."""
    if len(vad_result) <= 1:
        return vad_result
    steps = sorted({t for seg in vad_result for t in seg})
    if not steps:
        return []
    out = []
    bg = 0
    for i in range(len(steps) - 1):
        t = steps[i]
        if steps[i + 1] - bg < max_length:
            continue
        if t - bg > min_length:
            out.append([bg, t])
        bg = t
    out.append([bg, steps[-1]])
    return out
