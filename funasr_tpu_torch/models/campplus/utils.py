"""Speaker pipeline helpers, copied from ``funasr_tpu/models/campplus/utils.py``
(numpy only; FunASR ``funasr/models/campplus/utils.py``: ``sv_chunk:76`` 1.5 s / 0.75 s
sliding chunks, ``postprocess:140-255`` overlap resolution + smoothing + merge,
``distribute_spk:256`` sentence -> speaker assignment by overlap)."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np


def sv_chunk(vad_segments: list, fs: int = 16000) -> list:
    """[[start_s, end_s, waveform], ...] -> 1.5 s chunks with 0.75 s shift."""
    seg_dur, seg_shift = 1.5, 0.75
    chunk_len = int(seg_dur * fs)
    chunk_shift = int(seg_shift * fs)

    out = []
    for seg_st, _seg_ed, data in vad_segments:
        last_ed = 0
        for st in range(0, data.shape[0], chunk_shift):
            ed = min(st + chunk_len, data.shape[0])
            if ed <= last_ed:
                break
            last_ed = ed
            st = max(0, ed - chunk_len)
            chunk = data[st:ed]
            if chunk.shape[0] < chunk_len:
                chunk = np.pad(chunk, (0, chunk_len - chunk.shape[0]))
            out.append([st / fs + seg_st, ed / fs + seg_st, chunk])
    return out


def correct_labels(labels: np.ndarray) -> np.ndarray:
    """Renumber labels by first appearance order."""
    id2id = {}
    out = []
    for label in labels:
        if label not in id2id:
            id2id[label] = len(id2id)
        out.append(id2id[label])
    return np.asarray(out)


def merge_seque(rows: list) -> list:
    out = [rows[0]]
    for row in rows[1:]:
        if row[2] != out[-1][2] or row[0] > out[-1][1]:
            out.append(row)
        else:
            out[-1][1] = row[1]
    return out


def smooth(rows: list, mindur: float = 0.7) -> list:
    if len(rows) < 2:
        return rows
    for i, row in enumerate(rows):
        row[0] = round(row[0], 2)
        row[1] = round(row[1], 2)
        if row[1] - row[0] < mindur:
            if i == 0:
                row[2] = rows[i + 1][2]
            elif i == len(rows) - 1:
                row[2] = rows[i - 1][2]
            elif row[0] - rows[i - 1][1] <= rows[i + 1][0] - row[1]:
                row[2] = rows[i - 1][2]
            else:
                row[2] = rows[i + 1][2]
    return merge_seque(rows)


def postprocess(segments: list, vad_segments, labels: np.ndarray,
                embeddings: np.ndarray, return_spk_center: bool = False
                ) -> Union[list, tuple]:
    """Chunk labels -> chronologically merged speaker turns [[st, ed, spk], ...]."""
    assert len(segments) == len(labels)
    labels = correct_labels(labels)
    rows = [[segments[i][0], segments[i][1], labels[i]] for i in range(len(segments))]
    rows = merge_seque(rows)

    # split overlap regions at the midpoint
    for i in range(1, len(rows)):
        if rows[i - 1][1] > rows[i][0] + 1e-4:
            mid = (rows[i][0] + rows[i - 1][1]) / 2
            rows[i][0] = mid
            rows[i - 1][1] = mid
    rows = smooth(rows)

    if return_spk_center:
        centers = np.stack([embeddings[labels == i].mean(0)
                            for i in range(labels.max() + 1)])
        return rows, centers
    return rows


def distribute_spk(sentence_list: List[dict], sd_time_list: list) -> List[dict]:
    """Assign each sentence the speaker with maximal temporal overlap (ms)."""
    turns = [(st * 1000, ed * 1000, spk) for st, ed, spk in sd_time_list]
    for sent in sentence_list:
        best_spk, best_overlap = 0, 0
        for st, ed, spk in turns:
            overlap = max(min(sent["end"], ed) - max(sent["start"], st), 0)
            if overlap > best_overlap:
                best_overlap = overlap
                best_spk = spk
            if overlap > 0 and best_spk == spk:
                best_overlap += overlap
        sent["spk"] = int(best_spk)
    return sentence_list
