"""CIF-peak -> per-token timestamps + punctuation-based sentence splitting, copied from
``funasr_tpu/utils/timestamp_tools.py`` (numpy only).

Behavioural port of FunASR ``funasr/utils/timestamp_tools.py``:
``ts_prediction_lfr6_standard:37-122`` (fires at peaks>=1-1e-4 shifted by
force_time_shift=-1.5; frame->sec via 10ms*6/upsample_rate; alpha renormalize+refire
when fire count != tokens+1; <sil> for gaps >12 frames and leading/trailing >5 frames),
``timestamp_sentence:125`` / ``timestamp_sentence_en:223``.
"""

from __future__ import annotations

import logging
from itertools import zip_longest
from typing import List, Optional

import numpy as np


def cif_wo_hidden_np(alphas: np.ndarray, threshold: float) -> np.ndarray:
    """Sequential integrate-and-fire over (T,) alphas -> fires trace."""
    integrate = 0.0
    fires = np.zeros_like(alphas)
    for t in range(alphas.shape[0]):
        integrate += alphas[t]
        fires[t] = integrate
        if integrate >= threshold:
            integrate -= threshold
    return fires


def ts_prediction_lfr6_standard(us_alphas, us_peaks, char_list, vad_offset=0.0,
                                force_time_shift=-1.5, sil_in_str=True,
                                upsample_rate=3):
    if not len(char_list):
        return "", []
    START_END_THRESHOLD = 5
    MAX_TOKEN_DURATION = 12
    TIME_RATE = 10.0 * 6 / 1000 / upsample_rate

    alphas = np.asarray(us_alphas, np.float64)
    peaks = np.asarray(us_peaks, np.float64)
    if alphas.ndim == 2:
        alphas, peaks = alphas[0], peaks[0]
    if char_list[-1] == "</s>":
        char_list = char_list[:-1]

    fire_place = np.where(peaks >= 1.0 - 1e-4)[0] + force_time_shift
    if len(fire_place) != len(char_list) + 1:
        alphas = alphas / (alphas.sum() / (len(char_list) + 1))
        peaks = cif_wo_hidden_np(alphas, threshold=1.0 - 1e-4)
        fire_place = np.where(peaks >= 1.0 - 1e-4)[0] + force_time_shift
    num_frames = peaks.shape[0]

    timestamp_list: List[List[float]] = []
    new_char_list: List[str] = []
    if len(fire_place) and fire_place[0] > START_END_THRESHOLD:
        timestamp_list.append([0.0, fire_place[0] * TIME_RATE])
        new_char_list.append("<sil>")
    for i in range(len(fire_place) - 1):
        if i >= len(char_list):
            break
        new_char_list.append(char_list[i])
        if MAX_TOKEN_DURATION < 0 or \
                fire_place[i + 1] - fire_place[i] <= MAX_TOKEN_DURATION:
            timestamp_list.append([fire_place[i] * TIME_RATE,
                                   fire_place[i + 1] * TIME_RATE])
        else:
            split = fire_place[i] + MAX_TOKEN_DURATION
            timestamp_list.append([fire_place[i] * TIME_RATE, split * TIME_RATE])
            timestamp_list.append([split * TIME_RATE, fire_place[i + 1] * TIME_RATE])
            new_char_list.append("<sil>")
    if len(fire_place) and num_frames - fire_place[-1] > START_END_THRESHOLD:
        end = (num_frames + fire_place[-1]) * 0.5
        if timestamp_list:
            timestamp_list[-1][1] = end * TIME_RATE
        timestamp_list.append([end * TIME_RATE, num_frames * TIME_RATE])
        new_char_list.append("<sil>")
    elif timestamp_list:
        timestamp_list[-1][1] = num_frames * TIME_RATE
    if vad_offset:
        for ts in timestamp_list:
            ts[0] += vad_offset / 1000.0
            ts[1] += vad_offset / 1000.0

    res_txt = "".join(
        f"{ch} {str(ts[0] + 0.0005)[:5]} {str(ts[1] + 0.0005)[:5]};"
        for ch, ts in zip(new_char_list, timestamp_list)
        if sil_in_str or ch != "<sil>")
    res = [[int(ts[0] * 1000), int(ts[1] * 1000)]
           for ch, ts in zip(new_char_list, timestamp_list) if ch != "<sil>"]
    return res_txt, res


def _timestamp_sentence_impl(punc_id_list, timestamps, text, punc_list,
                             return_raw_text):
    res: List[dict] = []
    if not text or timestamps is None or len(timestamps) == 0:
        return res
    if punc_id_list is None or len(punc_id_list) == 0:
        return [{"text": text.split(), "start": timestamps[0][0],
                 "end": timestamps[-1][1], "timestamp": timestamps}]
    if len(punc_id_list) != len(timestamps):
        logging.warning("length mismatch between punc and timestamp")

    sentence_text = ""
    sentence_seg = ""
    ts_list: List = []
    start: Optional[float] = timestamps[0][0]
    end = timestamps[0][1]
    for punc_id, ts, word in zip_longest(punc_id_list, timestamps, text.split(),
                                         fillvalue=None):
        if start is None and ts is not None:
            start = ts[0]
        if word is not None:
            first = word[0]
            if "a" <= first <= "z" or "A" <= first <= "Z":
                sentence_text += " " + word
            elif sentence_text and ("a" <= sentence_text[-1] <= "z"
                                    or "A" <= sentence_text[-1] <= "Z"):
                sentence_text += " " + word
            else:
                sentence_text += word
            sentence_seg += word + " "
        ts_list.append(ts)
        punc_id = int(punc_id) if punc_id is not None else 1
        end = ts[1] if ts is not None else end
        sentence_seg = sentence_seg.rstrip(" ")
        if punc_id > 1:
            sentence_text += punc_list[punc_id - 2]
            entry = {"text": sentence_text, "start": start, "end": end,
                     "timestamp": ts_list}
            if return_raw_text:
                entry["raw_text"] = sentence_seg
            res.append(entry)
            sentence_text, sentence_seg, ts_list, start = "", "", [], None
        else:
            sentence_seg += " " if sentence_seg else ""
    return res


def timestamp_sentence(punc_id_list, timestamp_postprocessed, text_postprocessed,
                       return_raw_text: bool = False):
    return _timestamp_sentence_impl(punc_id_list, timestamp_postprocessed,
                                    text_postprocessed, ["，", "。", "？", "、"],
                                    return_raw_text)


def timestamp_sentence_en(punc_id_list, timestamp_postprocessed, text_postprocessed,
                          return_raw_text: bool = False):
    return _timestamp_sentence_impl(punc_id_list, timestamp_postprocessed,
                                    text_postprocessed, [",", ".", "?", ","],
                                    return_raw_text)
