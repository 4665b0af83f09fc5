"""FSMN-VAD in PyTorch: streaming voice activity detection with an endpoint state
machine (counterpart of ``funasr_tpu/models/fsmn_vad_streaming/model.py``).

FunASR's ``funasr/models/fsmn_vad_streaming/model.py``: the FSMN scores run on the
model's device (``encoder.py``, the FSMN memory on the hand-written kernel on CUDA) and
move to the host once per chunk; the endpoint state machine is host code, copied as it
is from the JAX package (``VADXOptions`` tunables, ``SlidingWindowDetector``, the
frame-indexed ``_Tracker``, the decibel + score frame classifier with its noise EMA, the
one-frame transitions, segment emission, and the chunk loop of ``inference`` with the
dynamic silence schedule).

Outputs: offline ``[[start_ms, end_ms], ...]``; streaming emits ``[beg, -1]`` /
``[-1, end]`` partials per the reference protocol.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

import funasr_tpu_torch.models.fsmn_vad_streaming.encoder  # noqa: F401 (registers FSMN)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.register import tables

# Dynamic silence threshold schedule: (accumulated_speech_ms, silence_threshold_ms)
STREAMING_SILENCE_SCHEDULE = [
    (5000, 2000), (10000, 1500), (15000, 1000), (30000, 800), (45000, 400),
    (float("inf"), 100),
]
DEFAULT_SILENCE_SCHEDULE = [
    (10000, 2000), (20000, 1000), (30000, 800), (40000, 600), (50000, 400),
    (60000, 200), (float("inf"), 100),
]


class VadState(Enum):
    START_NOT_DETECTED = 1
    IN_SPEECH = 2
    END_DETECTED = 3


class FrameState(Enum):
    SIL = 0
    SPEECH = 1


class Change(Enum):
    SPEECH2SPEECH = 0
    SPEECH2SIL = 1
    SIL2SIL = 2
    SIL2SPEECH = 3


@dataclass
class VADXOptions:
    """All reference tunables (``model.py:71-175``), defaults identical."""
    sample_rate: int = 16000
    detect_mode: int = 1  # 0=single-utterance, 1=multiple-utterance
    snr_mode: int = 0
    max_end_silence_time: int = 800
    max_start_silence_time: int = 3000
    do_start_point_detection: bool = True
    do_end_point_detection: bool = True
    window_size_ms: int = 200
    sil_to_speech_time_thres: int = 150
    speech_to_sil_time_thres: int = 150
    speech_2_noise_ratio: float = 1.0
    do_extend: int = 1
    lookback_time_start_point: int = 200
    lookahead_time_end_point: int = 100
    max_single_segment_time: int = 60000
    nn_eval_block_size: int = 8
    dcd_block_size: int = 4
    snr_thres: float = -100.0
    noise_frame_num_used_for_snr: int = 100
    decibel_thres: float = -100.0
    speech_noise_thres: float = 0.6
    fe_prior_thres: float = 1e-4
    silence_pdf_num: int = 1
    sil_pdf_ids: List[int] = field(default_factory=lambda: [0])
    speech_noise_thresh_low: float = -0.1
    speech_noise_thresh_high: float = 0.3
    output_frame_probs: bool = False
    frame_in_ms: int = 10
    frame_length_ms: int = 25

    @classmethod
    def from_kwargs(cls, **kwargs):
        keys = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in kwargs.items() if k in keys})


class SlidingWindowDetector:
    """Ring-buffer majority window for sil<->speech transitions
    (reference ``WindowDetector:218-321``)."""

    def __init__(self, window_size_ms: int, sil_to_speech_ms: int,
                 speech_to_sil_ms: int, frame_ms: int):
        self.size = window_size_ms // frame_ms
        self.sil2speech_thres = sil_to_speech_ms // frame_ms
        self.speech2sil_thres = speech_to_sil_ms // frame_ms
        self.reset()

    def reset(self):
        self.win = [0] * self.size
        self.pos = 0
        self.total = 0
        self.prev = FrameState.SIL

    def detect(self, state: FrameState) -> Change:
        val = 1 if state == FrameState.SPEECH else 0
        self.total += val - self.win[self.pos]
        self.win[self.pos] = val
        self.pos = (self.pos + 1) % self.size
        if self.prev == FrameState.SIL and self.total >= self.sil2speech_thres:
            self.prev = FrameState.SPEECH
            return Change.SIL2SPEECH
        if self.prev == FrameState.SPEECH and self.total <= self.speech2sil_thres:
            self.prev = FrameState.SIL
            return Change.SPEECH2SIL
        return Change.SIL2SIL if self.prev == FrameState.SIL else Change.SPEECH2SPEECH


@dataclass
class _Segment:
    start_ms: int
    end_ms: int
    has_start: bool = False
    has_end: bool = False


class _Tracker:
    """Frame-indexed VAD bookkeeping (replaces the reference's Stats + waveform
    buffer juggling with pure integer state)."""

    def __init__(self, opts: VADXOptions, max_end_sil_thresh: int,
                 speech_noise_thres: float):
        self.opts = opts
        self.frm_cnt = 0
        self.buf_start_frame = 0  # first frame not yet consumed into output/silence
        self.latest_speech_frame = 0
        self.latest_silence_frame = -1
        self.continous_silence = 0
        self.state = VadState.START_NOT_DETECTED
        self.confirmed_start = -1
        self.confirmed_end = -1
        self.n_ends = 0
        self.max_end_sil_frame_cnt_thresh = max_end_sil_thresh
        self.speech_noise_thres = speech_noise_thres
        self.noise_avg_db = -100.0
        self.segments: List[_Segment] = []
        self.seg_offset = 0
        self.next_seg = True
        self.scores: List[float] = []  # per-frame silence-pdf score sum
        self.decibel: List[float] = []
        self.max_time_out = False

    # -- segment emission -------------------------------------------------

    def _pop_till(self, frame: int):
        self.buf_start_frame = max(self.buf_start_frame, frame)

    def _extend_segment(self, start_frm: int, new_seg: bool, is_end: bool):
        ms = self.opts.frame_in_ms
        self._pop_till(start_frm)
        if not self.segments or new_seg:
            self.segments.append(_Segment(start_frm * ms, start_frm * ms))
        seg = self.segments[-1]
        self.buf_start_frame += 1
        seg.end_ms = (start_frm + 1) * ms
        if new_seg:
            seg.has_start = True
        if is_end:
            seg.has_end = True

    def on_silence(self, frame: int):
        self.latest_silence_frame = frame
        if self.state == VadState.START_NOT_DETECTED:
            self._pop_till(frame)

    def on_voice(self, frame: int):
        self.latest_speech_frame = frame
        self._extend_segment(frame, False, False)

    def on_voice_start(self, frame: int, fake: bool = False):
        if self.confirmed_start == -1:
            self.confirmed_start = frame
        if not fake and self.state == VadState.START_NOT_DETECTED:
            self._extend_segment(self.confirmed_start, True, False)

    def on_voice_end(self, frame: int, fake: bool, is_last: bool):
        for t in range(self.latest_speech_frame + 1, frame):
            self.on_voice(t)
        if self.confirmed_end == -1:
            self.confirmed_end = frame
        if not fake:
            self._extend_segment(self.confirmed_end, False, True)
        self.n_ends += 1

    def reset_detection(self, window: SlidingWindowDetector):
        self.continous_silence = 0
        self.latest_speech_frame = 0
        self.latest_silence_frame = -1
        self.confirmed_start = -1
        self.confirmed_end = -1
        self.state = VadState.START_NOT_DETECTED
        window.reset()
        if self.segments:
            assert self.segments[-1].has_end
            self._pop_till(self.segments[-1].end_ms // self.opts.frame_in_ms)


@tables.register("model_classes", "FsmnVADStreaming")
class FsmnVADStreaming(nn.Module):
    """Offline output: [{"key", "value": [[start_ms, end_ms], ...]}];
    streaming: [beg,-1] / [-1,end] / [beg,end] partial events."""

    def __init__(self, encoder: str = "FSMN", encoder_conf: Optional[Dict] = None,
                 vad_post_args: Optional[Dict] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's
        init rules, ``core/module.py::init_weights``)."""
        super().__init__()
        self.vad_opts = VADXOptions.from_kwargs(**kwargs)
        self.encoder = tables.encoder_classes[encoder](device=device, **(encoder_conf or {}))
        self.kwargs = kwargs
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    # ------------------------------------------------------------------

    def init_cache(self, cache: Optional[Dict] = None, **kwargs) -> Dict:
        if cache is None:
            cache = {}
        if kwargs.get("max_end_silence_time") is not None:
            self.vad_opts.max_end_silence_time = kwargs["max_end_silence_time"]
        opts = self.vad_opts
        cache["frontend"] = {}
        cache["prev_samples"] = np.zeros((0,), np.float32)
        cache["encoder"] = {}
        cache["window"] = SlidingWindowDetector(
            opts.window_size_ms, opts.sil_to_speech_time_thres,
            opts.speech_to_sil_time_thres, opts.frame_in_ms)
        cache["stats"] = _Tracker(
            opts,
            opts.max_end_silence_time - opts.speech_to_sil_time_thres,
            kwargs.get("speech_noise_thres", opts.speech_noise_thres))
        cache["sample_offset"] = 0
        return cache

    # -- per-frame classification (reference GetFrameState) ----------------

    def _frame_state(self, st: _Tracker, t: int) -> FrameState:
        opts = self.vad_opts
        if t >= len(st.decibel):
            return FrameState.SIL
        cur_db = st.decibel[t]
        cur_snr = cur_db - st.noise_avg_db
        if cur_db < opts.decibel_thres:
            return FrameState.SIL
        sil_score = st.scores[t]
        noise_prob = math.log(max(sil_score, 1e-10)) * opts.speech_2_noise_ratio
        speech_score = 1.0 - sil_score
        if speech_score >= math.exp(noise_prob) + st.speech_noise_thres:
            if cur_snr >= opts.snr_thres and cur_db >= opts.decibel_thres:
                return FrameState.SPEECH
            return FrameState.SIL
        # noise frame: update noise decibel EMA
        if st.noise_avg_db < -99.9:
            st.noise_avg_db = cur_db
        else:
            n = opts.noise_frame_num_used_for_snr
            st.noise_avg_db = (cur_db + st.noise_avg_db * (n - 1)) / n
        return FrameState.SIL

    def _latency_frames(self) -> int:
        opts = self.vad_opts
        lat = opts.window_size_ms // opts.frame_in_ms
        if opts.do_extend:
            lat += opts.lookback_time_start_point // opts.frame_in_ms
        return lat

    # -- one-frame state machine (reference DetectOneFrame) ----------------

    def _detect_one(self, cache: Dict, state: FrameState, idx: int, is_final: bool):
        st: _Tracker = cache["stats"]
        opts = self.vad_opts
        change = cache["window"].detect(state)
        ms = opts.frame_in_ms
        max_seg_frames = opts.max_single_segment_time / ms

        def maybe_end_if_last():
            if is_final:
                st.on_voice_end(idx, False, True)
                st.state = VadState.END_DETECTED

        if change == Change.SIL2SPEECH:
            st.continous_silence = 0
            if st.state == VadState.START_NOT_DETECTED:
                start = max(st.buf_start_frame, idx - self._latency_frames())
                st.on_voice_start(start)
                st.state = VadState.IN_SPEECH
                for t in range(start + 1, idx + 1):
                    st.on_voice(t)
            elif st.state == VadState.IN_SPEECH:
                for t in range(st.latest_speech_frame + 1, idx):
                    st.on_voice(t)
                if idx - st.confirmed_start + 1 > max_seg_frames:
                    st.on_voice_end(idx, False, False)
                    st.state = VadState.END_DETECTED
                elif not is_final:
                    st.on_voice(idx)
                else:
                    maybe_end_if_last()
        elif change == Change.SPEECH2SIL:
            st.continous_silence = 0
            if st.state == VadState.IN_SPEECH:
                if idx - st.confirmed_start + 1 > max_seg_frames:
                    st.on_voice_end(idx, False, False)
                    st.state = VadState.END_DETECTED
                elif not is_final:
                    st.on_voice(idx)
                else:
                    maybe_end_if_last()
        elif change == Change.SPEECH2SPEECH:
            st.continous_silence = 0
            if st.state == VadState.IN_SPEECH:
                if idx - st.confirmed_start + 1 > max_seg_frames:
                    st.max_time_out = True
                    st.on_voice_end(idx, False, False)
                    st.state = VadState.END_DETECTED
                elif not is_final:
                    st.on_voice(idx)
                else:
                    maybe_end_if_last()
        else:  # SIL2SIL
            st.continous_silence += 1
            if st.state == VadState.START_NOT_DETECTED:
                single = opts.detect_mode == 0
                if (single and st.continous_silence * ms > opts.max_start_silence_time) \
                        or (is_final and st.n_ends == 0):
                    for t in range(st.latest_silence_frame + 1, idx):
                        st.on_silence(t)
                    st.on_voice_start(0, fake=True)
                    st.on_voice_end(0, True, False)
                    st.state = VadState.END_DETECTED
                elif idx >= self._latency_frames():
                    st.on_silence(idx - self._latency_frames())
            elif st.state == VadState.IN_SPEECH:
                if st.continous_silence * ms >= st.max_end_sil_frame_cnt_thresh:
                    lookback = st.max_end_sil_frame_cnt_thresh // ms
                    if opts.do_extend:
                        lookback -= opts.lookahead_time_end_point // ms
                        lookback = max(0, lookback - 1)
                    st.on_voice_end(idx - lookback, False, False)
                    st.state = VadState.END_DETECTED
                elif idx - st.confirmed_start + 1 > max_seg_frames:
                    st.on_voice_end(idx, False, False)
                    st.state = VadState.END_DETECTED
                elif opts.do_extend and not is_final:
                    if st.continous_silence <= opts.lookahead_time_end_point // ms:
                        st.on_voice(idx)
                else:
                    maybe_end_if_last()

        if st.state == VadState.END_DETECTED and opts.detect_mode == 1:
            st.reset_detection(cache["window"])

    # -- chunk forward ------------------------------------------------------

    def silence_scores(self, feats, cache: Dict) -> np.ndarray:
        """(1, T, D) chunk features -> (T,) silence-pdf score sums on the host: the
        encoder on the model's device, one device-to-host copy per chunk."""
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(feats, np.float32)).to(self.device, self.dtype)
            scores = self.encoder(x, cache=cache["encoder"])
            sil = scores[0][:, self.vad_opts.sil_pdf_ids].cpu().numpy()
        return sil.sum(axis=1)

    def forward(self, feats, waveform, cache: Dict, is_final: bool = False,
                is_streaming_input: bool = True, **kwargs):
        """feats: (1, T, D) numpy chunk features; waveform: scaled samples aligned to
        the T score frames. Appends scores/decibel, advances the state machine, and
        returns newly-emittable segments (streaming or complete)."""
        st: _Tracker = cache["stats"]
        t = int(feats.shape[1]) if feats is not None else 0
        if t > 0:
            opts = self.vad_opts
            flen = opts.frame_length_ms * opts.sample_rate // 1000
            fshift = opts.frame_in_ms * opts.sample_rate // 1000
            w = np.asarray(waveform, np.float32)
            for i in range(t):
                frame = w[i * fshift : i * fshift + flen]
                st.decibel.append(10.0 * math.log10(float(np.sum(frame * frame)) + 1e-6))
            st.scores.extend(float(s) for s in self.silence_scores(feats, cache))
            st.frm_cnt += t

            if st.state != VadState.END_DETECTED:
                for i in range(t - 1, -1, -1):
                    idx = st.frm_cnt - 1 - i
                    fs = self._frame_state(st, idx)
                    final_frame = is_final and i == 0
                    self._detect_one(cache, fs, idx, final_frame)
        elif is_final and st.state != VadState.END_DETECTED:
            # flush on empty final chunk
            idx = max(st.frm_cnt - 1, 0)
            fs = self._frame_state(st, idx)
            self._detect_one(cache, fs, idx, True)

        # emit segments per reference protocol (forward:867-909)
        out = []
        for i in range(st.seg_offset, len(st.segments)):
            seg = st.segments[i]
            if is_streaming_input:
                if not seg.has_start:
                    continue
                if not st.next_seg and not seg.has_end:
                    continue
                start_ms = seg.start_ms if st.next_seg else -1
                if seg.has_end:
                    end_ms = seg.end_ms
                    st.next_seg = True
                    st.seg_offset += 1
                else:
                    end_ms = -1
                    st.next_seg = False
                out.append([start_ms, end_ms])
            else:
                if not is_final and (not seg.has_start or not seg.has_end):
                    continue
                out.append([seg.start_ms, seg.end_ms])
                st.seg_offset += 1
        return [out] if out else []

    # -- host inference (chunk loop) -----------------------------------------

    def inference(self, data_in, data_lengths=None, key: Optional[list] = None,
                  tokenizer=None, frontend=None, cache: Optional[Dict] = None,
                  **kwargs):
        from funasr_tpu_torch.utils.load_utils import (as_unit_f32,
                                                       load_audio_text_image_video)

        if cache is None or len(cache) == 0:
            cache = cache if cache is not None else {}
            self.init_cache(cache, **kwargs)

        meta_data: Dict[str, Any] = {}
        chunk_size = kwargs.get("chunk_size", 60000)  # ms
        chunk_stride = int(chunk_size * frontend.fs / 1000)
        is_streaming_input = kwargs.get("is_streaming_input",
                                        chunk_size < 15000)
        is_final = kwargs.get("is_final", not is_streaming_input)

        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        if isinstance(data_in, (str, bytes)):
            is_final = True
        meta_data["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        assert len(audio_list) == 1, "batch_size must be 1 for VAD"

        audio = np.concatenate([cache["prev_samples"],
                                as_unit_f32(audio_list[0])])
        n = int(len(audio) // chunk_stride + int(is_final))
        m = int(len(audio) % chunk_stride * (1 - int(is_final)))

        dynamic_silence = kwargs.get(
            "dynamic_silence", kwargs.get("max_end_silence_time") is None)
        schedule = kwargs.get("silence_schedule", DEFAULT_SILENCE_SCHEDULE)
        speech_to_sil = self.vad_opts.speech_to_sil_time_thres
        accumulated = cache.get("_dyn_ms", 0)
        in_speech = cache.get("_dyn_speech", False)

        segments: List[List[int]] = []
        # span plan: the adaptive-silence schedule updates per chunk; with a fixed
        # schedule (dynamic_silence=False) the whole non-final span scores in one
        # encoder call
        if dynamic_silence or n <= 1:
            spans = [(i * chunk_stride, (i + 1) * chunk_stride,
                      is_final and i == n - 1) for i in range(n)]
        else:
            n_nonfinal = n - int(is_final)
            spans = [(0, n_nonfinal * chunk_stride, False)]
            if is_final:
                spans.append((n_nonfinal * chunk_stride, len(audio), True))
        for beg, end, final_i in spans:
            chunk = audio[beg:end]

            if dynamic_silence:
                st = cache["stats"]
                if st.state == VadState.IN_SPEECH or in_speech:
                    accumulated += chunk_size
                    in_speech = True
                for limit_ms, sil_ms in schedule:
                    if accumulated <= limit_ms:
                        st.max_end_sil_frame_cnt_thresh = max(sil_ms - speech_to_sil, 0)
                        st.speech_noise_thres = 0.5
                        break
                cache["_dyn_ms"] = accumulated
                cache["_dyn_speech"] = in_speech

            feats, flens = frontend.forward_streaming([chunk], cache=cache["frontend"],
                                                      is_final=final_i, device=self.device)
            t_new = int(flens[0])
            # aligned waveform span for the emitted score frames
            opts = self.vad_opts
            fshift = opts.frame_in_ms * opts.sample_rate // 1000
            flen_smp = opts.frame_length_ms * opts.sample_rate // 1000
            all_samples = cache.setdefault("_all_samples", np.zeros((0,), np.float32))
            all_samples = np.concatenate([all_samples, chunk])
            cache["_all_samples"] = all_samples
            emitted = cache["stats"].frm_cnt
            w_beg = emitted * fshift
            w_end = (emitted + t_new - 1) * fshift + flen_smp if t_new > 0 else w_beg
            waveform = all_samples[w_beg:w_end] * 32768.0

            segs_i = self.forward(feats, waveform, cache, is_final=final_i,
                                  is_streaming_input=is_streaming_input)
            if segs_i:
                segments.extend(segs_i[0])
                if dynamic_silence:
                    accumulated = 0
                    in_speech = False
                    cache["_dyn_ms"] = 0
                    cache["_dyn_speech"] = False

        cache["prev_samples"] = audio[-m:] if m > 0 else np.zeros((0,), np.float32)
        if is_final:
            self.init_cache(cache)
            cache.pop("_all_samples", None)

        if key is None:
            key = ["rand_key"]
        return [{"key": key[0], "value": segments}], meta_data
