"""DynamicStreamingVAD: streaming VAD with an adaptive endpoint schedule (a copy of
``funasr_tpu/models/fsmn_vad_streaming/dynamic_vad.py`` over the port's
``FsmnVADStreaming``; FunASR ``funasr/models/fsmn_vad_streaming/dynamic_vad.py:47``).

It feeds the streaming VAD fixed-size chunks and, as the speech of the current
utterance grows, tightens the end-silence threshold ("don't chop short sentences; cut
long ones fast"), returning endpoint events. The model is the port's
``FsmnVADStreaming`` (its weights are its own, so no params argument) or an
``AutoModel`` around it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

DEFAULT_SCHEDULE: List[Tuple[float, int]] = [
    (5000, 2000), (10000, 1500), (15000, 1000), (30000, 800), (45000, 400),
    (float("inf"), 100),
]


class DynamicStreamingVAD:
    def __init__(self, vad_model, frontend=None, chunk_size_ms: int = 60,
                 speech_noise_thres: float = 0.5, speech_to_sil_thres_ms: int = 150,
                 silence_schedule: Optional[List[Tuple[float, int]]] = None,
                 sample_rate: int = 16000):
        self.model = vad_model          # FsmnVADStreaming or AutoModel
        self.frontend = frontend
        self.chunk_size_ms = chunk_size_ms
        self.chunk_samples = sample_rate * chunk_size_ms // 1000
        self.speech_noise_thres = speech_noise_thres
        self.speech_to_sil_thres_ms = speech_to_sil_thres_ms
        self.schedule = (silence_schedule if silence_schedule is not None
                         else list(DEFAULT_SCHEDULE))
        self.sample_rate = sample_rate
        self.reset()

    def reset(self):
        self.cache: dict = {}
        self.buffer = np.zeros((0,), np.float32)
        self.accumulated_ms = 0
        self.in_speech = False

    def _current_silence_ms(self) -> int:
        for limit, sil in self.schedule:
            if self.accumulated_ms <= limit:
                return sil
        return self.schedule[-1][1]

    def feed(self, samples: np.ndarray, is_final: bool = False):
        """Append audio; returns VAD events [[beg,-1]|[-1,end]|[beg,end], ...] in ms."""
        self.buffer = np.concatenate([self.buffer, np.asarray(samples, np.float32)])
        events: List[List[int]] = []
        while len(self.buffer) >= self.chunk_samples or (is_final and
                                                         len(self.buffer) > 0):
            # every complete chunk in one model call: the VAD takes multi-chunk input,
            # and the silence schedule then moves at the caller's feed cadence
            n_chunks = max(len(self.buffer) // self.chunk_samples, 1)
            take = min(n_chunks * self.chunk_samples, len(self.buffer))
            chunk = self.buffer[:take]
            self.buffer = self.buffer[take:]
            final_chunk = is_final and len(self.buffer) == 0
            if self.in_speech:
                self.accumulated_ms += self.chunk_size_ms * n_chunks
            kwargs = dict(chunk_size=self.chunk_size_ms, is_final=final_chunk,
                          max_end_silence_time=self._current_silence_ms()
                          + self.speech_to_sil_thres_ms,
                          speech_noise_thres=self.speech_noise_thres,
                          dynamic_silence=False)
            if hasattr(self.model, "generate"):  # AutoModel facade
                res = self.model.generate(input=chunk, cache=self.cache, **kwargs)
            else:
                res, _ = self.model.inference(chunk, frontend=self.frontend,
                                              cache=self.cache, **kwargs)
            for ev in (res[0]["value"] if res else []):
                events.append(ev)
                if ev[0] != -1 and ev[1] == -1:
                    self.in_speech = True
                if ev[1] != -1:  # endpoint
                    self.in_speech = False
                    self.accumulated_ms = 0
            if final_chunk:
                break
        return events
