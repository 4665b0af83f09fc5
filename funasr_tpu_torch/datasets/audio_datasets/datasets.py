"""Map-style audio dataset + padding collator (a copy of
``funasr_tpu/datasets/audio_datasets/datasets.py``; FunASR
``funasr/datasets/audio_datasets/datasets.py:10-153``).

``__getitem__`` returns the raw waveform + token ids (host work only); fbank / LFR / CMVN
run inside the train step on the device (``train_utils/trainer.py``). The collator pads
waveforms and token ids to the JAX package's bucketed shapes (token padding -1).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


@tables.register("dataset_classes", "AudioDataset")
class AudioDataset:
    def __init__(self, index_ds=None, index_ds_conf=None, tokenizer=None,
                 frontend=None, speed_perturb: bool = False, fs: int = 16000,
                 data_split_num: int = 1, **kwargs):
        if isinstance(index_ds, str):
            index_cls = tables.index_ds_classes[index_ds]
            index_ds = index_cls(**(index_ds_conf or {}))
        self.index_ds = index_ds
        self.tokenizer = tokenizer
        self.frontend = frontend
        self.fs = fs
        self.perturb = None
        if speed_perturb:
            from funasr_tpu_torch.datasets.audio_datasets.preprocessor import SpeedPerturb
            self.perturb = SpeedPerturb()
        self._rng = np.random.default_rng(kwargs.get("seed", 0))

    def __len__(self):
        return len(self.index_ds)

    def get_source_len(self, idx: int) -> int:
        item = self.index_ds[idx]
        return item["source_len"] if item["source_len"] > 0 else 1000

    def get_target_len(self, idx: int) -> int:
        item = self.index_ds[idx]
        return max(item["target_len"], 0)

    def __getitem__(self, idx: int) -> Optional[Dict]:
        from funasr_tpu_torch.utils.load_utils import load_audio
        item = self.index_ds[idx]
        wav = load_audio(item["source"], fs=self.fs)
        if self.perturb is not None:
            wav = self.perturb(wav, self._rng)
        text = item["target"]
        ids = self.tokenizer.encode(text) if self.tokenizer is not None else []
        return {"speech": wav, "speech_lengths": len(wav),
                "text": np.asarray(ids, np.int32), "text_lengths": len(ids),
                "key": item.get("key") or str(idx)}

    def collator(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        """Pad to bucketed (B, N) waveform + (B, L) token batches."""
        samples = [s for s in samples if s is not None]
        b = len(samples)
        n = bucket_length(max(s["speech_lengths"] for s in samples),
                          minimum=self.fs // 2, multiple=160)
        l = bucket_length(max(max(s["text_lengths"] for s in samples), 1),
                          minimum=8, multiple=8)
        speech = np.zeros((b, n), np.float32)
        text = np.full((b, l), -1, np.int32)
        slen = np.zeros((b,), np.int32)
        tlen = np.zeros((b,), np.int32)
        keys = []
        for i, s in enumerate(samples):
            speech[i, : s["speech_lengths"]] = s["speech"]
            text[i, : s["text_lengths"]] = s["text"]
            slen[i] = s["speech_lengths"]
            tlen[i] = s["text_lengths"]
            keys.append(s["key"])
        return {"speech": speech, "speech_lengths": slen, "text": text,
                "text_lengths": tlen, "keys": keys}
