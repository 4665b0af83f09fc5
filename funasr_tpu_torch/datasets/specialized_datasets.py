"""Per-model-family dataset variants (a copy of the first two of
``funasr_tpu/datasets/specialized_datasets.py``; FunASR ``funasr/datasets/
sense_voice_datasets``, ``audio_datasets/datasets.py:155``).

Both specialize :class:`AudioDataset` with their family's targets; the bucketed collator
is shared. ``SenseVoiceDataset`` puts the four rich tags before the text. Where the JAX
package reads every tag with ``int()``, the port also takes the string tags that
``bin/data_tools sensevoice2jsonl`` writes ("zh", "NEUTRAL", "Speech", ``with_itn``):
each becomes the tokenizer's id of ``<|zh|>``, ``<|NEUTRAL|>``, ``<|Speech|>``,
``<|withitn|>`` / ``<|woitn|>`` (the JAX dataset raises ``ValueError`` on that jsonl:
ROADMAP section 3). Integer tags, and the defaults of a row without tags, are the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from funasr_tpu_torch.datasets.audio_datasets.datasets import AudioDataset
from funasr_tpu_torch.register import tables


def tag_token_id(tokenizer, token: str) -> int:
    """The tokenizer's id of a rich tag such as ``<|zh|>``; raises naming the token where
    the vocabulary lacks it."""
    ids = getattr(tokenizer, "token2id", None)
    if ids and token in ids:
        return ids[token]
    sp = getattr(tokenizer, "sp", None)
    if sp is not None and sp.piece_to_id(token) != sp.unk_id():
        return sp.piece_to_id(token)
    raise KeyError(f"the tokenizer has no token {token!r} for a SenseVoice tag")


def _is_int(value) -> bool:
    return not isinstance(value, str) or value.lstrip("-").isdigit()


@tables.register("dataset_classes", "SenseVoiceDataset")
class SenseVoiceDataset(AudioDataset):
    """Targets prepend 4 rich-tag ids [lid, event, emo, textnorm] before the text
    tokens (the prompt positions trained with CE, ``sense_voice/model.py:767-815``).

    jsonl lines may carry "lid" / "emo" / "event" / "textnorm" fields, integers or tag
    names ("zh", "<|zh|>"), or "with_itn"; defaults: ``DEFAULT_TAGS``, overridable
    through ``tag_ids_conf``.
    """

    DEFAULT_TAGS = {"lid": 3, "event": 1, "emo": 2, "textnorm": 15}

    def __init__(self, *args, tag_ids_conf: Optional[Dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.tag_defaults = {**self.DEFAULT_TAGS, **(tag_ids_conf or {})}

    def tag_id(self, value) -> int:
        if _is_int(value):
            return int(value)
        token = value if value.startswith("<|") else f"<|{value}|>"
        return tag_token_id(self.tokenizer, token)

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        meta = self.index_ds[idx]
        textnorm = meta.get("textnorm")
        if textnorm is None and "with_itn" in meta:
            textnorm = "withitn" if meta["with_itn"] else "woitn"
        tags = [self.tag_id(meta.get("lid", self.tag_defaults["lid"])),
                self.tag_id(meta.get("event", self.tag_defaults["event"])),
                self.tag_id(meta.get("emo", self.tag_defaults["emo"])),
                self.tag_id(self.tag_defaults["textnorm"] if textnorm is None else textnorm)]
        item["text"] = np.concatenate([np.asarray(tags, np.int32), item["text"]])
        item["text_lengths"] = item["text_lengths"] + 4
        return item


@tables.register("dataset_classes", "AudioDatasetHotword")
class AudioDatasetHotword(AudioDataset):
    """SeACo training: sample hotword spans from the target per item
    (reference ``datasets.py:155``). Adds hotword_pad/hotword_lengths/seaco_label."""

    def __init__(self, *args, hotword_min_length: int = 2,
                 hotword_max_length: int = 8, sample_rate: float = 0.75, **kwargs):
        super().__init__(*args, **kwargs)
        self.hw_min = hotword_min_length
        self.hw_max = hotword_max_length
        self.hw_rate = sample_rate

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        text = item["text"]
        n = len(text)
        rng = self._rng
        if n >= self.hw_min and rng.random() < self.hw_rate:
            span = int(rng.integers(self.hw_min, min(self.hw_max, n) + 1))
            start = int(rng.integers(0, n - span + 1))
            item["hotword"] = text[start: start + span].copy()
        else:
            item["hotword"] = np.asarray([1], np.int32)  # <s> = no-bias
        return item
