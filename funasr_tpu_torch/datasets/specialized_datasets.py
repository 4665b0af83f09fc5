"""Per-model-family dataset variants (a copy of ``funasr_tpu/datasets/
specialized_datasets.py``; FunASR ``funasr/datasets/{sense_voice_datasets,llm_datasets*,openai_datasets}``,
``audio_datasets/datasets.py:155``).

Each specializes :class:`AudioDataset` with its family's targets; the bucketed collator
is shared but for ``OpenAIDataset``'s, which pads token streams and labels too.
``SenseVoiceDataset`` puts the four rich tags before the text. Where the JAX package
reads every tag with ``int()``, the port also takes the string tags that
``bin/data_tools sensevoice2jsonl`` writes ("zh", "NEUTRAL", "Speech", ``with_itn``):
each becomes the tokenizer's id of ``<|zh|>``, ``<|NEUTRAL|>``, ``<|Speech|>``,
``<|withitn|>`` / ``<|woitn|>`` (the JAX dataset raises ``ValueError`` on that jsonl:
ROADMAP section 3). Integer tags, and the defaults of a row without tags, are the JAX
package's.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from funasr_tpu_torch.datasets.audio_datasets.datasets import AudioDataset
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


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


@tables.register("dataset_classes", "KWSDataset")
class KWSDataset(AudioDataset):
    """Keyword spotting: jsonl "target" may carry the keyword transcription; items
    gain a binary "is_keyword" flag from the "label" field."""

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        item["is_keyword"] = int(self.index_ds[idx].get("label", 1))
        return item


@tables.register("dataset_classes", "LLMDataset")
class LLMDataset(AudioDataset):
    """LLM-ASR training items: raw waveform + prompt/target token ids (ChatML
    construction happens in the model; reference ``llm_datasets/``)."""

    def __init__(self, *args, prompt_field: str = "prompt", **kwargs):
        super().__init__(*args, **kwargs)
        self.prompt_field = prompt_field

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        prompt = self.index_ds[idx].get(self.prompt_field, "")
        if self.tokenizer is not None and prompt:
            item["prompt_ids"] = np.asarray(self.tokenizer.encode(prompt), np.int32)
        else:
            item["prompt_ids"] = np.zeros((0,), np.int32)
        return item


@tables.register("dataset_classes", "LLMVicunaDataset")
class LLMVicunaDataset(LLMDataset):
    """Vicuna-style instruction items (reference ``llm_datasets_vicuna/
    datasets.py:57-127``): ``USER: {prompt}\\n ASSISTANT:`` template prepended;
    labels mask the prompt span with -100."""

    def __init__(self, *args, prompt: str = "Transcribe speech to text.",
                 ignore_index: int = -100, **kwargs):
        super().__init__(*args, **kwargs)
        self.prompt = prompt
        self.prompt_template = "USER: {}\n ASSISTANT:"
        self.ignore_index = ignore_index

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        pre = self.prompt_template.format(
            self.index_ds[idx].get("prompt", self.prompt))
        pre_ids = np.asarray(self.tokenizer.encode(pre), np.int32)
        target_ids = item["text"]
        input_ids = np.concatenate([pre_ids, target_ids])
        labels = np.concatenate([np.full(len(pre_ids), self.ignore_index,
                                         np.int32), target_ids])
        item.update(input_ids=input_ids, labels_ids=labels,
                    prompt_ids=pre_ids,
                    attention_mask=np.ones(len(input_ids), np.int32))
        return item


@tables.register("dataset_classes", "LLMQwenAudioDataset")
class LLMQwenAudioDataset(LLMDataset):
    """QwenAudio-style items (reference ``llm_datasets_qwenaudio/datasets.py``):
    audio framed by ``<audio>{path}</audio>`` tags inside the prompt; the audio
    span is replaced by placeholder positions sized from the encoder output."""

    AUDIO_START, AUDIO_END = "<audio>", "</audio>"

    def __init__(self, *args, prompt: str = "Transcribe:",
                 audio_token_id: int = 0, audio_downsample: int = 8,
                 ignore_index: int = -100, **kwargs):
        super().__init__(*args, **kwargs)
        self.prompt = prompt
        self.audio_token_id = audio_token_id
        self.audio_downsample = audio_downsample
        self.ignore_index = ignore_index

    def __getitem__(self, idx: int):
        item = super().__getitem__(idx)
        n_audio_tok = max(int(item["speech_lengths"])
                          // (self.audio_downsample * 160), 1)
        pre_ids = np.asarray(self.tokenizer.encode(
            self.AUDIO_START), np.int32)
        post_ids = np.asarray(self.tokenizer.encode(
            self.AUDIO_END + self.index_ds[idx].get("prompt", self.prompt)),
            np.int32)
        audio_ids = np.full(n_audio_tok, self.audio_token_id, np.int32)
        target_ids = item["text"]
        input_ids = np.concatenate([pre_ids, audio_ids, post_ids, target_ids])
        labels = np.concatenate([
            np.full(len(pre_ids) + n_audio_tok + len(post_ids),
                    self.ignore_index, np.int32), target_ids])
        fbank_mask = np.zeros(len(input_ids), np.float32)
        fbank_mask[len(pre_ids): len(pre_ids) + n_audio_tok] = 1.0
        item.update(input_ids=input_ids, labels_ids=labels,
                    fbank_mask=fbank_mask,
                    fbank_beg=np.asarray([len(pre_ids)], np.int32),
                    attention_mask=np.ones(len(input_ids), np.int32))
        return item


@tables.register("dataset_classes", "OpenAIDataset")
@tables.register("dataset_classes", "OpenAIDatasetMultiTurn")
class OpenAIDataset(AudioDataset):
    """ChatML multiturn items with inline audio spans (reference
    ``openai_datasets/datasets.py:103-213``): jsonl rows carry parallel
    ``system``/``user``/``assistant`` turn lists; ``<|startofspeech|>!path
    <|endofspeech|>`` spans inside user turns load audio and occupy placeholder
    positions sized by the encoder/adaptor downsampling; labels mask every
    non-assistant position with -100."""

    PATTERN = re.compile(r"(<\|startofspeech\|>.*?<\|endofspeech\|>)")

    def __init__(self, *args, max_token_length: int = 1024,
                 audio_adaptor_downsample_rate: int = 2,
                 audio_encoder_downsample_rate: int = 4,
                 audio_token_id: int = 0, ignore_index: int = -100, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_token_length = max_token_length
        self.adaptor_ds = audio_adaptor_downsample_rate
        self.encoder_ds = audio_encoder_downsample_rate
        self.audio_token_id = audio_token_id
        self.ignore_index = ignore_index

    def _audio_token_len(self, fbank_len: int) -> int:
        olens = fbank_len
        if self.encoder_ds == 4:  # two stride-2 convs (ref :168-171)
            olens = 1 + (olens - 3 + 2) // 2
            olens = 1 + (olens - 3 + 2) // 2
        return (olens - 1) // self.adaptor_ds + 1

    def _frames(self, n_samples: int) -> int:
        """Fbank frames an audio span yields (10 ms hop; LFR-aware when the
        dataset was built with a frontend)."""
        frames = max(n_samples // 160, 1)
        lfr_n = getattr(self.frontend, "lfr_n", 1) if self.frontend else 1
        return -(-frames // lfr_n)

    def collator(self, samples):
        """Pad multiturn batches: waveforms to a bucketed sample count, token
        streams to a bucketed length (labels padded with -100 so padding never
        contributes loss; fbank_mask padded with 0)."""
        samples = [s for s in samples if s is not None]
        b = len(samples)
        n = bucket_length(max(int(s["speech_lengths"]) for s in samples),
                          minimum=self.fs // 2, multiple=160)
        l = bucket_length(max(len(s["input_ids"]) for s in samples),
                          minimum=8, multiple=8)
        out = {"speech": np.zeros((b, n), np.float32),
               "speech_lengths": np.zeros((b,), np.int32),
               "input_ids": np.zeros((b, l), np.int32),
               "labels_ids": np.full((b, l), self.ignore_index, np.int32),
               "fbank_mask": np.zeros((b, l), np.float32),
               "attention_mask": np.zeros((b, l), np.int32),
               "text": np.full((b, l), -1, np.int32),
               "text_lengths": np.zeros((b,), np.int32),
               "keys": []}
        for i, s in enumerate(samples):
            sl = int(s["speech_lengths"])
            tl = len(s["input_ids"])
            out["speech"][i, :sl] = s["speech"]
            out["speech_lengths"][i] = sl
            out["input_ids"][i, :tl] = s["input_ids"]
            out["labels_ids"][i, :tl] = s["labels_ids"]
            out["fbank_mask"][i, :tl] = s["fbank_mask"][:tl]
            out["attention_mask"][i, :tl] = 1
            out["text"][i, :tl] = s["input_ids"]
            out["text_lengths"][i] = tl
            out["keys"].append(s["key"])
        return out

    def __getitem__(self, idx: int):
        from funasr_tpu_torch.utils.load_utils import load_audio
        row = self.index_ds[idx]
        systems = row.get("system") or [""]
        users = row.get("user") or [row.get("source", "")]
        assistants = row.get("assistant") or [row.get("target", "")]
        input_ids, labels, fbank_mask, fbank_beg = [], [], [], []
        speech, speech_len = np.zeros((0,), np.float32), 0
        for sys_p, user_p, target in zip(systems, users, assistants):
            source = (f"<|im_start|>system\n{sys_p}<|im_end|>\n"
                      f"<|im_start|>user\n{user_p}<|im_end|>\n"
                      f"<|im_start|>assistant\n")
            source_ids = []
            for sub in self.PATTERN.split(source):
                if not sub.startswith("<|startofspeech|>"):
                    toks = list(self.tokenizer.encode(sub))
                    source_ids += toks
                    fbank_mask += [0.0] * len(toks)
                else:
                    path = sub.replace("<|startofspeech|>", "") \
                        .replace("<|endofspeech|>", "")
                    if path.startswith("!"):
                        wav = load_audio(path[1:], fs=self.fs)
                        speech, speech_len = wav, len(wav)
                        n = self._audio_token_len(self._frames(speech_len))
                        fbank_beg.append(len(input_ids) + len(source_ids))
                        source_ids += [self.audio_token_id] * n
                        fbank_mask += [1.0] * n
            target_ids = list(self.tokenizer.encode(f"{target}<|im_end|>"))
            input_ids += source_ids + target_ids
            labels += [self.ignore_index] * len(source_ids) + target_ids
            fbank_mask += [0.0] * len(target_ids)
        input_ids = np.asarray(input_ids[: self.max_token_length], np.int32)
        labels = np.asarray(labels[: self.max_token_length], np.int32)
        return {"speech": speech, "speech_lengths": speech_len,
                "input_ids": input_ids, "labels_ids": labels,
                "text": input_ids, "text_lengths": len(input_ids),
                "fbank_mask": np.asarray(fbank_mask[: self.max_token_length],
                                         np.float32),
                "fbank_beg": np.asarray(fbank_beg, np.int32),
                "attention_mask": np.ones(len(input_ids), np.int32),
                "key": row.get("key") or str(idx)}
