"""The LLM-ASR family in PyTorch: an audio encoder + an adaptor + a causal-LM decoder
(counterpart of ``funasr_tpu/models/llm_asr/model.py``; FunASR
``funasr/models/llm_asr/model.py`` LLMASR, ``qwen_audio/`` chat wrappers, ``llm_asr_nar/``).

All share Fun-ASR-Nano's machinery (the port's ``QwenLM`` and ``LLMEngine``) and differ
in encoder, prompt format and decode mode. ``LLMASR`` and its versions also speak the
reference's multiturn OpenAI-message format: ``generate(input=[messages])``, where user
turns may hold ``<|startofspeech|>!path<|endofspeech|>`` audio spans (reference
``data_template:666`` / ``data_load_speech:693`` / ``inference:820``). ``GLMASR`` runs
its audio through the port's ``TransformerEncoder``. Every name trains on collated
OpenAI-format batches through ``forward_batch`` (the JAX ``forward_jit_batch``), which the
trainer picks for a batch holding ``input_ids``; plain (speech, text) batches take
Fun-ASR-Nano's ``forward``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

from funasr_tpu_torch.llm.engine import Request
from funasr_tpu_torch.models.fun_asr_nano.model import FunASRNano
from funasr_tpu_torch.parallel.sharding import global_count
from funasr_tpu_torch.register import tables

#: ``<|startofspeech|>!/path.wav<|endofspeech|>`` inside a user turn (reference
#: ``llm_asr/model.py:706``; ``!`` marks a file path)
SPEECH_SPAN = re.compile(r"(<\|startofspeech\|>.*?<\|endofspeech\|>)")
IGNORE_INDEX = -100

@tables.register("model_classes", "LLMASR")
class LLMASR(FunASRNano):
    """Any registered encoder + adaptor + Qwen-style decoder (reference
    ``llm_asr/model.py:28``), prompted with a plain instruction string."""

    def __init__(self, audio_encoder: str = "SANMEncoder",
                 prompt_template: str = "Transcribe the speech to text:", **kwargs):
        super().__init__(audio_encoder=audio_encoder, **kwargs)
        self.prompt_template = prompt_template

    def get_prompt(self, hotwords=None, language=None, itn=True) -> str:
        prompt = self.prompt_template
        if language:
            prompt += f" (language: {language})"
        if hotwords:
            prompt += f" [context: {', '.join(hotwords)}]"
        return prompt

    # -- the multiturn OpenAI-message format ----------------------------------

    def audio_token_len(self, fbank_len: int) -> int:
        """LLM token slots one audio span takes (reference ``model.py:770-786``)."""
        enc_len = int(fbank_len)
        if hasattr(self.audio_encoder, "output_len"):
            enc_len = int(self.audio_encoder.output_len(enc_len))
        if hasattr(self.audio_adaptor, "audio_token_len"):
            return int(self.audio_adaptor.audio_token_len(enc_len))
        return max(enc_len, 1)

    @staticmethod
    def data_template(data) -> Dict[str, List[str]]:
        """OpenAI role list -> parallel system / user / assistant turn lists (reference
        ``model.py:666-691``; the system prompt repeats over the turns)."""
        if isinstance(data, dict):  # already in template form
            return {"system": list(data.get("system") or [""]),
                    "user": list(data.get("user") or []),
                    "assistant": list(data.get("assistant") or [])}
        system, user, assistant = [], [], []
        for item in data:
            role, content = item["role"], item["content"]
            if role == "system":
                system.append(content)
            elif role == "user":
                user.append(content)
            elif role == "assistant":
                assistant.append(content)
        if not system:
            system = [""]
        system = system * len(user)
        return {"system": system, "user": user, "assistant": assistant}

    def data_load_speech(self, contents: Dict, tokenizer, frontend,
                         meta_data: Optional[Dict] = None, **kwargs) -> Dict:
        """One sample's ids, labels and audio from template turns (reference
        ``model.py:693-818``): each audio span is loaded and featurized and reserves
        ``audio_token_len`` placeholder ids; labels are -100 off the assistant turns.

        Returns numpy arrays: ``speech (S, T, D)``, ``speech_lengths (S,)``,
        ``input_ids`` / ``labels_ids`` / ``fbank_mask (L,)``, ``source_ids`` (all before
        the last assistant turn: the generation prompt), ``fbank_beg`` /
        ``fake_token_len (S,)``, ``attention_mask``."""
        from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

        meta_data = meta_data if meta_data is not None else {}
        input_ids: List[int] = []
        labels: List[int] = []
        fbank_mask: List[float] = []
        fbank_beg: List[int] = []
        fake_token_len: List[int] = []
        fbanks: List[np.ndarray] = []
        source_end = 0
        for sys_p, user_p, target in zip(contents["system"], contents["user"],
                                         contents["assistant"]):
            source = (f"<|im_start|>system\n{sys_p}<|im_end|>\n"
                      f"<|im_start|>user\n{user_p}<|im_end|>\n"
                      f"<|im_start|>assistant\n")
            for sub in SPEECH_SPAN.split(source):
                if not sub.startswith("<|startofspeech|>"):
                    toks = list(tokenizer.encode(sub))
                    input_ids += toks
                    labels += [IGNORE_INDEX] * len(toks)
                    fbank_mask += [0.0] * len(toks)
                    continue
                src = sub[len("<|startofspeech|>"):-len("<|endofspeech|>")]
                if src.startswith("!"):
                    src = src[1:]
                audio = load_audio_text_image_video([src], fs=frontend.fs,
                                                    audio_fs=kwargs.get("fs", 16000))
                speech, speech_lengths = extract_fbank(audio, frontend=frontend)
                fbanks.append(np.asarray(speech[0], np.float32))
                n = self.audio_token_len(int(speech_lengths[0]))
                fbank_beg.append(len(input_ids))
                fake_token_len.append(n)
                input_ids += [0] * n
                labels += [IGNORE_INDEX] * n
                fbank_mask += [1.0] * n
            source_end = len(input_ids)
            target_ids = list(tokenizer.encode(f"{target}<|im_end|>"))
            input_ids += target_ids
            labels += target_ids
            fbank_mask += [0.0] * len(target_ids)
        t_max = max((f.shape[0] for f in fbanks), default=1)
        d = fbanks[0].shape[1] if fbanks else 1
        speech = np.zeros((len(fbanks), t_max, d), np.float32)
        speech_lengths = np.zeros((len(fbanks),), np.int32)
        for s, f in enumerate(fbanks):
            speech[s, : f.shape[0]] = f
            speech_lengths[s] = f.shape[0]
        meta_data["batch_data_time"] = sum(f.shape[0] for f in fbanks) * getattr(
            frontend, "frame_shift_ms", 10) * getattr(frontend, "lfr_n", 1) / 1000
        return {
            "speech": speech, "speech_lengths": speech_lengths,
            "input_ids": np.asarray(input_ids, np.int32),
            "labels_ids": np.asarray(labels, np.int32),
            "source_ids": np.asarray(input_ids[:source_end], np.int32),
            "fbank_mask": np.asarray(fbank_mask, np.float32),
            "fbank_beg": np.asarray(fbank_beg, np.int32),
            "fake_token_len": np.asarray(fake_token_len, np.int32),
            "attention_mask": np.ones((len(input_ids),), np.int32),
        }

    def splice_audio_embeds(self, embeds, audio, audio_lens, fbank_mask):
        """Positions where ``fbank_mask`` is set take successive rows of the audio
        embeddings, one span per row (the JAX cumsum + gather, ``model.py:168-177``; the
        reference's in-place row loop, ``model.py:869-878``)."""
        mask = fbank_mask > 0
        idx = (torch.cumsum(mask.int(), dim=-1) - 1).clamp(0, audio.shape[1] - 1)
        gathered = torch.gather(audio, 1, idx[..., None].expand(-1, -1, audio.shape[-1]))
        return torch.where(mask[..., None], gathered.to(embeds.dtype), embeds)

    def forward_batch(self, batch, generator=None):
        """The multiturn fine-tune loss over a collated OpenAI-format batch
        (``model.py:179-209``, reference LLMASR4 ``forward:1135-1244``) -> (loss, stats,
        batch size): the audio embeddings spliced into the placeholder slots, next-token
        CE where ``labels_ids[:, 1:]`` is not -100 over their count (at least 1), ``acc``
        by argmax. ``batch``: tensors ``speech`` (B, T, D) features, ``speech_lengths``,
        ``input_ids``, ``labels_ids``, ``fbank_mask``. ``generator`` is unused."""
        speech = batch["speech"]
        if speech.dim() == 2:  # waveforms: the trainer runs the frontend first
            raise ValueError("forward_batch expects fbank features")
        audio, audio_lens = self.encode_audio(speech, batch["speech_lengths"])
        emb = self.llm.embed(batch["input_ids"].clamp_min(0), torch.float32)
        spliced = self.splice_audio_embeds(emb, audio, audio_lens, batch["fbank_mask"])
        pred = self.llm.logits_head(self.llm.hidden_embeds(spliced)[:, :-1])
        tgt = batch["labels_ids"][:, 1:].long()
        valid = (tgt != IGNORE_INDEX).float()
        tgt = tgt.clamp_min(0)
        logp = torch.log_softmax(pred.float(), dim=-1)
        ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        denom = global_count(valid.sum()).clamp_min(1.0)
        loss = (ce * valid).sum() / denom
        acc = ((pred.argmax(-1) == tgt).float() * valid).sum() / denom
        return loss, {"loss": loss, "loss_llm": loss, "acc": acc}, speech.shape[0]

    @staticmethod
    def _is_messages(x) -> bool:
        return (isinstance(x, (list, tuple)) and len(x) > 0
                and isinstance(x[0], dict) and "role" in x[0]) or (
                    isinstance(x, dict) and ("user" in x or "messages" in x))

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """Messages mode when ``data_in`` holds OpenAI-format conversations (reference
        LLMASR2 ``inference:820-945``); plain audio takes Fun-ASR-Nano's path."""
        is_msgs = (isinstance(data_in, (list, tuple)) and len(data_in) > 0
                   and self._is_messages(data_in[0]))
        if not is_msgs:
            return super().inference(data_in, data_lengths, key, tokenizer, frontend, **kwargs)
        meta: Dict = {}
        results = []
        teacher_forcing = kwargs.get("teacher_forcing", kwargs.get("tearchforing", False))
        for i, messages in enumerate(data_in):
            if isinstance(messages, dict) and "messages" in messages:
                messages = messages["messages"]
            contents = self.data_template(messages)
            sample = self.data_load_speech(contents, tokenizer, frontend, meta_data=meta,
                                           **kwargs)
            if sample["speech"].shape[0] > 0:
                with torch.no_grad():
                    audio, audio_lens = self.encode_audio(
                        torch.from_numpy(sample["speech"]).to(self.device),
                        torch.from_numpy(sample["speech_lengths"]).to(self.device))
                audio = audio.float().cpu().numpy()
                audio_lens = audio_lens.cpu().numpy()
                packed = np.concatenate([audio[s, : audio_lens[s]]
                                         for s in range(audio.shape[0])], axis=0)
            else:
                packed = np.zeros((0, self.llm_cfg.hidden_size), np.float32)
            label = contents["assistant"][-1] if contents["assistant"] else ""
            k = key[i] if key is not None and i < len(key) else f"rand_key_{i}"
            if teacher_forcing:
                res = self._teacher_forcing_eval(sample, packed, tokenizer)
            else:
                res = self._generate_from_prompt(sample, packed, tokenizer, **kwargs)
            res.update({"key": k, "label": label})
            res["text_tn"] = re.sub(r"[^\w\s　一-鿿]+", "", res["text"])
            results.append(res)
        return results, meta

    def _splice_np(self, ids: np.ndarray, packed: np.ndarray, fbank_mask: np.ndarray):
        with torch.no_grad():
            emb = self.llm.embed(np.maximum(ids, 0), torch.float32).cpu().numpy()
        pos = np.nonzero(fbank_mask[: len(ids)] > 0)[0]
        n = min(len(pos), len(packed))
        emb[pos[:n]] = packed[:n]
        return emb

    def _generate_from_prompt(self, sample, packed, tokenizer, **kwargs) -> Dict:
        emb = self._splice_np(sample["source_ids"], packed, sample["fbank_mask"])
        eos_ids = self.eos_ids(tokenizer, kwargs)
        engine = self.engine(num_slots=kwargs.get("num_slots", 8),
                             max_len=kwargs.get("max_model_len", 2048))
        req = Request(request_id=0, input_embeds=emb,
                      max_new_tokens=kwargs.get("max_new_tokens", kwargs.get("max_length", 512)),
                      eos_token_ids=eos_ids, temperature=kwargs.get("temperature", 0.0))
        engine.generate([req])
        out_ids = [t for t in req.output_ids if t not in eos_ids]
        return {"text": tokenizer.decode(out_ids) if tokenizer else ""}

    def _teacher_forcing_eval(self, sample, packed, tokenizer) -> Dict:
        """Teacher-forcing loss and prediction over the assistant span (reference
        ``tearchforing`` branch ``model.py:908-928``)."""
        emb = self._splice_np(sample["input_ids"], packed, sample["fbank_mask"])
        with torch.no_grad():
            logits = self.llm.forward_embeds(torch.from_numpy(emb)[None].to(self.device))[0]
        pred = logits[:-1].float()
        tgt = torch.from_numpy(sample["labels_ids"][1:].astype(np.int64)).to(pred.device)
        valid = tgt != IGNORE_INDEX
        logp = torch.log_softmax(pred, dim=-1)
        ce = -torch.gather(logp, 1, tgt.clamp_min(0)[:, None])[:, 0]
        loss = float((ce * valid).sum().cpu() / max(int(valid.sum()), 1))
        n_src = len(sample["source_ids"])
        preds = pred[n_src - 1:].argmax(-1).cpu().numpy()
        tgt_np = tgt.cpu().numpy()[n_src - 1:]
        out = [int(t) for t, v in zip(preds, tgt_np != IGNORE_INDEX) if v]
        return {"text": tokenizer.decode(out) if tokenizer else "", "loss": loss}


@tables.register("model_classes", "GLMASR")
class GLMASR(LLMASR):
    """GLM-ASR-Nano (reference ``glm_asr/model.py:14``; ``funasr_tpu/models/llm_asr/
    model.py:323-347``): a Transformer audio encoder (conv2d x4 subsampling, d 256 unless
    the config says otherwise) + adaptor + a GLM-edge decoder (GQA + RMSNorm, the Qwen
    block layout set by ``llm_conf``), prompted with GLM's chat template around the audio
    span."""

    def __init__(self, audio_encoder: str = "TransformerEncoder",
                 audio_encoder_conf: Optional[dict] = None, input_size: int = 128,
                 prompt_template: str = "Please transcribe this audio into text", **kwargs):
        enc_conf = dict(audio_encoder_conf or {})
        if audio_encoder == "TransformerEncoder":
            enc_conf.setdefault("input_layer", "conv2d")
            enc_conf.setdefault("output_size", 256)
        super().__init__(audio_encoder=audio_encoder, audio_encoder_conf=enc_conf,
                         input_size=input_size, prompt_template=prompt_template, **kwargs)

    def build_chatml_ids(self, tokenizer, prompt: str, prev_text: str = ""):
        """[gMASK]<sop><|user|> prompt + audio ... <|assistant|> (GLM-edge's
        apply_chat_template layout); ``prev_text`` is a forced continuation prefix."""
        prefix = f"[gMASK]<sop><|user|>\n{prompt}\n<|begin_of_audio|>"
        suffix = "<|end_of_audio|><|assistant|>\n" + prev_text
        return tokenizer.encode(prefix), tokenizer.encode(suffix)


@tables.register("model_classes", "QwenAudio")
@tables.register("model_classes", "QwenAudioChat")
@tables.register("model_classes", "QwenAudioWarp")
class QwenAudio(LLMASR):
    """Qwen-Audio chat wrapper (reference ``qwen_audio/model.py``): a whisper-style audio
    encoder, ChatML prompting."""

    def build_chatml_ids(self, tokenizer, prompt: str, prev_text: str = ""):
        prefix = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                  "<|im_start|>user\nAudio 1:<audio>")
        suffix = f"</audio>\n{prompt}<|im_end|>\n<|im_start|>assistant\n" + prev_text
        return tokenizer.encode(prefix), tokenizer.encode(suffix)


@tables.register("model_classes", "LLMASRNAR")
class LLMASRNAR(LLMASR):
    """Non-autoregressive variant (reference ``llm_asr_nar/model.py``): one parallel LLM
    forward over the audio rows, every position decodes a token, repeats collapse."""

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

        audio_list = load_audio_text_image_video(data_in, fs=frontend.fs,
                                                 audio_fs=kwargs.get("fs", 16000))
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend, device=self.device)
        with torch.no_grad():
            audio, audio_lens = self.encode_audio(
                speech, torch.as_tensor(speech_lengths, device=self.device))
            b, t, _ = audio.shape
            kv = self.llm.init_kv_cache(b, t, torch.float32)
            positions = torch.arange(t, device=audio.device)[None].expand(b, t)
            logits, _ = self.llm.forward(audio, positions, kv,
                                         torch.zeros(b, dtype=torch.long, device=audio.device),
                                         audio_lens.long())
        ids = logits.argmax(-1).cpu().numpy()
        lens = audio_lens.cpu().numpy()
        if key is None:
            key = [f"rand_key_{i}" for i in range(b)]
        results = []
        for i in range(b):
            seq = [int(x) for x in ids[i, : lens[i]]]
            out = [seq[0]] if seq else []  # repeats collapse (a CTC-style surface)
            for tok in seq[1:]:
                if tok != out[-1]:
                    out.append(tok)
            results.append({"key": key[i],
                            "text": tokenizer.decode(out) if tokenizer is not None else ""})
        return results, {}


@tables.register("model_classes", "Qwen3ASR")
class Qwen3ASR(LLMASR):
    """Qwen3-ASR (reference ``qwen3_asr/``, an external package there): a Qwen3-config
    decoder, timestamps through the CTC branch."""


@tables.register("model_classes", "LLMASR2")
@tables.register("model_classes", "LLMASR3")
@tables.register("model_classes", "LLMASR4")
class LLMASRVersions(LLMASR):
    """The versioned LLMASR configs (reference LLMASR2:403 / LLMASR3:947 / LLMASR4:977):
    all speak the multiturn message format; their differences are checkpoint layouts,
    which the converter reads."""


@tables.register("model_classes", "LLMASRNARPrompt")
class LLMASRNARPrompt(LLMASRNAR):
    """The NAR variant with a learned prompt prefix (reference ``llm_asr_nar``)."""


@tables.register("model_classes", "MinMo")
class MinMo(LLMASR):
    """MinMo (the reference's ``minmo/`` is an empty stub)."""
