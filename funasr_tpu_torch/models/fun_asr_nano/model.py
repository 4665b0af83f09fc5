"""Fun-ASR-Nano in PyTorch: LLM-based ASR, a SAN-M audio encoder + an adaptor + a Qwen3
decoder (counterpart of ``funasr_tpu/models/fun_asr_nano/model.py``; FunASR
``funasr/models/fun_asr_nano/model.py:33-1100``).

Parameter names are FunASR's: ``audio_encoder.*`` (the port's ``SANMEncoder``, so every
encode runs the flash and FSMN kernels on the card), ``audio_adaptor.*``, ``llm.*``
(Hugging Face Qwen3 names, ``models/llm/qwen.py``) and, with a CTC branch,
``ctc_decoder.*`` and ``ctc.ctc_lo.*``.

``inference`` runs the JAX path:

* greedy (``temperature`` 0): the ChatML prefix | audio rows | suffix are spliced into
  one (B, T, D) buffer on the device (``assemble_prompts``, the JAX
  ``_assemble_prompts_jit``) and handed to ``LLMEngine.submit_prompt_batch``;
* sampled: one host prompt per utterance with ``prefix_len`` set, so the engine's prefix
  cache prefills the shared ChatML prefix once;
* with a CTC branch and a ``ctc_tokenizer``: ``ctc_text`` (greedy CTC) and character
  timestamps by forced alignment of both texts (60 ms frames).

One departure: the features go to the encoder in its weights' dtype, as the port's
Paraformer and SenseVoice do (JAX keeps them fp32, so its bf16 encoder computes in
fp32). The LLM runs in the engine's dtype, bf16 by default whatever the weights' dtype,
as in JAX. The encoder runs once a batch: the JAX CTC branch encodes again
(``ctc_branch``), with the same result.

``forward`` is the fine-tune loss (``forward_jit``), the encoder, adaptor and LLM all
trained: on the card the encoder's 50 attentions and FSMN memories run the flash and
FSMN kernels forward and backward.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

import funasr_tpu_torch.models.llm_asr.adaptor  # noqa: F401 (registers the adaptors)
import funasr_tpu_torch.models.sanm.encoder  # noqa: F401 (registers SANMEncoder)
from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.llm.engine import LLMEngine, Request
from funasr_tpu_torch.models.llm.qwen import QwenConfig, QwenLM, init_qwen
from funasr_tpu_torch.models.llm_asr.adaptor import init_adaptor
from funasr_tpu_torch.parallel.sharding import global_count
from funasr_tpu_torch.register import tables


def assemble_prompts(prefix, audio, audio_lens, suffix):
    """Splice [prefix | audio rows | suffix] per batch row on the device: prefix (P, D)
    and suffix (S, D) token embeds, audio (B, Ta, D) with (B,) valid lengths -> (B, P +
    Ta + S, D). A gather and two selects, no per-row shapes; rows past a prompt's length
    (P + audio_lens + S) are garbage that the engine masks."""
    b, ta, d = audio.shape
    p, s = prefix.shape[0], suffix.shape[0]
    pos = torch.arange(p + ta + s, device=audio.device)[None]     # (1, T)
    al = audio_lens.to(audio.device)[:, None]                      # (B, 1)
    in_prefix = (pos < p)[..., None]
    in_audio = ((pos >= p) & (pos < p + al))[..., None]
    pre_idx = pos.clamp(0, p - 1)
    aud_idx = (pos - p).clamp(0, ta - 1).expand(b, -1)
    suf_idx = (pos - p - al).clamp(0, s - 1)
    aud_rows = torch.gather(audio, 1, aud_idx[..., None].expand(-1, -1, d))
    return torch.where(in_prefix, prefix[pre_idx],
                       torch.where(in_audio, aud_rows, suffix[suf_idx]))


@tables.register("model_classes", "FunASRNano")
class FunASRNano(nn.Module):
    def __init__(self, audio_encoder: str = "SANMEncoder",
                 audio_encoder_conf: Optional[dict] = None, audio_adaptor: str = "Linear",
                 audio_adaptor_conf: Optional[dict] = None, llm_conf: Optional[dict] = None,
                 input_size: int = 560, vocab_size: int = -1, ctc_conf: Optional[dict] = None,
                 ctc_weight: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: every weight drawn from it (``init_weights``' rules for the
        encoder, adaptors and CTC head, ``init_qwen``'s for the LLM), else torch's
        default init."""
        super().__init__()
        self.audio_encoder = tables.encoder_classes[audio_encoder](
            input_size=input_size, device=device, **(audio_encoder_conf or {}))
        enc_out = self.audio_encoder.output_size()
        llm_conf = dict(llm_conf or {})
        self.llm_cfg = QwenConfig(**{k: v for k, v in llm_conf.items()
                                     if k in QwenConfig._fields})
        adaptor_conf = dict(audio_adaptor_conf or {})
        adaptor_conf.setdefault("encoder_dim", enc_out)
        adaptor_conf.setdefault("llm_dim", self.llm_cfg.hidden_size)
        self.audio_adaptor = tables.adaptor_classes[audio_adaptor](**adaptor_conf,
                                                                   device=device)
        self.llm = QwenLM(self.llm_cfg, device=device)
        # the CTC branch (reference model.py:153-206): an adaptor-class module over the
        # encoder output + a CTC head over the CTC tokenizer's vocab
        self.ctc = None
        self.ctc_decoder = None
        self.blank_id = kwargs.get("blank_id", 0)
        ctc_decoder = kwargs.get("ctc_decoder")
        if ctc_decoder is not None or ctc_weight > 0:
            from funasr_tpu_torch.models.ctc.ctc import CTC
            ctc_dec_conf = dict(kwargs.get("ctc_decoder_conf") or {})
            ctc_dec_conf.setdefault("encoder_dim", enc_out)
            ctc_dim = enc_out
            if ctc_decoder is not None:
                self.ctc_decoder = tables.adaptor_classes[ctc_decoder](**ctc_dec_conf,
                                                                       device=device)
                ctc_dim = ctc_dec_conf.get("llm_dim", getattr(self.ctc_decoder, "llm_dim",
                                                              enc_out))
            ctc_conf = dict(ctc_conf or {})
            ctc_vocab = int(ctc_conf.pop("ctc_vocab_size",
                                         vocab_size if vocab_size > 0 else 8404))
            self.ctc = CTC(odim=ctc_vocab, encoder_output_size=ctc_dim, device=device,
                           **ctc_conf)
        self.ctc_weight = ctc_weight
        self._engine: Optional[LLMEngine] = None
        self.kwargs = kwargs
        if generator is not None:
            init_weights(self.audio_encoder, generator)
            for mod in (self.audio_adaptor, self.ctc_decoder):
                if mod is not None:
                    init_adaptor(mod, generator)
            if self.ctc is not None:
                init_weights(self.ctc, generator)
            init_qwen(self.llm, generator)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        """The fine-tune loss (``fun_asr_nano/model.py:114-163``, reference
        ``forward:287-408``) -> (loss, stats, batch size). The LLM reads [``<|im_start|>`` |
        every audio row of the batch's width | ``<|im_end|>`` | target embeds] (the two
        ids clipped to the vocabulary, as the JAX ``embed`` clips them); CE on the target
        positions (``text >= 0`` within ``text_lengths``) over their count, at least 1, and
        ``acc`` by argmax; with a CTC head and ``ctc_weight`` > 0, plus ``ctc_weight`` x
        the CTC loss.

        As in JAX: no encoder dropout, whatever the config's ``dropout_rate`` (the JAX
        loss gives ``encode_audio`` no key; FunASR's torch model drops out); the CTC loss
        reads the encoder output the LLM path computed, where JAX encodes a second time:
        the same values and the same gradient. The head (the vocab projection) runs on
        the target window alone, gathered before it: rows are independent, so the
        numbers are those of JAX's full logits at a quarter of the head's work for
        Fun-ASR-Nano's prompts. ``generator`` is unused (nothing is drawn)."""
        b = speech.shape[0]
        enc, enc_lens = self.encode(speech, speech_lengths)
        audio, _ = self.audio_adaptor(enc, enc_lens)
        dt = torch.float32
        d = self.llm_cfg.hidden_size
        prefix = self.llm.embed([151644], dt)  # <|im_start|>
        suffix = self.llm.embed([151645], dt)  # <|im_end|>
        tgt = text.clamp_min(0)
        inputs = torch.cat([prefix[None].expand(b, -1, d), audio.to(dt),
                            suffix[None].expand(b, -1, d), self.llm.embed(tgt, dt)], dim=1)
        # the logits predicting target t sit one step left of it
        off = prefix.shape[0] + audio.shape[1] + suffix.shape[0]
        hidden = self.llm.hidden_embeds(inputs)[:, off - 1: off - 1 + tgt.shape[1]]
        pred = self.llm.logits_head(hidden)
        logp = torch.log_softmax(pred.float(), dim=-1)
        mask = (make_pad_mask(text_lengths, tgt.shape[1]) & (text >= 0)).float()
        ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        denom = global_count(mask.sum()).clamp_min(1.0)
        loss_llm = (ce * mask).sum() / denom
        acc = ((pred.argmax(-1) == tgt).float() * mask).sum() / denom
        stats = {"loss_llm": loss_llm, "acc": acc}
        loss = loss_llm
        if self.ctc is not None and self.ctc_weight > 0:
            ctc_in, ctc_lens = enc, enc_lens
            if self.ctc_decoder is not None:
                ctc_in, ctc_lens = self.ctc_decoder(ctc_in, ctc_lens)
            loss_ctc = self.ctc.loss(ctc_in, ctc_lens, text, text_lengths)
            stats["loss_ctc"] = loss_ctc
            loss = loss_llm + self.ctc_weight * loss_ctc
        stats["loss"] = loss
        return loss, stats, b

    @property
    def device(self) -> torch.device:
        return self.llm.device

    # ------------------------------------------------------------------

    def get_prompt(self, hotwords: Optional[List[str]] = None,
                   language: Optional[str] = None, itn: bool = True) -> str:
        prompt = ""
        if hotwords:
            joined = ", ".join(hotwords)
            prompt = ("请结合上下文信息，更加准确地完成语音转写任务。如果没有相关信息，"
                      "我们会留空。\n\n\n**上下文信息：**\n\n\n")
            prompt += f"热词列表：[{joined}]\n"
        prompt += "语音转写" if language is None else f"语音转写成{language}"
        if not itn:
            prompt += "，不进行文本规整"
        return prompt + "："

    def build_chatml_ids(self, tokenizer, prompt: str, prev_text: str = ""):
        """-> (prefix_ids, suffix_ids) around the audio span. ``prev_text`` follows the
        assistant turn's opener as a forced continuation (the streaming SDK's stage 2,
        reference ``inference_vllm_streaming.py:175-189``)."""
        prefix = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                  f"<|im_start|>user\n{prompt}")
        suffix = "<|im_end|>\n<|im_start|>assistant\n" + prev_text
        return tokenizer.encode(prefix), tokenizer.encode(suffix)

    def encode(self, speech, speech_lengths):
        """Features (B, T, D) -> (encoder output, its lengths); the features in the
        encoder's weight dtype."""
        dtype = next(self.audio_encoder.parameters()).dtype
        return self.audio_encoder(speech.to(dtype), speech_lengths)

    def encode_audio(self, speech, speech_lengths):
        enc, enc_lens = self.encode(speech, speech_lengths)
        return self.audio_adaptor(enc, enc_lens)

    def ctc_log_probs(self, enc, enc_lens):
        """Encoder output -> ctc_decoder -> fp32 CTC log-probs, (B, T, V) and lengths."""
        if self.ctc_decoder is not None:
            enc, enc_lens = self.ctc_decoder(enc, enc_lens)
        return self.ctc.log_softmax(enc), enc_lens

    def engine(self, num_slots: int = 8, max_len: int = 2048) -> LLMEngine:
        if self._engine is None:
            self._engine = LLMEngine(self.llm, num_slots=num_slots, max_len=max_len)
        return self._engine

    # ------------------------------------------------------------------

    @staticmethod
    def eos_ids(tokenizer, kwargs) -> tuple:
        eos_ids = tuple(kwargs.get("eos_token_ids", ()))
        if not eos_ids:
            for tok in ("<|im_end|>", "<|endoftext|>"):
                try:
                    ids = tokenizer.encode(tok)
                    if len(ids) == 1:
                        eos_ids += (ids[0],)
                except Exception:  # noqa: BLE001 (a tokenizer without the token)
                    pass
        return eos_ids

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        from funasr_tpu_torch.utils.load_utils import extract_fbank, load_audio_text_image_video

        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=frontend.fs, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        dev = self.device
        speech, speech_lengths = extract_fbank(audio_list, frontend=frontend, device=dev)
        speech_lengths = torch.as_tensor(speech_lengths, device=dev)
        lens_host = speech_lengths.cpu().numpy()
        meta["batch_data_time"] = (float(np.sum(lens_host)) * frontend.frame_shift_ms
                                   * frontend.lfr_n / 1000)

        with torch.no_grad():
            enc, enc_lens = self.encode(speech, speech_lengths)
            audio_embeds, audio_lens = self.audio_adaptor(enc, enc_lens)
        audio_lens_host = audio_lens.cpu().numpy()

        hotword = kwargs.get("hotword")
        prompt = self.get_prompt(hotwords=hotword.split() if hotword else None,
                                 language=kwargs.get("language"),
                                 itn=kwargs.get("use_itn", True))
        prefix_ids, suffix_ids = self.build_chatml_ids(tokenizer, prompt,
                                                       prev_text=kwargs.get("prev_text", ""))
        eos_ids = self.eos_ids(tokenizer, kwargs)
        engine = self.engine(num_slots=kwargs.get("num_slots", 8),
                             max_len=kwargs.get("max_model_len", 2048))
        temperature = kwargs.get("temperature", 0.0)
        max_new = kwargs.get("max_new_tokens", 256)
        with torch.no_grad():
            prefix = self.llm.embed(prefix_ids, torch.float32)
            suffix = self.llm.embed(suffix_ids, torch.float32)
            if not temperature:
                # greedy: splice on the device, hand the (B, T, D) buffer to the engine
                prompts = assemble_prompts(prefix, audio_embeds.float(), audio_lens, suffix)
                prompt_lens = len(prefix_ids) + audio_lens_host + len(suffix_ids)
                requests = engine.submit_prompt_batch(prompts, prompt_lens,
                                                      max_new_tokens=max_new,
                                                      eos_token_ids=eos_ids)
                while any(not r.done for r in requests):
                    if not engine.step():
                        break
            else:
                prefix_np, suffix_np = prefix.cpu().numpy(), suffix.cpu().numpy()
                audio_np = audio_embeds.float().cpu().numpy()
                requests = [Request(
                    request_id=i, max_new_tokens=max_new, eos_token_ids=eos_ids,
                    temperature=temperature,
                    input_embeds=np.concatenate(
                        [prefix_np, audio_np[i, :audio_lens_host[i]], suffix_np], axis=0),
                    # every request repeats the ChatML prefix: prefilled once
                    prefix_len=prefix_np.shape[0]) for i in range(audio_np.shape[0])]
                engine.generate(requests)

        if key is None:
            key = [f"rand_key_{i}" for i in range(len(requests))]
        results = []
        for i, req in enumerate(requests):
            out_ids = [t for t in req.output_ids if t not in eos_ids]
            text = tokenizer.decode(out_ids) if tokenizer is not None else ""
            results.append({"key": key[i], "text": text})

        ctc_tokenizer = kwargs.get("ctc_tokenizer")
        if self.ctc is not None and ctc_tokenizer is not None:
            with torch.no_grad():
                logp, ctc_lens = self.ctc_log_probs(enc, enc_lens)
            self._ctc_results(results, logp.cpu().numpy(), ctc_lens.cpu().numpy(),
                              ctc_tokenizer)
        return results, meta

    def _ctc_results(self, results, logp, ctc_lens, ctc_tokenizer):
        """Greedy ``ctc_text`` and character timestamps by forced alignment of both
        texts (reference model.py:965-1070; 60 ms frames)."""
        from funasr_tpu_torch.ops.ctc_align import ctc_forced_align

        frame_s = 0.06  # lfr 6 x 10 ms

        def path_to_ts(path):
            out = []
            prev = self.blank_id
            for t, lab in enumerate(path):
                if lab != self.blank_id:
                    if lab != prev:  # a new emission starts
                        out.append({"token": ctc_tokenizer.decode([int(lab)]),
                                    "start_time": round(t * frame_s, 3),
                                    "end_time": round((t + 1) * frame_s, 3)})
                    else:  # the same emission goes on
                        out[-1]["end_time"] = round((t + 1) * frame_s, 3)
                prev = lab
            return out

        def align(x, text):
            ids = np.asarray(ctc_tokenizer.encode(text), np.int64)
            ids = ids[(ids >= 0) & (ids < x.shape[-1])]  # drop out-of-vocab ids
            if ids.size == 0 or 2 * ids.size + 1 > x.shape[0]:
                return []
            return path_to_ts(ctc_forced_align(x, ids, x.shape[0], len(ids),
                                               blank_id=self.blank_id))

        for i, res in enumerate(results):
            x = logp[i, : int(ctc_lens[i])]
            yseq = x.argmax(-1)
            keep = np.concatenate([[True], yseq[1:] != yseq[:-1]])
            toks = yseq[keep]
            toks = toks[toks != self.blank_id].tolist()
            res["ctc_text"] = ctc_tokenizer.decode(toks).replace("<|nospeech|>", "")
            res["ctc_timestamps"] = align(x, res["ctc_text"])
            res["timestamps"] = align(x, res["text"])
