"""AutoModelVLLM: the batched LLM-ASR serving facade of the port (a port of
``funasr_tpu/auto/auto_model_vllm.py``; FunASR ``funasr/auto/auto_model_vllm.py:181``).

The same ``generate()`` surface as the reference, over the port's continuous-batching
``LLMEngine`` instead of vLLM. ``max_num_seqs`` sets the engine's slots and
``max_model_len`` its cache bound. ``tensor_parallel_size`` > 1 raises: sharding the
LLM over several cards is ROADMAP item 21b.
"""

from __future__ import annotations

from typing import List, Optional

_LLM_BASED_MODELS = {"FunASRNano", "LLMASR", "LLMASR2", "LLMASR3", "LLMASR4",
                     "LLMASRNAR", "GLMASR", "QwenAudioWarp", "QwenAudio",
                     "QwenAudioChat"}

# reference auto_model_vllm.py:59-66 says why each family is excluded
_NON_LLM_MODELS = {
    "Paraformer": "non-autoregressive CIF model — no LLM decoding",
    "SenseVoice": "CTC encoder model — not LLM-based",
    "CTTransformer": "small punctuation model — no benefit from batched LLM",
    "Conformer": "CTC/attention encoder-decoder — no LLM",
    "Transformer": "CTC/attention encoder-decoder — no LLM",
    "Qwen3ASR": "served by the external qwen-asr package in the reference",
}


def check_vllm_applicable(model_class: str) -> bool:
    """True for LLM-decoder models; raises with the reason for known non-LLM families
    (reference ``check_vllm_applicable:67``)."""
    if model_class in _LLM_BASED_MODELS:
        return True
    for non_llm, reason in _NON_LLM_MODELS.items():
        if non_llm in model_class:
            raise ValueError(
                f"Model '{model_class}' cannot use the batched-LLM path: "
                f"{reason}. Use funasr_tpu_torch.AutoModel instead.")
    return False


class AutoModelVLLM:
    def __init__(self, **kwargs):
        from funasr_tpu_torch.auto.auto_model import AutoModel

        self.tensor_parallel_size = kwargs.pop("tensor_parallel_size", 1)
        if self.tensor_parallel_size > 1:
            raise NotImplementedError(
                "tensor_parallel_size > 1: sharding the LLM over several cards is not "
                "ported yet (ROADMAP item 21b)")
        self.num_slots = kwargs.pop("max_num_seqs", 8)
        self.max_model_len = kwargs.pop("max_model_len", 2048)
        model, kwargs = AutoModel.build_model(**kwargs)
        name = type(model).__name__
        if not check_vllm_applicable(name):
            raise ValueError(f"{name} is not an LLM-based model; use AutoModel instead "
                             f"(vLLM-path models: {sorted(_LLM_BASED_MODELS)})")
        self.model = model
        self.kwargs = kwargs

    def generate(self, input, input_len=None, key: Optional[List] = None, **cfg):
        from funasr_tpu_torch.auto.auto_model import prepare_data_iterator

        key_list, data_list = prepare_data_iterator(input, input_len=input_len, key=key)
        merged = dict(self.kwargs)
        merged.update(cfg)
        merged.setdefault("num_slots", self.num_slots)
        merged.setdefault("max_model_len", self.max_model_len)
        results, _ = self.model.inference(
            data_list, key=key_list, tokenizer=merged.get("tokenizer"),
            frontend=merged.get("frontend"),
            **{k: v for k, v in merged.items()
               if k not in ("tokenizer", "frontend", "model", "model_conf")})
        return results

    def streaming_generate(self, audio_input, chunk_ms: int = 720, rollback_chars: int = 8,
                           **cfg):
        """Streaming LLM-ASR (reference ``fun_asr_nano/inference_vllm_streaming.py:190``):
        yields an improving transcript per audio chunk. Every chunk decodes the prefix
        window ``audio[:end_i]``, all windows through the engine at once. Stage 1 decodes
        the first 10 windows fresh; the longest text, less its last ``rollback_chars``,
        is forced as the assistant's opening (``prev_text``) for the rest (stage 2).
        ``fixed_text`` drops the unstable tail of non-final partials.

        Yields {"text", "fixed_text", "is_final", "chunk_idx", "audio_duration_ms"}."""
        import numpy as np

        from funasr_tpu_torch.utils.load_utils import load_audio_text_image_video

        merged = dict(self.kwargs)
        merged.update(cfg)
        fs = getattr(merged.get("frontend"), "fs", 16000)
        audio = np.asarray(
            load_audio_text_image_video(audio_input, fs=fs)
            if isinstance(audio_input, (str, bytes)) else audio_input,
            np.float32).reshape(-1)
        chunk_samples = max(int(fs * chunk_ms / 1000), 1)
        num_chunks = max(-(-len(audio) // chunk_samples), 1)
        windows = [audio[: min((i + 1) * chunk_samples, len(audio))]
                   for i in range(num_chunks)]

        def info(i):
            return {"is_final": i == num_chunks - 1, "chunk_idx": i + 1,
                    "audio_duration_ms": len(windows[i]) * 1000.0 / fs}

        stage1 = min(10, num_chunks)
        best = ""
        for i, res in enumerate(self.generate(windows[:stage1], **cfg)):
            text = res.get("text", "")
            if text.strip() and len(text) > len(best):
                best = text
            if info(i)["is_final"]:
                fixed = text
            elif text.strip() and len(text) > rollback_chars:
                fixed = text[:-rollback_chars]
            else:
                fixed = ""
            yield {"text": text, "fixed_text": fixed, **info(i)}

        if stage1 < num_chunks:
            prev = best[:-rollback_chars] if len(best) > rollback_chars else best
            results = self.generate(windows[stage1:], prev_text=prev, **cfg)
            for j, res in enumerate(results):
                i = stage1 + j
                full = prev + res.get("text", "")
                if info(i)["is_final"]:
                    fixed = full
                elif full.strip() and len(full) > rollback_chars:
                    fixed = full[:-rollback_chars]
                else:
                    fixed = prev
                yield {"text": full, "fixed_text": fixed, **info(i)}
