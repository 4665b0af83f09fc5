"""CTTransformerStreaming in PyTorch: realtime (VAD-aware) punctuation (counterpart of
``funasr_tpu/models/ct_transformer_streaming/model.py``; FunASR
``funasr/models/ct_transformer_streaming/model.py:32``).

The offline ``CTTransformer`` with ``SANMVadEncoder``: each call's text follows the
words carried in ``cache["pre_text"]`` (those after the last sentence end), and
``vad_pos`` (their count) keeps the carried words from attending to the new ones in the
last layer. ``inference`` is the JAX package's loop, copied: 20-word windows padded to
``bucket_length(n, 8, 8)``, the 200-word pop trigger, only the words past ``vad_pos``
emitted, a trailing punctuation mark withheld ("_") so the next call can revise it.
Every encoder layer runs the flash kernel with per-row key limits (3 causal, 1 corner
at ct-punc's 4 blocks) and the FSMN kernel on CUDA.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from funasr_tpu_torch.core.layers import apply_linear, embedding
from funasr_tpu_torch.models.ct_transformer.model import CTTransformer
from funasr_tpu_torch.models.ct_transformer.utils import split_to_mini_sentence, split_words
from funasr_tpu_torch.models.ct_transformer_streaming import encoder as _vad_encoder  # noqa: F401
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


@tables.register("model_classes", "CTTransformerStreaming")
class CTTransformerStreaming(CTTransformer):
    """Output per call: {"key", "text" (new words only, punctuated), "punc_array"}."""

    def __init__(self, encoder: str = "SANMVadEncoder", **kwargs):
        super().__init__(encoder=encoder, **kwargs)

    def punc_forward(self, text, text_lengths, vad_indexes=None):
        """(B, L) ids, (B,) lengths, (B,) vad positions -> (B, L, punc) logits."""
        x = embedding(text, self.embed.weight)
        h, _ = self.encoder(x, text_lengths, vad_indexes)
        return apply_linear(self.decoder, h)

    def window_logits(self, ids: np.ndarray, vad_pos: int = 0) -> np.ndarray:
        """One window of ids with its vad position -> its (n, punc) logits on the host."""
        n = len(ids)
        nb = bucket_length(n, minimum=8, multiple=8)
        padded = np.zeros((1, nb), np.int64)
        padded[0, :n] = ids
        dev = self.device
        with torch.inference_mode():
            y = self.punc_forward(torch.from_numpy(padded).to(dev),
                                  torch.full((1,), n, dtype=torch.int32, device=dev),
                                  torch.full((1,), vad_pos, dtype=torch.int32, device=dev))
            return y[0, :n].float().cpu().numpy()

    def inference(self, data_in, data_lengths=None, key: Optional[list] = None,
                  tokenizer=None, frontend=None, cache: Optional[dict] = None, **kwargs):
        if cache is None:
            cache = {}
        cache.setdefault("pre_text", [])
        text = data_in[0] if isinstance(data_in, list) else data_in
        text = "".join(cache["pre_text"]) + " " + str(text)

        split_size = kwargs.get("split_size", 20)
        cache_pop_trigger_limit = 200

        tokens = split_words(text, jieba_usr_dict=self.jieba_usr_dict)
        tokens_int = [tokenizer.token2id.get(t, tokenizer.unk_id) for t in tokens]

        mini_sents = split_to_mini_sentence(tokens, split_size)
        mini_ids = split_to_mini_sentence(tokens_int, split_size)
        cache_sent: List[str] = []
        cache_ids = np.array([], dtype=np.int32)
        punc_strs: List[str] = []
        words: List[str] = []
        puncs = np.array([], dtype=np.int64)
        vad_pos = len(cache["pre_text"])

        for si in range(len(mini_sents)):
            sent = cache_sent + mini_sents[si]
            ids = np.concatenate([cache_ids, np.asarray(mini_ids[si], np.int32)])
            logits = self.window_logits(ids, vad_pos)
            puncs = logits.argmax(-1).astype(np.int64)
            assert len(puncs) == len(sent)

            if si < len(mini_sents) - 1:
                sentence_end = -1
                last_comma = -1
                for i in range(len(puncs) - 2, 1, -1):
                    p = self.punc_list[puncs[i]]
                    if p in ("。", "？"):
                        sentence_end = i
                        break
                    if last_comma < 0 and p == "，":
                        last_comma = i
                if sentence_end < 0 and len(sent) > cache_pop_trigger_limit \
                        and last_comma >= 0:
                    sentence_end = last_comma
                    puncs[sentence_end] = self.sentence_end_id
                cache_sent = sent[sentence_end + 1:]
                cache_ids = ids[sentence_end + 1:]
                sent = sent[: sentence_end + 1]
                puncs = puncs[: sentence_end + 1]

            punc_strs += [self.punc_list[int(x)] for x in puncs]
            words += sent

        # emit only the words past the carried pre-text, with their punctuation
        pieces: List[str] = []
        emitted_punc: List[str] = []
        skip_num = 0
        for i in range(len(words)):
            if i > 0 and len(words[i][0].encode()) == 1 \
                    and len(words[i - 1][-1].encode()) == 1:
                words[i] = " " + words[i]
            if skip_num < vad_pos:
                skip_num += 1
            else:
                pieces.append(words[i])
            if skip_num >= vad_pos:
                emitted_punc.append(punc_strs[i])
                if punc_strs[i] != "_":
                    pieces.append(punc_strs[i])
        sentence_out = "".join(pieces)

        # carry words after the last full stop into the next call
        sentence_end = -1
        for i in range(len(punc_strs) - 2, 1, -1):
            if punc_strs[i] in ("。", "？"):
                sentence_end = i
                break
        cache["pre_text"] = words[sentence_end + 1:]
        if sentence_out and sentence_out[-1] in self.punc_list:
            sentence_out = sentence_out[:-1]
            if emitted_punc:
                emitted_punc[-1] = "_"

        result = [{"key": key[0] if key else "punc", "text": sentence_out,
                   "punc_array": puncs}]
        return result, {}
