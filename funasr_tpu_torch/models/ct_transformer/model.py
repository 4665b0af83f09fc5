"""CT-Transformer punctuation restoration in PyTorch (counterpart of
``funasr_tpu/models/ct_transformer/model.py``; controllable time-delay transformer,
arXiv 2003.01309).

FunASR's ``funasr/models/ct_transformer/model.py``: ``punc_forward`` = embedding -> SAN-M
encoder (``input_layer="pe"``) -> linear punctuation head, under FunASR's state-dict
names (``embed``, ``encoder.*``, ``decoder``). ``inference`` is the JAX package's host
loop, copied: 20-word mini-sentence windows with the words after the last sentence end
carried into the next window, output {"key", "text", "punc_array"} with ids
{1: _, 2: ，, 3: 。, 4: ？, ...}.

Each window is padded to ``bucket_length(n, minimum=8, multiple=8)`` with length n, as
in JAX; every encoder block runs the flash kernel (8 heads x 32 at ct-punc width) and
the FSMN kernel on CUDA. Each window's logits come to the host for the argmax, as in
JAX, so the loop is host-bound by design.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, embedding
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.ct_transformer.utils import split_to_mini_sentence, split_words
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


@tables.register("model_classes", "CTTransformer")
class CTTransformer(nn.Module):
    """Output: {"key", "text" (punctuated), "punc_array" np.ndarray}."""

    def __init__(self, encoder: str = "SANMEncoder", encoder_conf: Optional[dict] = None,
                 vocab_size: int = -1, punc_list: Optional[list] = None,
                 embed_unit: int = 128, att_unit: int = 256, sentence_end_id: int = 3,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        """``generator``: when given, every weight is drawn from it (the JAX package's
        init rules, ``core/module.py::init_weights``). Training-only keys of hub configs
        (``punc_weight``, ``ignore_id``, ...) are accepted and ignored."""
        super().__init__()
        self.punc_list = punc_list or ["<unk>", "_", "，", "。", "？", "、"]
        self.sentence_end_id = sentence_end_id
        enc_conf = dict(encoder_conf or {})
        enc_conf.setdefault("input_size", embed_unit)
        self.embed = nn.Embedding(vocab_size, embed_unit, device=device)
        self.encoder = tables.encoder_classes[encoder](device=device, **enc_conf)
        self.decoder = nn.Linear(att_unit, len(self.punc_list), device=device)
        self.jieba_usr_dict = None
        if kwargs.get("jieba_usr_dict"):
            try:
                import jieba
                jieba.load_userdict(kwargs["jieba_usr_dict"])
                self.jieba_usr_dict = jieba
            except ImportError:
                pass
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def punc_forward(self, text, text_lengths):
        """(B, L) ids -> (B, L, punc) logits."""
        x = embedding(text, self.embed.weight)
        h, _ = self.encoder(x, text_lengths)
        return apply_linear(self.decoder, h)

    # ------------------------------------------------------------------

    def window_logits(self, ids: np.ndarray) -> np.ndarray:
        """One window of ids -> its (n, punc) logits on the host."""
        n = len(ids)
        nb = bucket_length(n, minimum=8, multiple=8)
        padded = np.zeros((1, nb), np.int64)
        padded[0, :n] = ids
        with torch.inference_mode():
            y = self.punc_forward(torch.from_numpy(padded).to(self.device),
                                  torch.tensor([n], dtype=torch.int32, device=self.device))
            return y[0, :n].float().cpu().numpy()

    def inference(self, data_in, data_lengths=None, key: Optional[list] = None,
                  tokenizer=None, frontend=None, **kwargs):
        """Sliding 20-word window punctuation with sentence-boundary cache
        (reference ``inference:290+`` semantics, restructured)."""
        assert len(data_in) == 1 if isinstance(data_in, list) else True
        text = data_in[0] if isinstance(data_in, list) else data_in
        if not text or not str(text).strip():
            return [{"key": key[0] if key else "", "text": "",
                     "punc_array": None}], {"batch_data_time": -1}

        split_size = kwargs.get("split_size", 20)
        cache_pop_trigger_limit = 200

        tokens = split_words(text, jieba_usr_dict=self.jieba_usr_dict)
        tokens_int = tokenizer.encode(" ".join(tokens)) if hasattr(
            tokenizer, "seg_dict") and tokenizer.seg_dict else [
            tokenizer.token2id.get(t, tokenizer.unk_id) for t in tokens]

        mini_sents = split_to_mini_sentence(tokens, split_size)
        mini_ids = split_to_mini_sentence(tokens_int, split_size)
        cache_sent: List[str] = []
        cache_ids = np.array([], dtype=np.int32)
        out_text = ""
        punc_array: Optional[np.ndarray] = None

        def is_ascii(w):
            return len(w[0].encode()) == 1

        for si in range(len(mini_sents)):
            sent = cache_sent + mini_sents[si]
            ids = np.concatenate([cache_ids, np.asarray(mini_ids[si], np.int32)])
            logits = self.window_logits(ids)
            puncs = logits.argmax(-1).astype(np.int64)
            assert len(puncs) == len(sent)

            if si < len(mini_sents) - 1:
                # carry words after the last sentence end into the next window
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

            # assemble surface text (capitalization + latin punctuation forms)
            pieces = []
            for i, w in enumerate(sent):
                if (i == 0 or self.punc_list[puncs[i - 1]] in ("。", "？")) \
                        and is_ascii(w):
                    w = w.capitalize()
                if is_ascii(w) and (i == 0 or is_ascii(sent[i - 1])):
                    w = " " + w
                pieces.append(w)
                p = self.punc_list[puncs[i]]
                if p != "_":
                    if is_ascii(sent[i]):
                        p = {"，": ",", "。": ".", "？": "?"}.get(p, p)
                    pieces.append(p)
            out_text += "".join(pieces)

            if si == len(mini_sents) - 1 and out_text:
                # force a sentence end at the very end
                if out_text[-1] in ("，", "、"):
                    out_text = out_text[:-1] + "。"
                    if len(puncs):
                        puncs[-1] = self.sentence_end_id
                elif out_text[-1] == ",":
                    out_text = out_text[:-1] + "."
                    if len(puncs):
                        puncs[-1] = self.sentence_end_id
                elif out_text[-1] not in ("。", "？") and len(out_text[-1].encode()) != 1:
                    out_text += "。"
                    if len(puncs):
                        puncs[-1] = self.sentence_end_id
                elif out_text[-1] not in (".", "?") and len(out_text[-1].encode()) == 1:
                    out_text += "."
                    if len(puncs):
                        puncs[-1] = self.sentence_end_id

            punc_array = puncs if punc_array is None else np.concatenate(
                [punc_array, puncs])

        result = [{"key": key[0] if key else "punc",
                   "text": out_text, "punc_array": punc_array}]
        return result, {}
