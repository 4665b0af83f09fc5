"""Paraformer-v2 in PyTorch: the decoder's token inputs from compressed CTC posteriors
instead of a CIF predictor (counterpart of ``funasr_tpu/models/paraformer_v2/model.py``;
FunASR ``funasr/models/paraformer_v2_community/model.py:30``).

The greedy CTC path segments the frames (``map_path_to_target_index``); each segment's
posterior rows are averaged into one row of a (K, vocab) matrix by one batched product
over the whole batch (``compress_ctc_probs``), projected by ``decoder.embed.0``
(``Linear(vocab, d)``, FunASR's name; the JAX package keeps it as a model-level
``embed``) and decoded by the Paraformer decoder. The CTC head is mandatory and the
model has no predictor. It keeps Paraformer's dispatch / fetch pair: ``infer_core``
runs the compression with the pair's token budget K = T/2 + 16, and the fetch's
full-budget retry runs when a row has K segments (JAX ``paraformer/model.py:308-330,
384-388``). The decoder runs in the weights' dtype: the JAX package feeds it the fp32
projection, which under bf16 weights lifts its decoder to fp32; in fp32 the two are the
same. Training's forced alignment (``ctc_forced_align_jax``) comes with slice 7.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.register import tables


def map_path_to_target_index(path, blank_id: int):
    """Greedy / aligned label path (B, T) -> each frame's target segment index (B, T),
    -1 at blanks (JAX ``:34-41``)."""
    prev = torch.cat([torch.full_like(path[:, :1], blank_id), path[:, :-1]], dim=1)
    is_token = path != blank_id
    seg = torch.cumsum((is_token & (path != prev)).to(torch.int32), dim=1) - 1
    return torch.where(is_token, seg, -1)


def compress_ctc_probs(probs, target_idx, frame_valid, max_tokens: int):
    """Average the CTC posterior rows of each target segment (JAX ``:44-56``).

    probs (B, T, V); target_idx (B, T) in [-1, U); frame_valid (B, T) bool. Segments at
    or past ``max_tokens`` are dropped, as JAX's one-hot drops them. Returns (compressed
    (B, max_tokens, V) in probs' dtype, counts (B, max_tokens) frames a segment)."""
    sel = (target_idx >= 0) & frame_valid
    oh = ((target_idx[..., None] == torch.arange(max_tokens, device=probs.device))
          & sel[..., None]).to(probs.dtype)
    summed = torch.einsum("btu,btv->buv", oh.float(), probs.float())
    counts = oh.float().sum(dim=1)
    return (summed / torch.clamp_min(counts, 1e-9)[..., None]).to(probs.dtype), counts


@tables.register("model_classes", "Paraformer_v2_community")
@tables.register("model_classes", "ParaformerV2")
class ParaformerV2(Paraformer):
    def __init__(self, ctc_weight: float = 0.5, predictor: Optional[str] = None,
                 ctc_conf: Optional[Dict] = None, vocab_size: int = -1, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """``predictor`` is accepted for the configs that name one and not built; the CTC
        head is built whatever ``ctc_weight`` (the training loss's weight) says."""
        super().__init__(predictor=None, vocab_size=vocab_size, device=device, **kwargs)
        self.ctc = CTC(odim=vocab_size, encoder_output_size=self.encoder.output_size(),
                       device=device, **(ctc_conf or {}))
        self.decoder.embed = nn.Sequential(
            nn.Linear(vocab_size, self.encoder.output_size(), device=device))
        if generator is not None:
            init_weights(self, generator)

    def infer_core(self, speech, speech_lengths, max_tokens: Optional[int] = None,
                   context=None):
        """``infer_jit`` (JAX ``:122-141``): the CTC path compressed into at most
        ``max_tokens`` (else max(T // 2, 8)) decoder inputs. Returns Paraformer's tuple
        with zero alphas and peaks; the score sums the decoder's largest logits, as in
        JAX."""
        encoder_out, encoder_out_lens = self.encode(speech, speech_lengths)
        logits = self.ctc.logits(encoder_out)
        probs = torch.softmax(logits.float(), dim=-1)
        frame_valid = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        path = torch.where(frame_valid, logits.argmax(dim=-1), self.blank_id)
        target_idx = map_path_to_target_index(path, self.blank_id)
        k = max_tokens or max(encoder_out.shape[1] // 2, 8)
        compressed, counts = compress_ctc_probs(probs, target_idx, frame_valid, k)
        token_lens = (counts > 0).sum(dim=-1).to(torch.int32)
        sem = apply_linear(self.decoder.embed[0], compressed).to(self.dtype)
        # the decoder's logits, not log-probs: JAX's score sums their maxima
        decoder_out, _ = self.decoder(encoder_out, encoder_out_lens, sem, token_lens)
        yseq = decoder_out.argmax(dim=-1).to(torch.int32)
        tok_valid = make_pad_mask(token_lens, k)
        score = (decoder_out.max(dim=-1).values * tok_valid).sum(dim=-1)
        yseq = torch.where(tok_valid, yseq, self.blank_id)
        zeros = torch.zeros(speech.shape[0], encoder_out.shape[1] + 1, device=speech.device)
        return yseq, token_lens, score, zeros, zeros, encoder_out, encoder_out_lens
