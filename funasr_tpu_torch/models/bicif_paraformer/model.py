"""BiCifParaformer in PyTorch: Paraformer plus the CifPredictorV3 timestamp head
(counterpart of ``funasr_tpu/models/bicif_paraformer/model.py``; FunASR
``funasr/models/bicif_paraformer/model.py:42-360``, the production
``speech_paraformer-large-vad-punc`` model).

The decode is Paraformer's, with the same bucketing, token budget and full-budget retry;
then ``get_upsample_timestamp`` rescales the upsampled alphas to the decoded token count
(``infer_jit_timestamp``), and each row's timestamps come from
``ts_prediction_lfr6_standard`` over its ``enc_len * upsample_times`` frames at that
upsample rate. It keeps Paraformer's dispatch / fetch pair: ``decode_outputs`` hands the
upsampled alphas and peaks to the pair's single copy, and ``transcript`` formats each
row, so ``AutoModel``'s double-buffered loop keeps the timestamps.

``forward`` is the training loss (``forward_jit``, ``model.py:39-53``): Paraformer's plus
``loss_pre2``, the MAE of the upsampled alphas' sum against the target count. As in the
JAX package, that head reads a second pass of the encoder without SpecAug or dropout, so
a BiCif step runs the encoder twice (SeACo-Paraformer inherits the loss).
"""

from __future__ import annotations

from typing import Optional

import funasr_tpu_torch.models.bicif_paraformer.cif_predictor  # noqa: F401 (registers V3)
from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.models.paraformer.cif_predictor import mae_token_loss
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.timestamp_tools import ts_prediction_lfr6_standard


@tables.register("model_classes", "BiCifParaformer")
class BiCifParaformer(Paraformer):
    def __init__(self, *args, predictor: str = "CifPredictorV3", **kwargs):
        super().__init__(*args, predictor=predictor, **kwargs)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None,
                sampler_uniform=None):
        """Paraformer's (loss, stats, weight) with ``loss_pre2`` added to the loss and the
        stats."""
        loss, stats, weight = super().forward(speech, speech_lengths, text, text_lengths,
                                              generator, sampler_uniform)
        encoder_out, encoder_out_lens = self.encode(speech, speech_lengths)
        mask = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        _, _, us_alphas, _ = self.predictor.get_upsample_timestamp(encoder_out, mask)
        loss_pre2 = mae_token_loss(text_lengths + self.predictor_bias, us_alphas.sum(dim=-1))
        loss = loss + loss_pre2
        return loss, dict(stats, loss_pre2=loss_pre2, loss=loss), weight

    def infer_timestamp(self, speech, speech_lengths, max_tokens: Optional[int] = None,
                        context=None):
        """``infer_jit_timestamp`` (``model.py:55-64``) -> (yseq, token_lens, score,
        us_alphas (B, T * up), us_peaks, encoder_out_lens)."""
        (yseq, token_lens, score, _, _, encoder_out,
         encoder_out_lens) = self.infer_core(speech, speech_lengths, max_tokens, context)
        mask = make_pad_mask(encoder_out_lens, encoder_out.shape[1])
        _, _, us_alphas, us_peaks = self.predictor.get_upsample_timestamp(
            encoder_out, mask, token_num=token_lens.float())
        return yseq, token_lens, score, us_alphas, us_peaks, encoder_out_lens

    def wants_timestamps(self, kwargs) -> bool:
        return True

    def decode_outputs(self, sp, ln, max_tokens: int, timestamps: bool = True, context=None):
        yseq, token_lens, _, us_alphas, us_peaks, enc_lens = self.infer_timestamp(
            sp, ln, max_tokens, context)
        return yseq, token_lens, enc_lens, (us_alphas, us_peaks)

    def transcript(self, token, tokenizer, enc_len: int, ts, kwargs) -> dict:
        """``model.py:105-121``: timestamps over the row's ``enc_len * up`` upsampled
        frames at upsample rate ``up``."""
        up = self.predictor.upsample_times
        us_alphas, us_peaks = ts
        n_us = enc_len * up
        _, timestamp = ts_prediction_lfr6_standard(
            us_alphas[:n_us], us_peaks[:n_us], list(token),
            vad_offset=kwargs.get("begin_time", 0), upsample_rate=up)
        if not hasattr(tokenizer, "bpemodel"):
            text, timestamp, _ = postprocess_utils.sentence_postprocess(token, timestamp)
        else:
            text = tokenizer.tokens2text(token)
        return {"text": text, "timestamp": timestamp}
