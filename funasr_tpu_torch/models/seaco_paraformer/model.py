"""SeACo-Paraformer in PyTorch: semantic-context hotword biasing (counterpart of
``funasr_tpu/models/seaco_paraformer/model.py``; FunASR ``funasr/models/seaco_paraformer/
model.py:49-420``, the ``paraformer-zh`` model).

BiCifParaformer plus, under FunASR's names, ``bias_encoder`` (a 2-layer LSTM over each
hotword's ``decoder.embed`` rows, its last valid step kept, in fp32 whatever the weights'
dtype: ``core/layers.py::lstm_apply``), ``seaco_decoder`` (a SAN-M decoder without an
output layer whose memory is the hotword matrix; at FunASR's kernel_size 21 its FSMN
blocks take the FSMN kernel's k = 21 instantiation) and ``hotword_output_layer``.

The biased decode (``_seaco_decode_with_asf``, ``model.py:64-125``): the main decoder's
hidden state, its log-probs through ``output_layer`` (the JAX package runs the decoder a
second time for the logits; the numbers are the same); with more hotwords than
``nfilter`` (default 50), attention-score filtering: the probe's attention of the first
row, summed over heads and all K query rows (padded token slots included), ranked with
numpy on the host so that ties break as in the JAX package, the top ``min(nfilter,
N - 1)`` of all N kept and the no-bias entry appended (it may then appear twice); the
SeACo decoder over the CIF embeddings and over the decoder hidden, summed and projected;
then the NO_BIAS gate: where the hotword head's argmax is ``NO_BIAS`` the main log-probs
stand, elsewhere the hotword head's (``seaco_weight`` from the call, default 1.0; the
model's 0.01 attribute is unused in inference, as in the JAX package).

It keeps Paraformer's dispatch / fetch pair: ``decode_context`` turns the call's
``hotword`` ("w1 w2 ..." or a list) into token-id lists once per call, plus the no-bias
sentinel ``[sos]``; ``cal_decoder_with_predictor`` runs the biased decode; the timestamps
come from the upsample head as in BiCif (none with a V2 predictor, as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, encode_hotwords
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.bicif_paraformer.model import BiCifParaformer
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.register import tables


@tables.register("model_classes", "SeacoParaformer")
class SeacoParaformer(BiCifParaformer):
    def __init__(self, *args, inner_dim: int = 256, seaco_weight: float = 0.01,
                 NO_BIAS: int = 8377, seaco_decoder: Optional[str] = None,
                 seaco_decoder_conf: Optional[Dict] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        vocab_size = self.decoder.cfg.vocab_size
        self.inner_dim = inner_dim
        self.seaco_weight = seaco_weight
        self.NO_BIAS = NO_BIAS
        self.bias_encoder = nn.LSTM(inner_dim, inner_dim, 2, batch_first=True, device=device)
        self.seaco_decoder = None
        if seaco_decoder is not None:
            self.seaco_decoder = tables.decoder_classes[seaco_decoder](
                vocab_size=vocab_size, encoder_output_size=inner_dim, device=device,
                **(seaco_decoder_conf or {}))
        self.hotword_output_layer = nn.Linear(inner_dim, vocab_size, device=device)
        if generator is not None:
            init_weights(self, generator)

    # ------------------------------------------------------------------

    def _proc_hotword(self, hotword, tokenizer) -> Optional[List[List[int]]]:
        """"w1 w2" or a list -> token-id lists plus the no-bias sentinel ``[sos]``."""
        if not hotword:
            return None
        if isinstance(hotword, str):
            hotword = hotword.strip().split()
        return [tokenizer.encode(w) for w in hotword] + [[self.sos]]

    def decode_context(self, kwargs, tokenizer):
        hw_list = None if tokenizer is None else self._proc_hotword(kwargs.get("hotword"),
                                                                    tokenizer)
        if hw_list is None:
            return None
        return dict(hw_list=hw_list, nfilter=kwargs.get("nfilter", 50),
                    seaco_weight=kwargs.get("seaco_weight", 1.0))

    def cal_decoder_with_predictor(self, encoder_out, encoder_out_lens, sematic_embeds,
                                   ys_pad_lens, context=None):
        if context is None or self.seaco_decoder is None:
            return super().cal_decoder_with_predictor(encoder_out, encoder_out_lens,
                                                      sematic_embeds, ys_pad_lens)
        hidden, _ = self.decoder(encoder_out, encoder_out_lens, sematic_embeds, ys_pad_lens,
                                 return_hidden=True)
        decoder_pred = torch.log_softmax(
            apply_linear(self.decoder.output_layer, hidden).float(), dim=-1)
        return self._seaco_decode_with_asf(decoder_pred, hidden, sematic_embeds, ys_pad_lens,
                                           **context), ys_pad_lens

    def _seaco_decode_with_asf(self, decoder_pred, decoder_hidden, sematic_embeds,
                               ys_pad_lens, hw_list, nfilter: int = 50,
                               seaco_weight: float = 1.0):
        """The main decoder's fp32 log-probs merged with the hotword head's (B, K, vocab)."""
        selected = encode_hotwords(self.bias_encoder, self.decoder.embed[0].weight, hw_list)
        b, n = decoder_hidden.shape[0], selected.shape[0]
        lens = torch.full((b,), n, dtype=torch.int32, device=selected.device)
        if 0 < nfilter < n:
            attn = self.seaco_decoder.forward_asf(selected.expand(b, -1, -1), lens,
                                                  decoder_hidden, ys_pad_lens)
            scores = attn[0].sum(dim=(0, 1)).float().cpu().numpy()
            keep = list(np.argsort(-scores)[: min(nfilter, n - 1)]) + [n - 1]
            selected = selected[torch.as_tensor(keep, device=selected.device)]
            lens = torch.full_like(lens, len(keep))
        memory = selected.expand(b, -1, -1)
        cif_attended, _ = self.seaco_decoder(memory, lens, sematic_embeds, ys_pad_lens,
                                             return_hidden=True)
        dec_attended, _ = self.seaco_decoder(memory, lens, decoder_hidden, ys_pad_lens,
                                             return_hidden=True)
        dha_pred = torch.log_softmax(apply_linear(self.hotword_output_layer,
                                                  cif_attended + dec_attended).float(), dim=-1)
        return self.no_bias_gate(decoder_pred, dha_pred, seaco_weight)

    def no_bias_gate(self, decoder_pred, dha_pred, lmbd: float):
        """The main decoder's log-probs where the hotword head's argmax is NO_BIAS, the
        hotword head's elsewhere (at ``lmbd`` = 1; ``model.py:121-125``)."""
        dha_mask = (dha_pred.argmax(dim=-1) == self.NO_BIAS).float()[..., None]
        dha_mask = (dha_mask + (1 - lmbd) / lmbd) / (1 / lmbd)
        return decoder_pred * dha_mask + dha_pred * (1 - dha_mask)

    # ------------------------------------------------------------------

    def wants_timestamps(self, kwargs) -> bool:
        return hasattr(self.predictor, "get_upsample_timestamp")

    def decode_outputs(self, sp, ln, max_tokens: int, timestamps: bool = True, context=None):
        if timestamps:
            return super().decode_outputs(sp, ln, max_tokens, timestamps, context)
        return Paraformer.decode_outputs(self, sp, ln, max_tokens, timestamps, context)

    def transcript(self, token, tokenizer, enc_len: int, ts, kwargs) -> dict:
        if ts is None:
            return Paraformer.transcript(self, token, tokenizer, enc_len, ts, kwargs)
        return super().transcript(token, tokenizer, enc_len, ts, kwargs)
