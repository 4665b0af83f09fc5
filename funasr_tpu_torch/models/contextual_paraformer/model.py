"""ContextualParaformer in PyTorch: CLAS-style hotword biasing (counterpart of
``funasr_tpu/models/contextual_paraformer/model.py``; FunASR
``funasr/models/contextual_paraformer/model.py:45`` and ``decoder.py``, the
``paraformer-zh-hotword`` model).

``ContextualParaformerDecoder`` keeps FunASR's state-dict layout, so that a hub
``model.pt`` loads: ``decoders.0`` ... ``decoders.{att_layer_num - 2}`` and
``last_decoder``, ``bias_decoder.{norm3, src_attn}`` (a cross-attention over the hotword
memory) and ``bias_output`` (``Conv1d(2d, d, 1, bias=False)``). With a hotword memory the
last attention layer exposes its FSMN ("self-attention") branch; the bias attention reads
it and ``bias_output`` merges ``[src_attn || clas_scale * bias]`` back before the tail
layers. Without one the decoder is Paraformer's.

``ContextualParaformer`` embeds each hotword with ``bias_embed`` (or the decoder's embed
under ``use_decoder_embedding``), runs the 1-layer LSTM ``bias_encoder`` in fp32
(``core/layers.py::lstm_apply``) and keeps its last valid step. It keeps Paraformer's
dispatch / fetch pair through ``decode_context`` and ``cal_decoder_with_predictor``; the
memory is expanded to the padded bucket batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, conv1d, encode_hotwords, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.paraformer.decoder import ParaformerSANMDecoder
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.models.sanm.attention import MultiHeadedAttentionCrossAtt
from funasr_tpu_torch.register import tables


class ContextualBiasDecoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.norm3 = LayerNorm(cfg.dim, device=device)
        self.src_attn = MultiHeadedAttentionCrossAtt(cfg.cross_cfg, device=device)


@tables.register("decoder_classes", "ContextualParaformerDecoder")
class ContextualParaformerDecoder(ParaformerSANMDecoder):
    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        cfg = self.cfg
        self.last_decoder = self.decoders[-1]
        del self.decoders[-1]
        self.bias_decoder = ContextualBiasDecoder(cfg, device)
        self.bias_output = nn.Conv1d(cfg.dim * 2, cfg.dim, 1, bias=False, device=device)

    def forward(self, hs_pad, hlens, ys_in_pad, ys_in_lens, contextual_info=None,
                clas_scale: float = 1.0, return_hidden: bool = False):
        """``contextual_info``: (B, N, d) hotword memory, or None (Paraformer's decoder)."""
        tgt_mask = make_pad_mask(ys_in_lens, ys_in_pad.shape[1])
        memory_mask = make_pad_mask(hlens, hs_pad.shape[1])
        x = ys_in_pad
        for layer in self.decoders:
            x = layer(x, tgt_mask, hs_pad, memory_mask)
        last = self.last_decoder
        if contextual_info is None:
            x = last(x, tgt_mask, hs_pad, memory_mask)
        else:
            h = last.feed_forward(last.norm1(x))
            x_self_attn = x + last.self_attn(last.norm2(h), tgt_mask)
            x_src_attn = last.src_attn(last.norm3(x_self_attn), hs_pad, memory_mask)
            bias = self.bias_decoder
            cx = bias.src_attn(bias.norm3(x_self_attn), contextual_info, None)
            merged = conv1d(torch.cat([x_src_attn, cx * clas_scale], dim=-1),
                            self.bias_output.weight)
            x = x_self_attn + merged
        return self.forward_tail(x, tgt_mask, ys_in_lens, return_hidden)


@tables.register("model_classes", "ContextualParaformer")
class ContextualParaformer(Paraformer):
    def __init__(self, *args, decoder: str = "ContextualParaformerDecoder", inner_dim: int = 256,
                 use_decoder_embedding: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(*args, decoder=decoder, device=device, **kwargs)
        self.inner_dim = inner_dim
        self.use_decoder_embedding = use_decoder_embedding
        self.bias_embed = nn.Embedding(self.decoder.cfg.vocab_size, inner_dim, device=device)
        self.bias_encoder = nn.LSTM(inner_dim, inner_dim, 1, batch_first=True, device=device)
        if generator is not None:
            init_weights(self, generator)

    def decode_context(self, kwargs, tokenizer):
        hotword = kwargs.get("hotword")
        if not hotword or tokenizer is None:
            return None
        words = hotword.split() if isinstance(hotword, str) else list(hotword)
        return dict(hw_lists=[tokenizer.encode(w) for w in words] + [[self.sos]],
                    clas_scale=kwargs.get("clas_scale", 1.0))

    def cal_decoder_with_predictor(self, encoder_out, encoder_out_lens, sematic_embeds,
                                   ys_pad_lens, context=None):
        info = None
        if context is not None:
            table = (self.decoder.embed[0] if self.use_decoder_embedding
                     else self.bias_embed).weight
            info = encode_hotwords(self.bias_encoder, table, context["hw_lists"]).expand(
                encoder_out.shape[0], -1, -1)
        logits, olens = self.decoder(encoder_out, encoder_out_lens, sematic_embeds, ys_pad_lens,
                                     contextual_info=info,
                                     clas_scale=1.0 if context is None else context["clas_scale"])
        return torch.log_softmax(logits.float(), dim=-1), olens
