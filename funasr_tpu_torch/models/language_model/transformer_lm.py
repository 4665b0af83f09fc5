"""Language models for shallow fusion in beam search, in PyTorch (counterpart of
``funasr_tpu/models/language_model/transformer_lm.py``; FunASR
``funasr/models/language_model/transformer_lm.py:14`` and ``seq_rnn_lm.py:11``).

Both expose ``score_step(ys, ys_len)`` -> (N, V) fp32 next-token log-probs at each
prefix's last valid position, the scorer ``models/transformer/search.py::beam_search``
fuses at ``lm_weight``, and ``forward(text, text_lengths)``, the next-token CE of LM
training -> (loss, stats, weight).

``TransformerLM``: token embedding -> ``input_proj`` -> espnet PE -> causal pre-norm
Transformer blocks -> after-norm -> ``decoder`` head. ``SeqRNNLM``: embedding -> an LSTM
stack -> head, each LSTM layer run in ``core/layers.py::lstm_apply``'s order (the JAX
package's gate order (i, f, g, o), both biases added to the input product), not through
``nn.LSTM``'s kernel; ``rnn`` only holds FunASR's parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from funasr_tpu_torch.core.layers import (LayerNorm, apply_linear, embedding, lstm_apply)
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.transformer.attention import add_espnet_pe
from funasr_tpu_torch.models.transformer.decoder import causal_pad_mask, last_log_probs
from funasr_tpu_torch.models.transformer.encoder import EncoderLayer, TransformerEncoderConfig
from funasr_tpu_torch.register import tables


def _lm_loss(logits, text, text_lengths):
    """Next-token CE over text[:, 1:] (``forward_jit``) -> (loss, stats, token count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ys_out = text[:, 1:]
    valid = (torch.arange(ys_out.shape[1], device=text.device)[None]
             < (text_lengths - 1)[:, None])
    tgt = torch.where(valid, ys_out, 0).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0] * valid
    ntok = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / ntok
    return loss, {"loss": loss, "ppl": torch.exp(loss)}, ntok


@tables.register("model_classes", "TransformerLM")
class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int, embed_unit: int = 128, att_unit: int = 256,
                 head: int = 2, unit: int = 1024, layer: int = 4, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        self.vocab_size = vocab_size
        self.cfg = TransformerEncoderConfig(embed_unit, att_unit, head, unit, layer,
                                            input_layer="linear")
        self.embed = nn.Embedding(vocab_size, embed_unit, device=device)
        self.input_proj = nn.Linear(embed_unit, att_unit, device=device)
        self.encoders = nn.ModuleList(EncoderLayer(self.cfg, device=device)
                                      for _ in range(layer))
        self.after_norm = LayerNorm(att_unit, device=device)
        self.decoder = nn.Linear(att_unit, vocab_size, device=device)
        if generator is not None:
            init_weights(self, generator)

    def run(self, ys, ys_len):
        """(N, L) ids -> (N, L, V) logits under the causal + padding mask."""
        x = add_espnet_pe(apply_linear(self.input_proj, embedding(ys, self.embed.weight)))
        mask = causal_pad_mask(ys_len, ys.shape[1])
        for layer in self.encoders:
            x = layer(x, mask)
        return apply_linear(self.decoder, self.after_norm(x))

    def forward(self, text, text_lengths, generator=None):
        return _lm_loss(self.run(text[:, :-1], text_lengths - 1), text, text_lengths)

    def score_step(self, ys, ys_len, *unused):
        return last_log_probs(self.run(ys, ys_len), ys_len)


@tables.register("model_classes", "SeqRNNLM")
class SeqRNNLM(nn.Module):
    def __init__(self, vocab_size: int, embed_unit: int = 256, hidden_size: int = 512,
                 num_layers: int = 2, device=None, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = nn.Embedding(vocab_size, embed_unit, device=device)
        self.rnn = nn.LSTM(embed_unit, hidden_size, num_layers, batch_first=True,
                           device=device)
        self.decoder = nn.Linear(hidden_size, vocab_size, device=device)
        if generator is not None:
            init_weights(self, generator)

    def run(self, ys):
        return apply_linear(self.decoder, lstm_apply(self.rnn, embedding(ys, self.encoder.weight)))

    def forward(self, text, text_lengths, generator=None):
        return _lm_loss(self.run(text[:, :-1]), text, text_lengths)

    def score_step(self, ys, ys_len, *unused):
        return last_log_probs(self.run(ys), ys_len)
