"""SANMEncoderChunkOpt in PyTorch: the chunked streaming SAN-M encoder (counterpart of
``funasr_tpu/models/scama/encoder.py``; SCAMA, arXiv 2006.01712).

FunASR's ``funasr/models/scama/encoder.py`` (``forward_chunk:496-548``). The offline
``forward`` is ``SANMEncoder``'s: the streaming checkpoints share its weights, and the
config's ``input_layer: pe_online`` means plain PE there (JAX ``:108-111``). A chunk:

* features x sqrt(d) plus the sinusoidal PE from the absolute position
  ``start_idx + 1`` (``_encoder_chunk_jit``);
* the overlap carry: the last ``chunk_size[0] + chunk_size[2]`` PE'd rows of
  [carry | chunk] lead the next chunk (5 look-ahead rows at ``[0, 10, 5]``, so a
  600 ms chunk runs 15 rows);
* every layer's self-attention over [cached K/V | chunk] (``sanm_attention_apply_chunk``,
  the flash kernel with Tq < Tk), its cache trimmed to ``look_back * chunk_size[1]``
  keys (-1: unbounded; 0: no cache);
* the tail chunk (the final call's audio under 960 samples) re-runs the carried rows.

The caches are a list with one {"k", "v"} per layer (None until the first chunk with a
look-back); the JAX package keeps the first layer's apart and stacks the rest. The
training forward with overlap-chunk masks (``forward_train_chunk``, ``OverlapChunk``)
belongs to the training slice.
"""

from __future__ import annotations

import torch

from funasr_tpu_torch.core.layers import sinusoidal_pe
from funasr_tpu_torch.models.sanm.encoder import SANMEncoder
from funasr_tpu_torch.register import tables


@tables.register("encoder_classes", "SANMEncoderChunkOpt")
class SANMEncoderChunkOpt(SANMEncoder):
    def __init__(self, *args, **kwargs):
        """Hub configs' training chunk keys (``chunk_size``, ``stride``, ``pad_left``, the
        look-back factors) are accepted and unused: inference takes its chunking from the
        cache."""
        kwargs["input_layer"] = "pe"  # offline forward: plain PE; chunks: their own
        super().__init__(*args, **kwargs)

    def forward_chunk(self, xs_pad, cache):
        """One streaming chunk. ``cache`` (``ParaformerStreaming.init_cache``): start_idx,
        feats (the carried rows), chunk_size [pad_left, stride, look-ahead],
        encoder_chunk_look_back, opt (the per-layer K/V caches), tail_chunk.
        xs_pad: (1, T, input_size) features in the model's dtype (ignored for a tail
        chunk) -> (1, T', output_size)."""
        look_back = cache.get("encoder_chunk_look_back", 0)
        if cache.get("opt") is None:
            cache["opt"] = [None] * self.cfg.num_blocks
        start = cache["start_idx"]
        cache["start_idx"] = start + xs_pad.shape[1]
        y, carry, opt = self.chunk_step(xs_pad, start, cache["feats"], cache["opt"],
                                        tuple(cache["chunk_size"]), look_back,
                                        bool(cache.get("tail_chunk")))
        cache["feats"] = carry
        if look_back > 0 or look_back == -1:
            cache["opt"] = opt
        return y

    def chunk_step(self, x, start: int, carry, opt, chunk_size, look_back: int, tail: bool):
        """``_encoder_chunk_jit``: -> (output, new carry, new caches)."""
        cfg = self.cfg
        if tail:  # the final sub-stride chunk re-runs the carried (already PE'd) rows
            x, new_carry = carry, carry
        else:
            x = x * (cfg.output_size ** 0.5)
            pos = torch.arange(start + 1, start + 1 + x.shape[1], dtype=torch.float32,
                               device=x.device)
            x = x + sinusoidal_pe(pos, x.shape[2], x.dtype)[None]
            x = torch.cat([carry, x], dim=1)
            new_carry = x[:, x.shape[1] - (chunk_size[0] + chunk_size[2]):]
        cached = 0
        if (look_back > 0 or look_back == -1) and opt[0] is not None:
            cached = opt[0]["k"].shape[2]
        lengths = torch.full((x.shape[0],), cached + x.shape[1], dtype=torch.int32,
                             device=x.device)  # every layer attends over Tk keys
        new_opt = []
        for layer, kv in zip((*self.encoders0, *self.encoders), opt):
            x, kv = layer.forward_chunk(x, kv, lengths, chunk_size, look_back)
            new_opt.append(kv)
        if cfg.normalize_before:
            x = self.after_norm(x)
        return x, new_carry, new_opt
