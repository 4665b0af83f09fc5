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
look-back); the JAX package keeps the first layer's apart and stacks the rest.

Training (``forward_train_chunk``, JAX ``:126-160`` and ``_layer_apply_masked`` ``:27-44``):
x sqrt(d) plus PE, then the overlap-chunk split (``chunk_utils.split_chunk``), every
layer with the FSMN branch under the frame mask (pad and FSMN shift rows out) and its
self-attention on the flash kernels' chunk mode (own chunk plus the look-back,
``ops/flash_attention.py::chunk_mask``), after_norm, the pad mask. No dropout: the JAX
chunk path takes no key (its offline ``forward_jit`` does).
"""

from __future__ import annotations

import torch

from funasr_tpu_torch.core.layers import add_sinusoidal_pe, make_pad_mask, sinusoidal_pe
from funasr_tpu_torch.models.scama.chunk_utils import OverlapChunk, split_chunk
from funasr_tpu_torch.models.sanm.encoder import SANMEncoder
from funasr_tpu_torch.register import tables


@tables.register("encoder_classes", "SANMEncoderChunkOpt")
class SANMEncoderChunkOpt(SANMEncoder):
    def __init__(self, *args, chunk_size=(16,), stride=(10,), pad_left=(0,),
                 encoder_att_look_back_factor=(1,), decoder_att_look_back_factor=(1,),
                 **kwargs):
        """The training chunk keys (``chunk_size``, ``stride``, ``pad_left``, the look-back
        factors; one entry per config) make ``overlap_chunk_cls``, which only training
        reads: inference takes its chunking from the cache."""
        kwargs["input_layer"] = "pe"  # offline forward: plain PE; chunks: their own
        super().__init__(*args, **kwargs)
        # FSMN shift rows per chunk = the conv's left context (scama/encoder.py:377)
        self.overlap_chunk_cls = OverlapChunk(
            chunk_size=tuple(chunk_size), stride=tuple(stride), pad_left=tuple(pad_left),
            encoder_att_look_back_factor=tuple(encoder_att_look_back_factor),
            shfit_fsmn=(self.cfg.kernel_size - 1) // 2,
            decoder_att_look_back_factor=tuple(decoder_att_look_back_factor))

    def forward_train_chunk(self, xs_pad, ilens, masks):
        """The training forward under overlap-chunk masks: (B, T, input_size) features
        and lengths -> (chunked output (B, Tc, out), chunked lengths (B,)). ``masks``
        (``ParaformerStreaming.chunk_masks``): "tables" (``chunk_utils.device_tables``),
        "x_len_chunk" (B,), "mask_shfit_chunk" (Tc,) bool, "pad_left", and "chunk" (the
        flash kernels' chunk-mode integers)."""
        cfg = self.cfg
        x = add_sinusoidal_pe(xs_pad * (cfg.output_size ** 0.5))
        x_chunk = split_chunk(x, ilens, masks["tables"], masks["pad_left"])
        lens_chunk = masks["x_len_chunk"]
        pad_ok = make_pad_mask(lens_chunk, x_chunk.shape[1])
        frame_mask = pad_ok & masks["mask_shfit_chunk"][None]
        for layer in (*self.encoders0, *self.encoders):
            x_chunk = layer(x_chunk, frame_mask, lens_chunk, "chunk", chunk=masks["chunk"])
        if cfg.normalize_before:
            x_chunk = self.after_norm(x_chunk)
        return x_chunk * pad_ok[..., None].to(x_chunk.dtype), lens_chunk

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
