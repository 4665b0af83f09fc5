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

The overlap-chunk masks of a padded length are built once, here, for every model that
trains or decodes through ``forward_train_chunk`` (``chunk_masks``; ParaformerStreaming
pads every config's masks to their common shape as its JAX trainer does, SCAMA and UniASR
take one config's as ``OverlapChunk.gen_chunk_mask`` gives them), and
``chunk_lengths`` gives the chunked lengths of JAX's formula.

Training (``forward_train_chunk``, JAX ``:126-160`` and ``_layer_apply_masked`` ``:27-44``):
x sqrt(d) plus PE, then the overlap-chunk split (``chunk_utils.split_chunk``), every
layer with the FSMN branch under the frame mask (pad and FSMN shift rows out) and its
self-attention on the flash kernels' chunk mode (own chunk plus the look-back,
``ops/flash_attention.py::chunk_mask``), after_norm, the pad mask. No dropout: the JAX
chunk path takes no key (its offline ``forward_jit`` does).
"""

from __future__ import annotations

import numpy as np
import torch

from funasr_tpu_torch.core.layers import add_sinusoidal_pe, make_pad_mask, sinusoidal_pe
from funasr_tpu_torch.models.scama.chunk_utils import OverlapChunk, device_tables, split_chunk
from funasr_tpu_torch.models.sanm.encoder import SANMEncoder
from funasr_tpu_torch.register import tables


def _padto(a, shape):
    out = np.zeros(shape, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


@tables.register("encoder_classes", "SANMEncoderChunkOpt")
class SANMEncoderChunkOpt(SANMEncoder):
    CHUNK_MASKS_KEPT = 64  # (length, config, device, stacked) keys whose masks stay built

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
        self._chunk_masks = {}

    def stacked_chunk_masks(self, l_max: int):
        """Every config's masks at ``l_max`` (``OverlapChunk.gen_chunk_mask``), padded to
        their common shape (``ParaformerStreaming._stacked_chunk_masks``, ``:76-113``):
        {key: [one per config]} (numpy; the attention mask left out, the kernels compute
        it) and the common pad_left."""
        oc = self.overlap_chunk_cls
        if len(set(oc.pad_left)) != 1:
            raise ValueError("mixed pad_left is unsupported")
        per_cfg = [oc.gen_chunk_mask(np.asarray([l_max]), ind)
                   for ind in range(len(oc.chunk_size))]
        lc = max(m["x_add_mask"].shape[0] for m in per_cfg)
        tp = max(m["x_add_mask"].shape[1] for m in per_cfg)
        shapes = {"x_add_mask": (lc, tp), "x_rm_mask": (l_max, lc), "mask_shfit_chunk": (lc,),
                  "mask_chunk_predictor": (lc,)}
        return ({k: [_padto(m[k], shape) for m in per_cfg] for k, shape in shapes.items()},
                oc.pad_left[0])

    def chunk_masks(self, l_max: int, ind: int, device, stacked: bool = False):
        """Config ``ind``'s masks at the padded length ``l_max`` on ``device``, as
        ``forward_train_chunk`` and the models take them (the attention mask stays on the
        host: the kernels compute it): {"tables", "mask_shfit_chunk",
        "mask_chunk_predictor" (Tc,) bool, "pad_left", "chunk", "stride", "shift"}.
        ``stacked``: padded to every config's common shape (``stacked_chunk_masks``),
        else config ``ind``'s own (``gen_chunk_mask``). Kept for the CHUNK_MASKS_KEPT keys
        used last."""
        key = (l_max, ind, str(device), stacked)
        if key not in self._chunk_masks:
            if len(self._chunk_masks) >= self.CHUNK_MASKS_KEPT:
                del self._chunk_masks[next(iter(self._chunk_masks))]
            oc = self.overlap_chunk_cls
            if stacked:
                masks, pad_left = self.stacked_chunk_masks(l_max)
                masks = {k: v[ind] for k, v in masks.items()}
            else:
                masks = oc.gen_chunk_mask(np.asarray([l_max]), ind)
                pad_left = masks["pad_left"]
            chunk = oc.attention_chunk(ind)
            self._chunk_masks[key] = {
                "tables": device_tables(masks["x_add_mask"], masks["x_rm_mask"], device),
                "mask_shfit_chunk": torch.from_numpy(masks["mask_shfit_chunk"] > 0).to(device),
                "mask_chunk_predictor": torch.from_numpy(
                    masks["mask_chunk_predictor"] > 0).to(device),
                "pad_left": pad_left, "chunk": chunk, "shift": chunk[0],
                "stride": oc.stride[ind]}
        self._chunk_masks[key] = self._chunk_masks.pop(key)  # the most recent last
        return self._chunk_masks[key]

    def chunk_lengths(self, lengths, masks):
        """(B,) lengths -> their chunked lengths (B,) int32 under ``masks``' config
        (``gen_chunk_mask``'s ``x_len_chunk``)."""
        stride, shift = masks["stride"], masks["shift"]
        n = (lengths + stride - 1) // stride
        return ((n - 1) * shift + self.overlap_chunk_cls.shfit_fsmn + masks["pad_left"]
                + lengths - (n - 1) * stride).to(torch.int32)

    def forward_train_chunk(self, xs_pad, ilens, masks):
        """The training forward under overlap-chunk masks: (B, T, input_size) features
        and lengths -> (chunked output (B, Tc, out), chunked lengths (B,)). ``masks``
        (``chunk_masks``): "tables" (``chunk_utils.device_tables``),
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
