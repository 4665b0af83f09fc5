"""SCAMA decoder-attention alignments in PyTorch (counterpart of
``funasr_tpu/models/scama/utils.py``; FunASR ``funasr/models/paraformer/cif_predictor.py:
144`` ``gen_frame_alignments`` and ``funasr/models/scama/chunk_utilis.py:482``
``build_scama_mask_for_cross_attention_decoder``).

Integer and mask arithmetic over static shapes, the JAX functions' operations one for
one, run as torch on the model's device: no host loop and no host read. Both are equal to
the JAX functions wherever the fp32 sums of the alphas are (they are exact for alphas that
are multiples of a power of two; elsewhere the two frameworks may sum in another order,
``ROADMAP.md`` section "Numerics to copy").
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from funasr_tpu_torch.core.layers import make_pad_mask


def gen_frame_alignments(alphas, encoder_lengths, max_token_num: int,
                         training: bool = True):
    """CIF alphas (B, T) -> (per-frame emitted-token counts (B, T) int32, their sums (B,)).

    Frame t gets a 1 for each token whose integration completes at t; tokens past the
    alphas' rounded (training) or floored sum get none; frames past ``encoder_lengths``
    none."""
    b, t = alphas.shape
    dev = alphas.device
    total = alphas.sum(dim=1)
    token_num = (torch.round(total) if training else torch.floor(total)).to(torch.int32)
    cums = torch.floor(torch.cumsum(alphas, dim=1)).to(torch.int32)  # (B, T)
    index = torch.arange(1, max_token_num + 1, dtype=torch.int32, device=dev)  # (K,)
    # the first frame where the running count reaches k: the frames where it has not, + 1
    zeros = torch.div(cums[:, None, :], index[None, :, None], rounding_mode="floor") == 0
    first_fire = zeros.to(torch.int32).sum(dim=-1) + 1  # (B, K), 1-based
    max_len = encoder_lengths.max().to(torch.int32)
    first_fire = torch.minimum(first_fire.clamp(min=0), max_len)
    first_fire = first_fire * make_pad_mask(token_num, max_token_num).to(torch.int32)
    frame_idx = torch.arange(1, t + 1, dtype=torch.int32, device=dev)
    hits = first_fire[:, :, None] == frame_idx[None, None, :]  # (B, K, T)
    alignments = hits.to(torch.int32).sum(dim=1)
    alignments = alignments * make_pad_mask(encoder_lengths, t).to(torch.int32)
    return alignments, alignments.sum(dim=-1)


def build_scama_mask_for_cross_attention_decoder(
        predictor_alignments, encoder_sequence_length, max_target_length: int,
        chunk_size: int = 1, encoder_chunk_size: int = 5,
        attention_chunk_center_bias: int = 0,
        attention_chunk_size: Optional[int] = None,
        attention_chunk_type: str = "chunk",
        predictor_mask_chunk_hopping=None,
        decoder_att_look_back_factor: int = 1,
        mask_shift_att_chunk_decoder=None,
        target_length=None, is_training: bool = True):
    """Each target token's encoder attention window (B, max_target_length, T_enc) fp32:
    token k sees up to the end of the chunk in which it fired, with
    ``decoder_att_look_back_factor`` chunks of look-back; of earlier chunks only the rows
    ``predictor_mask_chunk_hopping`` keeps (the stride rows), never the FSMN shift rows
    ``mask_shift_att_chunk_decoder`` drops. ``predictor_mask_chunk_hopping`` /
    ``mask_shift_att_chunk_decoder``: (T',) or (B, T') float tensors."""
    b, t_enc = predictor_alignments.shape
    dev = predictor_alignments.device
    max_enc = t_enc
    if not is_training or target_length is None:
        target_length = predictor_alignments.sum(dim=-1)
    k_axis = torch.arange(1, max_target_length + 1, dtype=torch.int32, device=dev)
    cums = torch.cumsum(predictor_alignments, dim=1).to(torch.int32)  # (B, T)
    zeros = torch.div(cums[:, None, :], k_axis[None, :, None], rounding_mode="floor") == 0
    fire_pos = zeros.to(torch.int32).sum(dim=-1) + 1  # (B, K)
    fire_pos = fire_pos.clamp(1, t_enc)

    end = fire_pos * chunk_size + attention_chunk_center_bias
    end = (end - 1).clamp(0, max_enc)
    # rounded up to the chunk boundary
    end = (torch.div(end, encoder_chunk_size, rounding_mode="floor") + 1) * encoder_chunk_size
    max_len_chunk = int(math.ceil(max_enc / encoder_chunk_size) * encoder_chunk_size)
    cols = torch.arange(max_len_chunk, dtype=torch.int32, device=dev)

    mask = (cols[None, None, :] < end[:, :, None]).float()
    mask_flip = mask_flip2 = None
    if attention_chunk_size is not None:
        beg = (end - attention_chunk_size).clamp(0, max_len_chunk)
        mask_flip = (cols[None, None, :] >= beg[:, :, None]).float()
        beg2 = (end - attention_chunk_size * (decoder_att_look_back_factor + 1)).clamp(
            0, max_len_chunk)
        mask_flip2 = (cols[None, None, :] >= beg2[:, :, None]).float()

    if predictor_mask_chunk_hopping is not None:
        hop = predictor_mask_chunk_hopping.float()
        if hop.dim() == 1:
            hop = hop[None].expand(b, hop.shape[0])
        hop = torch.nn.functional.pad(hop, (0, max_len_chunk - hop.shape[1]))
        hop = hop[:, None, :].expand(b, max_target_length, max_len_chunk)
        mask_mask_flip = mask * mask_flip if mask_flip is not None else mask
        if max_len_chunk > chunk_size:
            # own-chunk rows always visible; earlier chunks only their stride rows
            mask_sliced = torch.nn.functional.pad(mask[:, :, encoder_chunk_size:],
                                                  (0, encoder_chunk_size))
            mask = mask_mask_flip + mask_sliced * hop
        else:
            mask = mask_mask_flip
    if mask_flip2 is not None:
        mask = mask * mask_flip2

    mask = mask.clamp(max=1.0)
    tgt_valid = make_pad_mask(target_length, max_target_length).float()
    mask = mask[:, :, :max_enc] * tgt_valid[:, :, None]
    enc_valid = make_pad_mask(encoder_sequence_length, max_enc).float()
    mask = mask * enc_valid[:, None, :]
    if attention_chunk_type == "full":
        mask = torch.ones_like(mask)
    if mask_shift_att_chunk_decoder is not None:
        shift = mask_shift_att_chunk_decoder.float()
        if shift.dim() == 1:
            shift = shift[None, None, :]
        elif shift.dim() == 2:
            shift = shift[:, None, :]
        mask = mask * shift[..., :max_enc]
    return mask
