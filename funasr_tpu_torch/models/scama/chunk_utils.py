"""Overlap-chunk training masks for streaming SAN-M in PyTorch (counterpart of
``funasr_tpu/models/scama/chunk_utils.py``; FunASR ``funasr/models/scama/
chunk_utilis.py:10``, ``overlap_chunk``; SCAMA, arXiv 2006.01713).

The training forward of a streaming encoder splits the sequence into overlapping chunks
(duplicating context frames) and restricts attention to the own chunk plus a bounded
look-back, so training sees the receptive field streaming inference has.

Layout (shift = chunk_size + shfit_fsmn): chunk ``c`` owns chunked rows
``[c*shift, (c+1)*shift)``; its first ``shfit_fsmn`` rows are zero padding for the FSMN
memory conv, then ``chunk_size`` frame rows cover source positions
``[c*stride - pad_left, c*stride - pad_left + chunk_size)`` of the original sequence.

``OverlapChunk.gen_chunk_mask`` is the JAX package's numpy code as it is (the masks and
the chunked lengths equal its own). ``split_chunk`` / ``remove_chunk`` take the JAX
package's 0/1 split and un-split matrices and move rows by index instead of by their
einsums: each chunked row comes from one source row and each source row goes back from
one chunked row, so a gather is the same product, exact whatever the float32 matmul
precision. The gradient of ``split_chunk`` sends up to ceil(chunk / stride) chunked rows'
gradients to one source row: it adds them slot by slot in a fixed order (``RowGather``),
not with ``index_add_``, whose CUDA atomics add in an order that changes from run to run.

The attention mask ``mask_att_chunk_encoder`` is built here for the tests only: the
encoder's attention takes the same predicate as the flash kernel's chunk mode
(``ops/flash_attention.py::chunk_mask``), computed from row and key indices, and no
(Tc, Tc) mask reaches the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


class OverlapChunk:
    def __init__(self, chunk_size=(16,), stride=(10,), pad_left=(0,),
                 encoder_att_look_back_factor=(1,), shfit_fsmn: int = 0,
                 decoder_att_look_back_factor=(1,)):
        def ext(x):
            x = tuple(x)
            return x if len(x) >= len(chunk_size) else tuple(
                x[0] for _ in chunk_size)

        self.chunk_size = tuple(chunk_size)
        self.stride = ext(stride)
        self.pad_left = ext(pad_left)
        self.enc_look_back = ext(encoder_att_look_back_factor)
        self.dec_look_back = ext(decoder_att_look_back_factor)
        self.shfit_fsmn = shfit_fsmn

    def attention_chunk(self, ind: int) -> Tuple[int, int, int, int]:
        """Config ``ind``'s attention predicate as the flash kernel's chunk mode takes it:
        (shift, shfit_fsmn, stride, look-back)."""
        return (self.chunk_size[ind] + self.shfit_fsmn, self.shfit_fsmn, self.stride[ind],
                int(self.enc_look_back[ind]))

    def gen_chunk_mask(self, x_len: np.ndarray, ind: int = 0):
        """x_len: (B,) -> dict of masks + chunked lengths (all numpy)."""
        x_len = np.asarray(x_len)
        c_sz, s_sz = self.chunk_size[ind], self.stride[ind]
        p_left = self.pad_left[ind]
        lb = self.enc_look_back[ind]
        s_fsmn = self.shfit_fsmn
        shift = c_sz + s_fsmn

        l_max = int(x_len.max())
        n_chunks_row = np.ceil(x_len / s_sz).astype(np.int64)
        x_len_chunk = ((n_chunks_row - 1) * shift + s_fsmn + p_left + x_len
                       - (n_chunks_row - 1) * s_sz).astype(x_len.dtype)
        n = int(math.ceil(l_max / s_sz))
        lc_max = int(x_len_chunk.max())
        l_pad = max(c_sz, l_max + p_left)

        rows = np.arange(n * shift)
        chunk_of = rows // shift
        j = rows % shift - s_fsmn          # frame index within chunk, <0 = fsmn pad
        is_frame = j >= 0

        # split matrix: chunked row r <- left-padded source col chunk*stride + j
        src = chunk_of * s_sz + np.maximum(j, 0)
        x_add = np.zeros((n * shift, l_pad), np.float32)
        ok = is_frame & (src < l_pad)
        x_add[rows[ok], src[ok]] = 1.0

        # un-split matrix: original pos p = c*stride + i <- chunked row of the
        # stride region (j in [pad_left, pad_left+stride))
        x_rm = np.zeros((l_pad, n * shift), np.float32)
        in_stride = is_frame & (j >= p_left) & (j < p_left + s_sz)
        orig = chunk_of * s_sz + (j - p_left)
        ok = in_stride & (orig < l_pad)
        x_rm[orig[ok], rows[ok]] = 1.0

        # attention: query r1 (frame row) may attend key r2 when same chunk
        # (any frame row) or a look-back chunk's stride-start rows (j < stride
        # on BOTH sides — reference mask_att_chunk_encoder block layout)
        same = chunk_of[:, None] == chunk_of[None, :]
        back = (chunk_of[None, :] < chunk_of[:, None]) & \
               (chunk_of[None, :] >= chunk_of[:, None] - lb) & \
               (j[:, None] < s_sz) & (j[None, :] < s_sz)
        att = (is_frame[:, None] & is_frame[None, :] & (same | back))

        masks = {
            "x_add_mask": x_add[:lc_max, : l_max + p_left],
            "x_rm_mask": x_rm[:l_max, :lc_max],
            "x_len_chunk": x_len_chunk,
            "mask_shfit_chunk": is_frame[:lc_max].astype(np.float32),
            "mask_chunk_predictor": in_stride[:lc_max].astype(np.float32),
            "mask_att_chunk_encoder": att[:lc_max, :lc_max],
            "pad_left": p_left,
        }
        return masks


def gather_tables(add, rm):
    """The 0/1 split matrix (Tc, Tp) and un-split matrix (T, Tc) as row indices (numpy):
    split (Tc,) the source row of each chunked row (Tp, a zero row, where it has none);
    slots (Tp, S) the chunked rows each source row went to, in order (Tc where a slot is
    empty), S the most any source row has; remove (T,) the chunked row of each original
    row (Tc where it has none)."""
    tc, tp = add.shape
    has = add.any(axis=1)
    split = np.where(has, add.argmax(axis=1), tp).astype(np.int64)
    counts = np.bincount(split[has], minlength=tp)
    slots = np.full((tp, max(int(counts.max(initial=0)), 1)), tc, np.int64)
    filled = np.zeros(tp, np.int64)
    for r in np.flatnonzero(has):  # rows in order: each source row's slots ascend
        slots[split[r], filled[split[r]]] = r
        filled[split[r]] += 1
    rm = rm[:, :tc]
    remove = np.where(rm.any(axis=1), rm.argmax(axis=1), tc).astype(np.int64)
    return split, slots, remove


class RowGather(torch.autograd.Function):
    """out[:, i] = x[:, index[i]] over x (B, N, D) with a zero row appended at N; the
    gradient of x[:, n] is the sum of the output rows ``slots[n]`` names (N' = out's row
    count names the zero row), slot by slot: a fixed order, so two runs give bit-equal
    gradients."""

    @staticmethod
    def forward(ctx, x, index, slots):
        ctx.save_for_backward(slots)
        ctx.n_out = index.shape[0]
        ext = torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], dim=1)
        return ext.index_select(1, index)

    @staticmethod
    def backward(ctx, grad):
        (slots,) = ctx.saved_tensors
        b, _, d = grad.shape
        ext = torch.cat([grad, grad.new_zeros(b, 1, d)], dim=1)
        parts = ext.index_select(1, slots.reshape(-1)).view(b, *slots.shape, d)
        out = parts[:, :, 0]
        for s in range(1, slots.shape[1]):
            out = out + parts[:, :, s]
        return out, None, None


def _inverse_slots(index, n_src: int):
    """(N,) -> (n_src, 1): the output row that reads each source row (a one-to-one
    gather such as ``remove``), len(index) where none does."""
    inv = torch.full((n_src, 1), index.shape[0], dtype=torch.int64, device=index.device)
    ok = index < n_src
    inv[index[ok], 0] = torch.arange(index.shape[0], device=index.device)[ok]
    return inv


def split_chunk(x, x_len, tables, pad_left: int = 0):
    """(B, T, D) -> (B, Tc, D) chunked copy (``OverlapChunk.split_chunk``): rows past
    ``x_len`` zeroed, ``pad_left`` zero rows in front, then each chunked row taken from
    its source row. ``tables``: {"split", "slots"} as ``gather_tables`` gives them, as
    int64 tensors on x's device."""
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < x_len[:, None]
    x = x * valid[..., None].to(x.dtype)
    need = tables["slots"].shape[0]
    x = torch.nn.functional.pad(x, (0, 0, pad_left, 0))
    if x.shape[1] < need:
        x = torch.nn.functional.pad(x, (0, 0, 0, need - x.shape[1]))
    return RowGather.apply(x[:, :need], tables["split"], tables["slots"])


def remove_chunk(x_chunk, x_len_chunk, tables):
    """(B, Tc, D) -> (B, T, D) original layout (``OverlapChunk.remove_chunk``): rows past
    ``x_len_chunk`` zeroed, then each original row taken from the chunked row of its
    stride region. ``tables``: {"remove", "remove_slots"} (``gather_tables``'s remove and
    its inverse, ``_inverse_slots``)."""
    valid = (torch.arange(x_chunk.shape[1], device=x_chunk.device)[None, :]
             < x_len_chunk[:, None])
    x_chunk = x_chunk * valid[..., None].to(x_chunk.dtype)
    return RowGather.apply(x_chunk, tables["remove"], tables["remove_slots"])


def device_tables(add, rm, device):
    """``gather_tables`` of the split / un-split matrices as tensors on ``device``, the
    un-split's inverse included: the tables ``split_chunk`` and ``remove_chunk`` take."""
    split, slots, remove = (torch.from_numpy(a).to(device) for a in gather_tables(add, rm))
    return {"split": split, "slots": slots, "remove": remove,
            "remove_slots": _inverse_slots(remove, add.shape[0])}
