"""Flash attention for the SAN-M encoder: a hand-written Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel ``funasr_tpu/ops/flash_attention.py::flash_attention``
(Pallas kernel ``_flash_kernel``): softmax(Q K^T / sqrt(D)) V with fp32 scores, an
online softmax and an fp32 accumulator; keys at or past ``lengths[b]`` score -1e30;
output in q's dtype. The CUDA source, ``funasr_tpu_torch/csrc/flash_attention.cu``,
notes what bounds it on the H100 (bytes at the path's T = 384, operations at the
long-form T = 1408) and what its design does about it: bf16 runs on ``wgmma`` with K/V
fed by TMA through a 2-stage ring from one producer warp, scores, softmax and the
accumulator in registers, key tiles past a row's length skipped. fp32 is the dtype of
the public default ``AutoModel`` (no ``bf16``, no ``quant``), 50 launches per decode; it
runs on the tensor cores with the 3xTF32 split (hi = tf32(a), lo = tf32(a - hi), each
product as lo*hi' + hi*lo' + hi*hi' on ``mma.sync``; plain TF32 would move results by
~1e-3), the accumulator in registers, Q in shared memory, K / V through a 2-stage
``cp.async`` ring, two blocks of 64 query rows per SM. At (1, 4, 1408) its 88 blocks of 64 rows leave 44 of
132 SMs idle: each warp holds 16 rows, so only a split over keys would fill them.

Shapes: queries (B, H, Tq, D) over keys and values (B, H, Tk, D), Tq <= Tk. Offline
Tq = Tk; the streaming encoder's chunk (``models/sanm/attention.py::
sanm_attention_apply_chunk``) attends 15 query rows over [cached K/V | chunk], Tk = 15 to
55 at look-back 4. Row r of batch b sees the keys below its limit (``key_limits``):
``lengths[b]`` (mode "none"), ``min(r + 1, lengths[b])`` ("causal") or, for "corner"
with ``vad_pos``, ``min(vp, lengths[b])`` on rows r <= vp - 2 and ``lengths[b]`` on the
rest; the streaming punctuation encoder (``models/ct_transformer_streaming/encoder.py``)
runs causal layers and a corner last layer. The kernel skips key tiles past a row
block's largest limit.

Chunk mode (``mode="chunk"``, ``chunk=(shift, s_fsmn, stride, look_back)``, fp32 only,
Tq = Tk) is the overlap-chunk attention of streaming training
(``funasr_tpu/models/scama/chunk_utils.py:90-97`` ANDed with the key pad mask,
``funasr_tpu/models/sanm/attention.py:121-133``): query row r is in chunk
c = r // shift at in-chunk index j = r % shift - s_fsmn; a row with j < 0 (an FSMN shift
row) sees nothing; any other row sees every frame row (j >= 0) of its own chunk and, when
j < stride, the rows with j < stride of the ``look_back`` chunks before it; keys at or past
``lengths[b]`` never. That is no per-row key limit (a look-back chunk's look-ahead rows and
every chunk's shift rows are holes), so the kernels compute the predicate from row and key
indices, and each block loads only the key tiles its chunks reach (the forward: from
(c_first - look_back) * shift to (c_last + 1) * shift; the backward's key blocks: the query
tiles of chunks c' ... c' + look_back). A fully masked row gives 0, and dq 0, as JAX's
``masked_softmax`` does; its (m, l) = (-1e30, 0) carries no probability mass into the
backward, which forms P only at live keys. ``chunk_mask`` is the predicate as a (B, Tq, Tk)
bool tensor, the plain version's mask.

Unlike the Pallas kernel it needs no T % block == 0: the ragged last tile is masked in
the kernel. A row of length 0 gets the uniform average of V over its Tk keys in both
versions (the Pallas kernel's behaviour); bucketing never builds one.

Dispatch: a CPU tensor takes ``flash_attention_ref``; a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` counts kernel launches. With grad mode on
and q, k or v requiring grad, the output comes from ``FlashAttentionFn``: on CUDA at fp32
its forward is the kernel's instantiation that also writes each row's softmax max and sum
(m, l; ``flash_attention_with_stats``), and its backward is ``flash_attention_bwd``, the
hand-written kernel of ``funasr_tpu_torch/csrc/flash_attention_bwd.cu``
(``flash_attention_bwd.launches`` counts its calls, three kernel launches each): every
product on the tensor cores in 3xTF32, S and dO V^T formed once, a small kernel for
Dr = rowsum(dO o O), one block of 256 threads per 32 keys (``flash_bwd_plan``: 120 at
the recipe's (5, 4, 190)) that walks the query tiles with dK and dV in registers and
writes its share of dQ to a scratch, and a last kernel that adds the shares in key-block
order; no float atomics, so gradients are bit-equal across runs. On the CPU the backward
is autograd through ``flash_attention_ref``; bf16 raises (ROADMAP item 20b). lengths and
vad_pos get no gradient. Under ``torch.export`` the wrapper records the custom op
``funasr_tpu_torch::flash_attention`` (modes none, causal and corner; chunk mode, which
only training runs, raises) instead (its CUDA implementation launches the same
kernel, its CPU one is ``flash_attention_ref``, its fake one gives the output's shape
and strides), so an exported program runs the kernel; eager calls skip the op's
dispatch, which costs host time on every call (measured in PERF.md, section 6).
"""

from __future__ import annotations

import ctypes
import math

import torch

from funasr_tpu_torch.ops import cuda_lib

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"none": 0, "causal": 1, "corner": 2, "chunk": 3}
H100_SMS = 132


def flash_block_rows(b: int, h: int, t: int, sms: int = H100_SMS) -> int:
    """Query rows per block of the bf16 kernel: 128 (two consumer warpgroups sharing
    each K/V tile, half the K/V traffic) while that grid still gives every SM a block,
    else 64 (twice the blocks). (32, 4, 384): 384 blocks of 128. (1, 4, 1408): 128-row
    blocks would be 44 for 132 SMs, so 88 blocks of 64."""
    return 128 if b * h * -(-t // 128) >= sms else 64


def key_limits(lengths, tq: int, mode: str = "none", vad_pos=None):
    """(B, Tq) int64: the keys each query row sees (row r sees keys < limit). Chunk mode
    has no such limit: ``chunk_mask``."""
    lens = lengths.long()[:, None]
    rows = torch.arange(tq, device=lengths.device)[None, :]
    if mode == "causal":
        return torch.minimum(rows + 1, lens)
    if mode == "corner":
        vp = vad_pos.to(lengths.device).long()[:, None]
        return torch.where(rows <= vp - 2, torch.minimum(vp, lens), lens)
    if mode != "none":
        raise ValueError(f"key_limits takes modes none, causal and corner, got {mode!r}")
    return lens.expand(-1, tq)


def chunk_mask(lengths, tq: int, tk: int, chunk):
    """(B, Tq, Tk) bool: chunk mode's predicate (row r may attend key c), ``chunk`` =
    (shift, s_fsmn, stride, look_back); the key pad mask c < lengths[b] included."""
    shift, sf, stride, lb = chunk
    dev = lengths.device
    rows, keys = torch.arange(tq, device=dev), torch.arange(tk, device=dev)
    rc, rj = rows // shift, rows % shift - sf
    kc, kj = keys // shift, keys % shift - sf
    same = rc[:, None] == kc[None, :]
    back = ((kc[None, :] < rc[:, None]) & (kc[None, :] >= rc[:, None] - lb)
            & (rj[:, None] < stride) & (kj[None, :] < stride))
    att = (rj[:, None] >= 0) & (kj[None, :] >= 0) & (same | back)
    return att[None] & (keys[None, None, :] < lengths.long()[:, None, None])


def flash_attention_ref(q, k, v, lengths, mode: str = "none", vad_pos=None, chunk=None):
    """Plain PyTorch version: q (B, H, Tq, D), k, v (B, H, Tk, D), lengths (B,), row
    limits (or chunk mode's mask) as ``flash_attention`` -> (B, H, Tq, D). Masked scores
    are -1e30; in chunk mode the probabilities are then zeroed where masked, so a fully
    masked row gives 0 (JAX's ``masked_softmax``). Computed in fp32 (float64 stays
    float64, for ``gradcheck``)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(acc) * (1.0 / math.sqrt(d)), k.to(acc).transpose(-1, -2))
    lengths = lengths.to(q.device)
    if mode == "chunk":
        if chunk is None:
            raise ValueError("mode 'chunk' needs chunk=(shift, s_fsmn, stride, look_back)")
        live = chunk_mask(lengths, tq, tk, chunk)[:, None]
        p = torch.softmax(s.masked_fill(~live, NEG_INF), dim=-1).masked_fill(~live, 0.0)
        return torch.matmul(p, v.to(acc)).to(q.dtype)
    lim = key_limits(lengths, tq, mode, vad_pos)
    key_valid = torch.arange(tk, device=q.device)[None, None, :] < lim[:, :, None]
    s = s.masked_fill(~key_valid[:, None], NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v.to(acc)).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, dout, lengths, mode: str = "none", vad_pos=None,
                            chunk=None):
    """Plain version of the backward: autograd through ``flash_attention_ref`` ->
    (dq, dk, dv)."""
    with torch.enable_grad():
        q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
        out = flash_attention_ref(q_, k_, v_, lengths, mode, vad_pos, chunk)
        return torch.autograd.grad(out, (q_, k_, v_), dout)


def chunk_args(chunk, tq: int):
    """Chunk mode's four integers as the kernels take them, the look-back cut to the
    chunks there are (a larger one sees nothing more); None outside chunk mode."""
    if chunk is None:
        return None
    shift, sf, stride, lb = (int(x) for x in chunk)
    return shift, sf, stride, min(lb, -(-tq // shift))


def _check(q, k, v, lengths, mode, vad_pos, chunk=None):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or k.shape[2] < q.shape[2]:
        raise ValueError(f"q must be (B, H, Tq, D) and k, v one (B, H, Tk, D) shape with "
                         f"Tq <= Tk: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    if d > 128 or d % 8 or d < 8 or t < 1 or b * h < 1:
        raise ValueError(f"flash_attention needs D <= 128 with D % 8 == 0 and T >= 1, "
                         f"got {tuple(q.shape)}")
    if -(-t // 64) > 65535:
        raise ValueError(f"T={t} exceeds the kernel's grid")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if (mode == "chunk") != (chunk is not None):
        raise ValueError("chunk=(shift, s_fsmn, stride, look_back) is given with mode='chunk' "
                         "and only then")
    if chunk is not None:
        if q.dtype != torch.float32:
            raise NotImplementedError(
                f"chunk mode is the fp32 kernels' (streaming training and the SCAMA / UniASR "
                f"decodes run fp32; ROADMAP.md queue 2, item 11: bf16 chunk mode); got "
                f"{q.dtype}")
        shift, sf, stride, lb = chunk
        if k.shape[2] != t or not (shift >= 1 and 0 <= sf < shift and stride >= 1 and lb >= 0):
            raise ValueError(f"chunk mode needs Tq == Tk and shift >= 1, 0 <= s_fsmn < shift, "
                             f"stride >= 1, look_back >= 0: {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, chunk {tuple(chunk)}")
    if (mode == "corner") != (vad_pos is not None):
        raise ValueError("vad_pos is given with mode='corner' and only then")
    if vad_pos is not None and (vad_pos.shape != (b,) or vad_pos.device != q.device):
        raise ValueError(f"vad_pos must be ({b},) on {q.device}, got {tuple(vad_pos.shape)} "
                         f"on {vad_pos.device}")
    vec = 16 // q.element_size()  # the kernel moves 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit last stride, 16-byte aligned rows and "
                             f"base; strides {x.stride()}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")


def flash_attention(q, k, v, lengths, mode: str = "none", vad_pos=None, chunk=None):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D), Tq <= Tk; lengths: (B,) valid key lengths;
    ``mode`` "none", "causal" or "corner" (with ``vad_pos`` (B,)) sets each query row's
    key limit (``key_limits``); "chunk" (with ``chunk`` = (shift, s_fsmn, stride,
    look_back), fp32, Tq = Tk) the overlap-chunk predicate (``chunk_mask``) ->
    (B, H, Tq, D).

    On CUDA q, k, v may be strided views (e.g. heads split out of a fused projection)
    as long as the last stride is 1; the result is a (B, H, Tq, D) view of a contiguous
    (B, Tq, H, D) tensor, so merging heads afterwards costs no copy.
    """
    if torch.compiler.is_exporting():
        if chunk is not None:
            raise NotImplementedError("chunk mode (streaming training) is not exportable")
        return flash_attention_op(q, k, v, lengths, mode, vad_pos)
    cuda_lib.no_dtensor("flash_attention", q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, lengths, mode, vad_pos, chunk)
    return _flash_forward(q, k, v, lengths, mode, vad_pos, chunk)


def _flash_forward(q, k, v, lengths, mode="none", vad_pos=None, chunk=None):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lengths, mode, vad_pos, chunk)
    return _flash_attention_cuda(q, k, v, lengths, mode, vad_pos, chunk=chunk)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward kernel (or plain version) as it
    is, on CUDA at fp32 its instantiation that also writes each row's (m, l), and the
    backward ``flash_attention_bwd`` on the saved q, k, v, output and (m, l)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, mode, vad_pos, chunk):
        if q.device.type == "cuda" and q.dtype == torch.float32:
            out, stats = flash_attention_with_stats(q, k, v, lengths, mode, vad_pos, chunk)
        else:
            out, stats = _flash_forward(q, k, v, lengths, mode, vad_pos, chunk), None
        ctx.save_for_backward(q, k, v, out, lengths, vad_pos, stats)
        ctx.mode, ctx.chunk = mode, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lengths, vad_pos, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lengths, ctx.mode, vad_pos,
                                         stats=stats, chunk=ctx.chunk)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_stats(q, k, v, lengths, mode: str = "none", vad_pos=None,
                               chunk=None):
    """The fp32 forward kernel on CUDA tensors, also writing each query row's softmax
    max m (log2 units: scores times log2(e) / sqrt(D)) and sum l, which the backward
    kernel takes -> (out, stats (2, B H Tq) fp32). One ``flash_attention`` launch."""
    if q.device.type != "cuda" or q.dtype != torch.float32:
        raise ValueError(f"the forward with (m, l) is the fp32 CUDA kernel's; got "
                         f"{q.dtype} on {q.device}")
    b, h, t, _ = q.shape
    stats = torch.empty((2, b * h * t), dtype=torch.float32, device=q.device)
    return _flash_attention_cuda(q, k, v, lengths, mode, vad_pos, stats=stats,
                                 chunk=chunk), stats


KEY_BLOCK = 32  # keys a block of the backward kernel (csrc/flash_attention_bwd.cu)


def flash_bwd_plan(b: int, h: int, tq: int, tk: int, d: int) -> dict:
    """The backward kernel's grid and scratch: (B H, ceil(Tk / KEY_BLOCK)) blocks of 256
    threads, and floats of scratch for Dr (B H Tq, rounded up to a multiple of 4) and the
    key blocks' shares of dQ (key blocks, B H, Tq, D). (5, 4, 190, 128): 120 blocks."""
    key_blocks = -(-tk // KEY_BLOCK)
    rows = b * h * tq
    return dict(grid=(b * h, key_blocks), dr_floats=-(-rows // 4) * 4,
                dq_part_shape=(key_blocks, b * h, tq, d),
                scratch_floats=-(-rows // 4) * 4 + key_blocks * rows * d)


def flash_attention_bwd(q, k, v, out, dout, lengths, mode: str = "none", vad_pos=None, *,
                        stats=None, chunk=None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, lengths, mode, vad_pos,
    chunk=chunk)`` = out, given dout, its output's gradient. CPU tensors: ``flash_attention_bwd_ref``;
    CUDA: the fp32 backward kernel, or raises (bf16: ``NotImplementedError``). ``stats``:
    the (m, l) that ``flash_attention_with_stats`` wrote with ``out`` (``FlashAttentionFn``
    passes them); without them the forward kernel runs once more to write them. Each
    gradient is a (B, H, T, D) view of a contiguous (B, T, H, D) tensor, as the forward's
    output is, so the heads merge back into the fused projection's layout without a
    copy."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, lengths, mode, vad_pos, chunk)
    if q.dtype != torch.float32:
        raise NotImplementedError(
            f"the flash attention backward kernel takes float32, as the reference trains; "
            f"{q.dtype} training is not planned (ROADMAP item 20b)")
    _check(q, k, v, lengths, mode, vad_pos, chunk)
    b, h, t, d = q.shape
    tk = k.shape[2]
    if stats is None:
        _, stats = flash_attention_with_stats(q, k, v, lengths, mode, vad_pos, chunk)
    if stats.shape != (2, b * h * t) or stats.dtype != torch.float32 \
            or stats.device != q.device or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous (2, {b * h * t}) float32 tensor on "
                         f"{q.device}")
    o, do = (cuda_lib.vectorizable(x) for x in (out, dout))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    vps = None if vad_pos is None else vad_pos.to(dtype=torch.int32).contiguous()
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    dk, dv = (torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
              for _ in range(2))
    scratch = torch.empty(flash_bwd_plan(b, h, t, tk, d)["scratch_floats"],
                          dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, o, do, dq, dk, dv)
                                         for s in x.stride()[:3]))
    args = chunk_args(chunk, t)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(flash_attention_bwd, (q, k, v, o, do), (mode, *(args or ())), lens)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        lens.data_ptr(), b, h, t, tk, d, strides, 1.0 / math.sqrt(d), MODES[mode],
        None if vps is None else vps.data_ptr(), _chunk_array(args),
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(err, "flash_attention_bwd")
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _chunk_array(args):
    return None if args is None else (ctypes.c_int * 4)(*args)


def _flash_attention_cuda(q, k, v, lengths, mode="none", vad_pos=None, stats=None,
                          chunk=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    _check(q, k, v, lengths, mode, vad_pos, chunk)
    b, h, t, d = q.shape
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    vps = None if vad_pos is None else vad_pos.to(dtype=torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    rows = flash_block_rows(b, h, t, cuda_lib.sm_count(q.device.index or 0))
    args = chunk_args(chunk, t)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(flash_attention, (q, k, v), (mode, *(args or ())), lens)
    err = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), b, h, t, k.shape[2], d, strides, 1.0 / math.sqrt(d), MODES[mode],
        None if vps is None else vps.data_ptr(), rows,
        None if stats is None else stats.data_ptr(), _chunk_array(args),
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(err, "flash_attention_fwd")
    return out


flash_attention.launches = 0

flash_attention_op = torch.library.custom_op(
    "funasr_tpu_torch::flash_attention", flash_attention_ref, mutates_args=(),
    device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor lengths, str mode, Tensor? vad_pos) "
           "-> Tensor")
flash_attention_op.register_kernel("cuda")(_flash_attention_cuda)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, lengths, mode, vad_pos):
    b, h, t, d = q.shape
    if q.device.type == "cuda":  # the kernel writes (B, Tq, H, D)
        return q.new_empty((b, t, h, d)).permute(0, 2, 1, 3)
    return q.new_empty((b, h, t, d))
