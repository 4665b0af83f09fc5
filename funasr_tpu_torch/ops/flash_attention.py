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

Unlike the Pallas kernel it needs no T % block == 0: the ragged last tile is masked in
the kernel. A row of length 0 gets the uniform average of V over its Tk keys in both
versions (the Pallas kernel's behaviour); bucketing never builds one.

Dispatch: a CPU tensor takes ``flash_attention_ref``; a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` counts kernel launches. Under
``torch.export`` the wrapper records the custom op ``funasr_tpu_torch::flash_attention``
instead (its CUDA implementation launches the same kernel, its CPU one is
``flash_attention_ref``, its fake one gives the output's shape and strides), so an
exported program runs the kernel; eager calls skip the op's dispatch, which costs host
time on every call (measured in PERF.md, section 6).
"""

from __future__ import annotations

import ctypes
import math

import torch

from funasr_tpu_torch.ops import cuda_lib

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = {"none": 0, "causal": 1, "corner": 2}
H100_SMS = 132


def flash_block_rows(b: int, h: int, t: int, sms: int = H100_SMS) -> int:
    """Query rows per block of the bf16 kernel: 128 (two consumer warpgroups sharing
    each K/V tile, half the K/V traffic) while that grid still gives every SM a block,
    else 64 (twice the blocks). (32, 4, 384): 384 blocks of 128. (1, 4, 1408): 128-row
    blocks would be 44 for 132 SMs, so 88 blocks of 64."""
    return 128 if b * h * -(-t // 128) >= sms else 64


def key_limits(lengths, tq: int, mode: str = "none", vad_pos=None):
    """(B, Tq) int64: the keys each query row sees (row r sees keys < limit)."""
    lens = lengths.long()[:, None]
    rows = torch.arange(tq, device=lengths.device)[None, :]
    if mode == "causal":
        return torch.minimum(rows + 1, lens)
    if mode == "corner":
        vp = vad_pos.to(lengths.device).long()[:, None]
        return torch.where(rows <= vp - 2, torch.minimum(vp, lens), lens)
    if mode != "none":
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    return lens.expand(-1, tq)


def flash_attention_ref(q, k, v, lengths, mode: str = "none", vad_pos=None):
    """Plain PyTorch version: q (B, H, Tq, D), k, v (B, H, Tk, D), lengths (B,), row
    limits as ``flash_attention`` -> (B, H, Tq, D)."""
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.matmul(q.float() * (1.0 / math.sqrt(d)), k.float().transpose(-1, -2))
    lim = key_limits(lengths.to(q.device), tq, mode, vad_pos)
    key_valid = torch.arange(tk, device=q.device)[None, None, :] < lim[:, :, None]
    s = s.masked_fill(~key_valid[:, None], NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _check(q, k, v, lengths, mode, vad_pos):
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


def flash_attention(q, k, v, lengths, mode: str = "none", vad_pos=None):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D), Tq <= Tk; lengths: (B,) valid key lengths;
    ``mode`` "none", "causal" or "corner" (with ``vad_pos`` (B,)) sets each query row's
    key limit (``key_limits``) -> (B, H, Tq, D).

    On CUDA q, k, v may be strided views (e.g. heads split out of a fused projection)
    as long as the last stride is 1; the result is a (B, H, Tq, D) view of a contiguous
    (B, Tq, H, D) tensor, so merging heads afterwards costs no copy.
    """
    if torch.compiler.is_exporting():
        return flash_attention_op(q, k, v, lengths, mode, vad_pos)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lengths, mode, vad_pos)
    return _flash_attention_cuda(q, k, v, lengths, mode, vad_pos)


def _flash_attention_cuda(q, k, v, lengths, mode="none", vad_pos=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    _check(q, k, v, lengths, mode, vad_pos)
    b, h, t, d = q.shape
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    vps = None if vad_pos is None else vad_pos.to(dtype=torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    rows = flash_block_rows(b, h, t, cuda_lib.sm_count(q.device.index or 0))
    lib = cuda_lib.load_library()
    flash_attention.launches += 1
    err = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr(), b, h, t, k.shape[2], d, strides, 1.0 / math.sqrt(d), MODES[mode],
        None if vps is None else vps.data_ptr(), rows, cuda_lib.stream_handle(q.device))
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
