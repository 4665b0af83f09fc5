"""FSMN memory block: a hand-written Hopper kernel and its plain PyTorch version.

    out = mask * (dwconv(mask * x) + mask * x)

Replaces the TPU kernel ``benchmarks/bench_pallas_dwconv.py::dw_pallas`` (the FSMN
depthwise conv1d, bit-exact to ``funasr_tpu/core/layers.py::depthwise_conv1d_apply``),
fused with the mask / residual / mask passes of ``funasr_tpu/models/sanm/attention.py``
``_fsmn`` (encoder) and ``fsmn_decoder_apply`` (decoder), which compute this same
function. The CUDA source, ``funasr_tpu_torch/csrc/fsmn.cu``, notes what bounds it on the
H100 (device-memory bandwidth: 23 flops per element for k = 11; 7.5 us of bytes at
(32, 384, 512) bf16, where the first port took 0.0488 ms) and what its design does about
it: 16-byte loads and stores of 8 bf16 or 4 fp32 channels per thread, k and the pads as
template parameters (11 and 5 on the SAN-M path, 20 and 19 for the VAD's fp32 causal
memory, 21 and 10 for the SeACo decoder's memory, 12 and 9 for the keyword spotters'
lookahead FSMN and 17 and 8 for MossFormer's FFConvM conv, the last three at 4 channels a
thread, so that bf16's window and taps fit in
registers too; a generic instantiation for the rest) so the
k-vector input window stays in registers and loads run several rows ahead, the weights
read once per thread, the mask once per warp and row (as ballot bits), and the three
elementwise passes fused away.

Taps accumulate in fp32; the conv sum is rounded to x's dtype before the residual is
added, and the sum rounded again, in the JAX functions' order.

On CUDA the kernel moves 16-byte vectors, so x's base must be 16-byte aligned and C and
x's batch / time strides multiples of 16 bytes / element size (8 bf16, 4 fp32): the
path's inputs are (the v slice at offset 2C of q|k|v, the decoder's contiguous input);
anything else raises ``ValueError``.

Dispatch: a CPU tensor takes ``fsmn_memory_ref``; a CUDA tensor launches the kernel or
raises. ``fsmn_memory.launches`` counts kernel launches. With grad mode on and x or the
weight requiring grad, the output comes from ``FsmnMemoryFn``. With a 0/1 mask m,
out = m (conv(m x) + m x), so with g = m dout the input gradient is m (corr'(g) + g),
where corr' correlates with the taps reversed and the pads swapped: the forward kernel
itself on dout (``fsmn_memory_bwd_input``; the path's (11, 5) maps onto itself and keeps
its instantiation). The weight gradient dw[c, j] = sum_{b,t} g[b,t,c] xm[b,t+j-left,c]
is the reduction kernel ``fsmn_memory_bwd_weight`` of ``csrc/fsmn.cu`` (fp32,
deterministic: per-chunk partials added in chunk order). At k 11, pads 5 / 5 (every
SAN-M FSMN of the training path), k 12, pads 9 / 2 (the lookahead FSMN) or k 17, pads 8 / 8
(MossFormer's FFConvM conv) and C a
multiple of 4 it is the forward's shape: 4 channels a
thread, the k-row window of xm and the k x 4 taps in registers, each g and x row read
once (a block's rows and halo staged in shared memory by one batch of ``cp.async``), 4
chunks a block added in the block, chunks planned by ``dw_plan`` to fill the card; any
other k, pads or C takes the generic kernel, which reads each row once a tap. Each counts
its calls in ``.launches``; on the CPU both are autograd through ``fsmn_memory_ref``;
bf16 raises (ROADMAP item 20b). The mask gets no gradient.
``generic=True`` launches the generic instantiation whatever k is, to time a specialised
one against it.

The lookahead FSMN (``models/fsmn_vad_streaming/encoder.py``, ``rorder > 0``: the keyword
spotters' lorder 10 / rorder 2) is this function at k = lorder + rorder, the taps
``[conv_left | conv_right]`` and pads (lorder - 1, rorder): one launch of the k 12 / left
9 instantiation a block, its input gradient on k 12 / left 2 (the pads swapped), its
weight gradient on the vector kernel at k 12 / left 9, split back into the two convs by
autograd through the concatenation.

``depthwise_conv1d`` is the same kernel's plain mode: dw_pallas's own function,
``core/layers.py::depthwise_conv1d_apply`` (zero pads, taps summed in fp32 from 0 in tap
order, then the bias, one rounding to x's dtype), with an optional input mask and no
residual or output mask, as the Conformer's convolution module, the Branchformer's
cgMLP gate and the E-Branchformer's merge conv call it (own instantiations for k 15 / left
7, k 3 / left 1 and fp32 k 31 / left 15; ``generic=True`` as above). Its plain version is
``depthwise_conv1d_ref``, whose separate multiply and add the kernel copies, so the two
agree bit for bit on the card. It counts its launches in ``depthwise_conv1d.launches``.
With grad mode on and a CUDA input, weight or bias requiring grad it runs through
``DepthwiseConvFn``: dx is the plain-mode forward kernel on dout with the taps reversed,
the pads swapped and no bias, times the input mask (applied by the wrapper,
``depthwise_conv1d_bwd_input``, bit-equal to ``depthwise_conv1d_bwd_input_ref``); dw and
db come from one deterministic reduction, ``depthwise_conv1d_bwd_weight`` (the FSMN weight
gradient's vector kernel with a bias row and an unmasked dout, at k 15 / left 7, k 15 /
left 14, k 3 / left 1 and, 2 channels a thread, k 31 / left 15; the generic kernel for any
other k; plain version ``depthwise_conv1d_bwd_weight_ref``). fp32 only: a bf16 backward
raises (ROADMAP item 20b). On the CPU autograd runs through the plain version. The chunk
conformer's causal conv (pads 14 / 0) and its dx (0 / 14) have their own forward
instantiations. Under
``torch.export`` the wrapper records the custom op ``funasr_tpu_torch::fsmn_memory``
(CUDA: the same kernel; CPU: ``fsmn_memory_ref``; fake: the (B, T, C) output), so an
exported program runs the kernel; eager calls skip the op's dispatch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from funasr_tpu_torch.ops import cuda_lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_KERNEL = 64
TIME_STEPS = 24 * 4  # time steps per block (csrc/fsmn.cu: TT x WARPS)


def _masked(x, mask):
    return x if mask is None else x * mask[..., None].to(x.dtype)


def fsmn_memory_ref(x, weight, mask, left_pad: int, right_pad: int):
    """Plain PyTorch version. x (B, T, C); weight (C, 1, k) (torch depthwise Conv1d);
    mask (B, T) bool, True = valid, or None -> (B, T, C) in x's dtype."""
    c, k = weight.shape[0], weight.shape[-1]
    x = _masked(x, mask)
    acc_t = torch.promote_types(x.dtype, torch.float32)  # float64 stays (gradcheck)
    pad = F.pad(x.to(acc_t), (0, 0, left_pad, right_pad))
    w = weight.reshape(c, k).to(acc_t)
    t = x.shape[1]
    acc = torch.zeros(pad.shape[0], t, c, dtype=acc_t, device=x.device)
    for i in range(k):
        acc = acc + pad[:, i : i + t] * w[:, i]
    return _masked(acc.to(x.dtype) + x, mask)


def _check(x, weight, mask, left_pad, right_pad):
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"fsmn_memory takes float32 or bfloat16 x and weight of one dtype, "
                        f"got {x.dtype}, {weight.dtype}")
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"x must be (B, T, C) with unit channel stride, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, t, c = x.shape
    k = weight.shape[-1]
    if weight.shape not in ((c, 1, k), (c, k)) or weight.device != x.device:
        raise ValueError(f"weight must be ({c}, 1, k) on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if not 1 <= k <= MAX_KERNEL or left_pad < 0 or right_pad < 0 or left_pad + right_pad != k - 1:
        raise ValueError(f"need 1 <= k <= {MAX_KERNEL} and pads summing to k - 1, got "
                         f"k={k}, pads=({left_pad}, {right_pad})")
    if b > 65535 or -(-t // TIME_STEPS) > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, t)
                             or mask.device != x.device):
        raise ValueError(f"mask must be a ({b}, {t}) bool tensor on {x.device}")
    vec = 16 // x.element_size()  # the kernel moves 16-byte vectors
    if c % vec or x.stride(0) % vec or x.stride(1) % vec or x.data_ptr() % 16:
        raise ValueError(f"the FSMN kernel needs C and x's batch / time strides multiples of "
                         f"{vec} and a 16-byte aligned base; got C={c}, strides {x.stride()}, "
                         f"base offset {x.data_ptr() % 16}")


def fsmn_memory(x, weight, mask, left_pad: int, right_pad: int, *, generic: bool = False):
    """x (B, T, C) (any batch/time strides, unit channel stride); weight (C, 1, k) in
    x's dtype; mask (B, T) bool or None -> contiguous (B, T, C) in x's dtype."""
    if torch.compiler.is_exporting():
        return fsmn_memory_op(x, weight, mask, left_pad, right_pad, generic)
    cuda_lib.no_dtensor("fsmn_memory", x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return FsmnMemoryFn.apply(x, weight, mask, left_pad, right_pad)
    return _fsmn_forward(x, weight, mask, left_pad, right_pad, generic)


def _fsmn_forward(x, weight, mask, left_pad, right_pad, generic=False):
    if x.device.type == "cpu":
        return fsmn_memory_ref(x, weight, mask, left_pad, right_pad)
    return _fsmn_memory_cuda(x, weight, mask, left_pad, right_pad, generic)


class FsmnMemoryFn(torch.autograd.Function):
    """``fsmn_memory`` with a gradient for x and the weight."""

    @staticmethod
    def forward(ctx, x, weight, mask, left_pad, right_pad):
        ctx.save_for_backward(x, weight, mask)
        ctx.pads = (left_pad, right_pad)
        return _fsmn_forward(x, weight, mask, left_pad, right_pad)

    @staticmethod
    def backward(ctx, dout):
        x, weight, mask = ctx.saved_tensors
        left, right = ctx.pads
        if x.device.type == "cpu":
            dx, dw = fsmn_memory_bwd_ref(x, weight, mask, left, right, dout)
        else:
            dx = (fsmn_memory_bwd_input(dout, weight, mask, left, right)
                  if ctx.needs_input_grad[0] else None)
            dw = (fsmn_memory_bwd_weight(x, dout, mask, left, right).reshape(weight.shape)
                  if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None, None


def fsmn_memory_bwd_ref(x, weight, mask, left_pad, right_pad, dout):
    """Plain version of the backward: autograd through ``fsmn_memory_ref`` -> (dx, dw)."""
    with torch.enable_grad():
        x_, w_ = x.detach().requires_grad_(), weight.detach().requires_grad_()
        out = fsmn_memory_ref(x_, w_, mask, left_pad, right_pad)
        return torch.autograd.grad(out, (x_, w_), dout)


def _fp32_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on CUDA tensors, not {t.device}")
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"{name} takes float32, as the reference trains; {t.dtype} training is "
                "not planned (ROADMAP item 20b)")


def fsmn_memory_bwd_input(dout, weight, mask, left_pad: int, right_pad: int):
    """The input gradient of ``fsmn_memory``: the forward kernel on dout with the taps
    reversed and the pads swapped (CUDA, fp32) -> contiguous (B, T, C)."""
    _fp32_cuda("fsmn_memory_bwd_input", dout, weight)
    g = cuda_lib.vectorizable(dout)
    w = weight.reshape(weight.shape[0], weight.shape[-1]).flip(-1).contiguous()
    _check(g, w, mask, right_pad, left_pad)
    b, t, c = g.shape
    m = None if mask is None else mask.contiguous()
    dx = torch.empty((b, t, c), dtype=g.dtype, device=g.device)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(fsmn_memory_bwd_input, (g,), (w.shape[1], left_pad, right_pad), m)
    err = lib.fsmn_memory_fwd(_DTYPES[g.dtype], g.data_ptr(), w.data_ptr(),
                              None if m is None else m.data_ptr(), dx.data_ptr(), b, t, c,
                              w.shape[1], right_pad, g.stride(0), g.stride(1),
                              cuda_lib.stream_handle(g.device))
    cuda_lib.check(err, "fsmn_memory_bwd_input")
    return dx


fsmn_memory_bwd_input.launches = 0

DW_BLOCKS_PER_SM = 4  # blocks the generic weight-gradient kernel aims for, per multiprocessor
DW_THREADS = 128  # channels a block of the generic kernel (csrc/fsmn.cu)
# (k, left) of the vector weight-gradient kernel (csrc/fsmn.cu): the SAN-M FSMN's, the
# keyword spotters' lookahead FSMN (lorder 10, rorder 2) and MossFormer's FFConvM conv
DW_SPECIALISED = ((11, 5), (12, 9), (17, 8))
DW_BLOCK_CHUNKS = 4  # chunks a block of the vector kernel: 4 warps on 128 channels
DW_BLOCKS_PER_SM_VEC = 2  # blocks the vector kernel aims for, per multiprocessor
DW_MIN_ROWS, DW_MAX_ROWS = 4, 16  # rows a chunk (a warp's) of the vector kernel


def dw_rows_per_chunk(b: int, t: int, c: int, k: int, sms: int) -> int:
    """Rows (b, t) each partial sum of the generic weight-gradient kernel covers: enough
    chunks that the grid (C / 128, k, chunks) holds about DW_BLOCKS_PER_SM blocks on each
    of the card's ``sms`` multiprocessors."""
    per_chunk = -(-c // DW_THREADS) * k
    chunks = max(1, DW_BLOCKS_PER_SM * sms // per_chunk)
    return max(32, -(-(b * t) // chunks))


def _vec_plan(b: int, t: int, c: int, v: int, sms: int):
    """(rows a chunk, blocks a channel group) of the vector weight-gradient kernel at v
    channels a thread: chunks of DW_MIN_ROWS-DW_MAX_ROWS rows, DW_BLOCK_CHUNKS a block of
    32 v channels, as many as give each of the card's ``sms`` multiprocessors
    DW_BLOCKS_PER_SM_VEC blocks."""
    chunks = max(1, DW_BLOCK_CHUNKS * DW_BLOCKS_PER_SM_VEC * sms // -(-c // (32 * v)))
    rows = min(DW_MAX_ROWS, max(DW_MIN_ROWS, -(-(b * t) // chunks)))
    return rows, -(-(-(-(b * t) // rows)) // DW_BLOCK_CHUNKS)


def dw_plan(b: int, t: int, c: int, k: int, left: int, sms: int):
    """(specialised, rows a chunk, partial shape) of the weight gradient. The vector
    kernel (k 11, left 5, k 12, left 9 or k 17, left 8; C a multiple of 4) walks chunks of
    DW_MIN_ROWS-DW_MAX_ROWS
    rows, DW_BLOCK_CHUNKS a block of 128 channels, as many as give each of the card's
    ``sms`` multiprocessors DW_BLOCKS_PER_SM_VEC blocks: at (5, 190, 512) 238 chunks of
    4 rows, 240 blocks (60 for each 128 channels), one partial (k, C) a block. Any other
    k, pads or C takes the generic kernel (``dw_rows_per_chunk``, a partial a chunk).
    Partials: (parts, k, C) fp32."""
    if (k, left) in DW_SPECIALISED and c % 4 == 0:
        rows, parts = _vec_plan(b, t, c, 4, sms)
        return True, rows, (parts, k, c)
    rows = dw_rows_per_chunk(b, t, c, k, sms)
    return False, rows, (-(-(b * t) // rows), k, c)


def fsmn_memory_bwd_weight(x, dout, mask, left_pad: int, right_pad: int):
    """The weight gradient of ``fsmn_memory`` (CUDA, fp32): x and dout (B, T, C), any
    batch / time strides -> (C, k) fp32, k = left_pad + right_pad + 1."""
    _fp32_cuda("fsmn_memory_bwd_weight", x, dout)
    if x.dim() != 3 or dout.shape != x.shape or x.stride(2) != 1 or dout.stride(2) != 1:
        raise ValueError(f"x and dout must be one (B, T, C) shape with unit channel "
                         f"stride, got {tuple(x.shape)}, {tuple(dout.shape)}")
    b, t, c = x.shape
    k = left_pad + right_pad + 1
    if not 1 <= k <= MAX_KERNEL or left_pad < 0 or right_pad < 0:
        raise ValueError(f"need pads >= 0 with k = left + right + 1 <= {MAX_KERNEL}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, t)
                             or mask.device != x.device):
        raise ValueError(f"mask must be a ({b}, {t}) bool tensor on {x.device}")
    specialised, rows, shape = dw_plan(b, t, c, k, left_pad,
                                       cuda_lib.sm_count(x.device.index or 0))
    if specialised:  # 16-byte vectors: a copy only for a layout the path never hands over
        x, dout = cuda_lib.vectorizable(x), cuda_lib.vectorizable(dout)
    if shape[0] > (2**31 - 1 if specialised else 65535):
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    partial = torch.empty(shape, dtype=torch.float32, device=x.device)
    dw = torch.empty((c, k), dtype=torch.float32, device=x.device)
    m = None if mask is None else mask.contiguous()
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(fsmn_memory_bwd_weight, (x, dout), (k, left_pad, right_pad), m)
    err = lib.fsmn_memory_bwd_weight(
        x.data_ptr(), dout.data_ptr(), None if m is None else m.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), b, t, c, k, left_pad, x.stride(0), x.stride(1),
        dout.stride(0), dout.stride(1), rows, int(specialised),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "fsmn_memory_bwd_weight")
    return dw


fsmn_memory_bwd_weight.launches = 0


def _fsmn_memory_cuda(x, weight, mask, left_pad, right_pad, generic=False):
    if x.device.type != "cuda":
        raise ValueError(f"fsmn_memory runs on CPU or CUDA tensors, not {x.device}")
    _check(x, weight, mask, left_pad, right_pad)
    b, t, c = x.shape
    k = weight.shape[-1]
    w = weight.reshape(c, k).contiguous()
    if w.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte vectors
        w = w.clone()
    m = None if mask is None else mask.contiguous()
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(fsmn_memory, (x,), (k, left_pad, right_pad, generic), m)
    err = (lib.fsmn_memory_generic_fwd if generic else lib.fsmn_memory_fwd)(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if m is None else m.data_ptr(), out.data_ptr(), b, t, c, k, left_pad,
        x.stride(0), x.stride(1), cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "fsmn_memory_fwd")
    return out


fsmn_memory.launches = 0

fsmn_memory_op = torch.library.custom_op(
    "funasr_tpu_torch::fsmn_memory",
    lambda x, weight, mask, left_pad, right_pad, generic: fsmn_memory_ref(
        x, weight, mask, left_pad, right_pad),
    mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor weight, Tensor? mask, int left_pad, int right_pad, "
           "bool generic) -> Tensor")
fsmn_memory_op.register_kernel("cuda")(_fsmn_memory_cuda)


@fsmn_memory_op.register_fake
def _fsmn_memory_fake(x, weight, mask, left_pad, right_pad, generic):
    return x.new_empty(x.shape)


# ---- the plain mode: dw_pallas's own function ---------------------------------------


def depthwise_conv1d_ref(x, weight, bias, mask, left_pad: int, right_pad: int):
    """Plain PyTorch version (``depthwise_conv1d_apply``, ``core/layers.py:104-122``).
    x (B, T, C); weight (C, 1, k); bias (C,) or None; mask (B, T) bool or None masks the
    input -> (B, T + left + right - k + 1, C) in x's dtype."""
    c, k = weight.shape[0], weight.shape[-1]
    x = _masked(x, mask)
    acc_t = torch.promote_types(x.dtype, torch.float32)
    pad = F.pad(x.to(acc_t), (0, 0, left_pad, right_pad))
    w = weight.reshape(c, k).to(acc_t)
    t_out = pad.shape[1] - k + 1
    acc = torch.zeros(pad.shape[0], t_out, c, dtype=acc_t, device=x.device)
    for i in range(k):
        acc = acc + pad[:, i : i + t_out] * w[:, i]
    if bias is not None:
        acc = acc + bias.to(acc_t)
    return acc.to(x.dtype)


def depthwise_conv1d(x, weight, bias, mask, left_pad: int, right_pad: int, *,
                     generic: bool = False):
    """x (B, T, C) (unit channel stride); weight (C, 1, k) and bias (C,) or None in x's
    dtype; mask (B, T) bool or None (applied to the input); pads summing to k - 1 ->
    contiguous (B, T, C) in x's dtype. CPU tensors take ``depthwise_conv1d_ref`` (autograd
    runs through it); CUDA tensors launch the plain mode of the kernel of ``csrc/fsmn.cu``
    or raise, through ``DepthwiseConvFn`` when grad mode is on and x, the weight or the
    bias requires grad."""
    cuda_lib.no_dtensor("depthwise_conv1d", x, weight)
    if x.device.type == "cpu":
        return depthwise_conv1d_ref(x, weight, bias, mask, left_pad, right_pad)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        return DepthwiseConvFn.apply(x, weight, bias, mask, left_pad, right_pad)
    return _depthwise_cuda(x, weight, bias, mask, left_pad, right_pad, generic)


def _depthwise_cuda(x, weight, bias, mask, left_pad, right_pad, generic=False):
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d runs on CPU or CUDA tensors, not {x.device}")
    x = cuda_lib.vectorizable(x)
    _check(x, weight, mask, left_pad, right_pad)
    b, t, c = x.shape
    k = weight.shape[-1]
    w = weight.reshape(c, k).contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    if bias is not None:
        if bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device:
            raise ValueError(f"bias must be ({c},) {x.dtype} on {x.device}, got "
                             f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
        bias = bias.contiguous()
        if bias.data_ptr() % 16:
            bias = bias.clone()
    m = None if mask is None else mask.contiguous()
    out = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(depthwise_conv1d, (x,), (k, left_pad, right_pad, generic), m)
    err = lib.fsmn_depthwise_fwd(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), None if m is None else m.data_ptr(),
        out.data_ptr(), b, t, c, k, left_pad, x.stride(0), x.stride(1), int(generic),
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "fsmn_depthwise_fwd")
    return out


depthwise_conv1d.launches = 0


class DepthwiseConvFn(torch.autograd.Function):
    """``depthwise_conv1d`` on the card with gradients for x, the weight and the bias:
    dx from ``depthwise_conv1d_bwd_input``, dw and db from one
    ``depthwise_conv1d_bwd_weight``. The mask gets none."""

    @staticmethod
    def forward(ctx, x, weight, bias, mask, left_pad, right_pad):
        x = cuda_lib.vectorizable(x)
        ctx.save_for_backward(x, weight, mask)
        ctx.pads = (left_pad, right_pad)
        return _depthwise_cuda(x, weight, bias, mask, left_pad, right_pad)

    @staticmethod
    def backward(ctx, dout):
        x, weight, mask = ctx.saved_tensors
        left, right = ctx.pads
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv1d_bwd_input(dout, weight, mask, left, right)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = depthwise_conv1d_bwd_weight(x, dout, mask, left, right)
            dw = dw.reshape(weight.shape) if ctx.needs_input_grad[1] else None
            db = db if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None


def depthwise_conv1d_bwd_input_ref(dout, weight, mask, left_pad: int, right_pad: int):
    """Plain version of the input gradient: ``depthwise_conv1d_ref`` on dout with the taps
    reversed, the pads swapped and no bias, times the input mask."""
    w = weight.reshape(weight.shape[0], 1, weight.shape[-1]).flip(-1)
    return _masked(depthwise_conv1d_ref(dout, w, None, None, right_pad, left_pad), mask)


def depthwise_conv1d_bwd_weight_ref(x, dout, mask, left_pad: int, right_pad: int):
    """Plain version of the weight and bias gradients: dw[c, j] = sum_{b,t} dout[b, t, c]
    xm[b, t + j - left, c] (xm the masked input, zero outside [0, T)) and db[c] =
    sum_{b,t} dout[b, t, c], each a sum over (b, t) in fp32, tap by tap in tap order ->
    ((C, k), (C,)) fp32."""
    k = left_pad + right_pad + 1
    t = x.shape[1]
    g = dout.float()
    xp = F.pad(_masked(x, mask).float(), (0, 0, left_pad, right_pad))
    dw = torch.stack([(g * xp[:, j: j + t]).sum((0, 1)) for j in range(k)], dim=-1)
    return dw, g.sum((0, 1))


def depthwise_conv1d_bwd_input(dout, weight, mask, left_pad: int, right_pad: int):
    """The input gradient of ``depthwise_conv1d`` (CUDA, fp32): the plain-mode forward
    kernel on dout with the taps reversed, the pads swapped and no bias; the wrapper then
    multiplies by the input mask -> contiguous (B, T, C). Bit-equal to
    ``depthwise_conv1d_bwd_input_ref``."""
    _fp32_cuda("depthwise_conv1d_bwd_input", dout, weight)
    g = cuda_lib.vectorizable(dout)
    k = weight.shape[-1]
    w = weight.reshape(weight.shape[0], k).flip(-1).contiguous()
    _check(g, w, mask, right_pad, left_pad)
    b, t, c = g.shape
    dx = torch.empty((b, t, c), dtype=g.dtype, device=g.device)
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(depthwise_conv1d_bwd_input, (g,), (k, right_pad, left_pad), mask)
    err = lib.fsmn_depthwise_fwd(_DTYPES[g.dtype], g.data_ptr(), w.data_ptr(), None, None,
                                 dx.data_ptr(), b, t, c, k, right_pad, g.stride(0),
                                 g.stride(1), 0, cuda_lib.stream_handle(g.device))
    cuda_lib.check(err, "depthwise_conv1d_bwd_input")
    return dx if mask is None else dx.mul_(mask[..., None].to(dx.dtype))


depthwise_conv1d_bwd_input.launches = 0

# (k, left) of the depthwise weight gradient's vector kernel -> channels a thread
# (csrc/fsmn.cu): the Conformer's, the chunk conformer's causal, the E-Branchformer's merge
# conv and, at 2 channels a thread as its forward, the cgMLP gate
DEPTHWISE_DW_VEC = {(15, 7): 4, (15, 14): 4, (3, 1): 4, (31, 15): 2}


def depthwise_dw_plan(b: int, t: int, c: int, k: int, left: int, sms: int):
    """(channels a thread of the vector kernel, 0 for the generic one; rows a chunk;
    partial shape) of ``depthwise_conv1d_bwd_weight``: ``dw_plan``'s chunks at the vector
    kernel's channels (``DEPTHWISE_DW_VEC``, C a multiple of them), else the generic
    kernel's; each partial holds the k taps and the bias row: (parts, k + 1, C) fp32."""
    v = DEPTHWISE_DW_VEC.get((k, left), 0)
    if v and c % v == 0:
        rows, parts = _vec_plan(b, t, c, v, sms)
        return v, rows, (parts, k + 1, c)
    rows = dw_rows_per_chunk(b, t, c, k + 1, sms)
    return 0, rows, (-(-(b * t) // rows), k + 1, c)


def depthwise_conv1d_bwd_weight(x, dout, mask, left_pad: int, right_pad: int):
    """The weight and bias gradients of ``depthwise_conv1d`` (CUDA, fp32): one reduction
    kernel over the B T rows for the C k taps and the bias row at once
    (``fsmn_depthwise_bwd_weight``, deterministic: per-chunk partials added in chunk
    order), x and dout (B, T, C), any batch / time strides -> ((C, k), (C,)) fp32."""
    _fp32_cuda("depthwise_conv1d_bwd_weight", x, dout)
    if x.dim() != 3 or dout.shape != x.shape or x.stride(2) != 1 or dout.stride(2) != 1:
        raise ValueError(f"x and dout must be one (B, T, C) shape with unit channel "
                         f"stride, got {tuple(x.shape)}, {tuple(dout.shape)}")
    b, t, c = x.shape
    k = left_pad + right_pad + 1
    if not 1 <= k <= MAX_KERNEL or left_pad < 0 or right_pad < 0:
        raise ValueError(f"need pads >= 0 with k = left + right + 1 <= {MAX_KERNEL}")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (b, t)
                             or mask.device != x.device):
        raise ValueError(f"mask must be a ({b}, {t}) bool tensor on {x.device}")
    vec, rows, shape = depthwise_dw_plan(b, t, c, k, left_pad,
                                         cuda_lib.sm_count(x.device.index or 0))
    if vec:
        x, dout = cuda_lib.vectorizable(x), cuda_lib.vectorizable(dout)
    if shape[0] > (2**31 - 1 if vec else 65535):
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    partial = torch.empty(shape, dtype=torch.float32, device=x.device)
    dw = torch.empty((c, k), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    m = None if mask is None else mask.contiguous()
    lib = cuda_lib.load_library()
    cuda_lib.count_launch(depthwise_conv1d_bwd_weight, (x, dout), (k, left_pad, right_pad), m)
    err = lib.fsmn_depthwise_bwd_weight(
        x.data_ptr(), dout.data_ptr(), None if m is None else m.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), db.data_ptr(), b, t, c, k, left_pad, x.stride(0),
        x.stride(1), dout.stride(0), dout.stride(1), rows, vec,
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(err, "depthwise_conv1d_bwd_weight")
    return dw, db


depthwise_conv1d_bwd_weight.launches = 0
