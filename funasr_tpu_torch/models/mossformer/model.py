"""MossFormer monaural speech separation in PyTorch (counterpart of
``funasr_tpu/models/mossformer/model.py``; FunASR ``funasr/models/mossformer/``), under
FunASR's state-dict names (``enc.conv1d``, ``mask_net.norm``, ``mask_net.conv1d_encoder``,
``mask_net.pos_enc.scale``, ``mask_net.mdl.intra_mdl.mossformerM.layers.{i}.to_hidden /
to_qk / to_out`` with ``mdl.0.g``, ``mdl.1``, ``mdl.3.sequential.1.conv``,
``qk_offset_scale.gamma`` / ``beta``, ``mask_net.mdl.intra_mdl.norm``,
``mask_net.mdl.intra_norm``, ``mask_net.prelu``, ``mask_net.conv1d_out``,
``mask_net.output.0``, ``mask_net.output_gate.0``, ``mask_net.conv1_decoder``, ``dec``),
which the JAX package's ``convert_mossformer`` reads.

* The conv encoder (k 16, stride 8, ReLU) and the transposed-conv decoder per source.
* The MaskNet: GroupNorm(1) (eps 1e-8), the 1x1 bottleneck, the scaled sinusoidal
  positions, the FLASH_ShareA_FFConvM stack, its LayerNorm (eps 1e-6), GroupNorm(1), the
  skip, PReLU, the per-speaker tanh x sigmoid-gated mask heads and the 1x1 decoder conv.
* A FLASH block: the token shift (the first half of the channels one frame late),
  ``FFConvM`` (ScaleNorm -> linear -> SiLU -> h + depthwise conv(h), k 17 with symmetric
  pads and no bias) for the hidden, qk and output projections, the 4-way offset-scale of
  the shared qk, the interleaved partial rotary embedding (the first 32 features), the
  grouped relu^2 quadratic attention with the global linear attention (padded to a
  multiple of the group, padded keys zeroed, ``:125-185``) and the u / v gating. The
  attention is no softmax and no Pallas kernel in the JAX package, so it stays plain
  PyTorch here.
* The sinusoid tables (positions and rotary) from fp32 angles as the JAX functions
  compute them, their frequencies, sines and cosines evaluated in float64 and rounded to
  fp32 (``sin_cos``), so that every device gets the same tables.
* ``FFConvM``'s conv: h + dwconv(h) is ``ops/fsmn.py::fsmn_memory(h, w, None, 8, 8)``
  exactly (the conv rounded before the residual is added, as the JAX function does): the
  FSMN kernel on CUDA (its k 17 / left 8 instantiation; three launches a block, at C =
  expansion x d, qk_dim and d), its plain version on the CPU. Training reaches its dx and
  dw kernels through ``FsmnMemoryFn``.
* ``separate``, the SI-SNR PIT ``forward`` (utterance-level over the source
  permutations) and ``inference``.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, layer_norm
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.ops.fsmn import fsmn_memory
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import as_unit_f32, load_audio_text_image_video

CONV_KERNEL = 17  # FFConvM's depthwise conv (the JAX init's only kernel)


def scale_norm(g, x, eps: float = 1e-5):
    """ScaleNorm (ref ``transformer/layer_norm.py:171-188``)."""
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True) * (x.shape[-1] ** -0.5)
    return (x / norm.clamp_min(eps) * g).to(x.dtype)


def group_norm1(norm: nn.GroupNorm, x, eps: float = 1e-8):
    """GroupNorm(1, C) over (B, S, N): stats across all (S, N) of each sample."""
    xf = x.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = xf.var((1, 2), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * norm.weight.float()
            + norm.bias.float()).to(x.dtype)


def inverse_frequencies(dim: int, device):
    """10000^(-2i/dim) for i < dim / 2 as fp32, computed in float64 and rounded once, so
    the same on every device."""
    exps = torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim
    return (1.0 / 10000 ** exps).float()


def sin_cos(angles):
    """sin and cos of fp32 angles, evaluated in float64 and rounded to fp32. A device's
    fp32 sin / cos differ from another's by an ulp or two, and MossFormer's ScaleNorm gains
    are ill-conditioned sums that amplify that ~10^3-fold in their gradients (on an H100,
    a 2-block SI-SNR step on 4 s sat 1.7e-3 from float64 with the card's own fp32 tables;
    ``chip_smoke.py`` phase 24 holds that step within 1e-4)."""
    a = angles.double()
    return torch.sin(a).float(), torch.cos(a).float()


def scaled_sinu_embedding(s: int, dim: int, scale, device, dtype=torch.float32):
    """ScaledSinuEmbedding (ref ``transformer/embedding.py:555-581``), the table from
    ``sin_cos`` of the fp32 angles."""
    sinu = (torch.arange(s, dtype=torch.float32, device=device)[:, None]
            * inverse_frequencies(dim, device)[None])
    emb = torch.cat(sin_cos(sinu), dim=-1)
    return (emb * scale).to(dtype)


def rotate_queries_or_keys(x, rot_dim: int):
    """Partial rotary embedding, rotary_embedding_torch's convention: the first
    ``rot_dim`` features rotate in interleaved pairs with per-pair frequencies
    10000^(-2i/rot_dim); positions along axis -2."""
    n = x.shape[-2]
    angles = (torch.arange(n, dtype=torch.float32, device=x.device)[:, None]
              * inverse_frequencies(rot_dim, x.device)[None])
    angles = angles.repeat_interleave(2, dim=-1)  # (n, rot_dim) interleaved pairs
    sin, cos = sin_cos(angles)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    rotated_half = torch.stack([-x_rot[..., 1::2], x_rot[..., 0::2]], dim=-1).reshape(
        x_rot.shape)
    x_rot = (x_rot * cos + rotated_half * sin).to(x.dtype)
    return torch.cat([x_rot, x_pass], dim=-1)


class ScaleNormG(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, device=device))


class FFConvM(nn.Module):
    """ScaleNorm -> linear -> SiLU -> h + depthwise conv(h) (ref ``mossformer.py:215-244``):
    ``mdl.0`` the norm, ``mdl.1`` the linear, ``mdl.3.sequential.1.conv`` the conv."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        conv_module = nn.Module()
        dw = nn.Module()
        dw.conv = nn.Conv1d(d_out, d_out, CONV_KERNEL, groups=d_out, bias=False,
                            device=device)
        conv_module.sequential = nn.ModuleList([nn.Identity(), dw])
        self.mdl = nn.ModuleList([ScaleNormG(device), nn.Linear(d_in, d_out, device=device),
                                  nn.Identity(), conv_module])

    def forward(self, x):
        h = F.silu(apply_linear(self.mdl[1], scale_norm(self.mdl[0].g, x)))
        w = self.mdl[3].sequential[1].conv.weight
        pad = (w.shape[-1] - 1) // 2
        return fsmn_memory(h, w.to(h.dtype), None, pad, pad)


class OffsetScale(nn.Module):
    def __init__(self, qk_dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(4, qk_dim, device=device))
        self.beta = nn.Parameter(torch.zeros(4, qk_dim, device=device))

    def init_from(self, generator):
        """gamma normal(1, 0.02), as the JAX init draws it."""
        with torch.no_grad():
            g = torch.randn(self.gamma.shape, device=generator.device, generator=generator)
            self.gamma.copy_((g * 0.02 + 1.0).to(self.gamma.device))


class FlashShareAFFConvM(nn.Module):
    """FLASH_ShareA_FFConvM (ref ``mossformer.py:298-422``)."""

    def __init__(self, dim: int, group_size: int, qk_dim: int, expansion: float,
                 device=None):
        super().__init__()
        self.group_size, self.qk_dim = group_size, qk_dim
        self.to_hidden = FFConvM(dim, int(dim * expansion), device)
        self.to_qk = FFConvM(dim, qk_dim, device)
        self.qk_offset_scale = OffsetScale(qk_dim, device)
        self.to_out = FFConvM(dim * 2, dim, device)

    def forward(self, x):
        b, n, d = x.shape
        # token shift: the first half of the channels one frame late (ref :314-317)
        x_shift, x_pass = x.chunk(2, dim=-1)
        x_shift = F.pad(x_shift, (0, 0, 1, 0))[:, :n]
        normed = torch.cat([x_shift, x_pass], dim=-1)

        hidden = self.to_hidden(normed)
        v, u = hidden.chunk(2, dim=-1)
        qk = self.to_qk(normed)
        osc = self.qk_offset_scale
        offset = qk[..., None, :] * osc.gamma + osc.beta  # (B, n, 4, qk)
        rot = min(32, self.qk_dim)
        quad_q, lin_q, quad_k, lin_k = (rotate_queries_or_keys(offset[..., i, :], rot)
                                        for i in range(4))

        g = self.group_size
        pad = (-n) % g
        if pad:
            quad_q, quad_k, lin_q, lin_k, v, u = (
                F.pad(t, (0, 0, 0, pad)) for t in (quad_q, quad_k, lin_q, lin_k, v, u))
        n_pad = n + pad
        valid = (torch.arange(n_pad, device=x.device) < n).to(x.dtype)

        def grp(t):
            return t.reshape(b, n_pad // g, g, t.shape[-1])

        quad_q, quad_k, lin_q, lin_k, vg, ug = map(grp, (quad_q, quad_k, lin_q, lin_k, v, u))
        lin_k = lin_k * valid.reshape(1, n_pad // g, g, 1)  # zero the padded keys (:346-348)

        # quadratic (within-group) attention: relu(sim / g)^2, padded columns zeroed
        sim = torch.einsum("bgid,bgjd->bgij", quad_q.float(), quad_k.float()) / g
        attn = (torch.relu(sim) ** 2) * valid.reshape(n_pad // g, g)[None, :, None, :]
        attn = attn.to(x.dtype)
        quad_v = torch.einsum("bgij,bgjd->bgid", attn, vg)
        quad_u = torch.einsum("bgij,bgjd->bgid", attn, ug)

        # global linear attention (non-causal, ref :412-416)
        lin_kv = torch.einsum("bgnd,bgne->bde", lin_k.float(), vg.float()) / n
        lin_v = torch.einsum("bgnd,bde->bgne", lin_q, lin_kv.to(x.dtype))
        lin_ku = torch.einsum("bgnd,bgne->bde", lin_k.float(), ug.float()) / n
        lin_u = torch.einsum("bgnd,bde->bgne", lin_q, lin_ku.to(x.dtype))

        att_v = (quad_v + lin_v).reshape(b, n_pad, -1)[:, :n]
        att_u = (quad_u + lin_u).reshape(b, n_pad, -1)[:, :n]
        out = (att_u * v[:, :n]) * torch.sigmoid(att_v * u[:, :n])
        return x + self.to_out(out)


def _conv1x1(c_in: int, c_out: int, bias: bool, device):
    return nn.Conv1d(c_in, c_out, 1, bias=bias, device=device)


def _apply1x1(conv: nn.Conv1d, x):
    """A 1x1 ``nn.Conv1d`` over x (B, S, C_in) as a linear (weight (C_out, C_in, 1))."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.linear(x, conv.weight[:, :, 0].to(x.dtype), b)


@tables.register("model_classes", "MossFormer")
@tables.register("model_classes", "MossFormer2")
class MossFormer(nn.Module):
    """ref ``e2e_ss.py:11``: encoder -> MaskNet -> per-speaker masks -> transposed-conv
    decoder."""

    def __init__(self, in_channels: int = 512, out_channels: int = 512,
                 num_blocks: int = 24, kernel_size: int = 16, norm: str = "ln",
                 num_spks: int = 2, skip_around_intra: bool = True,
                 use_global_pos_enc: bool = True, group_size: int = 256,
                 query_key_dim: int = 128, expansion_factor: float = 4.0,
                 d_model: Optional[int] = None, ffn_dim: Optional[int] = None,
                 encoder_kernel: Optional[int] = None, conv_kernel: Optional[int] = None,
                 device=None, generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        if d_model is not None:  # the legacy aliases of the JAX class
            in_channels = out_channels = d_model
        if encoder_kernel is not None:
            kernel_size = encoder_kernel
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_blocks, self.kernel_size = num_blocks, kernel_size
        self.stride = kernel_size // 2
        self.num_spks = num_spks
        self.skip_around_intra = skip_around_intra
        self.use_global_pos_enc = use_global_pos_enc
        self.group_size, self.qk_dim = group_size, query_key_dim
        self.expansion = expansion_factor
        d = out_channels

        self.enc = nn.Module()
        self.enc.conv1d = nn.Conv1d(1, in_channels, kernel_size, stride=self.stride,
                                    bias=False, device=device)
        mn = self.mask_net = nn.Module()
        mn.norm = nn.GroupNorm(1, in_channels, eps=1e-8, device=device)
        mn.conv1d_encoder = _conv1x1(in_channels, d, False, device)
        mn.pos_enc = nn.Module()
        mn.pos_enc.scale = nn.Parameter(torch.ones(1, device=device))
        mn.mdl = nn.Module()
        mn.mdl.intra_mdl = nn.Module()
        mn.mdl.intra_mdl.mossformerM = nn.Module()
        mn.mdl.intra_mdl.mossformerM.layers = nn.ModuleList([
            FlashShareAFFConvM(d, group_size, query_key_dim, expansion_factor, device)
            for _ in range(num_blocks)])
        mn.mdl.intra_mdl.norm = nn.LayerNorm(d, eps=1e-6, device=device)
        mn.mdl.intra_norm = nn.GroupNorm(1, d, eps=1e-8, device=device)
        mn.prelu = nn.PReLU(1, device=device)
        mn.conv1d_out = _conv1x1(d, d * num_spks, True, device)
        mn.output = nn.ModuleList([_conv1x1(d, d, True, device)])
        mn.output_gate = nn.ModuleList([_conv1x1(d, d, True, device)])
        mn.conv1_decoder = _conv1x1(d, in_channels, False, device)
        self.dec = nn.ConvTranspose1d(d, 1, kernel_size, stride=self.stride, bias=False,
                                      device=device)
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    @property
    def blocks(self):
        return self.mask_net.mdl.intra_mdl.mossformerM.layers

    def encode(self, wav):
        """(B, L) -> (B, S, N): conv k = 2 stride, stride s, ReLU."""
        w = self.enc.conv1d.weight.to(wav.dtype)
        return torch.relu(F.conv1d(wav[:, None], w, stride=self.stride)).transpose(1, 2)

    def mask_net_apply(self, x):
        """(B, S, N) -> (spks, B, S, N) masks (ref ``mossformer_encoder.py:170-232``)."""
        mn = self.mask_net
        h = _apply1x1(mn.conv1d_encoder, group_norm1(mn.norm, x))
        if self.use_global_pos_enc:
            h = h + scaled_sinu_embedding(h.shape[1], h.shape[2], mn.pos_enc.scale[0],
                                          h.device, h.dtype)
        intra = h
        for block in self.blocks:
            intra = block(intra)
        intra = layer_norm(intra, mn.mdl.intra_mdl.norm.weight, mn.mdl.intra_mdl.norm.bias,
                           1e-6)
        intra = group_norm1(mn.mdl.intra_norm, intra)
        if self.skip_around_intra:
            intra = intra + h
        a = mn.prelu.weight.to(intra.dtype)
        h = torch.where(intra >= 0, intra, a * intra)
        h = _apply1x1(mn.conv1d_out, h)  # (B, S, N * spks)
        b, s, _ = h.shape
        h = h.reshape(b, s, self.num_spks, self.out_channels).transpose(1, 2).reshape(
            b * self.num_spks, s, self.out_channels)
        h = torch.tanh(_apply1x1(mn.output[0], h)) * torch.sigmoid(
            _apply1x1(mn.output_gate[0], h))
        h = torch.relu(_apply1x1(mn.conv1_decoder, h))
        return h.reshape(b, self.num_spks, s, -1).transpose(0, 1)

    def separate(self, wav):
        """(B, L) -> a list of num_spks (B, L) sources (ref ``e2e_ss.py:87-113``)."""
        x = self.encode(wav)
        masks = self.mask_net_apply(x)
        w = self.dec.weight.to(wav.dtype)
        outs = []
        for spk in range(self.num_spks):
            sep = (x * masks[spk]).transpose(1, 2)  # (B, N, S)
            est = F.conv_transpose1d(sep, w, stride=self.stride)[:, 0]
            t0, t1 = wav.shape[1], est.shape[1]
            outs.append(F.pad(est, (0, max(t0 - t1, 0)))[:, :t0])
        return outs

    def forward(self, speech, speech_lengths=None, targets=None, target_lengths=None,
                **kwargs):
        """SI-SNR loss with utterance-level PIT over the sources -> (loss, {loss, si_snr},
        B) (``forward_jit``)."""
        est = torch.stack(self.separate(speech), 1)  # (B, S, L)

        def sisnr(e, r):
            e = e - e.mean(-1, keepdim=True)
            r = r - r.mean(-1, keepdim=True)
            proj = ((e * r).sum(-1, keepdim=True) / ((r * r).sum(-1, keepdim=True) + 1e-8)) * r
            noise = e - proj
            return 10 * torch.log10((proj ** 2).sum(-1) / ((noise ** 2).sum(-1) + 1e-8) + 1e-8)

        perms = list(itertools.permutations(range(self.num_spks)))
        scores = torch.stack([torch.stack([sisnr(est[:, i], targets[:, j])
                                           for i, j in enumerate(perm)]).mean(0)
                              for perm in perms])  # (P, B)
        loss = -scores.amax(0).mean()
        return loss, {"loss": loss, "si_snr": -loss}, speech.shape[0]

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        audio_list = load_audio_text_image_video(data_in, fs=16000,
                                                 audio_fs=kwargs.get("fs", 16000))
        audio_list = [as_unit_f32(a) for a in audio_list]
        maxlen = max(len(a) for a in audio_list)
        batch = np.zeros((len(audio_list), maxlen), np.float32)
        for i, a in enumerate(audio_list):
            batch[i, : len(a)] = a
        with torch.inference_mode():
            outs = self.separate(torch.from_numpy(batch).to(self.device, self.dtype))
            outs = [o.float().cpu().numpy() for o in outs]
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(audio_list))]
        return [{"key": key[i], "value": [o[i, : len(a)] for o in outs]}
                for i, a in enumerate(audio_list)], {}

