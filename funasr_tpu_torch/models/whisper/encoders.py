"""Whisper-tower audio encoders under the reference's encoder names, in PyTorch
(counterpart of ``funasr_tpu/models/whisper/encoders.py``):

- ``OpenAIWhisperEncoderWarp`` (reference ``funasr/models/whisper_lid/encoder.py:18``): a
  whisper encoder as it is: conv1 (k 3) + GELU, conv2 (k 3, stride 2) + GELU, fixed
  sinusoids, pre-norm blocks, ``ln_post``; the audio tower of LLM-ASR configs;
- ``QwenAudioEncoder`` (reference ``funasr/models/qwen_audio/audio.py:406``): the same
  tower, then AvgPool1d(2) over time, ``ln_post``, a projection to the LLM's width and a
  2-row bos / eos table (its checkpoint tensor; nothing in the family reads it).

Both take (B, T, n_mels) log-mel features and respect padding: padded frames are zeroed
and masked out of attention as keys (reference ``audio.py:475-492``). Parameter names are
OpenAI whisper's (``blocks.N.attn.{query, key, value, out}``, ``attn_ln``, ``mlp.0``,
``mlp.2``, ``mlp_ln``, ``ln_post``), which ``funasr_tpu/convert/torch_to_jax.py::
convert_whisper_tower`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, apply_linear, make_pad_mask
from funasr_tpu_torch.models.whisper.model import SIZES, attend, conv_gelu, heads, sinusoids
from funasr_tpu_torch.register import tables


class TowerAttention(nn.Module):
    def __init__(self, d: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, bias=False, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, x, mask):
        h = self.n_head
        ctx = attend(heads(apply_linear(self.query, x), h), heads(apply_linear(self.key, x), h),
                     heads(apply_linear(self.value, x), h), mask, x.dtype)
        return apply_linear(self.out, ctx)


class TowerBlock(nn.Module):
    def __init__(self, d: int, n_head: int, device=None):
        super().__init__()
        self.attn = TowerAttention(d, n_head, device)
        self.attn_ln = LayerNorm(d, device=device)
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d, device=device), nn.GELU(),
                                 nn.Linear(4 * d, d, device=device))
        self.mlp_ln = LayerNorm(d, device=device)

    def forward(self, h, mask):
        h = h + self.attn(self.attn_ln(h), mask)
        x = self.mlp_ln(h)
        return h + apply_linear(self.mlp[2], F.gelu(apply_linear(self.mlp[0], x)))


class WhisperTower(nn.Module):
    def __init__(self, n_mels: int, n_state: int, n_head: int, n_layer: int, n_ctx: int,
                 device=None):
        super().__init__()
        self.n_state, self.n_ctx = n_state, n_ctx
        self.conv1 = nn.Conv1d(n_mels, n_state, 3, device=device)
        self.conv2 = nn.Conv1d(n_state, n_state, 3, device=device)
        self.blocks = nn.ModuleList([TowerBlock(n_state, n_head, device) for _ in range(n_layer)])
        self.ln_post = LayerNorm(n_state, device=device)

    def output_len(self, ilens):
        return (ilens + 1) // 2

    def tower(self, mel, ilens, final_norm: bool = True):
        """mel (B, T, n_mels), ilens in mel frames -> ((B, T // 2, n_state), olens)."""
        h = conv_gelu(conv_gelu(mel.to(self.conv1.weight.dtype), self.conv1), self.conv2,
                      stride=2)
        t = h.shape[1]
        pos = torch.from_numpy(sinusoids(max(t, self.n_ctx), self.n_state)[:t]).to(h.device)
        h = h + pos.to(h.dtype)
        olens = mask = None
        if ilens is not None:
            olens = (ilens + 1) // 2
            valid = make_pad_mask(olens, t)
            h = torch.where(valid[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))
            mask = valid[:, None, None, :]
        for block in self.blocks:
            h = block(h, mask)
        return (self.ln_post(h) if final_norm else h), olens


@tables.register("encoder_classes", "OpenAIWhisperEncoderWarp")
class OpenAIWhisperEncoderWarp(WhisperTower):
    """``whisper_model`` picks the OpenAI size ("small", "large-v3", ...); the dims can
    be given instead (n_mels / n_state / n_head / n_layer)."""

    def __init__(self, whisper_model: str = "small", n_mels: int = None, n_state: int = None,
                 n_head: int = None, n_layer: int = None, n_ctx: int = 1500, device=None,
                 **kwargs):
        size = (whisper_model if whisper_model.startswith("whisper-")
                else f"whisper-{whisper_model}")
        conf = dict(d_model=1280, encoder_layers=32, encoder_attention_heads=20,
                    num_mel_bins=128)
        conf.update(SIZES.get(size, {}))
        super().__init__(n_mels or conf.get("num_mel_bins", 80), n_state or conf["d_model"],
                         n_head or conf["encoder_attention_heads"],
                         n_layer or conf["encoder_layers"], n_ctx, device)

    def output_size(self):
        return self.n_state

    def forward(self, xs_pad, ilens):
        return self.tower(xs_pad, ilens)


@tables.register("encoder_classes", "QwenAudioEncoder")
class QwenAudioEncoder(WhisperTower):
    def __init__(self, n_mels: int = 80, n_ctx: int = 1500, n_state: int = 1280,
                 n_head: int = 20, n_layer: int = 32, output_dim: int = 4096,
                 avg_pool: bool = True, add_audio_bos_eos_token: bool = True, device=None,
                 **kwargs):
        super().__init__(n_mels, n_state, n_head, n_layer, n_ctx, device)
        self.out_dim = output_dim
        self.avg_pool = avg_pool
        self.proj = nn.Linear(n_state, output_dim, device=device)
        if add_audio_bos_eos_token:
            self.audio_bos_eos_token = nn.Embedding(2, output_dim, device=device)

    def output_size(self):
        return self.out_dim

    def output_len(self, ilens):
        n = (ilens + 1) // 2
        return n // 2 if self.avg_pool else n

    def forward(self, xs_pad, ilens):
        # ln_post after the pooling (reference audio.py:495-501)
        h, olens = self.tower(xs_pad, ilens, final_norm=False)
        if self.avg_pool:
            t2 = (h.shape[1] // 2) * 2
            h = h[:, :t2].reshape(h.shape[0], t2 // 2, 2, -1).mean(dim=2)
            olens = None if olens is None else olens // 2
        h = self.ln_post(h)
        return apply_linear(self.proj, h), olens
