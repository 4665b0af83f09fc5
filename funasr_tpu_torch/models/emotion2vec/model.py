"""emotion2vec in PyTorch: the data2vec-2.0 audio trunk and the emotion head
(counterpart of ``funasr_tpu/models/emotion2vec/model.py``; FunASR
``funasr/models/emotion2vec/model.py:40`` and its fairseq / timm modules), under FunASR's
state-dict names (``modality_encoders.AUDIO.*``, ``blocks.{i}``, ``proj``), which the JAX
package's ``convert_emotion2vec`` reads.

The raw-waveform conv feature extractor (7 layers, no padding, LayerNorm then exact-erf
GELU after each), the feature projection, 5 grouped positional convs (k =
``conv_pos_width // conv_pos_depth``, a frame trimmed only for an even k, each followed by
a LayerNorm without affine parameters over the population variance and GELU), 10 learned
extra tokens, the symmetric ALiBi bias (``-|i - j|`` times each head's slope times its
learned scale clipped at 0; zero rows and columns for the extra tokens), the prenet's
LayerNorm, 4 prenet and 8 main post-norm blocks, the utterance mean and the linear emotion
head. LayerNorms use eps 1e-5, not the package's 1e-12; the waveform normalisation uses
the population variance (``unbiased=False``), as ``jnp.var``.

No kernel lies on this path: the JAX package computes this attention with an einsum and an
additive bias (``model.py:177-203``), outside the Pallas flash kernel, and the port's flash
kernel takes no bias; so plain PyTorch matmuls serve here, as do ``F.conv1d`` for the
convolutions (JAX's ``conv_general_dilated``).

``forward`` is the fine-tuning objective (cross-entropy on the pooled logits, with
``acc``); ``inference`` gives {"key", "labels", "scores", "feats"} per clip, "unuse"
labels masked out, ``granularity`` "utterance" (the mean frame) or "frame".
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.load_utils import as_unit_f32, load_audio_text_image_video

LN_EPS = 1e-5  # the reference's norm_eps


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi per-head slopes (reference ``base.py:608-635``)."""
    def pow2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2(n_heads), np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(pow2(closest) + extra, np.float32)


def alibi_bias(t: int, n_heads: int) -> np.ndarray:
    """Symmetric (non-causal) alibi: -|i - j| * slope, (H, T, T)."""
    pos = -np.abs(np.arange(t)[None, :] - np.arange(t)[:, None]).astype(np.float32)
    return alibi_slopes(n_heads)[:, None, None] * pos[None]


def _ln(x, norm: Optional[nn.LayerNorm]):
    """fp32 LayerNorm with eps 1e-5 (no affine parameters when ``norm`` is None)."""
    w, b = (None, None) if norm is None else (norm.weight.float(), norm.bias.float())
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, LN_EPS).to(x.dtype)


def _gelu(x):
    return F.gelu(x)  # exact erf, torch.nn.GELU's default


class AltBlock(nn.Module):
    """Post-norm block (reference ``modules.py:314``, layer_norm_first False): x +=
    attn(x); r = x = norm1(x); x = norm2(r + mlp(x))."""

    def __init__(self, d: int, heads: int, hidden: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(d, 3 * d, device=device)
        self.attn.proj = nn.Linear(d, d, device=device)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, hidden, device=device)
        self.mlp.fc2 = nn.Linear(hidden, d, device=device)

    def forward(self, x, bias):
        b, t, d = x.shape
        dk = d // self.heads
        q, k, v = apply_linear(self.attn.qkv, x).split(d, dim=-1)

        def split(y):
            return y.reshape(b, t, self.heads, dk).transpose(1, 2)

        scores = torch.matmul((split(q) * dk ** -0.5).float(), split(k).float().transpose(-1, -2))
        if bias is not None:
            scores = scores + bias
        att = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(att.float(), split(v).float())
        ctx = ctx.transpose(1, 2).reshape(b, t, d).to(x.dtype)
        x = x + apply_linear(self.attn.proj, ctx)
        r = x = _ln(x, self.norm1)
        h = apply_linear(self.mlp.fc2, _gelu(apply_linear(self.mlp.fc1, x)))
        return _ln(r + h, self.norm2)


@tables.register("model_classes", "Emotion2vec")
class Emotion2vec(nn.Module):
    FEATURE_SPEC = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2

    def __init__(self, vocab_size: int = -1, model_conf: Optional[dict] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        cfg = dict(model_conf or {})
        self.embed_dim = d = cfg.get("embed_dim", 768)
        self.depth = cfg.get("depth", 8)
        self.num_heads = cfg.get("num_heads", 12)
        self.mlp_ratio = cfg.get("mlp_ratio", 4.0)
        self.normalize = cfg.get("normalize", True)
        mod = (cfg.get("modalities") or {}).get("audio", {})
        self.prenet_depth = mod.get("prenet_depth", 4)
        self.num_extra_tokens = mod.get("num_extra_tokens", 10)
        self.conv_pos_depth = mod.get("conv_pos_depth", 5)
        self.conv_pos_width = mod.get("conv_pos_width", 95)
        self.conv_pos_groups = mod.get("conv_pos_groups", 16)
        self.use_alibi = mod.get("use_alibi_encoder", True)
        self.num_alibi_heads = mod.get("num_alibi_heads", self.num_heads)
        spec = mod.get("feature_encoder_spec")
        if isinstance(spec, str):
            # the reference stores a python expression ("[(512,10,5)] + ... * 4");
            # evaluated with no builtins reachable, as the JAX package does
            spec = eval(spec, {"__builtins__": {}})  # noqa: S307
        if spec is not None:
            self.FEATURE_SPEC = [tuple(s) for s in spec]
        self.vocab_size = vocab_size
        self.feat_dim = fd = self.FEATURE_SPEC[-1][0]
        self.k_pos = max(3, self.conv_pos_width // self.conv_pos_depth)
        hidden = int(d * self.mlp_ratio)

        # the reference's nn.Sequential stacks as ModuleLists (children named 0, 1, ...), a
        # parameterless slot an nn.Identity, so that the state-dict names are FunASR's
        audio = nn.Module()
        audio.local_encoder = nn.Module()
        layers, c_in = [], 1
        for c_out, k, s in self.FEATURE_SPEC:
            layers.append(nn.ModuleList([nn.Conv1d(c_in, c_out, k, stride=s, bias=False,
                                            device=device), nn.Identity(),
                                  nn.ModuleList([nn.Identity(), nn.LayerNorm(c_out, eps=LN_EPS,
                                                                      device=device)])]))
            c_in = c_out
        audio.local_encoder.conv_layers = nn.ModuleList(layers)
        audio.project_features = nn.ModuleList([nn.Identity(),
                                         nn.LayerNorm(fd, eps=LN_EPS, device=device),
                                         nn.Linear(fd, d, device=device)])
        audio.relative_positional_encoder = nn.ModuleList(
            [nn.Identity()] + [nn.ModuleList([nn.Conv1d(d, d, self.k_pos, padding=self.k_pos // 2,
                                                 groups=self.conv_pos_groups, device=device)])
                               for _ in range(self.conv_pos_depth)])
        audio.extra_tokens = nn.Parameter(torch.zeros(1, self.num_extra_tokens, d,
                                                      device=device))
        audio.alibi_scale = nn.Parameter(torch.ones(1, 1, self.num_alibi_heads, 1, 1,
                                                    device=device))
        audio.context_encoder = nn.Module()
        audio.context_encoder.norm = nn.LayerNorm(d, eps=LN_EPS, device=device)
        audio.context_encoder.blocks = nn.ModuleList(
            [AltBlock(d, self.num_heads, hidden, device) for _ in range(self.prenet_depth)])
        self.modality_encoders = nn.ModuleDict({"AUDIO": audio})
        self.blocks = nn.ModuleList([AltBlock(d, self.num_heads, hidden, device)
                                     for _ in range(self.depth)])
        self.proj = nn.Linear(d, vocab_size, device=device) if vocab_size > 0 else None
        if generator is not None:
            init_weights(self, generator)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    @property
    def audio(self):
        return self.modality_encoders["AUDIO"]

    def _local_features(self, source):
        """(B, N) raw waveform -> (B, T, embed_dim)."""
        x = source[:, None]  # (B, 1, N)
        for layer in self.audio.local_encoder.conv_layers:
            conv = layer[0]
            x = F.conv1d(x, conv.weight.to(x.dtype), stride=conv.stride)
            x = _gelu(_ln(x.transpose(1, 2).float(), layer[2][1])).transpose(1, 2)
        x = x.transpose(1, 2)
        pf = self.audio.project_features
        return apply_linear(pf[2], _ln(x, pf[1]))

    def _positional(self, x):
        h = x
        for layer in list(self.audio.relative_positional_encoder)[1:]:
            conv = layer[0]
            h = F.conv1d(h.transpose(1, 2), conv.weight.to(h.dtype), conv.bias.to(h.dtype),
                         padding=conv.padding, groups=conv.groups).transpose(1, 2)
            if self.k_pos % 2 == 0:  # SamePad trims the extra frame for even kernels
                h = h[:, :-1]
            hf = h.float()  # LayerNorm without affine parameters, population variance
            mean = hf.mean(-1, keepdim=True)
            var = hf.var(-1, keepdim=True, unbiased=False)
            h = _gelu(((hf - mean) * torch.rsqrt(var + LN_EPS)).to(h.dtype))
        return h

    def extract_features(self, source):
        """(B, N) raw 16 kHz waveform -> (B, T, D) frame features (the extra tokens
        removed)."""
        x = self._local_features(source)
        x = x + self._positional(x)
        b, t, d = x.shape
        num = self.num_extra_tokens
        bias = None
        if self.use_alibi:
            ab = torch.from_numpy(alibi_bias(t, self.num_alibi_heads)).to(x.device)[None]
            # clipped at 0 as jnp.clip, whose gradient at a scale of exactly 0 is halved
            s = self.audio.alibi_scale.float()
            scale = torch.maximum(s, torch.zeros_like(s)).reshape(1, self.num_alibi_heads, 1, 1)
            bias = F.pad(ab * scale, (num, 0, num, 0))
        x = torch.cat([self.audio.extra_tokens.to(x.dtype).expand(b, num, d), x], dim=1)
        x = _ln(x, self.audio.context_encoder.norm)
        for block in self.audio.context_encoder.blocks:
            x = block(x, bias)
        for block in self.blocks:
            x = block(x, bias)
        return x[:, num:]

    def _normalized(self, speech):
        if not self.normalize:
            return speech
        mean = speech.mean(-1, keepdim=True)
        var = speech.var(-1, keepdim=True, unbiased=False)
        return (speech - mean) * torch.rsqrt(var + 1e-5)

    def forward(self, speech, speech_lengths, labels, label_lengths, generator=None,
                **kwargs):
        """Cross-entropy on the utterance-pooled emotion logits -> (loss, stats with
        ``acc``, B) (``forward_jit``)."""
        feats = self.extract_features(self._normalized(speech))
        logits = apply_linear(self.proj, feats.mean(1))
        logp = torch.log_softmax(logits.float(), -1)
        tgt = labels.reshape(-1).long()
        loss = -logp.gather(-1, tgt[:, None]).mean()
        acc = (logits.argmax(-1) == tgt).float().mean()
        return loss, {"loss": loss, "acc": acc}, speech.shape[0]

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(
            data_in, fs=16000, audio_fs=kwargs.get("fs", 16000),
            data_type=kwargs.get("data_type", "sound"))
        audio_list = [as_unit_f32(a) for a in audio_list]
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        meta["batch_data_time"] = sum(len(a) for a in audio_list) / 16000.0

        granularity = kwargs.get("granularity", "utterance")
        extract_embedding = kwargs.get("extract_embedding", True)
        labels = tokenizer.token_list if tokenizer is not None else []
        unuse = [str(lb).startswith("unuse") for lb in labels]
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(audio_list))]
        results = []
        for i, wav in enumerate(audio_list):
            with torch.inference_mode():
                source = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
                x = self.extract_features(self._normalized(source)[None].to(self.dtype))
                logits = (apply_linear(self.proj, x[0].mean(0)).float()
                          if self.proj is not None else None)
                feats = x[0].float().cpu().numpy()
                logits = None if logits is None else logits.cpu().numpy()
            feats_out = feats.mean(axis=0) if granularity == "utterance" else feats
            scores: List[float] = []
            if logits is not None:
                logits[np.asarray(unuse, bool)[: len(logits)]] = -np.inf
                ex = np.exp(logits - logits.max())
                scores = (ex / ex.sum()).tolist()
            row = {"key": key[i], "labels": [lb for lb, u in zip(labels, unuse) if not u],
                   "scores": [scores[j] for j, u in enumerate(unuse) if not u] if scores
                   else []}
            if extract_embedding:
                row["feats"] = feats_out
            results.append(row)
        return results, meta
