"""data2vec audio SSL pretraining in PyTorch (counterpart of
``funasr_tpu/models/data2vec/model.py``; FunASR ``funasr/models/data2vec/``, fairseq
lineage), under FunASR's state-dict names (``feature_extractor.conv_layers.{i}``,
``layer_norm``, ``post_extract_proj``, ``mask_emb``, ``encoder.pos_conv.0.weight_g`` /
``weight_v`` / ``bias``, ``encoder.layers.{i}.self_attn.{q,k,v,out}_proj``,
``self_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``, ``encoder.layer_norm``,
``final_proj``), which the JAX package's ``convert_data2vec`` reads.

* The conv feature extractor (no bias) in both ``extractor_mode``s: "default" with
  ``Fp32GroupNorm(dim, dim)`` on layer 0 only (per channel over time), "layer_norm" with
  a LayerNorm after every conv; exact-erf GELU after each.
* The positional conv: grouped (k 128, 16 groups at the defaults), padding k // 2, the
  trailing frame trimmed for an even k (SamePad), GELU. Its weight is stored under the
  weight-norm names and computed as w = g * v / ||v|| (the norm over all but the tap
  axis), as ``convert_data2vec`` folds it; ``torch.nn.utils.parametrizations.weight_norm``
  is not used, since it renames the keys.
* fairseq post-norm layers (LayerNorm eps 1e-5, exact-erf GELU); T padded to
  ``required_seq_len_multiple`` with the pad rows invalid. The attention is
  softmax(QK^T / sqrt(D)) V under the key-padding mask: ``ops/flash_attention.py::
  flash_attention`` in mode "none" with the frame lengths, the flash kernel on CUDA (12
  heads x 64 at base width). The kernel scales by 1 / sqrt(D), so it takes the unscaled
  q projection where the JAX package scales q after the projection: the two differ in
  rounding only. A row of length 0 (a wave shorter than the conv stack's receptive field)
  would average V where the JAX package gives 0; no caller makes one.
* Pretraining (``Data2VecPretrainModel.forward``): masked spans of the student's input
  take ``mask_emb``; the EMA teacher (``ema``, a copy of the transformer whose parameters
  take no gradient) encodes the unmasked features without grad, and the average of its
  top-K layers' FFN outputs (with the instance / layer-norm target options) is the
  regression target of ``final_proj`` on the masked frames (MSE, or smooth L1 at
  ``loss_beta``). ``ema_update`` steps the teacher with the annealed decay, copying
  ``pos_conv`` through. ``sample_mask`` draws spans from an explicit ``torch.Generator``
  with the statistics of the JAX package's bernoulli-and-dilate sampler (it cannot equal
  JAX's PRNG bit for bit: parity passes ``mask_indices``).
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear, layer_norm, make_pad_mask
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.ops.flash_attention import flash_attention
from funasr_tpu_torch.register import tables

DEFAULT_CONV_LAYERS = "[(512,2,2)] + [(512,2,2)]"
LN_EPS = 1e-5  # fairseq's LayerNorm / GroupNorm eps


def _parse_conv_layers(spec) -> List[Tuple[int, int, int]]:
    if isinstance(spec, str):
        # the reference evals this config string (data2vec_encoder.py:167), with no
        # builtins reachable, as the JAX package does
        return list(eval(spec, {"__builtins__": {}}))  # noqa: S307
    return [tuple(l) for l in spec]


def _ln(x, norm: nn.LayerNorm):
    return layer_norm(x, norm.weight, norm.bias, LN_EPS)


def _gelu(x):
    return F.gelu(x)  # exact erf


def get_annealed_rate(start, end, curr_step, total_steps):
    """ref ``data2vec_encoder.py:24``."""
    r = end - start
    pct_remaining = 1 - curr_step / total_steps
    return end - r * pct_remaining


def _norm_over(x, dim):
    """(x - mean) * rsqrt(var + 1e-5) over ``dim``, population variance."""
    mean = x.mean(dim, keepdim=True)
    var = x.var(dim, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class WeightNormConv(nn.Module):
    """A grouped Conv1d kept as FunASR's ``weight_norm(dim=2)`` tensors: ``weight_g``
    (1, 1, K), ``weight_v`` (C_out, C_in / groups, K), ``bias`` (C_out,)."""

    def __init__(self, d: int, k: int, groups: int, device=None):
        super().__init__()
        self.k, self.groups = k, groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, k, device=device))
        self.weight_v = nn.Parameter(torch.zeros(d, d // groups, k, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def weight(self):
        """w = g * v / ||v|| (``convert_data2vec``'s fold, ``torch_to_jax.py:984-987``)."""
        v = self.weight_v.float()
        norm = v.pow(2).sum((0, 1), keepdim=True).sqrt()
        return v * (self.weight_g.float() / norm.clamp_min(1e-12))

    def init_from(self, generator):
        """normal(0, sqrt(4 / (k d))) for v and g = ||v|| (w = v), zero bias (the JAX
        init's distribution for w)."""
        d = self.weight_v.shape[0]
        v = torch.randn(self.weight_v.shape, device=generator.device, generator=generator)
        v = v * math.sqrt(4.0 / (self.k * d))
        with torch.no_grad():
            self.weight_v.copy_(v.to(self.weight_v.device))
            g = v.pow(2).sum((0, 1), keepdim=True).sqrt()
            self.weight_g.copy_(g.to(self.weight_g.device))
            self.bias.zero_()

    def forward(self, x):
        """x (B, T, D) -> GELU(SamePad(conv(x))) (B, T, D)."""
        out = F.conv1d(x.transpose(1, 2), self.weight().to(x.dtype), self.bias.to(x.dtype),
                       padding=self.k // 2, groups=self.groups).transpose(1, 2)
        if self.k % 2 == 0:
            out = out[:, :-1]
        return _gelu(out)


class EncoderLayer(nn.Module):
    """fairseq post-norm layer (ref ``wav2vec2.py:472-495``)."""

    def __init__(self, d: int, ffn: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d, device=device))
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(d, ffn, device=device)
        self.fc2 = nn.Linear(ffn, d, device=device)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS, device=device)

    def forward(self, x, lengths):
        """-> (block output, FFN output)."""
        b, t, d = x.shape
        att = self.self_attn

        def heads(z):
            return z.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)

        q, k, v = (heads(apply_linear(getattr(att, n), x))
                   for n in ("q_proj", "k_proj", "v_proj"))
        ctx = flash_attention(q, k, v, lengths).transpose(1, 2).reshape(b, t, d)
        x = _ln(x + apply_linear(att.out_proj, ctx), self.self_attn_layer_norm)
        ffn = apply_linear(self.fc2, _gelu(apply_linear(self.fc1, x)))
        return _ln(x + ffn, self.final_layer_norm), ffn


class TransformerEncoder(nn.Module):
    """``pos_conv``, the layers and the encoder LayerNorm (ref ``wav2vec2.py:152-367``)."""

    def __init__(self, d: int, ffn: int, heads: int, n_layers: int, conv_pos: int,
                 conv_pos_groups: int, layer_norm_first: bool, seq_multiple: int,
                 device=None):
        super().__init__()
        self.layer_norm_first, self.seq_multiple = layer_norm_first, seq_multiple
        self.pos_conv = nn.ModuleList([WeightNormConv(d, conv_pos, conv_pos_groups, device)])
        self.layers = nn.ModuleList([EncoderLayer(d, ffn, heads, device)
                                     for _ in range(n_layers)])
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS, device=device)

    def extract_features(self, x, valid, min_layer: int = 0):
        """x (B, T, D), valid (B, T) bool -> (x, [(block out, FFN out)] of layers >=
        ``min_layer``) (``encoder_extract_features``)."""
        x = x * valid[..., None].to(x.dtype)
        x = x + self.pos_conv[0](x)
        if not self.layer_norm_first:
            x = _ln(x, self.layer_norm)
        t = x.shape[1]
        pad_len = (-t) % self.seq_multiple
        if pad_len:  # the pad rows are invalid keys
            x = F.pad(x, (0, 0, 0, pad_len))
        lengths = valid.sum(-1).to(torch.int32)
        results = []
        for i, layer in enumerate(self.layers):
            x, ffn = layer(x, lengths)
            if i >= min_layer:
                results.append((x, ffn))
        if pad_len:
            x = x[:, :t]
            results = [(a[:, :t], f[:, :t]) for a, f in results]
        if self.layer_norm_first:
            x = _ln(x, self.layer_norm)
        return x, results


@tables.register("encoder_classes", "Data2VecEncoder")
class Data2VecEncoder(nn.Module):
    """ref ``data2vec_encoder.py:38``."""

    def __init__(self, input_size: Optional[int] = None, extractor_mode: str = "default",
                 conv_feature_layers: str = DEFAULT_CONV_LAYERS,
                 layer_norm_first: bool = False, encoder_layers: int = 12,
                 encoder_embed_dim: int = 768, encoder_ffn_embed_dim: int = 3072,
                 encoder_attention_heads: int = 12, activation_fn: str = "gelu",
                 mask_prob: float = 0.65, mask_length: int = 10,
                 require_same_masks: bool = True, conv_pos: int = 128,
                 conv_pos_groups: int = 16, pos_conv_depth: int = 1,
                 average_top_k_layers: int = 8, layer_norm_target_layer: bool = False,
                 instance_norm_target_layer: bool = False,
                 instance_norm_targets: bool = False, layer_norm_targets: bool = False,
                 ema_decay: float = 0.999, ema_end_decay: float = 0.9999,
                 ema_anneal_end_step: int = 100000, min_target_var: float = 0.1,
                 min_pred_var: float = 0.01, loss_beta: float = 0.0,
                 loss_scale: Optional[float] = None, required_seq_len_multiple: int = 2,
                 device=None, generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        assert extractor_mode in ("default", "layer_norm")
        assert activation_fn == "gelu", "data2vec uses gelu"
        assert pos_conv_depth == 1, "stacked pos_conv not used by data2vec audio"
        self.input_size = input_size or 1
        self.extractor_mode = extractor_mode
        self.conv_layers = _parse_conv_layers(conv_feature_layers)
        self.extractor_embed = self.conv_layers[-1][0]
        self.encoder_layers = encoder_layers
        self.encoder_embed_dim = d = encoder_embed_dim
        self.mask_prob, self.mask_length = mask_prob, mask_length
        self.require_same_masks = require_same_masks
        self.average_top_k_layers = average_top_k_layers
        self.layer_norm_target_layer = layer_norm_target_layer
        self.instance_norm_target_layer = instance_norm_target_layer
        self.instance_norm_targets = instance_norm_targets
        self.layer_norm_targets = layer_norm_targets
        self.ema_decay, self.ema_end_decay = ema_decay, ema_end_decay
        self.ema_anneal_end_step = ema_anneal_end_step
        self.min_target_var, self.min_pred_var = min_target_var, min_pred_var
        self.loss_beta, self.loss_scale = loss_beta, loss_scale

        # the reference's nn.Sequential stacks as ModuleLists, parameterless slots as
        # nn.Identity, so that the state-dict names are FunASR's
        layers, c_in = [], self.input_size
        for i, (dim, k, s) in enumerate(self.conv_layers):
            conv = nn.Conv1d(c_in, dim, k, stride=s, bias=False, device=device)
            if extractor_mode == "layer_norm":
                norm = nn.ModuleList([nn.Identity(), nn.LayerNorm(dim, eps=LN_EPS,
                                                                  device=device)])
            elif i == 0:
                norm = nn.GroupNorm(dim, dim, eps=LN_EPS, device=device)
            else:
                norm = nn.Identity()
            layers.append(nn.ModuleList([conv, nn.Identity(), norm]))
            c_in = dim
        self.feature_extractor = nn.Module()
        self.feature_extractor.conv_layers = nn.ModuleList(layers)
        self.layer_norm = nn.LayerNorm(self.extractor_embed, eps=LN_EPS, device=device)
        self.post_extract_proj = nn.Linear(self.extractor_embed, d, device=device)
        self.mask_emb = nn.Parameter(torch.zeros(d, device=device))
        self.encoder = TransformerEncoder(d, encoder_ffn_embed_dim, encoder_attention_heads,
                                          encoder_layers, conv_pos, conv_pos_groups,
                                          layer_norm_first, required_seq_len_multiple, device)
        self.final_proj = nn.Linear(d, d, device=device)
        if generator is not None:
            init_weights(self, generator)

    def init_from(self, generator):
        """``mask_emb`` uniform in [0, 1), as the JAX init draws it."""
        with torch.no_grad():
            self.mask_emb.copy_(torch.rand(self.mask_emb.shape, device=generator.device,
                                           generator=generator).to(self.mask_emb.device))

    def output_size(self) -> int:
        return self.encoder_embed_dim

    def feature_extract(self, x):
        """(B, N) raw (or (B, N, F)) -> (B, T', C) (ref ``wav2vec2.py:19-123``)."""
        x = x[:, None] if x.dim() == 2 else x.transpose(1, 2)  # (B, C_in, N)
        for layer, (_, _, s) in zip(self.feature_extractor.conv_layers, self.conv_layers):
            conv, norm = layer[0], layer[2]
            x = F.conv1d(x, conv.weight.to(x.dtype), stride=s)
            if isinstance(norm, nn.ModuleList):  # LayerNorm over channels
                x = _ln(x.transpose(1, 2), norm[1]).transpose(1, 2)
            elif isinstance(norm, nn.GroupNorm):  # per channel over time, fp32
                xf = x.float()
                x = (_norm_over(xf, -1) * norm.weight.float()[:, None]
                     + norm.bias.float()[:, None]).to(x.dtype)
            x = _gelu(x)
        return x.transpose(1, 2)

    def feat_extract_output_length(self, input_length):
        for (_, k, s) in self.conv_layers:
            input_length = torch.div(input_length - k, s, rounding_mode="floor") + 1
        return input_length

    def sample_mask(self, generator: torch.Generator, b: int, t: int, lengths=None):
        """Span masking: span starts drawn at rate mask_prob / mask_length from
        ``generator`` (on the device of the mask), each dilated to mask_length frames
        forward with wrap-around; frames at or past ``lengths`` unmasked. The JAX
        sampler's statistics (``sample_mask``), not its PRNG stream."""
        dev = generator.device
        starts = torch.rand((b, t), generator=generator, device=dev) < (
            self.mask_prob / self.mask_length)
        mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        for i in range(self.mask_length):
            mask = mask | torch.roll(starts, i, dims=1)
        if lengths is not None:
            mask = mask & make_pad_mask(lengths.to(dev), t)
        return mask

    def front(self, feats, lens=None):
        """The conv front, its LayerNorm and projection -> (features (B, T, D), out_lens,
        valid (B, T) bool)."""
        features = _ln(self.feature_extract(feats), self.layer_norm)
        b, t = features.shape[:2]
        if lens is not None:
            out_lens = self.feat_extract_output_length(lens.to(features.device))
            valid = make_pad_mask(out_lens, t)
        else:
            out_lens = torch.full((b,), t, dtype=torch.int32, device=features.device)
            valid = torch.ones(b, t, dtype=torch.bool, device=features.device)
        return apply_linear(self.post_extract_proj, features), out_lens, valid

    def forward(self, feats, lens=None, *, mask=True, features_only=False,
                mask_indices=None, teacher=None, generator=None, num_updates: int = 0):
        """(ref ``data2vec_encoder.py:413-623``): ``features_only`` -> (x, out_lens); else
        the regression loss against ``teacher`` (the EMA transformer)'s targets -> dict
        with ``losses``, ``sample_size``, ``x``, ``mask_indices``, ``target_var``,
        ``pred_var``, ``ema_decay``."""
        features, out_lens, valid = self.front(feats, lens)
        if mask:
            if mask_indices is None:
                mask_indices = self.sample_mask(generator, features.shape[0],
                                                features.shape[1], out_lens)
            mask_indices = mask_indices.to(features.device)
            x = torch.where(mask_indices[..., None], self.mask_emb.to(features.dtype),
                            features)
        else:
            x = features
        x, _ = self.encoder.extract_features(x, valid)
        if features_only:
            return x, out_lens

        assert teacher is not None, "the pretraining forward needs the EMA teacher"
        with torch.no_grad():
            _, teacher_layers = teacher.extract_features(
                features.detach(), valid,
                min_layer=self.encoder_layers - self.average_top_k_layers)
            targets = [f.float() for _, f in teacher_layers]
            if self.instance_norm_target_layer:  # F.instance_norm over (B, C, T): time
                targets = [_norm_over(tl, 1) for tl in targets]
            if self.layer_norm_target_layer:
                targets = [_norm_over(tl, -1) for tl in targets]
            y = sum(targets) / len(targets)
            if self.layer_norm_targets:
                y = _norm_over(y, -1)
            if self.instance_norm_targets:
                y = _norm_over(y, 1)

        pred = apply_linear(self.final_proj, x).float()
        diff = pred - y
        if self.loss_beta == 0:
            per_tok = (diff * diff).sum(-1)
        else:
            beta = self.loss_beta
            per_tok = torch.where(diff.abs() < beta, 0.5 * diff * diff / beta,
                                  diff.abs() - 0.5 * beta).sum(-1)
        scale = (self.loss_scale if self.loss_scale is not None
                 else 1.0 / math.sqrt(pred.shape[-1]))
        m = mask_indices.float()
        loss_sum = (per_tok * m).sum() * scale
        sample_size = m.sum().clamp_min(1.0)

        def masked_var(z):
            # sqrt(var over the masked frames per dim + 1e-6), mean over dims
            w = m[..., None]
            cnt = m.sum().clamp_min(2.0)
            mu = (z * w).sum((0, 1)) / cnt
            var = (((z - mu) ** 2) * w).sum((0, 1)) / (cnt - 1)
            return torch.sqrt(var + 1e-6).mean()

        return {"losses": {"regression": loss_sum}, "sample_size": sample_size, "x": x,
                "mask_indices": mask_indices, "target_var": masked_var(y).detach(),
                "pred_var": masked_var(pred.detach()),
                "ema_decay": self.annealed_decay(num_updates) * 1000}

    def annealed_decay(self, num_updates) -> float:
        if self.ema_decay == self.ema_end_decay:
            return self.ema_decay
        if num_updates >= self.ema_anneal_end_step:
            return self.ema_end_decay
        return get_annealed_rate(self.ema_decay, self.ema_end_decay, num_updates,
                                 self.ema_anneal_end_step)


@tables.register("model_classes", "Data2VecPretrainModel")
@tables.register("model_classes", "Data2VecAudio")
@tables.register("model_classes", "data2vec")
class Data2VecPretrainModel(nn.Module):
    """ref ``data2vec.py:38``: loss = regression loss sum / sample_size. The student is
    ``encoder`` (FunASR's names); the EMA teacher is ``ema``, a copy of the student's
    transformer (``encoder.encoder``) whose parameters take no gradient; a state dict
    without ``ema.*`` (a FunASR checkpoint) loads the student's transformer into it, as
    ``convert_data2vec`` builds the JAX teacher. Call ``ema_update`` between steps."""

    def __init__(self, encoder: str = "Data2VecEncoder", encoder_conf: Optional[dict] = None,
                 input_size: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        conf = dict(encoder_conf or {})
        if input_size is not None:
            conf.setdefault("input_size", input_size)
        self.encoder = tables.encoder_classes[encoder](device=device, generator=generator,
                                                       **conf)
        self.ema = copy.deepcopy(self.encoder.encoder).requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if not any(k.startswith("ema.") for k in state_dict):
            pre = "encoder.encoder."
            state_dict = dict(state_dict, **{"ema." + k[len(pre):]: v
                                             for k, v in state_dict.items()
                                             if k.startswith(pre)})
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def forward(self, speech, speech_lengths=None, mask_indices=None, generator=None,
                num_updates: int = 0, **kwargs):
        """-> (loss, stats {loss, target_var, pred_var, ema_decay, masked_frames},
        sample_size) (``forward_jit``)."""
        result = self.encoder(speech, speech_lengths, mask=True, mask_indices=mask_indices,
                              teacher=self.ema, generator=generator, num_updates=num_updates)
        loss = sum(result["losses"].values()) / result["sample_size"]
        stats = {"loss": loss.detach(), "target_var": result["target_var"],
                 "pred_var": result["pred_var"], "ema_decay": result["ema_decay"],
                 "masked_frames": result["mask_indices"].sum()}
        return loss, stats, result["sample_size"]

    def extract_features(self, speech, speech_lengths=None):
        return self.encoder(speech, speech_lengths, mask=False, features_only=True)

    @torch.no_grad()
    def ema_update(self, num_updates: int = 0):
        """teacher <- decay * teacher + (1 - decay) * student transformer, the annealed
        decay schedule (ref ``data2vec_encoder.py:288-310``); ``pos_conv`` copied through
        (``make_ema_teacher``'s skip_keys)."""
        d = self.encoder.annealed_decay(num_updates)
        student = dict(self.encoder.encoder.named_parameters())
        for name, p in self.ema.named_parameters():
            s = student[name]
            p.copy_(s if name.startswith("pos_conv.") else d * p + (1 - d) * s)
