"""Whisper ASR in PyTorch (counterpart of ``funasr_tpu/models/whisper/model.py``; FunASR
``funasr/models/whisper/model.py:20-190`` wraps openai-whisper).

Encoder: conv1d (k 3) + GELU, conv1d (k 3, stride 2) + GELU, fixed sinusoidal positions,
pre-norm blocks, a final LayerNorm. Decoder: token + learned position embeddings, causal
self-attention and cross-attention blocks, the tied head. Parameter names are Hugging
Face ``WhisperForConditionalGeneration``'s (``model.encoder.layers.N.self_attn.q_proj``,
``k_proj`` without a bias, ...), so ``funasr_tpu/models/whisper/model.py::
convert_hf_whisper`` maps this module's ``state_dict()`` into the JAX params and a
Hugging Face checkpoint loads with ``load_state_dict`` (its tied ``proj_out.weight`` is
dropped). Every size of ``SIZES`` registers under the JAX package's names.

Attention is plain PyTorch, as the JAX package computes it with einsums outside any
Pallas kernel: fp32 scores, the masked softmax in the activations' dtype
(``core/layers.py::masked_softmax``). ``greedy_decode`` is the cached decode: cross-K / V
once an utterance (``cross_kv``), self-K / V written a step at a time (``cached_step``),
one host fetch of the next ids a step, as in JAX; ``greedy_decode_prefix`` is the
full-prefix oracle it must equal. ``forward`` is the training loss on mel features (the
JAX ``forward_jit``); the encoder's fixed sinusoids take no gradient, a constant in JAX.
The JAX ``WhisperFrontend`` has no batched ``_pipeline``, so its trainer cannot run
Whisper from waveforms, and the port's trains it on given features only.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import LayerNorm, apply_linear, conv1d, masked_softmax
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.parallel.sharding import global_count
from funasr_tpu_torch.register import tables
from funasr_tpu_torch.utils.bucket import bucket_length


class WhisperConfig(NamedTuple):
    vocab_size: int = 51866
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448


SIZES = {
    "whisper-tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4,
                         encoder_attention_heads=6, decoder_attention_heads=6,
                         encoder_ffn_dim=1536, decoder_ffn_dim=1536,
                         num_mel_bins=80, vocab_size=51865),
    "whisper-base": dict(d_model=512, encoder_layers=6, decoder_layers=6,
                         encoder_attention_heads=8, decoder_attention_heads=8,
                         encoder_ffn_dim=2048, decoder_ffn_dim=2048,
                         num_mel_bins=80, vocab_size=51865),
    "whisper-small": dict(d_model=768, encoder_layers=12, decoder_layers=12,
                          encoder_attention_heads=12, decoder_attention_heads=12,
                          encoder_ffn_dim=3072, decoder_ffn_dim=3072,
                          num_mel_bins=80, vocab_size=51865),
    "whisper-medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24,
                           encoder_attention_heads=16, decoder_attention_heads=16,
                           encoder_ffn_dim=4096, decoder_ffn_dim=4096,
                           num_mel_bins=80, vocab_size=51865),
    "whisper-large-v2": dict(d_model=1280, encoder_layers=32, decoder_layers=32,
                             encoder_attention_heads=20, decoder_attention_heads=20,
                             encoder_ffn_dim=5120, decoder_ffn_dim=5120,
                             num_mel_bins=80, vocab_size=51865),
    "whisper-large-v3": dict(),  # the defaults above
}


def sinusoids(length: int, channels: int) -> np.ndarray:
    """OpenAI whisper's sinusoid table (sin || cos), float32."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def conv_gelu(x, conv: nn.Conv1d, stride: int = 1):
    """GELU of ``conv`` (k 3, zero padding 1 each side) over x (B, T, C_in)."""
    return F.gelu(conv1d(x, conv.weight, conv.bias, left_pad=1, right_pad=1, stride=stride))


def heads(y, n_head):
    b, t, d = y.shape
    return y.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def attend(q, k, v, mask, dtype, scale=None):
    """q (B, H, Tq, dk), k / v (B, H, Tk, dk) -> (B, Tq, H * dk) in ``dtype``: fp32
    scores divided by sqrt(dk) (or times ``scale``), the masked softmax in ``dtype``, an
    fp32 product."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores * scale if scale is not None else scores / math.sqrt(q.shape[-1])
    probs = masked_softmax(scores.to(dtype), mask)
    ctx = torch.matmul(probs.float(), v.float())
    b, h, t, dk = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * dk).to(dtype)


class WhisperAttention(nn.Module):
    """Hugging Face names: ``q_proj``, ``k_proj`` (no bias), ``v_proj``, ``out_proj``."""

    def __init__(self, d: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.q_proj = nn.Linear(d, d, device=device)
        self.k_proj = nn.Linear(d, d, bias=False, device=device)
        self.v_proj = nn.Linear(d, d, device=device)
        self.out_proj = nn.Linear(d, d, device=device)

    def forward(self, x, mem, mask=None):
        """``mha_apply``: x (B, Tq, D) attends over mem (B, Tk, D); mask bool
        broadcastable to (B, 1, Tq, Tk), True = attend."""
        h = self.n_head
        ctx = attend(heads(apply_linear(self.q_proj, x), h),
                     heads(apply_linear(self.k_proj, mem), h),
                     heads(apply_linear(self.v_proj, mem), h), mask, x.dtype)
        return apply_linear(self.out_proj, ctx)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, d: int, n_head: int, ffn: int, device=None):
        super().__init__()
        self.self_attn = WhisperAttention(d, n_head, device)
        self.self_attn_layer_norm = LayerNorm(d, device=device)
        self.fc1 = nn.Linear(d, ffn, device=device)
        self.fc2 = nn.Linear(ffn, d, device=device)
        self.final_layer_norm = LayerNorm(d, device=device)

    def ffn(self, x):
        return apply_linear(self.fc2, F.gelu(apply_linear(self.fc1, x)))

    def forward(self, h, mask=None):
        x = self.self_attn_layer_norm(h)
        h = h + self.self_attn(x, x, mask)
        return h + self.ffn(self.final_layer_norm(h))


class WhisperDecoderLayer(WhisperEncoderLayer):
    def __init__(self, d: int, n_head: int, ffn: int, device=None):
        super().__init__(d, n_head, ffn, device)
        self.encoder_attn = WhisperAttention(d, n_head, device)
        self.encoder_attn_layer_norm = LayerNorm(d, device=device)

    def forward(self, h, enc, causal):
        x = self.self_attn_layer_norm(h)
        h = h + self.self_attn(x, x, causal)
        x = self.encoder_attn_layer_norm(h)
        h = h + self.encoder_attn(x, enc, None)
        return h + self.ffn(self.final_layer_norm(h))


class Positions(nn.Module):
    """A position table held as ``weight`` (not an ``nn.Embedding``, so that the seeded
    init leaves the encoder's fixed sinusoids alone)."""

    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d, device=device))


class WhisperEncoder(nn.Module):
    def __init__(self, c: WhisperConfig, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(c.num_mel_bins, c.d_model, 3, device=device)
        self.conv2 = nn.Conv1d(c.d_model, c.d_model, 3, device=device)
        self.embed_positions = Positions(c.max_source_positions, c.d_model, device)
        with torch.no_grad():
            self.embed_positions.weight.copy_(
                torch.from_numpy(sinusoids(c.max_source_positions, c.d_model)))
        self.embed_positions.weight.requires_grad_(False)  # fixed, as in JAX
        self.layers = nn.ModuleList([
            WhisperEncoderLayer(c.d_model, c.encoder_attention_heads, c.encoder_ffn_dim, device)
            for _ in range(c.encoder_layers)])
        self.layer_norm = LayerNorm(c.d_model, device=device)


def encode_mel(enc: WhisperEncoder, mel):
    """The encoder tower over mel (B, T, n_mels) -> (B, T // 2, D)."""
    mel = mel.to(enc.conv1.weight.dtype)
    h = conv_gelu(conv_gelu(mel, enc.conv1), enc.conv2, stride=2)
    h = h + enc.embed_positions.weight[: h.shape[1]].to(h.dtype)
    for layer in enc.layers:
        h = layer(h)
    return enc.layer_norm(h)


class WhisperDecoder(nn.Module):
    def __init__(self, c: WhisperConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.d_model, device=device)
        self.embed_positions = Positions(c.max_target_positions, c.d_model, device)
        self.layers = nn.ModuleList([
            WhisperDecoderLayer(c.d_model, c.decoder_attention_heads, c.decoder_ffn_dim, device)
            for _ in range(c.decoder_layers)])
        self.layer_norm = LayerNorm(c.d_model, device=device)


class WhisperBody(nn.Module):
    def __init__(self, c: WhisperConfig, device=None):
        super().__init__()
        self.encoder = WhisperEncoder(c, device)
        self.decoder = WhisperDecoder(c, device)


def _drop_hf_extras(state_dict, prefix, *args):
    state_dict.pop(prefix + "proj_out.weight", None)  # Hugging Face's tied head


class WhisperModel(nn.Module):
    """Registered per size (``SIZES``, and the JAX package's aliases)."""

    def __init__(self, whisper_size: str = "whisper-large-v3", vocab_size: int = -1, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        conf = dict(SIZES.get(whisper_size, {}))
        conf.update({k: v for k, v in kwargs.items() if k in WhisperConfig._fields})
        if vocab_size and vocab_size > 0:
            conf["vocab_size"] = vocab_size
        self.cfg = WhisperConfig(**conf)
        self.size_name = whisper_size
        self.model = WhisperBody(self.cfg, device)
        self._register_load_state_dict_pre_hook(_drop_hf_extras)
        if generator is not None:
            init_whisper(self, generator)

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        """The training loss (``whisper/model.py:365-375``): mel (B, T, n_mels), token ids
        (B, L) -> (loss, stats, batch size); CE of ``text[:, 1:]`` teacher forced on
        ``text[:, :-1]``, over the positions below ``text_lengths - 1``. ``generator`` is
        unused."""
        encoder_out, _ = self.encode(speech, speech_lengths)
        logits = self.decode_logits(text[:, :-1], encoder_out)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ys_out = text[:, 1:]
        valid = (torch.arange(ys_out.shape[1], device=ys_out.device)[None]
                 < (text_lengths - 1)[:, None])
        tgt = torch.where(valid, ys_out, 0).long()
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0] * valid
        loss = nll.sum() / global_count(valid.sum()).clamp_min(1)
        return loss, {"loss": loss}, speech.shape[0]

    @property
    def device(self) -> torch.device:
        return self.model.decoder.embed_tokens.weight.device

    # ------------------------------------------------------------------

    def encode(self, mel, mel_lens=None):
        """mel (B, T, n_mels) -> ((B, T // 2, D), mel_lens // 2)."""
        return encode_mel(self.model.encoder, mel), None if mel_lens is None else mel_lens // 2

    def _logits(self, h):
        w = self.model.decoder.embed_tokens.weight.to(h.dtype)
        return F.linear(h, w) if h.dtype == torch.float32 else torch.matmul(h.float(),
                                                                            w.float().T)

    def decode_logits(self, tokens, encoder_out):
        """tokens (B, L) -> (B, L, V) fp32 (teacher forced / prefix scoring)."""
        dec = self.model.decoder
        n = tokens.shape[1]
        h = dec.embed_tokens.weight[tokens] + dec.embed_positions.weight[:n]
        causal = torch.tril(torch.ones(n, n, dtype=torch.bool, device=h.device))[None, None]
        for layer in dec.layers:
            h = layer(h, encoder_out, causal)
        return self._logits(dec.layer_norm(h))

    def cross_kv(self, encoder_out):
        """Each decoder layer's cross-attention K / V (B, H, T, dk), once an utterance."""
        h = self.cfg.decoder_attention_heads
        return [{"k": heads(apply_linear(lp.encoder_attn.k_proj, encoder_out), h),
                 "v": heads(apply_linear(lp.encoder_attn.v_proj, encoder_out), h)}
                for lp in self.model.decoder.layers]

    def cached_step(self, toks, self_kv, cross_kv, pos: int):
        """One cached decoder step: toks (B,) at position ``pos`` -> (B,) next ids; the
        self-attention caches written at ``pos`` in place. ``decode_logits``' math on one
        query row."""
        c, dec = self.cfg, self.model.decoder
        n_head = c.decoder_attention_heads
        scale = 1.0 / math.sqrt(c.d_model // n_head)
        x = dec.embed_tokens.weight[toks][:, None] + dec.embed_positions.weight[pos:pos + 1][None]
        for lp, kv, ckv in zip(dec.layers, self_kv, cross_kv):
            y = lp.self_attn_layer_norm(x)
            at = lp.self_attn
            kv["k"][:, :, pos] = heads(apply_linear(at.k_proj, y), n_head)[:, :, 0].to(
                kv["k"].dtype)
            kv["v"][:, :, pos] = heads(apply_linear(at.v_proj, y), n_head)[:, :, 0].to(
                kv["v"].dtype)
            valid = (torch.arange(kv["k"].shape[2], device=x.device) <= pos)[None, None, None]
            ctx = attend(heads(apply_linear(at.q_proj, y), n_head), kv["k"], kv["v"], valid,
                         x.dtype, scale)
            x = x + apply_linear(at.out_proj, ctx)
            y = lp.encoder_attn_layer_norm(x)
            ctx = attend(heads(apply_linear(lp.encoder_attn.q_proj, y), n_head), ckv["k"],
                         ckv["v"], None, x.dtype, scale)
            x = x + apply_linear(lp.encoder_attn.out_proj, ctx)
            x = x + lp.ffn(lp.final_layer_norm(x))
        return self._logits(dec.layer_norm(x))[:, 0].argmax(dim=-1)

    @torch.no_grad()
    def greedy_decode(self, encoder_out, prompt_ids, eot_id: int, max_new: int = 128):
        """KV-cached greedy decode: the self-attention caches (B, H, max_len, dk) in the
        decoder's weight dtype, cross-K / V once; equal to ``greedy_decode_prefix`` token
        for token."""
        c = self.cfg
        b, dev = encoder_out.shape[0], encoder_out.device
        n_head = c.decoder_attention_heads
        max_len = min(bucket_length(len(prompt_ids) + max_new, minimum=32, multiple=32),
                      c.max_target_positions)
        dtype = self.model.decoder.embed_tokens.weight.dtype
        shape = (b, n_head, max_len, c.d_model // n_head)
        self_kv = [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
                   for _ in range(c.decoder_layers)]
        cross = self.cross_kv(encoder_out)
        tokens = [list(prompt_ids) for _ in range(b)]
        done = [False] * b
        cur = np.full((b,), prompt_ids[0], np.int64)
        for pos in range(max_len - 1):
            nxt = self.cached_step(torch.from_numpy(cur).to(dev), self_kv, cross, pos)
            if pos + 1 < len(prompt_ids):
                cur = np.full((b,), prompt_ids[pos + 1], np.int64)
                continue
            nxt = nxt.cpu().numpy()
            for i in range(b):
                if done[i]:
                    continue
                if int(nxt[i]) == eot_id:
                    done[i] = True
                else:
                    tokens[i].append(int(nxt[i]))
            n_generated = pos + 2 - len(prompt_ids)
            if all(done) or n_generated >= max_new or max(len(t) for t in tokens) >= max_len:
                break
            cur = np.asarray([t[pos + 1] if pos + 1 < len(t) else eot_id for t in tokens],
                             np.int64)
        return [t[len(prompt_ids):] for t in tokens]

    @torch.no_grad()
    def greedy_decode_prefix(self, encoder_out, prompt_ids, eot_id: int, max_new: int = 128):
        """Greedy by full-prefix recompute (the oracle of the cached path)."""
        b, dev = encoder_out.shape[0], encoder_out.device
        tokens = [list(prompt_ids) for _ in range(b)]
        done = [False] * b
        for _ in range(max_new):
            lmax = bucket_length(max(len(t) for t in tokens), minimum=8, multiple=8)
            ys = np.zeros((b, lmax), np.int64)
            last = np.zeros((b,), np.int64)
            for i, t in enumerate(tokens):
                ys[i, : len(t)] = t
                last[i] = len(t) - 1
            logits = self.decode_logits(torch.from_numpy(ys).to(dev), encoder_out)
            nxt = logits[torch.arange(b, device=dev), torch.from_numpy(last).to(dev)].argmax(-1)
            for i, tok in enumerate(nxt.cpu().numpy()):
                if done[i]:
                    continue
                if int(tok) == eot_id:
                    done[i] = True
                else:
                    tokens[i].append(int(tok))
            if all(done):
                break
        return [t[len(prompt_ids):] for t in tokens]

    def inference(self, data_in, data_lengths=None, key: Optional[List] = None,
                  tokenizer=None, frontend=None, **kwargs):
        from funasr_tpu_torch.utils.load_utils import as_unit_f32, load_audio_text_image_video

        meta: Dict = {}
        t0 = time.perf_counter()
        audio_list = load_audio_text_image_video(data_in, fs=frontend.fs,
                                                 audio_fs=kwargs.get("fs", 16000))
        meta["load_data"] = f"{time.perf_counter() - t0:0.3f}"
        mel, _ = frontend.extract([as_unit_f32(a) for a in audio_list], device=self.device)
        meta["batch_data_time"] = sum(len(a) for a in audio_list) / 16000.0
        with torch.no_grad():
            encoder_out, _ = self.encode(mel)
        prompt = kwargs.get("prompt_ids")
        eot = kwargs.get("eot_id", self.cfg.vocab_size - 1)
        if prompt is None and tokenizer is not None and hasattr(tokenizer, "sot_sequence"):
            prompt = list(tokenizer.sot_sequence)
        if prompt is None:
            prompt = [0]
        hyps = self.greedy_decode(encoder_out, prompt, eot,
                                  max_new=kwargs.get("max_new_tokens", 128))
        if key is None:
            key = [f"rand_key_{i}" for i in range(len(hyps))]
        results = [{"key": key[i], "text": tokenizer.decode(ids) if tokenizer is not None
                    else ""} for i, ids in enumerate(hyps)]
        return results, meta


def init_whisper(model: WhisperModel, generator: torch.Generator) -> WhisperModel:
    """Seeded weights: ``init_weights``' rules for the linears, convs and norms; the token
    and decoder position tables normal * 0.02, as the JAX ``init_params``."""
    init_weights(model, generator)
    dec = model.model.decoder
    with torch.no_grad():
        for w in (dec.embed_tokens.weight, dec.embed_positions.weight):
            w.copy_(torch.randn(w.shape, device=generator.device, generator=generator) * 0.02)
    return model


def _register_sizes():
    for size in list(SIZES) + ["Whisper-large-v3", "Whisper-large-v2", "OpenAIWhisperModel",
                               "WhisperWarp"]:
        canonical = size.lower() if size.lower().startswith("whisper") else "whisper-large-v3"

        def make(sz):
            class _W(WhisperModel):
                def __init__(self, **kwargs):
                    kwargs.setdefault("whisper_size", sz)
                    super().__init__(**kwargs)
            _W.__name__ = f"Whisper_{sz.replace('-', '_')}"
            return _W

        tables.model_classes[size] = make(canonical)


_register_sizes()
