"""Qwen2 / Qwen3-style decoder-only causal LM in PyTorch, the LLM half of Fun-ASR-Nano
(counterpart of ``funasr_tpu/models/llm/qwen.py``; FunASR loads Qwen3-0.6B through
``transformers``).

RMSNorm, rotary embeddings, grouped-query attention (per-head q / k RMSNorm for Qwen3),
a SwiGLU MLP or a dense Qwen3-MoE block, an optional tied head. Parameter names are
Hugging Face ``Qwen3ForCausalLM``'s (``model.layers.N.self_attn.q_proj.weight``, ...,
``mlp.experts.J.gate_proj.weight`` for the MoE), so a Hugging Face state dict loads with
``load_state_dict`` and ``funasr_tpu/models/llm/qwen.py::convert_hf_qwen`` maps this
module's ``state_dict()`` straight into the JAX params.

Numerics copied from the JAX package, not "fixed":

* RMSNorm in fp32, cast back to the input's dtype (``qwen.py:77-80``);
* RoPE with Hugging Face's half split, fp32 frequencies from ``rope_theta``
  (``:83-92``); q / k RMSNorm before RoPE when ``qk_norm`` (``:181-183``). The RoPE
  tables, the cache rows and the mask are computed once a forward (``step_tables``) and
  shared by the layers: the same values as JAX's per-layer ones, with fewer launches;
* attention scores in fp32, q scaled by ``hd ** -0.5`` before the product, masked by
  ``spos <= qpos & spos < kv_lens`` over the whole cache (``:193-213``); the grouped
  query (B, T, Hkv, G, hd) reads the (B, S, Hkv, hd) cache once, with no repeat of
  K / V. The JAX package computes it with einsums outside any Pallas kernel, so it
  stays plain PyTorch here;
* every linear multiplies in its input's dtype (``qlinear`` casts the weight);
* ``embed`` clips out-of-range ids (``mode="clip"``, ``:291-295``), where PyTorch
  indexing would raise;
* the tied head is ``x @ embed_tokens.T`` with the weight in x's dtype and an fp32
  product (``:277-279``);
* the MoE block runs densely over all experts with a zero-masked combine
  (``:223-251``); expert parallelism is ROADMAP item 21b.

The K / V cache is a list of ``{"k", "v"}`` (B, S, Hkv, hd) tensors, one per layer;
``forward_hidden`` writes the new rows into it in place and returns it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from funasr_tpu_torch.core.layers import apply_linear


class QwenConfig(NamedTuple):
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True
    qkv_bias: bool = False       # qwen2: True, qwen3: False
    qk_norm: bool = False        # qwen3: True
    num_experts: int = 0         # Qwen3-MoE: routed SwiGLU experts, top-k softmax gating
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def moe(self) -> bool:
        return self.num_experts > 0

    @classmethod
    def from_hf(cls, hf_config) -> "QwenConfig":
        d = hf_config.to_dict() if hasattr(hf_config, "to_dict") else dict(hf_config)
        mtype = d.get("model_type", "")
        is_qwen3 = mtype in ("qwen3", "qwen3_moe")
        return cls(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1e6),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            qkv_bias=not is_qwen3 and mtype == "qwen2",
            qk_norm=is_qwen3,
            num_experts=d.get("num_experts", 0) if mtype == "qwen3_moe" else 0,
            num_experts_per_tok=d.get("num_experts_per_tok", 0),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            norm_topk_prob=d.get("norm_topk_prob", True),
        )


def rms_norm(w, x, eps: float):
    """fp32 RMSNorm (``F.rms_norm`` on the fp32 copy), cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


def rope_tables(positions, hd: int, theta: float):
    """positions (B, T) -> (cos, sin), each (B, T, 1, hd / 2) fp32."""
    inv_freq = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                            device=positions.device) / hd)
    freqs = positions[..., None].float() * inv_freq
    return torch.cos(freqs)[:, :, None, :], torch.sin(freqs)[:, :, None, :]


def apply_rope(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x, positions, theta: float):
    """x (B, T, H, hd), positions (B, T) -> rotated (Hugging Face half split)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


class StepTables(NamedTuple):
    """What every layer of one forward shares: the RoPE tables, the cache rows the new
    keys go to (None without a cache), and the attention mask over the cache, or over
    this call's keys without one (True where masked)."""
    cos: torch.Tensor
    sin: torch.Tensor
    b_idx: Optional[torch.Tensor]  # (B, T)
    idx: Optional[torch.Tensor]    # (B, T) cache rows, write_pos + t modulo the cache length
    masked: torch.Tensor   # (B, 1, 1, T, S): not (spos <= qpos and spos < kv_lens)


def step_tables(cfg, positions, write_pos, kv_lens, max_len: int) -> StepTables:
    b, t = positions.shape
    dev = positions.device
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    idx = (write_pos[:, None] + torch.arange(t, device=dev)[None]) % max_len
    b_idx = torch.arange(b, device=dev)[:, None].expand(b, t)
    spos = torch.arange(max_len, device=dev)[None, None, None, None, :]
    valid = ((spos <= positions[:, None, None, :, None])
             & (spos < kv_lens[:, None, None, None, None]))
    return StepTables(cos, sin, b_idx, idx, ~valid)


def causal_tables(cfg, t: int, device) -> StepTables:
    """The tables of a full-sequence forward without a cache: positions 0..T-1, each
    query seeing the keys up to its own (the cache path's mask with kv_lens = T)."""
    pos = torch.arange(t, device=device)
    cos, sin = rope_tables(pos[None], cfg.hd, cfg.rope_theta)
    masked = (pos[None, :] > pos[:, None])[None, None, None]  # (1, 1, 1, T, T)
    return StepTables(cos, sin, None, None, masked)


class RMSNorm(nn.Module):
    """A norm's weight (ones); applied with :func:`rms_norm` and the config's eps."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))


class QwenAttention(nn.Module):
    def __init__(self, c: QwenConfig, device=None):
        super().__init__()
        self.cfg = c
        self.q_proj = nn.Linear(c.hidden_size, c.num_attention_heads * c.hd, bias=c.qkv_bias,
                                device=device)
        self.k_proj = nn.Linear(c.hidden_size, c.num_key_value_heads * c.hd, bias=c.qkv_bias,
                                device=device)
        self.v_proj = nn.Linear(c.hidden_size, c.num_key_value_heads * c.hd, bias=c.qkv_bias,
                                device=device)
        self.o_proj = nn.Linear(c.num_attention_heads * c.hd, c.hidden_size, bias=False,
                                device=device)
        if c.qk_norm:
            self.q_norm = RMSNorm(c.hd, device)
            self.k_norm = RMSNorm(c.hd, device)

    def forward(self, x, tabs: StepTables, kv):
        """x (B, T, D); kv the layer's cache, written in place at rows ``tabs.idx``, or
        None: attention over this call's keys (training, teacher forcing)."""
        c = self.cfg
        b, t, _ = x.shape

        def proj(mod, n_heads):
            return apply_linear(mod, x).reshape(b, t, n_heads, c.hd)

        q = proj(self.q_proj, c.num_attention_heads)
        k = proj(self.k_proj, c.num_key_value_heads)
        v = proj(self.v_proj, c.num_key_value_heads)
        if c.qk_norm:
            q = rms_norm(self.q_norm.weight, q, c.rms_norm_eps)
            k = rms_norm(self.k_norm.weight, k, c.rms_norm_eps)
        q = apply_rope(q, tabs.cos, tabs.sin)
        k = apply_rope(k, tabs.cos, tabs.sin)

        if kv is None:
            k_cache, v_cache = k, v
        else:
            k_cache, v_cache = kv["k"], kv["v"]
            k_cache.index_put_((tabs.b_idx, tabs.idx), k.to(k_cache.dtype))
            v_cache.index_put_((tabs.b_idx, tabs.idx), v.to(v_cache.dtype))

        n_rep = c.num_attention_heads // c.num_key_value_heads
        qg = (q.float() * c.hd ** -0.5).reshape(b, t, c.num_key_value_heads, n_rep, c.hd)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.float())
        attn = torch.softmax(scores.masked_fill(tabs.masked, float("-inf")), dim=-1)
        dt = torch.promote_types(x.dtype, v_cache.dtype)  # jnp.einsum promotes
        ctx = torch.einsum("bkgts,bskd->btkgd", attn.to(x.dtype).to(dt), v_cache.to(dt))
        ctx = ctx.reshape(b, t, c.num_attention_heads * c.hd).to(x.dtype)
        return apply_linear(self.o_proj, ctx)


class QwenMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.gate_proj = nn.Linear(dim, hidden, bias=False, device=device)
        self.up_proj = nn.Linear(dim, hidden, bias=False, device=device)
        self.down_proj = nn.Linear(hidden, dim, bias=False, device=device)

    def forward(self, x):
        g = apply_linear(self.gate_proj, x)
        u = apply_linear(self.up_proj, x)
        h = F.silu(g.float()).to(x.dtype) * u
        return apply_linear(self.down_proj, h)


class QwenMoeBlock(nn.Module):
    """Qwen3-MoE sparse block (Hugging Face ``Qwen3MoeSparseMoeBlock``'s names): softmax
    router -> top-k experts (renormalised when ``norm_topk_prob``) -> weighted sum of the
    experts' SwiGLU outputs, computed densely over every expert as the JAX package does."""

    def __init__(self, c: QwenConfig, device=None):
        super().__init__()
        self.cfg = c
        mi = c.moe_intermediate_size or c.intermediate_size
        self.gate = nn.Linear(c.hidden_size, c.num_experts, bias=False, device=device)
        self.experts = nn.ModuleList([QwenMLP(c.hidden_size, mi, device)
                                      for _ in range(c.num_experts)])

    def _stacked(self, name, dtype):
        mods = [getattr(e, name) for e in self.experts]
        if not all(isinstance(m, nn.Linear) for m in mods):
            raise NotImplementedError("quantized MoE experts are not supported (the JAX "
                                      "package's dense MoE reads float expert weights)")
        return torch.stack([m.weight for m in mods]).to(dtype)  # (E, out, in)

    def forward(self, x):
        c = self.cfg
        router = apply_linear(self.gate, x).float()  # (B, T, E)
        probs = torch.softmax(router, dim=-1)
        topv, topi = torch.topk(probs, c.num_experts_per_tok, dim=-1)
        if c.norm_topk_prob:
            topv = topv / topv.sum(dim=-1, keepdim=True)
        gates = (F.one_hot(topi, c.num_experts).float() * topv[..., None]).sum(dim=-2)
        g = torch.einsum("btd,ehd->beth", x, self._stacked("gate_proj", x.dtype))
        u = torch.einsum("btd,ehd->beth", x, self._stacked("up_proj", x.dtype))
        h = F.silu(g.float()).to(x.dtype) * u
        y = torch.einsum("beth,edh->betd", h, self._stacked("down_proj", x.dtype))
        return torch.einsum("betd,bte->btd", y, gates.to(x.dtype))


class QwenDecoderLayer(nn.Module):
    def __init__(self, c: QwenConfig, device=None):
        super().__init__()
        self.cfg = c
        self.input_layernorm = RMSNorm(c.hidden_size, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, device)
        self.self_attn = QwenAttention(c, device)
        self.mlp = (QwenMoeBlock(c, device) if c.moe
                    else QwenMLP(c.hidden_size, c.intermediate_size, device))

    def forward(self, x, tabs: StepTables, kv):
        eps = self.cfg.rms_norm_eps
        h = rms_norm(self.input_layernorm.weight, x, eps)
        x = x + self.self_attn(h, tabs, kv)
        h = rms_norm(self.post_attention_layernorm.weight, x, eps)
        return x + self.mlp(h)


class QwenModel(nn.Module):
    def __init__(self, c: QwenConfig, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, device=device)
        self.layers = nn.ModuleList([QwenDecoderLayer(c, device)
                                     for _ in range(c.num_hidden_layers)])
        self.norm = RMSNorm(c.hidden_size, device)


class QwenLM(nn.Module):
    """``model`` (embed_tokens, layers, norm) and, untied, ``lm_head``. A tied model drops
    a checkpoint's ``lm_head.weight`` on load (Hugging Face's state dict carries it)."""

    def __init__(self, config: QwenConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = config
        self.model = QwenModel(config, device)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False,
                                     device=device)
        else:
            self._register_load_state_dict_pre_hook(_drop_tied_head)
        if generator is not None:
            init_qwen(self, generator)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def init_kv_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        c = self.cfg
        device = self.device if device is None else device
        shape = (batch, max_len, c.num_key_value_heads, c.hd)
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(c.num_hidden_layers)]

    def forward_hidden(self, input_embeds, positions, kv_cache, write_pos, kv_lens):
        """(B, T, D) embeds -> ((B, T, D) hidden states before the final norm, kv_cache
        written in place). Callers that need the logits of a few positions gather them
        before :meth:`logits_head`."""
        tabs = step_tables(self.cfg, positions, write_pos, kv_lens, kv_cache[0]["k"].shape[1])
        x = input_embeds
        for layer, kv in zip(self.model.layers, kv_cache):
            x = layer(x, tabs, kv)
        return x, kv_cache

    def logits_head(self, x):
        """Final RMSNorm + vocab projection: (B, T, D) -> (B, T, V) fp32."""
        x = rms_norm(self.model.norm.weight, x, self.cfg.rms_norm_eps)
        if self.cfg.tie_word_embeddings:
            w = self.model.embed_tokens.weight.to(x.dtype)
            if x.dtype == torch.float32:
                return F.linear(x, w)
            return torch.matmul(x.float(), w.float().T)  # the fp32 product of x's dtype
        return apply_linear(self.lm_head, x).float()

    def forward(self, input_embeds, positions, kv_cache, write_pos, kv_lens):
        """input_embeds (B, T, D); positions (B, T) global positions -> (logits (B, T, V)
        fp32, kv_cache)."""
        x, kv_cache = self.forward_hidden(input_embeds, positions, kv_cache, write_pos,
                                          kv_lens)
        return self.logits_head(x), kv_cache

    def embed(self, token_ids, dtype=torch.bfloat16):
        table = self.model.embed_tokens.weight
        ids = torch.as_tensor(token_ids, device=table.device).long()
        return table[ids.clamp(0, table.shape[0] - 1)].to(dtype)

    def hidden_embeds(self, input_embeds):
        """Full-sequence causal forward without a cache: (B, T, D) embeds -> (B, T, D)
        hidden states before the final norm. The JAX ``forward_embeds`` writes K / V into
        a fresh cache of T rows and attends over all of it; this attends over the call's
        own K / V under the same causal mask, the same values with no scatter or copy,
        and autograd follows it (training)."""
        tabs = causal_tables(self.cfg, input_embeds.shape[1], input_embeds.device)
        x = input_embeds
        for layer in self.model.layers:
            x = layer(x, tabs, None)
        return x

    def forward_embeds(self, input_embeds):
        """Full-sequence causal forward without a persistent cache: (B, T, D) embeds ->
        (B, T, V) logits (teacher forcing, training; ``qwen.py:297-307``)."""
        return self.logits_head(self.hidden_embeds(input_embeds))


def _drop_tied_head(state_dict, prefix, *args):
    state_dict.pop(prefix + "lm_head.weight", None)


def init_qwen(lm: QwenLM, generator: torch.Generator) -> QwenLM:
    """Seeded weights by the JAX ``init_params`` rules: linears uniform in
    +-1/sqrt(fan_in), the token table normal * 0.02, norms ones, MoE experts normal *
    fan_in ** -0.5. Drawn on the generator's device and copied."""
    import math

    dev = generator.device
    with torch.no_grad():
        for mod in lm.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape, device=dev).uniform_(
                            -bound, bound, generator=generator))
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        for mod in lm.modules():
            if isinstance(mod, QwenMoeBlock):
                for e in mod.experts:
                    for lin in (e.gate_proj, e.up_proj, e.down_proj):
                        lin.weight.copy_(torch.randn(lin.weight.shape, device=dev,
                                                     generator=generator)
                                         * lin.in_features ** -0.5)
        w = lm.model.embed_tokens.weight
        w.copy_(torch.randn(w.shape, device=dev, generator=generator) * 0.02)
    return lm
