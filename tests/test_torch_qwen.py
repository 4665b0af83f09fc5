"""The port's Qwen LM and ``LLMEngine`` against the JAX package's (CPU, fp32).

Weights: a seeded port ``QwenLM``'s ``state_dict()`` through the JAX converter
``convert_hf_qwen``. The config is ``tests/test_llm_engine.py``'s (2 layers, d 32, 4
heads over 2 K / V heads, head_dim 8, qk_norm, tied head). Held:

* logits of a whole-sequence forward and of a prefill-then-decode pass through the K / V
  cache within ``LOGIT_TOL`` of JAX's, dense and MoE; and against ``transformers``'
  random-init ``Qwen3ForCausalLM`` / ``Qwen3MoeForCausalLM`` (built inside the test),
  loaded with ``load_state_dict``;
* the engine cases of ``tests/test_llm_engine.py`` (naive greedy = engine, multi-step =
  single step, EOS stops, chunked prefill = one shot, no head-of-line blocking, cache
  growth, seeded sampling reproducible, prefix hit = miss, no false prefix hit, device
  prompt batch = host path, several chunks): exact within the port, and the port's ids
  equal to the JAX naive greedy decode on every step whose top-2 logit margin clears
  ``MARGIN_FACTOR`` x the measured logit difference (``assert_ids_match_jax``; with
  random weights every step clears it here, and the count is printed); and the JAX
  package's own ``LLMEngine`` on host prompts and on a device prompt batch, its ids equal
  to the port engine's under the same margin rule.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.models.llm import qwen as jqwen
from funasr_tpu_torch.llm.engine import LLMEngine, Request
from funasr_tpu_torch.models.llm.qwen import QwenConfig, QwenLM
from torch_parity_util import one_torch_thread, to_jax  # noqa: F401

LOGIT_TOL = 2e-4
MARGIN_FACTOR = 10
CFG = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=8,
           tie_word_embeddings=True, qk_norm=True, rope_theta=10000.0)
MOE_CFG = dict(CFG, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
               norm_topk_prob=True)


def build(conf, seed=0):
    pt = QwenLM(QwenConfig(**conf), generator=torch.Generator().manual_seed(seed)).eval()
    jcfg = jqwen.QwenConfig(**conf)
    return pt, jqwen.QwenLM(jcfg), to_jax(jqwen.convert_hf_qwen(pt.state_dict(), jcfg))


@pytest.fixture(scope="module")
def pair():
    return build(CFG)


def port_logits(pt, embeds):
    with torch.no_grad():
        return pt.forward_embeds(torch.from_numpy(embeds)).numpy()


def jax_logits(jm, jp, embeds):
    return np.asarray(jax.jit(jm.forward_embeds)(jp, jnp.asarray(embeds)))


@pytest.mark.parametrize("conf", [CFG, MOE_CFG], ids=["dense", "moe"])
def test_forward_logits_match_jax(conf):
    pt, jm, jp = build(conf, seed=1)
    embeds = np.random.default_rng(0).standard_normal((2, 11, 32)).astype(np.float32)
    got, want = port_logits(pt, embeds), jax_logits(jm, jp, embeds)
    assert got.shape == (2, 11, 96)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("conf", [CFG, MOE_CFG], ids=["dense", "moe"])
def test_prefill_then_decode_through_the_cache_matches_jax(conf):
    """Prefill 9 rows into a 16-row cache at a per-row offset, then decode 3 steps one
    row at a time; the cache rows and every logit row against JAX's."""
    pt, jm, jp = build(conf, seed=2)
    rng = np.random.default_rng(1)
    b, s = 2, 16
    prompt = rng.standard_normal((b, 9, 32)).astype(np.float32)
    steps = rng.standard_normal((3, b, 1, 32)).astype(np.float32)
    write = np.asarray([0, 2], np.int32)  # row 1 starts 2 rows in
    kv_t = pt.init_kv_cache(b, s, torch.float32)
    kv_j = jm.init_kv_cache(b, s, jnp.float32)
    forward = jax.jit(jm.forward)

    def both(x, pos0):
        nonlocal kv_j
        t = x.shape[1]
        pos = pos0[:, None] + np.arange(t)[None]
        with torch.no_grad():
            got, _ = pt.forward(torch.from_numpy(x), torch.from_numpy(pos).long(), kv_t,
                                torch.from_numpy(pos0).long(),
                                torch.from_numpy(pos0 + t).long())
        want, kv_j = forward(jp, jnp.asarray(x), jnp.asarray(pos), kv_j,
                                jnp.asarray(pos0), jnp.asarray(pos0 + t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)

    both(prompt, write)
    for i, x in enumerate(steps):
        both(x, write + 9 + i)
    for c_t, c_j in zip(kv_t, kv_j):
        np.testing.assert_allclose(c_t["k"].numpy(), np.asarray(c_j["k"]), atol=1e-5)
        np.testing.assert_allclose(c_t["v"].numpy(), np.asarray(c_j["v"]), atol=1e-5)


def test_rms_norm_and_rope_match_jax():
    from funasr_tpu_torch.models.llm.qwen import rms_norm, rope

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    np.testing.assert_allclose(rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
                               np.asarray(jqwen.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-6).numpy(),
                               np.asarray(jqwen.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6)),
                               atol=1e-5, rtol=0)


def test_embed_clips_out_of_range_ids(pair):
    pt, jm, jp = pair
    ids = np.asarray([[0, 95, 96, 151644, -3]])
    got = pt.embed(torch.from_numpy(ids), torch.float32).detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.embed(jp, jnp.asarray(ids), jnp.float32)))
    np.testing.assert_array_equal(got[0, 2], got[0, 1])


def test_qwen_config_from_hf_matches_jax():
    for d in ({"model_type": "qwen3", **CFG, "head_dim": 128},
              {"model_type": "qwen2", **CFG},
              {"model_type": "qwen3_moe", **MOE_CFG}):
        assert QwenConfig.from_hf(d)._asdict() == jqwen.QwenConfig.from_hf(d)._asdict()
    assert QwenConfig().hd == 64 and QwenConfig(head_dim=128).hd == 128


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_logits_match_transformers(moe):
    """``transformers`` as a third oracle: its random-init Qwen3 (MoE) model's state dict
    loads into the port (tied ``lm_head.weight`` dropped) and gives the same logits."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers

    conf = MOE_CFG if moe else CFG
    kw = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=8,
              tie_word_embeddings=True, rope_theta=10000.0, attn_implementation="eager")
    torch.manual_seed(3)
    if moe:
        hf = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            **kw, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=16,
            norm_topk_prob=True)).eval()
    else:
        hf = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(**kw)).eval()
    pt = QwenLM(QwenConfig.from_hf(hf.config)).eval()
    assert QwenConfig.from_hf(hf.config)._asdict() == QwenConfig(**conf)._asdict()
    pt.load_state_dict(hf.state_dict())
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 96, (2, 13)))
    with torch.no_grad():
        want = hf(input_ids=ids).logits.numpy()
        got = pt.forward_embeds(pt.embed(ids, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


# ---- the engine ---------------------------------------------------------------------


GREEDY_ROWS = 128  # the JAX oracle's one padded length: prompt + new tokens fit


@functools.lru_cache(maxsize=None)
def _jax_last_logits(jm):
    """Jitted JAX forward over a (1, GREEDY_ROWS, D) buffer whose first n rows are the
    sequence: keys from n on are masked, so row n - 1 is the sequence's last logits."""

    def last(jp, buf, n):
        kv = jm.init_kv_cache(1, GREEDY_ROWS, jnp.float32)
        logits, _ = jm.forward(jp, buf, jnp.arange(GREEDY_ROWS)[None], kv,
                               jnp.zeros((1,), jnp.int32), n[None])
        return logits[0, n - 1]

    return jax.jit(last)


def jax_greedy(jm, jp, embeds, n_new):
    """``tests/test_llm_engine.py``'s full-recompute greedy oracle on the JAX model:
    (ids, the top-2 logit margin of each step)."""
    ids, margins = [], []
    buf = np.zeros((1, GREEDY_ROWS, embeds.shape[1]), np.float32)
    buf[0, :len(embeds)] = embeds
    n = len(embeds)
    for _ in range(n_new):
        row = np.asarray(_jax_last_logits(jm)(jp, jnp.asarray(buf), jnp.int32(n)))
        top2 = np.sort(row)[-2:]
        ids.append(int(row.argmax()))
        margins.append(float(top2[1] - top2[0]))
        buf[0, n] = np.asarray(jm.embed(jp, jnp.asarray([ids[-1]]), jnp.float32))[0]
        n += 1
    return ids, margins


def port_greedy(pt, embeds, n_new):
    """The same oracle on the port."""
    ids = []
    cur = torch.from_numpy(embeds[None])
    with torch.no_grad():
        for _ in range(n_new):
            ids.append(int(pt.forward_embeds(cur)[0, -1].argmax()))
            cur = torch.cat([cur, pt.embed(torch.tensor([[ids[-1]]]), torch.float32)], 1)
    return ids


@pytest.fixture(scope="module")
def logit_diff(pair):
    """The measured port-vs-JAX logit difference at this config."""
    pt, jm, jp = pair
    x = np.random.default_rng(9).standard_normal((2, 40, 32)).astype(np.float32)
    return float(np.abs(port_logits(pt, x) - jax_logits(jm, jp, x)).max())


def assert_ids_match_jax(pair, logit_diff, prompt, got, n_new=None):
    """``got`` equals the port's naive greedy decode exactly, and JAX's on the steps up
    to the first whose top-2 margin does not clear MARGIN_FACTOR x ``logit_diff``."""
    pt, jm, jp = pair
    n = len(got) if n_new is None else n_new
    assert got == port_greedy(pt, prompt, n)[:len(got)]
    want, margins = jax_greedy(jm, jp, prompt, n)
    clear = next((i for i, m in enumerate(margins) if m <= MARGIN_FACTOR * logit_diff),
                 len(margins))
    print(f"greedy ids held against JAX: {min(clear, len(got))} of {len(got)} tokens "
          f"(logit diff {logit_diff:.2e})")
    assert got[:clear] == want[:len(got)][:clear], (got, want, margins)


def engine(pt, **kw):
    kw.setdefault("dtype", torch.float32)
    return LLMEngine(pt, **kw)


def test_engine_matches_naive_greedy(pair, logit_diff):
    pt = pair[0]
    rng = np.random.default_rng(0)
    prompts = [rng.standard_normal((np.random.default_rng(i).integers(5, 12), 32))
               .astype(np.float32) for i in range(3)]
    eng = engine(pt, num_slots=2, max_len=64)
    reqs = [Request(request_id=i, input_embeds=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.generate(reqs)  # 3 requests through 2 slots
    for r, p in zip(reqs, prompts):
        assert len(r.output_ids) == 6
        assert_ids_match_jax(pair, logit_diff, p, r.output_ids)


def test_multi_step_decode_matches_single_step(pair):
    """32-step device decode (here 8) = one step a sync, EOS mid-chunk included."""
    pt = pair[0]
    rng = np.random.default_rng(7)
    prompts = [rng.standard_normal((9 + i, 32)).astype(np.float32) for i in range(3)]
    eos = port_greedy(pt, prompts[1], 4)[3]
    outs, syncs = [], []
    for chunk in (1, 8):
        eng = engine(pt, num_slots=2, max_len=64)
        eng.decode_chunk = chunk
        reqs = [Request(request_id=i, input_embeds=p, max_new_tokens=11, eos_token_ids=(eos,))
                for i, p in enumerate(prompts)]
        eng.generate(reqs)
        outs.append([r.output_ids for r in reqs])
        syncs.append(eng.n_syncs)
    assert outs[0] == outs[1], outs
    assert outs[0][1][-1] == eos and len(outs[0][1]) <= 4
    assert syncs[1] < syncs[0], syncs


def test_engine_eos_stops(pair, logit_diff):
    pt = pair[0]
    prompt = np.random.default_rng(1).standard_normal((8, 32)).astype(np.float32)
    first = port_greedy(pt, prompt, 1)[0]
    eng = engine(pt, num_slots=2, max_len=64)
    req = Request(request_id=0, input_embeds=prompt, max_new_tokens=10, eos_token_ids=(first,))
    eng.generate([req])
    assert req.output_ids == [first] and req.done
    assert_ids_match_jax(pair, logit_diff, prompt, req.output_ids)


def test_chunked_prefill_no_head_of_line_blocking(pair):
    """A long prompt admitting does not stall an in-flight decode: one prefill chunk a
    step, and the active request gains a token on each of those steps."""
    pt = pair[0]
    rng = np.random.default_rng(3)
    eng = engine(pt, num_slots=2, max_len=512, prefill_chunk=32, init_cache_len=512)
    short = Request(request_id=0, input_embeds=rng.standard_normal((8, 32)).astype(np.float32),
                    max_new_tokens=64)
    eng.submit(short)
    while len(short.output_ids) < 2:
        eng.step()
    long = Request(request_id=1, input_embeds=rng.standard_normal((128, 32)).astype(np.float32),
                   max_new_tokens=4)
    eng.submit(long)
    before, steps = len(short.output_ids), 0
    while not long.output_ids:
        eng.step()
        steps += 1
        assert steps < 50
    assert steps >= 4, steps  # 128 rows / 32-row chunks
    assert len(short.output_ids) - before >= steps - 1


def test_chunked_prefill_matches_oneshot(pair, logit_diff):
    pt = pair[0]
    prompt = np.random.default_rng(4).standard_normal((70, 32)).astype(np.float32)
    eng = engine(pt, num_slots=2, max_len=256, prefill_chunk=32)
    req = Request(request_id=0, input_embeds=prompt, max_new_tokens=5)
    eng.generate([req])
    assert_ids_match_jax(pair, logit_diff, prompt, req.output_ids, 5)


def test_kv_cache_grows_on_demand(pair, logit_diff):
    pt = pair[0]
    prompt = np.random.default_rng(5).standard_normal((100, 32)).astype(np.float32)
    eng = engine(pt, num_slots=2, max_len=512, prefill_chunk=64, init_cache_len=32)
    assert eng.cache_len == 32
    req = Request(request_id=0, input_embeds=prompt, max_new_tokens=4)
    eng.generate([req])
    assert_ids_match_jax(pair, logit_diff, prompt, req.output_ids, 4)
    assert eng.n_cache_grows >= 1 and 104 <= eng.cache_len <= 256


def test_seeded_sampling_reproducible(pair):
    pt = pair[0]
    prompt = np.random.default_rng(6).standard_normal((10, 32)).astype(np.float32)

    def run(seed):
        eng = engine(pt, num_slots=2, max_len=128, seed=seed)
        req = Request(request_id=7, input_embeds=prompt, max_new_tokens=8, temperature=1.0)
        eng.generate([req])
        return req.output_ids

    a, b, c = run(0), run(0), run(1)
    assert a == b and len(a) == 8, (a, b)
    assert a != c  # these seeds draw different tokens at temperature 1


def test_prefix_cache_hits_and_matches(pair, logit_diff):
    pt = pair[0]
    rng = np.random.default_rng(7)
    prefix = rng.standard_normal((12, 32)).astype(np.float32)
    prompts = [np.concatenate([prefix, rng.standard_normal((n, 32)).astype(np.float32)])
               for n in (6, 9, 3)]
    eng = engine(pt, num_slots=1, max_len=64, prefill_chunk=32)
    for i, p in enumerate(prompts):
        req = Request(request_id=i, input_embeds=p, max_new_tokens=5, prefix_len=12)
        eng.generate([req])
        assert_ids_match_jax(pair, logit_diff, p, req.output_ids, 5)
    assert eng.n_prefix_hits == 2 and len(eng.prefix_cache) == 1


def test_prefix_cache_distinct_prefixes_no_false_hit(pair):
    pt = pair[0]
    rng = np.random.default_rng(8)
    eng = engine(pt, num_slots=1, max_len=64)
    a = rng.standard_normal((20, 32)).astype(np.float32)
    b = rng.standard_normal((20, 32)).astype(np.float32)
    ra = Request(request_id=0, input_embeds=a, max_new_tokens=4, prefix_len=10)
    rb = Request(request_id=1, input_embeds=b, max_new_tokens=4, prefix_len=10)
    rc = Request(request_id=2, input_embeds=b, max_new_tokens=4, prefix_len=4)
    for r in (ra, rb, rc):
        eng.generate([r])
    wb = port_greedy(pt, b, 4)
    assert ra.output_ids == port_greedy(pt, a, 4) and rb.output_ids == wb == rc.output_ids
    assert eng.n_prefix_hits == 0 and len(eng.prefix_cache) == 2


@pytest.mark.parametrize("lens,chunk", [([9, 5, 12], 128), ([70, 40], 32)],
                         ids=["one_chunk", "multichunk"])
def test_device_prompt_batch_matches_host_path(pair, logit_diff, lens, chunk):
    """``submit_prompt_batch`` (one (B, T, D) tensor, sliced per chunk) gives the host
    path's ids, over one chunk and over several."""
    pt = pair[0]
    rng = np.random.default_rng(11)
    buf = np.zeros((len(lens), max(lens), 32), np.float32)
    prompts = []
    for i, n in enumerate(lens):
        prompts.append(rng.standard_normal((n, 32)).astype(np.float32))
        buf[i, :n] = prompts[-1]
    host = engine(pt, num_slots=4, max_len=128, prefill_chunk=chunk)
    host_reqs = [Request(request_id=i, input_embeds=p, max_new_tokens=4)
                 for i, p in enumerate(prompts)]
    host.generate(host_reqs)
    dev = engine(pt, num_slots=4, max_len=128, prefill_chunk=chunk)
    dev_reqs = dev.submit_prompt_batch(torch.from_numpy(buf), np.asarray(lens), max_new_tokens=4)
    while any(not r.done for r in dev_reqs):
        if not dev.step():
            break
    for h, d, p in zip(host_reqs, dev_reqs, prompts):
        assert h.output_ids == d.output_ids
    assert_ids_match_jax(pair, logit_diff, prompts[0], dev_reqs[0].output_ids, 4)


@pytest.mark.parametrize("case", ["host_prompts", "device_batch"])
def test_engine_ids_equal_the_jax_engine(pair, logit_diff, case):
    """The port's engine against the JAX package's ``LLMEngine`` on the same requests:
    three host prompts through two slots (continuous batching, chunked prefill), and a
    device prompt batch of two rows over several 32-row chunks; equal ids on every step
    whose JAX naive margin clears MARGIN_FACTOR x the logit difference."""
    from funasr_tpu.llm.engine import LLMEngine as JaxEngine
    from funasr_tpu.llm.engine import Request as JaxRequest

    pt, jm, jp = pair
    rng = np.random.default_rng(12)
    lens = [9, 70, 40] if case == "host_prompts" else [70, 40]
    prompts = [rng.standard_normal((n, 32)).astype(np.float32) for n in lens]
    kw = dict(num_slots=2, max_len=128, prefill_chunk=32)
    port, ref = engine(pt, **kw), JaxEngine(jm, jp, dtype=jnp.float32, **kw)
    if case == "host_prompts":
        got = port.generate([Request(request_id=i, input_embeds=p, max_new_tokens=5)
                             for i, p in enumerate(prompts)])
        want = ref.generate([JaxRequest(request_id=i, input_embeds=p, max_new_tokens=5)
                             for i, p in enumerate(prompts)])
    else:
        buf = np.zeros((2, 70, 32), np.float32)
        for i, p in enumerate(prompts):
            buf[i, :len(p)] = p
        got = port.submit_prompt_batch(torch.from_numpy(buf), np.asarray(lens),
                                       max_new_tokens=5)
        want = ref.submit_prompt_batch(jnp.asarray(buf), np.asarray(lens), max_new_tokens=5)
        for eng, reqs in ((port, got), (ref, want)):
            while any(not r.done for r in reqs):
                if not eng.step():
                    break
    for g, w, p in zip(got, want, prompts):
        _, margins = jax_greedy(jm, jp, p, 5)
        clear = next((i for i, m in enumerate(margins) if m <= MARGIN_FACTOR * logit_diff),
                     len(margins))
        assert len(g.output_ids) == 5 and g.output_ids[:clear] == w.output_ids[:clear]
        print(f"{case}: ids equal to the JAX engine's on {clear} of 5 tokens")
