"""The keyword spotters of the PyTorch port against the JAX package (CPU): ``FsmnKWS`` over
a small FSMN with the lookahead (2 layers, linear 64, proj 32, lorder 10, rorder 2: the
recipe's taps at a narrow width), ``SanmKWS`` over a small SAN-M encoder (2 blocks, d 32)
and ``CTC``, ``FsmnKWSStreaming``, the copied ``utils/kws_utils.py`` and ``KWSDataset``.
The same weights in both packages: the port's seeded init through ``convert_state_dict``,
``params_from_jax`` back. The output layers are sharpened (x10 the FSMN's, x2 the CTC
head over the SAN-M encoder, whose scores then sum to a few hundred, where float32 sums
hold 1e-4) and blank's logit raised by 3
(the seeded heads' posteriors are near uniform, under the prefix beam's 0.05 floor, and
without blank among a frame's top 3 the beam dies: ``test_prefix_beam_dies_...``).

Limits:

* the FSMN encoder with rorder 2 and 3, offline and in 3 chunks with its cache: within
  1e-6 of max |y| of JAX's (the CPU block keeps JAX's order: the left memory, then the
  lookahead). The fused route the card takes (one ``fsmn_memory`` at k = lorder + rorder,
  pads (lorder - 1, rorder)) within 1e-6 relative L2 of the CPU block, and one launch a
  block on a device that is not the CPU (meta tensors through a recording
  ``fsmn_memory``); rorder 0 keeps its k = lorder, pads (lorder - 1, 0) launch;
* ``inference`` in both decode modes: hits and frames equal, scores within 1e-4 (each side
  rounds to 4 places); ``detect`` scores within 1e-4 and ``detected`` equal;
  ``detect_chunk`` over 3 chunks equal, scores within 1e-4;
* ``forward`` loss within 1e-5 relative, every gradient (``conv_right``'s included) within
  1e-4 relative L2 of ``jax.jit(jax.value_and_grad(forward_jit))``;
* ``kws_utils`` equal to the original on the JAX test's cases and 20 seeded posteriors;
  ``KWSDataset`` items equal, with and without the jsonl ``label``;
* ``AutoModel(model=<FsmnKWS dir>).generate(input=wav, keywords=...)`` equal to the JAX
  model's ``inference``, the keywords as a string and as a list.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
import funasr_tpu.models.fsmn_kws.model as jkws_model
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.register import tables as jtables
from funasr_tpu.utils import kws_utils as jkws
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.fsmn_vad_streaming import encoder as enc_mod
from funasr_tpu_torch.ops.fsmn import DW_SPECIALISED, dw_plan, fsmn_memory_ref
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils import kws_utils as pkws
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import _write_config, _write_tokens, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(20)] + ["<unk>"]
V = len(TOKENS)
FSMN_CONF = dict(input_dim=400, input_affine_dim=48, fsmn_layers=2, linear_dim=64,
                 proj_dim=32, lorder=10, rorder=2, lstride=1, rstride=1,
                 output_affine_dim=48, output_dim=V, use_softmax=False)
SANM_CONF = dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
                 kernel_size=11, sanm_shfit=0)
FRONTEND = dict(fs=16000, lfr_m=5, lfr_n=1, n_mels=80, dither=0.0)
ENC_TOL = 1e-6
SCORE_TOL = 1e-4


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def model_conf(kind, **fsmn):
    if kind == "fsmn":
        return dict(encoder="FSMN", encoder_conf=dict(FSMN_CONF, **fsmn), input_size=400,
                    vocab_size=V)
    return dict(encoder="SANMEncoder", encoder_conf=SANM_CONF, input_size=400, vocab_size=V)


def build(name, kind, seed=0, **fsmn):
    conf = model_conf(kind, **fsmn)
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # a sharper head, blank the likeliest token as in trained CTC
        head = pt.encoder.out_linear2.linear if kind == "fsmn" else pt.ctc.ctc_lo
        head.weight.mul_(10.0 if kind == "fsmn" else 2.0)
        head.bias[0] += 3.0
    jm = jtables.model_classes[name](**conf)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm, name))
    return pt.eval(), jm, tree


@pytest.fixture(scope="module", params=["fsmn", "sanm"])
def pair(request):
    # the FSMN through a streaming / multi-task name (the offline methods are shared)
    return request.param, build("FsmnKWSMT" if request.param == "fsmn" else "SanmKWS",
                                request.param)


def wavs(seed=5, lengths=(16000, 11000)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


def tokenizer():
    return CharTokenizer(token_list=TOKENS)


def test_params_round_trip(pair):
    _, (pt, _, tree) = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


# ---- the FSMN with its lookahead ------------------------------------------------------


@pytest.mark.parametrize("lorder,rorder", [(10, 2), (5, 3)])
def test_lookahead_encoder_matches_jax_offline_and_chunked(lorder, rorder):
    pt, jm, tree = build("FsmnKWS", "fsmn", seed=lorder, lorder=lorder, rorder=rorder)
    jp = to_jax(tree)["encoder"]
    x = np.random.default_rng(rorder).standard_normal((2, 47, 400)).astype(np.float32)
    with torch.no_grad():
        got = pt.encoder(t(x)).numpy()
    close(got, np.asarray(jm.encoder(jp, jnp.asarray(x))), ENC_TOL)
    tcache, jcache = {}, {}
    for part in np.array_split(x, 3, axis=1):
        with torch.no_grad():
            got = pt.encoder(t(part), cache=tcache).numpy()
        close(got, np.asarray(jm.encoder(jp, jnp.asarray(part), cache=jcache)), ENC_TOL)
    for i in range(FSMN_CONF["fsmn_layers"]):
        key = f"cache_layer_{i}"
        close(tcache[key].numpy(), np.asarray(jcache[key]), ENC_TOL)


def recorded_block(monkeypatch, lorder, rorder, device):
    """A block whose ``fsmn_memory`` calls are recorded (meta tensors: shapes only)."""
    calls = []

    def record(x, w, mask, left, right, **kw):
        calls.append((tuple(x.shape), tuple(w.shape), left, right))
        return x.new_empty(x.shape)

    monkeypatch.setattr(enc_mod, "fsmn_memory", record)
    block = enc_mod.FSMNBlock(32, lorder, rorder).to(device)
    return block, calls


@pytest.mark.parametrize("lorder,rorder", [(10, 2), (5, 3), (20, 0)])
def test_block_launches_once_off_the_cpu(monkeypatch, lorder, rorder):
    """Off the CPU a block is one ``fsmn_memory`` call: k = lorder + rorder, pads (lorder -
    1, rorder), offline and with a cache (over concat(cache, h), the first lorder - 1 rows
    dropped); no ``NotImplementedError``."""
    block, calls = recorded_block(monkeypatch, lorder, rorder, "meta")
    h = torch.empty(2, 30, 32, device="meta")
    out, _ = block(h)
    cache = torch.empty(2, lorder - 1, 32, device="meta")
    out_c, new_cache = block(h, cache)
    k = lorder + rorder
    assert calls == [((2, 30, 32), (32, 1, k), lorder - 1, rorder),
                     ((2, 30 + lorder - 1, 32), (32, 1, k), lorder - 1, rorder)]
    assert out.shape == out_c.shape == (2, 30, 32) and new_cache.shape == (2, lorder - 1, 32)


def test_cpu_block_keeps_jax_order_and_the_fused_route_agrees(monkeypatch):
    """On the CPU the block is ``fsmn_memory`` over the left taps, then the lookahead
    (two calls' worth of rounding, JAX's); the card's fused conv at k 12 agrees within
    1e-6 relative L2, offline and with a cache, and its taps are ``[conv_left |
    conv_right]`` with the right half reading frames t + 1 .. t + 2 (rows at both ends
    included)."""
    torch.manual_seed(0)
    block = enc_mod.FSMNBlock(32, 10, 2)
    with torch.no_grad():
        block.conv_left.weight.uniform_(-0.5, 0.5)
        block.conv_right.weight.copy_(torch.tensor([0.7, -1.3])[None, None, :, None])
    h = torch.randn(2, 23, 32)
    cache = torch.randn(2, 9, 32)
    w = torch.cat([block.conv_left.weight.reshape(32, 1, 10),
                   block.conv_right.weight.reshape(32, 1, 2)], dim=-1)
    with torch.no_grad():
        off, _ = block(h)
        on, _ = block(h, cache)
    fused_off = fsmn_memory_ref(h, w, None, 9, 2)
    fused_on = fsmn_memory_ref(torch.cat([cache, h], 1), w, None, 9, 2)[:, 9:]
    for got, want in ((fused_off, off), (fused_on, on)):
        assert ((got - want).norm() / want.norm()).item() <= ENC_TOL
    # the lookahead's two taps in order, zero past the end
    left_only = enc_mod.FSMNBlock(32, 10, 0)
    with torch.no_grad():
        left_only.conv_left.weight.copy_(block.conv_left.weight)
        look = off - left_only(h)[0]
    want = 0.7 * h[:, 1:] + -1.3 * torch.nn.functional.pad(h[:, 2:], (0, 0, 0, 1))
    np.testing.assert_allclose(look[:, :-1].numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(look[:, -1].numpy(), 0.0, atol=0)


def test_weight_gradient_plans_the_vector_kernel_at_12_9():
    assert (12, 9) in DW_SPECIALISED
    assert dw_plan(8, 300, 128, 12, 9, 132)[0] and not dw_plan(8, 300, 128, 12, 2, 132)[0]


# ---- the models ------------------------------------------------------------------------


def feats(wav_list):
    fe = WavFrontend(**FRONTEND)
    return fe.extract(wav_list)


def test_detect_scores_match_jax(pair):
    _, (pt, jm, tree) = pair
    speech, lens = feats(wavs())
    kw = [[3, 4], [7, 8, 9], [12]]
    got = pt.detect(speech, lens, kw, threshold=-5.0)
    want = jm.detect(to_jax(tree), speech, lens, kw, threshold=-5.0)
    for gu, wu in zip(got, want):
        for g, w in zip(gu, wu):
            assert g["keyword_idx"] == w["keyword_idx"]
            assert abs(g["score"] - w["score"]) <= SCORE_TOL
            if abs(w["score"] + 5.0) > 10 * abs(g["score"] - w["score"]):
                assert g["detected"] == w["detected"]


def greedy_keywords(pt, wav):
    """Keywords of the model's own path (each frame's likeliest token but blank,
    repeats collapsed) and one of two fixed tokens."""
    speech, lens = feats([wav])
    logp, _ = pt.log_probs(speech, lens)
    path = [int(i) + 1 for i in logp[0, :, 1:].argmax(-1)]
    ids = [a for a, b in zip(path, [-1] + path[:-1]) if a != b and a >= 3 and a < V - 1]
    words = ["".join(TOKENS[i] for i in ids[:2]), "".join(TOKENS[i] for i in ids[2:5])]
    return [w for w in words if w] + [TOKENS[5] + TOKENS[6]]


@pytest.mark.parametrize("mode", ["forced_align", "prefix_beam"])
def test_inference_matches_jax_in_both_decode_modes(pair, mode):
    _, (pt, jm, tree) = pair
    wav_list = wavs()
    keywords = greedy_keywords(pt, wav_list[0])
    cfg = dict(keywords=",".join(keywords), decode_mode=mode, kws_threshold=-3.0)
    got, _ = pt.inference(wav_list, key=["a", "b"], tokenizer=tokenizer(),
                          frontend=WavFrontend(**FRONTEND), **cfg)
    want, _ = jm.inference(to_jax(tree), wav_list, key=["a", "b"], tokenizer=tokenizer(),
                           frontend=JaxWavFrontend(**FRONTEND), **cfg)
    assert [r["key"] for r in got] == ["a", "b"]
    for g, w in zip(got, want):
        assert len(g["value"]) == len(w["value"])
        for gh, wh in zip(g["value"], w["value"]):
            assert gh["keyword"] == wh["keyword"] and gh.get("frames") == wh.get("frames")
            assert abs(gh["score"] - wh["score"]) <= SCORE_TOL + 1e-9
    if mode == "prefix_beam":
        assert any(r["value"] for r in got)  # the greedy path's keyword is found
    empty, _ = pt.inference(wav_list[:1], tokenizer=None, frontend=WavFrontend(**FRONTEND),
                            keywords="一丁")
    assert empty == [{"key": "rand_key_0", "value": []}]


def test_detect_chunk_matches_jax():
    pt, jm, tree = build("FsmnKWSMT", "fsmn", seed=2)
    jp = to_jax(tree)
    speech, _ = feats(wavs()[:1])
    kw = [[3, 4], [7, 8, 9]]
    tcache, jcache = pt.init_cache(), jm.init_cache()
    for part in np.array_split(speech, 3, axis=1):
        got = pt.detect_chunk(part, tcache, kw, threshold=-100.0)
        want = jm.detect_chunk(jp, part, jcache, kw, threshold=-100.0)
        assert [g["keyword_idx"] for g in got] == [w["keyword_idx"] for w in want]
        for g, w in zip(got, want):
            assert abs(g["score"] - w["score"]) <= SCORE_TOL
    assert len(got) == 2
    np.testing.assert_allclose(tcache["logp_window"], jcache["logp_window"], atol=1e-5)


def batch(seed=3):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((3, 60, 400)).astype(np.float32)
    slen = np.asarray([60, 44, 25], np.int32)
    tlen = np.asarray([5, 3, 2], np.int32)
    text = np.full((3, 5), -1, np.int32)
    for i in range(3):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    return speech, slen, text, tlen


def test_loss_and_grads_match_jax(pair):
    """The CTC loss over the batch and every gradient, the FSMN's ``conv_right`` among
    them (the lookahead's taps) or the SAN-M encoder's and the CTC head's."""
    kind, (pt, jm, tree) = pair
    check_loss_stats_grads(pt, jm, tree, *batch())
    if kind == "fsmn":
        grad = pt.encoder.fsmn[0].fsmn_block.conv_right.weight.grad
        assert grad is not None and grad.abs().sum() > 0


# ---- host code -------------------------------------------------------------------------


def test_kws_utils_cases_of_the_jax_test():
    got = pkws.split_mixed_label("小爱hello同学")
    assert got == jkws.split_mixed_label("小爱hello同学") == ["小", "爱", "hello", "同", "学"]
    table = {"小": 3, "爱": 4, "hello": 5, "<unk>": 1, "<blank>": 0, "sil": 2}
    for txt in ("小爱", "hello", "新", "小(sil)爱<noise>", "<blank>hello"):
        assert pkws.query_token_set(txt, table) == jkws.query_token_set(txt, table)
    token_list = ["<blank>"] + [chr(ord("一") + i) for i in range(9)]
    probs = np.full((20, 10), 0.1 / 9, np.float32)
    probs[:, 0] = 0.9
    for i, tok in enumerate([3, 4, 5]):
        probs[2 + 3 * i] = 0.1 / 9
        probs[2 + 3 * i, tok] = 0.9
    for kw in (token_list[3] + token_list[4] + token_list[5], token_list[7] + token_list[8]):
        got = pkws.KwsCtcPrefixDecoder(keywords=kw, token_list=token_list).decode(probs)
        want = jkws.KwsCtcPrefixDecoder(keywords=kw, token_list=token_list).decode(probs)
        assert got == want
    assert got[0] is False


@pytest.mark.parametrize("seed", range(20))
def test_kws_prefix_decoder_equal_on_seeded_posteriors(seed):
    rng = np.random.default_rng(seed)
    token_list = ["<blank>"] + [chr(ord("一") + i) for i in range(11)]
    logits = rng.standard_normal((40, 12)) * 3
    logits[:, 0] += 1.5
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    kws = ",".join("".join(token_list[j] for j in rng.integers(1, 12, rng.integers(1, 4)))
                   for _ in range(3))
    dec = (pkws.KwsCtcPrefixDecoder(kws, token_list), jkws.KwsCtcPrefixDecoder(kws, token_list))
    assert dec[0].decode(probs) == dec[1].decode(probs)
    assert dec[0].beam_search(probs, None) == dec[1].beam_search(probs, None)


def test_prefix_beam_dies_without_blank_in_both_packages():
    """A reference oddity, kept: a hypothesis extends its last token only while that
    path's probability exceeds 1e-6 (``math.isclose(pnb, 0.0, abs_tol=1e-6)`` on raw
    probabilities), so when a frame's only candidate repeats the last token of every
    hypothesis and no blank is among the top 3, the beam empties and stays empty: 30
    frames of p 0.6 for the keyword's one token find nothing."""
    token_list = ["<blank>", "一", "丁", "七", "丄"]
    probs = np.tile(np.asarray([0.04, 0.6, 0.12, 0.12, 0.12], np.float32), (30, 1))
    for mod in (pkws, jkws):
        dec = mod.KwsCtcPrefixDecoder("一", token_list)
        assert dec.beam_search(probs[:20], dec.keywords_idxset)  # alive at 0.6^20
        assert dec.beam_search(probs, dec.keywords_idxset) == []
        assert dec.decode(probs) == (False, None, None, None)


def test_kws_dataset_items_equal_jax(tmp_path):
    from torch_parity_util import wav_bytes
    rng = np.random.default_rng(9)
    rows = []
    for i in range(3):
        path = str(tmp_path / f"k{i}.wav")
        with open(path, "wb") as f:
            f.write(wav_bytes(0.2 * rng.standard_normal(8000 + 1000 * i)))
        row = {"source": path, "target": TOKENS[3 + i] + TOKENS[4 + i], "key": f"k{i}",
               "source_len": 50, "target_len": 2}
        if i != 1:
            row["label"] = i % 2
        rows.append(row)
    jsonl = str(tmp_path / "kws.jsonl")
    with open(jsonl, "w", encoding="utf-8") as f:
        f.write("\n".join(json.dumps(r, ensure_ascii=False) for r in rows) + "\n")
    tok = tokenizer()
    port = tables.dataset_classes["KWSDataset"](
        index_ds="IndexDSJsonl", index_ds_conf={"path": jsonl}, tokenizer=tok,
        frontend=WavFrontend(**FRONTEND))
    ref = jtables.dataset_classes["KWSDataset"](
        index_ds="IndexDSJsonl", index_ds_conf={"path": jsonl}, tokenizer=tok,
        frontend=JaxWavFrontend(**FRONTEND))
    assert tables.dataset_classes["KwsMTDataset"] is type(port)
    for i in range(3):
        got, want = port[i], ref[i]
        assert set(got) == set(want) and got["is_keyword"] == want["is_keyword"]
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(got[k], v, atol=1e-3, err_msg=k)
            else:
                assert got[k] == v, k
    assert [port[i]["is_keyword"] for i in range(3)] == [0, 1, 0]


# ---- the public entry point ------------------------------------------------------------


def write_kws_dir(d, pt):
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, TOKENS)
    return _write_config(d, dict(
        model="FsmnKWS", model_conf=dict(ctc_weight=1.0), encoder="FSMN",
        encoder_conf=FSMN_CONF, frontend="WavFrontend", frontend_conf=FRONTEND,
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def test_automodel_generate_with_keywords_matches_jax(tmp_path):
    pt, jm, tree = build("FsmnKWS", "fsmn", seed=4)
    d = write_kws_dir(str(tmp_path), pt)
    am = AutoModel(model=d, device="cpu", log_level="WARNING")
    wav = wavs()[0]
    keywords = greedy_keywords(pt, wav)
    calls = []
    original = am.model.inference
    am.model.inference = lambda *a, **k: calls.append(k.get("keywords")) or original(*a, **k)
    for kw in (",".join(keywords), keywords):
        got = am.generate(input=wav, keywords=kw, kws_threshold=-3.0)
        want, _ = jm.inference(to_jax(tree), [wav], key=[got[0]["key"]], tokenizer=tokenizer(),
                               frontend=JaxWavFrontend(**FRONTEND), keywords=kw,
                               kws_threshold=-3.0)
        assert [h["keyword"] for h in got[0]["value"]] == [h["keyword"] for h in
                                                             want[0]["value"]]
        for g, w in zip(got[0]["value"], want[0]["value"]):
            assert abs(g["score"] - w["score"]) <= SCORE_TOL + 1e-9
    assert calls == [",".join(keywords), keywords]
    assert jkws_model.FsmnKWS is jtables.model_classes["FsmnKWS"]
