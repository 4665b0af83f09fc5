"""SeACo-Paraformer (hotword biasing) of the PyTorch port against the JAX package (CPU).

Weights go port ``state_dict()`` -> ``convert_state_dict`` -> JAX, and JAX ->
``params_from_jax`` -> port. The small config: the pipeline's d 64 Paraformer with the
published CifPredictorV3 head, a SeACo decoder of 3 cross-attention layers + 1 FFN layer
at kernel_size 21 (the FSMN kernel's k = 21 instantiation on the card) or 5, NO_BIAS 7.

* the hotword representation (``lstm_apply`` over ``decoder.embed`` rows, 2 layers, last
  valid step) within 1e-5; the SeACo decoder's output and its attention-score probe
  (``forward_asf``) within 2e-4;
* ``SeacoParaformer.inference`` with 0, 3 and 10 hotwords (``nfilter=4``, so attention-
  score filtering runs): token ids and ms timestamps equal, the kept set equal;
* both branches of the NO_BIAS gate taken, with ``hotword_output_layer``'s NO_BIAS bias
  set so that some tokens pick NO_BIAS and some do not;
* ``AutoModel(bf16=True)``: log-probs within the bf16 tolerance and token flips against
  the JAX package's bf16 decode no more than bf16 rounding itself makes against fp32
  (``tests/test_w8a8_production.py``'s method);
* ``AutoModel.generate(batch_size=1)`` over 3 inputs keeps the hotword bias through the
  dispatch / fetch pair; the JAX ``AutoModel`` loses it there (it takes Paraformer's pair);
* the VAD -> SeACo -> punctuation pipeline with ``hotword=``: results equal to the JAX
  pipeline's, which keeps the bias (its ASR batches are never pipelined);
* on the card (``cuda``): the FSMN kernel's (21, 10) instantiation against
  ``fsmn_memory_ref`` and against the generic instantiation.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.core.layers import lstm_apply as jax_lstm_apply
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.seaco_paraformer.model import SeacoParaformer as JaxSeaco
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.layers import encode_hotwords, lstm_apply
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.seaco_paraformer.model import SeacoParaformer
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (NO_BIAS, PIPE_TOKENS, seaco_conf, shape_only_init, t, to_jax,
                               write_punc_dir, write_seaco_dir, write_vad_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
HOTWORDS_3 = "一二 三四五 六"
# 10 words of 2-3 tokens (more than nfilter = 4: attention-score filtering runs)
HOTWORDS_10 = " ".join(chr(0x4E00 + 3 * i) + chr(0x4E00 + 3 * i + 7) + chr(0x4E00 + i + 20) * (i % 2)
                       for i in range(10))


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _pair(kernel_size=21, seed=0):
    conf = seaco_conf(kernel_size=kernel_size)
    pt = SeacoParaformer(**conf, generator=torch.Generator().manual_seed(seed)).eval()
    jm = JaxSeaco(**conf)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm))


@pytest.fixture(scope="module")
def seaco_pair():
    return _pair()


def _waves():
    return [multi_segment_wav(s, seed=i + 3) for i, s in enumerate((1.1, 4.2, 9.0))]


def _toks():
    return CharTokenizer(token_list=PIPE_TOKENS), JaxCharTokenizer(token_list=PIPE_TOKENS)


def test_weights_round_trip_through_jax(seaco_pair):
    pt, jm, params = seaco_pair
    back = SeacoParaformer(**seaco_conf()).eval()
    back.load_state_dict(params_from_jax(_tree(params), back))
    for name, tensor in pt.state_dict().items():
        torch.testing.assert_close(back.state_dict()[name], tensor, rtol=0, atol=0)


def test_hotword_representation_matches_jax(seaco_pair):
    pt, jm, params = seaco_pair
    hw = [[5, 9, 11], [3], [20, 21], [1]]
    with torch.inference_mode():
        rep = encode_hotwords(pt.bias_encoder, pt.decoder.embed[0].weight, hw)
    pad = np.zeros((4, 3), np.int32)
    for i, h in enumerate(hw):
        pad[i, :len(h)] = h
    want = jm._hotword_representation(params, jnp.asarray(pad),
                                      jnp.asarray([len(h) for h in hw], jnp.int32))
    assert rep.shape == (4, 64) and rep.dtype == torch.float32
    np.testing.assert_allclose(rep.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # every step of both layers, on a ragged seeded input
    x = np.random.default_rng(1).standard_normal((3, 5, 64)).astype(np.float32)
    h = jax_lstm_apply(params["bias_encoder"][1], jax_lstm_apply(params["bias_encoder"][0],
                                                                   jnp.asarray(x)))
    with torch.inference_mode():
        np.testing.assert_allclose(lstm_apply(pt.bias_encoder, t(x)).numpy(), np.asarray(h),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel_size", [21, 5])
def test_seaco_decoder_and_probe_match_jax(kernel_size):
    pt, jm, params = _pair(kernel_size, seed=2)
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((2, 6, 64)).astype(np.float32)
    query = rng.standard_normal((2, 30, 64)).astype(np.float32)
    mlens, qlens = np.asarray([6, 6], np.int32), np.asarray([30, 17], np.int32)
    with torch.inference_mode():
        hidden, _ = pt.seaco_decoder(t(memory), t(mlens), t(query), t(qlens), return_hidden=True)
        attn = pt.seaco_decoder.forward_asf(t(memory), t(mlens), t(query), t(qlens))
    args = (params["seaco_decoder"], jnp.asarray(memory), jnp.asarray(mlens),
            jnp.asarray(query), jnp.asarray(qlens))
    want, _ = jm.seaco_decoder(*args, return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    want_attn = jm.seaco_decoder.forward_asf(*args)
    assert attn.shape == (2, 4, 30, 6)  # the probe is layer min(6, 3) - 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=2e-4, rtol=0)


def _kept(probe_owner, calls):
    """Wrap ``probe_owner.forward_asf`` to record each call's ranked scores."""
    inner = probe_owner.forward_asf

    def probe(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(np.asarray(out[0].sum((0, 1)) if not hasattr(out, "numpy")
                                else out[0].sum(dim=(0, 1)).numpy()))
        return out
    return probe


@pytest.mark.parametrize("hotword", [None, HOTWORDS_3, HOTWORDS_10])
def test_seaco_inference_matches_jax(seaco_pair, hotword):
    """Token ids and ms timestamps equal (three rows that bucket to T = 256, B to 4), and
    with more hotwords than nfilter the same kept set."""
    pt, jm, params = seaco_pair
    tok, jtok = _toks()
    port_scores, jax_scores = [], []
    pt.seaco_decoder.forward_asf = _kept(pt.seaco_decoder, port_scores)
    jm.seaco_decoder.forward_asf = _kept(jm.seaco_decoder, jax_scores)
    try:
        got, _ = pt.inference(_waves(), tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                              hotword=hotword, nfilter=4, begin_time=120)
        want, _ = jm.inference(params, _waves(), tokenizer=jtok,
                               frontend=JaxWavFrontend(**FRONTEND), hotword=hotword, nfilter=4,
                               begin_time=120)
    finally:
        del pt.seaco_decoder.forward_asf, jm.seaco_decoder.forward_asf
    assert got == want
    assert all(r["timestamp"] and len(r["timestamp"]) == len(r["text"].split()) for r in got)
    assert len(port_scores) == len(jax_scores) == (hotword == HOTWORDS_10)
    for a, b in zip(port_scores, jax_scores):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
        n = len(a)
        assert set(np.argsort(-a)[: min(4, n - 1)]) == set(np.argsort(-b)[: min(4, n - 1)])
    if hotword is None:  # no hotword: the BiCif decode
        from funasr_tpu_torch.models.bicif_paraformer.model import BiCifParaformer
        base = BiCifParaformer(**{k: v for k, v in seaco_conf().items()
                                  if k not in ("inner_dim", "NO_BIAS", "seaco_decoder",
                                               "seaco_decoder_conf")}).eval()
        base.load_state_dict({k: v for k, v in pt.state_dict().items()
                              if k.split(".")[0] in ("encoder", "decoder", "predictor")})
        assert base.inference(_waves(), tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                              begin_time=120)[0] == got
    else:  # the bias changes the decode
        plain, _ = pt.inference(_waves(), tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                                begin_time=120)
        assert plain != got


def test_seaco_without_upsample_head_matches_jax():
    """A SeACo over a V2 predictor has no upsample head: texts without timestamps, as in
    the JAX package."""
    conf = dict(seaco_conf(), predictor_conf=dict(seaco_conf()["predictor_conf"]))
    for key in ("smooth_factor2", "noise_threshold2", "upsample_times", "use_cif1_cnn",
                "upsample_type"):
        conf["predictor_conf"].pop(key)
    conf["predictor"] = "CifPredictorV2"
    pt = SeacoParaformer(**conf, generator=torch.Generator().manual_seed(5)).eval()
    jm = JaxSeaco(**conf)
    params = to_jax(convert_state_dict(pt.state_dict(), jm))
    tok, jtok = _toks()
    got, _ = pt.inference(_waves(), tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                          hotword=HOTWORDS_3)
    want, _ = jm.inference(params, _waves(), tokenizer=jtok, frontend=JaxWavFrontend(**FRONTEND),
                           hotword=HOTWORDS_3)
    assert got == want and all("timestamp" not in r and r["text"] for r in got)


def _gate_picks(model, waves, hotword):
    """(hotword-head tokens, NO_BIAS tokens, NO_BIAS margins of the hotword head's
    log-probs) over the valid tokens of one decode."""
    seen = []
    gate, decode = model.no_bias_gate, model.cal_decoder_with_predictor
    model.no_bias_gate = lambda dec, dha, lmbd: seen.append(dha) or gate(dec, dha, lmbd)
    model.cal_decoder_with_predictor = lambda *a: seen.append(a[3]) or decode(*a)
    try:
        model.inference(waves, tokenizer=CharTokenizer(token_list=PIPE_TOKENS),
                        frontend=WavFrontend(**FRONTEND), hotword=hotword)
    finally:
        del model.no_bias_gate, model.cal_decoder_with_predictor
    n, dha = seen[-2], seen[-1]
    valid = torch.arange(dha.shape[1])[None] < n[:, None]
    picks = dha.argmax(-1)[valid]
    margins = (dha.max(-1).values - dha[..., NO_BIAS])[valid]
    return int((picks != NO_BIAS).sum()), int((picks == NO_BIAS).sum()), margins


def test_no_bias_gate_takes_both_branches():
    """``hotword_output_layer``'s NO_BIAS bias raised by the median margin, so that about
    half the tokens keep the main decoder's log-probs; the results still equal JAX's."""
    pt, _, _ = _pair(seed=4)
    waves = _waves()
    _, _, margins = _gate_picks(pt, waves, HOTWORDS_3)
    with torch.no_grad():
        pt.hotword_output_layer.bias[NO_BIAS] += float(margins.median()) + 1e-3
    head, no_bias, _ = _gate_picks(pt, waves, HOTWORDS_3)
    assert head > 0 and no_bias > 0, (head, no_bias)
    jm = JaxSeaco(**seaco_conf())
    params = to_jax(convert_state_dict(pt.state_dict(), jm))
    tok, jtok = _toks()
    for weight in (1.0, 0.5):
        got, _ = pt.inference(waves, tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                              hotword=HOTWORDS_3, seaco_weight=weight)
        want, _ = jm.inference(params, waves, tokenizer=jtok,
                               frontend=JaxWavFrontend(**FRONTEND), hotword=HOTWORDS_3,
                               seaco_weight=weight)
        assert got == want


def test_bf16_automodel_matches_jax_bf16(tmp_path):
    """``AutoModel(bf16=True)``: the merged log-probs of the port's bf16 decode within
    0.5 of the JAX package's bf16 decode (bf16 rounds at other places in the two), and
    its token flips against JAX bf16 no more than JAX bf16 makes against JAX fp32."""
    from funasr_tpu.core.module import cast_floats
    from funasr_tpu_torch.utils.bucket import pad_feats_bucketed

    d = write_seaco_dir(tmp_path)
    port = AutoModel(model=d, device="cpu", bf16=True, log_level="WARNING")
    assert port.model.dtype == torch.bfloat16
    jm = JaxSeaco(**seaco_conf())
    params = to_jax(convert_state_dict(torch.load(os.path.join(d, "model.pt")), jm))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((4, 150, 560)).astype(np.float32)
    lens = np.asarray([150, 150, 120, 90], np.int32)
    hw = port.model.decode_context({"hotword": HOTWORDS_10, "nfilter": 4},
                                   port.kwargs["tokenizer"])
    hw_lists = hw["hw_list"]
    sp, ln, _ = pad_feats_bucketed(t(feats), t(lens))

    with torch.inference_mode():
        enc, enc_lens = port.model.encode(sp.to(torch.bfloat16), ln)
        emb, tn, _, _ = port.model.calc_predictor(enc, enc_lens, 80)
        tl = torch.clamp(torch.round(tn).to(torch.int32), 0, emb.shape[1])
        got, _ = port.model.cal_decoder_with_predictor(enc, enc_lens, emb, tl, hw)

    def jax_decode(p, dtype):
        x = jnp.asarray(sp.numpy(), dtype)
        e, el = jm.encode(p, x, jnp.asarray(ln.numpy()))
        em, ptl, _, _ = jm.calc_predictor(p, e, el, 80)
        tl_ = jnp.clip(jnp.round(ptl).astype(jnp.int32), 0, em.shape[1])
        return np.asarray(jm._seaco_decode_with_asf(p, e, el, em, tl_, hw_lists, nfilter=4)), \
            np.asarray(tl_)

    want_bf, tl_bf = jax_decode(cast_floats(params, jnp.bfloat16), jnp.bfloat16)
    want_32, tl_32 = jax_decode(params, jnp.float32)
    np.testing.assert_array_equal(tl.numpy(), tl_bf)
    np.testing.assert_array_equal(tl_bf, tl_32)
    valid = np.arange(got.shape[1])[None] < tl_bf[:, None]
    np.testing.assert_allclose(got.numpy()[valid], want_bf[valid], atol=0.5, rtol=0)
    ids = got.numpy().argmax(-1)[valid]
    flips = int((ids != want_bf.argmax(-1)[valid]).sum())
    floor = int((want_bf.argmax(-1)[valid] != want_32.argmax(-1)[valid]).sum())
    assert valid.sum() >= 50 and flips <= max(floor, 1), (flips, floor, valid.sum())


def test_automodel_keeps_the_hotword_bias_in_the_double_buffered_loop(tmp_path):
    d = write_seaco_dir(tmp_path)
    port = AutoModel(model=d, device="cpu", log_level="WARNING")
    fetched = []
    fetch = port.model.inference_fetch
    port.model.inference_fetch = lambda h: fetched.append(h["context"] is not None) or fetch(h)
    waves = [multi_segment_wav(s, seed=i) for i, s in enumerate((2.0, 3.0, 4.0))]
    got = port.generate(input=waves, batch_size=1, key=["a", "b", "c"], hotword=HOTWORDS_3)
    assert fetched == [True, True, True]  # through the dispatch / fetch pair, biased

    jm = JaxSeaco(**seaco_conf())
    params = to_jax(convert_state_dict(torch.load(os.path.join(d, "model.pt")), jm))
    jtok = JaxCharTokenizer(token_list=PIPE_TOKENS)
    want = [jm.inference(params, [w], key=[k], tokenizer=jtok, hotword=HOTWORDS_3,
                         frontend=JaxWavFrontend(**FRONTEND))[0][0]
            for w, k in zip(waves, "abc")]
    assert got == want and all(r["timestamp"] for r in got)
    plain = port.generate(input=waves, batch_size=1, key=["a", "b", "c"])
    assert [r["text"] for r in plain] != [r["text"] for r in got]
    # the reference fault the port does not copy: the JAX AutoModel pipelines SeACo
    # through Paraformer's pair, which drops the hotword bias and the timestamps
    with shape_only_init():
        ref = jauto.AutoModel(model=d, device="cpu", log_level="WARNING")
    lost = ref.generate(input=waves, batch_size=1, key=["a", "b", "c"], hotword=HOTWORDS_3)
    def chars(rows):
        return [r["text"].replace(" ", "") for r in rows]
    assert chars(lost) == chars(plain) != chars(got)  # Paraformer's text: no spaces either
    assert all("timestamp" not in r for r in lost)


@pytest.fixture(scope="module")
def hotword_pipelines(tmp_path_factory):
    dirs = dict(model=write_seaco_dir(tmp_path_factory.mktemp("seaco")),
                vad_model=write_vad_dir(tmp_path_factory.mktemp("vad")),
                punc_model=write_punc_dir(tmp_path_factory.mktemp("punc")))
    kw = dict(dirs, device="cpu", log_level="WARNING")
    with shape_only_init():
        return AutoModel(**kw), jauto.AutoModel(**kw)


@pytest.mark.parametrize("cfg", [dict(), dict(sentence_timestamp=True, nfilter=4)])
def test_vad_pipeline_with_hotwords_matches_jax(hotword_pipelines, cfg):
    """Each ASR batch of the JAX pipeline runs ``SeacoParaformer.inference`` (one batch
    of at most ``batch_size_s`` of segments is never pipelined), so the bias holds there
    and the whole results compare."""
    port, ref = hotword_pipelines
    waves = [multi_segment_wav(), multi_segment_wav(9.0, seed=3)]
    kw = dict(key=["a", "b"], max_end_silence_time=800, hotword=HOTWORDS_10, **cfg)
    got = port.generate(input=waves, **kw)
    want = ref.generate(input=waves, **kw)
    assert got == want and all(r["timestamp"] for r in got)
    assert all(r["text"] and r["text"][-1] in "。？." for r in got)


def test_port_import_leaves_jax_out():
    code = ("import sys, funasr_tpu_torch as f; "
            "assert 'SeacoParaformer' in f.tables.model_classes; "
            "assert 'ContextualParaformer' in f.tables.model_classes; "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('funasr_tpu.')"
            " or m == 'funasr_tpu']")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


# ---------------------------------------------------------------------------
# on the card: the FSMN kernel's instantiation for the SeACo decoder's k = 21 memory
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(32, 208, 512), (3, 50, 64), (2, 1, 512)])
def test_fsmn_k21_instantiation_matches_plain_on_card(cuda_device, dtype, tol, shape):
    """The SeACo decoder's memory (k = 21, pads 10 / 10) on its contiguous input with a
    prefix mask, against the plain version and the generic instantiation."""
    from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref
    b, n, c = shape
    g = torch.Generator().manual_seed(6)
    x = torch.randn(b, n, c, generator=g).to(cuda_device, dtype)
    w = (torch.rand(c, 1, 21, generator=g) - 0.5).to(cuda_device, dtype)
    lens = torch.tensor([max(n - 17 * i, 1) for i in range(b)], device=cuda_device)
    mask = torch.arange(n, device=cuda_device)[None] < lens[:, None]
    before = fsmn_memory.launches
    got = fsmn_memory(x, w, mask, 10, 10)
    generic = fsmn_memory(x, w, mask, 10, 10, generic=True)
    torch.cuda.synchronize()
    assert fsmn_memory.launches == before + 2
    want = fsmn_memory_ref(x, w, mask, 10, 10)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got, generic, atol=0, rtol=0)
