"""The CTC family of the PyTorch port against the JAX package (CPU), small configs (2
encoder + 2 decoder blocks, d = 64), the same weights in both packages:

* ``CTCModel`` (model "CTC"): ids and texts, weights both ways; the CTC head's
  log-probs and argmax;
* Paraformer with ``ctc_weight > 0`` builds its CTC head, loads such a checkpoint (the
  port's state dict through the JAX converter, and a model dir through both
  ``AutoModel``s) and decodes as without it;
* Paraformer-v2: its CTC head built at any ``ctc_weight``; ``map_path_to_target_index``
  / ``compress_ctc_probs`` equal, ids equal at a given budget, and ``inference`` texts
  equal on audio whose CTC segments overrun the T/2 + 16 budget, so the full-budget
  retry runs in both;
* E-Paraformer: the PIF predictor's embeddings within 2e-4 with and without
  ``target_length``, ids equal; the port's dispatch / fetch pair decodes it, where the
  JAX fetch raises on the predictor's missing fires (ROADMAP section 3);
* ``MonotonicAligner`` (fa-zh): timestamps equal through both ``AutoModel``s over (audio,
  text) pairs;
* the copied host functions: ``ctc_forced_align`` / ``ctc_forced_align_batch`` (an empty
  target and repeated labels included), ``rich_transcription_postprocess``; and the
  ``SentencepiecesTokenizer`` registration, import-gated.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import (SD, convert_ctc, convert_paraformer,
                                             convert_paraformer_v2, convert_sanm_encoder)
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.ctc.model import CTCModel as JaxCTCModel
from funasr_tpu.models.e_paraformer.model import EParaformer as JaxEParaformer
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.models.paraformer.model import _infer_program
from funasr_tpu.models.paraformer_v2 import model as jv2
from funasr_tpu.ops import ctc_align as jalign
from funasr_tpu.register import tables as jtables
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu.utils import postprocess_utils as jpost
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.auto.auto_model import dispatch_pair
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.ctc.model import CTCModel
from funasr_tpu_torch.models.e_paraformer.model import EParaformer
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.models.paraformer_v2 import model as pv2
from funasr_tpu_torch.ops import ctc_align
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils import postprocess_utils
from funasr_tpu_torch.utils.bucket import pad_feats_bucketed
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (BICIF_PREDICTOR, PIPE_ASR_CONF, PIPE_TOKENS, SMALL_CONF, TOKENS,
                               _write_asr_family, _write_config, _write_tokens, t, to_jax,
                               write_identity_cmvn)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
TOL = 2e-4
CTC_CONF = dict(input_size=560, vocab_size=len(TOKENS), encoder="SANMEncoder",
                encoder_conf=SMALL_CONF["encoder_conf"])
V2_CONF = dict({k: v for k, v in SMALL_CONF.items() if k != "predictor_conf"}, ctc_weight=0.5)
EP_CONF = dict(SMALL_CONF, predictor_conf=dict(idim=64, l_order=1, r_order=1, sigma=0.5,
                                               bias=0.0, sigma_heads=4))


def _feats(waves):
    return WavFrontend(**FRONTEND).extract(waves)


def _waves(*seconds):
    return [multi_segment_wav(s, seed=i + 1) for i, s in enumerate(seconds)]


# ---------------------------------------------------------------------------
# CTCModel
# ---------------------------------------------------------------------------

def _jax_ctc_params(pt, jm):
    sd = SD(pt.state_dict())
    return to_jax({"encoder": convert_sanm_encoder(sd.sub("encoder"),
                                                   jm.encoder.cfg.num_blocks),
                   "ctc": convert_ctc(sd.sub("ctc"))})


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ctc_model_ids_and_texts_match_jax(direction):
    jm = JaxCTCModel(**CTC_CONF)
    if direction == "port_to_jax":
        pt = CTCModel(**CTC_CONF, generator=torch.Generator().manual_seed(0)).eval()
        params = _jax_ctc_params(pt, jm)
    else:
        params = jm.init_params(jax.random.PRNGKey(1))
        pt = CTCModel(**CTC_CONF).eval()
        pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    feats, lens = _feats(_waves(3.0, 1.7, 2.4))
    want_path, _ = jm.infer_jit(params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got_path, _ = pt.infer(t(feats), t(lens))
    np.testing.assert_array_equal(got_path.numpy(), np.asarray(want_path))
    waves = _waves(3.0, 1.7, 2.4)
    got, _ = pt.inference(waves, tokenizer=CharTokenizer(token_list=TOKENS),
                          frontend=WavFrontend(**FRONTEND))
    want, _ = jm.inference(params, waves, tokenizer=JaxCharTokenizer(token_list=TOKENS),
                           frontend=JaxWavFrontend(**FRONTEND))
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert all(r["text"] for r in got)
    ids, _ = pt.inference(waves, frontend=WavFrontend(**FRONTEND))
    assert [r["token_int"] for r in ids] == [r["token_int"] for r in
                                              jm.inference(params, waves,
                                                           frontend=JaxWavFrontend(**FRONTEND))[0]]


def test_ctc_head_log_softmax_and_argmax_match_jax():
    from funasr_tpu.models.ctc.ctc import CTC as JaxCTC
    from funasr_tpu_torch.models.ctc.ctc import CTC

    torch.manual_seed(0)
    pt = CTC(odim=len(TOKENS), encoder_output_size=64)
    jm = JaxCTC(odim=len(TOKENS), encoder_output_size=64)
    params = to_jax(convert_ctc(SD(pt.state_dict())))
    hs = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    with torch.no_grad():
        got_logp, got_ids = pt.log_softmax(t(hs)), pt.argmax(t(hs))
    np.testing.assert_allclose(got_logp.numpy(), np.asarray(jm.log_softmax(params, hs)),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(jm.argmax(params, hs)))


# ---------------------------------------------------------------------------
# Paraformer's CTC head
# ---------------------------------------------------------------------------

def test_paraformer_with_a_ctc_head_builds_loads_and_decodes_as_without():
    conf = dict(SMALL_CONF, ctc_weight=0.3)
    pt = Paraformer(**conf, generator=torch.Generator().manual_seed(0)).eval()
    sd = pt.state_dict()
    assert sd["ctc.ctc_lo.weight"].shape == (len(TOKENS), 64)
    jm = JaxParaformer(**conf)
    params = to_jax(convert_paraformer(sd, jm))
    assert "ctc" in params  # the JAX converter keeps the head too
    plain = Paraformer(**SMALL_CONF).eval()
    plain.load_state_dict({k: v for k, v in sd.items() if not k.startswith("ctc.")})
    feats, lens = _feats(_waves(3.0, 2.0))
    got = pt.infer_bucketed(feats, lens)
    np.testing.assert_array_equal(got[0], plain.infer_bucketed(feats, lens)[0])
    sp, ln, b = pad_feats_bucketed(torch.from_numpy(feats), torch.from_numpy(lens))
    want = _infer_program(jm, params, jnp.asarray(sp.numpy()), jnp.asarray(ln.numpy()),
                          pt._max_tokens_for(sp.shape[1]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1])[:b])
    for i, n in enumerate(got[1]):
        np.testing.assert_array_equal(got[0][i, :n], np.asarray(want[0])[i, :n])
    back = Paraformer(**conf).eval()
    back.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), back))
    assert torch.equal(back.ctc.ctc_lo.weight, pt.ctc.ctc_lo.weight)


def test_automodel_loads_a_ctc_weight_checkpoint(tmp_path):
    conf = dict(PIPE_ASR_CONF, ctc_weight=0.3)
    model = Paraformer(**conf, generator=torch.Generator().manual_seed(0))
    d = _write_asr_family(tmp_path, "Paraformer", model, conf, {})
    _rewrite(d, lambda cfg: cfg["model_conf"].update(ctc_weight=0.3))
    kw = dict(model=d, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    assert port.model.ctc is not None
    waves = _waves(3.0, 2.0)
    got, want = port.generate(input=waves, batch_size=2), ref.generate(input=waves, batch_size=2)
    assert [r["text"] for r in got] == [r["text"] for r in want]


def _rewrite(d, edit):
    import os

    import yaml
    path = os.path.join(d, "config.yaml")
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    edit(cfg)
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


# ---------------------------------------------------------------------------
# Paraformer-v2
# ---------------------------------------------------------------------------

def test_path_to_target_index_and_compression_match_jax():
    rng = np.random.default_rng(0)
    path = rng.integers(0, 4, (3, 40)).astype(np.int32)  # blanks, repeats, changes
    path[1, 10:20] = 2  # one long run
    lens = np.asarray([40, 27, 33])
    valid = np.arange(40)[None] < lens[:, None]
    got_idx = pv2.map_path_to_target_index(t(path), 0)
    want_idx = np.asarray(jv2.map_path_to_target_index(jnp.asarray(path), 0))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    probs = rng.dirichlet(np.ones(7), (3, 40)).astype(np.float32)
    for k in (int(want_idx.max()) + 3, 6):  # all segments; segments past k dropped
        got, got_n = pv2.compress_ctc_probs(t(probs), got_idx, t(valid), k)
        want, want_n = jv2.compress_ctc_probs(jnp.asarray(probs), jnp.asarray(want_idx),
                                              jnp.asarray(valid), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.fixture(scope="module")
def v2_pair():
    pt = pv2.ParaformerV2(**V2_CONF, generator=torch.Generator().manual_seed(0)).eval()
    jm = jtables.model_classes["ParaformerV2"](**V2_CONF)
    return pt, jm, to_jax(convert_paraformer_v2(pt.state_dict(), jm))


@pytest.mark.parametrize("ctc_weight", [0.0, 0.5])
def test_paraformer_v2_builds_its_ctc_head_at_any_weight_as_jax(ctc_weight):
    conf = dict(V2_CONF, ctc_weight=ctc_weight)
    pt = pv2.ParaformerV2(**conf)
    jm = jtables.model_classes["ParaformerV2"](**conf)
    assert pt.ctc is not None and jm.ctc is not None
    assert pt.ctc.ctc_lo.weight.shape == (len(TOKENS), 64)


def test_paraformer_v2_ids_match_jax(v2_pair):
    pt, jm, params = v2_pair
    assert pt.predictor is None and pt.ctc is not None
    assert "decoder.embed.0.weight" in pt.state_dict()
    feats, lens = _feats(_waves(3.0, 1.5, 2.2))
    sp, ln, _ = pad_feats_bucketed(torch.from_numpy(feats), torch.from_numpy(lens))
    for k in (24, 80):
        want = jm.infer_jit(params, jnp.asarray(sp.numpy()), jnp.asarray(ln.numpy()),
                            max_tokens=k)
        with torch.no_grad():
            got = pt.infer_core(sp, ln, k)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=0)
    back = pv2.ParaformerV2(**V2_CONF).eval()
    back.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), back))
    for name, tensor in pt.state_dict().items():
        assert torch.equal(back.state_dict()[name], tensor), name


def test_paraformer_v2_inference_retries_the_full_budget_as_jax(v2_pair, caplog,
                                                                monkeypatch):
    """The random-weight CTC path has ~76 segments in 10 s (T = 256), under the T/2 + 16
    = 144 budget; at a budget ratio of 0.05 (28 tokens at T = 256) both packages
    overrun it and re-decode at T + 1."""
    pt, jm, params = v2_pair
    for model in (pt, jm):
        monkeypatch.setattr(model, "MAX_TOKENS_RATIO", 0.05, raising=False)
    waves = [np.random.default_rng(4).standard_normal(160000).astype(np.float32) * 0.1,
             multi_segment_wav(3.0, seed=2)]
    with caplog.at_level(logging.WARNING):
        got, _ = pt.inference(waves, tokenizer=CharTokenizer(token_list=TOKENS),
                              frontend=WavFrontend(**FRONTEND))
    assert "re-decoding with the full budget" in caplog.text
    want, _ = jm.inference(params, waves, tokenizer=JaxCharTokenizer(token_list=TOKENS),
                           frontend=JaxWavFrontend(**FRONTEND))
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert len(got[0]["text"]) > 28
    assert dispatch_pair(pt) is not None


# ---------------------------------------------------------------------------
# E-Paraformer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ep_pair():
    pt = EParaformer(**EP_CONF, generator=torch.Generator().manual_seed(0)).eval()
    g = np.random.default_rng(7)
    with torch.no_grad():  # per-head sigma and bias away from their constant init
        pt.predictor.sigma.copy_(t(g.uniform(0.3, 0.9, 4).astype(np.float32)))
        pt.predictor.bias.copy_(t(g.normal(0, 0.5, 4).astype(np.float32)))
    jm = JaxEParaformer(**EP_CONF)
    return pt, jm, to_jax(convert_paraformer(pt.state_dict(), jm))


@pytest.mark.parametrize("target", [False, True])
def test_pif_predictor_matches_jax(ep_pair, target):
    pt, jm, params = ep_pair
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 30, 64)).astype(np.float32)
    lens = np.asarray([30, 17, 24])
    mask = np.arange(30)[None] < lens[:, None]
    tl = np.asarray([5, 9, 2], np.int32) if target else None
    want = jm.predictor(params["predictor"], jnp.asarray(hidden), jnp.asarray(mask), 12,
                        target_length=None if tl is None else jnp.asarray(tl))
    with torch.no_grad():
        got = pt.predictor(t(hidden), t(mask), 12, None if tl is None else t(tl))
    assert got[3] is None and want[3] is None
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=TOL, rtol=0)
    assert np.abs(got[0].numpy()).max() > 0.1


def test_e_paraformer_ids_match_jax_and_the_pair_decodes(ep_pair):
    pt, jm, params = ep_pair
    waves = _waves(3.0, 1.5, 2.2)
    feats, lens = _feats(waves)
    sp, ln, _ = pad_feats_bucketed(torch.from_numpy(feats), torch.from_numpy(lens))
    mt = pt._max_tokens_for(sp.shape[1])
    want = _infer_program(jm, params, jnp.asarray(sp.numpy()), jnp.asarray(ln.numpy()), mt)
    with torch.no_grad():
        yseq, token_lens, _, _ = pt.decode_outputs(sp, ln, mt, timestamps=True)
    np.testing.assert_array_equal(token_lens.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(yseq.numpy(), np.asarray(want[0]))
    assert want[4] is None  # no fires: the JAX fetch indexes them and raises
    tok = CharTokenizer(token_list=TOKENS)
    got, _ = pt.inference(waves, tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                          pred_timestamp=True)
    ids = [[int(i) for i in yseq[r, :token_lens[r]] if int(i) not in (0, 1, 2)]
           for r in range(len(waves))]
    assert [r["text"] for r in got] == [
        postprocess_utils.sentence_postprocess(tok.ids2tokens(i))[0] for i in ids]
    with pytest.raises(IndexError):
        jm.inference(params, waves, tokenizer=JaxCharTokenizer(token_list=TOKENS),
                     frontend=JaxWavFrontend(**FRONTEND))


# ---------------------------------------------------------------------------
# MonotonicAligner (fa-zh)
# ---------------------------------------------------------------------------

ALIGNER_CONF = dict(input_size=560, encoder="SANMEncoder",
                    encoder_conf=PIPE_ASR_CONF["encoder_conf"], predictor="CifPredictorV3",
                    predictor_conf=BICIF_PREDICTOR)


def write_aligner_dir(d, seed=0):
    import os

    from funasr_tpu_torch.models.monotonic_aligner.model import MonotonicAligner
    model = MonotonicAligner(**ALIGNER_CONF, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PIPE_TOKENS)
    write_identity_cmvn(os.path.join(d, "am.mvn"), 560)
    return _write_config(d, dict(
        model="MonotonicAligner", model_conf=dict(predictor_bias=0),
        encoder="SANMEncoder", encoder_conf=ALIGNER_CONF["encoder_conf"],
        predictor="CifPredictorV3", predictor_conf=BICIF_PREDICTOR,
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn", dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def test_monotonic_aligner_timestamps_match_jax_through_automodel(tmp_path):
    d = write_aligner_dir(tmp_path)
    kw = dict(model=d, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    pairs = [(multi_segment_wav(4.0, seed=1), "一二三四五六七八"),
             (multi_segment_wav(2.5, seed=2), "九十丁"), (multi_segment_wav(3.0, seed=3), "丂")]
    got, want = port.generate(input=pairs), ref.generate(input=pairs)
    assert [(r["text"], r["timestamp"]) for r in got] == \
        [(r["text"], r["timestamp"]) for r in want]
    assert all(r["timestamp"] for r in got)
    assert all(a[1] <= b[0] for r in got for a, b in zip(r["timestamp"], r["timestamp"][1:]))
    batched, _ = port.model.inference(pairs, tokenizer=port.kwargs["tokenizer"],
                                      frontend=port.kwargs["frontend"])
    assert [r["timestamp"] for r in batched] == [r["timestamp"] for r in got]


# ---------------------------------------------------------------------------
# copied host code
# ---------------------------------------------------------------------------

def _log_probs(rng, shape):
    logp = rng.standard_normal(shape)
    return logp - np.log(np.exp(logp).sum(-1, keepdims=True))


@pytest.mark.parametrize("target", [[3, 5, 5, 2], [4, 4, 4], [1, 2, 3, 4, 5, 6, 7], [6]])
def test_ctc_forced_align_matches_jax(target):
    logp = _log_probs(np.random.default_rng(len(target)), (20, 9))
    got = ctc_align.ctc_forced_align(logp, np.asarray(target, np.int64))
    np.testing.assert_array_equal(got, jalign.ctc_forced_align(logp, np.asarray(target,
                                                                                 np.int64)))
    # the path spells the target: runs collapsed, blanks dropped, repeats split by a blank
    labels = [int(x) for i, x in enumerate(got) if x and (i == 0 or got[i - 1] != x)]
    assert labels == target


def test_ctc_forced_align_empty_target_raises_as_in_jax():
    """An empty target (one blank state) fails in both copies: the skip candidates are
    built two states wide (ROADMAP section 3)."""
    logp = _log_probs(np.random.default_rng(0), (12, 5))
    for fn in (ctc_align.ctc_forced_align, jalign.ctc_forced_align):
        with pytest.raises(ValueError, match="same shape"):
            fn(logp, np.zeros(0, np.int64))


def test_ctc_forced_align_batch_matches_jax():
    logp = _log_probs(np.random.default_rng(5), (3, 16, 8)).astype(np.float32)
    targets = np.asarray([[2, 2, 3, -1], [5, 1, -1, -1], [7, -1, -1, -1]])
    args = (logp, targets, np.asarray([16, 11, 7]), np.asarray([3, 2, 1]))
    got = ctc_align.ctc_forced_align_batch(*args)
    np.testing.assert_array_equal(got, jalign.ctc_forced_align_batch(*args))
    assert (got[1, 11:] == 0).all() and (got[2, 7:] == 0).all()  # padded frames blank
    targets[2, 0] = -1  # a row whose target is all padding: empty, as above
    for fn in (ctc_align.ctc_forced_align_batch, jalign.ctc_forced_align_batch):
        with pytest.raises(ValueError, match="same shape"):
            fn(*args)


@pytest.mark.parametrize("text", [
    "<|zh|><|NEUTRAL|><|Speech|><|woitn|>一二三",
    "<|en|><|HAPPY|><|BGM|><|withitn|>hello world<|ja|><|SAD|><|Laughter|><|withitn|>x",
    "<|nospeech|><|Event_UNK|>", "plain text", "<|yue|><|ANGRY|><|Cough|><|woitn|>"])
def test_rich_transcription_postprocess_matches_jax(text):
    assert postprocess_utils.rich_transcription_postprocess(text) == \
        jpost.rich_transcription_postprocess(text)
    for table in ("EMO_DICT", "EVENT_DICT", "_OTHER_TAGS"):
        assert getattr(postprocess_utils, table) == getattr(jpost, table)


def test_sentencepiece_tokenizer_registers_and_is_import_gated():
    cls = tables.tokenizer_classes["SentencepiecesTokenizer"]
    assert cls.__name__ == jtables.tokenizer_classes["SentencepiecesTokenizer"].__name__
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError) as port_err:
            cls(bpemodel="chn_jpn_yue_eng_ko_spectok.bpe.model")
        with pytest.raises(ImportError) as jax_err:
            jtables.tokenizer_classes["SentencepiecesTokenizer"](
                bpemodel="chn_jpn_yue_eng_ko_spectok.bpe.model")
        assert str(port_err.value) == str(jax_err.value)
    else:
        pytest.skip("sentencepiece is installed; no .model file is in the repository")


def test_params_from_jax_loads_jax_init_e_paraformer():
    """JAX -> port for E-Paraformer: the PIF predictor's bare ``sigma`` / ``bias`` and its
    depthwise conv with a bias, beside Paraformer's layout; ids equal."""
    jm = JaxEParaformer(**EP_CONF)
    params = jm.init_params(jax.random.PRNGKey(3))
    pt = EParaformer(**EP_CONF).eval()
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    feats, lens = _feats(_waves(3.0, 2.2))
    sp, ln, _ = pad_feats_bucketed(torch.from_numpy(feats), torch.from_numpy(lens))
    mt = pt._max_tokens_for(sp.shape[1])
    want = _infer_program(jm, params, jnp.asarray(sp.numpy()), jnp.asarray(ln.numpy()), mt)
    with torch.no_grad():
        yseq, token_lens, _, _ = pt.decode_outputs(sp, ln, mt, timestamps=False)
    np.testing.assert_array_equal(token_lens.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(yseq.numpy(), np.asarray(want[0]))


def test_params_from_jax_loads_jax_init_monotonic_aligner():
    """JAX -> port for the fa-zh aligner (SAN-M encoder + the V3 head with its BLSTM): the
    upsampled alphas within 1e-5 at given token counts."""
    from funasr_tpu.models.monotonic_aligner.model import MonotonicAligner as JaxAligner
    from funasr_tpu_torch.models.monotonic_aligner.model import MonotonicAligner

    jm = JaxAligner(**ALIGNER_CONF)
    params = jm.init_params(jax.random.PRNGKey(5))
    pt = MonotonicAligner(**ALIGNER_CONF).eval()
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    feats, lens = _feats(_waves(3.0, 2.2))
    token_nums = np.asarray([6.0, 3.0], np.float32)
    enc, enc_lens = jm.encode(params, jnp.asarray(feats), jnp.asarray(lens))
    mask = np.arange(enc.shape[1])[None] < np.asarray(enc_lens)[:, None]
    want = jm.predictor.get_upsample_timestamp(params["predictor"], enc, jnp.asarray(mask),
                                               token_num=jnp.asarray(token_nums))[2]
    with torch.no_grad():
        got = pt.upsampled(t(feats), t(lens), t(token_nums))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
