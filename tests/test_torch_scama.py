"""SCAMA of the PyTorch port against the JAX package (CPU), small configs (2 encoder blocks
of d 16, kernel 5, two chunk configs; a 3-block decoder with 2 cross-attention layers;
vocab 12), the same weights in both packages (the JAX init through ``params_from_jax``;
``convert_state_dict`` takes the port's back). Limits:

* ``models/scama/utils.py``: ``gen_frame_alignments`` and
  ``build_scama_mask_for_cross_attention_decoder`` equal to the JAX functions on ragged
  batches: both ``attention_chunk_type``s, decoder look-back 0, 1 and -1, training and
  decoding, alphas in multiples of 1/16 whose running sums reach integers exactly at
  chunk edges (so both frameworks' fp32 sums are exact);
* ``FsmnDecoderSCAMAOpt`` logits within 2e-4 of max |y|: ``decoders2`` running
  (``att_layer_num`` < ``num_blocks``), ``concat_embeds``, with a SCAMA mask and without;
  the fixed-shape greedy step equal to the prefix-only forward at the step's row;
* ``SCAMA.forward`` (JAX's trainer call: no masks, config 0) loss and stats within 1e-5
  relative, every gradient within 1e-4 relative L2 of
  ``jax.jit(jax.value_and_grad(forward_jit))``;
* ``SCAMA.inference`` at ``decoding_ind`` 0 and 1: ids, ``token_num`` and texts equal to
  JAX's; ``AutoModel(model=<SCAMA dir>).generate`` equal to the JAX ``AutoModel``'s.

The chunk mode's fp32-only rule on the card is in ``test_torch_scama_chip.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.scama.model  # noqa: F401 (registers SCAMA in JAX)
from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.scama import utils as jutils
from funasr_tpu.register import tables as jtables
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.scama import utils
from funasr_tpu_torch.models.scama.model import greedy_decode
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from torch_parity_util import _write_config, _write_tokens, shape_only_init, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ZERO_SHARE = 1e-6
LOGIT_TOL = 2e-4
TOKENS = ["<blank>", "<s>", "</s>"] + [f"t{i}" for i in range(8)] + ["<unk>"]
V = len(TOKENS)
CHUNK = dict(chunk_size=(8, 12), stride=(5, 8), pad_left=(0, 0),
             encoder_att_look_back_factor=(1, 1), decoder_att_look_back_factor=(1, 1))
ENC = dict(output_size=16, attention_heads=2, linear_units=32, num_blocks=2, kernel_size=5,
           **CHUNK)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=3, att_layer_num=2, kernel_size=5)
CONF = dict(input_size=16, vocab_size=V, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=dict(idim=16, threshold=1.0, tail_threshold=0.45),
            ctc_weight=0.3, predictor_weight=1.0, lsm_weight=0.1)
FRONTEND = dict(fs=16000, n_mels=16, lfr_m=1, lfr_n=6, dither=0.0)


def rel_l2(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want)


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


# ---- alignments and windows --------------------------------------------------------

def dyadic_alphas(seed, b=3, t=24, lens=(24, 19, 11)):
    """Alphas in multiples of 1/16 (exact fp32 sums in any order); row 0's running sum
    hits integers exactly at frames 7 and 15 (the ends of chunks of 8)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 12, (b, t)).astype(np.float32) / 16.0
    for i, n in enumerate(lens):
        a[i, n:] = 0.0
    for end in (7, 15):  # make the prefix sum an integer at the chunk edge
        s = a[0, : end + 1].sum()
        a[0, end] += np.ceil(s) - s
    return a, np.asarray(lens, np.int32)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_gen_frame_alignments_equal_jax(training, seed):
    alphas, lens = dyadic_alphas(seed)
    k = int(np.floor(alphas.sum(1)).max()) + 2
    got, got_n = utils.gen_frame_alignments(t(alphas), t(lens), k, training=training)
    want, want_n = jutils.gen_frame_alignments(jnp.asarray(alphas), jnp.asarray(lens), k,
                                               training=training)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("look_back", [0, 1, -1])
@pytest.mark.parametrize("att_type", ["chunk", "full"])
def test_scama_mask_equals_jax(att_type, look_back, training):
    alphas, lens = dyadic_alphas(2)
    k = int(np.floor(alphas.sum(1)).max()) + 1
    align, _ = jutils.gen_frame_alignments(jnp.asarray(alphas), jnp.asarray(lens), k,
                                           training=False)
    align = np.asarray(align)
    hop = (np.arange(24) % 8 < 5).astype(np.float32)
    shift = (np.arange(24) % 8 >= 2).astype(np.float32)
    tgt = np.asarray([k, k - 2, 3], np.int32)
    kw = dict(max_target_length=k, chunk_size=1, encoder_chunk_size=8,
              attention_chunk_size=8, attention_chunk_type=att_type,
              decoder_att_look_back_factor=look_back, is_training=training)
    got = utils.build_scama_mask_for_cross_attention_decoder(
        t(align), t(lens), predictor_mask_chunk_hopping=t(hop),
        mask_shift_att_chunk_decoder=t(shift), target_length=t(tgt), **kw)
    want = jutils.build_scama_mask_for_cross_attention_decoder(
        jnp.asarray(align), jnp.asarray(lens), predictor_mask_chunk_hopping=hop,
        mask_shift_att_chunk_decoder=shift, target_length=jnp.asarray(tgt), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the decoder ---------------------------------------------------------------------

def decoder_pair(seed, **conf):
    jd = jtables.decoder_classes["FsmnDecoderSCAMAOpt"](vocab_size=V, encoder_output_size=16,
                                                        **conf)
    tree = {"decoder": jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(seed)))}
    pd = tables.decoder_classes["FsmnDecoderSCAMAOpt"](vocab_size=V, encoder_output_size=16,
                                                       **conf)
    sd = params_from_jax(tree, torch.nn.ModuleDict({"decoder": pd}))
    pd.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    return pd.eval(), jd, to_jax(tree["decoder"])


DECODER_CASES = {
    "decoders2": dict(DEC),
    "concat_embeds": dict(DEC, concat_embeds=True, attention_dim=24, att_layer_num=3),
    "shift_21": dict(DEC, kernel_size=21, num_blocks=2, att_layer_num=2),
}


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_logits_match_jax(case, with_mask):
    conf = DECODER_CASES[case]
    pd, jd, jp = decoder_pair(len(case), **conf)
    rng = np.random.default_rng(3)
    hs = rng.standard_normal((2, 24, 16)).astype(np.float32)
    hlens = np.asarray([24, 17], np.int32)
    ys = rng.integers(3, V, (2, 6)).astype(np.int32)
    ylens = np.asarray([6, 4], np.int32)
    mask = (rng.random((2, 6, 24)) < 0.6).astype(np.float32) if with_mask else None
    pre = (rng.standard_normal((2, 6, 16)).astype(np.float32)
           if conf.get("concat_embeds") else None)
    with torch.no_grad():
        got, glens = pd(t(hs), t(hlens), t(ys).long(), t(ylens),
                        chunk_mask=None if mask is None else t(mask),
                        pre_acoustic_embeds=None if pre is None else t(pre))
    want, wlens = jd(jp, jnp.asarray(hs), jnp.asarray(hlens), jnp.asarray(ys),
                     jnp.asarray(ylens), chunk_mask=None if mask is None else jnp.asarray(mask),
                     pre_acoustic_embeds=None if pre is None else jnp.asarray(pre))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    valid = np.arange(6)[None, :] < ylens[:, None]
    close(got.numpy()[valid], np.asarray(want)[valid], LOGIT_TOL)


def test_fixed_shape_greedy_step_equals_the_prefix_forward():
    """Rows past ``step`` (eos padding) never reach the step's row: logits at the step
    equal the forward over the prefix alone, for every step, at the default
    ``sanm_shfit`` (left context only) and at ``sanm_shfit`` 0 (two rows of right
    context, masked)."""
    for conf in (dict(DEC, kernel_size=11), dict(DEC, sanm_shfit=0)):
        pd, _, _ = decoder_pair(5, **conf)
        rng = np.random.default_rng(4)
        hs = t(rng.standard_normal((2, 20, 16)).astype(np.float32))
        hlens = t(np.asarray([20, 13], np.int32))
        mask = t((rng.random((2, 7, 20)) < 0.7).astype(np.float32))
        ids = greedy_decode(pd, hs, hlens, mask, 7, 1, 2)
        ys = torch.cat([torch.ones(2, 1, dtype=torch.long), ids], 1)
        with torch.no_grad():
            for step in range(7):
                prefix, _ = pd(hs, hlens, ys[:, : step + 1],
                               torch.full((2,), step + 1), chunk_mask=mask)
                assert torch.equal(prefix[:, step].argmax(-1), ids[:, step]), step


# ---- the model -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm = jtables.model_classes["SCAMA"](**CONF)
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    pt = tables.model_classes["SCAMA"](**CONF)
    pt.load_state_dict(params_from_jax(tree, pt))
    return pt, jm, tree


def batch(seed=0):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((3, 30, 16)).astype(np.float32)
    slen = np.asarray([30, 22, 13], np.int32)
    tlen = np.asarray([5, 4, 2], np.int32)
    text = np.full((3, 5), -1, np.int32)
    for i in range(3):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    return speech, slen, text, tlen


def test_params_round_trip_through_the_jax_converter(pair):
    pt, jm, tree = pair
    back = convert_state_dict(pt.state_dict(), jm, "SCAMA")
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == set(map(jax.tree_util.keystr, got))
    for path, want in flat.items():
        np.testing.assert_array_equal(np.asarray(got[path]), want)


def check_loss_stats_grads(pt, jm, tree, speech, slen, text, tlen):
    def loss_fn(p):
        loss, stats, _ = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                        jnp.asarray(text), jnp.asarray(tlen), None)
        return loss, stats

    (jl, jstats), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(to_jax(tree))
    pt.train()
    pt.zero_grad()
    loss, stats, weight = pt(t(speech), t(slen), t(text).long(), t(tlen).long())
    loss.backward()
    pt.eval()
    assert weight == speech.shape[0] and set(stats) == set(jstats)
    for k, v in jstats.items():
        got = float(stats[k].detach()) if torch.is_tensor(stats[k]) else float(stats[k])
        assert abs(got - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1e-6), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    floor = ZERO_SHARE * np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for n, p in pt.named_parameters():
        if not p.requires_grad:  # a fixed table (Whisper's sinusoids): not trained
            continue
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        if np.linalg.norm(want[n].numpy()) <= floor:  # exact zero in exact arithmetic
            assert np.linalg.norm(g) <= floor, n
        else:
            assert rel_l2(g, want[n].numpy()) <= GRAD_REL_L2, n


def test_loss_stats_and_grads_match_jax(pair):
    check_loss_stats_grads(*pair, *batch())


def frontends():
    return WavFrontend(**FRONTEND), JaxWavFrontend(**FRONTEND)


def wavs(seed=7, lengths=(12000, 7000)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("ind", [0, 1])
def test_inference_ids_and_texts_match_jax(pair, ind):
    pt, jm, tree = pair
    fe, jfe = frontends()
    got, _ = pt.inference(wavs(), key=["a", "b"], tokenizer=CharTokenizer(token_list=TOKENS),
                          frontend=fe, decoding_ind=ind)
    want, _ = jm.inference(to_jax(tree), wavs(), key=["a", "b"],
                           tokenizer=JaxCharTokenizer(token_list=TOKENS), frontend=jfe,
                           decoding_ind=ind)
    assert got == want
    assert all(r["token_num"] > 0 and r["text"] for r in got), got


def write_scama_dir(d, pt):
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, TOKENS)
    return _write_config(d, dict(
        model="SCAMA", model_conf=dict(ctc_weight=0.3, predictor_weight=1.0, lsm_weight=0.1,
                                       sos=1, eos=2),
        encoder="SANMEncoderChunkOpt", encoder_conf={k: list(v) if isinstance(v, tuple)
                                                     else v for k, v in ENC.items()},
        decoder="FsmnDecoderSCAMAOpt", decoder_conf=DEC,
        predictor="CifPredictorV2", predictor_conf=CONF["predictor_conf"],
        frontend="WavFrontend", frontend_conf=FRONTEND,
        tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt",
                                                       unk_symbol="<unk>")))


def test_automodel_generate_matches_jax(pair, tmp_path):
    d = write_scama_dir(str(tmp_path), pair[0])
    kw = dict(input=wavs(9), key=["a", "b"])
    got = AutoModel(model=d, device="cpu", log_level="WARNING").generate(**kw)
    with shape_only_init(("SCAMA",)):
        ref = jauto.AutoModel(model=d, log_level="WARNING")
    want = ref.generate(**kw)
    assert got == want and all(r["text"] for r in got), got
