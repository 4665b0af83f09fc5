"""The transducer family of the PyTorch port against the JAX package (CPU), small configs
(2 blocks, d 32), the same weights in both packages (the JAX init, seeded batch-norm
statistics and RWKV decays, through ``params_from_jax``). Limits:

* ``ops/rnnt_loss.py::rnnt_loss`` against JAX's and against the brute-force oracle of
  ``test_transducer_lm.py`` on ragged T and U (a row with T < U, one with U = 0): values
  within 1e-5 relative, gradients within 1e-4 relative L2 of ``jax.grad``;
* ``lstm_step`` / ``lstm_apply(init=, return_state=)`` within 1e-6;
* ``ChunkConformerEncoder`` offline (with and without the conv2d input layer) and chunk by
  chunk within 2e-5 of max |y| of JAX's, the chunks' output within 2e-5 of the offline
  pass; ``RWKVEncoder`` within 2e-5;
* ``Transducer.forward`` over a Conformer, a chunk Conformer and an RWKV encoder: the loss
  within 1e-5 relative and every gradient within 1e-4 relative L2 of
  ``jax.value_and_grad(forward_jit)`` (a leaf under 1e-6 of the global norm, the key
  biases' exact-zero gradients, is held to that floor); greedy ids equal to JAX's
  ``greedy_decode`` and to the host oracle; ``decode_chunk`` emissions equal to JAX's and
  to the offline ids over the chunk-causal encoder output;
* ``params_from_jax`` round trips through ``convert_state_dict``.

``AutoModel.generate`` and the recipes on the CPU are in ``test_torch_transducer_recipes.py``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.conformer.model  # noqa: F401 (registers the JAX encoders)
import funasr_tpu.models.rwkv_bat.model  # noqa: F401
import funasr_tpu.models.transducer.model  # noqa: F401
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.core import layers as jlayers
from funasr_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt_loss
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.layers import lstm_apply, lstm_step
from funasr_tpu_torch.ops.rnnt_loss import NEG_INF, rnnt_loss
from test_transducer_lm import brute_force_rnnt
from torch_parity_util import _write_config, _write_tokens, t, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ZERO_SHARE = 1e-6
ENC_TOL = 2e-5
V = 13
TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(V - 4)] + ["<unk>"]
ENCODERS = {
    "conformer": ("ConformerEncoder", dict(output_size=32, attention_heads=4, linear_units=48,
                                           num_blocks=2, cnn_module_kernel=15)),
    "chunk": ("ChunkConformerEncoder", dict(output_size=32, attention_heads=4, linear_units=48,
                                            num_blocks=2, cnn_module_kernel=15, chunk_size=4,
                                            left_chunks=2, input_layer="conv2d")),
    "rwkv": ("RWKVEncoder", dict(output_size=32, num_blocks=2, ffn_mult=2)),
}
PRED = dict(decoder_conf=dict(embed_size=16, hidden_size=24),
            joint_network_conf=dict(joint_space_size=40))
FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                lfr_m=1, lfr_n=1, dither=0.0)


def rel_l2(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want)


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


# ---- the RNN-T loss -------------------------------------------------------------------

LOSS_CASES = {  # (B, T, U, V, logit lengths, target lengths)
    "ragged": (3, 7, 4, 6, [7, 5, 2], [4, 2, 4]),
    "t_below_u": (2, 3, 6, 5, [3, 1], [6, 5]),
    "no_labels": (2, 4, 0, 3, [4, 2], [0, 0]),
    # a row of logit length 0: JAX reads its frozen row 0 and the blank at the wrapped
    # frame -1, a finite value (ROADMAP section 3, repaired)
    "zero_logit_length": (3, 6, 3, 7, [6, 4, 0], [3, 2, 1]),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_rnnt_loss_and_grad_match_jax(case):
    b, tt, u, v, tlen, ulen = LOSS_CASES[case]
    rng = np.random.default_rng(len(case))
    logits = rng.standard_normal((b, tt, u + 1, v)).astype(np.float32)
    tgt = rng.integers(1, v, (b, u)).astype(np.int32)
    args = [jnp.asarray(a) for a in (tgt, np.asarray(tlen), np.asarray(ulen))]

    def mean_loss(x):
        nll = jax_rnnt_loss(x, *args)
        return jnp.mean(nll), nll

    (_, want), want_g = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = rnnt_loss(x, t(tgt), t(np.asarray(tlen)), t(np.asarray(ulen)))
    got.mean().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    assert rel_l2(x.grad.numpy(), want_g) <= GRAD_REL_L2
    assert np.isfinite(x.grad.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_rnnt_loss_matches_brute_force(seed):
    """Every monotone alignment enumerated (``test_transducer_lm.py``'s oracle), T < U in
    the second row."""
    rng = np.random.default_rng(seed)
    tt, u, v = 4, 5, 5
    logits = rng.standard_normal((2, tt, u + 1, v)).astype(np.float32)
    tgt = rng.integers(1, v, (2, u)).astype(np.int32)
    tlen, ulen = np.asarray([4, 2]), np.asarray([3, 5])
    got = rnnt_loss(t(logits), t(tgt), t(tlen), t(ulen)).numpy()
    logp = torch.log_softmax(t(logits), -1).numpy()
    for i in range(2):
        want = brute_force_rnnt(logp[i], tgt[i], int(tlen[i]), int(ulen[i]))
        assert abs(got[i] - want) <= LOSS_RTOL * abs(want), (got[i], want)


def test_rnnt_loss_zero_logit_length_row_is_jaxs_finite_value():
    """The row of logit length 0 reads alpha(0, U_b) and the blank at frame T - 1, as
    JAX's index -1 does: a finite loss equal to JAX's, not 1e30; the other rows are
    those of the same batch without it, bit for bit."""
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((3, 6, 4, 7)).astype(np.float32)
    tgt = rng.integers(1, 7, (3, 3)).astype(np.int32)
    tlen, ulen = np.asarray([6, 4, 0]), np.asarray([3, 2, 1])
    want = np.asarray(jax_rnnt_loss(jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(tlen),
                                    jnp.asarray(ulen)))
    got = rnnt_loss(t(logits), t(tgt), t(tlen), t(ulen)).numpy()
    assert np.isfinite(want[2]) and abs(want[2]) < 1e3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    logp = np.asarray(torch.log_softmax(t(logits[2]), -1))
    np.testing.assert_allclose(got[2], -(logp[0, 0, tgt[2, 0]] + logp[5, 1, 0]), rtol=1e-6)
    rest = rnnt_loss(t(logits[:2]), t(tgt[:2]), t(tlen[:2]), t(ulen[:2])).numpy()
    np.testing.assert_array_equal(got[:2], rest)


def test_rnnt_loss_keeps_cells_past_the_target_at_neg_inf():
    """A cell past a row's target length is NEG_INF, a large finite value, not -inf: no
    gradient reaches the logits there, and none is NaN."""
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((1, 3, 4, 5)).astype(np.float32)).requires_grad_()
    loss = rnnt_loss(x, t(np.asarray([[1, 2, 3]])), t(np.asarray([3])), t(np.asarray([1])))
    loss.sum().backward()
    assert NEG_INF == -1e30 and torch.isfinite(x.grad).all()
    assert torch.count_nonzero(x.grad[0, :, 2:]) == 0  # u = 2, 3 lie past U = 1


# ---- the LSTM step --------------------------------------------------------------------

def test_lstm_step_and_stateful_apply_match_jax():
    rng = np.random.default_rng(3)
    lstm = torch.nn.LSTM(6, 8, batch_first=True)
    p = {"w_ih": lstm.weight_ih_l0.detach().numpy().T, "w_hh": lstm.weight_hh_l0.detach().numpy().T,
         "b_ih": lstm.bias_ih_l0.detach().numpy(), "b_hh": lstm.bias_hh_l0.detach().numpy()}
    jp = to_jax(p)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    h0, c0 = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        out, (h, c) = lstm_apply(lstm, t(x), init=(t(h0), t(c0)), return_state=True)
        y, (hs, cs) = lstm_step(lstm, t(x[:, 0]), (t(h0), t(c0)))
    jout, (jh, jc) = jlayers.lstm_apply(jp, jnp.asarray(x), init=(jnp.asarray(h0),
                                                                 jnp.asarray(c0)),
                                        return_state=True)
    jy, (jhs, jcs) = jlayers.lstm_step(jp, jnp.asarray(x[:, 0]), (jnp.asarray(h0),
                                                                  jnp.asarray(c0)))
    for got, want in ((out, jout), (h, jh), (c, jc), (y, jy), (hs, jhs), (cs, jcs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---- the models -----------------------------------------------------------------------

def jax_tree(name, jm, seed=0):
    """The JAX init as numpy, batch-norm statistics and RWKV decays drawn from a seed."""
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    enc = tree["encoder"]
    if "encoders" in enc:
        norm = enc["encoders"]["conv_module"]["norm"]
        norm["mean"] = rng.normal(0, 0.1, norm["mean"].shape).astype(np.float32)
        norm["var"] = rng.uniform(0.5, 1.5, norm["var"].shape).astype(np.float32)
    else:
        for k in ("time_decay", "time_first"):
            enc["blocks"][k] = rng.normal(0, 0.5, enc["blocks"][k].shape).astype(np.float32)
    return tree


def build(name, model="Transducer", seed=0, input_size=20):
    encoder, ec = ENCODERS[name]
    conf = dict(encoder=encoder, input_size=input_size, vocab_size=V, encoder_conf=ec, **PRED)
    jm = jtables.model_classes[model](**conf)
    tree = jax_tree(name, jm, seed)
    pt = tables.model_classes[model](**conf)
    pt.load_state_dict(params_from_jax(tree, pt))
    return pt, jm, tree, conf


def batch(seed=0, b=3, tt=40, u=6, feat=20):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((b, tt, feat)).astype(np.float32)
    slen = np.asarray([tt, 31, 18][:b], np.int32)
    tlen = np.asarray([6, 4, 2][:b], np.int32)
    text = np.full((b, u), -1, np.int32)
    for i in range(b):
        text[i, :tlen[i]] = rng.integers(1, V, tlen[i])
    return speech, slen, text, tlen


@pytest.mark.parametrize("input_layer", ["null", "conv2d"])
def test_chunk_conformer_offline_matches_jax(input_layer):
    ec = dict(ENCODERS["chunk"][1], input_layer=input_layer)
    jenc = jtables.encoder_classes["ChunkConformerEncoder"](input_size=32, **ec)
    tree = {"encoder": jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(1)))}
    enc = tables.encoder_classes["ChunkConformerEncoder"](input_size=32, **ec)
    sd = params_from_jax(tree, torch.nn.ModuleDict({"encoder": enc}))
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 36, 32)).astype(np.float32)
    lens = np.asarray([36, 23], np.int32)
    with torch.no_grad():
        got, glens = enc(t(x), t(lens))
    want, wlens = jax.jit(jenc.__call__)(to_jax(tree["encoder"]), jnp.asarray(x),
                                         jnp.asarray(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    close(got.numpy(), np.asarray(want), ENC_TOL)


def test_chunk_conformer_stream_matches_jax_and_offline():
    ec = dict(ENCODERS["chunk"][1], input_layer="null")
    jenc = jtables.encoder_classes["ChunkConformerEncoder"](input_size=32, **ec)
    tree = {"encoder": jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(4)))}
    enc = tables.encoder_classes["ChunkConformerEncoder"](input_size=32, **ec)
    sd = params_from_jax(tree, torch.nn.ModuleDict({"encoder": enc}))
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    jp = to_jax(tree["encoder"])
    x = np.random.default_rng(6).standard_normal((2, 20, 32)).astype(np.float32)
    cache, jcache = enc.init_cache(2), jenc.init_cache(2)
    outs, jouts = [], []
    with torch.no_grad():
        for c in range(5):
            y, cache = enc.forward_chunk(t(x[:, 4 * c: 4 * c + 4]), cache)
            jy, jcache = jenc.forward_chunk(jp, jnp.asarray(x[:, 4 * c: 4 * c + 4]), jcache)
            outs.append(y.numpy())
            jouts.append(np.asarray(jy))
        full, _ = enc(t(x), t(np.asarray([20, 20])))
    close(np.concatenate(outs, 1), np.concatenate(jouts, 1), ENC_TOL)
    close(np.concatenate(outs, 1), full.numpy(), ENC_TOL)
    for k in ("k", "v", "conv"):
        close(cache[k].numpy(), np.asarray(jcache[k]), ENC_TOL)
    assert cache["filled"].tolist() == [20, 20]


def test_rwkv_encoder_matches_jax():
    pt, jm, tree, _ = build("rwkv")
    speech, slen, _, _ = batch(7)
    with torch.no_grad():
        got, _ = pt.encoder(t(speech), t(slen))
    want, _ = jax.jit(jm.encoder.__call__)(to_jax(tree)["encoder"], jnp.asarray(speech),
                                           jnp.asarray(slen))
    close(got.numpy(), np.asarray(want), ENC_TOL)
    assert not got[1, 31:].any()


@pytest.mark.parametrize("name", list(ENCODERS))
def test_transducer_loss_and_grads_match_jax(name):
    check_loss_and_grads(name, *batch())


def test_transducer_loss_with_an_empty_encoder_output_matches_jax():
    """A batch whose third utterance has no frames: the RWKV encoder keeps lengths, so
    its logit length is 0, and the batch mean takes JAX's finite value for that row (it
    was ~1e30 / 3 before the repair)."""
    speech, _, text, tlen = batch()
    check_loss_and_grads("rwkv", speech, np.asarray([40, 31, 0], np.int32), text, tlen)


def check_loss_and_grads(name, speech, slen, text, tlen):
    pt, jm, tree, _ = build(name)
    pt.train()

    def loss_fn(p):
        return jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen), jnp.asarray(text),
                              jnp.asarray(tlen), None)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(to_jax(tree))
    loss, stats, weight = pt(t(speech), t(slen), t(text).long(), t(tlen).long())
    loss.backward()
    assert weight == 3 and set(stats) == {"loss"}
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg), pt)
    floor = ZERO_SHARE * np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for n, p in pt.named_parameters():
        g = p.grad.numpy()
        if np.linalg.norm(want[n].numpy()) <= floor:  # exact zero (attention key biases)
            assert np.linalg.norm(g) <= floor, n
        else:
            assert rel_l2(g, want[n].numpy()) <= GRAD_REL_L2, n


@pytest.mark.parametrize("name", list(ENCODERS))
def test_greedy_ids_match_jax_and_the_host_oracle(name):
    pt, jm, tree, _ = build(name, seed=1)
    pt.eval()
    speech, slen, _, _ = batch(8)
    with torch.no_grad():
        enc, elens = pt.encoder(t(speech), t(slen))
    jenc, jlens = jax.jit(jm.encoder.__call__)(to_jax(tree)["encoder"], jnp.asarray(speech),
                                               jnp.asarray(slen))
    ids = pt.greedy_decode(enc, elens)
    assert ids == pt._greedy_decode_host(enc, elens)
    assert ids == jm.greedy_decode(to_jax(tree), jenc, np.asarray(jlens))
    assert all(ids), ids


def test_decode_chunk_matches_jax_and_offline():
    """Chunk-by-chunk emissions over a ChunkConformerEncoder (``input_layer`` null) equal
    JAX's and the offline greedy ids (JAX's own contract, ``test_chunk_conformer.py``)."""
    encoder, ec = ENCODERS["chunk"]
    conf = dict(encoder=encoder, input_size=32, vocab_size=V,
                encoder_conf=dict(ec, input_layer="null"), **PRED)
    jm = jtables.model_classes["Transducer"](**conf)
    tree = jax_tree("chunk", jm, 2)
    pt = tables.model_classes["Transducer"](**conf).eval()
    pt.load_state_dict(params_from_jax(tree, pt))
    jp = to_jax(tree)
    x = np.random.default_rng(9).standard_normal((2, 16, 32)).astype(np.float32)
    state, jstate = pt.init_stream(batch=2), jm.init_stream(jp, batch=2)
    for c in range(4):
        got, state = pt.decode_chunk(t(x[:, 4 * c: 4 * c + 4]), state)
        want, jstate = jm.decode_chunk(jp, jnp.asarray(x[:, 4 * c: 4 * c + 4]), jstate)
        assert got == want, (c, got, want)
    with torch.no_grad():
        enc, elens = pt.encoder(t(x), t(np.asarray([16, 16])))
    assert state["tokens"] == pt.greedy_decode(enc, elens) == jstate["tokens"]


@pytest.mark.parametrize("name", ["conformer", "chunk"])
def test_params_round_trip_through_the_jax_converter(name):
    """JAX tree -> ``params_from_jax`` -> state dict -> JAX's ``convert_transducer`` gives
    the tree back (JAX's converter reads every encoder as a Conformer, so the RWKV BAT
    goes one way only: ``params_from_jax``, as the tests above load it)."""
    pt, jm, tree, _ = build(name)
    back = convert_state_dict(pt.state_dict(), jm, "Transducer")
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == set(map(jax.tree_util.keystr, got))
    for path, want in flat.items():
        np.testing.assert_array_equal(np.asarray(got[path]), want)


def test_bat_and_conformer_rwkv_load_the_jax_tree():
    """BAT and ConformerRWKV (the JAX classes return a Transducer / Transformer over
    RWKVEncoder) take the JAX init through ``params_from_jax`` with every name matched."""
    pt, _, tree, _ = build("rwkv", model="BAT")
    assert type(pt).__name__ == "BAT" and "encoder.blocks.1.time_first" in pt.state_dict()
    conf = dict(input_size=20, vocab_size=V, encoder_conf=ENCODERS["rwkv"][1],
                decoder_conf=dict(attention_heads=4, linear_units=48, num_blocks=1),
                ctc_weight=0.3)
    jm = jtables.model_classes["ConformerRWKV"](**conf)
    jt = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    pc = tables.model_classes["ConformerRWKV"](**conf)
    pc.load_state_dict(params_from_jax(jt, pc))
    speech, slen, _, _ = batch(2)
    with torch.no_grad():
        got, _ = pc.encode(t(speech), t(slen))
    want, _ = jm.encode(to_jax(jt), jnp.asarray(speech), jnp.asarray(slen))
    close(got.numpy(), np.asarray(want), ENC_TOL)


def write_transducer_dir(d, name, model, seed=3, encoder_conf=None, pred=PRED):
    """A model dir both AutoModels load: config.yaml, tokens.txt and the JAX tree as a
    Trainer pickle (``model.pt``), the joint's output sharpened so that seeded weights
    emit tokens with clear margins; ``encoder_conf`` / ``pred`` widen the defaults."""
    encoder, ec = ENCODERS[name]
    ec = dict(ec, **(encoder_conf or {}))
    conf = dict(encoder=encoder, input_size=80, vocab_size=V, encoder_conf=ec, **pred)
    jm = jtables.model_classes[model](**conf)
    tree = jax_tree(name, jm, seed)
    tree["joint"]["lin_out"]["w"] = tree["joint"]["lin_out"]["w"] * 8.0
    with open(os.path.join(d, "model.pt"), "wb") as f:
        pickle.dump({"params": tree}, f)
    _write_tokens(d, TOKENS)
    return _write_config(d, dict(
        model=model, encoder=encoder, encoder_conf=ec, **pred, frontend="WavFrontend",
        frontend_conf=FRONTEND, tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
