"""Streaming Paraformer's training loss (overlap-chunk masks) against the JAX package's,
on the CPU, and the recipe around it.

* ``OverlapChunk``'s masks and chunked lengths equal the JAX package's exactly, over both
  recipe configs ([12, 15] / [8, 10]), look-backs 0, 1, 4 and 1e6 (unbounded), ragged
  lengths; ``split_chunk`` / ``remove_chunk`` equal JAX's einsums, their gradients too,
  and ``split_chunk``'s gradient is bit-equal across runs.
* The flash kernels' chunk mode: ``chunk_mask`` equals JAX's attention mask ANDed with the
  key pad mask; the plain version inside ``sanm_attention_apply`` equals JAX's masked
  einsum path (``sanm_attention_apply(..., attn_mask=)``) within 1e-6, fully masked rows
  exactly 0; a float64 ``gradcheck`` of the plain version.
* ``SANMEncoderChunkOpt.forward_train_chunk`` within 2e-4 of JAX's, and
  ``ParaformerStreaming.forward`` (loss, stats, weight, every gradient) against
  ``jax.jit(jax.value_and_grad(forward_jit))`` with each config pinned (JAX's key chosen
  so that it draws that config) at ``sampling_ratio`` 0 and 0.75, the sampler's uniforms
  fed from JAX's key: the loss within 1e-5 relative, each gradient within 1e-4 relative L2.
* A 2-step ``bin/train`` run of a small ``ParaformerStreaming`` directory on the CPU whose
  averaged checkpoint decodes through the streaming ``generate``.
* The trainer's launch-shape record keeps a holed mask's runs (``cuda_lib``).

The card's tests of chunk mode are in ``test_torch_train_streaming_chip.py`` (no JAX).
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.paraformer.cif_predictor as jax_cif
import funasr_tpu_torch.models.paraformer.cif_predictor as port_cif
from funasr_tpu.convert.torch_to_jax import SD, convert_sanm_encoder, convert_state_dict
from funasr_tpu.models.scama.chunk_utils import OverlapChunk as JaxOverlapChunk
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch.models.scama import chunk_utils
from funasr_tpu_torch.ops.flash_attention import (chunk_mask, flash_attention,
                                                  flash_attention_bwd, flash_attention_ref)
from funasr_tpu_torch.register import tables
from torch_parity_util import to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
ENC_TOL = 2e-4          # forward_train_chunk, fp32 on the CPU in both: sums in other orders
ATTN_TOL = 1e-6         # the attention block's output (values of order 1)
CIF_TIE_SCALE = 1 + 1e-5
V = 41
B, T, L = 3, 45, 8
RECIPE = dict(chunk_size=[12, 15], stride=[8, 10], pad_left=[0, 0],
              encoder_att_look_back_factor=[4, 4], decoder_att_look_back_factor=[1, 1])
ENC = dict(output_size=32, attention_heads=4, linear_units=48, num_blocks=2, kernel_size=11,
           sanm_shfit=0, dropout_rate=0.0, **RECIPE)
DEC = dict(attention_heads=4, linear_units=48, num_blocks=2, att_layer_num=2, kernel_size=11,
           sanm_shfit=5)
CONF = dict(input_size=80, vocab_size=V, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=dict(idim=32, l_order=1, r_order=1, tail_threshold=0.45),
            sos=1, eos=2, predictor_bias=1, lsm_weight=0.1, length_normalized_loss=True,
            specaug=None)
LOOK_BACKS = [0, 1, 4, 1_000_000]
LENGTHS = {"ragged": [45, 33, 7], "one": [190], "stride_multiple": [40, 24, 8, 1]}


def overlap_chunks(look_back):
    kw = dict(chunk_size=(12, 15), stride=(8, 10), pad_left=(0, 0),
              encoder_att_look_back_factor=(look_back, look_back), shfit_fsmn=5,
              decoder_att_look_back_factor=(1, 1))
    return chunk_utils.OverlapChunk(**kw), JaxOverlapChunk(**kw)


@pytest.mark.parametrize("look_back", LOOK_BACKS)
@pytest.mark.parametrize("ind", [0, 1])
@pytest.mark.parametrize("lengths", list(LENGTHS))
def test_overlap_chunk_masks_equal_jax(look_back, ind, lengths):
    port, ref = overlap_chunks(look_back)
    lens = np.asarray(LENGTHS[lengths])
    got, want = port.gen_chunk_mask(lens, ind), ref.gen_chunk_mask(lens, ind)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    # the kernels' predicate is JAX's attention mask ANDed with the key pad mask
    tc = want["mask_att_chunk_encoder"].shape[0]
    lc = torch.from_numpy(np.asarray(want["x_len_chunk"]).astype(np.int64))
    pred = chunk_mask(lc, tc, tc, port.attention_chunk(ind)).numpy()
    pad = np.arange(tc)[None, None, :] < np.asarray(want["x_len_chunk"])[:, None, None]
    np.testing.assert_array_equal(pred, want["mask_att_chunk_encoder"][None] & pad)


@pytest.mark.parametrize("ind", [0, 1])
@pytest.mark.parametrize("lengths", ["ragged", "stride_multiple"])
def test_split_and_remove_chunk_equal_jax(ind, lengths):
    """Values and gradients equal JAX's einsum path (each row a single product by 1, so
    exactly); the split's gradient bit-equal across two runs."""
    _, ref = overlap_chunks(4)
    lens = np.asarray(LENGTHS[lengths])
    masks = ref.gen_chunk_mask(lens, ind)
    rng = np.random.default_rng(ind)
    x = rng.standard_normal((len(lens), int(lens.max()), 6)).astype(np.float32)
    tables_ = chunk_utils.device_tables(masks["x_add_mask"], masks["x_rm_mask"], "cpu")

    def jax_fn(x):
        xc, lc = JaxOverlapChunk.split_chunk(x, lens, masks)
        return xc, JaxOverlapChunk.remove_chunk(xc * 1.5, lc, masks)

    (jxc, jback), vjp = jax.vjp(jax_fn, jnp.asarray(x))
    gc = rng.standard_normal(jxc.shape).astype(np.float32)
    gb = rng.standard_normal(jback.shape).astype(np.float32)
    (jgrad,) = vjp((jnp.asarray(gc), jnp.asarray(gb)))

    def port_fn():
        xt = torch.from_numpy(x).requires_grad_()
        xc = chunk_utils.split_chunk(xt, torch.from_numpy(lens), tables_, masks["pad_left"])
        back = chunk_utils.remove_chunk(xc * 1.5, torch.from_numpy(masks["x_len_chunk"]),
                                        tables_)
        grad, = torch.autograd.grad((xc, back), xt, (torch.from_numpy(gc), torch.from_numpy(gb)))
        return xc.detach(), back.detach(), grad

    xc, back, grad = port_fn()
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jxc))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    assert torch.equal(grad, port_fn()[2])
    for b, n in enumerate(lens):  # the round trip is the identity on the valid rows
        np.testing.assert_array_equal(back.numpy()[b, :n], 1.5 * x[b, :n])


# ---------------------------------------------------------------------------
# the attention in chunk mode
# ---------------------------------------------------------------------------

def chunk_case(ind=0, look_back=4, lengths=(45, 33, 7), d=16, h=2, seed=0, dtype=np.float32):
    """q, k, v (B, H, Tc, d) over a config's chunked rows, the chunked lengths, the
    predicate's integers and JAX's masks."""
    port, ref = overlap_chunks(look_back)
    lens = np.asarray(lengths)
    masks = ref.gen_chunk_mask(lens, ind)
    tc = masks["mask_att_chunk_encoder"].shape[0]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((len(lens), h, tc, d)).astype(dtype))
               for _ in range(3))
    lc = torch.from_numpy(np.asarray(masks["x_len_chunk"]).astype(np.int32))
    return q, k, v, lc, port.attention_chunk(ind), masks


def test_chunk_mode_plain_version_zeroes_fully_masked_rows():
    q, k, v, lc, chunk, _ = chunk_case()
    out = flash_attention(q, k, v, lc, "chunk", chunk=chunk)
    live = chunk_mask(lc, q.shape[2], k.shape[2], chunk)
    dead = ~live.any(-1)
    assert dead.any() and (~dead).any()
    assert (out.permute(0, 2, 1, 3)[dead] == 0).all()
    assert (out.permute(0, 2, 1, 3)[~dead].abs().sum(-1) > 0).all()
    dq, dk, dv = flash_attention_bwd(q, k, v, out, torch.randn_like(out), lc, "chunk",
                                     chunk=chunk)
    assert (dq.permute(0, 2, 1, 3)[dead] == 0).all()
    keys_dead = ~live.any(-2)  # keys no row sees get no gradient
    assert (dk.permute(0, 2, 1, 3)[keys_dead] == 0).all()
    assert (dv.permute(0, 2, 1, 3)[keys_dead] == 0).all()


@pytest.mark.parametrize("ind", [0, 1])
def test_chunk_attention_equals_jax_masked_einsum(ind):
    """The port's ``sanm_attention_apply`` in chunk mode (the flash kernels' plain version,
    the FSMN under the frame mask) against JAX's with ``attn_mask`` = the chunk mask."""
    from funasr_tpu.models.sanm.attention import sanm_attention_apply as jax_apply
    from funasr_tpu_torch.models.sanm.attention import sanm_attention_apply

    enc = tables.encoder_classes["SANMEncoderChunkOpt"](
        input_size=32, **{k: v for k, v in ENC.items() if k != "dropout_rate"})
    from funasr_tpu_torch.core.module import init_weights
    init_weights(enc, torch.Generator().manual_seed(ind))
    params = to_jax(convert_sanm_encoder(SD(enc.state_dict()), ENC["num_blocks"]))
    _, ref = overlap_chunks(4)
    lens = np.asarray([45, 33, 7])
    masks = ref.gen_chunk_mask(lens, ind)
    tc = masks["mask_att_chunk_encoder"].shape[0]
    rng = np.random.default_rng(3 + ind)
    x = rng.standard_normal((3, tc, 32)).astype(np.float32)
    lc = np.asarray(masks["x_len_chunk"]).astype(np.int32)
    frame = (np.arange(tc)[None] < lc[:, None]) & (masks["mask_shfit_chunk"][None] > 0)
    att = np.broadcast_to(masks["mask_att_chunk_encoder"][None], (3, tc, tc))
    cfg = jtables.encoder_classes["SANMEncoderChunkOpt"](input_size=32, **ENC).cfg
    want = np.asarray(jax_apply(params["encoders0"]["self_attn"], cfg.attn_cfg(True),
                                jnp.asarray(x), jnp.asarray(frame), attn_mask=jnp.asarray(att)))
    oc = enc.overlap_chunk_cls
    got = sanm_attention_apply(enc.encoders0[0].self_attn, torch.from_numpy(x),
                               torch.from_numpy(frame), torch.from_numpy(lc), "chunk",
                               chunk=oc.attention_chunk(ind)).detach().numpy()
    err = np.abs(got - want).max()
    assert err <= ATTN_TOL * max(1.0, np.abs(want).max()), err
    # an FSMN-shift row (no key, no frame): the attention's context is 0 in both, so the
    # block gives linear_out's bias
    bias = enc.encoders0[0].self_attn.linear_out.bias.detach().numpy()
    np.testing.assert_allclose(got[:, :5], np.broadcast_to(bias, got[:, :5].shape), atol=1e-7)
    np.testing.assert_allclose(want[:, :5], np.broadcast_to(bias, want[:, :5].shape), atol=1e-7)


def test_chunk_mode_gradcheck_float64():
    q, k, v, lc, chunk, _ = chunk_case(lengths=(20, 13), d=4, h=1, dtype=np.float64)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: flash_attention_ref(q_, k_, v_, lc, "chunk", chunk=chunk),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_chunk_mode_checks():
    q, k, v, lc, chunk, _ = chunk_case()
    with pytest.raises(ValueError, match="chunk"):
        flash_attention_ref(q, k, v, lc, "chunk")
    from funasr_tpu_torch.ops.flash_attention import _check, key_limits
    with pytest.raises(NotImplementedError, match="fp32"):
        _check(q.bfloat16(), k.bfloat16(), v.bfloat16(), lc, "chunk", None, chunk)
    with pytest.raises(ValueError, match="Tq == Tk"):
        _check(q[:, :, :-1], k, v, lc, "chunk", None, chunk)
    with pytest.raises(ValueError, match="only then"):
        _check(q, k, v, lc, "none", None, chunk)
    with pytest.raises(ValueError):
        key_limits(lc, q.shape[2], "chunk")


# ---------------------------------------------------------------------------
# the encoder and the loss against JAX
# ---------------------------------------------------------------------------

def batch(seed=0):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((B, T, 80)).astype(np.float32)
    slen = np.array([45, 33, 21], np.int32)
    tlen = np.array([6, 8, 3], np.int32)
    text = np.full((B, L), -1, np.int32)
    for i in range(B):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    return speech, slen, text, tlen


def build(sampling_ratio=0.0, seed=0):
    conf = dict(CONF, sampling_ratio=sampling_ratio)
    pt = tables.model_classes["ParaformerStreaming"](
        **conf, generator=torch.Generator().manual_seed(seed)).train()
    jm = jtables.model_classes["ParaformerStreaming"](**conf)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm, "ParaformerStreaming"))


def key_drawing(ind, n_cfg=2):
    """The first PRNGKey(s) whose forward_jit draws chunk config ``ind``."""
    for s in range(100):
        key = jax.random.PRNGKey(s)
        if int(jax.random.randint(jax.random.split(key, 3)[2], (), 0, n_cfg)) == ind:
            return key
    raise AssertionError("no key draws the config")


def test_params_from_jax_round_trips_the_training_params():
    """JAX-initialised ParaformerStreaming parameters (the training config: the chunk
    encoder, the decoder at sanm_shfit 5) through ``convert.params_from_jax`` into the
    port and back through the JAX converter: every leaf equal; the port then gives JAX's
    loss on them."""
    from funasr_tpu_torch.convert import params_from_jax
    pt, jm, _ = build()
    params = jm.init_params(jax.random.PRNGKey(4))
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    back = convert_state_dict(pt.state_dict(), jm, "ParaformerStreaming")
    leaves = jax.tree_util.tree_leaves_with_path(params)
    for path, want in leaves:
        got = back
        for k in path:
            got = got[k.key] if hasattr(k, "key") else got[k.idx]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))
    speech, slen, text, tlen = batch(2)
    key = key_drawing(1)
    jl, _, _ = jm.forward_jit(params, jnp.asarray(speech), jnp.asarray(slen), jnp.asarray(text),
                              jnp.asarray(tlen), key)
    with torch.no_grad():
        pl, _, _ = pt(torch.from_numpy(speech), torch.from_numpy(slen),
                      torch.from_numpy(text).long(), torch.from_numpy(tlen).long(),
                      chunk_index=1)
    assert abs(float(pl) - float(jl)) <= LOSS_RTOL * abs(float(jl))


@pytest.mark.parametrize("ind", [0, 1])
def test_forward_train_chunk_matches_jax(ind):
    pt, jm, params = build()
    speech, slen, _, _ = batch(1)
    l_max = speech.shape[1]
    stacked, cfgs, pad_left = jm._stacked_chunk_masks(l_max)
    n = np.ceil(slen / cfgs["stride"][ind]).astype(np.int32)
    jmasks = {k: v[ind] for k, v in stacked.items()}
    jmasks.update(x_len_chunk=((n - 1) * cfgs["shift"][ind] + 5 + pad_left + slen
                               - (n - 1) * cfgs["stride"][ind]).astype(np.int32),
                  pad_left=pad_left)
    want, want_lens = jm.encoder.forward_train_chunk(params["encoder"], jnp.asarray(speech),
                                                     jnp.asarray(slen), jmasks)
    masks = dict(pt.chunk_masks(l_max, ind, torch.device("cpu")))
    masks["x_len_chunk"] = torch.from_numpy(jmasks["x_len_chunk"])
    got, got_lens = pt.encoder.forward_train_chunk(torch.from_numpy(speech),
                                                   torch.from_numpy(slen), masks)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    err = np.abs(got.detach().numpy() - np.asarray(want)).max()
    assert err <= ENC_TOL, err


@pytest.fixture
def cif_tie_moved(monkeypatch):
    """Both packages' training CIF with the rescaled alphas scaled by CIF_TIE_SCALE (the
    last fire sits on a rounding tie at the exact target count)."""
    jax_fn, port_fn = jax_cif.cif, port_cif.cif
    monkeypatch.setattr(jax_cif, "cif", lambda h, a, k, thr=1.0: jax_fn(h, a * CIF_TIE_SCALE,
                                                                          k, thr))
    monkeypatch.setattr(port_cif, "cif", lambda h, a, k, thr=1.0: port_fn(h, a * CIF_TIE_SCALE,
                                                                            k, thr))


def port_grads(pt):
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in pt.named_parameters()}
    return {k: grads.get(k, v) for k, v in pt.state_dict().items()}


@pytest.mark.parametrize("sampling_ratio", [0.0, 0.75])
@pytest.mark.parametrize("ind", [0, 1])
def test_loss_stats_and_grads_match_jax(ind, sampling_ratio, cif_tie_moved):
    pt, jm, params = build(sampling_ratio)
    speech, slen, text, tlen = batch()
    key = key_drawing(ind)
    kwargs = {}
    if sampling_ratio > 0:  # the sampler's uniforms, as JAX draws them
        k_smp = jax.random.split(key, 3)[1]
        uniform = np.asarray(jax.random.uniform(k_smp, (B, L + 1)))
        kwargs["sampler_uniform"] = torch.from_numpy(uniform.copy())

    def loss_fn(p):
        loss, stats, weight = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                             jnp.asarray(text), jnp.asarray(tlen), key)
        return loss, (stats, weight)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, stats, weight = pt(torch.from_numpy(speech), torch.from_numpy(slen),
                             torch.from_numpy(text).long(), torch.from_numpy(tlen).long(),
                             chunk_index=ind, **kwargs)
    loss.backward()
    jl = float(jl)
    assert math.isfinite(loss.item()) and abs(loss.item() - jl) <= LOSS_RTOL * abs(jl), \
        (loss.item(), jl)
    assert set(stats) == set(jst)
    for k, want in jst.items():
        got = float(stats[k].detach())
        assert abs(got - float(want)) <= LOSS_RTOL * max(abs(float(want)), 1.0), (k, got, want)
    assert int(weight) == int(jw)
    pg = convert_state_dict(port_grads(pt), jm, "ParaformerStreaming")
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    for path, want in leaves:
        got = pg
        for k in path:
            got = got[k.key] if hasattr(k, "key") else got[k.idx]
        want, got = np.asarray(want), np.asarray(got)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
    assert len(leaves) >= 40


def test_generator_draws_both_configs():
    """The config comes from the step's generator: over a few seeds both occur."""
    pt, _, _ = build()
    seen = set()
    speech, slen, text, tlen = (torch.from_numpy(x) for x in batch())
    masks_by = {}
    for s in range(6):
        g = torch.Generator().manual_seed(s)
        ind = int(torch.randint(2, (), generator=g))
        seen.add(ind)
        with torch.no_grad():
            loss, _, _ = pt(speech, slen, text.long(), tlen.long(),
                            generator=torch.Generator().manual_seed(s))
        masks_by.setdefault(ind, float(loss))
        assert math.isfinite(float(loss))
    assert seen == {0, 1} and len(set(masks_by.values())) == 2


# ---------------------------------------------------------------------------
# the recipe on the CPU
# ---------------------------------------------------------------------------

def write_stream_train_dir(d, tokens):
    import yaml
    from torch_parity_util import STREAM_FRONTEND, write_identity_cmvn
    conf = dict(CONF, input_size=560, vocab_size=len(tokens), sampling_ratio=0.75)
    model = tables.model_classes["ParaformerStreaming"](
        **conf, generator=torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    write_identity_cmvn(os.path.join(d, "am.mvn"), 560)
    cfg = dict(model="ParaformerStreaming",
               model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0, lsm_weight=0.1,
                               length_normalized_loss=True, sampling_ratio=0.75),
               encoder="SANMEncoderChunkOpt", encoder_conf=dict(ENC, input_layer="pe_online"),
               decoder="ParaformerSANMDecoder", decoder_conf=DEC,
               predictor="CifPredictorV2", predictor_conf=CONF["predictor_conf"],
               frontend="WavFrontendOnline",
               frontend_conf=dict(STREAM_FRONTEND, cmvn_file="am.mvn"),
               tokenizer="CharTokenizer",
               tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>"))
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def test_bin_train_streaming_recipe_on_cpu(tmp_path):
    """finetune.sh on the CPU: scp2jsonl, 2 epochs of ``bin/train``, the 2 best averaged;
    the average decodes through ``AutoModel``'s streaming ``generate``."""
    from funasr_tpu_torch.bin import data_tools
    from torch_parity_util import TOKENS, wav_bytes
    md = tmp_path / "model"
    md.mkdir()
    write_stream_train_dir(str(md), TOKENS)
    rng = np.random.default_rng(16)
    scp, txt = [], []
    for i in range(3):
        path = tmp_path / f"u{i}.wav"
        path.write_bytes(wav_bytes(0.2 * rng.standard_normal(int(16000 * (0.8 + 0.4 * i)))))
        scp.append(f"u{i} {path}")
        txt.append(f"u{i} " + "".join(TOKENS[int(j)] for j in rng.integers(3, 40, 3 + i)))
    (tmp_path / "wav.scp").write_text("\n".join(scp) + "\n", encoding="utf-8")
    (tmp_path / "text.txt").write_text("\n".join(txt) + "\n", encoding="utf-8")
    jsonl = str(tmp_path / "train.jsonl")
    data_tools.scp2jsonl([str(tmp_path / "wav.scp"), str(tmp_path / "text.txt")],
                         ["source", "target"], jsonl)
    out = str(tmp_path / "exp")
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "funasr_tpu_torch.bin.train", f"++model={md}", "++device=cpu",
         f"++train_data_set_list={jsonl}", f"++valid_data_set_list={jsonl}",
         "++dataset_conf.batch_size=300", "++dataset_conf.batch_type=token",
         "++optim_conf.lr=0.0002", "++train_conf.max_epoch=2", "++train_conf.log_interval=1",
         "++train_conf.avg_nbest_model=2", "++train_conf.use_tensorboard=False",
         f"++output_dir={out}"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    steps = [x for x in lines if "validate" not in x]
    assert len(steps) >= 2 and all(math.isfinite(x["loss"]) for x in steps)
    from funasr_tpu_torch import AutoModel
    am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cpu")
    wave = (0.2 * rng.standard_normal(16000 * 2)).astype(np.float32)
    cache, text = {}, ""
    for i in range(0, len(wave), 9600):
        res = am.generate(input=wave[i:i + 9600], cache=cache, is_final=i + 9600 >= len(wave),
                          chunk_size=[0, 10, 5], encoder_chunk_look_back=4,
                          decoder_chunk_look_back=1)
        text += res[0]["text"]
    assert isinstance(text, str)


def test_launch_shapes_keep_a_holed_mask():
    """A recorded FSMN launch keeps its mask's row sums and, for a mask with holes (the
    encoder's frame mask), its [start, end) runs; a prefix mask keeps its sums only."""
    from funasr_tpu_torch.ops import cuda_lib

    def fsmn_memory():
        pass
    fsmn_memory.launches = 0
    x = torch.zeros(2, 12, 4)
    holed = torch.tensor([[0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0],
                          [0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    prefix = torch.arange(12)[None] < torch.tensor([[12], [5]])
    cuda_lib.record_launch_shapes()
    try:
        cuda_lib.count_launch(fsmn_memory, (x,), (11, 5, 5), holed)
        cuda_lib.count_launch(fsmn_memory, (x,), (11, 5, 5), holed)
        cuda_lib.count_launch(fsmn_memory, (x[:, :6],), (11, 5, 5), prefix[:, :6])
        taken = cuda_lib.take_launch_shapes()
    finally:
        cuda_lib.stop_recording_launch_shapes()
    assert fsmn_memory.launches == 3
    assert taken[0]["launches"] == 2 and taken[0]["lengths"] == [5, 10]
    assert taken[0]["mask_runs"] == [[[2, 5], [7, 9]], [[2, 12]]]
    assert taken[1]["lengths"] == [6, 5] and "mask_runs" not in taken[1]


STREAM_MODULES = ["funasr_tpu_torch.models.scama.chunk_utils",
                  "funasr_tpu_torch.models.scama.encoder",
                  "funasr_tpu_torch.models.paraformer_streaming.model",
                  "funasr_tpu_torch.ops.flash_attention"]


def test_streaming_training_modules_import_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {STREAM_MODULES!r}:\n    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'funasr_tpu.'))"
            " or m == 'funasr_tpu']\n"
            "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
