"""The training losses of SenseVoice-Small, the CTC model, Paraformer-v2, E-Paraformer,
BiCif, SeACo, Contextual, the fa-zh aligner and CT-Transformer against the JAX
package's (CPU), and the recipe's data, checkpoint ranking and CLI around them.

* Each model's ``forward`` (loss, stats, weight) and every parameter's gradient against
  ``jax.jit(jax.value_and_grad(forward_jit))`` on the same weights (the port's state
  dict through ``convert_state_dict``) and the same inputs: dropout 0, SpecAug off, the
  glancing sampler's uniforms fed from JAX's key. Limits: the loss and stats within 1e-5
  relative, each gradient leaf within 1e-4 relative L2 (fp32 on the CPU in both; sums in
  other orders). The CIF models move the training CIF's last-fire tie alike in both
  packages (``cif_tie_moved``, as ``test_torch_train_grads.py`` does).
* ``ctc_forced_align_device`` int-equal to ``ctc_forced_align_jax``.
* ``SenseVoiceDataset`` / ``AudioDatasetHotword`` items equal to the JAX package's on
  integer-tag rows; the string tags ``bin/data_tools sensevoice2jsonl`` writes, on which
  the JAX dataset raises and the port gives the tags' token ids.
* Checkpoint ranking on a model that reports no ``acc``: the JAX trainer keeps the
  highest losses, the port's pruning and ``average_checkpoints`` the lowest.
* ``bin/train`` on SenseVoice on the CPU, from ``sensevoice2jsonl`` to the averaged
  checkpoint decoding through ``AutoModel``.
* Which models train (``Paraformer.forward``'s guard), and the import boundary.

``chip_smoke.py``'s phase 17 and the card's tests are in ``test_torch_train_family_chip.py``.
"""

import json
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
from funasr_tpu.convert.torch_to_jax import (SD, convert_ctc, convert_sanm_encoder,
                                             convert_state_dict)
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch.register import tables
from torch_parity_util import SV_TAGS, sense_voice_tokens, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
CIF_TIE_SCALE = 1 + 1e-5
ZERO_SHARE = 1e-6  # a gradient leaf under this share of the global norm is zero
V = 41
B, T, L = 3, 40, 8
SV_V = 25055

ENC = dict(output_size=32, attention_heads=4, linear_units=48, num_blocks=2, dropout_rate=0.0)
DEC = dict(attention_heads=4, linear_units=48, num_blocks=2, att_layer_num=2, sanm_shfit=0)
PARA = dict(input_size=80, vocab_size=V, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=dict(idim=32), sos=1, eos=2, lsm_weight=0.1,
            length_normalized_loss=True)
V3 = dict(idim=32, upsample_times=3, upsample_type="cnn_blstm", smooth_factor2=0.25,
          noise_threshold2=0.01)

# model -> (config, whether its CIF trains, the sampler's width past the text's)
MODELS = {
    "SenseVoiceSmall": (dict(
        input_size=80, vocab_size=SV_V, lsm_weight=0.1, length_normalized_loss=False,
        encoder="SenseVoiceEncoderSmall",
        encoder_conf=dict(output_size=32, attention_heads=4, linear_units=48, num_blocks=2,
                          tp_blocks=1, kernel_size=11, sanm_shfit=0)), False, None),
    "CTC": (dict(input_size=80, vocab_size=V, encoder_conf=ENC), False, None),
    "ParaformerV2": ({**{k: v for k, v in PARA.items() if k != "predictor_conf"},
                      "ctc_weight": 0.5}, False, None),
    "EParaformer": (dict(PARA, sampling_ratio=0.75, predictor_conf=dict(idim=32,
                                                                          sigma_heads=4)),
                    False, 2),
    "BiCifParaformer": (dict(PARA, sampling_ratio=0.75, predictor_bias=1,
                             predictor_conf=V3), True, 1),
    "SeacoParaformer": (dict(PARA, sampling_ratio=0.0, predictor_bias=1, predictor_conf=V3,
                             inner_dim=32, seaco_decoder="ParaformerSANMDecoder",
                             seaco_decoder_conf=dict(DEC, num_blocks=1, att_layer_num=1,
                                                     kernel_size=21)), True, None),
    "ContextualParaformer": (dict(PARA, sampling_ratio=0.75, predictor_bias=1,
                                  inner_dim=32), True, 1),
    "MonotonicAligner": (dict(input_size=80, encoder_conf=ENC, predictor_conf=V3,
                              predictor_bias=1, length_normalized_loss=True), False, None),
}
CT_CONF = dict(vocab_size=50, embed_unit=32, att_unit=32, ignore_id=-1,
               punc_weight=[1.0, 0.5, 2.0, 1.5, 3.0, 1.0],
               encoder_conf=dict(input_size=32, output_size=32, attention_heads=8,
                                 linear_units=48, num_blocks=2, kernel_size=11, sanm_shfit=0,
                                 dropout_rate=0.0))


def asr_batch(model_name, seed=0):
    """(B, T, 80) features, their lengths, (B, L') ids padded with -1 and their lengths;
    SenseVoice's rows start with the four tags (row 2's language unknown to the
    query table, row 1 with itn)."""
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((B, T, 80)).astype(np.float32)
    slen = np.array([40, 33, 21], np.int32)
    tlen = np.array([6, 8, 3], np.int32)
    text = np.full((B, L), -1, np.int32)
    for i in range(B):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    if model_name == "SenseVoiceSmall":
        tags = np.array([[24884, 24993, 25004, 25017], [24885, 24994, 25001, 25016],
                         [5, 24993, 25004, 25017]], np.int32)
        text, tlen = np.concatenate([tags, text], axis=1), tlen + 4
    return speech, slen, text, tlen


@pytest.fixture
def cif_tie_moved(monkeypatch):
    """Both packages' training CIF with the rescaled alphas scaled by CIF_TIE_SCALE."""
    jax_fn, port_fn = jax_cif.cif, port_cif.cif
    monkeypatch.setattr(jax_cif, "cif", lambda h, a, k, thr=1.0: jax_fn(h, a * CIF_TIE_SCALE,
                                                                          k, thr))
    monkeypatch.setattr(port_cif, "cif", lambda h, a, k, thr=1.0: port_fn(h, a * CIF_TIE_SCALE,
                                                                            k, thr))


def to_jax_tree(sd, name, jm):
    """A port state dict (weights or gradients) as the JAX model's parameter tree."""
    if name == "CTC":
        view = SD(sd)
        return {"encoder": convert_sanm_encoder(view.sub("encoder"), ENC["num_blocks"]),
                "ctc": convert_ctc(view.sub("ctc"))}
    return convert_state_dict(sd, jm, name)


def port_grads(pt):
    """Each state-dict entry's gradient, zeros where the loss does not reach a parameter
    (JAX's gradient tree holds zeros there)."""
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in pt.named_parameters()}
    return {k: grads.get(k, v) for k, v in pt.state_dict().items()}


def leaf(tree, path):
    for k in path:
        tree = tree[k.key] if hasattr(k, "key") else tree[k.idx]
    return np.asarray(tree)


def assert_grads_match(jax_grads, port_tree):
    """Each leaf within GRAD_REL_L2 relative L2. A leaf whose gradient is zero in exact
    arithmetic (the PIF predictor's per-head ``bias``: softmax over the frames does not
    move when a head's scores all shift) holds rounding noise in both packages; such a
    leaf, under ZERO_SHARE of the gradient's global norm in JAX, must stay under it in
    the port too. Returns the count of leaves compared."""
    leaves = jax.tree_util.tree_leaves_with_path(jax_grads)
    floor = ZERO_SHARE * np.sqrt(sum(float(np.sum(np.square(w))) for _, w in leaves))
    for path, want in leaves:
        want, got = np.asarray(want), leaf(port_tree, path)
        if np.linalg.norm(want) <= floor:
            assert np.linalg.norm(got) <= floor, (jax.tree_util.keystr(path), floor)
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
    return len(leaves)


def run_both(name, seed=0):
    conf, _, extra = MODELS[name]
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed)).train()
    jm = jtables.model_classes[name](**conf)
    params = to_jax(to_jax_tree(pt.state_dict(), name, jm))
    speech, slen, text, tlen = asr_batch(name, seed)
    key = jax.random.PRNGKey(seed + 3)
    kwargs = {}
    if extra is not None:  # the glancing sampler's uniforms, as JAX draws them
        _, k_smp = jax.random.split(key)
        uniform = np.asarray(jax.random.uniform(k_smp, (B, text.shape[1] + extra)))
        kwargs["sampler_uniform"] = torch.from_numpy(uniform.copy())

    def loss_fn(p):
        loss, stats, weight = jm.forward_jit(p, jnp.asarray(speech), jnp.asarray(slen),
                                             jnp.asarray(text), jnp.asarray(tlen), key)
        return loss, (stats, weight)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, stats, weight = pt(torch.from_numpy(speech), torch.from_numpy(slen),
                             torch.from_numpy(text).long(), torch.from_numpy(tlen).long(),
                             **kwargs)
    loss.backward()
    return (float(jl), jst, jw, jg), (loss.item(), stats, weight,
                                      to_jax_tree(port_grads(pt), name, jm))


def assert_stats_match(pst, jst):
    assert set(pst) == set(jst)
    for k, want in jst.items():
        want = float(want)
        got = float(pst[k].detach()) if torch.is_tensor(pst[k]) else float(pst[k])
        assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1.0), (k, got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_stats_weight_and_grads_match_jax(name, request):
    if MODELS[name][1]:
        request.getfixturevalue("cif_tie_moved")
    (jl, jst, jw, jg), (pl, pst, pw, pg) = run_both(name)
    assert np.isfinite(pl) and abs(pl - jl) <= LOSS_RTOL * abs(jl), (pl, jl)
    assert_stats_match(pst, jst)
    assert int(pw) == int(jw)
    assert assert_grads_match(jg, pg) >= 10


def test_ct_transformer_loss_and_grads_match_jax():
    """CT-Transformer's weighted CE (``forward(text, punc, text_lengths)``), its token
    count as the weight."""
    pt = tables.model_classes["CTTransformer"](**CT_CONF,
                                               generator=torch.Generator().manual_seed(1))
    jm = jtables.model_classes["CTTransformer"](**CT_CONF)
    params = to_jax(convert_state_dict(pt.state_dict(), jm))
    rng = np.random.default_rng(1)
    lens = np.array([12, 9, 4], np.int32)
    text = rng.integers(0, 50, (3, 12)).astype(np.int32)
    punc = np.where(np.arange(12)[None] < lens[:, None], rng.integers(0, 6, (3, 12)), -1)
    punc = punc.astype(np.int32)

    def loss_fn(p):
        loss, stats, w = jm.forward_jit(p, jnp.asarray(text), jnp.asarray(punc),
                                        jnp.asarray(lens))
        return loss, (stats, w)

    (jl, (jst, jw)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, stats, w = pt(torch.from_numpy(text).long(), torch.from_numpy(punc).long(),
                        torch.from_numpy(lens))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert_stats_match(stats, jst)
    assert int(w) == int(jw) == int(lens.sum())
    assert assert_grads_match(jg, convert_state_dict(port_grads(pt), jm)) >= 10


# ---------------------------------------------------------------------------
# the device viterbi
# ---------------------------------------------------------------------------

def _log_softmax(x):
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _viterbi_case(case):
    """(log-probs (B, T, V), targets (B, L) padded with 0, input lengths, target lengths)."""
    rng = np.random.default_rng(len(case))
    if case == "repeats":
        tg = [[2, 2, 3, 3, 3], [5, 1, 5, 1, 0], [7, 7, 7, 7, 7]]
        tl, il, t, v = [5, 4, 5], [20, 16, 18], 20, 9
    elif case == "empty_rows":  # L = 0 in two rows, one of them with no frames either
        tg = [[0, 0, 0], [3, 4, 0], [0, 0, 0]]
        tl, il, t, v = [0, 2, 0], [12, 9, 0], 12, 6
    elif case == "tight":  # T = 2L + 1 frames, and a repeat that needs all of them
        tg = [[4, 4, 4], [1, 2, 3], [2, 0, 0]]
        tl, il, t, v = [3, 3, 1], [7, 7, 3], 7, 6
    elif case == "infeasible":  # fewer frames than the target needs
        tg = [[3, 3, 3, 3], [1, 2, 3, 4]]
        tl, il, t, v = [4, 4], [5, 3], 6, 6
    elif case == "ties":  # equal log-probs: every move a tie, the first maximum decides
        tg = [[1, 2, 2, 3], [3, 3, 0, 0], [5, 0, 0, 0]]
        tl, il, t, v = [4, 2, 1], [14, 10, 6], 14, 7
    else:  # half the frames tied, built from two values
        tg = [[2, 5, 5, 1], [6, 6, 0, 0]]
        tl, il, t, v = [4, 2], [16, 11], 16, 8
    b = len(tg)
    if case == "ties":
        logp = np.full((b, t, v), -np.log(v), np.float32)
    elif case == "half_ties":
        logp = _log_softmax(rng.integers(0, 2, (b, t, v)).astype(np.float32))
        logp[:, ::2] = -np.log(np.float32(v))
    else:
        logp = _log_softmax(rng.standard_normal((b, t, v)).astype(np.float32) * 2)
    return (logp, np.asarray(tg, np.int64), np.asarray(il, np.int64),
            np.asarray(tl, np.int64))


@pytest.mark.parametrize("case", ["repeats", "empty_rows", "tight", "infeasible", "ties",
                                  "half_ties"])
def test_ctc_forced_align_device_equals_jax(case):
    from funasr_tpu.ops.ctc_align import ctc_forced_align_jax
    from funasr_tpu_torch.ops.ctc_align import ctc_forced_align_device
    logp, tg, il, tl = _viterbi_case(case)
    want = np.asarray(jax.jit(ctc_forced_align_jax)(
        jnp.asarray(logp), jnp.asarray(tg, jnp.int32), jnp.asarray(il, jnp.int32),
        jnp.asarray(tl, jnp.int32)))
    got = ctc_forced_align_device(torch.from_numpy(logp), torch.from_numpy(tg),
                                  torch.from_numpy(il), torch.from_numpy(tl))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[np.arange(logp.shape[1])[None] >= il[:, None]] == -1).all()


def test_ctc_forced_align_device_spells_the_target():
    """Where the frames suffice, the alignment visits every target position in order."""
    from funasr_tpu_torch.ops.ctc_align import ctc_forced_align_device
    logp, tg, il, tl = _viterbi_case("repeats")
    idx = ctc_forced_align_device(torch.from_numpy(logp), torch.from_numpy(tg),
                                  torch.from_numpy(il), torch.from_numpy(tl)).numpy()
    for row, n in zip(idx, tl):
        seen = [int(x) for i, x in enumerate(row) if x >= 0 and (i == 0 or row[i - 1] != x)]
        assert seen == list(range(n))


# ---------------------------------------------------------------------------
# the datasets and the recipe's jsonl
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sv_corpus(tmp_path_factory):
    """4 wavs of 0.6-1.5 s with texts of the test vocabulary, as wav.scp + text.txt, and
    the jsonl ``sensevoice2jsonl`` writes from them."""
    from funasr_tpu_torch.bin import data_tools
    from torch_parity_util import wav_bytes
    root = tmp_path_factory.mktemp("sv_corpus")
    rng = np.random.default_rng(15)
    tokens = sense_voice_tokens()
    scp, txt = [], []
    for i in range(4):
        path = root / f"u{i}.wav"
        path.write_bytes(wav_bytes(0.2 * rng.standard_normal(int(16000 * (0.6 + 0.3 * i)))))
        scp.append(f"u{i} {path}")
        txt.append(f"u{i} " + "".join(tokens[int(j)] for j in rng.integers(4, 60, 3 + i)))
    (root / "wav.scp").write_text("\n".join(scp) + "\n", encoding="utf-8")
    (root / "text.txt").write_text("\n".join(txt) + "\n", encoding="utf-8")
    jsonl = str(root / "sv.jsonl")
    data_tools.sensevoice2jsonl([str(root / "wav.scp"), str(root / "text.txt")],
                                ["source", "target"], jsonl)
    return root, tokens, jsonl


def _datasets(name, jsonl, tokens, **kwargs):
    from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
    from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
    conf = dict(index_ds="IndexDSJsonl", index_ds_conf={"path": jsonl}, **kwargs)
    return (jtables.dataset_classes[name](tokenizer=JaxCharTokenizer(token_list=tokens), **conf),
            tables.dataset_classes[name](tokenizer=CharTokenizer(token_list=tokens), **conf))


def _rewrite_jsonl(src, dst, edit):
    with open(src, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    with open(dst, "w", encoding="utf-8") as f:
        for i, row in enumerate(rows):
            f.write(json.dumps(edit(i, row), ensure_ascii=False) + "\n")


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_sensevoice2jsonl_writes_the_same_rows_in_both_packages(sv_corpus, tmp_path):
    from funasr_tpu.bin import data_tools as jdata_tools
    root, _, jsonl = sv_corpus
    out = str(tmp_path / "jax.jsonl")
    jdata_tools.sensevoice2jsonl([str(root / "wav.scp"), str(root / "text.txt")],
                                 ["source", "target"], out)
    assert open(out, encoding="utf-8").read() == open(jsonl, encoding="utf-8").read()
    row = json.loads(open(jsonl, encoding="utf-8").readline())
    assert (row["lid"], row["emo"], row["event"], row["with_itn"]) == ("zh", "NEUTRAL",
                                                                        "Speech", False)


@pytest.mark.parametrize("tags", ["integers", "none", "textnorm", "tag_ids_conf"])
def test_sense_voice_dataset_equals_jax_on_integer_tags(sv_corpus, tmp_path, tags):
    """Integer tags, rows without tags (the JAX defaults 3, 1, 2, 15) and
    ``tag_ids_conf``: the port's items are the JAX package's."""
    _, tokens, jsonl = sv_corpus
    drop = ("lid", "emo", "event", "with_itn")

    def edit(i, row):
        row = {k: v for k, v in row.items() if k not in drop}
        if tags == "integers":
            row.update(lid=24884 + i, emo=25001 + i, event=str(24993 + i))
        elif tags == "textnorm":
            row.update(textnorm=25016 + i % 2, lid=24885)
        return row

    path = str(tmp_path / "rows.jsonl")
    _rewrite_jsonl(jsonl, path, edit)
    kwargs = ({"tag_ids_conf": {"lid": 24884, "textnorm": 25017}} if tags == "tag_ids_conf"
              else {})
    jds, pds = _datasets("SenseVoiceDataset", path, tokens, **kwargs)
    for i in range(len(pds)):
        _assert_items_equal(pds[i], jds[i])
    assert list(pds[0]["text"][:4]) == {"integers": [24884, 24993, 25001, 15],
                                        "none": [3, 1, 2, 15],
                                        "textnorm": [24885, 1, 2, 25016],
                                        "tag_ids_conf": [24884, 1, 2, 25017]}[tags]


def test_sense_voice_dataset_repairs_sensevoice2jsonl_string_tags(sv_corpus, tmp_path):
    """The recipe's own jsonl: the JAX dataset raises on the string tags; the port gives
    the ids of <|zh|>, <|Speech|>, <|NEUTRAL|>, <|woitn|> (with_itn false), <|withitn|>
    where with_itn is true, names a tag the vocabulary lacks, and keeps the text."""
    _, tokens, jsonl = sv_corpus
    ids = {tag: i for i, tag in SV_TAGS.items()}
    jds, pds = _datasets("SenseVoiceDataset", jsonl, tokens)
    with pytest.raises(ValueError, match="invalid literal for int"):
        jds[0]
    item = pds[0]
    assert list(item["text"][:4]) == [ids["<|zh|>"], ids["<|Speech|>"], ids["<|NEUTRAL|>"],
                                      ids["<|woitn|>"]]
    plain = tables.dataset_classes["AudioDataset"](
        index_ds="IndexDSJsonl", index_ds_conf={"path": jsonl}, tokenizer=pds.tokenizer)[0]
    np.testing.assert_array_equal(item["text"][4:], plain["text"])
    assert item["text_lengths"] == plain["text_lengths"] + 4

    path = str(tmp_path / "tags.jsonl")
    _rewrite_jsonl(jsonl, path, lambda i, row: dict(row, with_itn=True, lid="<|en|>",
                                                    emo="HAPPY", event="BGM"))
    _, pds = _datasets("SenseVoiceDataset", path, tokens)
    assert list(pds[1]["text"][:4]) == [ids["<|en|>"], ids["<|BGM|>"], ids["<|HAPPY|>"],
                                        ids["<|withitn|>"]]
    _rewrite_jsonl(jsonl, path, lambda i, row: dict(row, lid="xx"))
    _, pds = _datasets("SenseVoiceDataset", path, tokens)
    with pytest.raises(KeyError, match=r"<\|xx\|>"):
        pds[0]


def test_audio_dataset_hotword_equals_jax(sv_corpus):
    _, tokens, jsonl = sv_corpus
    jds, pds = _datasets("AudioDatasetHotword", jsonl, tokens, hotword_min_length=2,
                         hotword_max_length=4, sample_rate=0.75, seed=3)
    for _ in range(2):  # the same draws, item after item
        for i in range(len(pds)):
            _assert_items_equal(pds[i], jds[i])


def test_sense_voice_ctc_dataset_alias_binds():
    from funasr_tpu_torch.datasets.specialized_datasets import SenseVoiceDataset
    assert tables.dataset_classes["SenseVoiceCTCDataset"] is SenseVoiceDataset


# ---------------------------------------------------------------------------
# n-best ranking of a model that reports no accuracy
# ---------------------------------------------------------------------------

class PortLossOnly(torch.nn.Module):
    """A model whose validation reports only a loss: sum(w ** 2)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))

    def forward(self, speech, speech_lengths, text, text_lengths, generator=None):
        loss = (self.w ** 2).sum()
        return loss, {"loss": loss}, speech.shape[0]


class JaxLossOnly:
    def forward_jit(self, params, speech, speech_lengths, text, text_lengths, rng):
        loss = jnp.sum(params["w"] ** 2)
        return loss, {"loss": loss}, speech.shape[0]


VAL_BATCH = {"speech": np.zeros((2, 8), np.float32), "speech_lengths": np.array([8, 8], np.int32),
             "text": np.zeros((2, 3), np.int32), "text_lengths": np.array([3, 3], np.int32)}
VAL_W = ([0.5, 0.5], [1.0, 1.0], [0.5, 1.0])  # validation losses 0.5, 2.0, 1.25


def _left(out):
    return sorted(n for n in os.listdir(out) if n.startswith("model.pt.ep"))


def test_nbest_keeps_the_highest_losses_in_jax_and_the_lowest_in_the_port(tmp_path):
    """Three validations (losses 0.5, 2.0, 1.25) with ``keep_nbest_models`` 1 and the
    default ``avg_keep_nbest_models_type`` "acc", which the model does not report: the
    JAX trainer's metric is the loss, ranked highest first, so it keeps epoch 1 (2.0) and
    the latest and deletes the best; the port records ``metric_name`` "loss" and keeps
    epoch 0 (0.5). With nothing pruned, the port's ``average_checkpoints`` of 2 takes the
    two lowest losses."""
    import optax
    from funasr_tpu.parallel.sharding import make_mesh
    from funasr_tpu.train_utils.trainer import Trainer as JaxTrainer
    from funasr_tpu_torch.train_utils.average_nbest_models import average_checkpoints
    from funasr_tpu_torch.train_utils.trainer import Trainer

    jout = str(tmp_path / "jax")
    jt = JaxTrainer(JaxLossOnly(), optax.adam(0.1), output_dir=jout, keep_nbest_models=1,
                    mesh=make_mesh(1, model=1), use_tensorboard=False)
    state = jt.tx.init({"w": jnp.zeros(2)})
    metrics = []
    for epoch, w in enumerate(VAL_W):
        params = {"w": jnp.asarray(w, jnp.float32)}
        metrics.append(jt.validate_epoch(params, [VAL_BATCH], epoch, jax.random.PRNGKey(0)))
        jt.save_checkpoint(params, state, epoch, metric=metrics[-1])
    assert metrics == pytest.approx([0.5, 2.0, 1.25])
    assert _left(jout) == ["model.pt.ep1", "model.pt.ep2"]  # the worst loss kept

    for keep, want in ((1, ["model.pt.ep0", "model.pt.ep2"]), (3, None)):
        out = str(tmp_path / f"port{keep}")
        model = PortLossOnly()
        t = Trainer(model, torch.optim.Adam(model.parameters(), lr=0.1), output_dir=out,
                    keep_nbest_models=keep, use_tensorboard=False)
        for epoch, w in enumerate(VAL_W):
            with torch.no_grad():
                model.w.copy_(torch.tensor(w))
            val = t.validate_epoch([VAL_BATCH], epoch)
            assert val["metric_name"] == "loss"
            t.save_checkpoint(epoch, **val)
        t.close()
        if want:
            assert _left(out) == want
            state = torch.load(os.path.join(out, "model.pt.ep0"), weights_only=True)
            assert (state["metric"], state["metric_name"]) == (pytest.approx(0.5), "loss")
    avg = torch.load(average_checkpoints(out, 2), weights_only=True)
    assert [os.path.basename(p) for p in avg["averaged_from"]] == ["model.pt.ep0",
                                                                   "model.pt.ep2"]
    torch.testing.assert_close(avg["state_dict"]["w"], torch.tensor([0.5, 0.75]))


def test_nbest_ranks_an_accuracy_highest_first(tmp_path):
    """A model that reports ``acc``: the metric is it, kept and averaged highest first."""
    from funasr_tpu_torch.train_utils.average_nbest_models import average_checkpoints
    from funasr_tpu_torch.train_utils.trainer import Trainer
    model = PortLossOnly()
    t = Trainer(model, torch.optim.Adam(model.parameters(), lr=0.1), output_dir=str(tmp_path),
                keep_nbest_models=2, use_tensorboard=False)
    for epoch, acc in enumerate((0.7, 0.2, 0.9, 0.4)):
        t.save_checkpoint(epoch, metric=acc, metric_name="acc")
    t.close()
    assert _left(tmp_path) == ["model.pt.ep0", "model.pt.ep2", "model.pt.ep3"]  # + latest
    avg = torch.load(average_checkpoints(str(tmp_path), 2), weights_only=True)
    assert sorted(os.path.basename(p) for p in avg["averaged_from"]) == ["model.pt.ep0",
                                                                         "model.pt.ep2"]


# ---------------------------------------------------------------------------
# SenseVoice's recipe through the CLIs on the CPU
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SV_SMALL = dict(input_size=560, vocab_size=SV_V, blank_id=0, encoder="SenseVoiceEncoderSmall",
                encoder_conf=dict(output_size=32, attention_heads=4, linear_units=48,
                                  num_blocks=2, tp_blocks=1, kernel_size=11, sanm_shfit=0))
SV_SPECAUG = dict(apply_time_warp=False, apply_freq_mask=True, freq_mask_width_range=[0, 30],
                  lfr_rate=6, num_freq_mask=1, apply_time_mask=True,
                  time_mask_width_range=[0, 12], num_time_mask=1)


def test_sense_voice_train_cli_cpu_end_to_end(sv_corpus, tmp_path):
    """finetune.sh's recipe for SenseVoice on the CPU: ``data_tools sensevoice2jsonl``
    (string tags), ``bin/train ++dataset=SenseVoiceDataset`` with SpecAug and
    ``lsm_weight`` in the config, two epochs, the 2 best averaged by their loss (the
    model reports ``acc_rich``, not ``acc``); the average decodes through ``AutoModel``."""
    import yaml
    from torch_parity_util import write_sense_voice_dir
    root, _, _ = sv_corpus
    d = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    jsonl = os.path.join(d, "train.jsonl")
    subprocess.run([sys.executable, "-m", "funasr_tpu_torch.bin.data_tools", "sensevoice2jsonl",
                    f'++scp_file_list=["{root / "wav.scp"}","{root / "text.txt"}"]',
                    '++data_type_list=["source","target"]', f"++jsonl_file_out={jsonl}"],
                   check=True, env=env, cwd=d, capture_output=True)
    md = os.path.join(d, "sv")
    os.makedirs(md)
    write_sense_voice_dir(md, conf=SV_SMALL)
    with open(os.path.join(md, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg.update(specaug="SpecAugLFR", specaug_conf=SV_SPECAUG)
    cfg["model_conf"].update(lsm_weight=0.1, length_normalized_loss=True, ignore_id=-1)
    with open(os.path.join(md, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    out = os.path.join(d, "exp")
    run = subprocess.run(
        [sys.executable, "-m", "funasr_tpu_torch.bin.train", f"++model={md}", "++device=cpu",
         "++dataset=SenseVoiceDataset", f"++train_data_set_list={jsonl}",
         f"++valid_data_set_list={jsonl}", "++dataset_conf.batch_size=300",
         "++dataset_conf.batch_type=token", "++optim_conf.lr=0.0002",
         "++train_conf.max_epoch=2", "++train_conf.log_interval=1",
         "++train_conf.avg_nbest_model=2", "++train_conf.use_tensorboard=False",
         f"++output_dir={out}"], env=env, cwd=d, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(line) for line in open(os.path.join(out, "train.log.jsonl"))]
    steps = [x for x in lines if "validate" not in x]
    assert steps and all(np.isfinite(x["loss"]) for x in steps)
    assert {"loss_ctc", "loss_rich", "acc_rich"} <= set(steps[0])
    assert sum("validate" in x for x in lines) == 2
    state = torch.load(os.path.join(out, "model.pt.ep1"), weights_only=True)
    assert state["metric_name"] == "loss"
    from funasr_tpu_torch import AutoModel
    am = AutoModel(model=out, init_param=os.path.join(out, "model.pt.avg"), device="cpu")
    res = am.generate(input=[str(root / "u1.wav")], language="zh")
    assert res[0]["key"] == "u1" and isinstance(res[0]["text"], str)


# ---------------------------------------------------------------------------
# which models train, and the import boundary
# ---------------------------------------------------------------------------

def test_only_streaming_and_the_llm_family_wait_for_their_loss():
    """No Paraformer class waits for its loss any more: ParaformerStreaming trains (a
    finite loss and a gradient under its overlap-chunk masks); since the LLM slice nothing
    waits: the LLM family's and Whisper's ``forward`` are their losses
    (``test_torch_train_llm.py`` holds them against JAX)."""
    from funasr_tpu_torch.models.fun_asr_nano.model import FunASRNano
    from funasr_tpu_torch.models.llm_asr.model import LLMASR
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    from funasr_tpu_torch.models.whisper.model import WhisperModel
    waiting = {name for name, cls in tables.model_classes.items()
               if isinstance(cls, type) and issubclass(cls, Paraformer)
               and getattr(cls, "TRAINING_WAITS_FOR", None)}
    assert waiting == set()
    stream = tables.model_classes["ParaformerStreaming"](
        input_size=80, vocab_size=V, encoder_conf=dict(ENC, chunk_size=[5], stride=[5],
                                                       pad_left=[0], encoder_att_look_back_factor=[0],
                                                       decoder_att_look_back_factor=[0]),
        decoder_conf=DEC, predictor_conf=dict(idim=32),
        generator=torch.Generator().manual_seed(0)).train()
    speech, slen, text, tlen = (torch.from_numpy(x) for x in asr_batch("Paraformer"))
    loss, stats, _ = stream(speech, slen, text.long(), tlen.long(),
                            generator=torch.Generator().manual_seed(1))
    loss.backward()
    assert torch.isfinite(loss) and set(stats) >= {"loss", "loss_att", "loss_pre", "acc"}
    assert stream.encoder.encoders[0].self_attn.linear_q_k_v.weight.grad.abs().max() > 0
    import inspect
    for cls in (FunASRNano, LLMASR, WhisperModel):
        args = list(inspect.signature(cls.forward).parameters)[1:5]
        assert args == ["speech", "speech_lengths", "text", "text_lengths"], cls
    assert callable(LLMASR.forward_batch)


NEW_MODULES = [
    "funasr_tpu_torch.datasets.specialized_datasets", "funasr_tpu_torch.ops.ctc_align",
    "funasr_tpu_torch.models.sense_voice.model", "funasr_tpu_torch.models.ctc.model",
    "funasr_tpu_torch.models.paraformer_v2.model", "funasr_tpu_torch.models.e_paraformer.model",
    "funasr_tpu_torch.models.bicif_paraformer.model",
    "funasr_tpu_torch.models.seaco_paraformer.model",
    "funasr_tpu_torch.models.contextual_paraformer.model",
    "funasr_tpu_torch.models.monotonic_aligner.model",
    "funasr_tpu_torch.models.ct_transformer.model",
    "funasr_tpu_torch.models.paraformer_streaming.model",
    "funasr_tpu_torch.models.scama.chunk_utils", "funasr_tpu_torch.models.scama.encoder",
    "funasr_tpu_torch.models.fun_asr_nano.model", "funasr_tpu_torch.models.whisper.model",
    "funasr_tpu_torch.train_utils.trainer", "funasr_tpu_torch.train_utils.average_nbest_models",
    "funasr_tpu_torch.bin.train"]


def test_new_modules_import_without_jax():
    code = ("import importlib, sys\n"
            "import funasr_tpu_torch\n"
            f"for m in {NEW_MODULES!r}:\n    importlib.import_module(m)\n"
            "from funasr_tpu_torch.register import tables\n"
            "assert 'SenseVoiceDataset' in tables.dataset_classes\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'funasr_tpu.'))"
            " or m == 'funasr_tpu']\n"
            "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
