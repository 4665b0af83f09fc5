"""The port's extra frontends against the JAX package's (CPU): ``DefaultFrontend`` /
``EspnetFrontend`` and ``WavFrontendMel23`` bit-equal (plain, LFR, a cmvn file, int16 PCM
through ``extract_fbank``, a wave whose length is a multiple of the hop), the
``extract(..., device=)`` form; ``S3prlFrontend`` over data2vec at a small width (a 2-layer
conv extractor, 2 layers of 16 x 2 heads) with the same weights in both packages (the
port's seeded init through ``convert_state_dict``, or an ``upstream_ckpt`` file both
read): features within 2e-4 of max |y| plain, with ``multilayer_feature`` and with
``tile_factor``; ``FusedFrontends`` over default plus S3PRL with the JAX init's
projections carried across: features within 2e-4, lengths equal. Without a device named
in ``extract`` the two compute on their own, the card unless the caller asks for the CPU;
``AutoModel`` hands them its device, so a model whose ``inference`` takes host numpy (CTC)
still runs the trunk there.
"""

import jax
import numpy as np
import pytest
import torch

import funasr_tpu  # noqa: F401 (fills the JAX tables)
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.default import DefaultFrontend as JaxDefault
from funasr_tpu.frontends.fused import FusedFrontends as JaxFused
from funasr_tpu.frontends.mel23 import WavFrontendMel23 as JaxMel23
from funasr_tpu.frontends.s3prl import S3prlFrontend as JaxS3prl
from funasr_tpu.register import tables as jtables
from funasr_tpu.utils.load_utils import extract_fbank as jax_extract_fbank
from funasr_tpu_torch import tables
from funasr_tpu_torch.utils.load_utils import extract_fbank
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)
from torch_parity_util import _write_config, _write_tokens, write_identity_cmvn

D2V_SMALL = dict(encoder_conf=dict(
    input_size=1, conv_feature_layers="[(16,10,5)] + [(16,3,2)]", encoder_layers=2,
    encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_attention_heads=2, conv_pos=4,
    conv_pos_groups=2, average_top_k_layers=2))
FEAT_TOL = 2e-4


def close(got, want, tol=FEAT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def waves(seed=0, lengths=(16000, 9600, 7203)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("name", ["DefaultFrontend", "EspnetFrontend"])
@pytest.mark.parametrize("conf", [
    dict(), dict(n_mels=40, lfr_m=7, lfr_n=6), dict(n_fft=400, win_length=400, hop_length=128,
                                                    n_mels=64, fmin=20.0, fmax=7600.0)],
    ids=["default", "lfr", "nfft400"])
def test_default_frontend_bit_equal(name, conf):
    fe, jfe = tables.frontend_classes[name](**conf), jtables.frontend_classes[name](**conf)
    wavs = waves()
    got, glens = fe.extract(wavs)
    want, wlens = jfe.extract(wavs)
    assert np.array_equal(got, want) and np.array_equal(glens, wlens)
    assert fe.output_size() == jfe.output_size() and fe.frame_shift_ms == jfe.frame_shift_ms
    for w in wavs:
        assert np.array_equal(fe(w), jfe(w))


def test_default_frontend_cmvn_and_int16(tmp_path):
    path = str(tmp_path / "am.mvn")
    write_identity_cmvn(path, 80 * 5)
    with open(path) as f:  # a non-trivial shift and scale
        text = f.read().replace("[ 0.0 0.0", "[ 0.5 -1.25", 1)
    text = text.replace("[ 1.0 1.0", "[ 2.0 0.75", 1)
    with open(path, "w") as f:
        f.write(text)
    conf = dict(lfr_m=5, lfr_n=3, cmvn_file=path)
    fe, jfe = tables.frontend_classes["DefaultFrontend"](**conf), JaxDefault(**conf)
    assert fe.cmvn[0][0] == 0.5 and fe.cmvn[1][1] == 0.75
    pcm = [np.asarray(w * 32767, np.int16) for w in waves(1)]
    got, glens = extract_fbank(pcm, frontend=fe)
    want, wlens = jax_extract_fbank(pcm, frontend=jfe)
    assert np.array_equal(got, want) and np.array_equal(glens, wlens)
    feats, lens = fe.extract(pcm, device="cpu")
    assert torch.is_tensor(feats) and np.array_equal(feats.numpy(), want)
    assert np.array_equal(lens.numpy(), wlens)


@pytest.mark.parametrize("conf", [
    dict(fs=8000, frame_length=200, frame_shift=80, lfr_m=7, lfr_n=10),
    dict(fs=8000, frame_length_samples=256, frame_shift_samples=64, lfr_m=3, lfr_n=5)],
    ids=["eend", "samples"])
def test_mel23_bit_equal(conf):
    fe, jfe = tables.frontend_classes["WavFrontendMel23"](**conf), JaxMel23(**conf)
    wavs = waves(2, lengths=(48000, 32000, 8000 * 3 + 17))  # 32000: a multiple of the hop
    got, glens = fe.extract(wavs)
    want, wlens = jfe.extract(wavs)
    assert got.shape[-1] == fe.output_size() == jfe.output_size()
    assert np.array_equal(got, want) and np.array_equal(glens, wlens)
    pcm = [np.asarray(w * 32767, np.int16) for w in wavs]
    got, _ = extract_fbank(pcm, frontend=fe, device="cpu")
    assert np.array_equal(got.numpy(), jax_extract_fbank(pcm, frontend=jfe)[0])
    got, _ = fe.forward(np.stack([wavs[1], wavs[1]]), [32000, 20000])
    assert np.array_equal(got, jfe.forward(np.stack([wavs[1], wavs[1]]), [32000, 20000])[0])


def s3prl_pair(tmp_path=None, **kw):
    """(port S3prlFrontend, JAX S3prlFrontend) over the same data2vec weights."""
    conf = dict(upstream="data2vec", upstream_conf=D2V_SMALL, seed=3, **kw.pop("conf", {}))
    fe = tables.frontend_classes["S3prlFrontend"](frontend_conf=conf, device="cpu", **kw)
    if tmp_path is not None:  # both read a FunASR-layout checkpoint file
        path = str(tmp_path / "upstream.pt")
        torch.save(fe.upstream.state_dict(), path)
        conf = dict(conf, upstream_ckpt=path)
        fe = tables.frontend_classes["S3prlFrontend"](frontend_conf=conf, device="cpu", **kw)
        return fe, JaxS3prl(frontend_conf=conf, **kw)
    jfe = JaxS3prl(frontend_conf=conf, **kw)
    jfe.params = convert_state_dict(fe.upstream.state_dict(), jfe.upstream,
                                    "Data2VecPretrainModel")
    return fe, jfe


@pytest.mark.parametrize("kw", [dict(), dict(multilayer_feature=True),
                                dict(conf=dict(tile_factor=2))],
                         ids=["plain", "multilayer", "tile2"])
def test_s3prl_features_match_jax(kw):
    fe, jfe = s3prl_pair(**kw)
    wavs = waves(3, lengths=(4000, 3000))
    got, glens = fe.extract(wavs)
    want, wlens = jfe.extract(wavs)
    assert np.array_equal(glens, wlens)
    for i, n in enumerate(wlens):
        close(got[i, :n], want[i, :n])
    assert fe.output_size() == jfe.output_size() == 16
    assert (fe.frame_shift_ms, fe.lfr_n) == (20, 1)


def test_s3prl_upstream_ckpt_and_device_form(tmp_path):
    fe, jfe = s3prl_pair(tmp_path)
    wavs = waves(4, lengths=(5000, 2600))
    want, wlens = jfe.extract(wavs)
    feats, lens = fe.extract(wavs, device="cpu")
    assert torch.is_tensor(feats) and np.array_equal(lens.numpy(), wlens)
    for i, n in enumerate(wlens):
        close(feats[i, :n].numpy(), want[i, :n])


def test_fused_default_plus_s3prl_match_jax():
    subs = [dict(frontend_type="default", n_mels=40, hop_length=160, win_length=400,
                 n_fft=512),
            dict(frontend_type="S3prlFrontend", hop_length=320,
                 frontend_conf=dict(upstream="data2vec", upstream_conf=D2V_SMALL, seed=5))]
    fe = tables.frontend_classes["FusedFrontends"](frontends=subs, proj_dim=8, fs=16000,
                                                   device="cpu")
    jfe = JaxFused(frontends=subs, proj_dim=8, fs=16000)
    assert fe.factors == jfe.factors == [1, 2] and fe.output_size() == jfe.output_size()
    jfe.frontends[1].params = convert_state_dict(fe.frontends[1].upstream.state_dict(),
                                                 jfe.frontends[1].upstream,
                                                 "Data2VecPretrainModel")
    params = jax.tree_util.tree_map(np.asarray, jfe.init(jax.random.PRNGKey(0)))
    fe.load_state_dict({f"projections.{i}.{k}": torch.from_numpy(np.array(
        p["w"].T if k == "weight" else p["b"])) for i, p in enumerate(params["projections"])
        for k in ("weight", "bias")})
    wavs = waves(5, lengths=(8000, 6400))
    got, glens = fe.extract(wavs)
    want, wlens = jfe.extract(wavs, params=params)
    assert np.array_equal(glens, wlens)
    close(got, want)
    feats, _ = tables.frontend_classes["fused"](frontends=subs[:1], proj_dim=8).extract(
        wavs, device="cpu")
    assert torch.is_tensor(feats) and feats.shape[-1] == 8


def test_s3prl_and_fused_default_to_the_card():
    conf = dict(upstream="data2vec", upstream_conf=D2V_SMALL)
    assert tables.frontend_classes["S3prlFrontend"](frontend_conf=conf).device.type == "cuda"
    subs = [dict(frontend_type="S3prlFrontend", frontend_conf=conf)]
    assert tables.frontend_classes["FusedFrontends"](frontends=subs).device.type == "cuda"


@pytest.mark.parametrize("frontend", ["S3prlFrontend", "FusedFrontends"])
def test_automodel_runs_the_frontend_on_its_device(tmp_path, frontend):
    """CTC's ``inference`` calls ``extract_fbank`` with no device and takes host numpy:
    the trunk still runs on the model's device, which ``AutoModel`` hands the frontend."""
    from funasr_tpu_torch import AutoModel

    s3prl = dict(fs=16000, frontend_conf=dict(upstream="data2vec", upstream_conf=D2V_SMALL,
                                              seed=3))
    fe_conf = (s3prl if frontend == "S3prlFrontend" else dict(
        proj_dim=8, frontends=[dict(frontend_type="S3prlFrontend", hop_length=320,
                                    frontend_conf=s3prl["frontend_conf"])]))
    tokens = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(12)] + ["<unk>"]
    enc = dict(output_size=16, attention_heads=2, linear_units=32, num_blocks=1)
    model = tables.model_classes["CTC"](input_size=16 if frontend == "S3prlFrontend" else 8,
                                        vocab_size=len(tokens), encoder_conf=enc,
                                        generator=torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    _write_tokens(str(tmp_path), tokens)
    _write_config(str(tmp_path), dict(
        model="CTC", encoder="SANMEncoder", encoder_conf=enc, frontend=frontend,
        frontend_conf=fe_conf, tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
    am = AutoModel(model=str(tmp_path), device="cpu", log_level="WARNING")
    fe = am.kwargs["frontend"]
    assert fe.device == torch.device("cpu")
    trunk = fe if frontend == "S3prlFrontend" else fe.frontends[0]
    seen = []
    inner = trunk.upstream.extract_features
    trunk.upstream.extract_features = lambda wav, lens: seen.append(wav.device) or inner(
        wav, lens)
    res = am.generate(input=waves(8, lengths=(6000,)))
    assert seen == [torch.device("cpu")] and len(res) == 1 and "text" in res[0]
