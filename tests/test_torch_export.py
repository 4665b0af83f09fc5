"""``AutoModel.export`` / ``bin/export.py`` and ``export_runtime.ExportedModel`` of the
PyTorch port, and the kernels' custom ops, on the CPU.

* ``torch.library.opcheck`` of ``funasr_tpu_torch::{flash_attention, fsmn_memory,
  w8a8_linear}`` on CPU tensors, every mode of their schemas;
* the exported graph of a small Paraformer holds one custom-op node a kernel call of the
  eager decode: ``num_blocks`` flash, encoder + decoder FSMN blocks, and under
  ``quant="w8a8"`` one W8A8 node a quantized linear;
* the loaded program's ids and lengths equal eager ``infer_core``'s exactly (fp32, bf16,
  W8A8), its score within 1e-6; the ids equal the JAX package's exported program's on
  the same weights (``tests/test_export_runtime_mcp.py::test_exported_model_roundtrip``);
* ``AutoModel.export`` then ``ExportedModel.transcribe`` equals ``generate``, in a
  process that imports no model module; the weights are written once, in ``params.pt``;
* the export CLI, and every module this slice adds importing neither jax nor
  ``funasr_tpu``.
"""

import json
import os
import subprocess
import sys
import zipfile
from collections import Counter
from pathlib import Path

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.bin.export import export_model as jax_export_model
from funasr_tpu.export_runtime import ExportedModel as JaxExportedModel
from funasr_tpu.export_runtime import save_params_npz as jax_save_params_npz
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.bin.export import export_model
from funasr_tpu_torch.core.module import cast_floats
from funasr_tpu_torch.export_runtime import ExportedModel, bind_weights
from funasr_tpu_torch.models.paraformer.model import Paraformer
from funasr_tpu_torch.ops import flash_attention as fa
from funasr_tpu_torch.ops import fsmn, w8a8
from funasr_tpu_torch.ops.quant import quantize_params_int8
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import NUMBER_TOKENS, PIPE_ASR_CONF, build_pair, write_asr_dir
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
OPS = {"flash_attention": "funasr_tpu_torch.flash_attention.default",
       "fsmn_memory": "funasr_tpu_torch.fsmn_memory.default",
       "w8a8_linear": "funasr_tpu_torch.w8a8_linear.default"}
D256_CONF = dict(PIPE_ASR_CONF, encoder_conf=dict(PIPE_ASR_CONF["encoder_conf"],
                                                  output_size=256, linear_units=256),
                 decoder_conf=dict(PIPE_ASR_CONF["decoder_conf"], linear_units=256),
                 predictor_conf=dict(PIPE_ASR_CONF["predictor_conf"], idim=256))


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _opcheck_cases():
    g = _g()
    q, k, v = (torch.randn(2, 4, t, 16, generator=g) for t in (24, 30, 30))
    lens = torch.tensor([30, 17], dtype=torch.int32)
    x = torch.randn(2, 24, 32, generator=g)
    mask = torch.rand(2, 24, generator=g) > 0.3
    xw = torch.randn(3, 5, 48, generator=g)
    wq = torch.randint(-127, 128, (40, 48), dtype=torch.int8, generator=g)
    scale, bias = torch.rand(40, generator=g), torch.randn(40, generator=g)
    bf = torch.bfloat16
    return [
        pytest.param(fa.flash_attention_op, (q, k, v, lens, "none", None), id="flash-none"),
        pytest.param(fa.flash_attention_op, (q, k, v, lens, "causal", None), id="flash-causal"),
        pytest.param(fa.flash_attention_op, (q, k, v, lens, "corner", torch.tensor([5, 9])),
                     id="flash-corner"),
        pytest.param(fa.flash_attention_op, (q.to(bf), k.to(bf), v.to(bf), lens, "none", None),
                     id="flash-bf16"),
        pytest.param(fsmn.fsmn_memory_op, (x, torch.randn(32, 1, 11, generator=g), mask, 5, 5,
                                           False), id="fsmn-mask"),
        pytest.param(fsmn.fsmn_memory_op, (x, torch.randn(32, 1, 11, generator=g), None, 10, 0,
                                           True), id="fsmn-causal-generic"),
        pytest.param(fsmn.fsmn_memory_op, (x.to(bf), torch.randn(32, 1, 21, generator=g).to(bf),
                                           mask, 10, 10, False), id="fsmn-bf16-k21"),
        pytest.param(w8a8.w8a8_linear_op, (xw, wq, scale, bias), id="w8a8-bias"),
        pytest.param(w8a8.w8a8_linear_op, (xw.to(bf), wq, scale, None), id="w8a8-bf16"),
        pytest.param(w8a8.w8a8_linear_op, (xw.to(bf), wq, scale, bias.to(bf)),
                     id="w8a8-bf16-bias"),
    ]


@pytest.mark.parametrize("op,args", _opcheck_cases())
def test_opcheck(op, args):
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("op,args", _opcheck_cases())
def test_opcheck_on_card(op, args):
    """The same cases on CUDA tensors: the ops' CUDA implementations launch the kernels
    (each launch counted) and agree with their fake implementations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
    wrapper = {fa.flash_attention_op: fa.flash_attention, fsmn.fsmn_memory_op: fsmn.fsmn_memory,
               w8a8.w8a8_linear_op: w8a8.w8a8_linear}[op]
    before = wrapper.launches
    torch.library.opcheck(op, args)
    assert wrapper.launches > before


def test_eager_wrappers_do_not_go_through_the_ops(monkeypatch):
    """Eager calls take the wrapper's direct path (the op's dispatch costs host time on
    the card); only a trace records the op."""
    called = []
    for module, name in ((fa, "flash_attention_op"), (fsmn, "fsmn_memory_op"),
                         (w8a8, "w8a8_linear_op")):
        monkeypatch.setattr(module, name, lambda *a, _n=name: called.append(_n))
    g = _g()
    q = torch.randn(1, 2, 8, 8, generator=g)
    fa.flash_attention(q, q, q, torch.tensor([8]))
    fsmn.fsmn_memory(torch.randn(1, 8, 4, generator=g), torch.randn(4, 1, 3, generator=g),
                     None, 1, 1)
    w8a8.w8a8_linear(q[0, 0], torch.ones(3, 8, dtype=torch.int8), torch.ones(3))
    assert not called


def _model(conf=PIPE_ASR_CONF, quant=None, bf16=False, seed=0):
    model = Paraformer(**conf, generator=_g(seed)).eval()
    if bf16:
        model = cast_floats(model, torch.bfloat16)
    if quant:
        quantize_params_int8(model, mode=quant)
    return model


def _eager_calls(model, speech, lengths, max_tokens):
    """How often each kernel's plain version runs in one eager decode on the CPU."""
    counts = Counter()
    refs = [(fa, "flash_attention_ref"), (fsmn, "fsmn_memory_ref"), (w8a8, "w8a8_linear_ref")]
    saved = [getattr(m, n) for m, n in refs]
    for (m, n), fn in zip(refs, saved):
        setattr(m, n, lambda *a, _fn=fn, _n=n, **kw: counts.update([_n[:-4]]) or _fn(*a, **kw))
    try:
        with torch.inference_mode():
            out = model.infer_core(speech.to(model.dtype), lengths, max_tokens)[:3]
    finally:
        for (m, n), fn in zip(refs, saved):
            setattr(m, n, fn)
    return counts, out


def _inputs(b, t, seed=3):
    rng = np.random.default_rng(seed)
    speech = torch.from_numpy(rng.standard_normal((b, t, 560)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(t // 2, t + 1, b).astype(np.int32))
    lengths[0] = t
    return speech, lengths


SETTINGS = {"fp32": dict(), "bf16": dict(bf16=True), "w8a8": dict(conf=D256_CONF, quant="w8a8")}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each setting's model, exported at buckets (2, 64) and (3, 96)."""
    out = {}
    for name, kw in SETTINGS.items():
        model = _model(**kw)
        d = str(tmp_path_factory.mktemp(f"export_{name}"))
        export_model(model, d, [(2, 64), (3, 96)])
        out[name] = (model, d)
    return out


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_graph_holds_one_op_a_kernel_call(exported, setting):
    model, d = exported[setting]
    speech, lengths = _inputs(3, 96)
    want, _ = _eager_calls(model, speech, lengths, model._max_tokens_for(96))
    program = torch.export.load(os.path.join(d, "model_b3_t96.pt2"))
    nodes = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    got = {name: nodes[target] for name, target in OPS.items()}
    enc, dec = model.encoder.cfg.num_blocks, model.decoder.cfg.num_blocks
    assert got["flash_attention"] == enc == want["flash_attention"]
    assert got["fsmn_memory"] == enc + dec == want["fsmn_memory"]
    assert got["w8a8_linear"] == want["w8a8_linear"]
    assert (got["w8a8_linear"] > 0) == (setting == "w8a8")


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("bucket", [(2, 64), (3, 96)])
def test_program_equals_eager_infer_core(exported, setting, bucket):
    model, d = exported[setting]
    em = ExportedModel(d, device="cpu")
    speech, lengths = _inputs(*bucket, seed=bucket[1])
    yseq, token_lens, score = em(speech, lengths)
    _, (want_y, want_l, want_s) = _eager_calls(model, speech, lengths,
                                              model._max_tokens_for(bucket[1]))
    assert torch.equal(yseq, want_y) and torch.equal(token_lens, want_l)
    assert token_lens.sum() > 0
    np.testing.assert_allclose(score.float().numpy(), want_s.float().numpy(), rtol=0, atol=1e-6)


def _assert_nodes(graph):
    return sum(n.target is torch.ops.aten._assert_tensor_metadata.default for n in graph.nodes)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_bound_call_equals_module_call(exported, setting):
    """``bind_weights`` runs the graph over the weights bound once, its dtype asserts
    dropped: the same outputs as ``program.module()``, which flattens and checks the
    weights and runs the asserts on every call."""
    _, d = exported[setting]
    em = ExportedModel(d, device="cpu")
    path = os.path.join(d, "model_b3_t96.pt2")
    unbound = torch.export.load(path)
    assert _assert_nodes(unbound.graph) > 0
    speech, lengths = _inputs(3, 96, seed=7)
    with torch.inference_mode():
        want = unbound.module()(em.params, speech, lengths)
    got = em(speech, lengths)
    assert all(torch.equal(x, y) for x, y in zip(got, want)) and len(got) == 3
    program = torch.export.load(path)
    bind_weights(program, em.params)
    assert _assert_nodes(program.graph) == 0


def test_bound_call_checks_its_inputs(exported):
    """The weights are checked once against the program's placeholders, the features and
    lengths on every call."""
    _, d = exported["fp32"]
    em = ExportedModel(d, device="cpu")
    speech, lengths = _inputs(2, 64)
    for bad in ((speech.double(), lengths), (speech, lengths.long()),
                (speech[..., :100], lengths), (speech, lengths[:1])):
        with pytest.raises(ValueError, match="the program takes"):
            em(*bad)
    path = os.path.join(d, "model_b2_t64.pt2")
    name = next(iter(em.params))
    wrong = dict(em.params, **{name: em.params[name][..., :1]})
    with pytest.raises(ValueError, match="the program was traced with"):
        bind_weights(torch.export.load(path), wrong)
    with pytest.raises(ValueError, match="does not hold the weights"):
        bind_weights(torch.export.load(path), {k: v for k, v in em.params.items()
                                               if k != name})


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_kernel_shapes_record_every_launch(exported, setting):
    """``chip_smoke.KernelShapes`` records each kernel op call of a program by the shape it
    launches at, with its lengths and mask: flash over the encoder's (B, H, T, D) with the
    call's lengths, FSMN at the encoder's (B, T, C) and the decoder's (B, max_tokens, C),
    W8A8 at (M, K, N); the recorded calls are the graph's op nodes, each once."""
    model, d = exported[setting]
    em = ExportedModel(d, device="cpu")
    speech, lengths = _inputs(3, 96, seed=9)
    with chip_smoke.KernelShapes() as shapes:
        em(speech, lengths)
    program = torch.export.load(os.path.join(d, "model_b3_t96.pt2"))
    nodes = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    by_kernel = Counter()
    for key, n in shapes.seen.items():
        by_kernel[key[0]] += n
    assert by_kernel == {name: nodes[t] for name, t in OPS.items() if nodes[t]}
    enc, dec = model.encoder.cfg.num_blocks, model.decoder.cfg.num_blocks
    c, dtype = model.encoder.cfg.output_size, torch.bfloat16 if setting == "bf16" else torch.float32
    flash = [k for k in shapes.seen if k[0] == "flash_attention"]
    assert len(flash) == 1 and flash[0][1:3] == (dtype, (3, 4, 96, c // 4))
    assert torch.equal(shapes.inputs[flash[0]]["lengths"], lengths)
    assert chip_smoke.export_label(flash[0]) == f"3x4x96x{c // 4}_{str(dtype)[6:]}"
    fsmn_keys = {k[2]: shapes.seen[k] for k in shapes.seen if k[0] == "fsmn_memory"}
    assert fsmn_keys == {(3, 96, c): enc, (3, model._max_tokens_for(96), c): dec}
    w8a8_keys = [k for k in shapes.seen if k[0] == "w8a8_linear"]
    assert bool(w8a8_keys) == (setting == "w8a8")
    assert {k[1][0] for k in w8a8_keys} <= {3 * 96, 3 * model._max_tokens_for(96)}
    assert all(k[1][3] == torch.float32 for k in w8a8_keys)


def test_strided_randn_keeps_the_program_layout():
    """A row's inputs are laid out as the program's: a head view of a fused projection."""
    qkv = torch.zeros(2, 8, 3, 4, 16)
    q = qkv[:, :, 0].transpose(1, 2)
    x = chip_smoke.strided_randn(tuple(q.shape), q.stride(), torch.float32,
                                 torch.Generator().manual_seed(0), torch.device("cpu"))
    assert x.shape == q.shape and x.stride() == q.stride() and torch.isfinite(x).all()


def test_transcribe_text_rule_differs_from_jax():
    """``ExportedModel.transcribe`` builds text as the port's eager decode (``generate``)
    does, with ``sentence_postprocess``: ``<unk>`` dropped, BPE pieces joined. The JAX
    package's runtime joins the raw tokens. Same ids, same export directory, other text."""
    from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
    from funasr_tpu_torch.frontends.wav_frontend import WavFrontend

    tokens = ["<blank>", "<s>", "</s>", "\u2581he", "llo", "<unk>", "\u2581wor", "ld", "c@@",
              "at"]
    yseq = np.array([[1, 3, 4, 5, 6, 7, 8, 9, 2]], np.int32)
    lens, score = np.array([9], np.int32), np.zeros(1, np.float32)
    fconf = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
    port = ExportedModel.__new__(ExportedModel)
    port.device, port.tokens, port.frontend = torch.device("cpu"), tokens, WavFrontend(**fconf)
    port.functions = [dict(batch=1, frames=64, input_dim=560, call=lambda sp, ln: (
        torch.from_numpy(yseq), torch.from_numpy(lens), torch.from_numpy(score)))]
    jax_rt = JaxExportedModel.__new__(JaxExportedModel)
    jax_rt.tokens, jax_rt.params, jax_rt.frontend = tokens, {}, JaxWavFrontend(**fconf)
    jax_rt.functions = [dict(batch=1, frames=64, call=lambda p, sp, ln: (yseq, lens, score))]
    wave = multi_segment_wav(2.0)
    assert port.transcribe([wave]) == ["\u2581hello \u2581world cat"]
    assert jax_rt.transcribe([wave]) == ["\u2581hello<unk>\u2581worldc@@at"]


def test_program_ids_equal_jax_exported_program(tmp_path):
    """The same weights through the JAX package's exported StableHLO program."""
    pt, jm, jparams = build_pair()
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    export_model(pt, d_port, [(2, 24)])
    jax_export_model(jm, jparams, d_jax, buckets=[(2, 24)])
    jax_save_params_npz(jparams, os.path.join(d_jax, "params.npz"))
    speech, _ = _inputs(2, 24, seed=5)
    lengths = torch.tensor([24, 20], dtype=torch.int32)
    y, n, _ = ExportedModel(d_port, device="cpu")(speech, lengths)
    jm_run = JaxExportedModel(d_jax)
    jy, jn, _ = jm_run.functions[0]["call"](jm_run.params, jnp.asarray(speech.numpy()),
                                            jnp.asarray(lengths.numpy()))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def test_weights_are_written_once(exported):
    """``params.pt`` holds every weight; the programs hold none, and no example inputs."""
    model, d = exported["fp32"]
    files = sorted(os.listdir(d))
    assert files == ["export_manifest.json", "model_b2_t64.pt2", "model_b3_t96.pt2",
                     "params.pt"]
    params = torch.load(os.path.join(d, "params.pt"), weights_only=True)
    sd = model.state_dict()
    assert list(params) == list(sd) and all(torch.equal(params[k], sd[k]) for k in sd)
    for f in files:
        if f.endswith(".pt2"):
            program = torch.export.load(os.path.join(d, f))
            assert not program.state_dict and not program.constants
            with zipfile.ZipFile(os.path.join(d, f)) as z:  # example inputs hold weights
                assert sum(i.file_size for i in z.infolist() if "sample_inputs" in i.filename
                           ) == 0
    with open(os.path.join(d, "export_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "torch.export" and manifest["device"] == "cpu"
    assert [(e["batch"], e["frames"], e["input_dim"], e["max_tokens"])
            for e in manifest["functions"]] == [(2, 64, 560, 48), (3, 96, 560, 64)]
    with pytest.raises(ValueError, match="exported on cpu"):
        ExportedModel(d, device="cuda")


@pytest.fixture(scope="module")
def asr_dir(tmp_path_factory):
    return write_asr_dir(tmp_path_factory.mktemp("asr"), tokens=NUMBER_TOKENS)


def _waves():
    """6 s and 4 s: the eager decode pads them to (2, 128), the bucket exported."""
    return [multi_segment_wav(6.0), multi_segment_wav(4.0, seed=3)]


TRANSCRIBE = """
import json, sys
from funasr_tpu_torch.export_runtime import ExportedModel
from pipeline_parity_util import multi_segment_wav
waves = [multi_segment_wav(6.0), multi_segment_wav(4.0, seed=3)]
texts = ExportedModel(sys.argv[1], device="cpu").transcribe(waves)
bad = sorted(m for m in sys.modules if m.startswith("funasr_tpu_torch.models")
             or m.split(".")[0] in ("jax", "funasr_tpu"))
print(json.dumps({"texts": texts, "bad": bad}))
"""


@pytest.mark.parametrize("kw", [dict(), dict(quant="w8a8"), dict(bf16=True)])
def test_automodel_export_transcribes_as_generate(asr_dir, tmp_path, kw):
    """``AutoModel.export`` at the bucket the eager decode pads these inputs to, then
    ``ExportedModel.transcribe`` in a fresh process that imports no model module."""
    am = AutoModel(model=asr_dir, device="cpu", log_level="WARNING", **kw)
    out = str(tmp_path / "exported")
    am.export(output_dir=out, buckets=[(1, 128), (2, 128)])
    assert sorted(os.listdir(out)) == ["am.mvn", "config.yaml", "export_manifest.json",
                                       "model_b1_t128.pt2", "model_b2_t128.pt2", "params.pt",
                                       "tokens.txt"]
    want = [r["text"] for r in am.generate(input=_waves(), batch_size=2)]
    assert all(want)
    assert ExportedModel(out, device="cpu").transcribe(_waves()) == want
    proc = subprocess.run([sys.executable, "-c", TRANSCRIBE, out], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": f"{REPO}:{REPO / 'tests'}"})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"texts": want, "bad": []}


def test_export_cli(asr_dir, tmp_path):
    out = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "funasr_tpu_torch.bin.export", f"++model={asr_dir}",
         "++device=cpu", f"++output_dir={out}", "++buckets=[(2,128)]"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    am = AutoModel(model=asr_dir, device="cpu", log_level="WARNING")
    assert ExportedModel(out, device="cpu").transcribe(_waves()) == \
        [r["text"] for r in am.generate(input=_waves(), batch_size=2)]


NEW_MODULES = ["funasr_tpu_torch.text." + m for m in (
    "zh_numbers", "en_numbers", "multilingual", "multilingual_classes", "electronic",
    "multilingual_tn", "zh_en_tn", "inverse_normalize", "export_grammar")] + [
    "funasr_tpu_torch.bin.export", "funasr_tpu_torch.bin.mcp_server",
    "funasr_tpu_torch.export_runtime", "funasr_tpu_torch.runtime_bins",
    "funasr_tpu_torch.metrics.compute_eer", "funasr_tpu_torch.utils.datadir_writer",
    "funasr_tpu_torch.utils.version_checker", "funasr_tpu_torch.integrations.langchain_tool"]


def test_new_modules_pull_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "from funasr_tpu_torch import tables\n"
            "assert 'Paraformer' in tables.model_classes\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'funasr_tpu', 'sklearn'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
