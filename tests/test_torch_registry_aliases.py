"""Registry aliases of the PyTorch port against the JAX package's (``funasr_tpu/parity.py``).

Every (table, alias -> target) pair that the JAX package's ``register_parity_aliases``
binds, and whose target the port registers, must resolve in the port as in the JAX
package: to the target's class where the JAX package binds the alias to its target, and
never to the target where the JAX package has a class of that name of its own (the port
would otherwise build the target for a config that names another model): the port leaves
the name unbound, or registers a class of its own under it, as for the Whisper sizes. A ``config.yaml``
naming the export aliases then builds in the port's ``AutoModel`` and gives the JAX
``AutoModel``'s texts; so does one naming ``ContextualParaformerDecoderExport``.

``CifPredictor`` resolves to the V1 predictor. The JAX package also binds
``CifPredictorV2Export`` and ``CifPredictorV3Export`` to V1 (``cif_predictor.py:182-183``);
in FunASR those wrap V2 and V3, whose full (idim, idim, k) ``cif_conv1d`` does not fit V1's
depthwise weight, so the port leaves them unbound (ROADMAP section 3, shown on the JAX
side below).
"""

import os

import pytest
import yaml

import funasr_tpu  # noqa: F401  (fills the JAX tables)
from funasr_tpu import parity as jparity
from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import AutoModel, tables
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import write_asr_dir, write_contextual_dir

# the aliases of the JAX package's list whose targets the port has (ROADMAP section 3)
PORT_ALIASES = {"SANMEncoderExport", "FSMNExport", "FSMNConvert", "FSMNMT", "FSMNMTConvert",
                "ParaformerSANMDecoderExport", "ParaformerSANMDecoderOnlineExport",
                "ParaformerSANMDecoder_v2_community", "ContextualParaformerDecoderExport",
                "SANMEncoderChunkOptExport", "SANMVadEncoderExport", "FsmnDecoder"}


def _reference_pairs():
    """(table, alias, target) of every ``_alias`` call the JAX package makes."""
    pairs = []
    original = jparity._alias
    jparity._alias = lambda table, name, target: pairs.append((table, name, target))
    try:
        jparity.register_parity_aliases()
    finally:
        jparity._alias = original
    return pairs


PAIRS = [p for p in _reference_pairs() if p[2] in getattr(tables, p[0])]


def test_the_port_binds_the_eight_aliases():
    assert {name for _, name, _ in PAIRS} >= PORT_ALIASES
    for table, name, target in PAIRS:
        if name in PORT_ALIASES:
            assert getattr(tables, table)[name] is getattr(tables, table)[target]


@pytest.mark.parametrize("table,name,target", PAIRS, ids=[p[1] for p in PAIRS])
def test_alias_resolves_as_in_the_jax_package(table, name, target):
    jax_table, port_table = getattr(jtables, table), getattr(tables, table)
    if jax_table.get(name) is jax_table[target]:
        assert port_table[name] is port_table[target]
    else:  # the JAX package registers a class of that name (e.g. the SCAMA decoder):
        # the port leaves it unbound, or registers a class of that name too (e.g.
        # ``Whisper-large-v3``), never the alias's target
        assert port_table.get(name) is not port_table[target]


def test_streaming_encoder_aliases_bind_and_the_scama_decoder_stays_unbound():
    """The streaming encoders' export names resolve to the port's classes; the SCAMA
    decoder's names resolve to the port's ``FsmnDecoderSCAMAOpt``, as in the JAX package
    (``FsmnDecoder`` through the alias), never to the Paraformer decoder."""
    from funasr_tpu_torch.models.scama.decoder import FsmnDecoderSCAMAOpt

    enc, dec = tables.encoder_classes, tables.decoder_classes
    assert enc["SANMEncoderChunkOptExport"] is enc["SANMEncoderChunkOpt"]
    assert enc["SANMVadEncoderExport"] is enc["SANMVadEncoder"]
    assert dec["FsmnDecoderSCAMAOpt"] is FsmnDecoderSCAMAOpt
    assert dec["FsmnDecoder"] is FsmnDecoderSCAMAOpt
    assert jtables.decoder_classes["FsmnDecoder"] is jtables.decoder_classes[
        "FsmnDecoderSCAMAOpt"]
    assert dec["FsmnDecoderSCAMAOpt"] is not dec["ParaformerSANMDecoder"]


def test_config_naming_export_aliases_builds_and_matches_jax(tmp_path):
    d = write_asr_dir(tmp_path)
    with open(os.path.join(d, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg.update(encoder="SANMEncoderExport", decoder="ParaformerSANMDecoderExport")
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    kw = dict(model=d, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    assert type(port.model.encoder) is tables.encoder_classes["SANMEncoder"]
    assert type(port.model.decoder) is tables.decoder_classes["ParaformerSANMDecoder"]
    waves = [multi_segment_wav(3.0, seed=s) for s in (1, 2)]
    got = port.generate(input=waves, batch_size=2)
    want = ref.generate(input=waves, batch_size=2)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert all(r["text"] for r in got)


def _rewrite_config(d, **update):
    with open(os.path.join(d, "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg.update(update)
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)


def test_config_naming_the_contextual_export_decoder_builds_and_matches_jax(tmp_path):
    d = write_contextual_dir(tmp_path)
    _rewrite_config(d, decoder="ContextualParaformerDecoderExport")
    kw = dict(model=d, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    assert type(port.model.decoder) is tables.decoder_classes["ContextualParaformerDecoder"]
    waves = [multi_segment_wav(3.0, seed=s) for s in (1, 2)]
    got = port.generate(input=waves, batch_size=2, hotword="一二 三")
    want = ref.generate(input=waves, batch_size=2, hotword="一二 三")
    assert [r["text"] for r in got] == [r["text"] for r in want]


def test_cif_predictor_names():
    from funasr_tpu_torch.models.paraformer.cif_predictor import CifPredictorV1
    assert tables.predictor_classes["CifPredictor"] is CifPredictorV1
    assert jtables.predictor_classes["CifPredictor"].__name__ == "CifPredictorV1"
    for name in ("CifPredictorV2Export", "CifPredictorV3Export"):
        assert name not in tables.predictor_classes
        assert jtables.predictor_classes[name] is jtables.predictor_classes["CifPredictor"]


def test_jax_export_predictor_alias_cannot_hold_a_v2_checkpoint():
    """The suspected reference fault: a FunASR V2 checkpoint (full ``cif_conv1d``) under
    the name ``CifPredictorV2Export`` converts to a (k, idim, idim) conv, while the class
    the JAX package binds to that name holds a depthwise (k, idim) one."""
    import jax
    from funasr_tpu.convert.torch_to_jax import convert_paraformer
    from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    from torch_parity_util import SMALL_CONF

    v2 = Paraformer(**SMALL_CONF)  # FunASR's V2 layout: cif_conv1d (64, 64, 3)
    jm = JaxParaformer(**dict(SMALL_CONF, predictor="CifPredictorV2Export"))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    held = shapes["predictor"]["cif_conv1d"]["w"].shape
    loaded = convert_paraformer(v2.state_dict(), jm)["predictor"]["cif_conv1d"]["w"].shape
    assert held == (3, 64) and loaded == (3, 64, 64)


# the names of the SenseVoice / CTC-family slice, as hub configs spell them
SLICE_NAMES = [("model_classes", "SenseVoiceSmall"), ("encoder_classes", "SenseVoiceEncoderSmall"),
               ("model_classes", "CTC"), ("ctc_classes", "CTC"),
               ("model_classes", "ParaformerV2"), ("model_classes", "Paraformer_v2_community"),
               ("model_classes", "EParaformer"), ("predictor_classes", "PifPredictor"),
               ("model_classes", "MonotonicAligner"),
               ("tokenizer_classes", "SentencepiecesTokenizer")]


@pytest.mark.parametrize("table,name", SLICE_NAMES, ids=[f"{t}:{n}" for t, n in SLICE_NAMES])
def test_slice_names_resolve_as_in_the_jax_package(table, name):
    """Each name resolves in both packages to a class of the same name, and two names of
    one JAX class (Paraformer-v2's) to one port class."""
    port_cls, jax_cls = getattr(tables, table)[name], getattr(jtables, table)[name]
    assert port_cls.__name__ == jax_cls.__name__
    assert port_cls.__module__.replace("funasr_tpu_torch.", "funasr_tpu.") == jax_cls.__module__
    same = [n for t, n in SLICE_NAMES if t == table and getattr(jtables, t)[n] is jax_cls]
    assert all(getattr(tables, table)[n] is port_cls for n in same)


# the names of the keyword spotters', emotion2vec's, MFCCA's, SA-ASR's and Whisper-LID's
# slice, as hub configs and recipes spell them
SLICE22_NAMES = [("model_classes", n) for n in (
    "FsmnKWS", "SanmKWS", "FsmnKWSConvert", "FsmnKWSMT", "FsmnKWSMTConvert",
    "SanmKWSStreaming", "Emotion2vec", "MFCCA", "SAASR", "SAAsr", "LCBNetNAR",
    "OpenAIWhisperLIDModel", "WhisperLID")] + [
    ("encoder_classes", "MFCCAEncoder"), ("lid_predictor_classes", "LidPredictor"),
    ("dataset_classes", "KWSDataset"), ("dataset_classes", "KwsMTDataset")]


@pytest.mark.parametrize("table,name", SLICE22_NAMES,
                         ids=[f"{t}:{n}" for t, n in SLICE22_NAMES])
def test_slice22_names_resolve_as_in_the_jax_package(table, name):
    """Each name resolves in both packages to a class of the same module (the package
    prefix aside) and of the same name, the port's ``LCBNetNAR`` aside (the JAX package's
    class is ``LCBNet``, a name the port's AED LCB-Net holds); names of one JAX class
    resolve to one port class."""
    port_cls, jax_cls = getattr(tables, table)[name], getattr(jtables, table)[name]
    assert port_cls.__module__.replace("funasr_tpu_torch.", "funasr_tpu.") == jax_cls.__module__
    assert port_cls.__name__ == ("LCBNetNAR" if jax_cls.__name__ == "LCBNet" and
                                 name == "LCBNetNAR" else jax_cls.__name__)
    same = [n for t, n in SLICE22_NAMES if t == table and getattr(jtables, t)[n] is jax_cls]
    assert all(getattr(tables, table)[n] is port_cls for n in same)


# the names of the diarization, SSL-frontend and separation slice: 7 model, 2 encoder and
# 6 frontend names, as hub configs and recipes spell them
SLICE23_NAMES = [("model_classes", n) for n in (
    "EENDOLA", "DiarEENDOLA", "Data2VecPretrainModel", "Data2VecAudio", "data2vec",
    "MossFormer", "MossFormer2")] + [
    ("encoder_classes", "EENDOLATransformerEncoder"),
    ("encoder_classes", "Data2VecEncoder")] + [
    ("frontend_classes", n) for n in ("DefaultFrontend", "EspnetFrontend", "WavFrontendMel23",
                                      "S3prlFrontend", "FusedFrontends", "fused")]


@pytest.mark.parametrize("table,name", SLICE23_NAMES,
                         ids=[f"{t}:{n}" for t, n in SLICE23_NAMES])
def test_slice23_names_resolve_as_in_the_jax_package(table, name):
    """Each name resolves in both packages to a class of the same module (the package
    prefix aside) and of the same name; names of one JAX class resolve to one port
    class."""
    port_cls, jax_cls = getattr(tables, table)[name], getattr(jtables, table)[name]
    assert port_cls.__module__.replace("funasr_tpu_torch.", "funasr_tpu.") == jax_cls.__module__
    assert port_cls.__name__ == jax_cls.__name__
    same = [n for t, n in SLICE23_NAMES if t == table and getattr(jtables, t)[n] is jax_cls]
    assert all(getattr(tables, table)[n] is port_cls for n in same)


def test_the_first_table_read_imports_every_registering_module():
    """``import funasr_tpu_torch`` imports no model module; the first read of a table
    imports ``register.REGISTRABLE``, which must reach every module that registers a
    class (a fresh interpreter)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = ("import sys, funasr_tpu_torch\n"
            "assert not [m for m in sys.modules if m.startswith('funasr_tpu_torch.models')]\n"
            "funasr_tpu_torch.tables.model_classes['Paraformer']\n"
            "print(' '.join(m for m in sys.modules if m.startswith('funasr_tpu_torch.')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=repo, timeout=300)
    assert proc.returncode == 0, proc.stderr
    registering = {
        ".".join(path.relative_to(repo).with_suffix("").parts)
        for path in (repo / "funasr_tpu_torch").rglob("*.py")
        if "tables.register(" in path.read_text(encoding="utf-8")}
    assert registering and registering <= set(proc.stdout.split())
