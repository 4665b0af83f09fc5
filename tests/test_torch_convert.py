"""Package boundary and weight layout of the PyTorch port.

* ``import funasr_tpu_torch`` pulls in neither jax nor the JAX package (checked in a
  subprocess: this process already imported jax in ``conftest.py``);
* the port's state dict -> ``convert_paraformer`` -> ``params_from_jax`` gives back the
  same tensors exactly, and JAX-initialised params load into the port and run to the
  same encoder output (2e-4, fp32).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_paraformer
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.module import cast_floats
from torch_parity_util import SMALL_CONF, build_pair, t

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import funasr_tpu_torch\n"
        "from funasr_tpu_torch import convert, tables\n"
        "from funasr_tpu_torch.ops import flash_attention, fsmn\n"
        "assert 'Paraformer' in tables.model_classes\n"
        "assert {'FunASRNano', 'LLMASR', 'QwenAudio', 'whisper-tiny', 'Whisper-large-v3'} \\\n"
        "    <= set(tables.model_classes)\n"
        "assert {'Transformer', 'SANM', 'Conformer', 'Branchformer', 'EBranchformer',\n"
        "        'GLMASR', 'TransformerLM', 'SeqRNNLM'} <= set(tables.model_classes)\n"
        "assert {'LightweightConvolutionTransformerDecoder', 'TransformerDecoder',\n"
        "        'RNNTDecoder', 'rnnt_decoder'} <= set(tables.decoder_classes)\n"
        "assert {'Transducer', 'BAT', 'RWKVBAT', 'ConformerRWKV'} <= set(tables.model_classes)\n"
        "assert {'ChunkConformerEncoder', 'RWKVEncoder'} <= set(tables.encoder_classes)\n"
        "import funasr_tpu_torch.ops.rnnt_loss\n"
        "import funasr_tpu_torch.models.transformer.search\n"
        "import funasr_tpu_torch.models.transformer.hotword_scorer\n"
        "assert {'FsmnKWS', 'SanmKWS', 'FsmnKWSMT', 'SanmKWSStreaming', 'Emotion2vec',\n"
        "        'MFCCA', 'SAASR', 'LCBNetNAR', 'WhisperLID'} <= set(tables.model_classes)\n"
        "assert 'LidPredictor' in tables.lid_predictor_classes\n"
        "import funasr_tpu_torch.utils.kws_utils\n"
        "import funasr_tpu_torch.models.mfcca.encoder\n"
        "assert {'EENDOLA', 'DiarEENDOLA', 'Data2VecPretrainModel', 'Data2VecAudio',\n"
        "        'data2vec', 'MossFormer', 'MossFormer2'} <= set(tables.model_classes)\n"
        "assert {'EENDOLATransformerEncoder', 'Data2VecEncoder'} \\\n"
        "    <= set(tables.encoder_classes)\n"
        "assert {'DefaultFrontend', 'EspnetFrontend', 'WavFrontendMel23', 'S3prlFrontend',\n"
        "        'FusedFrontends', 'fused'} <= set(tables.frontend_classes)\n"
        "from funasr_tpu_torch.frontends import default, fused, mel23, s3prl\n"
        "from funasr_tpu_torch.models.data2vec import model as d2v\n"
        "from funasr_tpu_torch.models.eend import model as eend\n"
        "from funasr_tpu_torch.models.mossformer import model as moss\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'funasr_tpu' or m.startswith('funasr_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_state_dict_round_trip_is_exact():
    pt, jm, _ = build_pair(seed=5)
    sd = pt.state_dict()
    np_params = convert_paraformer(sd, jm)
    back = params_from_jax(np_params, pt)
    assert set(back) == set(sd)
    for name, tensor in sd.items():
        assert torch.equal(back[name], tensor), name


def test_jax_init_params_load_and_run_alike(rng):
    pt, jm, _ = build_pair(seed=1)
    jparams = jm.init_params(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    pt.load_state_dict(params_from_jax(np_params, pt))
    x = rng.standard_normal((2, 40, 560)).astype(np.float32)
    lens = np.asarray([40, 23], np.int32)
    with torch.inference_mode():
        got, _ = pt.encode(t(x), t(lens))
    want, _ = jm.encode(jparams, jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_params_from_jax_rejects_a_foreign_tree():
    pt, jm, _ = build_pair(seed=2)
    np_params = convert_paraformer(pt.state_dict(), jm)
    del np_params["decoder"]["after_norm"]
    with pytest.raises(KeyError, match="after_norm"):
        params_from_jax(np_params, pt)


def test_cast_floats_casts_every_weight():
    from funasr_tpu_torch.models.paraformer.model import Paraformer
    model = cast_floats(Paraformer(**SMALL_CONF), torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
