"""The transducer family's user paths on the CPU: ``AutoModel.generate`` texts of a
Transducer (chunk Conformer) and a BAT (RWKV) dir equal to the JAX ``AutoModel``'s, and two
``bin/train`` steps of a tiny transducer (``finetune.sh``'s flags) and of a tiny AISHELL
Conformer recipe (stage 1's ``compute_cmvn``, stage 4's ``bin/train``, stage 5's
``bin/benchmark ++mode=cer``). The models' parity is in ``test_torch_transducer.py``.
"""

import os

import numpy as np
import pytest
import yaml

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu_torch import AutoModel
from test_torch_transducer import TOKENS, V, write_transducer_dir
from torch_parity_util import _write_config
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,model", [("chunk", "Transducer"), ("rwkv", "BAT")])
def test_automodel_generate_texts_match_jax(tmp_path, name, model):
    d = write_transducer_dir(str(tmp_path), name, model)
    rng = np.random.default_rng(4)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (8000, 5600)]
    got = AutoModel(model=d, device="cpu").generate(input=wavs)
    want = jauto.AutoModel(model=d).generate(input=wavs)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert all(r["text"] for r in got), got


# ---- the recipes on the CPU ----------------------------------------------------------

def write_corpus(d, n=4, seconds=(1.0, 1.6), seed=0):
    """n generated wavs with random texts of TOKENS' characters, wav.scp + text."""
    import wave
    rng = np.random.default_rng(seed)
    scp, txt = [], []
    for i in range(n):
        x = (rng.standard_normal(int(16000 * rng.uniform(*seconds))) * 3000).astype(np.int16)
        path = os.path.join(d, f"u{i}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(x.tobytes())
        scp.append(f"u{i} {path}")
        txt.append(f"u{i} " + "".join(TOKENS[j] for j in rng.integers(3, V - 1, 5)))
    for name, lines in (("wav.scp", scp), ("text", txt)):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    from funasr_tpu_torch.bin.data_tools import scp2jsonl
    jsonl = os.path.join(d, "data.jsonl")
    scp2jsonl(scp_file_list=[os.path.join(d, "wav.scp"), os.path.join(d, "text")],
              data_type_list=["source", "target"], jsonl_file_out=jsonl)
    return jsonl


def train(md, jsonl, out, *flags):
    from funasr_tpu_torch.bin._overrides import parse_overrides
    from funasr_tpu_torch.bin.train import main
    main(**parse_overrides([f"++model={md}", "++device=cpu", f"++train_data_set_list={jsonl}",
                            f"++valid_data_set_list={jsonl}", f"++output_dir={out}",
                            "++train_conf.log_interval=1", "++train_conf.use_tensorboard=False",
                            *flags]))
    import json
    with open(os.path.join(out, "train.log.jsonl"), encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    return [x for x in lines if "validate" not in x]


def test_transducer_finetune_flags_train_two_steps_on_the_cpu(tmp_path):
    """``transducer/finetune.sh``'s flags (``++sharding=fsdp``, token batches,
    ``optim_conf.lr=0.0002``) on a small chunk-Conformer transducer: two steps, a finite
    loss. The FFN's w_1 (2,048 x 32) and the prediction LSTM's weight_hh (512 x 128) reach
    FSDP2's unit size (``parallel/sharding.py::layer_units``), so the encoder's layers are
    units of their own, as at full width."""
    d = str(tmp_path)
    jsonl = write_corpus(d)
    md = os.path.join(d, "model")
    os.makedirs(md)
    write_transducer_dir(md, "chunk", "Transducer", encoder_conf=dict(linear_units=2048),
                         pred=dict(decoder_conf=dict(embed_size=16, hidden_size=128),
                                   joint_network_conf=dict(joint_space_size=40)))
    steps = train(md, jsonl, os.path.join(d, "exp"), "++sharding=fsdp",
                  "++dataset_conf.batch_size=400", "++dataset_conf.batch_type=token",
                  "++optim_conf.lr=0.0002", "++train_conf.max_epoch=1")
    assert len(steps) >= 2 and all(np.isfinite(x["loss"]) for x in steps), steps


def test_aishell_conformer_recipe_stages_on_the_cpu(tmp_path):
    """The AISHELL recipe's stages 1, 4 and 5 at a tiny width: ``compute_cmvn``, then
    ``bin/train`` over a conf dir (the recipe's config.yaml layout: SpecAug,
    ``EspnetStyleBatchSampler``, ``batch_type: length``, ``++sharding=dp``) for two steps,
    then ``bin/benchmark ++mode=cer`` from the average."""
    import json
    import subprocess
    import sys
    from funasr_tpu_torch.bin.data_tools import compute_cmvn
    d = str(tmp_path)
    jsonl = write_corpus(d)
    mvn = os.path.join(d, "am.mvn")
    compute_cmvn(jsonl=jsonl, out=mvn, dim=80, device="cpu")
    conf_dir = os.path.join(d, "conf")
    os.makedirs(conf_dir)
    with open(os.path.join(REPO, "examples/aishell/conformer/conf/conformer_12e_6d_2048_256/"
                                 "config.yaml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg["encoder_conf"].update(output_size=32, linear_units=48, num_blocks=2)
    cfg["decoder_conf"].update(linear_units=48, num_blocks=1)
    _write_config(conf_dir, cfg)
    tokens = os.path.join(d, "tokens.txt")
    with open(tokens, "w", encoding="utf-8") as f:
        f.write("\n".join(TOKENS) + "\n")
    out = os.path.join(d, "exp")
    steps = train(conf_dir, jsonl, out, f"++tokenizer_conf.token_list={tokens}",
                  f"++frontend_conf.cmvn_file={mvn}", "++sharding=dp",
                  "++dataset_conf.batch_size=250", "++train_conf.max_epoch=1",
                  "++train_conf.avg_nbest_model=1")
    assert len(steps) >= 2 and all(np.isfinite(x["loss"]) for x in steps), steps
    run = subprocess.run(
        [sys.executable, "-m", "funasr_tpu_torch.bin.benchmark", "++mode=cer",
         f"++model={out}", f"++init_param={os.path.join(out, 'model.pt.avg')}",
         f"++tokenizer_conf.token_list={tokens}", f"++frontend_conf.cmvn_file={mvn}",
         f"++wav_scp={os.path.join(d, 'wav.scp')}", f"++text={os.path.join(d, 'text')}",
         "++device=cpu", "++beam_size=2"],
        cwd=d, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    report = json.loads(run.stdout.strip().splitlines()[-1])
    assert report["mode"] == "cer" and report["n_utts"] == 4 and report["cer"] >= 0
