"""What the port's kernels are held to that a CPU can check.

* ``chip_smoke.py``'s roofline arithmetic: each kernel's bytes and operations from its
  shapes, and the least time the H100 could take for them (the bound beside every
  kernel time in ``PERF.md``);
* the wrappers' pure-Python planning: the W8A8 paddings, the flash
  block rows;
* the W8A8 kernel's quantizer: a product with fl(1/sx), checked against the rounding
  boundary, gives the IEEE quotient's int8 value bit for bit (emulated here in fp32);
* the fp32 flash kernel's 3xTF32 split, emulated in fp32 with its key tiles and online
  softmax: within the card's tolerance of the plain version, where one TF32 product is
  not;
* the backward kernels' decompositions, emulated in fp32: flash's (3xTF32 products, the
  forward's (m, l) kept apart, 32-key blocks over 64-row query tiles with the live tiles
  a suffix, dK / dV added over four query quarters, the key blocks' dQ shares added in
  order) and the FSMN weight gradient's (blocks of 4 chunks, a k-slot window sliding
  over flat rows, taps outside a row's utterance skipped), each against autograd through
  the plain version; their planning functions and ``chip_smoke.fsmn_dw_work``;
* the kernels' JSON line of ``chip_smoke.py``, fp32, pipeline, hotword, streaming,
  SenseVoice, serving and LLM entries included, and phase 13's per-server launch gate
  (``served``);
* the flash kernel's per-row key limits (``key_limits``): each mode's limits are the JAX
  masks (causal, the "VAD corner") beside the pad mask as row prefixes, and never fall
  with the row, which the kernel's skip of key tiles past a row block's last row needs;
* the kernel modules never call the library functions that ``chip_smoke.py`` times
  beside the kernels.
"""

import ast
from pathlib import Path

import chip_smoke
import numpy as np
import pytest
import torch

from funasr_tpu_torch.ops.flash_attention import flash_attention_ref, flash_block_rows, key_limits
from funasr_tpu_torch.ops.w8a8 import INV127, plan_w8a8, quantize_rows_int8

REPO = Path(__file__).resolve().parents[1]


SMOKE_LENS = [384 - 37 * (i % 2) for i in range(32)]  # chip_smoke's flash lengths
QWEN_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]


@pytest.mark.parametrize("name,work,op_type,want_us,want_by", [
    # (32, 4, 384, 128) bf16, every key live: q, k, v read and o written, 50.3 MB
    ("flash path", chip_smoke.flash_work(32, 4, 384, 128, [384] * 32, 2), "bf16", 15.0,
     "bytes"),
    ("flash long form", chip_smoke.flash_work(1, 4, 1408, 128, [1408], 2), "bf16", 4.1,
     "operations"),
    ("w8a8 FFN w_1", chip_smoke.w8a8_work(12288, 512, 2048, 2, 2), "int8", 19.1, "bytes"),
    ("fsmn encoder", chip_smoke.fsmn_work(32, 384, 512, 11, 2), "fp32", 7.5, "bytes"),
    ("fsmn encoder fp32", chip_smoke.fsmn_work(32, 384, 512, 11, 4), "fp32", 15.0, "bytes"),
    # fp32 flash on the CUDA cores at the smoke's lengths (the figure beside the 3xTF32 one)
    ("flash fp32 CUDA cores", chip_smoke.flash_work(32, 4, 384, 128, SMOKE_LENS, 4), "fp32",
     137.3, "operations"),
    # the pipeline's shapes: the VAD's causal memory over cache + a 60 s chunk, the
    # punctuation encoder's FSMN and (8 x 32-wide heads, length 57 of 64) flash
    ("fsmn VAD k = 20", chip_smoke.fsmn_work(1, 6019, 128, 20, 4), "fp32", 1.8, "bytes"),
    ("fsmn punc", chip_smoke.fsmn_work(1, 64, 256, 11, 4), "fp32", 0.0, "bytes"),
    ("flash punc fp32", chip_smoke.flash_work(1, 8, 64, 32, [57], 4), "tf32", 0.1, "bytes"),
    # the SeACo decoder's memory (k = 21): the same bytes as k = 11 at (32, 208, 512)
    ("fsmn SeACo k = 21 fp32", chip_smoke.fsmn_work(32, 208, 512, 21, 4), "fp32", 8.2, "bytes"),
    ("fsmn SeACo k = 21 bf16", chip_smoke.fsmn_work(32, 208, 512, 21, 2), "fp32", 4.1, "bytes"),
])
def test_roofline_bounds(name, work, op_type, want_us, want_by):
    ms, by = chip_smoke.bound_ms(*work, op_type)
    assert round(ms * 1e3, 1) == want_us and by == want_by, (name, ms, by)


def test_fp32_flash_bound_on_the_3xtf32_route():
    """fp32 flash is bound at three TF32 products per product on the tensor cores (the
    card's fastest fp32-accurate route), not at the CUDA cores' 67 TFLOP/s."""
    assert chip_smoke.H100_PEAK["tf32"] == 495e12 and chip_smoke.H100_PEAK["fp32"] == 67e12
    n_bytes, n_ops = chip_smoke.flash_work(32, 4, 384, 128, SMOKE_LENS, 4)
    ms, by = chip_smoke.flash_bound(32, 4, 384, 128, SMOKE_LENS, torch.float32)
    assert (ms, by) == chip_smoke.bound_ms(n_bytes, 3 * n_ops, "tf32")
    assert round(ms * 1e3, 1) == 55.7 and by == "operations"
    ms, by = chip_smoke.flash_bound(1, 4, 1408, 128, [1408], torch.float32)
    assert round(ms * 1e3, 1) == 24.6 and by == "operations"
    # bf16 keeps its own route
    assert chip_smoke.flash_bound(32, 4, 384, 128, [384] * 32, torch.bfloat16) == \
        chip_smoke.bound_ms(*chip_smoke.flash_work(32, 4, 384, 128, [384] * 32, 2), "bf16")


def test_kernels_line_carries_fp32_entries():
    """One entry per kernel; flash and FSMN carry their fp32 figures under ``fp32`` with
    the launches of one default (fp32) AutoModel decode."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    record[("flash_attention", torch.float32)] = dict(row, ms=5.0, cuda_core_bound_ms=0.9)
    record[("fsmn_memory", torch.float32)] = dict(row, ms=6.0)
    line = chip_smoke.kernels_line(record, {"flash_attention": 100, "fsmn_memory": 132},
                                   {"w8a8_linear": 282},
                                   {"flash_attention": 50, "fsmn_memory": 66})
    kernels = {k["name"]: k for k in line["kernels"]}
    assert list(kernels) == ["flash_attention", "fsmn_memory", "w8a8_linear"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(k) for k in kernels.values())
    assert kernels["flash_attention"]["launches_per_decode"] == 50
    assert kernels["flash_attention"]["fp32"]["ms"] == 5.0
    assert kernels["flash_attention"]["fp32"]["launches"] == 50
    assert kernels["flash_attention"]["fp32"]["cuda_core_bound_ms"] == 0.9
    assert kernels["fsmn_memory"]["fp32"]["launches_per_decode"] == 66
    assert kernels["fsmn_memory"]["fp32"]["ms"] == 6.0
    assert "fp32" not in kernels["w8a8_linear"]
    assert kernels["w8a8_linear"]["launches"] == 282


def test_kernels_line_carries_pipeline_entries():
    """Flash and FSMN carry their rows at the pipeline's shapes under ``pipeline``, with
    the launches of phase 8's requests summed (the bf16 punctuation row: 0, the default
    pipeline runs fp32); W8A8 has none."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    for entries in chip_smoke.PIPELINE_ENTRIES.values():
        for _, key, _ in entries:
            record[key] = dict(row, ms=7.0)
    stage = {"flash_attention": 0, "fsmn_memory": 0, "w8a8_linear": 0}
    requests = [dict(vad_launches=dict(stage, fsmn_memory=24),
                     punc_launches=dict(stage, fsmn_memory=n, flash_attention=n))
                for n in (480, 500)]
    launches = {"flash_attention": 100, "fsmn_memory": 132}
    line = chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282}, launches, requests)
    kernels = {k["name"]: k for k in line["kernels"]}
    assert kernels["fsmn_memory"]["pipeline"]["vad"]["launches"] == 48
    assert kernels["fsmn_memory"]["pipeline"]["punc"]["launches_per_request"] == 490
    assert kernels["flash_attention"]["pipeline"]["punc_fp32"]["launches"] == 980
    assert kernels["flash_attention"]["pipeline"]["punc_bf16"]["launches"] == 0
    assert kernels["flash_attention"]["pipeline"]["punc_fp32"]["ms"] == 7.0
    assert "pipeline" not in kernels["w8a8_linear"]
    assert "pipeline" not in chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282},
                                                     launches)["kernels"][0]


def test_kernels_line_carries_hotword_entries():
    """Every kernel carries phase 10's launches under ``hotword``, per counted decode and
    over the pipeline's ASR batches; FSMN adds its k = 21 rows with the launches of the
    decodes of their dtype."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    for dtype in (torch.float32, torch.bfloat16):
        record[("fsmn_memory", "hotword", dtype)] = dict(row, ms=9.0, generic_ms=90.0)
    kernels = dict(flash_attention=50, fsmn_memory=78, w8a8_linear=0)

    def run(k21, fsmn=78):
        return dict(launches=dict(kernels, fsmn_memory=fsmn), k21_launches=k21)
    hotword = {("seaco", "fp32", 20): run(12), ("seaco", "fp32", 200): run(18, 84),
               ("seaco", "bf16", 200): run(18, 84), ("contextual", "fp32", 20): run(0, 66),
               "seaco_cuda_vs_cpu": dict(err=0.0),
               "pipeline": [dict(asr_launches=dict(kernels, fsmn_memory=156))] * 2}
    launches = {"flash_attention": 100, "fsmn_memory": 132}
    line = chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282}, launches,
                                   hotword=hotword)
    kernels_out = {k["name"]: k for k in line["kernels"]}
    fsmn = kernels_out["fsmn_memory"]["hotword"]
    assert fsmn["launches_per_decode"] == {"seaco_fp32_20": 78, "seaco_fp32_200": 84,
                                           "seaco_bf16_200": 84, "contextual_fp32_20": 66}
    assert fsmn["launches"] == 312 and fsmn["pipeline_launches"] == 312
    assert fsmn["k21_fp32"]["launches_per_decode"] == {"seaco_fp32_20": 12, "seaco_fp32_200": 18,
                                                       "contextual_fp32_20": 0}
    assert fsmn["k21_fp32"]["launches"] == 30 and fsmn["k21_bf16"]["launches"] == 18
    assert fsmn["k21_bf16"]["generic_ms"] == 90.0 and fsmn["k21_bf16"]["bound_by"] == "bytes"
    assert kernels_out["flash_attention"]["hotword"]["launches"] == 200
    assert kernels_out["w8a8_linear"]["hotword"]["launches"] == 0
    assert "k21_fp32" not in kernels_out["flash_attention"]["hotword"]
    # the other per-decode figures are the main path's, whatever phase 10 ran
    assert kernels_out["w8a8_linear"]["launches_per_decode"] == 282


def test_kernels_line_carries_streaming_entries():
    """Flash and FSMN carry phase 11's launches (fp32 and bf16 streams, per chunk, the
    realtime punctuation's) and their rows at the streaming shapes under ``streaming``;
    FSMN adds the profile's (11, 5) / (11, 10) split; W8A8 has none."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    for entries in chip_smoke.STREAMING_ENTRIES.values():
        for _, key in entries:
            record[key] = dict(row, ms=8.0)
    run = dict(launches=dict(flash_attention=5100, fsmn_memory=6732, w8a8_linear=0),
               launches_per_chunk=dict(flash_attention=50.0, fsmn_memory=66.0, w8a8_linear=0.0),
               profile_per_chunk=dict(flash=50.0, fsmn_11_5=50.0, fsmn_11_10=16.0))
    streaming = dict(fp32=run, bf16=run, punc=dict(launches=dict(flash_attention=56,
                                                                fsmn_memory=56, w8a8_linear=0)))
    launches = {"flash_attention": 100, "fsmn_memory": 132}
    line = chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282}, launches,
                                   streaming=streaming)
    kernels = {k["name"]: k for k in line["kernels"]}
    flash, fsmn = kernels["flash_attention"]["streaming"], kernels["fsmn_memory"]["streaming"]
    assert flash["launches"] == 10200 and flash["launches_per_chunk"] == {"fp32": 50.0,
                                                                          "bf16": 50.0}
    assert flash["punc_launches"] == 56 and flash["rows"]["keys55_fp32"]["ms"] == 8.0
    assert set(flash["rows"]) >= {"keys15_bf16", "keys1005_fp32", "causal_fp32", "corner30_bf16"}
    assert fsmn["profile_per_chunk"]["fp32"] == {"fsmn_11_5": 50.0, "fsmn_11_10": 16.0}
    assert set(fsmn["rows"]) == {"step25_fp32", "step25_bf16", "step26_fp32", "step26_bf16"}
    assert "streaming" not in kernels["w8a8_linear"]


def test_kernels_line_carries_sensevoice_entries():
    """Every kernel carries phase 12's launches per SenseVoice decode at each setting and
    its rows at SenseVoice's shapes under ``sensevoice``: W8A8 the five block products and
    the CTC head, flash and FSMN their rows at the demo's largest ASR batch too."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    for entries in chip_smoke.SENSEVOICE_ENTRIES.values():
        for _, key in entries:
            record[key] = dict(row, ms=7.0)
    launches = {"flash_attention": 70, "fsmn_memory": 70, "w8a8_linear": 0}
    run = dict(launches=launches, profile={name: dict(ms=1.5, launches=n)
                                           for name, n in launches.items()})
    sensevoice = dict(fp32=run, bf16=run, w8a8=dict(run, launches=dict(launches,
                                                                       w8a8_linear=281)),
                      demo=[dict(asr_launches=dict(launches, flash_attention=350))],
                      demo_kernels=dict(rows={"flash_attention": dict(row, ms=9.0),
                                              "fsmn_memory": dict(row, ms=9.0)}))
    line = chip_smoke.kernels_line(record, {"flash_attention": 100, "fsmn_memory": 132},
                                   {"w8a8_linear": 282}, launches, sensevoice=sensevoice)
    kernels = {k["name"]: k["sensevoice"] for k in line["kernels"]}
    assert kernels["w8a8_linear"]["launches_per_decode"] == {"fp32": 0, "bf16": 0, "w8a8": 281}
    assert set(kernels["w8a8_linear"]["rows"]) == {
        "block_560x1536_bf16", "block_512x1536_bf16", "block_512x512_bf16",
        "block_512x2048_bf16", "block_2048x512_bf16", "ctc_head_bf16"}
    assert "demo_asr_fp32" not in kernels["w8a8_linear"]["rows"]
    for name in ("flash_attention", "fsmn_memory"):
        assert set(kernels[name]["rows"]) == {"fp32", "bf16", "demo_asr_fp32"}
        assert kernels[name]["rows"]["demo_asr_fp32"]["ms"] == 9.0
    assert kernels["flash_attention"]["demo_asr_launches"] == 350


def test_kernels_line_carries_serving_entries():
    """Flash and FSMN carry phase 13's launches under ``serving``: the sum of the four
    server runs, each run's own beside it, and their rows at the serving shapes."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    launches = {"flash_attention": 100, "fsmn_memory": 132, "w8a8_linear": 0}
    runs = {srv: {"launches": {k: (i + 1) * v for k, v in launches.items()}}
            for i, srv in enumerate(chip_smoke.SERVERS)}
    serving = dict(runs, rows={key: dict(row, ms=5.0) for entries in
                               chip_smoke.SERVING_ENTRIES.values() for _, key in entries},
                   launches={k: 10 * v for k, v in launches.items()})
    line = chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282}, launches,
                                   serving=serving)
    kernels = {k["name"]: k["serving"] for k in line["kernels"]}
    for name, entry in kernels.items():
        assert entry["launches"] == sum(entry["by_server"].values()) == 10 * launches[name]
    assert set(kernels["flash_attention"]["rows"]) == set(kernels["fsmn_memory"]["rows"]) == {
        f"{b}x{t}_fp32" for b, t in [(8, 384)] + [(1, t) for t in chip_smoke.SERVE_T]}
    assert kernels["w8a8_linear"]["rows"] == {}


def test_kernels_line_carries_llm_entries():
    """Every kernel carries phase 14's launches under ``llm``: their sum over the three
    ``AutoModel`` settings and ``AutoModelVLLM``, each run's beside it, the sites x calls
    each run was held to, and the rows at the LLM path's shapes (W8A8's at each shape
    that the W8A8 run launched, labelled by ``w8a8_label``)."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    launches = {"flash_attention": 50, "fsmn_memory": 50, "w8a8_linear": 0}
    runs = {label: {"launches": dict(launches), "sites": dict(launches)}
            for label, _ in chip_smoke.LLM_SETTINGS + (("vllm", None),)}
    runs["w8a8"]["launches"]["w8a8_linear"] = runs["w8a8"]["sites"]["w8a8_linear"] = 13138
    shapes = [(4000, 560, 1536, torch.float32, torch.float32)] + [
        (m, k, n, torch.bfloat16, None) for m in (16, 1024, 2560) for k, n in QWEN_KN]
    rows = {key: dict(row, ms=5.0) for entries in chip_smoke.LLM_ENTRIES.values()
            for _, key in entries}
    rows.update({("w8a8_linear", "llm", shape): dict(row, ms=6.0) for shape in shapes})
    llm = dict(runs, rows=rows, launches={k: 4 * v + (13138 if k == "w8a8_linear" else 0)
                                          for k, v in launches.items()})
    line = chip_smoke.kernels_line(record, launches, {"w8a8_linear": 282}, launches, llm=llm)
    kernels = {k["name"]: k["llm"] for k in line["kernels"]}
    for name, entry in kernels.items():
        assert entry["launches"] == sum(entry["by_run"].values())
        assert set(entry["by_run"]) == set(entry["sites_x_calls"]) == {
            "fp32", "bf16", "w8a8", "vllm"}
    assert kernels["w8a8_linear"]["sites_x_calls"]["w8a8"] == 13138
    assert set(kernels["w8a8_linear"]["rows"]) == {"4000x560x1536_float32_bias"} | {
        f"{m}x{k}x{n}_bfloat16" for m in (16, 1024, 2560) for k, n in QWEN_KN}
    assert set(kernels["flash_attention"]["rows"]) == {"fp32", "bf16"}


def test_kernels_line_carries_export_entries():
    """Every kernel carries phase 15's launches under ``export``: their sum over the
    exported programs' counted calls, each call's by setting and bucket, the rows at the
    shapes those calls launched (with their launches a call by program), and its lone
    call's ms through the custom op and directly."""
    row = dict(shape=(1, 2), max_abs_err=0.0, ms=1.0, call_ms=2.0, plain_ms=3.0,
               library_ms=4.0, bound_ms=0.5, bound_by="bytes")
    record = {(name, torch.bfloat16): row for name in chip_smoke.LIBRARY_CALLS}
    call = {"flash_attention": 50, "fsmn_memory": 66, "w8a8_linear": 0}
    export = {"fp32": {"calls": [dict(bucket=b, launches=call)
                                 for b in chip_smoke.EXPORT_BUCKETS]},
              "w8a8": {"calls": [dict(bucket=b, launches=dict(call, w8a8_linear=282))
                                 for b in chip_smoke.EXPORT_W8A8_BUCKETS]},
              "launches": {"flash_attention": 150, "fsmn_memory": 198, "w8a8_linear": 282},
              "op_dispatch": {name: dict(direct_call_ms=0.05, op_call_ms=0.07)
                              for name in chip_smoke.LIBRARY_CALLS},
              "rows": {"flash_attention": {"4x4x168x128_float32": dict(
                           row, launches_per_call={"fp32_b4_t168": 50})},
                       "fsmn_memory": {"4x168x512_k11_float32": dict(
                           row, launches_per_call={"fp32_b4_t168": 50}),
                           "4x100x512_k11_float32": dict(
                           row, launches_per_call={"fp32_b4_t168": 16})}}}
    line = chip_smoke.kernels_line(record, call, {"w8a8_linear": 282}, call, export=export)
    kernels = {k["name"]: k["export"] for k in line["kernels"]}
    for name, entry in kernels.items():
        assert entry["launches"] == sum(entry["launches_per_call"].values())
    assert sum(r["launches_per_call"]["fp32_b4_t168"]
               for r in kernels["fsmn_memory"]["rows"].values()) == 66
    assert set(kernels["flash_attention"]["rows"]) == {"4x4x168x128_float32"}
    assert kernels["w8a8_linear"]["rows"] == {}
    assert kernels["fsmn_memory"]["launches_per_call"] == {
        "fp32_b4_t168": 66, "fp32_b32_t384": 66, "w8a8_b32_t384": 66}
    assert kernels["w8a8_linear"]["launches_per_call"]["w8a8_b32_t384"] == 282
    assert kernels["w8a8_linear"]["op_call_ms"] == 0.07
    assert "export" not in chip_smoke.kernels_line(record, call, {"w8a8_linear": 282},
                                                   call)["kernels"][0]


def test_number_tokens_put_the_numerals_first():
    """Phase 15's token list: as many distinct tokens as the vocabulary, the numerals at
    ids 3-20; ``lift_numerals`` raises the head's bias at those ids and nowhere else."""
    tokens = chip_smoke.number_tokens()
    n = len(chip_smoke.NUMBER_CHARS)
    assert len(tokens) == len(set(tokens)) == chip_smoke.PROD_CONF["vocab_size"]
    assert tokens[3:3 + n] == list(chip_smoke.NUMBER_CHARS) and tokens[-1] == "<unk>"
    head = torch.nn.Linear(4, len(tokens))
    before = head.bias.detach().clone()
    chip_smoke.lift_numerals(head, tokens)
    lift = (head.bias.detach() - before).nonzero().flatten().tolist()
    assert lift == list(range(3, 3 + n))
    assert torch.allclose(head.bias[3:3 + n] - before[3:3 + n],
                          torch.full((n,), chip_smoke.NUMBER_LIFT))


def test_w8a8_shapes_records_each_launch_and_restores_the_wrapper():
    """``chip_smoke.w8a8_shapes`` gathers (M, K, N, x dtype, bias dtype) of each W8A8 call
    through ``qlinear`` (here the plain version, on CPU tensors), and puts the wrapper
    back when the block ends."""
    from funasr_tpu_torch.ops import quant

    inner = quant.w8a8_linear
    with_bias = quant.quantize_linear_int8(torch.nn.Linear(256, 384), key="w_q8")
    no_bias = quant.quantize_linear_int8(torch.nn.Linear(384, 256, bias=False), key="w_q8")
    x = torch.randn(2, 3, 256)
    with chip_smoke.w8a8_shapes() as seen:
        y = quant.qlinear(no_bias, quant.qlinear(with_bias, x).to(torch.bfloat16))
    assert quant.w8a8_linear is inner and y.shape == (2, 3, 256)
    assert seen == {(6, 256, 384, torch.float32, torch.float32),
                    (6, 384, 256, torch.bfloat16, None)}


@pytest.mark.parametrize("counted", [True, False])
def test_served_gates_each_run_on_its_own_model_calls(monkeypatch, counted):
    """``chip_smoke.served`` sets the counts to 0 before a server's traffic, counts the
    calls of its models, and raises where the launches fall short of the kernel sites of
    those calls: here the plain versions count as launches only when ``counted``."""
    from funasr_tpu_torch import tables
    from funasr_tpu_torch.ops import flash_attention as fa
    from funasr_tpu_torch.ops import fsmn
    from funasr_tpu_torch.ops.w8a8 import w8a8_linear

    if counted:
        for mod, ref, wrapper in ((fa, "flash_attention_ref", fa.flash_attention),
                                  (fsmn, "fsmn_memory_ref", fsmn.fsmn_memory)):
            def plain(*args, _inner=getattr(mod, ref), _wrapper=wrapper, **kwargs):
                _wrapper.launches += 1
                return _inner(*args, **kwargs)
            monkeypatch.setattr(mod, ref, plain)
    enc = tables.encoder_classes["SANMEncoder"](input_size=16, output_size=32,
                                                attention_heads=4, linear_units=48,
                                                num_blocks=2)
    counters = (fa.flash_attention, fsmn.fsmn_memory, w8a8_linear)
    for c in counters:
        c.launches = 7  # set to 0 by served

    def traffic():
        for t in (20, 9):
            enc(torch.randn(1, t, 16), torch.tensor([t]))
        return "answer"
    run = lambda: chip_smoke.served("stub server", counters, {"enc": (enc, "forward")},
                                    traffic)
    if not counted:
        with pytest.raises(AssertionError, match="bypassed a kernel"):
            run()
        assert "forward" not in vars(enc)  # the wrapper is removed on a failure too
        return
    out, launches, calls = run()
    assert (out, calls) == ("answer", {"enc": 2})
    assert launches == {"flash_attention": 4, "fsmn_memory": 4, "w8a8_linear": 0}
    assert "forward" not in vars(enc)


def test_flash_work_with_a_key_cache_and_row_limits():
    """15 query rows over 55 cached + chunk keys read k and v once (55 rows) and score
    15 x 55 pairs; causal rows score r + 1 keys each."""
    n_bytes, n_ops = chip_smoke.flash_work(1, 4, 15, 128, [55], 4, [[55] * 15])
    assert n_bytes == 4 * 4 * 128 * (2 * 15 + 2 * 55) + 4
    assert n_ops == 4 * 4 * 128 * 15 * 55
    _, causal_ops = chip_smoke.flash_work(1, 8, 64, 32, [64], 4,
                                          key_limits(torch.tensor([64]), 64, "causal").tolist())
    assert causal_ops == 4 * 8 * 32 * sum(range(1, 65))
    assert chip_smoke.flash_work(3, 2, 100, 64, [100, 40, 0], 2) == chip_smoke.flash_work(
        3, 2, 100, 64, [100, 40, 0], 2, [[100] * 100, [40] * 100, [100] * 100])


@pytest.mark.parametrize("mode,vad_pos", [("none", None), ("causal", None),
                                          ("corner", [0, 1, 9, 40, 30])])
def test_key_limits_are_the_jax_masks(mode, vad_pos):
    """The keys below each row's limit are exactly the keys the JAX route lets it see:
    ``cols < len`` with the causal mask, or with ``vad_corner_mask``; limits never fall
    with the row."""
    b, t = 5, 30
    lens = torch.tensor([30, 17, 1, 30, 25])
    vp = None if vad_pos is None else torch.tensor(vad_pos)
    lim = key_limits(lens, t, mode, vp)
    rows, cols = np.arange(t)[None, :, None], np.arange(t)[None, None, :]
    want = np.broadcast_to(cols < lens.numpy()[:, None, None], (b, t, t))
    if mode == "causal":
        want = want & (rows >= cols)
    if mode == "corner":
        v = np.asarray(vad_pos)[:, None, None]
        want = want & ~((rows <= v - 2) & (cols >= v))
    np.testing.assert_array_equal(cols < lim.numpy()[:, :, None], want)
    assert (lim[:, 1:] >= lim[:, :-1]).all()


def test_flash_work_counts_keys_up_to_the_lengths():
    """K and V are read, and scored, only up to each row's length; a length-0 row
    averages V over all T keys, so it needs every key."""
    full_bytes, full_ops = chip_smoke.flash_work(3, 2, 100, 64, [100, 100, 100], 2)
    bytes_, ops = chip_smoke.flash_work(3, 2, 100, 64, [100, 40, 0], 2)
    assert full_ops == 4 * 2 * 100 * 64 * 300 and ops == 4 * 2 * 100 * 64 * 240
    assert full_bytes - bytes_ == 2 * 2 * 64 * 2 * 60  # k and v rows 40..99 of one batch


def test_w8a8_work_and_peaks():
    n_bytes, n_ops = chip_smoke.w8a8_work(12288, 512, 2048, 2, 2)
    assert n_ops == 2 * 12288 * 512 * 2048
    assert n_bytes == 12288 * 512 * 2 + 2048 * 512 + 4 * 2048 + 2 * 2048 + 12288 * 2048 * 2
    ms, by = chip_smoke.bound_ms(0, n_ops, "int8")
    assert by == "operations" and round(ms * 1e3, 1) == 13.0


def test_library_calls_named_for_every_kernel():
    assert set(chip_smoke.LIBRARY_CALLS) == {"flash_attention", "fsmn_memory", "w8a8_linear"}
    assert "scaled_dot_product_attention" in chip_smoke.LIBRARY_CALLS["flash_attention"]
    assert "conv1d" in chip_smoke.LIBRARY_CALLS["fsmn_memory"]
    assert "_int_mm" in chip_smoke.LIBRARY_CALLS["w8a8_linear"]


@pytest.mark.parametrize("m,k,n,dtype,kp,pad,pitch", [
    (12288, 560, 1536, torch.bfloat16, 560, False, 1536),  # encoders0: K = 35 x 16
    (12288, 2048, 512, torch.bfloat16, 2048, False, 512),
    (33, 40, 24, torch.bfloat16, 48, True, 24),            # K % 16 != 0: weights padded
    (65, 100, 37, torch.bfloat16, 112, True, 40),          # N = 37: out rows padded to 16 B
    (65, 100, 37, torch.float32, 112, True, 40),
    (7, 560, 24, torch.float32, 560, False, 24),
] + [
    # Qwen3-0.6B's linears under quant="w8a8": q, k / v, o, gate / up, down at the decode
    # step's M (8 or 16 slots, one 128-row tile mostly empty) and prefill chunks of 16
    # slots x 64, 128 and 160 rows (Fun-ASR-Nano's two chunks of a 15 s prompt: 160, 64)
    (m, k, n, dtype, k, False, n)
    for m in (8, 16, 16 * 128, 16 * 64, 16 * 160) for k, n in QWEN_KN
    for dtype in (torch.bfloat16, torch.float32)
] + [
    # Fun-ASR-Nano's encoder and Linear adaptor on 16 x 15 s (289 padded frames, 144 after
    # the adaptor's downsampling): ragged last tiles, fp32 activations
    (m, k, n, torch.float32, k, False, n)
    for m, k, n in [(16 * 289, 560, 1536), (16 * 289, 512, 1536), (16 * 289, 512, 512),
                    (16 * 289, 512, 2048), (16 * 289, 2048, 512), (16 * 144, 1024, 2048),
                    (16 * 144, 2048, 1024)]
])
def test_w8a8_plan(m, k, n, dtype, kp, pad, pitch):
    p = plan_w8a8(m, k, n, dtype)
    assert (p.kp, p.pad_weights, p.out_pitch) == (kp, pad, pitch)
    assert p.kp % 16 == 0 and p.out_pitch * torch.empty(0, dtype=dtype).element_size() % 16 == 0


@pytest.mark.parametrize("b,h,t,rows", [
    (32, 4, 384, 128),   # 384 blocks of 128 rows
    (1, 4, 1408, 64),    # 128-row blocks would be 44 for 132 SMs: 88 blocks of 64
    (4, 4, 384, 64),
    (2, 3, 77, 64),
    (132, 1, 128, 128),  # one 128-row block per SM
    (131, 1, 128, 64),
    (16, 4, 384, 128),   # Fun-ASR-Nano's encoder at B = 16, T = 384: 192 blocks
    (16, 4, 250, 64),    # at 250 frames 128-row blocks would be 128 of 132
    (16, 4, 289, 128),   # at 15 s: 250 LFR frames in the frontend's 289-frame bucket
])
def test_flash_block_rows(b, h, t, rows):
    assert flash_block_rows(b, h, t) == rows


@pytest.mark.parametrize("b,t,c,k", [(16, 384, 512, 11), (16, 250, 512, 11),
                                     (16, 289, 512, 11)])
def test_fsmn_plan_takes_the_llm_encoder_shapes(b, t, c, k):
    """The FSMN wrapper's checks pass Fun-ASR-Nano's encoder memory (the v slice of the
    fused q|k|v projection, as the SAN-M attention hands it over) at B = 16; its grid is
    (B, T / TIME_STEPS) blocks."""
    from funasr_tpu_torch.ops import fsmn

    qkv = torch.zeros(b, t, 3 * c)
    x = qkv[..., 2 * c:]
    w = torch.zeros(c, 1, k)
    mask = torch.ones(b, t, dtype=torch.bool)
    fsmn._check(x, w, mask, (k - 1) // 2, (k - 1) // 2)
    assert -(-t // fsmn.TIME_STEPS) <= 65535 and b <= 65535


def _quantize_like_the_kernel(x):
    """``csrc/w8a8.cu`` quant(), emulated in fp32: t = fl(v * fl(1 / sx)); where t lies
    more than 2^-12 from a half-integer, rint(t), else rint of the IEEE quotient."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) * INV127
    t = xf * (1.0 / s)
    near = (t - torch.floor(t) - 0.5).abs() <= 2.0 ** -12
    q = torch.where(near, torch.round(xf / s), torch.round(t))
    return torch.clamp(q, -127, 127).to(torch.int8), s, int(near.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_reciprocal_path_is_bit_exact(rng, dtype):
    x = (rng.standard_normal((256, 512)) * rng.uniform(1e-3, 50.0, (256, 1))).astype(np.float32)
    x[3] = 0.0
    x[4, :7] = 1e-7  # a row below the 1e-6 floor
    # rows of max 127 * 2^e and values (j + 1/2) 2^e, exact in bf16 too: their
    # quotients lie within rounding of a half-integer, where the IEEE quotient decides
    unit = 2.0 ** rng.integers(-10, 6, (35, 1))
    x[5:40, 0:1] = 127 * unit
    x[5:40, 1:255] = (np.arange(-127, 127) + 0.5) * unit
    xt = torch.from_numpy(x).to(dtype)
    got, s, n_near = _quantize_like_the_kernel(xt)
    want, want_s = quantize_rows_int8(xt)
    assert n_near > 0  # the boundary path was taken
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits; nearest, ties away), as ``csrc/flash_attention.cu``
    split_tf32 does with integer ops."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an fp32 operand: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's mma.sync computes it: hi = tf32(x), lo = x - hi (truncated
    to TF32 by the tensor core), lo hi' + hi lo' + hi hi'; TF32 products are exact in
    fp32, the sums fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _flash_like_the_kernel(q, k, v, lengths, mm, tile=32):
    """The fp32 kernel's arithmetic: 32-key tiles, scores in log2 units, keys past the
    length -1e30 (past T -inf), tiles past a non-zero length skipped, online softmax,
    out = O / max(l, 1e-30); every product through `mm`."""
    b, h, t, d = q.shape
    scale_log2 = (1.0 / d ** 0.5) * 1.4426950408889634
    out = torch.empty_like(q)
    for i in range(b):
        n = int(lengths[i])
        m = torch.full((h, t, 1), -1e30)
        l = torch.zeros(h, t, 1)
        o = torch.zeros(h, t, d)
        for k0 in range(0, n if n > 0 else t, tile):
            keys = torch.arange(k0, k0 + tile)
            kt = torch.zeros(h, tile, d)
            vt = torch.zeros(h, tile, d)
            kt[:, :min(tile, t - k0)] = k[i, :, k0:k0 + tile]
            vt[:, :min(tile, t - k0)] = v[i, :, k0:k0 + tile]
            s = mm(q[i], kt.transpose(1, 2)) * scale_log2
            s = torch.where(keys >= n, torch.tensor(-1e30), s)
            s = torch.where(keys >= t, torch.tensor(-float("inf")), s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + mm(p, vt)
            m = m_new
        out[i] = o / torch.clamp_min(l, 1e-30)
    return out


def test_3xtf32_split_meets_the_fp32_tolerance():
    """At (4, 4, 384, 128) with chip_smoke's lengths, the 3xTF32 emulation lies within
    FLASH_TOL[float32] of the plain version; a single TF32 product does not."""
    g = torch.Generator().manual_seed(0)
    b, h, t, d = 4, 4, 384, 128
    qkv = torch.randn(b, t, 3, h, d, generator=g)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    lens = [t - 37 * (i % 2) for i in range(b)]
    ref = flash_attention_ref(q, k, v, torch.tensor(lens))
    tol = chip_smoke.FLASH_TOL[torch.float32]

    def err(mm):
        got = _flash_like_the_kernel(q, k, v, lens, mm)
        return max((got[i, :, :n] - ref[i, :, :n]).abs().max().item()
                   for i, n in enumerate(lens))

    assert err(_mm_3xtf32) <= tol / 5
    assert err(_mm_1xtf32) > tol


def test_tf32_rounding_is_exact_split():
    """hi is a TF32 value (low 13 bits clear) within half a TF32 ulp of x, and x - hi is
    exact in fp32."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = _tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal((x.double() - hi.double()).float().double(), x.double() - hi.double())


KERNEL_MODULES = ["funasr_tpu_torch/ops/flash_attention.py", "funasr_tpu_torch/ops/fsmn.py",
                  "funasr_tpu_torch/ops/w8a8.py", "funasr_tpu_torch/ops/quant.py",
                  "funasr_tpu_torch/models/sanm/attention.py",
                  "funasr_tpu_torch/models/fsmn_vad_streaming/encoder.py",
                  "funasr_tpu_torch/models/ct_transformer/model.py"]


@pytest.mark.parametrize("path", KERNEL_MODULES)
def test_kernel_modules_call_no_library_kernel(path):
    """The yardsticks ``chip_smoke.py`` times are never named in the port's kernel
    modules (as an attribute, a function or an import)."""
    tree = ast.parse((REPO / path).read_text())
    names = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)}
    names |= {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}
    names |= {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
              for a in node.names}
    assert not names & {"scaled_dot_product_attention", "_int_mm", "conv1d"}, path


LOG2E = 1.4426950408889634
KEY_BLOCK, QUERY_TILE = 32, 64  # csrc/flash_attention_bwd.cu: KB, QT


def _flash_inputs(b, h, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.standard_normal((b, h, tq, d), dtype=np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, tk, d), dtype=np.float32))
            for _ in range(2))
    return q, k, v, dout


def _flash_bwd_like_the_kernel(q, k, v, dout, lengths, mode, vad_pos, mm, one_lse=False):
    """``csrc/flash_attention_bwd.cu``'s arithmetic in fp32: the forward's (m, l) (log2
    units; keys past a row's limit -1e30), Dr = rowsum(dO o O), one pass per 32-key
    block over the 64-row query tiles its keys reach (a suffix; every tile for a length-0
    row), S^T, P^T, dP^T, dS^T formed once, dK / dV summed per 16-row query quarter and
    the quarters added in order, each key block's share of dQ = dS K added in key-block
    order; every product through ``mm``. ``one_lse``: P from m + log2(l) alone."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / d ** 0.5
    lim = key_limits(lengths, tq, mode, vad_pos)  # (B, Tq)
    keys = torch.arange(tk)
    s2 = mm(q, k.transpose(-1, -2)) * (scale * LOG2E)
    s2 = torch.where(keys[None, None, None, :] >= lim[:, None, :, None], torch.tensor(-1e30),
                     s2)
    m = s2.amax(-1)
    l = torch.exp2(s2 - m[..., None]).sum(-1)
    out = mm(torch.exp2(s2 - m[..., None]) / l[..., None], v)
    if one_lse:
        m, l = m + torch.log2(l), torch.ones_like(l)
    dr = (dout * out).sum(-1)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(b):
        n = int(lengths[i])
        for k0 in range(0, tk, KEY_BLOCK):
            kb = slice(k0, min(k0 + KEY_BLOCK, tk))
            key = keys[kb]
            quarters_k = [torch.zeros(h, key.numel(), d) for _ in range(4)]
            quarters_v = [torch.zeros(h, key.numel(), d) for _ in range(4)]
            for r0 in range(0, tq, QUERY_TILE):
                rows = slice(r0, min(r0 + QUERY_TILE, tq))
                if n > 0 and int(lim[i, rows.stop - 1]) <= k0:
                    continue  # the tile's largest limit does not reach the block
                li = lim[i, rows]
                st = mm(k[i, :, kb], q[i, :, rows].transpose(-1, -2)) * (scale * LOG2E)
                st = torch.where(key[:, None] >= li[None, :], torch.tensor(-1e30), st)
                pt = torch.exp2(st - m[i, :, None, rows]) / l[i, :, None, rows]
                dpt = mm(v[i, :, kb], dout[i, :, rows].transpose(-1, -2))
                dst = torch.where(key[:, None] < li[None, :], pt * (dpt - dr[i, :, None, rows]),
                                  torch.tensor(0.0))
                for w in range(4):  # the warps' query quarters of the tile
                    cols = slice(16 * w, 16 * w + 16)
                    quarters_v[w] += mm(pt[..., cols], dout[i, :, rows][:, cols])
                    quarters_k[w] += mm(dst[..., cols], q[i, :, rows][:, cols])
                dq[i, :, rows] += mm(dst.transpose(-1, -2), k[i, :, kb])
            dv[i, :, kb] = ((quarters_v[0] + quarters_v[1]) + quarters_v[2]) + quarters_v[3]
            dk[i, :, kb] = (((quarters_k[0] + quarters_k[1]) + quarters_k[2])
                            + quarters_k[3]) * scale
    return dq * scale, dk, dv, out


FLASH_BWD_CASES = {
    # a length-0 row, a ragged last query tile (100 rows) and key block (4 x 32 > 100)
    "none": ((3, 2, 100, 100, 64), [100, 0, 37], "none", None),
    "causal": ((2, 2, 70, 70, 32), [70, 50], "causal", None),
    "corner": ((2, 2, 70, 70, 32), [70, 50], "corner", [20, 1]),
    # Tq < Tk: query rows over [cached keys | chunk], as the streaming encoder
    "tq_lt_tk": ((2, 2, 40, 100, 64), [100, 63], "none", None),
}


@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_backward_decomposition_meets_the_fp32_tolerance(case):
    """The backward kernel's decomposition, every product in 3xTF32, lies within
    chip_smoke.FLASH_BWD_REL_TOL (relative L2) of autograd through the plain version for
    dq, dk and dv."""
    from funasr_tpu_torch.ops.flash_attention import flash_attention_bwd_ref

    (b, h, tq, tk, d), lens, mode, vad_pos = FLASH_BWD_CASES[case]
    q, k, v, dout = _flash_inputs(b, h, tq, tk, d, seed=len(case))
    ln = torch.tensor(lens)
    vp = None if vad_pos is None else torch.tensor(vad_pos)
    want = flash_attention_bwd_ref(q, k, v, dout, ln, mode, vp)
    got = _flash_bwd_like_the_kernel(q, k, v, dout, ln, mode, vp, _mm_3xtf32)[:3]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        rel = ((a - w).norm() / w.norm()).item()
        assert rel <= chip_smoke.FLASH_BWD_REL_TOL / 2, (case, name, rel)


def test_flash_backward_needs_3xtf32_and_m_l_apart():
    """One TF32 product a product misses the 1e-5 gate; so does P from a single
    log-sum-exp m + log2(l), on the length-0 row, whose m is -1e30 and whose l = Tk
    vanishes in the sum, where m and l kept apart give P = 1 / Tk."""
    from funasr_tpu_torch.ops.flash_attention import flash_attention_bwd_ref

    (b, h, tq, tk, d), lens, mode, vad_pos = FLASH_BWD_CASES["none"]
    q, k, v, dout = _flash_inputs(b, h, tq, tk, d, seed=4)
    ln = torch.tensor(lens)
    want = flash_attention_bwd_ref(q, k, v, dout, ln)

    def worst(**kw):
        got = _flash_bwd_like_the_kernel(q, k, v, dout, ln, mode, None, **kw)[:3]
        return max(((a - w).norm() / w.norm()).item() for a, w in zip(got, want))

    assert worst(mm=_mm_3xtf32) <= chip_smoke.FLASH_BWD_REL_TOL
    assert worst(mm=_mm_1xtf32) > chip_smoke.FLASH_BWD_REL_TOL
    assert worst(mm=_mm_3xtf32, one_lse=True) > 0.5


@pytest.mark.parametrize("b,h,tq,tk,d,blocks,scratch", [
    (5, 4, 190, 190, 128, (20, 6), 3800 + 6 * 3800 * 128),   # the recipe's first batch
    (3, 4, 296, 296, 128, (12, 10), 3552 + 10 * 3552 * 128),
    (1, 4, 15, 55, 128, (4, 2), 60 + 2 * 60 * 128),          # a streaming chunk's keys
    (1, 1, 3, 3, 8, (1, 1), 4 + 3 * 8),                       # Dr rounded up to 4 floats
])
def test_flash_bwd_plan(b, h, tq, tk, d, blocks, scratch):
    """The backward's grid (B H, key blocks of 32): 120 blocks at the recipe's (5, 4,
    190), 132 SMs nearly full; its scratch: Dr, then the key blocks' dQ shares."""
    from funasr_tpu_torch.ops.flash_attention import KEY_BLOCK as kb, flash_bwd_plan

    plan = flash_bwd_plan(b, h, tq, tk, d)
    assert kb == KEY_BLOCK and plan["grid"] == blocks
    assert plan["scratch_floats"] == scratch
    assert plan["dq_part_shape"] == (blocks[1], b * h, tq, d)
    assert plan["dr_floats"] % 4 == 0 and plan["dr_floats"] >= b * h * tq


def _fsmn_dw_like_the_kernel(x, dout, mask, left, right, rows):
    """``csrc/fsmn.cu``'s vector weight-gradient kernel in fp32: blocks of 4 chunks of
    ``rows`` flat (b, t) rows; a chunk's walk loads x row c0 - left + i at step i into
    slot i % k and, from step k - 1 on, adds g row r times the window (tap j: slot
    (i + 1 + j) % k), skipping a masked g row and taps whose x row is masked or outside
    r's utterance; the 4 chunks' sums added in order into a block's partial, the
    partials in block order -> (C, k)."""
    b, t, c = x.shape
    k = left + right + 1
    n = b * t
    xf, gf = x.reshape(n, c), dout.reshape(n, c)
    valid = torch.ones(n, dtype=torch.bool) if mask is None else mask.reshape(n)
    blocks = []
    for r_0 in range(0, n, 4 * rows):
        r_1 = min(r_0 + 4 * rows, n)
        sums = []
        for c0 in range(r_0, r_0 + 4 * rows, rows):
            c1 = min(c0 + rows, r_1)
            acc = torch.zeros(k, c)
            window = [torch.zeros(c) for _ in range(k)]
            for i in range(c1 - c0 + k - 1 if c1 > c0 else 0):
                f = c0 - left + i
                window[i % k] = xf[f] if 0 <= f < n else torch.zeros(c)
                if i < k - 1:
                    continue
                r = c0 + i - (k - 1)
                if not valid[r]:
                    continue
                for j in range(k):
                    if 0 <= r % t + j - left < t and valid[r + j - left]:
                        acc[j] += gf[r] * window[(i + 1 + j) % k]
            sums.append(acc)
        blocks.append(((sums[0] + sums[1]) + sums[2]) + sums[3])
    dw = blocks[0]
    for part in blocks[1:]:
        dw = dw + part
    return dw.T


@pytest.mark.parametrize("rows,lens", [
    (7, [20, 13, 0]),    # chunks end inside utterances and at 21, across the first boundary
    (4, [20, 20, 20]),   # a boundary every 5 chunks, no mask
    (16, None),          # a chunk across two boundaries
    (5, "holes"),        # a mask with holes inside the utterances
])
def test_fsmn_dw_walk_matches_plain(rows, lens):
    """The vector kernel's walk and sums give the plain version's weight gradient within
    FSMN_BWD_REL_TOL (relative L2), however chunks fall against utterances."""
    from funasr_tpu_torch.ops.fsmn import fsmn_memory_bwd_ref

    rng = np.random.default_rng(rows)
    b, t, c, left, right = 3, 20, 8, 5, 5
    x, dout = (torch.from_numpy(rng.standard_normal((b, t, c), dtype=np.float32))
               for _ in range(2))
    w = torch.from_numpy(rng.uniform(-0.5, 0.5, (c, 1, left + right + 1)).astype(np.float32))
    if lens == "holes":
        mask = torch.from_numpy(rng.random((b, t)) > 0.3)
    else:
        mask = None if lens is None else torch.arange(t)[None] < torch.tensor(lens)[:, None]
    want = fsmn_memory_bwd_ref(x, w, mask, left, right, dout)[1].reshape(c, -1)
    got = _fsmn_dw_like_the_kernel(x, dout, mask, left, right, rows)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= chip_smoke.FSMN_BWD_REL_TOL / 10, rel


@pytest.mark.parametrize("b,t,c,k,left,plan", [
    # the recipe's encoder batches: 4-row chunks, 4 a block, >= 2 blocks an SM-ish
    (5, 190, 512, 11, 5, (True, 4, (60, 11, 512))),
    (4, 237, 512, 11, 5, (True, 4, (60, 11, 512))),
    (3, 296, 512, 11, 5, (True, 4, (56, 11, 512))),
    # the decoder's (B, L + 1): the fewest rows a chunk
    (5, 49, 512, 11, 5, (True, 4, (16, 11, 512))),
    # a decode-sized batch: the most rows a chunk
    (32, 384, 512, 11, 5, (True, 16, (192, 11, 512))),
    # other pads, or C the 16-byte vectors do not tile: the generic kernel
    (5, 190, 512, 11, 10, (False, 80, (12, 11, 512))),
    (5, 190, 512, 21, 10, (False, 159, (6, 21, 512))),
    (5, 190, 510, 11, 5, (False, 80, (12, 11, 510))),
])
def test_fsmn_dw_plan(b, t, c, k, left, plan):
    from funasr_tpu_torch.ops.fsmn import DW_MAX_ROWS, DW_MIN_ROWS, dw_plan

    got = dw_plan(b, t, c, k, left, 132)
    assert got == plan
    if got[0]:
        assert DW_MIN_ROWS <= got[1] <= DW_MAX_ROWS
        assert got[2][0] == -(-(-(-(b * t) // got[1])) // 4)  # blocks of 4 chunks
        if b * t >= 888:  # the encoder's: every SM a block, 512 channels in 4 groups
            assert 4 * got[2][0] >= 132


def test_fsmn_dw_work():
    """The weight gradient's bytes (x and dout once, the mask, dw) and flops (2 k a
    value): at the recipe's (5, 190, 512), k 11, 3.9 MB, a 1.2 us bound."""
    n_bytes, n_ops = chip_smoke.fsmn_dw_work(5, 190, 512, 11)
    assert n_bytes == 4 * (2 * 950 * 512 + 512 * 11) + 950 and n_ops == 2 * 11 * 950 * 512
    ms, by = chip_smoke.bound_ms(n_bytes, n_ops, "fp32")
    assert round(ms * 1e3, 1) == 1.2 and by == "bytes"
