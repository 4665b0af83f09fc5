"""Data preparation CLIs, a copy of ``funasr_tpu/bin/data_tools.py`` (counterparts of
FunASR ``scp2jsonl.py``, ``jsonl2scp.py``, ``scp2len.py``,
``funasr/bin/compute_audio_cmvn.py``, ``funasr/bin/tokenize_text.py``); ``compute_cmvn``
runs the port's fbank and LFR on ``++device`` (default cuda; ``++device=cpu`` for the CPU).

Usage (``funasr-tpu-torch-data-tools`` is the console script of this module):
    python -m funasr_tpu_torch.bin.data_tools scp2jsonl ++scp_file_list='["wav.scp","text.txt"]' \
        ++data_type_list='["source","target"]' ++jsonl_file_out=out.jsonl
    python -m funasr_tpu_torch.bin.data_tools jsonl2scp ++jsonl_file_in=in.jsonl ++scp_file_out=...
    python -m funasr_tpu_torch.bin.data_tools compute_cmvn ++jsonl=train.jsonl ++out=am.mvn \
        ++dim=560 [++device=cpu]
"""

from __future__ import annotations

import json
import sys
from typing import List

import numpy as np


def _read_scp(path: str) -> dict:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def scp2jsonl(scp_file_list: List[str], data_type_list: List[str],
              jsonl_file_out: str, **kwargs):
    """wav.scp + text.txt -> jsonl with source/target (+lengths)."""
    from funasr_tpu_torch.utils.load_utils import load_audio

    maps = [_read_scp(p) for p in scp_file_list]
    keys = [k for k in maps[0] if all(k in m for m in maps)]
    with open(jsonl_file_out, "w", encoding="utf-8") as f:
        for k in keys:
            obj = {"key": k}
            for dtype, m in zip(data_type_list, maps):
                obj[dtype] = m[k]
                if dtype == "source":
                    try:
                        # 10 ms frames, matching the reference scp2jsonl.py
                        # (token batching and max_token_length budgets count
                        # frames, not samples)
                        obj["source_len"] = int(len(load_audio(m[k], fs=16000))
                                                // 160)
                    except Exception:  # noqa: BLE001
                        obj["source_len"] = -1
                elif dtype == "target":
                    obj["target_len"] = len(m[k].replace(" ", ""))
            f.write(json.dumps(obj, ensure_ascii=False) + "\n")
    print(f"wrote {len(keys)} lines to {jsonl_file_out}")


def jsonl2scp(jsonl_file_in: str, scp_file_out: str, data_type: str = "source",
              **kwargs):
    with open(jsonl_file_in, encoding="utf-8") as fin, \
            open(scp_file_out, "w", encoding="utf-8") as fout:
        for line in fin:
            obj = json.loads(line)
            fout.write(f"{obj.get('key')}\t{obj.get(data_type)}\n")
    print(f"wrote {scp_file_out}")


def compute_cmvn(jsonl: str, out: str, dim: int = 560, lfr_m: int = None,
                 lfr_n: int = None, n_mels: int = 80, max_utts: int = 5000,
                 device: str = "cuda", **kwargs):
    """Accumulate fbank+LFR stats over the corpus -> Kaldi-format am.mvn.

    The LFR stacking is inferred from ``dim`` (dim = n_mels * lfr_m) unless
    given explicitly: dim=560 -> the classic 7/6, dim=80 -> no LFR, dim=400 ->
    the VAD frontend's 5/1. The features are computed on ``device`` and summed there
    in float64.
    """
    import torch
    from funasr_tpu_torch.ops.fbank import fbank
    from funasr_tpu_torch.ops.lfr import apply_lfr_batch
    from funasr_tpu_torch.utils.load_utils import as_unit_f32, load_audio

    if lfr_m is None:
        assert dim % n_mels == 0, f"dim={dim} not a multiple of n_mels={n_mels}"
        lfr_m = dim // n_mels
    if lfr_n is None:
        lfr_n = {7: 6, 5: 1}.get(lfr_m, lfr_m)
    assert dim == n_mels * lfr_m, (dim, n_mels, lfr_m)

    dev = torch.device(device)
    total = torch.zeros((dim,), dtype=torch.float64, device=dev)
    total_sq = torch.zeros((dim,), dtype=torch.float64, device=dev)
    n = 0
    with open(jsonl, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i >= max_utts:
                break
            obj = json.loads(line)
            wav = torch.from_numpy(as_unit_f32(load_audio(obj["source"])) * 32768.0)
            fb = fbank(wav.to(dev), num_mel_bins=n_mels)
            frames = fb.shape[0]
            lfr, _ = apply_lfr_batch(fb[None], torch.tensor([frames], device=dev), lfr_m, lfr_n)
            feats = lfr[0, : -(-frames // lfr_n)].double()
            total += feats.sum(0)
            total_sq += (feats ** 2).sum(0)
            n += feats.shape[0]
    mean = total.cpu().numpy() / max(n, 1)
    var = total_sq.cpu().numpy() / max(n, 1) - mean ** 2
    add_shift = -mean
    rescale = 1.0 / np.sqrt(np.maximum(var, 1e-8))
    with open(out, "w", encoding="utf-8") as f:
        means = " ".join(f"{v:.8f}" for v in add_shift)
        istd = " ".join(f"{v:.8f}" for v in rescale)
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n"
                f"<AddShift> {dim} {dim}\n<LearnRateCoef> 0 [ {means} ]\n"
                f"<Rescale> {dim} {dim}\n<LearnRateCoef> 0 [ {istd} ]\n</Nnet>\n")
    print(f"cmvn over {n} frames -> {out}")


def tokenize_text(input: str, output: str = "-", token_type: str = "char",
                  tokenizer: str = None, tokenizer_conf=None,
                  write_vocabulary: bool = False, vocabulary_size: int = 0,
                  add_symbol=None, field: str = None, **kwargs):
    """Tokenize a text file line-by-line, or build a vocabulary
    (counterpart of ``funasr/bin/tokenize_text.py``: token_type char/word;
    write_vocabulary collects counts, caps at vocabulary_size, prepends
    ``add_symbol`` entries like "<blank>:0")."""
    import collections
    import sys as _sys

    def toks(line):
        if tokenizer:
            from funasr_tpu_torch.register import tables
            tok = tables.tokenizer_classes[tokenizer](**(tokenizer_conf or {}))
            return tok.ids2tokens(tok.encode(line)) if hasattr(tok, "encode") \
                else list(line)
        if token_type == "word":
            return line.split()
        return [c for c in line.replace(" ", "") ]

    out_f = _sys.stdout if output == "-" else open(output, "w", encoding="utf-8")
    counter = collections.Counter()
    with open(input, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if field:  # "2-" style: skip the utt-id column(s)
                start = int(field.split("-")[0]) - 1
                line = " ".join(line.split()[start:])
            t = toks(line)
            if write_vocabulary:
                counter.update(t)
            else:
                out_f.write(" ".join(t) + "\n")
    if write_vocabulary:
        symbols = [s.split(":")[0] for s in (add_symbol or [])]
        vocab = [w for w, _ in counter.most_common()]
        if vocabulary_size > 0:
            vocab = vocab[: max(vocabulary_size - len(symbols), 0)]
        for sym in symbols:
            out_f.write(sym + "\n")
        for w in vocab:
            out_f.write(w + "\n")
    if out_f is not _sys.stdout:
        out_f.close()


def scp2len(scp_file: str, out: str, fs: int = 16000, **kwargs):
    """wav.scp -> "utt n_samples" lines (counterpart of ``scp2len.py``)."""
    from funasr_tpu_torch.utils.load_utils import load_audio
    with open(scp_file, encoding="utf-8") as f, open(out, "w") as fo:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) != 2:
                continue
            fo.write(f"{parts[0]} {len(load_audio(parts[1], fs=fs))}\n")


def sensevoice2jsonl(scp_file_list: List[str], data_type_list: List[str],
                     jsonl_file_out: str, lid: str = "zh", emo: str = "NEUTRAL",
                     event: str = "Speech", with_itn: bool = False, **kwargs):
    """wav.scp + text (+ optional per-utt lid/emo/event scps) -> jsonl rows
    with the rich-tag fields SenseVoiceDataset consumes (counterpart of
    ``funasr/datasets/audio_datasets/sensevoice2jsonl.py``)."""
    import json as _json
    from funasr_tpu_torch.utils.load_utils import load_audio
    cols = {dt: _read_scp(scp) for dt, scp in zip(data_type_list,
                                                  scp_file_list)}
    src, tgt = cols["source"], cols.get("target", {})
    with open(jsonl_file_out, "w", encoding="utf-8") as fo:
        for key, wav in src.items():
            try:
                n = len(load_audio(wav, fs=16000))
            except Exception:  # noqa: BLE001 — skip unreadable rows like ref
                continue
            text = tgt.get(key, "")
            row = {"key": key, "source": wav, "source_len": n // 160,
                   "target": text, "target_len": len(text),
                   "lid": cols.get("lid", {}).get(key, lid),
                   "emo": cols.get("emo", {}).get(key, emo),
                   "event": cols.get("event", {}).get(key, event),
                   "with_itn": with_itn}
            fo.write(_json.dumps(row, ensure_ascii=False) + "\n")
    print(f"wrote {jsonl_file_out}: {len(src)} rows")


def export_itn_grammar(out: str = "itn_grammar.json", **kwargs):
    """Export the ITN grammar archive (FAR-export role; see
    ``funasr_tpu/text/export_grammar.py``)."""
    from funasr_tpu_torch.text.export_grammar import export_grammar
    archive = export_grammar(out)
    print(f"wrote {out}: {len(archive['languages'])} languages "
          f"(v{archive['version']})")


def main_cli():
    from funasr_tpu_torch.bin._overrides import parse_overrides
    assert len(sys.argv) > 1, __doc__
    cmd = sys.argv[1]
    cfg = parse_overrides(sys.argv[2:])
    fn = {"scp2jsonl": scp2jsonl, "jsonl2scp": jsonl2scp,
          "compute_cmvn": compute_cmvn, "tokenize_text": tokenize_text,
          "scp2len": scp2len, "export_itn_grammar": export_itn_grammar,
          "sensevoice2jsonl": sensevoice2jsonl}.get(cmd)
    assert fn is not None, f"unknown command {cmd}; {__doc__}"
    fn(**cfg)


if __name__ == "__main__":
    main_cli()
