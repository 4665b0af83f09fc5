"""Jsonl index datasets, a copy of ``funasr_tpu/datasets/audio_datasets/index_ds.py`` (reference: ``funasr/datasets/audio_datasets/index_ds.py:13``
— lines of {"source", "target", "source_len", "target_len"}; rank-split sharding for
large corpora)."""

from __future__ import annotations

import json
from typing import List

from funasr_tpu_torch.register import tables


@tables.register("index_ds_classes", "IndexDSJsonl")
@tables.register("index_ds_classes", "IndexDSJsonlRankFull")
class IndexDSJsonl:
    """Loads every line on every rank (rank-full)."""

    def __init__(self, path, **kwargs):
        self.contents: List[dict] = []
        paths = path if isinstance(path, (list, tuple)) else [path]
        for p in paths:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    # keep every extra field (system/user/assistant turn
                    # lists, hotword/emo/lid tags …) for specialized packs —
                    # the reference index also hands the full row through
                    row = dict(obj)
                    row.update({
                        "source": obj["source"],
                        "target": obj.get("target", ""),
                        "source_len": int(obj.get("source_len", -1)),
                        "target_len": int(obj.get("target_len", -1)),
                        "key": obj.get("key"),
                    })
                    self.contents.append(row)

    def __len__(self):
        return len(self.contents)

    def __getitem__(self, idx):
        return self.contents[idx]


@tables.register("index_ds_classes", "IndexDSJsonlRankSplit")
class IndexDSJsonlRankSplit(IndexDSJsonl):
    """Each rank keeps a contiguous 1/world_size shard (for very large corpora)."""

    def __init__(self, path, rank: int = 0, world_size: int = 1, **kwargs):
        super().__init__(path, **kwargs)
        n = len(self.contents)
        per = -(-n // world_size)
        self.contents = self.contents[rank * per: (rank + 1) * per]
