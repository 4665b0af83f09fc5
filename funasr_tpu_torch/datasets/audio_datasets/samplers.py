"""Batch samplers, a copy of ``funasr_tpu/datasets/audio_datasets/samplers.py``: the same
seed gives the same batches (counterpart of FunASR ``funasr/datasets/audio_datasets/
samplers.py:14-539``): example-count batching and length-buffered dynamic token
batching (``batch_type: token``), with rank sharding for data parallelism."""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from funasr_tpu_torch.register import tables


@tables.register("batch_sampler_classes", "BatchSampler")
class BatchSampler:
    def __init__(self, dataset, batch_size: int = 16, batch_type: str = "example",
                 shuffle: bool = True, drop_last: bool = False, rank: int = 0,
                 world_size: int = 1, seed: int = 0, sort_size: int = 1024,
                 **kwargs):
        self.dataset = dataset
        self.batch_size = batch_size
        self.batch_type = batch_type
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.sort_size = sort_size
        # drop overlong samples (reference dataset_conf.max_token_length:
        # filter if source_token_len + target_token_len exceeds it)
        self.max_token_length = kwargs.get("max_token_length")
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batches(self) -> List[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.max_token_length:
            gtl = getattr(self.dataset, "get_target_len", None)
            order = np.asarray(
                [i for i in order
                 if self.dataset.get_source_len(i)
                 + (gtl(i) if gtl else 0) <= self.max_token_length],
                dtype=np.int64)
            n = len(order)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        batches: List[List[int]] = []
        if self.batch_type == "example":
            for i in range(0, n, self.batch_size):
                batches.append(list(order[i: i + self.batch_size]))
        else:  # token: buffer, sort by length, fill to token budget
            for i in range(0, n, self.sort_size):
                buf = sorted(order[i: i + self.sort_size],
                             key=self.dataset.get_source_len)
                cur: List[int] = []
                max_len = 0
                for idx in buf:
                    sl = self.dataset.get_source_len(idx)
                    potential = max(max_len, sl) * (len(cur) + 1)
                    if cur and potential > self.batch_size:
                        batches.append(cur)
                        cur, max_len = [], 0
                    cur.append(int(idx))
                    max_len = max(max_len, sl)
                if cur:
                    batches.append(cur)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch + 1)
                rng.shuffle(batches)
        if self.drop_last and batches and len(batches[-1]) < 2:
            batches = batches[:-1]
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        batches = self._batches()
        # rank sharding: every rank sees the same number of batches
        usable = len(batches) - len(batches) % self.world_size \
            if self.world_size > 1 else len(batches)
        for i in range(self.rank, usable, self.world_size):
            yield batches[i]

    def __len__(self):
        batches = self._batches()
        if self.world_size > 1:
            return len(batches) // self.world_size
        return len(batches)


@tables.register("batch_sampler_classes", "CustomDistributedBufferDynamicBatchSampler")
class CustomDistributedBufferDynamicBatchSampler(BatchSampler):
    """Alias with token batching defaults (the reference's production sampler,
    ``samplers.py:397``)."""

    def __init__(self, dataset, batch_size: int = 6000, batch_type: str = "token",
                 buffer_size: int = 1024, **kwargs):
        kwargs.pop("sort_size", None)
        super().__init__(dataset, batch_size=batch_size, batch_type=batch_type,
                         sort_size=buffer_size, **kwargs)
