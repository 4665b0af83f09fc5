"""Dataloader assembly, a copy of ``funasr_tpu/datasets/dataloader_entry.py`` (counterpart of FunASR ``funasr/datasets/dataloader_entry.py:54``
DataloaderMapStyle): builds train/valid datasets + samplers; plain-Python iteration
(audio decode is the only host work; features happen on device)."""

from __future__ import annotations

from typing import Iterator, Optional

from funasr_tpu_torch.register import tables


class DataLoader:
    def __init__(self, dataset, sampler, num_workers: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.num_workers = num_workers

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in self.sampler:
                    samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                    yield self.dataset.collator(samples)
        else:
            for batch_idx in self.sampler:
                yield self.dataset.collator([self.dataset[i] for i in batch_idx])

    def __len__(self):
        return len(self.sampler)


@tables.register("dataloader_classes", "DataloaderMapStyle")
class DataloaderMapStyle:
    def __init__(self, frontend=None, tokenizer=None, **kwargs):
        dataset_conf = dict(kwargs.get("dataset_conf", {}))
        # index_ds/batch sampling keys may live inside dataset_conf (the
        # reference template.yaml layout) or at the top level; dataset_conf wins
        index_ds = dataset_conf.get("index_ds", kwargs.get("index_ds",
                                                           "IndexDSJsonl"))
        dataset_cls = tables.dataset_classes[kwargs.get("dataset", "AudioDataset")]
        _loader_keys = ("speed_perturb", "index_ds", "batch_sampler",
                        "batch_size", "batch_type", "sort_size", "buffer_size",
                        "shuffle", "num_workers", "max_token_length")

        def build(path, is_training):
            ds = dataset_cls(
                index_ds=index_ds,
                index_ds_conf={"path": path, **kwargs.get("index_ds_conf", {})},
                tokenizer=tokenizer, frontend=frontend,
                speed_perturb=dataset_conf.get("speed_perturb", False) and is_training,
                **{k: v for k, v in dataset_conf.items()
                   if k not in _loader_keys})
            sampler_cls = tables.batch_sampler_classes[
                dataset_conf.get("batch_sampler", "BatchSampler")]
            sampler = sampler_cls(
                ds,
                batch_size=dataset_conf.get("batch_size", 16),
                batch_type=dataset_conf.get("batch_type", "example"),
                shuffle=is_training,
                rank=kwargs.get("rank", 0), world_size=kwargs.get("world_size", 1),
                max_token_length=dataset_conf.get("max_token_length"),
                sort_size=dataset_conf.get("sort_size",
                                           dataset_conf.get("buffer_size", 1024)))
            return DataLoader(ds, sampler,
                              num_workers=dataset_conf.get("num_workers", 0))

        self.train = build(kwargs.get("train_data_set_list"), True) \
            if kwargs.get("train_data_set_list") else None
        self.valid = build(kwargs.get("valid_data_set_list"), False) \
            if kwargs.get("valid_data_set_list") else None
