"""Cross-request dynamic batching for serving (the Triton-ensemble role; a copy of
``funasr_tpu/serving/batcher.py``).

The reference serves Paraformer under Triton with a BLS ensemble whose
``dynamic_batching`` block aggregates CONCURRENT client requests into one GPU
batch (FunASR ``runtime/triton_gpu/model_repo_paraformer_large_offline/
infer_pipeline/config.pbtxt``). Without it, concurrent clients serialize on
the forward and the batch dimension is wasted serving batch=1.

``BatchAggregator`` is the serving-side twin of ``AutoModel``'s
``batch_size_s`` batcher: requests arriving within ``max_wait_ms`` of each
other (or until ``max_batch`` fills) are decoded as ONE ``model.generate``
call; per-request kwargs (language/hotword/...) partition the batch so only
compatible requests share a forward. Padding to the shape-bucket grid happens
inside the model's bucketed decode, exactly as for file-list inputs.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict, List, Optional, Tuple


class BatchAggregator:
    """Micro-batching queue over a (threadsafe-called) ``model.generate``.

    One worker loop owns the model: it drains the request queue, waits up to
    ``max_wait_ms`` for co-batchable requests, groups them by kwargs
    signature, and runs one executor-side ``generate(input=[...])`` per group.
    """

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 15.0,
                 **generate_defaults):
        self.model = model
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max_wait_ms / 1000.0
        self.generate_defaults = generate_defaults
        self.queue: asyncio.Queue = asyncio.Queue()
        self._worker_task: Optional[asyncio.Task] = None
        # observability (docs/benchmarks.md load test + tests assert on these)
        self.n_requests = 0
        self.n_generate_calls = 0
        self.batch_sizes: List[int] = []

    async def submit(self, audio, **kwargs) -> Dict[str, Any]:
        """Queue one utterance; resolves to its result dict."""
        loop = asyncio.get_running_loop()
        if self._worker_task is None or self._worker_task.done():
            self._worker_task = loop.create_task(self._worker())
        fut: asyncio.Future = loop.create_future()
        sig = tuple(sorted(kwargs.items()))
        self.n_requests += 1
        await self.queue.put((audio, sig, kwargs, fut))
        return await fut

    async def _worker(self):
        loop = asyncio.get_running_loop()
        while True:
            first = await self.queue.get()
            batch = [first]
            deadline = loop.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    # drain whatever is already queued without waiting more
                    while (len(batch) < self.max_batch
                           and not self.queue.empty()):
                        batch.append(self.queue.get_nowait())
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self.queue.get(), timeout))
                except asyncio.TimeoutError:
                    break

            groups: Dict[Tuple, Tuple[list, list, dict]] = {}
            for audio, sig, kwargs, fut in batch:
                audios, futs, _ = groups.setdefault(sig, ([], [], kwargs))
                audios.append(audio)
                futs.append(fut)

            for audios, futs, kwargs in groups.values():
                self.n_generate_calls += 1
                self.batch_sizes.append(len(audios))
                merged = {**self.generate_defaults, **kwargs,
                          "batch_size": max(len(audios),
                                            self.generate_defaults.get(
                                                "batch_size", 1))}
                try:
                    results = await loop.run_in_executor(
                        None,
                        lambda a=audios, k=merged: self.model.generate(
                            input=list(a), **k))
                except Exception as exc:  # noqa: BLE001 — fan the error out
                    logging.exception("batched generate failed")
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(exc)
                    continue
                for i, fut in enumerate(futs):
                    if fut.done():
                        continue
                    if results and i < len(results):
                        fut.set_result(results[i])
                    else:
                        fut.set_result({"text": ""})

    def stats(self) -> Dict[str, Any]:
        sizes = self.batch_sizes
        return {
            "requests": self.n_requests,
            "generate_calls": self.n_generate_calls,
            "mean_batch": sum(sizes) / len(sizes) if sizes else 0.0,
            "max_batch_seen": max(sizes) if sizes else 0,
        }
