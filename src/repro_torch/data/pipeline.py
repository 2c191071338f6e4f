"""Deterministic, shard-aware synthetic LM data, as in the JAX package's
``data/pipeline.py``: the same ``np.random`` stream, so one
``(seed, step, shard)`` gives the port and the JAX package the same tokens,
labels and frontend embeddings.

The pipeline is a pure function of ``(seed, step, shard)``: a restarted job
resumes mid-epoch with no pipeline state in the checkpoint. A background
thread can keep batches ahead (``prefetching``). The stream is a
structured Markov-ish token process, so the cross-entropy has a learnable
signal.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    shard: int = 0  # data-parallel shard id
    n_shards: int = 1
    frontend_positions: int = 0  # for [audio]/[vlm] stubs
    d_model: int = 0
    device: Optional[str] = None  # the card unless "cpu"

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step, shard): ``tokens`` and ``labels``
        int64 [batch, seq] (and ``frontend_embeds`` f32) on the device."""
        dev = resolve_device(self.device)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.shard]))
        # structured stream: tokens follow t_{i+1} = (a*t_i + b + noise) % V
        a = 1 + 4 * (1 + self.shard)
        b = rng.integers(1, self.vocab, size=(self.batch, 1))
        t0 = rng.integers(0, self.vocab, size=(self.batch, 1))
        toks = [t0]
        for _ in range(self.seq):
            nxt = (a * toks[-1] + b) % self.vocab
            flip = rng.random((self.batch, 1)) < 0.1
            rand = rng.integers(0, self.vocab, size=(self.batch, 1))
            toks.append(np.where(flip, rand, nxt))
        stream = np.concatenate(toks, axis=1)
        out = {
            "tokens": torch.as_tensor(stream[:, : self.seq], dtype=torch.int64).to(dev),
            "labels": torch.as_tensor(stream[:, 1: self.seq + 1], dtype=torch.int64).to(dev),
        }
        if self.frontend_positions:
            out["frontend_embeds"] = torch.as_tensor(
                rng.standard_normal((self.batch, self.frontend_positions, self.d_model)),
                dtype=torch.float32).to(dev)
        return out

    def next_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self.batch_at(step)

    def prefetching(self, start_step: int = 0, depth: int = 2) -> Iterator:
        """``(step, batch)`` from ``start_step`` on, a producer thread
        ``depth`` batches ahead; closing the iterator stops the thread. An
        error in the producer is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            s = start_step
            try:
                while not stop.is_set():
                    put((s, self.batch_at(s)))
                    s += 1
            except Exception as e:  # noqa: BLE001  (raised by the consumer)
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
