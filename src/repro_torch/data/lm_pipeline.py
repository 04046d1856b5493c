"""Deterministic, sharded LM token pipeline.

A copy of ``repro/data/lm_pipeline.py`` (numpy only); ``batch(step)`` is
the reference's, bit for bit.

Fault-tolerance property: batch(step, shard) is a pure function of
(seed, step, shard) — any host can recompute any shard's data after a
failover, so checkpoint/restart never loses or duplicates samples and no
data-state needs checkpointing beyond the step counter. This is the
standard design for 1000+-node determinism (cf. MaxText's grain indices).

Source: a synthetic Zipf-distributed token stream with a Markov flavor so
a real LM loss signal exists (perplexity decreases under training), plus a
double-buffered host prefetcher to overlap host data generation with device
steps (straggler mitigation at the input layer).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, n_shards: int = 1, shard: int = 0, seed: int = 0):
        assert global_batch % n_shards == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // n_shards
        self.n_shards = n_shards
        self.shard = shard
        self.seed = seed
        # Zipf-ish unigram with Markov "bigram bonus" for learnable structure
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks ** 1.1)
        self._unigram /= self._unigram.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        base = rng.choice(v, size=(b, s + 1), p=self._unigram)
        # Markov structure: with p=0.5 the next token is a deterministic
        # function of the previous one -> learnable signal
        follow = (base[:, :-1] * 7 + 11) % v
        mask = rng.random((b, s)) < 0.5
        tokens = base[:, :-1].copy()
        labels = np.where(mask, follow, base[:, 1:])
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def prefetch(self, start_step: int, depth: int = 2):
        """Background-thread prefetch iterator (double buffering)."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put((step, self.batch(step)))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()

        class _Iter:
            def __iter__(self):
                return self

            def __next__(self):
                return q.get()

            def close(self):
                stop.set()
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass

        return _Iter()
