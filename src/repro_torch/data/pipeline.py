"""Token data pipeline — a copy of the JAX package's ``data/pipeline.py``.

Two sources:
  * ``SyntheticSource`` — deterministic pseudo-corpus (a mixture of Zipfian
    unigrams and repeated n-gram motifs so models can actually learn
    something in the example runs);
  * ``BinTokenSource``  — memory-mapped flat uint16/uint32 token files
    (the standard pretraining-data layout).

The ``Batcher`` packs documents into fixed-length sequences and builds
next-token labels as numpy arrays; the trainer moves each batch to its
device.  The same seed gives the same token arrays as the JAX ``Batcher``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


class SyntheticSource:
    """Infinite deterministic token stream with learnable structure."""

    def __init__(self, vocab_size: int, seed: int = 0, motif_len: int = 8,
                 n_motifs: int = 64):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        # Zipfian unigram table
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.motifs = [self.rng.integers(0, vocab_size, size=motif_len)
                       for _ in range(n_motifs)]

    def stream(self) -> Iterator[np.ndarray]:
        while True:
            if self.rng.random() < 0.5:
                yield self.motifs[int(self.rng.integers(len(self.motifs)))]
            else:
                yield self.rng.choice(self.vocab, size=16, p=self.probs)


class BinTokenSource:
    """Flat binary token file, memory-mapped; loops forever."""

    def __init__(self, path: str, dtype=np.uint16, chunk: int = 4096):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.chunk = chunk

    def stream(self) -> Iterator[np.ndarray]:
        off = 0
        n = len(self.data)
        while True:
            end = min(off + self.chunk, n)
            yield np.asarray(self.data[off:end], dtype=np.int64)
            off = end if end < n else 0


@dataclasses.dataclass
class Batcher:
    """Fixed-length batch packer with a restorable stream position.

    ``start_batch`` is the data-pipeline position: iteration replays the
    source stream from the beginning (sources are deterministic given
    their construction args) and discards that many packed batches before
    yielding; ``at(n)`` builds the repositioned batcher.
    """
    source: object
    seq_len: int
    global_batch: int
    start_batch: int = 0

    def at(self, position: int) -> "Batcher":
        """This batcher repositioned to ``position`` packed batches in."""
        return dataclasses.replace(self, start_batch=position)

    def __iter__(self):
        buf = np.empty((0,), np.int64)
        stream = self.source.stream()
        need = self.global_batch * (self.seq_len + 1)
        position = 0
        while True:
            while len(buf) < need:
                buf = np.concatenate([buf, next(stream).astype(np.int64)])
            flat, buf = buf[:need], buf[need:]
            position += 1
            if position <= self.start_batch:
                continue
            grid = flat.reshape(self.global_batch, self.seq_len + 1)
            tokens = grid[:, :-1].astype(np.int32)
            labels = grid[:, 1:].astype(np.int32)
            yield {"tokens": tokens, "labels": labels}
