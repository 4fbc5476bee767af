"""Deterministic K-way partitioned datasets (paper §III.1).

The torch counterpart of ``repro.data.pipeline``.  The dataset D is split
into K non-overlapping equal-size partitions; ``(epoch, partition)`` maps
to examples through a seeded numpy generator, so every worker can
materialize any partition without coordination (two workers computing the
same partition see identical bytes).  The bytes are the reference's: the
same numpy draws, handed to torch with ``torch.from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PartitionedDataset", "SyntheticLMDataset",
           "SyntheticClassificationDataset"]


class PartitionedDataset:
    """Base: deterministic partition -> examples mapping."""

    def __init__(self, K: int, examples_per_partition: int, seed: int = 0,
                 device="cuda"):
        self.K = K
        self.n = examples_per_partition
        self.seed = seed
        self.device = torch.device(device)

    def partition(self, epoch: int, k: int):
        raise NotImplementedError


class SyntheticLMDataset(PartitionedDataset):
    """Procedural token sequences with learnable structure.

    Tokens follow a noisy Markov chain determined by the seed, giving the
    model something learnable (loss decreases) while being fully offline.
    """

    def __init__(self, K: int, examples_per_partition: int, seq_len: int,
                 vocab: int, seed: int = 0, device="cuda"):
        super().__init__(K, examples_per_partition, seed, device)
        self.seq_len = seq_len
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # sparse-ish transition table for structure
        self._trans = rng.integers(0, vocab, size=(vocab,)).astype(np.int64)

    def partition(self, epoch: int, k: int) -> dict:
        """``{'tokens', 'labels': (n, S) int32, 'weights': (n, S) float32}``
        on ``device``; weights sum to one, the last position has none."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 131_071 + k)
        B, S, V = self.n, self.seq_len, self.vocab
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, S)) < 0.15
        rand_tok = rng.integers(0, V, size=(B, S))
        for t in range(1, S):
            nxt = self._trans[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        w = np.ones((B, S), np.float32)
        w[:, -1] = 0.0                      # no target for last position
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(
                    self.device),
                "labels": torch.from_numpy(labels.astype(np.int32)).to(
                    self.device),
                "weights": torch.from_numpy(w / w.sum()).to(self.device)}


class SyntheticClassificationDataset(PartitionedDataset):
    """MNIST/CIFAR-like: gaussian-cluster images + teacher labels."""

    def __init__(self, K: int, examples_per_partition: int, dim: int = 784,
                 n_classes: int = 10, seed: int = 0, device="cuda"):
        super().__init__(K, examples_per_partition, seed, device)
        self.dim = dim
        self.n_classes = n_classes
        rng = np.random.default_rng(seed + 7)
        self._centers = rng.standard_normal((n_classes, dim)).astype(
            np.float32) * 2.0

    def partition(self, epoch: int, k: int) -> dict:
        """``{'x': (n, dim) float32, 'y': (n,) int32}`` on ``device``."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 131_071 + k)
        B = self.n
        y = rng.integers(0, self.n_classes, size=B)
        x = self._centers[y] + rng.standard_normal(
            (B, self.dim)).astype(np.float32)
        return {"x": torch.from_numpy(x).to(self.device),
                "y": torch.from_numpy(y.astype(np.int32)).to(self.device)}
