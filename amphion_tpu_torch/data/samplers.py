"""Token-budget batching over a fixed ladder of padded lengths (the port's
copy of `LengthBucketSampler` of `amphion_tpu/data/samplers.py`).

Each batch is (indices, padded length), the padded length one of a
geometric ladder of buckets, so a run sees few batch shapes. The shuffle is
numpy's ``default_rng(seed)``, as in JAX, so that the same lengths and seed
give JAX's batches in JAX's order, epoch after epoch: each pass over the
sampler shuffles again from the same generator. The file's other samplers
(`ScheduledSampler`, `batch_by_size`, `VariableSampler`) are not ported.
"""

from __future__ import annotations

import numpy as np


class LengthBucketSampler:
    """Token-budget batching with padded lengths from a bucket ladder:
    ``max_tokens // bucket`` utterances a batch, grouped by length."""

    def __init__(self, lengths: list[int], max_tokens: int, bucket_growth: float = 1.3,
                 min_bucket: int = 128, shuffle: bool = True, seed: int = 0):
        self.lengths = np.asarray(lengths)
        self.max_tokens = max_tokens
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        # geometric bucket ladder covering [min_bucket, max length]
        buckets = [min_bucket]
        while buckets[-1] < self.lengths.max():
            buckets.append(int(np.ceil(buckets[-1] * bucket_growth)))
        self.buckets = np.asarray(buckets)

    def bucket_of(self, length: int) -> int:
        return int(self.buckets[np.searchsorted(self.buckets, length)])

    def __iter__(self):
        idx = np.argsort(self.lengths, kind="stable")  # group similar lengths
        by_bucket: dict[int, list[int]] = {}
        for i in idx:
            b = self.bucket_of(int(self.lengths[i]))
            by_bucket.setdefault(b, []).append(int(i))
        batches = []
        for b, members in by_bucket.items():
            bs = max(1, self.max_tokens // b)
            for k in range(0, len(members), bs):
                batches.append((members[k: k + bs], b))
        if self.shuffle:
            self._rng.shuffle(batches)
        yield from batches

    def __len__(self):
        by_bucket: dict[int, int] = {}
        for ln in self.lengths:
            b = self.bucket_of(int(ln))
            by_bucket[b] = by_bucket.get(b, 0) + 1
        return sum(-(-cnt // max(1, self.max_tokens // b)) for b, cnt in by_bucket.items())
