"""Datasets (the port's copy of the online part of
`amphion_tpu/data/dataset.py`): `SegmentAudioDataset` serves fixed-length
numpy waveform crops (random offsets in clips longer than a segment, zero
padding of shorter ones), whose spectral features the trainers' batch
makers compute on the device; `pad_batch` stacks variable-length arrays
(the TTS trainers' phone rows); `Prefetcher` makes the next batches on a
background thread.
"""

from __future__ import annotations

import queue
import threading
import numpy as np

from amphion_tpu_torch.data.audio_io import load_wav
from amphion_tpu_torch.data.metadata import Utterance


class SegmentAudioDataset:
    """Random fixed-length segments from a list of utterances; short clips
    are zero-padded to the segment length."""

    def __init__(self, utterances: list[Utterance], sample_rate: int,
                 segment_samples: int, seed: int = 0):
        self.utts = utterances
        self.sample_rate = sample_rate
        self.segment_samples = segment_samples
        self._rng = np.random.default_rng(seed)
        self._cache: dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.utts)

    def audio(self, i: int) -> np.ndarray:
        if i not in self._cache:
            x, _ = load_wav(self.utts[i].path, sr=self.sample_rate)
            self._cache[i] = x
        return self._cache[i]

    def __getitem__(self, i: int) -> dict:
        return self.segment(i, self._rng)

    def segment(self, i: int, rng: np.random.Generator) -> dict:
        """Utterance ``i``'s segment, a longer clip cropped at an offset
        drawn from ``rng``."""
        x = self.audio(i)
        seg = self.segment_samples
        if len(x) <= seg:
            out = np.zeros(seg, np.float32)
            out[: len(x)] = x
        else:
            start = int(rng.integers(0, len(x) - seg))
            out = x[start: start + seg]
        return {"audio": out, "uid": self.utts[i].uid}


def pad_batch(arrays: list[np.ndarray], target_len: int | None = None, axis: int = 0):
    """Stack variable-length arrays with zero padding; returns (batch, lengths)."""
    lengths = np.asarray([a.shape[axis] for a in arrays], np.int32)
    t = int(target_len if target_len is not None else lengths.max())
    out = []
    for a in arrays:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, t - a.shape[axis])
        out.append(np.pad(a, pad))
    return np.stack(out), lengths


class Prefetcher:
    """Make the next ``depth`` batches on a background thread while the
    current one is consumed. Closing the iterator early (a run that ends
    inside an epoch) stops the thread and waits for it."""

    def __init__(self, iterator_fn, depth: int = 2):
        self._fn = iterator_fn
        self._depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        done = object()
        error: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._fn():
                    if not put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=60)
