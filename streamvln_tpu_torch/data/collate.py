"""Batch collation: samples -> static-shape batch, plus the samplers and
dataset wrappers of the training data pipeline.

Own copy of `streamvln_tpu/data/collate.py` (reference collate_fn:
streamvln/dataset/vln_action_dataset.py:804-825). The splice layouts are
built here on the host: the expanded sequence is padded to a length
bucket and the frame axis to the batch max (padded frames are encoded
but never gathered).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.models.streamvln import (build_splice_layout,
                                                  stack_layouts)
from streamvln_tpu_torch.utils.constants import (IMAGE_TOKEN_INDEX,
                                                 MEMORY_TOKEN_INDEX)

DEFAULT_LENGTH_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"sequence of {n} exceeds largest bucket "
                     f"{max(buckets)}")


def collate(samples: List[dict], cfg: StreamVLNConfig,
            length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS,
            max_length: Optional[int] = None,
            pad_frames_to: Optional[int] = None) -> dict:
    """Samples from VLNActionDataset (or vln_sample) -> batch dict of numpy
    arrays for parallel.train.make_train_step. A sample's `images` may be
    a numpy array or a tensor ([V, S, S, 3]); the batch's images are then
    the same kind."""
    tpf = cfg.tokens_per_frame
    expanded = []
    for s in samples:
        ids = s["input_ids"]
        if max_length is not None:
            ids = ids[:max_length]
        n = 0
        for t in ids.tolist():
            if t == IMAGE_TOKEN_INDEX:
                n += tpf
            elif t == MEMORY_TOKEN_INDEX:
                n += cfg.num_history * tpf
            else:
                n += 1
        expanded.append(n)
    bucket = pick_bucket(max(expanded), length_buckets)

    layouts = []
    for s in samples:
        ids, labels = s["input_ids"], s["labels"]
        if max_length is not None:
            ids, labels = ids[:max_length], labels[:max_length]
        layouts.append(build_splice_layout(
            ids, cfg, labels=labels, pad_to=bucket,
            max_frames=len(s["images"])))

    batch = stack_layouts(layouts)
    del batch["lengths"]

    V_max = pad_frames_to or max(len(s["images"]) for s in samples)
    first = samples[0]["images"]
    if isinstance(first, np.ndarray):
        images = np.zeros((len(samples), V_max) + first.shape[1:],
                          np.float32)
    else:
        images = first.new_zeros((len(samples), V_max) + first.shape[1:])
    for i, s in enumerate(samples):
        v = len(s["images"])
        assert v <= V_max, (v, V_max)
        images[i, :v] = s["images"]
    batch["images"] = images

    tmax = max(len(s["time_ids"]) for s in samples)
    time_ids = np.full((len(samples), tmax), -1, np.int32)
    for i, s in enumerate(samples):
        time_ids[i, : len(s["time_ids"])] = s["time_ids"]
    batch["time_ids"] = time_ids
    batch["task_type"] = np.asarray([s["task_id"] for s in samples],
                                    np.int32)
    return batch


class TaskGroupedBatchSampler:
    """Each global batch draws from ONE task (co-training sampler parity;
    reference: llava/train/llava_trainer.py:128-154)."""

    def __init__(self, task_ids: Sequence[int], batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        self.task_ids = np.asarray(task_ids)
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        batches = []
        for task in np.unique(self.task_ids):
            idx = np.flatnonzero(self.task_ids == task)
            rng.shuffle(idx)
            n_full = len(idx) // self.batch_size
            for b in range(n_full):
                batches.append(
                    idx[b * self.batch_size:(b + 1) * self.batch_size])
            if not self.drop_last and len(idx) % self.batch_size:
                batches.append(idx[n_full * self.batch_size:])
        for i in rng.permutation(len(batches)):
            yield list(map(int, batches[i]))

    def __len__(self):
        n = 0
        for task in np.unique(self.task_ids):
            c = int((self.task_ids == task).sum())
            n += c // self.batch_size if self.drop_last else \
                -(-c // self.batch_size)
        return n


class LengthGroupedBatchSampler:
    """Group similarly-sized samples into batches to minimise padding
    (reference: llava/train/llava_trainer.py:223-268). Batches are built
    from megachunks sorted by length, then shuffled."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 seed: int = 0, mega_factor: int = 50):
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.seed = seed
        self.mega = batch_size * mega_factor

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(len(self.lengths))
        batches = []
        for start in range(0, len(order), self.mega):
            chunk = order[start: start + self.mega]
            chunk = chunk[np.argsort(self.lengths[chunk])[::-1]]
            for b in range(0, len(chunk), self.batch_size):
                batch = chunk[b: b + self.batch_size]
                if len(batch) == self.batch_size:
                    batches.append(batch)
        for i in rng.permutation(len(batches)):
            yield list(map(int, batches[i]))

    def __len__(self):
        n = 0
        for start in range(0, len(self.lengths), self.mega):
            n += min(self.mega,
                     len(self.lengths) - start) // self.batch_size
        return n


class RobustDataset:
    """Retry ladder around a flaky __getitem__ (corrupt images, transient
    file-system errors): 3 tries on the same index, then 3 on neighbouring
    indices, then raise (reference: streamvln_train.py:1109-1140)."""

    def __init__(self, dataset, same_retries: int = 3,
                 neighbor_retries: int = 3):
        self.dataset = dataset
        self.same_retries = same_retries
        self.neighbor_retries = neighbor_retries

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __getitem__(self, i: int):
        last: Exception = None
        for _ in range(self.same_retries):
            try:
                return self.dataset[i]
            except Exception as e:  # noqa: BLE001 — retry ladder
                last = e
        for step in range(1, self.neighbor_retries + 1):
            j = (i + step) % len(self.dataset)
            try:
                return self.dataset[j]
            except Exception as e:  # noqa: BLE001
                last = e
        raise RuntimeError(
            f"sample {i} and {self.neighbor_retries} neighbours all "
            f"failed") from last


class CombineDataset:
    """Concatenation of task datasets (reference:
    streamvln_train.py:902-931)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i: int):
        ds_idx = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[ds_idx][i - int(self._offsets[ds_idx])]

    @property
    def task_ids(self) -> np.ndarray:
        out = []
        for d in self.datasets:
            out.extend([d.task_id] * len(d))
        return np.asarray(out)
