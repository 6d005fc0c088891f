"""Host data pipeline of evaluation: decode, transform, batch, prefetch.

Counterpart of the test split of ``swinvox_tpu/data/pipeline.py``: a
thread-pool producer decodes samples (PNG decode and numpy transforms
release the GIL) into batches that a bounded queue keeps ahead of the
consumer.  Test and validation samples take their first N views in file
order (reference ``utils/data_loaders.py:61-67``); images decode to
float32 BGR(A) / 255 and go through the eval transform.  The training
split (random views, augmentation, device augmentation) and multi-host
sharding come with ``train_net``.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from swinvox_tpu_torch.data import eval_transform, load_image_bgr
from swinvox_tpu_torch.data.binvox import read_as_3d_array
from swinvox_tpu_torch.data.taxonomy import (
    DATASET_INDEX_MAPPING,
    DatasetType,
    SampleRecord,
)

log = logging.getLogger(__name__)


def load_volume(path: str) -> np.ndarray:
    """Decodes a .binvox ground-truth volume to float32 {0, 1}."""
    with open(path, "rb") as f:
        return read_as_3d_array(f).data.astype(np.float32)


@dataclass
class Batch:
    taxonomy_ids: List[str]
    sample_names: List[str]
    images: np.ndarray  # [B, N, H, W, 3] float32, normalized
    volumes: np.ndarray  # [B, D, H, W] float32 {0, 1}


class VoxelDataset:
    """Decoded and transformed samples of an evaluation split."""

    def __init__(self, records: Sequence[SampleRecord], split: DatasetType,
                 n_views: int, cfg):
        if split == DatasetType.TRAIN:
            raise NotImplementedError(
                "the training split (random views, augmentation) is not "
                "ported yet")
        self.records = list(records)
        self.split = split
        self.n_views = n_views
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.records)

    def load(self, idx: int) -> Tuple[str, str, np.ndarray, np.ndarray]:
        rec = self.records[idx]
        paths = rec.image_paths[: self.n_views]
        images = np.stack([load_image_bgr(p) for p in paths])
        images = eval_transform(images, self.cfg, rec.bounding_box)
        return (rec.taxonomy_id, rec.sample_name, images,
                load_volume(rec.volume_path))


def _put_unless_stopped(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Blocking put that gives up (returns False) once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class BatchLoader:
    """In-order batch iterator over a VoxelDataset: a thread pool decodes
    samples and a bounded queue keeps ``prefetch`` batches ready."""

    def __init__(self, dataset: VoxelDataset, batch_size: int,
                 num_workers: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.dataset))
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble(idxs: np.ndarray) -> Batch:
            tax, names, images, volumes = zip(
                *(self.dataset.load(int(i)) for i in idxs))
            return Batch(list(tax), list(names), np.stack(images),
                         np.stack(volumes))

        def producer():
            # a bounded window of futures, so the pool never races ahead
            # of the consumer with decoded batches piling up in memory
            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending = collections.deque()
                it = iter(batches)
                try:
                    while True:
                        while len(pending) < window:
                            b = next(it, None)
                            if b is None:
                                break
                            pending.append(pool.submit(assemble, b))
                        if not pending:
                            break
                        result = pending.popleft().result()
                        if stop.is_set() or not _put_unless_stopped(
                                out_q, result, stop):
                            for f in pending:
                                f.cancel()
                            return
                except Exception as e:  # surface worker errors
                    _put_unless_stopped(out_q, e, stop)
                    return
            _put_unless_stopped(out_q, None, stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def build_loader(cfg, split: DatasetType) -> BatchLoader:
    """Index -> dataset -> loader for an evaluation split of
    ``DATASET.TEST_DATASET`` with ``CONST.N_VIEWS_RENDERING`` views, in
    batches of 1 as the JAX ``build_loader`` has it outside training (the
    evaluator regroups samples into its own batches)."""
    index = DATASET_INDEX_MAPPING[cfg.DATASET.TEST_DATASET](cfg)
    dataset = VoxelDataset(index.samples(split), split,
                           cfg.CONST.N_VIEWS_RENDERING, cfg)
    return BatchLoader(dataset, batch_size=1,
                       num_workers=cfg.CONST.NUM_WORKER)
