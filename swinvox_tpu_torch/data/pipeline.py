"""Host data pipeline: decode, transform, batch, prefetch.

Counterpart of ``swinvox_tpu/data/pipeline.py`` for one process (its
multi-host sharding is not ported): a thread-pool producer decodes
samples (PNG decode and numpy transforms release the GIL) into batches
that a bounded queue keeps ahead of the consumer.  Images decode to
float32 BGR(A) / 255.

Views (reference ``utils/data_loaders.py:61-67``): each sample draws its
own generator ``default_rng(SeedSequence([seed, epoch, idx]))``; the
train split chooses ``n_views`` of the sample's renderings without
replacement from it and feeds the same generator to the train transform
(and, with ``DIR.RANDOM_BG_PATH``, to the choice of a background image
first); validation and test take the first ``n_views`` in file order
through the eval transform.  The train loader shuffles with
``default_rng(SeedSequence([seed, epoch]))`` and drops the last partial
batch; ``set_epoch`` and ``set_n_views`` move both, so a resumed run
draws what an uninterrupted one draws.

Under ``TRAIN.DEVICE_AUGMENT`` (every split of a source without bounding
boxes, and without ``DIR.RANDOM_BG_PATH``; otherwise the host transform
stays) a sample is decoded only (``VoxelDataset.load_raw``): its raw
renders ship as uint8 with the augmentation's parameters drawn from the
same generator in the same order, stacked into ``Batch.aug``, for
``data/device_augment.py`` to apply on the card.

An iteration's producer thread and its pool stop when the iterator is
closed, garbage-collected or raises, or when ``BatchLoader.close`` is
called (``train_net`` closes its loaders in a ``finally``).
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from swinvox_tpu_torch.data import load_image_bgr
from swinvox_tpu_torch.data.binvox import read_as_3d_array
from swinvox_tpu_torch.data.taxonomy import (
    DATASET_INDEX_MAPPING,
    DatasetType,
    SampleRecord,
)
from swinvox_tpu_torch.data.transforms import (
    draw_eval_params,
    draw_train_params,
    eval_transform,
    train_transform,
)

log = logging.getLogger(__name__)


def load_volume(path: str) -> np.ndarray:
    """Decodes a ground-truth volume (.binvox, or .mat with a ``Volume``)
    to float32."""
    if path.endswith(".mat"):
        import scipy.io

        return scipy.io.loadmat(path)["Volume"].astype(np.float32)
    with open(path, "rb") as f:
        return read_as_3d_array(f).data.astype(np.float32)


@dataclass
class Batch:
    taxonomy_ids: List[str]
    sample_names: List[str]
    # [B, N, H, W, 3] float32, normalized; under device augmentation the
    # raw decoded [B, N, H, W, 3|4] as uint8
    images: np.ndarray
    volumes: np.ndarray  # [B, D, H, W] float32 {0, 1}
    # device augmentation only: bg_color [B, 3], color_A/B [B, 3, 3],
    # color_v [B, 3], flips [B, N] (data/device_augment.py)
    aug: Optional[dict] = None


class VoxelDataset:
    """Decoded and transformed samples of one split."""

    def __init__(self, records: Sequence[SampleRecord], split: DatasetType,
                 n_views: int, cfg, train_augment: bool = False,
                 seed: int = 0, device_augment: bool = False):
        self.records = list(records)
        self.split = split
        self.n_views = n_views
        self.cfg = cfg
        self.train_augment = train_augment
        self.seed = seed
        self.device_augment = device_augment
        self.bg_files: List[str] = []
        if train_augment and cfg.DIR.RANDOM_BG_PATH:
            root = cfg.DIR.RANDOM_BG_PATH
            try:
                self.bg_files = [os.path.join(root, f)
                                 for f in sorted(os.listdir(root))]
            except OSError:
                log.warning("RANDOM_BG_PATH %s unreadable; using solid "
                            "colors", root)

    def __len__(self) -> int:
        return len(self.records)

    def set_n_views(self, n_views: int) -> None:
        self.n_views = n_views

    def _select_views(self, rec: SampleRecord, idx: int, epoch: int
                      ) -> Tuple[np.random.Generator, List[str]]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        if self.split == DatasetType.TRAIN:
            chosen = rng.choice(len(rec.image_paths), size=self.n_views,
                                replace=False)
            return rng, [rec.image_paths[i] for i in chosen]
        return rng, rec.image_paths[: self.n_views]

    def load(self, idx: int, epoch: int = 0
             ) -> Tuple[str, str, np.ndarray, np.ndarray]:
        rec = self.records[idx]
        rng, paths = self._select_views(rec, idx, epoch)
        images = np.stack([load_image_bgr(p) for p in paths])
        volume = load_volume(rec.volume_path)
        if self.train_augment:
            bg_image = None
            if self.bg_files:
                bg_image = load_image_bgr(
                    self.bg_files[int(rng.integers(len(self.bg_files)))])
            images = train_transform(images, self.cfg, rng, rec.bounding_box,
                                     bg_image=bg_image)
        else:
            images = eval_transform(images, self.cfg, rec.bounding_box)
        return rec.taxonomy_id, rec.sample_name, images, volume

    def load_raw(self, idx: int, epoch: int = 0
                 ) -> Tuple[str, str, np.ndarray, np.ndarray, dict]:
        """Decode only, for the augmentation on the card: the views as
        uint8 (``round(x * 255)`` inverts the decoder's /255 for 8-bit
        sources), the volume, and the parameters ``load`` would draw from
        the same generator (``draw_train_params`` for the train split,
        ``draw_eval_params`` otherwise).  Refuses a bounding box and
        background images, as the JAX package does."""
        rec = self.records[idx]
        if rec.bounding_box is not None:
            raise ValueError(
                "device_augment does not support bbox-cropped sources")
        if self.bg_files:
            raise ValueError(
                "device_augment does not support RANDOM_BG_PATH images")
        rng, paths = self._select_views(rec, idx, epoch)
        images = np.stack([load_image_bgr(p) for p in paths])
        volume = load_volume(rec.volume_path)
        draw = draw_train_params if self.train_augment else draw_eval_params
        params = draw(self.cfg, rng, self.n_views,
                      has_alpha=images.shape[-1] == 4)
        images = np.round(images * 255.0).astype(np.uint8)
        return rec.taxonomy_id, rec.sample_name, images, volume, params


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
    """Batch iterator over a VoxelDataset: a thread pool decodes samples
    and a bounded queue keeps ``prefetch`` batches ready; shuffled by
    ``(seed, epoch)`` and without the last partial batch when asked."""

    def __init__(self, dataset: VoxelDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.epoch = 0
        self._live: List[Tuple[threading.Event, threading.Thread]] = []
        self._live_lock = threading.Lock()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batch_indices(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def close(self) -> None:
        """Stops every iteration still running and joins its producer."""
        with self._live_lock:
            live, self._live = self._live, []
        for stop, thread in live:
            stop.set()
        for stop, thread in live:
            if thread is not threading.current_thread():
                thread.join()

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        epoch = self.epoch
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def assemble(idxs: np.ndarray) -> Batch:
            if self.dataset.device_augment:
                tax, names, images, volumes, params = zip(
                    *(self.dataset.load_raw(int(i), epoch) for i in idxs))
                aug = {k: np.stack([p[k] for p in params])
                       for k in params[0]}
                return Batch(list(tax), list(names), np.stack(images),
                             np.stack(volumes), aug)
            tax, names, images, volumes = zip(
                *(self.dataset.load(int(i), epoch) for i in idxs))
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
                    while not stop.is_set():
                        while len(pending) < window:
                            b = next(it, None)
                            if b is None:
                                break
                            pending.append(pool.submit(assemble, b))
                        if not pending:
                            _put_unless_stopped(out_q, None, stop)
                            return
                        result = pending.popleft().result()
                        if not _put_unless_stopped(out_q, result, stop):
                            return
                except Exception as e:  # surface worker errors
                    _put_unless_stopped(out_q, e, stop)
                finally:
                    for f in pending:
                        f.cancel()

        thread = threading.Thread(target=producer, daemon=True,
                                  name="BatchLoader")
        with self._live_lock:
            self._live.append((stop, thread))
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
            with self._live_lock:
                if (stop, thread) in self._live:
                    self._live.remove((stop, thread))


def build_loader(cfg, split: DatasetType, n_views: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 dataset_name: Optional[str] = None,
                 seed: int = 0) -> BatchLoader:
    """Index -> dataset -> loader for a split, as the JAX ``build_loader``
    builds it: the train split of ``DATASET.TRAIN_DATASET`` in shuffled
    batches of ``CONST.BATCH_SIZE`` without the last partial one, the
    others of ``DATASET.TEST_DATASET`` in file order in batches of 1 (the
    evaluator regroups samples into its own batches); ``n_views`` defaults
    to ``CONST.N_VIEWS_RENDERING``.  ``TRAIN.DEVICE_AUGMENT`` ships raw
    batches wherever the source allows it (no bounding box, no
    ``DIR.RANDOM_BG_PATH``)."""
    train = split == DatasetType.TRAIN
    if dataset_name is None:
        dataset_name = (cfg.DATASET.TRAIN_DATASET if train
                        else cfg.DATASET.TEST_DATASET)
    index = DATASET_INDEX_MAPPING[dataset_name](cfg)
    records = index.samples(split)
    device_aug = (cfg.TRAIN.DEVICE_AUGMENT and not cfg.DIR.RANDOM_BG_PATH
                  and all(r.bounding_box is None for r in records))
    dataset = VoxelDataset(records, split,
                           n_views or cfg.CONST.N_VIEWS_RENDERING, cfg,
                           train_augment=train, seed=seed,
                           device_augment=device_aug)
    return BatchLoader(
        dataset, batch_size=batch_size or (cfg.CONST.BATCH_SIZE if train
                                           else 1),
        shuffle=train, drop_last=train, num_workers=cfg.CONST.NUM_WORKER,
        seed=seed)
