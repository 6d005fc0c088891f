"""Dataset indexes: a taxonomy JSON and the file system into sample records.

Counterpart of ``swinvox_tpu/data/taxonomy.py``, the reference's
``utils/data_loaders.py`` semantics:

  * ShapeNet (reference :95-161): per-taxonomy sample lists from the
    JSON, %-template paths, samples whose volume or every rendering is
    missing skipped, views counted by listing the rendering folder;
  * Pascal3D (reference :209-296): .mat annotations, the object of the
    largest bounding box, its box normalized by the image size, the
    volume of its CAD index;
  * Pix3D (reference :344-426): ``pix3d.json`` annotations keyed by image
    path, the box normalized, the volume path from the annotation's
    voxel path.

Pascal3D and Pix3D give one view per sample and a bounding box, which
the transforms crop around.  The default split files are read from the
repository's ``datasets/`` (``config.resolve_data_path``).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from enum import Enum, unique
from typing import Dict, List, Optional

import numpy as np

from swinvox_tpu_torch.config import resolve_data_path

log = logging.getLogger(__name__)


@unique
class DatasetType(Enum):
    TRAIN = 0
    TEST = 1
    VAL = 2


@dataclass
class SampleRecord:
    taxonomy_id: str
    taxonomy_name: str
    sample_name: str
    image_paths: List[str]
    volume_path: str
    bounding_box: Optional[List[float]] = None  # normalized [x0,y0,x1,y1]


@dataclass
class TaxonomyInfo:
    taxonomy_id: str
    taxonomy_name: str
    baselines: Dict[str, float] = field(default_factory=dict)


class ShapeNetIndex:
    """Index over a ShapeNet-format tree (taxonomy JSON + path templates)."""

    def __init__(self, cfg):
        paths = cfg.DATASETS.SHAPENET
        self.rendering_tpl = paths.RENDERING_PATH
        self.volume_tpl = paths.VOXEL_PATH
        with open(resolve_data_path(paths.TAXONOMY_FILE_PATH),
                  encoding="utf-8") as f:
            self.taxonomies = json.load(f)

    def taxonomy_info(self) -> Dict[str, TaxonomyInfo]:
        return {
            t["taxonomy_id"]: TaxonomyInfo(
                t["taxonomy_id"], t["taxonomy_name"], t.get("baseline", {}))
            for t in self.taxonomies
        }

    def samples(self, split: DatasetType) -> List[SampleRecord]:
        key = {DatasetType.TRAIN: "train", DatasetType.TEST: "test",
               DatasetType.VAL: "val"}[split]
        records: List[SampleRecord] = []
        for taxonomy in self.taxonomies:
            tid = taxonomy["taxonomy_id"]
            for sample_name in taxonomy.get(key, []):
                volume_path = self.volume_tpl % (tid, sample_name)
                if not os.path.exists(volume_path):
                    log.warning("Ignore sample %s/%s: volume file missing",
                                tid, sample_name)
                    continue
                folder = os.path.dirname(
                    self.rendering_tpl % (tid, sample_name, 0))
                try:
                    total_views = len(os.listdir(folder))
                except FileNotFoundError:
                    total_views = 0
                image_paths = [
                    p for p in (self.rendering_tpl % (tid, sample_name, i)
                                for i in range(total_views))
                    if os.path.exists(p)
                ]
                if not image_paths:
                    log.warning("Ignore sample %s/%s: no rendering images",
                                tid, sample_name)
                    continue
                records.append(SampleRecord(
                    taxonomy_id=tid,
                    taxonomy_name=taxonomy["taxonomy_name"],
                    sample_name=sample_name,
                    image_paths=image_paths,
                    volume_path=volume_path,
                ))
        log.info("Collected %d samples for split %s", len(records), key)
        return records


def _by_name(taxonomies) -> Dict[str, TaxonomyInfo]:
    return {
        t["taxonomy_name"]: TaxonomyInfo(
            t["taxonomy_name"], t["taxonomy_name"], t.get("baseline", {}))
        for t in taxonomies
    }


class Pascal3DIndex:
    """Index over PASCAL3D: one image per sample, bbox-guided crops."""

    def __init__(self, cfg):
        paths = cfg.DATASETS.PASCAL3D
        self.volume_tpl = paths.VOXEL_PATH
        self.annotation_tpl = paths.ANNOTATION_PATH
        self.rendering_tpl = paths.RENDERING_PATH
        with open(resolve_data_path(paths.TAXONOMY_FILE_PATH),
                  encoding="utf-8") as f:
            self.taxonomies = json.load(f)

    def taxonomy_info(self) -> Dict[str, TaxonomyInfo]:
        return _by_name(self.taxonomies)

    def samples(self, split: DatasetType) -> List[SampleRecord]:
        import scipy.io

        key = "train" if split == DatasetType.TRAIN else "test"
        records: List[SampleRecord] = []
        for taxonomy in self.taxonomies:
            tname = taxonomy["taxonomy_name"]
            for sample_name in taxonomy.get(key, []):
                image_path = self.rendering_tpl % (tname, sample_name)
                anno_path = self.annotation_tpl % (tname, sample_name)
                try:
                    mat = scipy.io.loadmat(anno_path, squeeze_me=True,
                                           struct_as_record=False)
                except FileNotFoundError:
                    log.warning("Ignore %s/%s: annotation missing", tname,
                                sample_name)
                    continue
                record = mat["record"]
                img_w, img_h = record.imgsize[0], record.imgsize[1]
                objects = record.objects
                if isinstance(objects, np.ndarray):
                    # the object of the largest box (reference :258-277)
                    best_area, bbox, cad_index = -1.0, None, -1
                    for obj in objects:
                        bb = obj.__dict__["bbox"]
                        area = (bb[2] - bb[0]) * (bb[3] - bb[1])
                        if area > best_area:
                            best_area, bbox, cad_index = (area, bb,
                                                          obj.cad_index)
                else:
                    bbox, cad_index = objects.bbox, objects.cad_index
                bbox = [bbox[0] / img_w, bbox[1] / img_h, bbox[2] / img_w,
                        bbox[3] / img_h]
                volume_path = self.volume_tpl % (tname, cad_index)
                if not os.path.exists(volume_path):
                    log.warning("Ignore %s/%s: volume missing", tname,
                                sample_name)
                    continue
                records.append(SampleRecord(
                    taxonomy_id=tname, taxonomy_name=tname,
                    sample_name=sample_name, image_paths=[image_path],
                    volume_path=volume_path, bounding_box=bbox))
        log.info("Collected %d samples for split %s", len(records), key)
        return records


class Pix3DIndex:
    """Index over Pix3D (test-only in the reference)."""

    def __init__(self, cfg):
        paths = cfg.DATASETS.PIX3D
        self.volume_tpl = paths.VOXEL_PATH
        self.rendering_tpl = paths.RENDERING_PATH
        with open(resolve_data_path(paths.TAXONOMY_FILE_PATH),
                  encoding="utf-8") as f:
            self.taxonomies = json.load(f)
        with open(paths.ANNOTATION_PATH, encoding="utf-8") as f:
            annotations = json.load(f)
        self.annotations = {}
        for anno in annotations:
            filename, _ = os.path.splitext(anno["img"])
            self.annotations[filename[4:]] = anno  # strip the 'img/' prefix

    def taxonomy_info(self) -> Dict[str, TaxonomyInfo]:
        return _by_name(self.taxonomies)

    def samples(self, split: DatasetType) -> List[SampleRecord]:
        key = "train" if split == DatasetType.TRAIN else "test"
        records: List[SampleRecord] = []
        for taxonomy in self.taxonomies:
            tname = taxonomy["taxonomy_name"]
            for sample_name in taxonomy.get(key, []):
                anno = self.annotations.get(f"{tname}/{sample_name}")
                if anno is None:
                    continue
                _, suffix = os.path.splitext(anno["img"])
                image_path = self.rendering_tpl % (tname, sample_name,
                                                   suffix[1:])
                img_w, img_h = anno["img_size"]
                box = anno["bbox"]
                bbox = [box[0] / img_w, box[1] / img_h, box[2] / img_w,
                        box[3] / img_h]
                parts = anno["voxel"].split("/")
                volume_file = parts[3][:-4].replace("voxel", "model")
                volume_path = self.volume_tpl % (tname, parts[2], volume_file)
                if not os.path.exists(volume_path):
                    log.warning("Ignore %s/%s: volume missing", tname,
                                sample_name)
                    continue
                records.append(SampleRecord(
                    taxonomy_id=tname, taxonomy_name=tname,
                    sample_name=sample_name, image_paths=[image_path],
                    volume_path=volume_path, bounding_box=bbox))
        log.info("Collected %d samples for split %s", len(records), key)
        return records


DATASET_INDEX_MAPPING = {
    "ShapeNet": ShapeNetIndex,
    "Pascal3D": Pascal3DIndex,
    "Pix3D": Pix3DIndex,
}
