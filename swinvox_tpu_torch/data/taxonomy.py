"""Dataset index: a taxonomy JSON and the file system into sample records.

Counterpart of the ShapeNet part of ``swinvox_tpu/data/taxonomy.py``
(reference ``utils/data_loaders.py:95-161``): per-taxonomy sample lists
from the JSON, %-template paths, samples whose volume or every rendering
is missing skipped, views counted by listing the rendering folder.  The
Pascal3D and Pix3D indexes stay in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from enum import Enum, unique
from typing import Dict, List, Optional

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
        with open(paths.TAXONOMY_FILE_PATH, encoding="utf-8") as f:
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


DATASET_INDEX_MAPPING = {"ShapeNet": ShapeNetIndex}
