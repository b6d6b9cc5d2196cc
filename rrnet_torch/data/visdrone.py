"""VisDrone-DET dataset reader (port of `rrnet_tpu/data/visdrone.py`).

Folder layout `{root}/{split}/{images,annotations,roadmap}`, 8-column
csv annotations `(x, y, w, h, score, cls, truncation, occlusion)`, rows
with cls == 11 ("others") dropped, and an optional roadmap
(road-segmentation) image for the FillDuck copy-paste augmentation.
JPEGs are read through `data.jpeg`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from rrnet_torch.data import jpeg

VISDRONE_CLASS_NAMES = (
    "ignored-region", "pedestrian", "people", "bicycle", "car", "van",
    "truck", "tricycle", "awning-tricycle", "bus", "motor", "others",
)


def parse_annotation_file(path: str) -> np.ndarray:
    """Parse a VisDrone 8-column annotation txt -> (N, 8) float32.
    Tolerates trailing commas and missing columns; rows with cls == 11
    are removed."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().strip(",")
            if not line:
                continue
            vals = [float(v) for v in line.split(",")[:8]]
            if len(vals) < 8:
                vals = vals + [0.0] * (8 - len(vals))
            rows.append(vals)
    if not rows:
        return np.zeros((0, 8), np.float32)
    annos = np.asarray(rows, np.float32)
    return annos[annos[:, 5] != 11]


class VisDroneDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 with_road_map: bool = False):
        self.images_dir = os.path.join(root_dir, split, "images")
        self.annotations_dir = os.path.join(root_dir, split, "annotations")
        self.roadmap_dir = os.path.join(root_dir, split, "roadmap")
        self.names: List[str] = sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.images_dir)
            if f.endswith(".jpg"))
        self.with_road_map = with_road_map

    def __len__(self) -> int:
        return len(self.names)

    def load_image(self, name: str) -> np.ndarray:
        """(H, W, 3) uint8 RGB."""
        return jpeg.decode(os.path.join(self.images_dir, name + ".jpg"))

    def load_roadmap(self, name: str, hw: Tuple[int, int]) -> Optional[np.ndarray]:
        """Roadmap as float32 (H, W) in [0, 1] (channel 0 / 255); a
        missing file gives zeros."""
        path = os.path.join(self.roadmap_dir, name + ".jpg")
        if not os.path.exists(path):
            return np.zeros(hw, np.float32)
        return jpeg.decode(path)[:, :, 0].astype(np.float32) / 255.0

    def __getitem__(self, idx: int):
        name = self.names[idx]
        image = self.load_image(name)
        annos = parse_annotation_file(
            os.path.join(self.annotations_dir, name + ".txt"))
        roadmap = None
        if self.with_road_map:
            roadmap = self.load_roadmap(name, image.shape[:2])
        return {
            "name": name,
            "image": image.astype(np.float32) / 255.0,   # HWC RGB [0,1]
            "annos": annos,
            "roadmap": roadmap,
        }
