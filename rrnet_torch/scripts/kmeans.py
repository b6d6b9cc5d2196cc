"""Anchor priors by k-means over the training GT sizes (port of
`scripts/kmeans.py`; the reference's VisDrone result: heights {20.38,
73.23, 182.68}, widths {21.98, 63.83, 155.88}):

    python -m rrnet_torch.scripts.kmeans [--config retinanet] [--k 3]
        [--batches 200] [--device cuda] [key=value ...]

Draws `--batches` batches of 8 from the preset's `TrainLoader` (its
transforms included) and clusters their boxes' heights and widths on the
device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import TrainLoader
from rrnet_torch.ops.kmeans import anchor_priors_from_dataset


def main(argv: Optional[Sequence[str]] = None):
    """Print and return the (heights, widths) priors."""
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.kmeans",
        description="Cluster the training boxes' sizes into anchor priors.")
    ap.add_argument("--config", default="retinanet",
                    choices=sorted(cfglib.PRESETS))
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    cfg = cfglib.apply_overrides(cfglib.PRESETS[args.config](),
                                 args.overrides)
    loader = TrainLoader(cfg, batch_size=8)
    try:
        hs, ws = anchor_priors_from_dataset(loader, k=args.k,
                                            max_batches=args.batches,
                                            device=args.device)
    finally:
        loader.close()
    print("height priors:", hs)
    print("width priors:", ws)
    return hs, ws


if __name__ == "__main__":
    main()
