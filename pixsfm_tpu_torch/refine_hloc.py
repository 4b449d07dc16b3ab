"""hloc-flavoured pipeline (reference: pixsfm/refine_hloc.py).

Port of ``PixSfM.refine_keypoints`` of ``pixsfm_tpu/refine_hloc.py``: KA on
hloc feature/match files with the +-0.5 px coordinate shift, and its
``keypoint_adjuster`` command line::

    python -m pixsfm_tpu_torch.refine_hloc keypoint_adjuster \\
        --image_dir IMAGES --features_path F.h5 --pairs_path PAIRS.txt \\
        --matches_path M.h5 --output_path OUT.h5 [--device cpu] [a.b=c ...]

Triangulation, reconstruction and BA come with later slices of the port.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .config import OmegaConf, load_config
from .refine_colmap import PixSfM as PixSfMBase
from .util.hloc import (read_image_pairs, read_keypoints_hloc,
                        read_matches_hloc, write_keypoints_hloc)
from .util.misc import to_colmap_coordinates, to_hloc_coordinates

__all__ = ["PixSfM"]


class PixSfM(PixSfMBase):

    def refine_keypoints(self, output_path, features_path, image_dir,
                         pairs_path, matches_path, cache_path=None
                         ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """KA on hloc feature/match files (reference: refine_hloc.py:72-92)."""
        pairs = read_image_pairs(pairs_path)
        keypoints = read_keypoints_hloc(features_path)
        to_colmap_coordinates(keypoints)
        matches_list, scores_list = read_matches_hloc(matches_path, pairs)
        matches = {tuple(p): m for p, m in zip(pairs, matches_list)}
        scores = {tuple(p): s for p, s in zip(pairs, scores_list)}
        keypoints, outputs = self.run_ka(keypoints, image_dir,
                                         matches=matches, scores=scores,
                                         cache_path=cache_path)
        to_hloc_coordinates(keypoints)
        write_keypoints_hloc(output_path, keypoints)
        to_colmap_coordinates(keypoints)
        return keypoints, outputs


def main():
    parser = argparse.ArgumentParser(
        description="pixsfm_tpu_torch hloc keypoint refinement")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("keypoint_adjuster")
    p.add_argument("--image_dir", type=Path, required=True)
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--features_path", type=Path, required=True)
    p.add_argument("--pairs_path", type=Path, required=True)
    p.add_argument("--matches_path", type=Path, required=True)
    p.add_argument("--output_path", type=Path, required=True)
    p.add_argument("--device", type=str, default=None)
    p.add_argument("dotlist", nargs="*")
    args = parser.parse_args()
    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    sfm = PixSfM(conf, device=args.device)
    sfm.refine_keypoints(args.output_path, args.features_path,
                         args.image_dir, args.pairs_path, args.matches_path)


if __name__ == "__main__":
    main()
