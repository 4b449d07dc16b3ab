"""hloc-flavoured pipeline (reference: pixsfm/refine_hloc.py).

Port of ``PixSfM`` of ``pixsfm_tpu/refine_hloc.py``, on top of
:class:`pixsfm_tpu_torch.refine_colmap.PixSfM`:

- ``refine_keypoints``: KA on hloc feature/match files with the +-0.5 px
  coordinate shift;
- ``triangulation``: KA -> triangulation with the known poses of a
  reference model -> BA (the reference shells out to hloc/COLMAP; the
  built-in triangulator of ``sfm/triangulation.py`` is used);
- ``reconstruction`` (``run``): KA -> incremental SfM with unknown
  intrinsics (the built-in mapper of ``sfm/mapper.py``) -> BA.

Each flow's hloc-file head reads pairs, keypoints and matches; its body
(``_triangulation``, ``_reconstruction``) takes them in memory, so a
machine without ``h5py`` can drive the same path on decoded arrays.

The command lines (``--device cpu`` runs the plain PyTorch versions)::

    python -m pixsfm_tpu_torch.refine_hloc keypoint_adjuster \\
        --image_dir IMAGES --features_path F.h5 --pairs_path PAIRS.txt \\
        --matches_path M.h5 --output_path OUT.h5 [--device cpu] [a.b=c ...]
    python -m pixsfm_tpu_torch.refine_hloc triangulator \\
        --image_dir IMAGES --reference_model_path REF --features_path F.h5 \\
        --pairs_path PAIRS.txt --matches_path M.h5 --output_dir OUT \\
        [--device cpu] [a.b=c ...]
    python -m pixsfm_tpu_torch.refine_hloc reconstructor \\
        --image_dir IMAGES --features_path F.h5 --pairs_path PAIRS.txt \\
        --matches_path M.h5 --output_dir OUT [--device cpu] [a.b=c ...]
    python -m pixsfm_tpu_torch.refine_hloc bundle_adjuster \\
        --image_dir IMAGES --input_path MODEL --output_path OUT \\
        [--device cpu] [a.b=c ...]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .config import OmegaConf, load_config
from .keypoint_adjustment import build_matching_graph
from .refine_colmap import PixSfM as PixSfMBase
from .sfm.model import Reconstruction
from .sfm.triangulation import triangulate_reconstruction
from .util.hloc import (read_image_pairs, read_keypoints_hloc,
                        read_matches_hloc, write_keypoints_hloc)
from .util.misc import to_colmap_coordinates, to_hloc_coordinates

__all__ = ["PixSfM"]


def _read_hloc(pairs_path, features_path, matches_path):
    """(keypoints in COLMAP coordinates, {pair: matches}, {pair: scores})."""
    pairs = read_image_pairs(pairs_path)
    keypoints = read_keypoints_hloc(features_path)
    to_colmap_coordinates(keypoints)
    matches_list, scores_list = read_matches_hloc(matches_path, pairs)
    matches = {tuple(p): m for p, m in zip(pairs, matches_list)}
    scores = {tuple(p): s for p, s in zip(pairs, scores_list)}
    return keypoints, matches, scores


class PixSfM(PixSfMBase):

    def refine_keypoints(self, output_path, features_path, image_dir,
                         pairs_path, matches_path, cache_path=None
                         ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """KA on hloc feature/match files (reference: refine_hloc.py:72-92)."""
        keypoints, matches, scores = _read_hloc(pairs_path, features_path,
                                                matches_path)
        keypoints, outputs = self.run_ka(keypoints, image_dir,
                                         matches=matches, scores=scores,
                                         cache_path=cache_path)
        to_hloc_coordinates(keypoints)
        write_keypoints_hloc(output_path, keypoints)
        to_colmap_coordinates(keypoints)
        return keypoints, outputs

    def triangulation(self, output_dir, reference_model_path, image_dir,
                      pairs_path, features_path, matches_path,
                      cache_path=None,
                      max_reproj_error: float = 4.0) -> Tuple[Reconstruction,
                                                              Dict]:
        """KA -> triangulation with known poses -> BA
        (reference: refine_hloc.py:117-131)."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        keypoints, matches, scores = _read_hloc(pairs_path, features_path,
                                                matches_path)
        reference = Reconstruction.read(reference_model_path)
        return self._triangulation(output_dir, reference, image_dir,
                                   keypoints, matches, scores,
                                   cache_path=cache_path,
                                   max_reproj_error=max_reproj_error)

    def _triangulation(self, output_dir, reference: Reconstruction,
                       image_dir, keypoints: Dict[str, np.ndarray], matches,
                       scores, cache_path=None,
                       max_reproj_error: float = 4.0
                       ) -> Tuple[Reconstruction, Dict]:
        """The body of :meth:`triangulation` on in-memory inputs: keypoints
        (COLMAP coordinates, refined in place), ``{pair: matches}``,
        ``{pair: scores}`` and the reference model; ``image_dir`` as for
        :meth:`run_ka`. Returns the refined reconstruction, also written to
        ``output_dir``, and ``{"KA", "triangulation", "BA"}`` summaries."""
        graph = build_matching_graph(matches, scores)
        outputs: Dict = {}
        keypoints, outputs["KA"] = self.run_ka(
            keypoints, image_dir, graph=graph, cache_path=cache_path)
        t0 = time.time()
        reconstruction = triangulate_reconstruction(
            reference, graph, keypoints, max_reproj_error=max_reproj_error,
            device=self.device)
        outputs["triangulation"] = {
            "time": time.time() - t0,
            "num_points3D": len(reconstruction.points3D)}
        outputs["BA"] = self.run_ba(reconstruction, image_dir,
                                    cache_path=cache_path)
        reconstruction.write(output_dir)
        return reconstruction, outputs

    def reconstruction(self, output_dir, image_dir, pairs_path,
                       features_path, matches_path, cache_path=None,
                       camera_model: str = "SIMPLE_RADIAL",
                       cameras=None) -> Tuple[Reconstruction, Dict]:
        """KA -> incremental SfM -> BA (reference: refine_hloc.py:26-70)."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        keypoints, matches, scores = _read_hloc(pairs_path, features_path,
                                                matches_path)
        return self._reconstruction(output_dir, image_dir, keypoints,
                                    matches, scores, cache_path=cache_path,
                                    camera_model=camera_model,
                                    cameras=cameras)

    run = reconstruction

    def _reconstruction(self, output_dir, image_dir,
                        keypoints: Dict[str, np.ndarray], matches, scores,
                        cache_path=None, camera_model: str = "SIMPLE_RADIAL",
                        cameras=None) -> Tuple[Reconstruction, Dict]:
        """The body of :meth:`reconstruction` on in-memory inputs, as
        :meth:`_triangulation`. Returns the refined reconstruction, also
        written to ``output_dir``, and ``{"KA", "SfM", "BA"}`` summaries;
        ``SfM`` holds the mapper's counts and wall time (``time``)."""
        from .sfm.mapper import incremental_mapping

        graph = build_matching_graph(matches, scores)
        outputs: Dict = {}
        keypoints, outputs["KA"] = self.run_ka(
            keypoints, image_dir, graph=graph, cache_path=cache_path)
        t0 = time.time()
        stats: Dict = {}
        reconstruction = incremental_mapping(
            graph, keypoints, image_dir, camera_model=camera_model,
            cameras=cameras, device=self.device, stats=stats)
        outputs["SfM"] = {
            "num_reg_images": reconstruction.num_reg_images,
            "num_points3D": len(reconstruction.points3D),
            "time": time.time() - t0, **stats}
        outputs["BA"] = self.run_ba(reconstruction, image_dir,
                                    cache_path=cache_path)
        reconstruction.write(output_dir)
        return reconstruction, outputs


def main(argv=None):
    parser = argparse.ArgumentParser(description="pixsfm_tpu_torch hloc "
                                                 "refinement")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("keypoint_adjuster", "triangulator", "reconstructor",
                 "bundle_adjuster"):
        p = sub.add_parser(name)
        p.add_argument("--image_dir", type=Path, required=True)
        p.add_argument("--config_path", type=str, default=None)
        p.add_argument("--cache_path", type=Path, default=None)
        p.add_argument("--device", type=str, default=None)
        if name in ("keypoint_adjuster", "triangulator", "reconstructor"):
            p.add_argument("--features_path", type=Path, required=True)
            p.add_argument("--pairs_path", type=Path, required=True)
            p.add_argument("--matches_path", type=Path, required=True)
        if name == "keypoint_adjuster":
            p.add_argument("--output_path", type=Path, required=True)
        elif name == "triangulator":
            p.add_argument("--reference_model_path", type=Path,
                           required=True)
            p.add_argument("--output_dir", type=Path, required=True)
        elif name == "reconstructor":
            p.add_argument("--output_dir", type=Path, required=True)
        else:
            p.add_argument("--input_path", type=Path, required=True)
            p.add_argument("--output_path", type=Path, required=True)
        p.add_argument("dotlist", nargs="*")
    args = parser.parse_args(argv)
    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    sfm = PixSfM(conf, device=args.device)
    if args.command == "keypoint_adjuster":
        sfm.refine_keypoints(args.output_path, args.features_path,
                             args.image_dir, args.pairs_path,
                             args.matches_path, cache_path=args.cache_path)
    elif args.command == "triangulator":
        sfm.triangulation(args.output_dir, args.reference_model_path,
                          args.image_dir, args.pairs_path,
                          args.features_path, args.matches_path,
                          cache_path=args.cache_path)
    elif args.command == "reconstructor":
        sfm.reconstruction(args.output_dir, args.image_dir, args.pairs_path,
                           args.features_path, args.matches_path,
                           cache_path=args.cache_path)
    else:
        sfm.refine_reconstruction(args.output_path, args.input_path,
                                  args.image_dir, cache_path=args.cache_path)


if __name__ == "__main__":
    main()
