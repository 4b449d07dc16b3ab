"""COLMAP-flavoured refinement pipeline (reference: pixsfm/refine_colmap.py).

Port of ``PixSfM`` of ``pixsfm_tpu/refine_colmap.py``:

- ``run_ka(keypoints, image_dir)``: build the match graph, extract features
  at the matched keypoints, run multilevel featuremetric KA;
- ``run_ba(reconstruction, image_dir)``: extract features at the
  reprojections of the triangulated observations, run multilevel BA
  (``feature_reference`` by default);
- ``refine_keypoints_from_db`` / ``refine_reconstruction``: the COLMAP
  database round-trip around ``run_ka`` and the model round-trip around
  ``run_ba``.

Everything runs on ``device`` (``cuda`` unless ``"cpu"`` is passed). The
command lines::

    python -m pixsfm_tpu_torch.refine_colmap keypoint_adjuster \\
        --database_path DB --output_path OUT_DB --image_dir IMAGES \\
        [--config_path CONF] [--device cpu] [a.b=c ...]
    python -m pixsfm_tpu_torch.refine_colmap bundle_adjuster \\
        --input_path MODEL --output_path OUT --image_dir IMAGES \\
        [--config_path CONF] [--device cpu] [a.b=c ...]
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from . import resolve_device
from .bundle_adjustment import BundleAdjuster
from .config import OmegaConf, load_config, merge
from .extract import features_from_graph, features_from_reconstruction
from .features.extractor import FeatureExtractor
from .keypoint_adjustment import KeypointAdjuster, build_matching_graph
from .sfm.model import Reconstruction
from .util.colmap import (read_keypoints_from_db, read_matches_from_db,
                          write_keypoints_to_db)
from .util.profiling import span

__all__ = ["PixSfM"]


class PixSfM:
    default_conf = {
        "dense_features": FeatureExtractor.default_conf,
        "interpolation": {
            "nodes": [[0.0, 0.0]], "mode": "BICUBIC",
            "l2_normalize": True, "ncc_normalize": False,
        },
        "mapping": {
            "dense_features": "${..dense_features}",
            "interpolation": "${..interpolation}",
            "parallel": {"enabled": False, "n_devices": None},
            "KA": KeypointAdjuster.default_conf,
            "BA": BundleAdjuster.default_conf,
        },
    }

    def __init__(self, conf=None, device=None):
        if isinstance(conf, (str, Path)):
            conf = load_config(conf)
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(
            device if device is not None
            else self.conf.dense_features.get("device"))
        mapping = self.conf.mapping
        self.extractor = FeatureExtractor(self.conf.dense_features,
                                          device=self.device)

        # interpolation precedence: explicit mapping.KA/BA.interpolation >
        # top-level interpolation > strategy defaults (the strategy
        # default_confs carry a concrete interpolation dict, so the
        # top-level block is merged over it unless the user set one on the
        # strategy)
        def _user_sub(*keys):
            c = conf
            for k in keys:
                if c is None or not hasattr(c, "get"):
                    return None
                c = c.get(k)
            return c

        def _strategy_conf(name):
            # resolved while still attached to the root: a detached copy
            # would resolve ``interpolation: ${..interpolation}`` (the
            # default preset's) against itself
            sc = merge(mapping.get(name).to_dict(resolve=True), {})
            sc = merge(sc, {"interpolation": self.conf.interpolation})
            explicit = _user_sub("mapping", name, "interpolation")
            if explicit is not None:
                sc = merge(sc, {"interpolation": explicit})
            if _user_sub("mapping", name, "parallel") is None:
                sc = merge(sc, {"parallel": mapping.get(
                    "parallel", {"enabled": False, "n_devices": None})})
            return sc

        self.keypoint_adjuster = KeypointAdjuster.create(_strategy_conf("KA"),
                                                         device=self.device)
        self.bundle_adjuster = BundleAdjuster.create(_strategy_conf("BA"),
                                                     device=self.device)

    # -- KA -----------------------------------------------------------------
    def run_ka(self, keypoints: Dict[str, np.ndarray], image_dir,
               matches=None, scores=None, graph=None, cache_path=None
               ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """``image_dir``: a directory of images, or a mapping ``{name:
        [H, W, 3] uint8 array}`` of decoded images. ``keypoints`` are
        refined in place and returned with the per-level KA summaries."""
        if not self.keypoint_adjuster.conf.get("apply", True):
            return keypoints, {}
        with span("run_ka"):
            if graph is None:
                graph = build_matching_graph(matches, scores)
            feature_manager = features_from_graph(
                self.extractor, image_dir, graph, keypoints,
                cache_path=cache_path)
            outputs = self.keypoint_adjuster.refine_multilevel(
                keypoints, feature_manager, graph)
        return keypoints, outputs

    # -- BA -----------------------------------------------------------------
    def run_ba(self, reconstruction: Reconstruction, image_dir,
               cache_path=None) -> Dict:
        """Refine ``reconstruction`` in place; returns the per-level BA
        summaries. ``image_dir`` as for :meth:`run_ka`."""
        if not self.bundle_adjuster.conf.get("apply", True):
            return {}
        with span("run_ba"):
            feature_manager = features_from_reconstruction(
                self.extractor, reconstruction, image_dir,
                cache_path=cache_path)
            return self.bundle_adjuster.refine_multilevel(reconstruction,
                                                          feature_manager)

    # -- DB / model round-trips ---------------------------------------------
    def refine_keypoints_from_db(self, output_path, database_path, image_dir,
                                 cache_path=None) -> Dict:
        """:meth:`run_ka` on the keypoints and matches of a COLMAP database
        (match scores from its descriptors, when it stores any); the refined
        keypoints go to a copy of it at ``output_path`` (or back into it when
        the two paths are the same)."""
        keypoints = read_keypoints_from_db(database_path)
        pairs, matches, scores = read_matches_from_db(database_path)
        match_dict = {tuple(p): m for p, m in zip(pairs, matches)}
        score_dict = ({tuple(p): s for p, s in zip(pairs, scores)}
                      if scores is not None else None)
        keypoints, outputs = self.run_ka(keypoints, image_dir,
                                         matches=match_dict,
                                         scores=score_dict,
                                         cache_path=cache_path)
        if str(output_path) != str(database_path):
            shutil.copy(database_path, output_path)
        write_keypoints_to_db(output_path, keypoints)
        return outputs

    def refine_reconstruction(self, output_path, input_path, image_dir,
                              cache_path=None) -> Tuple[Reconstruction, Dict]:
        """Read a COLMAP model, :meth:`run_ba` it, write it to
        ``output_path`` (binary)."""
        reconstruction = Reconstruction.read(input_path)
        outputs = self.run_ba(reconstruction, image_dir,
                              cache_path=cache_path)
        Path(output_path).mkdir(parents=True, exist_ok=True)
        reconstruction.write(output_path)
        return reconstruction, outputs

    def resolve_cache_path(self, cache_path=None, output_dir=None):
        """{label}_featuremaps_{sparse|dense}.h5 naming
        (reference: refine_colmap.py:131-145)."""
        if cache_path is None:
            if output_dir is None:
                return None
            cache_path = Path(output_dir)
        cache_path = Path(cache_path)
        if cache_path.is_dir() or cache_path.suffix == "":
            mode = "sparse" if self.conf.dense_features.sparse else "dense"
            model_name = self.conf.dense_features.model.name
            cache_path = cache_path / f"{model_name}_featuremaps_{mode}.h5"
        return cache_path


def add_common_args(parser):
    """The options both commands share, as the JAX package's
    ``add_common_args``; :func:`main` adds ``--device``."""
    parser.add_argument("--image_dir", type=Path, required=True)
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--cache_path", type=Path, default=None)
    parser.add_argument("dotlist", nargs="*")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="pixsfm_tpu_torch COLMAP refinement")
    sub = parser.add_subparsers(dest="command", required=True)
    p_ka = sub.add_parser("keypoint_adjuster")
    p_ka.add_argument("--database_path", type=Path, required=True)
    p_ka.add_argument("--output_path", type=Path, required=True)
    p_ba = sub.add_parser("bundle_adjuster")
    p_ba.add_argument("--input_path", type=Path, required=True)
    p_ba.add_argument("--output_path", type=Path, required=True)
    for p in (p_ka, p_ba):
        add_common_args(p)
        p.add_argument("--device", type=str, default=None)
    args = parser.parse_args(argv)
    conf = load_config(args.config_path, cli=args.dotlist) \
        if args.config_path else OmegaConf.from_dotlist(args.dotlist)
    sfm = PixSfM(conf, device=resolve_device(args.device))
    if args.command == "keypoint_adjuster":
        sfm.refine_keypoints_from_db(args.output_path, args.database_path,
                                     args.image_dir,
                                     cache_path=args.cache_path)
    else:
        sfm.refine_reconstruction(args.output_path, args.input_path,
                                  args.image_dir, cache_path=args.cache_path)


if __name__ == "__main__":
    main()
