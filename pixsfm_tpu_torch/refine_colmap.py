"""COLMAP-flavoured refinement pipeline (reference: pixsfm/refine_colmap.py).

Port of ``PixSfM.__init__`` and ``PixSfM.run_ka`` of
``pixsfm_tpu/refine_colmap.py``: build the match graph, extract features at
the matched keypoints, run multilevel featuremetric KA. Everything runs on
``device`` (``cuda`` unless ``"cpu"`` is passed). Bundle adjustment and the
COLMAP database round-trips come with later slices of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from . import resolve_device
from .config import load_config, merge
from .extract import features_from_graph
from .features.extractor import FeatureExtractor
from .keypoint_adjustment import KeypointAdjuster, build_matching_graph

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

        # interpolation precedence: explicit mapping.KA.interpolation >
        # top-level interpolation > strategy defaults (the strategy
        # default_conf carries a concrete interpolation dict, so the
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
            sc = merge(mapping.get(name), {})
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

    # -- KA -----------------------------------------------------------------
    def run_ka(self, keypoints: Dict[str, np.ndarray], image_dir,
               matches=None, scores=None, graph=None, cache_path=None
               ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """``image_dir``: a directory of images, or a mapping ``{name:
        [H, W, 3] uint8 array}`` of decoded images. ``keypoints`` are
        refined in place and returned with the per-level KA summaries."""
        if not self.keypoint_adjuster.conf.get("apply", True):
            return keypoints, {}
        if graph is None:
            graph = build_matching_graph(matches, scores)
        feature_manager = features_from_graph(
            self.extractor, image_dir, graph, keypoints,
            cache_path=cache_path)
        outputs = self.keypoint_adjuster.refine_multilevel(
            keypoints, feature_manager, graph)
        return keypoints, outputs
