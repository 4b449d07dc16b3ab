"""Feature extraction orchestration (reference: pixsfm/extract.py).

Port of ``features_from_image_list`` / ``features_from_graph`` of
``pixsfm_tpu/extract.py``: extract patches only at matched keypoints (the KA
input), with image decoding prefetched on a background thread. ``image_dir``
is a directory of image files or a mapping ``{image_name: [H, W, 3] uint8
array}`` of decoded images. The H5 cache and extraction at reprojected
observations (BA input) come with later slices of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

from .features.extractor import FeatureExtractor
from .features.featuremaps import FeatureManager

__all__ = ["features_from_graph", "features_from_image_list"]


def features_from_image_list(extractor: FeatureExtractor, image_list,
                             image_dir,
                             keypoints_per_image: Dict[str, np.ndarray],
                             keypoint_ids_per_image: Optional[Dict] = None,
                             cache_path=None) -> FeatureManager:
    if cache_path is not None:
        raise NotImplementedError(
            "the H5 feature cache is not ported yet; it comes with a later "
            "slice of pixsfm_tpu_torch")
    manager = FeatureManager(extractor.channels_per_level,
                             int(extractor.conf.patch_size),
                             str(extractor.conf.dtype))

    from .util.misc import progress_iter
    from .util.prefetch import prefetch_map

    if isinstance(image_dir, Mapping):
        def _load(image_name):
            return image_name, image_dir[image_name]
    else:
        image_dir = Path(image_dir)

        def _load(image_name):
            return image_name, extractor.load_image(image_dir / image_name)

    image_list = list(image_list)
    depth = int(extractor.conf.get("prefetch_depth", 2))
    for image_name, img in progress_iter(
            prefetch_map(_load, image_list, depth=depth),
            desc="feature extraction", total=len(image_list)):
        fmaps = extractor(
            img, keypoints=keypoints_per_image.get(image_name),
            keypoint_ids=(keypoint_ids_per_image or {}).get(image_name))
        for level, fmap in enumerate(fmaps):
            manager.fset(level).emplace(image_name, fmap)
    return manager


def features_from_graph(extractor: FeatureExtractor, image_dir, graph,
                        keypoints_dict: Dict[str, np.ndarray],
                        cache_path=None) -> FeatureManager:
    from .keypoint_adjustment.main import extract_patchdata_from_graph
    patch_data = extract_patchdata_from_graph(graph)
    kp_per_image = {name: np.asarray(keypoints_dict[name])[ids]
                    for name, ids in patch_data.items()}
    return features_from_image_list(
        extractor, sorted(patch_data.keys()), image_dir, kp_per_image,
        keypoint_ids_per_image=patch_data, cache_path=cache_path)
