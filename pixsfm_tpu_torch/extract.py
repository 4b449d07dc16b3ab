"""Feature extraction orchestration (reference: pixsfm/extract.py).

Port of ``features_from_image_list`` / ``features_from_graph`` /
``features_from_reconstruction`` of ``pixsfm_tpu/extract.py``: extract
patches only at matched keypoints (the KA input) or at the reprojections of
triangulated observations (the BA input), with image decoding prefetched on
a background thread. ``image_dir`` is a directory of image files or a
mapping ``{image_name: [H, W, 3] uint8 array}`` of decoded images. The H5
cache comes with a later slice of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

from .features.extractor import FeatureExtractor
from .features.featuremaps import FeatureManager

__all__ = ["features_from_graph", "features_from_image_list",
           "features_from_reconstruction"]


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


def features_from_reconstruction(extractor: FeatureExtractor,
                                 reconstruction, image_dir,
                                 cache_path=None) -> FeatureManager:
    """Extract at the reprojections of triangulated observations only
    (reference: extract.py:153-194)."""
    from .base.projection import project_np

    kp_per_image: Dict[str, np.ndarray] = {}
    ids_per_image: Dict[str, list] = {}
    for im in reconstruction.images.values():
        if not im.registered:
            continue
        cam = reconstruction.cameras[im.camera_id]
        tri = [(p2D_idx, pid) for p2D_idx, pid in enumerate(im.point3D_ids)
               if pid >= 0 and pid in reconstruction.points3D]
        if not tri:
            continue
        X = np.stack([reconstruction.points3D[pid].xyz for _, pid in tri])
        xy, depth = project_np(cam, im.qvec, im.tvec, X)
        keep = depth > 0
        if keep.any():
            kp_per_image[im.name] = xy[keep]
            ids_per_image[im.name] = [tri[i][0]
                                      for i in np.nonzero(keep)[0]]
    return features_from_image_list(
        extractor, sorted(kp_per_image.keys()), image_dir, kp_per_image,
        keypoint_ids_per_image=ids_per_image, cache_path=cache_path)
