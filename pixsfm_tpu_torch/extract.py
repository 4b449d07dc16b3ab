"""Feature extraction orchestration (reference: pixsfm/extract.py).

Port of ``pixsfm_tpu/extract.py``: extract patches only at matched keypoints
(the KA input, ``features_from_graph``) or at the reprojections of
triangulated observations (the BA input, ``features_from_reconstruction``),
through the shared per-image loop ``features_from_image_list``, with image
decoding prefetched on a background thread. With ``batch_size > 1``
consecutive images of equal size run through one batched forward
(``FeatureExtractor.extract_batch``); with ``sparse: false`` each image keeps
its whole map (``FeatureView`` cuts the windows a solve reads). ``image_dir``
is a directory of image files or a mapping ``{image_name: [H, W, 3] uint8
array}`` of decoded images.

With ``use_cache: true`` and a ``cache_path`` the maps are written to an H5
cache (``features/h5cache.py``) and loaded from it on demand; an existing
cache is a resume point: unless ``overwrite_cache`` it is loaded and nothing
is extracted (extract.py:75-81 of the reference). ``use_cache`` without a
path is ignored, as in the JAX package. The cache needs ``h5py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

from . import logger
from .features.extractor import FeatureExtractor
from .features.featuremaps import FeatureManager
from .util.profiling import span

__all__ = ["features_from_graph", "features_from_image_list",
           "features_from_reconstruction", "load_features_from_cache"]


def load_features_from_cache(cache_path, device=None) -> FeatureManager:
    """A manager over an H5 cache; maps load onto ``device`` (``cuda``
    unless given)."""
    return FeatureManager.from_cache(Path(cache_path), device=device)


def features_from_image_list(extractor: FeatureExtractor, image_list,
                             image_dir,
                             keypoints_per_image: Dict[str, np.ndarray],
                             keypoint_ids_per_image: Optional[Dict] = None,
                             cache_path=None) -> FeatureManager:
    use_cache = bool(extractor.conf.use_cache) and cache_path is not None
    if use_cache:
        cache_path = Path(cache_path)
        if cache_path.exists() and not extractor.conf.overwrite_cache:
            logger.info("Loading features from existing cache %s", cache_path)
            return FeatureManager.from_cache(cache_path,
                                             device=extractor.device)

    channels = extractor.channels_per_level
    ps = int(extractor.conf.patch_size)
    manager = FeatureManager(channels, ps, str(extractor.conf.dtype),
                             h5_path=cache_path if use_cache else None,
                             device=extractor.device)
    if use_cache:
        from .features.h5cache import init_cache, write_featuremap
        init_cache(cache_path, channels, ps, str(extractor.conf.dtype),
                   overwrite=True)

    def emit(image_name, fmaps):
        for level, data in enumerate(fmaps):
            if not use_cache:
                manager.fset(level).emplace(image_name, data)
                continue
            write_featuremap(
                cache_path, f"level_{level}", image_name, data["patches"],
                data["keypoint_ids"], data["corners"],
                data["metadata"]["scale"],
                is_sparse=data["metadata"]["is_sparse"],
                cache_format=str(extractor.conf.cache_format))

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
    batch_size = max(int(extractor.conf.get("batch_size", 1)), 1)
    group: list = []       # (name, img, kps, kp_ids) of equal decoded size

    def flush():
        if not group:
            return
        with span("extract.view"):
            outs = extractor.extract_batch(
                [g[1] for g in group], [g[2] for g in group],
                keypoint_ids_list=[g[3] for g in group], as_dict=use_cache)
        for (name, *_), fmaps in zip(group, outs):
            emit(name, fmaps)
        group.clear()

    for image_name, img in progress_iter(
            prefetch_map(_load, image_list, depth=depth),
            desc="feature extraction", total=len(image_list)):
        kps = keypoints_per_image.get(image_name)
        kp_ids = (keypoint_ids_per_image or {}).get(image_name)
        if batch_size <= 1:
            with span("extract.view"):
                fmaps = extractor(img, keypoints=kps, keypoint_ids=kp_ids,
                                  as_dict=use_cache)
            emit(image_name, fmaps)
            continue
        # group consecutive same-sized images into one batched forward
        if group and (tuple(extractor._size(group[0][1]))
                      != tuple(extractor._size(img))
                      or len(group) >= batch_size):
            flush()
        group.append((image_name, img, kps, kp_ids))
    flush()
    return manager


def features_from_graph(extractor: FeatureExtractor, image_dir, graph,
                        keypoints_dict: Dict[str, np.ndarray],
                        cache_path=None) -> FeatureManager:
    from .keypoint_adjustment.main import extract_patchdata_from_graph
    with span("extract"):
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
    with span("extract"):
        with span("extract.project"):
            for im in reconstruction.images.values():
                if not im.registered:
                    continue
                cam = reconstruction.cameras[im.camera_id]
                tri = [(p2D_idx, pid) for p2D_idx, pid
                       in enumerate(im.point3D_ids)
                       if pid >= 0 and pid in reconstruction.points3D]
                if not tri:
                    continue
                X = np.stack([reconstruction.points3D[pid].xyz
                              for _, pid in tri])
                xy, depth = project_np(cam, im.qvec, im.tvec, X)
                keep = depth > 0
                if keep.any():
                    kp_per_image[im.name] = xy[keep]
                    ids_per_image[im.name] = [tri[i][0]
                                              for i in np.nonzero(keep)[0]]
        return features_from_image_list(
            extractor, sorted(kp_per_image.keys()), image_dir,
            kp_per_image, keypoint_ids_per_image=ids_per_image,
            cache_path=cache_path)
