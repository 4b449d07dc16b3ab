"""Dense feature extraction (reference: pixsfm/features/extractor.py).

Port of ``pixsfm_tpu/features/extractor.py``. Loads an image (a path, read
with PIL, or an already decoded ``[H, W, 3]`` uint8 array / PIL image),
resizes it to ``max_edge``, runs the feature model on the device and cuts a
``[ps, ps, C]`` window around every keypoint (``sparse: true``, the
default), or keeps the whole map (``sparse: false``, and the dense fallback
when the keypoint windows would hold more than the map). Windows or map are
L2-normalized per pixel (``l2_normalize``) and cast to the storage dtype
(``half`` -> bfloat16) on the device, and stay there as the
:class:`FeatureMap`'s patches (a :class:`DeviceFeatureMap` with
``keep_on_device``).

:meth:`FeatureExtractor.extract_batch` runs a group of equally sized images
through one forward per pyramid scale (``batch_size > 1`` in
``extract.features_from_image_list``). The JAX package pads such a batch to
a power of two for XLA's compile cache; the port does not pad, and its
outputs do not depend on the batch size. ``as_dict=True`` returns the
arrays the H5 cache stores, including the dense-stored / sparse-loaded mode
(a dense map with per-keypoint corners, ``extractor.py:212-226`` of the
reference).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import merge
from .featuremaps import (DeviceFeatureMap, FeatureMap, kDensePatchId,
                          storage_dtype, window_cut)
from .models import get_model

__all__ = ["FeatureExtractor", "extract_patches_numpy"]

# the ``resize`` option's PIL filters (PIL.Image.Resampling's values)
RESIZE_FILTERS = {"LANCZOS": 1, "BILINEAR": 2, "BICUBIC": 3, "NEAREST": 0}


def extract_patches_numpy(featuremap: np.ndarray, corners: np.ndarray,
                          ps: int) -> np.ndarray:
    """Window-gather ``[H, W, C]`` -> ``[N, ps, ps, C]`` at the top-left
    ``corners [N, 2]`` ``(x, y)`` (reference:
    features/extract_patches.py:14-44)."""
    out = np.empty((len(corners), ps, ps, featuremap.shape[-1]),
                   featuremap.dtype)
    for i, (cx, cy) in enumerate(corners):
        out[i] = featuremap[cy:cy + ps, cx:cx + ps]
    return out


class FeatureExtractor:
    default_conf = {
        "device": "auto",
        "dtype": "half",
        "fast_image_load": False,
        "l2_normalize": True,
        "max_edge": 1600,
        "model": {"name": "s2dnet"},
        "patch_size": 16,
        "pyr_scales": [1.0],
        "resize": "LANCZOS",
        "sparse": True,
        # emit DeviceFeatureMap (the JAX package's device-resident maps);
        # the port's maps stay on the device either way. Ignored when
        # as_dict=True (cache writes).
        "keep_on_device": False,
        "prefetch_depth": 2,
        "batch_size": 1,
        "use_cache": False,
        "overwrite_cache": False,
        "load_cache_on_init": False,
        "cache_format": "chunked",
    }

    dtype_map = {"half": "bfloat16", "float16": "float16",
                 "bfloat16": "bfloat16", "float": "float32",
                 "float32": "float32", "double": "float64"}

    def __init__(self, conf=None, device=None):
        self.conf = merge(self.default_conf, conf or {})
        self.device = resolve_device(device if device is not None
                                     else self.conf.get("device"))
        model_conf = self.conf.model.to_dict() \
            if hasattr(self.conf.model, "to_dict") else dict(self.conf.model)
        name = model_conf.pop("name", "s2dnet")
        self.model = get_model(name)(model_conf, device=self.device)
        self.storage_dtype = self.dtype_map[str(self.conf.dtype)]

    @property
    def channels_per_level(self) -> List[int]:
        return list(self.model.output_dims) * len(self.conf.pyr_scales)

    @property
    def num_levels(self) -> int:
        return len(self.channels_per_level)

    # -- image loading ------------------------------------------------------
    @staticmethod
    def _size(image):
        """(w, h) of a PIL image or an ``[H, W, ...]`` array."""
        if isinstance(image, np.ndarray):
            return image.shape[1], image.shape[0]
        return image.size

    def scaled_image_size(self, image, pyr_scale=1.0):
        w, h = self._size(image)
        s = min(float(self.conf.max_edge) / max(w, h), 1.0) * pyr_scale
        return [int(round(s * w)), int(round(s * h))]

    def resize_image(self, image, pyr_scale: float):
        w_new, h_new = self.scaled_image_size(image, pyr_scale)
        if (w_new, h_new) == tuple(self._size(image)):
            return image
        import PIL.Image
        if isinstance(image, np.ndarray):
            image = PIL.Image.fromarray(image)
        return image.resize((w_new, h_new),
                            RESIZE_FILTERS[str(self.conf.resize)])

    def load_image(self, image_path):
        """Open + decode an image with PIL (draft decoding with
        ``fast_image_load``); keeps the original size for keypoint scales."""
        import PIL.Image
        img = PIL.Image.open(image_path)
        orig_size = img.size
        if self.conf.fast_image_load:
            img.draft("RGB", self.scaled_image_size(
                img, self.conf.pyr_scales[0]))
        img = img.convert("RGB")
        img.original_size = orig_size
        return img

    def _preprocess(self, image, pyr_scale: float) -> torch.Tensor:
        return self.model.preprocess(self.resize_image(image, pyr_scale))

    @torch.no_grad()
    def extract_batch(self, images: Sequence, keypoints_list: Sequence,
                      keypoint_ids_list: Optional[Sequence] = None,
                      as_dict: bool = False) -> List[List]:
        """One model forward per pyramid scale for a group of images of
        equal decoded size; returns per-image lists of maps, exactly like
        calling the extractor per image."""
        B = len(images)
        ids_list = keypoint_ids_list or [None] * B
        if B == 1:
            return [self(images[0], keypoints=keypoints_list[0],
                         keypoint_ids=ids_list[0], as_dict=as_dict)]
        sizes = {tuple(self._size(im)) for im in images}
        if len(sizes) > 1:
            raise ValueError(f"extract_batch needs equal image sizes, "
                             f"got {sizes}")
        out: List[List] = [[] for _ in range(B)]
        for pyr_scale in self.conf.pyr_scales:
            feats = self.model(torch.cat(
                [self._preprocess(im, pyr_scale) for im in images]))
            for fm in feats:
                for i, im in enumerate(images):
                    img_size = getattr(im, "original_size", self._size(im))
                    out[i].append(self._to_fmap(
                        fm[i], img_size, keypoints_list[i], ids_list[i],
                        as_dict=as_dict))
        return out

    # -- memory estimation (reference extractor.py:242-264) -----------------
    def estimate_req_memory(self, image_path, num_kps: int) -> float:
        """Bytes of the stored features of one image: its ``num_kps``
        windows when sparse, else its dense maps at every level (NaN when
        the model states no scales)."""
        n_bytes = {"bfloat16": 2, "float16": 2, "float32": 4,
                   "float64": 8}[self.storage_dtype]
        if self.conf.sparse:
            return (self.conf.patch_size ** 2 * sum(self.channels_per_level)
                    * num_kps * n_bytes)
        if self.model.scales is None:
            return float("nan")
        import PIL.Image
        image = PIL.Image.open(image_path)
        req = 0.0
        for pyr_scale in self.conf.pyr_scales:
            w, h = self.scaled_image_size(image, pyr_scale)
            for i, c in enumerate(self.model.output_dims):
                req += w * h / self.model.scales[i] ** 2 * c * n_bytes
        return req

    # -- main entry ---------------------------------------------------------
    @torch.no_grad()
    def __call__(self, image, keypoints: Optional[np.ndarray] = None,
                 keypoint_ids: Optional[Sequence[int]] = None,
                 as_dict: bool = False,
                 overwrite_sparse: Optional[bool] = None) -> List:
        """``image``: path, PIL image or decoded ``[H, W, 3]`` array.
        Returns one :class:`FeatureMap` per level (a dict of the cache's
        arrays with ``as_dict``). ``overwrite_sparse`` replaces
        ``conf.sparse`` for this call."""
        if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
            image = self.load_image(image)
        img_size = getattr(image, "original_size", self._size(image))
        fmaps = []
        for pyr_scale in self.conf.pyr_scales:
            feats = self.model(self._preprocess(image, pyr_scale))
            for fm in feats:
                fmaps.append(self._to_fmap(fm[0], img_size, keypoints,
                                           keypoint_ids, as_dict,
                                           overwrite_sparse))
        return fmaps

    def _to_fmap(self, fmap: torch.Tensor, image_size, keypoints,
                 keypoint_ids, as_dict: bool = False,
                 overwrite_sparse=None):
        """Cut, normalize and cast the keypoint windows of one ``[C, h, w]``
        map on the device (``_compiled_extract_patches`` of the JAX
        package; the per-pixel L2 commutes with the window cut, so only
        the windows are normalized), or normalize and cast the whole map
        (``_to_fmap``'s dense branch, ``extractor.py:302-331``)."""
        sparse = bool(self.conf.sparse if overwrite_sparse is None
                      else overwrite_sparse)
        if sparse and keypoints is None:
            raise RuntimeError("sparse extraction requires keypoints")
        if keypoints is not None:
            keypoints = np.asarray(keypoints, np.float64).reshape(-1, 2)
            if keypoint_ids is None:
                keypoint_ids = list(range(len(keypoints)))
            elif len(keypoints) != len(keypoint_ids):
                raise ValueError("keypoints / keypoint_ids length mismatch")
        w, h = image_size
        ps = int(self.conf.patch_size)
        C, fh, fw = fmap.shape
        scale = np.array([fw / w, fh / h])
        dtype = storage_dtype(self.storage_dtype)
        keep_dev = bool(self.conf.get("keep_on_device", False)) \
            and not as_dict

        def normalize(f):
            f = f.to(torch.float32)
            if self.conf.l2_normalize:
                f = f / torch.clamp(torch.linalg.vector_norm(
                    f, dim=-1, keepdim=True), min=1e-12)
            return f.to(dtype).contiguous()

        def keypoint_corners():
            corners = (keypoints * scale - ps / 2.0).astype(np.int32)
            return np.clip(corners, [0, 0],
                           [max(fw - ps - 1, 0), max(fh - ps - 1, 0)])

        if sparse and fmap.numel() > len(keypoints) * ps * ps * C:
            corners = keypoint_corners()
            patches = normalize(window_cut(fmap.permute(1, 2, 0), corners,
                                           ps))
            if as_dict:
                return dict(patches=patches, corners=corners,
                            keypoint_ids=list(keypoint_ids),
                            metadata=dict(scale=scale, is_sparse=True,
                                          patch_size=ps))
            if keep_dev:
                return DeviceFeatureMap(patches, list(keypoint_ids), corners,
                                        scale, is_sparse=True)
            return FeatureMap(patches, list(keypoint_ids), corners, scale)
        # the whole map: sparse: false, or more keypoint windows than the
        # map holds (the JAX extractor's dense fallback)
        dense = normalize(fmap.permute(1, 2, 0))
        if as_dict:
            if not sparse or not self.conf.use_cache:
                return dict(patches=dense[None],
                            corners=np.zeros((1, 2), np.int32),
                            keypoint_ids=[kDensePatchId],
                            metadata=dict(scale=scale, is_sparse=False,
                                          patch_size=ps))
            # dense-stored / sparse-loaded cache mode (extractor.py:212-226)
            return dict(patches=dense[None], corners=keypoint_corners(),
                        keypoint_ids=list(keypoint_ids),
                        metadata=dict(scale=scale, is_sparse=False,
                                      patch_size=ps))
        if keep_dev:
            return DeviceFeatureMap(dense, None, None, scale, is_sparse=False)
        return FeatureMap(dense[None], [kDensePatchId],
                          np.zeros((1, 2), np.int64), scale, is_sparse=False)
