"""Dense feature extraction (reference: pixsfm/features/extractor.py).

Port of ``pixsfm_tpu/features/extractor.py``. Loads an image (a path, read
with PIL, or an already decoded ``[H, W, 3]`` uint8 array / PIL image),
resizes it to ``max_edge``, runs the feature model on the device and cuts a
``[ps, ps, C]`` window around every keypoint (``sparse: true``, the
default), or keeps the whole map (``sparse: false``, and the dense fallback
when the keypoint windows would hold more than the map). Windows or map are
L2-normalized per pixel (``l2_normalize``) and cast to the storage dtype
(``half`` -> bfloat16) on the device, and stay there as the
:class:`FeatureMap`'s patches.

The H5 cache and batched forwards come with a later slice. ``use_cache``
applies only when the caller gives a cache path, as in the JAX package, so
a preset that sets it (``low_memory``) runs without one; ``extract.py``
raises for a cache path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..config import merge
from .featuremaps import FeatureMap, kDensePatchId, storage_dtype, window_cut
from .models import get_model

__all__ = ["FeatureExtractor"]


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
        # the port always keeps patches on the device; accepted for parity
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
        if int(self.conf.get("batch_size", 1)) > 1:
            raise NotImplementedError(
                "batched extraction (batch_size > 1) is not ported yet")
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
                            getattr(PIL.Image, str(self.conf.resize)))

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

    # -- main entry ---------------------------------------------------------
    @torch.no_grad()
    def __call__(self, image, keypoints: Optional[np.ndarray] = None,
                 keypoint_ids: Optional[Sequence[int]] = None,
                 overwrite_sparse: Optional[bool] = None) -> List:
        """``image``: path, PIL image or decoded ``[H, W, 3]`` array.
        Returns one :class:`FeatureMap` per level. ``overwrite_sparse``
        replaces ``conf.sparse`` for this call."""
        if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
            image = self.load_image(image)
        img_size = getattr(image, "original_size", self._size(image))
        fmaps = []
        for pyr_scale in self.conf.pyr_scales:
            img_pyr = self.resize_image(image, pyr_scale)
            feats = self.model(self.model.preprocess(img_pyr))
            for fm in feats:
                fmaps.append(self._to_fmap(fm[0], img_size, keypoints,
                                           keypoint_ids, overwrite_sparse))
        return fmaps

    def _to_fmap(self, fmap: torch.Tensor, image_size, keypoints,
                 keypoint_ids, overwrite_sparse=None) -> FeatureMap:
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

        def normalize(f):
            f = f.to(torch.float32)
            if self.conf.l2_normalize:
                f = f / torch.clamp(torch.linalg.vector_norm(
                    f, dim=-1, keepdim=True), min=1e-12)
            return f.to(dtype).contiguous()

        if sparse and fmap.numel() > len(keypoints) * ps * ps * C:
            corners = (keypoints * scale - ps / 2.0).astype(np.int32)
            corners = np.clip(corners, [0, 0],
                              [max(fw - ps - 1, 0), max(fh - ps - 1, 0)])
            patches = normalize(window_cut(fmap.permute(1, 2, 0), corners,
                                           ps))
            return FeatureMap(patches, list(keypoint_ids), corners, scale)
        # the whole map: sparse: false, or more keypoint windows than the
        # map holds (the JAX extractor's dense fallback)
        return FeatureMap(normalize(fmap.permute(1, 2, 0))[None],
                          [kDensePatchId], np.zeros((1, 2), np.int64), scale,
                          is_sparse=False)
