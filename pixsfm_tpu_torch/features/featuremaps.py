"""Feature storage: maps, sets, manager, packed views.

Port of ``pixsfm_tpu/features/featuremaps.py`` (reference:
pixsfm/features/src/featuremap.cc, featureset.cc, featuremanager.cc,
featureview.cc). Patch payloads are ``torch`` tensors that stay on the
device in their storage dtype (``half`` maps to bfloat16, compute is
float32); metadata (keypoint ids, corners, scales) stays on the host.

- :class:`FeatureMap`: one image's sparse patches ``[N, ps, ps, C]`` aligned
  with ``keypoint_ids`` and ``corners``.
- :class:`FeatureView` packs exactly the (image, keypoint) patches a solve
  touches into one :class:`PackedFeatures` tensor with device-side gathers.

Only sparse maps are ported. Dense maps and the H5 cache come with a later
slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "storage_dtype", "FeatureMap", "FeatureSet", "FeatureManager",
    "FeatureView", "PackedFeatures",
]

_DTYPES = {
    "half": torch.bfloat16, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float": torch.float32,
    "float32": torch.float32, "double": torch.float64,
    "float64": torch.float64,
}


def storage_dtype(name: str) -> torch.dtype:
    """Storage dtype for a config name (``half`` -> bfloat16)."""
    return _DTYPES[str(name)]


class FeatureMap:
    """Per-image sparse patches (reference: featuremap.h:103-118).

    ``patches [N, ps, ps, C]`` tensor, ``keypoint_ids`` (N ints), ``corners
    [N, 2]`` (x, y) featuremap pixel of each patch origin, ``scale [2]``
    featuremap/image ratio.
    """

    def __init__(self, patches: torch.Tensor, keypoint_ids: Sequence[int],
                 corners: np.ndarray, scale, is_sparse: bool = True,
                 upsampling_factor: float = 1.0):
        if not is_sparse:
            raise NotImplementedError(
                "dense featuremaps are not ported yet; they come with a "
                "later slice of pixsfm_tpu_torch")
        self.patches = patches
        self._ids = [int(k) for k in keypoint_ids]
        self.corners = np.asarray(corners, np.int64).reshape(-1, 2)
        if len(self.corners) == 1 and len(self._ids) > 1:
            self.corners = np.repeat(self.corners, len(self._ids), axis=0)
        self.scale = np.asarray(scale, np.float64).reshape(2)
        self.upsampling_factor = float(upsampling_factor)
        self._row = {k: i for i, k in enumerate(self._ids)}

    @classmethod
    def from_arrays(cls, patches, keypoint_ids: Sequence[int],
                    corners: np.ndarray, scale, is_sparse: bool = True,
                    upsampling_factor: float = 1.0,
                    device=None) -> "FeatureMap":
        """From a stacked ``[N, ps, ps, C]`` array or tensor."""
        if not isinstance(patches, torch.Tensor):
            patches = torch.from_numpy(np.ascontiguousarray(patches))
        if device is not None:
            patches = patches.to(device)
        return cls(patches, keypoint_ids, corners, scale, is_sparse,
                   upsampling_factor)

    def keypoint_ids(self) -> List[int]:
        return list(self._ids)

    def row_of(self, p2D_idx: int) -> int:
        return self._row.get(int(p2D_idx), -1)

    def __len__(self):
        return len(self._ids)


class FeatureSet:
    """One CNN level: {image_name -> FeatureMap} (reference: featureset.cc)."""

    def __init__(self, channels: int, patch_size: int, dtype: str = "half"):
        self.channels = channels
        self.patch_size = patch_size
        self.dtype = dtype
        self.maps: Dict[str, FeatureMap] = {}

    def emplace(self, image_name: str, fmap: FeatureMap) -> None:
        self.maps[image_name] = fmap

    def get_map(self, image_name: str) -> FeatureMap:
        return self.maps[image_name]


class FeatureManager:
    """All levels of a feature pyramid (reference: featuremanager.{h,cc})."""

    def __init__(self, channels_per_level: Sequence[int], patch_size: int,
                 dtype: str = "half"):
        self.channels_per_level = list(channels_per_level)
        self.patch_size = patch_size
        self.dtype = dtype
        self.levels: List[FeatureSet] = [
            FeatureSet(c, patch_size, dtype) for c in self.channels_per_level]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def fset(self, level: int) -> FeatureSet:
        return self.levels[level]


@dataclass
class PackedFeatures:
    """Stacked patches for a solve.

    ``index``: {(image_name, p2D_idx) -> row}. ``patches`` is a device tensor
    in the storage dtype; kernels convert to float32.
    """
    patches: torch.Tensor        # [B, ps, ps, C]
    corners: np.ndarray          # [B, 2] float64 (x, y)
    scales: np.ndarray           # [B, 2] float64 (sx, sy)
    upsampling: np.ndarray       # [B] float32
    index: Dict[Tuple[str, int], int]

    @property
    def num_patches(self) -> int:
        return self.patches.shape[0]

    @property
    def channels(self) -> int:
        return self.patches.shape[-1]

    def row_or(self, image_name: str, p2D_idx: int, default: int = -1) -> int:
        """Packed row of an observation, ``default`` for one that was never
        extracted (e.g. a reprojection behind the camera)."""
        return self.index.get((image_name, int(p2D_idx)), default)

    def rows_for_image(self, image_name: str,
                       p2D_idxs: np.ndarray) -> np.ndarray:
        """Packed rows of many keypoints of ONE image (a dense ``p2D_idx
        -> row`` lookup table per image, built once)."""
        p2D_idxs = np.asarray(p2D_idxs, np.int64)
        cache = self.__dict__.setdefault("_image_row_cache", {})
        if not cache:
            per_image: Dict[str, list] = {}
            for (n, i), row in self.index.items():
                per_image.setdefault(n, []).append((i, row))
            for n, pairs in per_image.items():
                arr = np.asarray(pairs, np.int64)
                lut_n = np.full(int(arr[:, 0].max()) + 1, -1, np.int64)
                lut_n[arr[:, 0]] = arr[:, 1]
                cache[n] = lut_n
        lut = cache.get(image_name)
        if lut is None:
            raise KeyError(image_name)
        rows = lut[p2D_idxs]
        if (rows < 0).any():
            missing = p2D_idxs[rows < 0][:5]
            raise KeyError(f"{image_name}: keypoints {missing} not packed")
        return rows


class FeatureView:
    """Packs exactly the patches a solve touches (reference: featureview.cc).

    Each image contributes one device-side ``index_select`` of the rows it
    needs (the whole map, in order, without a copy when all are needed);
    the parts are concatenated on the device.
    """

    def __init__(self, fset: FeatureSet,
                 required: Mapping[str, Sequence[int]],
                 keypoints: Optional[Mapping[str, np.ndarray]] = None):
        # ``keypoints`` slices dense maps in the JAX package; only sparse
        # maps are ported, so it is accepted for API parity and unused.
        self.fset = fset
        parts: List[torch.Tensor] = []
        n_rows = 0
        corners, scales, ups = [], [], []
        index: Dict[Tuple[str, int], int] = {}
        n_missing = 0
        for image_name, ids in required.items():
            fmap = fset.get_map(image_name)
            want = []
            for p2D_idx in ids:
                key = (image_name, int(p2D_idx))
                if key in index:
                    continue
                r = fmap.row_of(int(p2D_idx))
                if r < 0:
                    # observation not extracted: consumers treat missing rows
                    # as invalid observations
                    n_missing += 1
                    continue
                index[key] = n_rows
                n_rows += 1
                want.append(r)
            if not want:
                continue
            sel = np.asarray(want, np.int64)
            corners.append(fmap.corners[sel])
            scales.append(np.repeat(fmap.scale[None], len(sel), axis=0))
            ups.append(np.full(len(sel), fmap.upsampling_factor, np.float32))
            if len(sel) == len(fmap) and (sel == np.arange(len(fmap))).all():
                parts.append(fmap.patches)
            else:
                parts.append(fmap.patches.index_select(
                    0, torch.as_tensor(sel, device=fmap.patches.device)))
        if n_missing:
            from .. import logger
            logger.warning(
                "FeatureView: %d requested observation(s) have no extracted "
                "patch; treating them as invalid.", n_missing)
        if n_rows:
            if len({tuple(p.shape[1:]) for p in parts}) > 1:
                raise ValueError("cannot stack featuremaps of differing "
                                 "patch shapes")
            patches = parts[0] if len(parts) == 1 else torch.cat(parts)
            self.packed = PackedFeatures(
                patches=patches,
                corners=np.concatenate(corners).astype(np.float64),
                scales=np.concatenate(scales).astype(np.float64),
                upsampling=np.concatenate(ups),
                index=index)
        else:
            ps, C = fset.patch_size, fset.channels
            self.packed = PackedFeatures(
                torch.zeros((0, ps, ps, C)), np.zeros((0, 2)),
                np.ones((0, 2)), np.ones((0,), np.float32), {})

    @classmethod
    def from_graph(cls, fset: FeatureSet, graph,
                   node_subset: Optional[Sequence[int]] = None,
                   keypoints: Optional[Mapping[str, np.ndarray]] = None
                   ) -> "FeatureView":
        image_ids, feature_idxs = graph.nodes_array()
        node_ids = (np.arange(graph.num_nodes) if node_subset is None
                    else np.asarray(node_subset))
        required: Dict[str, List[int]] = {}
        for nid in node_ids:
            name = graph.image_id_to_name[int(image_ids[nid])]
            required.setdefault(name, []).append(int(feature_idxs[nid]))
        return cls(fset, required, keypoints=keypoints)

    @classmethod
    def from_reconstruction(cls, fset: FeatureSet, reconstruction,
                            point3D_ids: Optional[Sequence[int]] = None
                            ) -> "FeatureView":
        """The patches of every track observation of the given (or all)
        3D points (``featuremaps.py:612`` of the JAX package)."""
        required: Dict[str, List[int]] = {}
        p3D_ids = (reconstruction.points3D.keys() if point3D_ids is None
                   else point3D_ids)
        for pid in p3D_ids:
            for image_id, p2D_idx in reconstruction.points3D[pid].track:
                name = reconstruction.images[image_id].name
                required.setdefault(name, []).append(int(p2D_idx))
        return cls(fset, required)
