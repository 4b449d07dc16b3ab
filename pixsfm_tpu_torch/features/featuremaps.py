"""Feature storage: maps, sets, manager, packed views.

Port of ``pixsfm_tpu/features/featuremaps.py`` (reference:
pixsfm/features/src/featuremap.cc, featureset.cc, featuremanager.cc,
featureview.cc). Patch payloads are ``torch`` tensors that stay on the
device in their storage dtype (``half`` maps to bfloat16, compute is
float32); metadata (keypoint ids, corners, scales) stays on the host.

- :class:`FeatureMap`: one image's sparse patches ``[N, ps, ps, C]`` aligned
  with ``keypoint_ids`` and ``corners``, or its dense map ``[1, h, w, C]``
  under ``kDensePatchId``.
- :class:`DeviceFeatureMap`: the JAX package's constructor ``(batch,
  keypoint_ids, corners, scale, is_sparse, upsampling_factor, corner)`` over
  the same storage (the port's maps live on the device already), with
  ``to_host()``; ``keep_on_device`` extraction emits it.
- :class:`FeatureSet` / :class:`FeatureManager` may be backed by an H5 cache
  (``features/h5cache.py``): a map is loaded on demand, moved to the set's
  device and not kept (``featureset.cc``'s on-demand semantics).
- :class:`FeatureView` packs exactly the (image, keypoint) patches a solve
  touches into one :class:`PackedFeatures` tensor with device-side gathers;
  a dense map is cut into ``ps x ps`` windows around the given keypoints
  (one device gather per image), or packed whole when none are given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

__all__ = [
    "kDensePatchId", "storage_dtype", "window_cut", "FeaturePatch",
    "FeatureMap", "DeviceFeatureMap", "FeatureSet", "FeatureManager",
    "FeatureView", "PackedFeatures",
]

# Keypoint id under which a dense map is stored (reference:
# util/src/types.h:33)
kDensePatchId = 1000000

_DTYPES = {
    "half": torch.bfloat16, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float": torch.float32,
    "float32": torch.float32, "double": torch.float64,
    "float64": torch.float64,
}


def storage_dtype(name: str) -> torch.dtype:
    """Storage dtype for a config name (``half`` -> bfloat16)."""
    return _DTYPES[str(name)]


def window_cut(fmap: torch.Tensor, corners: np.ndarray, ps: int):
    """The ``[N, ps, ps, C]`` windows of a ``[h, w, C]`` map whose origins
    are the integer ``corners [N, 2]`` (x, y), in one device gather. On an
    axis where the map is shorter than ``ps`` the windows span the map
    (``min(ps, h)`` rows, ``min(ps, w)`` columns), as the JAX package's
    slices do."""
    cr = torch.as_tensor(np.asarray(corners), device=fmap.device,
                         dtype=torch.int64)
    h, w = fmap.shape[:2]
    ys = (cr[:, 1, None] + torch.arange(min(ps, h), device=fmap.device))
    xs = (cr[:, 0, None] + torch.arange(min(ps, w), device=fmap.device))
    return fmap[ys[:, :, None], xs[:, None, :]]


@dataclass
class FeaturePatch:
    """One ``[H, W, C]`` patch of a map (reference: featurepatch.h:63-79).

    ``data`` is a view of the map's tensor (on its device); ``corner`` the
    map pixel (x, y) of the patch origin; ``scale`` the featuremap/image
    ratio; ``upsampling_factor`` the costmap upsampling."""
    data: torch.Tensor                  # [H, W, C]
    corner: np.ndarray                  # [2] (x, y) int
    scale: np.ndarray                   # [2] (sx, sy)
    upsampling_factor: float = 1.0

    def __post_init__(self):
        self.corner = np.asarray(self.corner).reshape(2)
        self.scale = np.asarray(self.scale, dtype=np.float64).reshape(2)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]

    @property
    def channels(self):
        return self.data.shape[2]

    def to_pixel_coordinates(self, xy):
        """Image coords -> patch pixel coords (featurepatch.h:252-256)."""
        xy = np.asarray(xy, dtype=np.float64)
        return (xy * self.scale - 0.5 - self.corner) * self.upsampling_factor

    def to_image_coordinates(self, uv):
        """Patch pixel coords -> image coords (featurepatch.h:258-262)."""
        uv = np.asarray(uv, dtype=np.float64)
        return (uv / self.upsampling_factor + self.corner + 0.5) / self.scale


class FeatureMap:
    """Per-image patches (reference: featuremap.h:103-118).

    Sparse: ``patches [N, ps, ps, C]`` tensor, ``keypoint_ids`` (N ints),
    ``corners [N, 2]`` (x, y) featuremap pixel of each patch origin.
    Dense (``is_sparse=False``): the whole map ``[1, h, w, C]`` under
    ``kDensePatchId``, corner (0, 0); every keypoint reads it. ``scale
    [2]`` is the featuremap/image ratio.
    """

    def __init__(self, patches: torch.Tensor, keypoint_ids: Sequence[int],
                 corners: np.ndarray, scale, is_sparse: bool = True,
                 upsampling_factor: float = 1.0):
        self.is_sparse = bool(is_sparse)
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

    @property
    def is_dense(self) -> bool:
        return not self.is_sparse

    def keypoint_ids(self) -> List[int]:
        return list(self._ids)

    def row_of(self, p2D_idx: int) -> int:
        if self.is_dense:
            return 0
        return self._row.get(int(p2D_idx), -1)

    def get_patch(self, p2D_idx: int) -> FeaturePatch:
        """The patch of a keypoint; a dense map's whole map for any."""
        r = self.row_of(p2D_idx)
        if r < 0:
            raise KeyError(p2D_idx)
        return FeaturePatch(self.patches[r], self.corners[r], self.scale,
                            self.upsampling_factor)

    def __contains__(self, p2D_idx: int) -> bool:
        return self.is_dense or int(p2D_idx) in self._row

    def __len__(self):
        return len(self._ids)


class DeviceFeatureMap(FeatureMap):
    """A map built from a device batch, with the JAX package's constructor.

    Sparse: ``batch [N, ps, ps, C]`` aligned with ``keypoint_ids`` /
    ``corners [N, 2]``. Dense: ``batch [h, w, C]`` with one ``corner``. The
    port's :class:`FeatureMap` keeps its patches on the device already, so
    this class adds the JAX package's interface, not a memory path:
    :class:`FeatureView` packs it like any map."""

    def __init__(self, batch: torch.Tensor,
                 keypoint_ids: Optional[Sequence[int]],
                 corners: Optional[np.ndarray], scale,
                 is_sparse: bool = True, upsampling_factor: float = 1.0,
                 corner=(0, 0)):
        if is_sparse:
            if keypoint_ids is None or corners is None:
                raise ValueError("sparse DeviceFeatureMap needs ids + corners")
            super().__init__(batch, keypoint_ids, corners, scale, True,
                             upsampling_factor)
        else:
            super().__init__(batch[None], [kDensePatchId],
                             np.asarray(corner, np.int64).reshape(1, 2),
                             scale, False, upsampling_factor)

    @property
    def batch(self) -> torch.Tensor:
        return self.patches if self.is_sparse else self.patches[0]

    @property
    def corner(self) -> Optional[np.ndarray]:
        return None if self.is_sparse else self.corners[0]

    def to_host(self) -> FeatureMap:
        """A full host (CPU) copy as a plain :class:`FeatureMap`."""
        return FeatureMap(self.patches.cpu(), self._ids, self.corners,
                          self.scale, self.is_sparse, self.upsampling_factor)


class FeatureSet:
    """One CNN level: {image_name -> FeatureMap} (reference: featureset.cc),
    optionally backed by an H5 cache (``h5_path``, group ``h5_key``) whose
    maps are loaded on demand onto ``device`` and not kept."""

    def __init__(self, channels: int, patch_size: int, dtype: str = "half",
                 h5_path=None, h5_key: Optional[str] = None, device=None):
        self.channels = channels
        self.patch_size = patch_size
        self.dtype = dtype
        self.maps: Dict[str, FeatureMap] = {}
        self.h5_path = h5_path
        self.h5_key = h5_key
        self.device = device

    def emplace(self, image_name: str, fmap: FeatureMap) -> None:
        self.maps[image_name] = fmap

    def has_image(self, image_name: str) -> bool:
        return image_name in self.maps or self._in_cache(image_name)

    def _in_cache(self, image_name: str) -> bool:
        if self.h5_path is None:
            return False
        from .h5cache import cache_has_image
        return cache_has_image(self.h5_path, self.h5_key, image_name)

    def get_map(self, image_name: str,
                required_ids: Optional[Sequence[int]] = None) -> FeatureMap:
        """The map of an image; from the cache (only the ``required_ids``
        rows of a sparse map) when the set does not hold it."""
        if image_name in self.maps:
            return self.maps[image_name]
        if self.h5_path is not None:
            from .. import resolve_device
            from .h5cache import load_featuremap
            return load_featuremap(self.h5_path, self.h5_key, image_name,
                                   required_ids,
                                   device=resolve_device(self.device))
        raise KeyError(image_name)

    def unload(self, image_name: Optional[str] = None):
        if image_name is None:
            self.maps.clear()
        else:
            self.maps.pop(image_name, None)

    def flush(self):
        """Nothing to write: the cache is written by ``h5cache``'s
        writers (the JAX package's no-op, kept for its API)."""
        return None

    def image_names(self) -> List[str]:
        names = set(self.maps.keys())
        if self.h5_path is not None:
            from .h5cache import cache_image_names
            names.update(cache_image_names(self.h5_path, self.h5_key))
        return sorted(names)


class FeatureManager:
    """All levels of a feature pyramid (reference: featuremanager.{h,cc})."""

    def __init__(self, channels_per_level: Sequence[int], patch_size: int,
                 dtype: str = "half", h5_path=None, device=None):
        self.channels_per_level = list(channels_per_level)
        self.patch_size = patch_size
        self.dtype = dtype
        self.levels: List[FeatureSet] = [
            FeatureSet(c, patch_size, dtype, h5_path=h5_path,
                       h5_key=f"level_{i}", device=device)
            for i, c in enumerate(self.channels_per_level)]

    @classmethod
    def from_cache(cls, h5_path, device=None) -> "FeatureManager":
        """A manager whose maps load from the H5 cache at ``h5_path`` onto
        ``device`` (``cuda`` unless given)."""
        from .h5cache import read_cache_metadata
        channels_per_level, patch_size, dtype = read_cache_metadata(h5_path)
        return cls(channels_per_level, patch_size, dtype, h5_path=h5_path,
                   device=device)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def fset(self, level: int) -> FeatureSet:
        return self.levels[level]


@dataclass
class PackedFeatures:
    """Stacked patches for a solve.

    ``index``: {(image_name, p2D_idx) -> row}; ``dense_images``: {image_name
    -> row} of the dense maps packed whole, whose row serves every keypoint
    of the image. ``patches`` is a device tensor in the storage dtype;
    kernels convert to float32.
    """
    patches: torch.Tensor        # [B, ps, ps, C]
    corners: np.ndarray          # [B, 2] float64 (x, y)
    scales: np.ndarray           # [B, 2] float64 (sx, sy)
    upsampling: np.ndarray       # [B] float32
    index: Dict[Tuple[str, int], int]
    dense_images: Dict[str, int] = field(default_factory=dict)

    @property
    def num_patches(self) -> int:
        return self.patches.shape[0]

    @property
    def channels(self) -> int:
        return self.patches.shape[-1]

    def row(self, image_name: str, p2D_idx: int) -> int:
        if image_name in self.dense_images:
            return self.dense_images[image_name]
        return self.index[(image_name, int(p2D_idx))]

    def rows(self, pairs: Iterable[Tuple[str, int]]) -> np.ndarray:
        return np.asarray([self.row(n, i) for n, i in pairs], dtype=np.int32)

    def row_or(self, image_name: str, p2D_idx: int, default: int = -1) -> int:
        """Packed row of an observation, ``default`` for one that was never
        extracted (e.g. a reprojection behind the camera)."""
        if image_name in self.dense_images:
            return self.dense_images[image_name]
        return self.index.get((image_name, int(p2D_idx)), default)

    def _image_lut(self, image_name: str) -> Optional[np.ndarray]:
        """The dense ``p2D_idx -> row`` lookup table of one image (-1 where
        a keypoint is not packed; all built once), None for an image
        without packed rows."""
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
        return cache.get(image_name)

    def rows_for_image(self, image_name: str,
                       p2D_idxs: np.ndarray) -> np.ndarray:
        """Packed rows of many keypoints of ONE image."""
        p2D_idxs = np.asarray(p2D_idxs, np.int64)
        if image_name in self.dense_images:
            return np.full(len(p2D_idxs), self.dense_images[image_name],
                           np.int64)
        lut = self._image_lut(image_name)
        if lut is None:
            raise KeyError(image_name)
        rows = lut[p2D_idxs]
        if (rows < 0).any():
            missing = p2D_idxs[rows < 0][:5]
            raise KeyError(f"{image_name}: keypoints {missing} not packed")
        return rows

    def rows_or_for_image(self, image_name: str, p2D_idxs: np.ndarray,
                          default: int = -1) -> np.ndarray:
        """:meth:`row_or` for many keypoints of ONE image."""
        p2D_idxs = np.asarray(p2D_idxs, np.int64)
        if image_name in self.dense_images:
            return np.full(len(p2D_idxs), self.dense_images[image_name],
                           np.int64)
        rows = np.full(len(p2D_idxs), default, np.int64)
        lut = self._image_lut(image_name)
        if lut is None:
            return rows
        inside = (p2D_idxs >= 0) & (p2D_idxs < len(lut))
        found = lut[p2D_idxs[inside]]
        rows[np.nonzero(inside)[0][found >= 0]] = found[found >= 0]
        return rows


class FeatureView:
    """Packs exactly the patches a solve touches (reference: featureview.cc).

    Each image contributes one device-side ``index_select`` of the rows it
    needs (the whole map, in order, without a copy when all are needed), or
    for a dense map one gather of the ``ps x ps`` windows around the
    requested ``keypoints`` (image coordinates per image: corner ``floor(xy
    * scale - 0.5 - ps / 2)``, clipped into the map, as the JAX package
    slices), or the whole dense map as one row when the image has no
    keypoints; the parts are concatenated on the device.
    """

    def __init__(self, fset: FeatureSet,
                 required: Mapping[str, Sequence[int]],
                 keypoints: Optional[Mapping[str, np.ndarray]] = None):
        self.fset = fset
        ps = fset.patch_size
        parts: List[torch.Tensor] = []
        n_rows = 0
        corners, scales, ups = [], [], []
        index: Dict[Tuple[str, int], int] = {}
        dense_images: Dict[str, int] = {}
        n_missing = 0
        for image_name, ids in required.items():
            fmap = fset.get_map(image_name, required_ids=list(ids))
            if fmap.is_dense:
                kps = None if keypoints is None else keypoints.get(
                    image_name)
                if kps is None:
                    # the whole dense map as one shared row
                    dense_images[image_name] = n_rows
                    n_rows += 1
                    parts.append(fmap.patches)
                    corners.append(fmap.corners[:1])
                    scales.append(fmap.scale[None])
                    ups.append(np.full(1, fmap.upsampling_factor,
                                       np.float32))
                    continue
                want = [i for i in dict.fromkeys(int(i) for i in ids)
                        if (image_name, i) not in index]
                if not want:
                    continue
                fh, fw = fmap.patches.shape[1:3]
                cpix = np.asarray(kps, np.float64)[want] * fmap.scale - 0.5
                cs = np.clip(np.floor(cpix - ps / 2).astype(np.int64)
                             + fmap.corners[0],
                             [0, 0], [max(fw - ps, 0), max(fh - ps, 0)])
                parts.append(window_cut(fmap.patches[0], cs, ps))
                for i in want:
                    index[(image_name, i)] = n_rows
                    n_rows += 1
                corners.append(cs)
                scales.append(np.repeat(fmap.scale[None], len(want), axis=0))
                ups.append(np.full(len(want), fmap.upsampling_factor,
                                   np.float32))
                continue
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
                index=index, dense_images=dense_images)
        else:
            C = fset.channels
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
        3D points (``featuremaps.py:612`` of the JAX package); dense maps
        are cut around the stored observations ``xys``."""
        required: Dict[str, List[int]] = {}
        p3D_ids = (reconstruction.points3D.keys() if point3D_ids is None
                   else point3D_ids)
        for pid in p3D_ids:
            for image_id, p2D_idx in reconstruction.points3D[pid].track:
                name = reconstruction.images[image_id].name
                required.setdefault(name, []).append(int(p2D_idx))
        keypoints = {im.name: im.xys
                     for im in reconstruction.images.values()}
        return cls(fset, required, keypoints=keypoints)

    @classmethod
    def from_image_list(cls, fset: FeatureSet,
                        image_names: Sequence[str]) -> "FeatureView":
        """Every patch of the given images."""
        return cls(fset, {name: fset.get_map(name).keypoint_ids()
                          for name in image_names})
