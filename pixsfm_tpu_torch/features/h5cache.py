"""HDF5 feature cache (reference: pixsfm/features/store_features.py, featuremap.cc).

Port of ``pixsfm_tpu/features/h5cache.py`` with the same on-disk layout, so
either package reads the other's files:

- ``chunked`` (reference "format 2", store_features.py:42-71): per image one
  ``patches [N, ps, ps, C]`` dataset (chunk shape ``[1, ps, ps, C]``) plus
  ``keypoint_ids``/``corners``/``scales`` datasets → per-patch reads are single-chunk
  hyperslabs (featuremap.cc:139-267).
- ``grouped`` (reference "format 1", featuremap.cc:92-136): one dataset per patch.

Root attrs carry ``channels_per_level``/``patch_size``/``dtype``/``format``. bfloat16
is stored as uint16 with the ``stored_as_bfloat16`` attribute (HDF5 has no bf16);
the bits go through ``torch.Tensor.view(torch.int16)``. ``h5py`` is imported inside
the functions: the package imports without it, only a cache call needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .featuremaps import FeatureMap, kDensePatchId, window_cut

__all__ = [
    "write_featuremap", "load_featuremap", "read_cache_metadata",
    "init_cache", "cache_has_image", "cache_image_names",
]

_BF16_ATTR = "stored_as_bfloat16"


def _h5py():
    import h5py
    return h5py


def _encode(patches) -> Tuple[np.ndarray, bool]:
    """Host array of a tensor or array; bf16 as its uint16 bits."""
    if isinstance(patches, torch.Tensor):
        t = patches.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(patches), False


def _decode(arr: np.ndarray, is_bf16: bool) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if is_bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def init_cache(path, channels_per_level: Sequence[int], patch_size: int,
               dtype: str, cache_format: str = "chunked",
               overwrite: bool = False) -> None:
    path = Path(path)
    mode = "w" if (overwrite or not path.exists()) else "a"
    with _h5py().File(path, mode) as f:
        f.attrs["channels_per_level"] = list(channels_per_level)
        f.attrs["patch_size"] = patch_size
        f.attrs["dtype"] = dtype
        f.attrs["format"] = cache_format
        for i in range(len(channels_per_level)):
            f.require_group(f"level_{i}")


def read_cache_metadata(path) -> Tuple[List[int], int, str]:
    with _h5py().File(path, "r") as f:
        return ([int(c) for c in f.attrs["channels_per_level"]],
                int(f.attrs["patch_size"]), str(f.attrs["dtype"]))


def _image_group_name(image_name: str) -> str:
    # image names may contain '/'; escape so each image is one flat group
    return image_name.replace("/", "__SLASH__")


def _unescape(group_name: str) -> str:
    return group_name.replace("__SLASH__", "/")


def write_featuremap(path, level_key: str, image_name: str,
                     patches, keypoint_ids: Sequence[int],
                     corners: np.ndarray, scale: np.ndarray,
                     is_sparse: bool = True, upsampling_factor: float = 1.0,
                     cache_format: str = "chunked") -> None:
    """Write one image's map (``patches`` a tensor on any device, or an
    array), replacing an earlier entry of the image."""
    enc, is_bf16 = _encode(patches)
    corners = np.asarray(corners)
    with _h5py().File(path, "a") as f:
        lvl = f.require_group(level_key)
        gname = _image_group_name(image_name)
        if gname in lvl:
            del lvl[gname]
        g = lvl.create_group(gname)
        g.attrs["is_sparse"] = bool(is_sparse)
        g.attrs["upsampling_factor"] = float(upsampling_factor)
        g.attrs[_BF16_ATTR] = bool(is_bf16)
        g.attrs["format"] = cache_format
        if cache_format == "chunked":
            n, ps1, ps2, c = enc.shape
            g.create_dataset("patches", data=enc, chunks=(1, ps1, ps2, c))
            g.create_dataset("keypoint_ids",
                             data=np.asarray(keypoint_ids, dtype=np.int64))
            g.create_dataset("corners", data=np.asarray(corners, np.int32))
            g.create_dataset("scales",
                             data=np.asarray(scale, dtype=np.float64))
        elif cache_format == "grouped":
            pg = g.create_group("patches_grouped")
            for i, kid in enumerate(keypoint_ids):
                d = pg.create_dataset(str(int(kid)), data=enc[i])
                d.attrs["corner"] = np.asarray(
                    corners[i] if corners.ndim > 1 else corners, np.int32)
            g.attrs["scale"] = np.asarray(scale, dtype=np.float64)
        else:
            raise ValueError(f"unknown cache_format {cache_format!r}")


def load_featuremap(path, level_key: str, image_name: str,
                    required_ids: Optional[Sequence[int]] = None,
                    device=None) -> FeatureMap:
    """Load a map onto ``device`` (the CPU unless given). With
    ``required_ids`` only those patch rows are read (present ones; a
    missing id is an observation never extracted). A dense map stored with
    per-keypoint corners (the dense-stored / sparse-loaded mode,
    featuremap.cc:160-168) loads as the sparse map of its ``ps x ps``
    windows at those corners."""
    device = torch.device("cpu") if device is None else torch.device(device)
    with _h5py().File(path, "r") as f:
        g = f[level_key][_image_group_name(image_name)]
        is_bf16 = bool(g.attrs.get(_BF16_ATTR, False))
        is_sparse = bool(g.attrs.get("is_sparse", True))
        ups = float(g.attrs.get("upsampling_factor", 1.0))
        want = None if required_ids is None else \
            {int(i) for i in required_ids}
        if g.attrs.get("format", "chunked") == "grouped":
            pg = g["patches_grouped"]
            scale = np.asarray(g.attrs["scale"], np.float64).reshape(-1, 2)[0]
            keys = [k for k in pg.keys() if want is None or int(k) in want]
            ids = [int(k) for k in keys]
            if keys:
                patches = torch.stack([_decode(pg[k][...], is_bf16)
                                       for k in keys])
                corners = np.stack([np.asarray(pg[k].attrs["corner"])
                                    for k in keys])
            else:
                patches = _decode(np.zeros((0, 0, 0, 0), np.float32), False)
                corners = np.zeros((0, 2), np.int64)
            return FeatureMap(patches.to(device), ids, corners, scale,
                              is_sparse=is_sparse, upsampling_factor=ups)

        kp_ids = np.asarray(g["keypoint_ids"][...], np.int64)
        corners = np.asarray(g["corners"][...], np.int64).reshape(-1, 2)
        scale = np.asarray(g["scales"][...], np.float64).reshape(-1, 2)[0]
        dset = g["patches"]
        sel = np.arange(len(kp_ids)) if want is None else np.asarray(
            [i for i, k in enumerate(kp_ids) if int(k) in want], np.int64)
        if not is_sparse and kp_ids.tolist() != [kDensePatchId]:
            # dense-stored / sparse-loaded: one dense map, a corner per id
            ps = int(f.attrs["patch_size"])
            dense = _decode(dset[0], is_bf16).to(device)
            return FeatureMap(window_cut(dense, corners[sel], ps),
                              kp_ids[sel].tolist(), corners[sel], scale,
                              is_sparse=True, upsampling_factor=ups)
        if len(sel) == len(kp_ids):
            patches = _decode(dset[...], is_bf16)
        elif len(sel):
            patches = _decode(dset[sel], is_bf16)
        else:
            patches = _decode(np.zeros((0,) + dset.shape[1:], dset.dtype),
                              is_bf16)
        return FeatureMap(patches.to(device), kp_ids[sel].tolist(),
                          corners[sel], scale, is_sparse=is_sparse,
                          upsampling_factor=ups)


def cache_has_image(path, level_key: str, image_name: str) -> bool:
    try:
        with _h5py().File(path, "r") as f:
            return _image_group_name(image_name) in f[level_key]
    except (OSError, KeyError):
        return False


def cache_image_names(path, level_key: str) -> List[str]:
    try:
        with _h5py().File(path, "r") as f:
            return [_unescape(k) for k in f[level_key].keys()]
    except (OSError, KeyError):
        return []
