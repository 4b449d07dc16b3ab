"""Reference-descriptor cache (reference: pixsfm/features/store_references.py).

Port of ``pixsfm_tpu/features/store_references.py`` with its H5 layout: the
per-point3D robust references (descriptor, source observation, optional kept
observations/costs and 3D node offsets) persist so localization can reload them
without re-extracting dense features. ``h5py`` is imported inside the functions.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..bundle_adjustment.references import Reference

__all__ = ["write_references_cache", "load_references_cache"]


def _host(a):
    """numpy copy of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_references_cache(path, references_per_level: List[Dict[int,
                                                                 Reference]]
                           ) -> None:
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["num_levels"] = len(references_per_level)
        for lvl, refs in enumerate(references_per_level):
            g = f.create_group(f"level_{lvl}")
            for pid, ref in refs.items():
                rg = g.create_group(str(int(pid)))
                rg.create_dataset("descriptor", data=_host(ref.descriptor))
                rg.attrs["source"] = np.asarray(ref.source, np.int64)
                if ref.node_offsets3D is not None:
                    rg.create_dataset("node_offsets3D",
                                      data=_host(ref.node_offsets3D))
                if ref.observations is not None:
                    rg.create_dataset(
                        "observations",
                        data=np.asarray(ref.observations, np.int64))
                    rg.create_dataset("costs", data=_host(ref.costs))
                    rg.create_dataset("track_descriptors",
                                      data=_host(ref.track_descriptors))


def load_references_cache(path) -> List[Dict[int, Reference]]:
    import h5py
    out: List[Dict[int, Reference]] = []
    with h5py.File(path, "r") as f:
        for lvl in range(int(f.attrs["num_levels"])):
            g = f[f"level_{lvl}"]
            refs: Dict[int, Reference] = {}
            for key in g:
                rg = g[key]
                ref = Reference(
                    source=tuple(int(v) for v in rg.attrs["source"]),
                    descriptor=rg["descriptor"][...])
                if "node_offsets3D" in rg:
                    ref.node_offsets3D = rg["node_offsets3D"][...]
                if "observations" in rg:
                    ref.observations = [tuple(int(v) for v in row)
                                        for row in rg["observations"][...]]
                    ref.costs = rg["costs"][...]
                    ref.track_descriptors = rg["track_descriptors"][...]
                refs[int(key)] = ref
            out.append(refs)
    return out
