"""The system under test, as the benchmark drives it: the program's
``PixSfM`` built from a configuration file, S2DNet's weights from the seed
loaded into its extractor, and an extractor that spans and samples what the
program stores."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import counts


def program_conf(config: Dict, **extra):
    """The preset the configuration names, with its ``overrides`` and
    ``extra`` merged over it."""
    from pixsfm_tpu_torch.config import load_config, merge
    return merge(load_config(config["preset"]), config.get("overrides", {}),
                 extra)


def load_weights(model, weights: Dict[str, torch.Tensor]):
    """Load the seed's S2DNet weights into the program's model; every
    weight it holds must come from them."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"S2DNet weights do not fit the program's model: "
                           f"missing {missing}, unexpected {unexpected}")


def summary_total(out, key: str) -> float:
    """A per-level summary value of a KA / BA output, summed."""
    v = (out or {}).get(key, 0)
    return float(sum(v)) if isinstance(v, (list, tuple)) else float(v)


class RecordingExtractor:
    """The program's extractor behind a span (``extract``), with the
    convolutions' operations counted from the image size and, for the views
    in ``sample``, a few stored keypoint windows kept on the device (rows
    drawn once from the seed) for the comparison after the window, under
    ``(view, keypoint count)``.
    Every other attribute is the extractor's own."""

    def __init__(self, inner, tracer, names_of, sample, seed: int,
                 n_windows: int = 32):
        self.__dict__.update(inner=inner, tracer=tracer, names_of=names_of,
                             sample=set(sample), n_windows=n_windows,
                             recording=False, kept={},
                             rng=np.random.default_rng(seed))
        self.__dict__["rows"] = {}

    def __getattr__(self, key):
        return getattr(self.inner, key)

    def __setattr__(self, key, value):
        if key in self.__dict__:
            self.__dict__[key] = value
        else:
            setattr(self.inner, key, value)

    def _rows(self, key, n, k):
        if key not in self.rows:
            self.rows[key] = np.sort(self.rng.choice(n, min(k, n),
                                                     replace=False))
        return self.rows[key]

    def __call__(self, image, keypoints=None, keypoint_ids=None, **kw):
        with self.tracer.span("extract"):
            fmaps = self.inner(image, keypoints=keypoints,
                               keypoint_ids=keypoint_ids, **kw)
        name = self.names_of(image)
        w, h = self.inner._size(image)
        self.tracer.add_piece("conv", *counts.s2dnet(h, w))
        if self.recording and name in self.sample:
            # one sample per call and keypoint count (a job may extract a
            # view twice: at the keypoints, then at reprojections)
            key = (name, len(keypoints))
            rows = self._rows(key, len(keypoints), self.n_windows)
            self.kept[key] = (np.asarray(keypoints, np.float64)[rows],
                              fmaps[0].patches[torch.as_tensor(
                                  rows, device=fmaps[0].patches.device)]
                              .clone())
        return fmaps


def free_cuda():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample_views(names, k: int, seed: int):
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(list(names), min(k, len(names)),
                             replace=False).tolist())

