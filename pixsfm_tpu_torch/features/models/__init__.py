"""Feature CNN registry (port of ``pixsfm_tpu/features/models/__init__.py``).

Only S2DNet, the default model, is ported; the other models come with a
later slice of the port.
"""

from .base_model import BaseModel  # noqa: F401
from .s2dnet import S2DNet

MODELS = {
    "s2dnet": S2DNet,
}

_LATER = ("vggnet", "dsift", "image", "superpoint", "r2d2", "d2net")


def get_model(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"feature model {name!r} is not ported to pixsfm_tpu_torch yet")
    if name not in MODELS:
        raise ValueError(f"unknown feature model {name!r}; "
                         f"available: {sorted(MODELS)}")
    return MODELS[name]
