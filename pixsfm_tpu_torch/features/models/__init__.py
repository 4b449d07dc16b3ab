"""Feature CNN registry (port of ``pixsfm_tpu/features/models/__init__.py``):
the dense-feature models (S2DNet, VGGNet, dense SIFT, the identity
``image`` model) and the detectors (SuperPoint, R2D2, D2-Net), each an
``nn.Module`` in NCHW."""

from .base_model import BaseModel  # noqa: F401
from .d2net import D2Net
from .dsift import DSIFT
from .image import ImageModel
from .r2d2 import R2D2
from .s2dnet import S2DNet
from .superpoint import SuperPoint
from .vggnet import VGGNet

MODELS = {
    "s2dnet": S2DNet,
    "vggnet": VGGNet,
    "dsift": DSIFT,
    "image": ImageModel,
    "superpoint": SuperPoint,
    "r2d2": R2D2,
    "d2net": D2Net,
}


def get_model(name: str):
    if name not in MODELS:
        raise ValueError(f"unknown feature model {name!r}; "
                         f"available: {sorted(MODELS)}")
    return MODELS[name]
