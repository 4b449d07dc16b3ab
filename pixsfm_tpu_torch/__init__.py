"""pixsfm_tpu_torch — featuremetric Structure-from-Motion refinement in PyTorch.

The PyTorch/CUDA counterpart of the JAX package ``pixsfm_tpu``: the same
module layout, configs and public API, with every Pallas kernel of the ported
paths replaced by a hand-written CUDA kernel for Hopper (``kernels/csrc``).
This package never imports JAX or ``pixsfm_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU the plain PyTorch version of each kernel runs instead. The ``parallel``
knob of KA, BA and the localizer shards their batches over a device mesh in
one process (``parallel/``), as the JAX package does.
"""

import logging

import torch

__version__ = "0.1.0"

formatter = logging.Formatter(
    fmt="[%(asctime)s %(name)s %(levelname)s] %(message)s",
    datefmt="%Y/%m/%d %H:%M:%S")
handler = logging.StreamHandler()
handler.setFormatter(formatter)
handler.setLevel(logging.INFO)

logger = logging.getLogger("pixsfm_tpu_torch")
logger.setLevel(logging.INFO)
logger.addHandler(handler)
logger.propagate = False


def set_debug():
    """Raise the package logger and its handler to DEBUG (reference:
    pixsfm/__init__.py:28-30)."""
    logger.setLevel(logging.DEBUG)
    handler.setLevel(logging.DEBUG)


def resolve_device(device=None) -> torch.device:
    """``None``/``"auto"`` mean ``cuda``. A CUDA device without a GPU raises:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device in (None, "auto") else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pixsfm_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev


from .config import DictConfig, OmegaConf, load_config, merge  # noqa: E402,F401
from . import base  # noqa: E402,F401
