"""ETH3D dataset fetch helper (reference: pixsfm/eval/eth3d/download.py).

Copy of ``pixsfm_tpu/eval/eth3d/download.py``. It downloads nothing: the
function checks for a pre-fetched dataset and otherwise logs the required
layout and where to fetch it from.
"""

from __future__ import annotations

from pathlib import Path

from ... import logger
from .config import DOWNLOAD_URL, SCENES

__all__ = ["ensure_dataset"]

EXPECTED_LAYOUT = """
<dataset_dir>/<scene>/images/dslr_images_undistorted/*.JPG
<dataset_dir>/<scene>/dslr_calibration_undistorted/{cameras,images,points3D}.txt
<dataset_dir>/<scene>/scan/*.ply              (ground-truth laser scan)
"""


def ensure_dataset(dataset_dir, scenes=SCENES) -> bool:
    dataset_dir = Path(dataset_dir)
    missing = [s for s in scenes if not (dataset_dir / s).exists()]
    if missing:
        logger.warning(
            "ETH3D scenes missing under %s: %s\n"
            "This helper downloads nothing; pre-fetch the scenes from %s "
            "with the layout:%s", dataset_dir, ", ".join(missing), DOWNLOAD_URL,
            EXPECTED_LAYOUT)
        return False
    return True
