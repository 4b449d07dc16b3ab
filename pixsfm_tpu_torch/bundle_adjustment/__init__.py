"""Bundle adjustment: problem packing, references, adjusters."""

from .costmaps import costmap_ba, extract_costmaps  # noqa: F401
from .main import (BundleAdjuster, CostMapBundleAdjuster,  # noqa: F401
                   FeatureReferenceBundleAdjuster, GeometricBundleAdjuster,
                   PatchWarpBundleAdjuster)
from .patch_warp import patch_warp_ba  # noqa: F401
from .problem import (BundleAdjustmentSetup, PackedBA,  # noqa: F401
                      default_problem_setup, find_problem_labels,
                      pack_ba_problem)
from .references import (Reference, extract_references,  # noqa: F401
                         robust_mean_irls)
