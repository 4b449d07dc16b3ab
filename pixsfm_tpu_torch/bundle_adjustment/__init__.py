"""Bundle adjustment: problem packing, references, adjusters."""

from .main import (BundleAdjuster, FeatureReferenceBundleAdjuster,  # noqa: F401
                   GeometricBundleAdjuster)
from .problem import (BundleAdjustmentSetup, PackedBA,  # noqa: F401
                      default_problem_setup, find_problem_labels,
                      pack_ba_problem)
from .references import (Reference, extract_references,  # noqa: F401
                         robust_mean_irls)
