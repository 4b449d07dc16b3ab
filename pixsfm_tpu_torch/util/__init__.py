"""Host-side utilities (copies of ``pixsfm_tpu/util`` modules)."""

from .colmap import (read_image_id_to_name_from_db,  # noqa: F401
                     read_keypoints_from_db, read_matches_from_db,
                     write_keypoints_to_db)
from .database import COLMAPDatabase  # noqa: F401
from .misc import (  # noqa: F401
    check_memory, free_memory, resolve_level_indices, to_colmap_coordinates,
    to_hloc_coordinates, total_memory,
)
from .profiling import SolverSummary, Timer, merge_summaries, trace  # noqa: F401
