"""Numeric core of the port: geometry, camera models, projection,
interpolation, robust losses, match graph (the names ``pixsfm_tpu.base``
exports, and its default config subtrees)."""

from .geometry import (  # noqa: F401
    quat_normalize, quat_mul, quat_conj, quat_rotate, quat_to_rotmat,
    rotmat_to_quat, exp_quat, log_quat, apply_pose, invert_pose, pose_update,
    angle_between_quats,
)
from .cameras import (  # noqa: F401
    CAMERA_MODELS, Camera, CameraModelSpec, img_from_cam, cam_from_img,
)
from .projection import (  # noqa: F401
    world_to_pixel, pixel_to_world, calculate_depth, point_in_front,
)
from .interpolation import (  # noqa: F401
    InterpolationConfig, interpolate, interpolate_with_grad,
    interpolate_nodes, interpolate_nodes_with_grad, ncc_normalize,
)
from .losses import RobustLoss, make_loss  # noqa: F401
from .graph import (  # noqa: F401
    Graph, compute_track_labels, compute_score_labels, compute_root_labels,
    count_track_edges, count_edges_AB,
)

# Default config subtrees (reference: pixsfm/base/main.py:1-22)
interpolation_default_conf = {
    "nodes": [[0.0, 0.0]],
    "mode": "BICUBIC",
    "l2_normalize": True,
    "ncc_normalize": False,
}

solver_default_conf = {
    "function_tolerance": 0.0,
    "gradient_tolerance": 0.0,
    "parameter_tolerance": 1.0e-5,
    "minimizer_progress_to_stdout": False,
    "max_num_iterations": 100,
    "max_linear_solver_iterations": 200,
    "max_num_consecutive_invalid_steps": 10,
    "max_consecutive_nonmonotonic_steps": 10,
    "use_inner_iterations": False,
    "use_nonmonotonic_steps": True,
    "update_state_every_iteration": False,
    "num_threads": 1,
}
