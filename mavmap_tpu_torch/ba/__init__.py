"""Bundle adjustment: robust Levenberg-Marquardt via Schur complement."""

from .core import (  # noqa: F401
    BAOptions,
    DENSE_SOLVER_MAX_CAMERAS,
    BAProblem,
    BA_POSE_FREE,
    BA_POSE_FIXED,
    BA_POSE_FIXED_X,
    build_problem,
    bundle_adjust,
    bundle_adjust_async,
    pose_refinement,
)
