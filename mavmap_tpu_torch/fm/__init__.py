"""Map store — the reconstruction state (poses, points, tracks)."""

from .map_store import MapStore  # noqa: F401
