"""Ranks of torch.distributed: the point-sharded bundle adjustment and the
batched fan-outs with their slots split over ranks (the JAX package's
mavmap_tpu/parallel/ over a device mesh)."""

from .dist_ba import dist_bundle_adjust, partition_problem  # noqa: F401
from .dist_match import dist_match_pairs  # noqa: F401
from .dist_register import (  # noqa: F401
    dist_match_counts,
    dist_register_view_batch,
    dist_register_view_pairs,
)
from .multihost import (  # noqa: F401
    Mesh,
    global_mesh,
    host_local_to_global,
    init_multihost,
    launch,
    process_shard_bounds,
)
