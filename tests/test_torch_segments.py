"""Segment-parallel mapping of the PyTorch port held against the JAX
package, on tests/test_torch_merge.py's 16-image survey (capacity 512, 128
RANSAC trials) and through its helpers. The packages draw different RANSAC
samples, so the checks are on outcomes: parallel_segments=2 with loop
detection maps two segments (overlap 4), a mapper each, merged in the
post-pass, whose cross-loop closures raise the common images; one map of
every frame in both packages, and the port's ATE under max(2x JAX's,
0.05 m). (The merge's adjacency fallback, with segments but without a
tree, is in tests/test_torch_merge.py, beside the runs whose compiled JAX
programs it shares.)
"""

import pytest

from tests.test_torch_merge import N, OPTS, _frames, _run_both, survey  # noqa: F401
from mavmap_tpu.utils.synthetic import mapper_ate as j_ate
from mavmap_tpu_torch.utils.synthetic import mapper_ate


def test_parallel_segments_matches_jax(survey):
    """Two segments of the survey (overlap 4), each with its own mapper
    and loop detection, merged in the post-pass: one map of every frame in
    both packages."""
    kw = dict(OPTS, parallel_segments=2, segment_overlap=4)
    rt, rj = _run_both(survey, lambda f: f, N, kw)
    assert len(rt.mappers) == len(rj.mappers) == 1
    assert _frames(rt) == _frames(rj) == [list(range(N))]
    rep = rt.main_mapper.report()
    assert rep["merges"] == 1 and rep["merge_closures"] > 0
    assert rep["merge_common_after"] > rep["merge_common_before"] >= 3
    assert {"sequential_loop", "backfill", "global_ba", "merge"} <= set(rt.timings)
    (ts, _, _), (js, _, _) = survey
    ate_t, ate_j = mapper_ate(rt.main_mapper, ts), j_ate(rj.main_mapper, js)
    assert ate_t < max(2.0 * ate_j, 0.05), (ate_t, ate_j)
