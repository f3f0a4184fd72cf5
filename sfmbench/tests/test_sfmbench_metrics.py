"""The readers of the program's registration and host-sync counters on a
made-up run: each reads its counters per frame offered (or per LM
iteration) summed over the window's maps, and reads nothing where the
program has no such counter."""

import pytest

from sfmbench import core

READERS = {r.name: r for r in core.load_readers()}
COUNTERS = {"reg_prepare_s": 0.9, "reg_dispatch_s": 2.1, "reg_pose_lm_s": 1.2,
            "reg_wait_s": 0.15, "reg_commit_s": 0.3, "ba_apply_s": 0.06, "host_syncs": 420,
            "ba_host_syncs": 250, "ba_iters": 40, "ba_selfcal_iters": 10}


def _run(counters, maps=2, offered=30):
    return core.Run(maps=[core.MapRecord(wall_s=9.0, offered=offered, registered=offered,
                                         counters=dict(counters), timings={}, stats={})
                          for _ in range(maps)], spans=core.Spans())


@pytest.mark.parametrize("name, value", [
    ("mapper.register_enqueue_ms_per_frame", 1000.0 * (0.9 + 2.1) / 30),
    ("estimators.pose_lm_ms_per_frame", 1000.0 * 1.2 / 30),
    ("mapper.register_wait_ms_per_frame", 1000.0 * 0.15 / 30),
    ("store.commit_ms_per_frame", 1000.0 * (0.3 + 0.06) / 30),
    ("device.host_syncs_per_frame", 420 / 30),
    ("ba.host_syncs_per_lm_iter", 250 / 50),
])
def test_reader_reads_its_counters(name, value):
    r = READERS[name]
    assert r.read(_run(COUNTERS)) == pytest.approx(value)
    assert r.drivers == ("chained", "pipeline") and r.moves == "frames_per_s"
    # A program without the spans and counters (the parent of this
    # benchmark's first traced runs) gives no reading, and no error.
    old = {k: v for k, v in COUNTERS.items() if k in ("ba_iters", "ba_selfcal_iters")}
    assert r.read(_run(old)) is None
    assert r.read(_run({}, maps=0)) is None
