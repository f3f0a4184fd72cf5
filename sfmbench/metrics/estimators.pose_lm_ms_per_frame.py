"""Host milliseconds per frame offered in the pose LM of registration: the
program's register.pose_lm spans around _pose_refine_loop, inside
register.dispatch (counter reg_pose_lm_s). None where the program has no
such span."""

UNIT = "ms"
LAYER = "estimators"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("chained", "pipeline")


def read(run):
    if not run.offered or not any("reg_pose_lm_s" in m.counters for m in run.maps):
        return None
    return 1000.0 * run.counter("reg_pose_lm_s") / run.offered
