"""Host milliseconds per slot of the batched registration steps (the
closures' and the sweeps'): batch_register_s over batch_register_slots."""

UNIT = "ms"
LAYER = "mapper"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("pipeline",)


def read(run):
    slots = run.counter("batch_register_slots")
    return 1000.0 * run.counter("batch_register_s") / slots if slots else None
