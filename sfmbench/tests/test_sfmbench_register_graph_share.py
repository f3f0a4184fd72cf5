"""The reader of registration's CUDA-graph counters on a made-up run:
replays over captures, replays and eager steps, summed over the window's
maps, and no reading where the program has none of those counters."""

from sfmbench import core

READER = {r.name: r for r in core.load_readers()}["mapper.register_graph_replay_share"]


def _run(counters, maps=2):
    return core.Run(maps=[core.MapRecord(wall_s=9.0, offered=30, registered=30,
                                         counters=dict(counters), timings={}, stats={})
                          for _ in range(maps)], spans=core.Spans())


def test_reader_reads_replays_over_every_chain_frame_step():
    counters = {"chains": 5, "reg_graph_captures": 1, "reg_graph_replays": 27,
                "reg_eager_steps": 2}
    assert READER.read(_run(counters)) == 54 / 60
    assert READER.read(_run({"reg_graph_replays": 24})) == 1.0
    assert READER.read(_run({"reg_eager_steps": 24})) == 0.0
    assert READER.read(_run({"reg_graph_captures": 1, "reg_graph_replays": 3})) == 0.75
    assert READER.drivers == ("chained", "pipeline") and READER.moves == "frames_per_s"
    assert (READER.unit, READER.better, READER.source, READER.layer) == (
        "share", "higher", "program_counter", "mapper")
    # A program without the counters (the parent of this reader) gives no
    # reading, and no error.
    assert READER.read(_run({"chains": 5, "ba_graph_replays": 40})) is None
    assert READER.read(_run({}, maps=0)) is None
