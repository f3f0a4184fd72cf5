"""Host milliseconds per frame offered in the CLI's feature extraction
ahead of mapping, the stage the user waits for: the program's
`cli.features` span (every frame decoded, detected on the card and its
features cached, on three worker threads), from the CLI's own timings."""

UNIT = "ms"
LAYER = "feature extraction"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("photo_cli",)


def read(run):
    if not run.offered or not any("cli.features" in m.timings for m in run.maps):
        return None
    return 1000.0 * sum(m.timings.get("cli.features", 0.0) for m in run.maps) / run.offered
