"""dev.graph_share.shuffle: percent of the window's device shuffle-verifier
runs (counter "dev.shuffle_verify.runs") that replayed the program's
captured CUDA graphs (counter "dev.shuffle_verify.graph_replays"); a run
that captured them is not one. Nothing where the port counts no runs."""


def read(run):
    counters = run.program.get("counters", {})
    runs = counters.get("dev.shuffle_verify.runs")
    if run.kind != "shuffle" or not runs:
        return None
    return 100.0 * counters.get("dev.shuffle_verify.graph_replays", 0.0) / runs
