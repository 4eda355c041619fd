"""graph.host_ms_per_replay: the mean of the port's ``graph.replay`` spans in the
window, the traced slice left out: the copy into the graph's inputs, the launch
and the clones of its outputs, host ms a replay."""

from benchmark.harness.program import program


def read(run):
    p = program(run)
    if p is None or p.totals.get("graph.replay", (0.0, 0))[1] == 0:
        return None
    seconds, n = p.totals["graph.replay"]
    return 1e3 * seconds / n
