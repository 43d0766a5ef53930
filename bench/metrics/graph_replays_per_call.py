"""``graph_replays_per_call``: exchanges replayed from a CUDA graph per
call over the profiled window, from the program's ``graph_replays``
count (``launch_counts()``): 1 where every exchange of the window
replays its buffer's captured exchange, 0 where every one runs its
Python.  None where the program does not count replays."""


def read(ctx):
    before, after = ctx.counters_before["launches"], ctx.counters_after["launches"]
    calls = ctx.profile["stats"]["calls"]
    if "graph_replays" not in after or not calls:
        return None
    return (after["graph_replays"] - before["graph_replays"]) / calls
