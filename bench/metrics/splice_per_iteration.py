"""``splice_per_iteration``: windows the stencil layer copied into the
state per iteration, from the program's ``splice_copies`` count
(``launch_counts()``) over the profiled window: 1 where each iteration
ends an odd chain of applications, 0 where the scratch chain copies
none.  None where the program does not count them."""


def read(ctx):
    before, after = ctx.counters_before["launches"], ctx.counters_after["launches"]
    calls = ctx.profile["stats"]["calls"]
    if "splice_copies" not in after or not calls:
        return None
    return (after["splice_copies"] - before["splice_copies"]) / calls
