"""``stencil_pairs_per_iteration``: fused pairs of stencil applications
per iteration, from the program's ``stencil_pairs`` count
(``launch_counts()``) over the profiled window: 1 where each iteration
ends an odd chain of radius-1 applications in one launch of its last
two, 0 where the chain is even.  None where the program does not count
them."""


def read(ctx):
    before, after = ctx.counters_before["launches"], ctx.counters_after["launches"]
    calls = ctx.profile["stats"]["calls"]
    if "stencil_pairs" not in after or not calls:
        return None
    return (after["stencil_pairs"] - before["stencil_pairs"]) / calls
