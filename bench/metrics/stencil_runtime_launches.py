"""``stencil_runtime_launches``: launches of the stencil update per
iteration that took the runtime-radii kernel instead of the fast path
for radii (1, 1, 1), from the program's ``stencil_runtime`` count
(``launch_counts()``) over the profiled window; 0 on the CPU, which
runs no kernel.  None where the program does not count them."""


def read(ctx):
    before, after = ctx.counters_before["launches"], ctx.counters_after["launches"]
    calls = ctx.profile["stats"]["calls"]
    if "stencil_runtime" not in after or not calls:
        return None
    return (after["stencil_runtime"] - before["stencil_runtime"]) / calls
