"""``shell_ms``: the device time per iteration of the operations
launched inside the program's ``tempi.shell`` ranges: each application's
shell slabs around its chain block in the overlapped iteration
(``halo/stencil.py``'s ``overlapped_stencil_iteration``), and the copies
that write them and the block into the state.  From the profiled
window's ``device_s_by_range`` (:mod:`bench.profiling`); None where no
device operation links to its launch (the CPU) or none was launched in
a shell range."""


def read(ctx):
    prof = ctx.profile
    shell_s = prof.get("device_s_by_range", {}).get("tempi.shell")
    calls = prof["stats"]["calls"]
    return 1e3 * shell_s / calls if shell_s and calls else None
