"""``stencil_roofline``: the stencil's share of its memory roofline.  The
least bytes of the traced iterations' applications
(:func:`bench.roofline.stencil_iteration_bytes`, over every rank the
process holds) over the published HBM bandwidth, divided by the time of
their ``stencil`` spans."""

from bench.roofline import stencil_iteration_bytes


def read(ctx):
    spans = [s.duration for s in ctx.spans if s.name == "stencil"]
    iterations = sum(1 for s in ctx.spans if s.name == "program_iteration")
    if not spans or not iterations or ctx.peaks is None:
        return None
    per_iteration = stencil_iteration_bytes(ctx.interior, ctx.halo, ctx.op_radii, ctx.steps)
    least_s = per_iteration * ctx.ranks_here * iterations / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / sum(spans)
