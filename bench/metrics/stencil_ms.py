"""``stencil_ms``: the mean ``stencil`` span, one application of the op
over every rank the process holds (``halo/program.py``'s traced
iteration synchronizes at each span's end)."""


def read(ctx):
    d = [s.duration for s in ctx.spans if s.name == "stencil"]
    return 1e3 * sum(d) / len(d) if d else None
