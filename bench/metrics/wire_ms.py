"""``wire_ms``: the device time of every operation other than the
pack/unpack kernels in the profiled window of the timed exchange, per
exchange.  With no stencil in the exchange cells that is the wire: the
transport's gathers and copies of the packed rows."""

from bench.profiling import PACK_UNPACK_KERNELS, device_seconds


def read(ctx):
    prof = ctx.profile
    wire_s = device_seconds(prof, PACK_UNPACK_KERNELS, inside=False)
    calls = prof["stats"]["calls"]
    return 1e3 * wire_s / calls if wire_s and calls else None
