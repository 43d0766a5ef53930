"""``pack_unpack_roofline``: the port's pack/unpack kernels' share of
their memory roofline.  One exchange's least pack and unpack bytes
(:func:`bench.roofline.pack_unpack_bytes`, over every rank the process
holds) over the published HBM bandwidth, divided by the device time per
exchange of those kernels (:data:`bench.profiling.PACK_UNPACK_KERNELS`)
in the profiled window of the timed exchange."""

from bench.profiling import PACK_UNPACK_KERNELS, device_seconds
from bench.roofline import pack_unpack_bytes


def read(ctx):
    prof = ctx.profile
    kernel_s = device_seconds(prof, PACK_UNPACK_KERNELS)
    calls = prof["stats"]["calls"]
    if not kernel_s or not calls or ctx.peaks is None:
        return None
    least_s = (pack_unpack_bytes(ctx.interior, ctx.halo) * ctx.ranks_here
               / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least_s / (kernel_s / calls)
