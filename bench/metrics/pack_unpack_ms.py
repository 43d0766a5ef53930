"""``pack_unpack_ms``: the device time of the port's pack/unpack kernels
(:data:`bench.profiling.PACK_UNPACK_KERNELS`) in the profiled window of
the timed exchange, per exchange."""

from bench.profiling import PACK_UNPACK_KERNELS, device_seconds


def read(ctx):
    prof = ctx.profile
    kernel_s = device_seconds(prof, PACK_UNPACK_KERNELS)
    calls = prof["stats"]["calls"]
    return 1e3 * kernel_s / calls if kernel_s and calls else None
