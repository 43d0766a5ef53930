"""``idle_pct.exchange``: the share of the profiled window of exchanges
in which no operation ran on the device."""


def read(ctx):
    prof = ctx.profile
    if prof.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
