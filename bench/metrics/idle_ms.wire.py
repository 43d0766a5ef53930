"""``idle_ms.wire``: device idle time per exchange while the host was in
the program's ``tempi.wire`` range, the launch of the wire's ops
(``transport.exchange``).

The profile charges each idle gap of the timed exchange to the innermost
host operation at the gap's middle (:mod:`bench.profiling`).  This is
what it charges to the range itself, where the host ran the phase's own
Python; a gap under an ``aten::`` op or a CUDA runtime call inside the
range stays charged to that op.  Only the 5,000 longest gaps of the
window are charged (``_MAX_GAPS``), so the number is a floor.  None
without a device trace, or where no gap is charged to any ``tempi.*``
range (a program without the ranges)."""


def read(ctx):
    gaps = ctx.profile.get("idle_gaps")
    calls = ctx.profile["stats"]["calls"]
    if not gaps or not calls or not any(k.startswith("tempi.") for k in gaps):
        return None
    return 1e3 * gaps.get("tempi.wire", 0.0) / calls
