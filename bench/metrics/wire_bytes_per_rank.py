"""``wire_bytes_per_rank``: bytes a rank put on the wire per exchange,
from the communicator's ``wire_payload_bytes`` counter over the profiled
window (the transport counts per rank; one exchange per call)."""


def read(ctx):
    moved = ctx.counters_after["wire_payload_bytes"] - ctx.counters_before["wire_payload_bytes"]
    calls = ctx.profile["stats"]["calls"]
    return moved / calls if calls and moved else None
