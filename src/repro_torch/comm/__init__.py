"""repro_torch.comm — strategy selection (§5 model), exact-byte wire
plans, transports and the Communicator."""

from repro_torch.comm.api import (
    DEFAULT_SCHEDULE_POLICY,
    MODES,
    BaselinePolicy,
    ClassRequest,
    Communicator,
    FixedPolicy,
    ModelPolicy,
    NeighborRequest,
    Policy,
    Request,
    SendRequest,
    Strategy,
    StrategyRegistry,
    default_registry,
    policy_for_mode,
    register_strategy,
    resolve_strategy,
    static_choice,
)
from repro_torch.comm.compress import (
    BLOCK_ELEMS,
    INT8_WIRE,
    RLE_HEADER_BYTES,
    RLE_RUN_BYTES,
    RLE_WIRE,
    Int8Wire,
    RleWire,
)
from repro_torch.comm.perfmodel import (
    H100_ANALYTIC,
    OverlapEstimate,
    PerfModel,
    ProgramEstimate,
    StrategyEstimate,
    SystemParams,
)
from repro_torch.comm.distributed import DistributedTransport
from repro_torch.comm.topology import Topology
from repro_torch.comm.transport import LocalMeshTransport
from repro_torch.comm.wireplan import WireGroup, WirePlan, plan_wire, reschedule

# the compressed-wire strategies ship registered, as in the reference:
# int8wire is never auto-picked; rlewire is priced at its capacity
# unless a payload probe measured its stream
for _codec in (INT8_WIRE, RLE_WIRE):
    if _codec.name not in default_registry():
        register_strategy(_codec)

__all__ = [
    "BLOCK_ELEMS",
    "DEFAULT_SCHEDULE_POLICY",
    "MODES",
    "BaselinePolicy",
    "ClassRequest",
    "Communicator",
    "DistributedTransport",
    "FixedPolicy",
    "H100_ANALYTIC",
    "INT8_WIRE",
    "Int8Wire",
    "LocalMeshTransport",
    "ModelPolicy",
    "NeighborRequest",
    "OverlapEstimate",
    "PerfModel",
    "Policy",
    "ProgramEstimate",
    "RLE_HEADER_BYTES",
    "RLE_RUN_BYTES",
    "RLE_WIRE",
    "RleWire",
    "Request",
    "SendRequest",
    "Strategy",
    "StrategyEstimate",
    "StrategyRegistry",
    "SystemParams",
    "Topology",
    "WireGroup",
    "WirePlan",
    "default_registry",
    "plan_wire",
    "policy_for_mode",
    "register_strategy",
    "reschedule",
    "resolve_strategy",
    "static_choice",
]
