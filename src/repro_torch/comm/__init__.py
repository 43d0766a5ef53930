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
    PersistentRequest,
    Policy,
    Request,
    SendRequest,
    Strategy,
    StrategyRegistry,
    as_communicator,
    default_registry,
    plan_neighbor_alltoallv,
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
    synthetic_two_tier,
)
from repro_torch.comm.distributed import DistributedTransport
from repro_torch.comm.scale import ScaleEstimate, ScalePlan, build_scale_plan, scale_ladder
from repro_torch.comm.topology import LINK_CLASSES, Topology, classify_and_coalesce
from repro_torch.comm.transport import LocalMeshTransport
from repro_torch.comm.wireplan import (
    WIRE_COLLECTIVES,
    WIRE_SCHEDULES,
    WireGroup,
    WirePlan,
    collective_payload_bytes,
    plan_wire,
    reschedule,
)

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
    "LINK_CLASSES",
    "LocalMeshTransport",
    "ModelPolicy",
    "NeighborRequest",
    "PersistentRequest",
    "OverlapEstimate",
    "PerfModel",
    "Policy",
    "ProgramEstimate",
    "RLE_HEADER_BYTES",
    "RLE_RUN_BYTES",
    "RLE_WIRE",
    "RleWire",
    "Request",
    "ScaleEstimate",
    "ScalePlan",
    "SendRequest",
    "Strategy",
    "StrategyEstimate",
    "StrategyRegistry",
    "SystemParams",
    "Topology",
    "WIRE_COLLECTIVES",
    "WIRE_SCHEDULES",
    "WireGroup",
    "WirePlan",
    "as_communicator",
    "build_scale_plan",
    "classify_and_coalesce",
    "collective_payload_bytes",
    "default_registry",
    "plan_neighbor_alltoallv",
    "plan_wire",
    "policy_for_mode",
    "register_strategy",
    "reschedule",
    "resolve_strategy",
    "scale_ladder",
    "static_choice",
    "synthetic_two_tier",
]
