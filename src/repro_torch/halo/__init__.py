"""repro_torch.halo — the paper's §6.4 3D stencil halo-exchange case
study on the local mesh (all ranks in one ``(R, az, ay, ax)`` tensor)."""

from repro_torch.halo.exchange import (
    DIRECTIONS,
    HaloPlan,
    HaloSpec,
    from_reference,
    halo_exchange,
    ihalo_exchange,
    make_halo_plan,
    make_halo_step,
    make_halo_types,
)
from repro_torch.halo.stencil import (
    STENCIL26,
    StencilOp,
    as_ops,
    cycle_halo_radii,
    cycle_radii,
    op_sequence,
    stencil26,
    stencil_apply,
    stencil_cycle,
    stencil_iterations,
    stencil_steps,
)

__all__ = [
    "DIRECTIONS",
    "HaloPlan",
    "HaloSpec",
    "STENCIL26",
    "StencilOp",
    "as_ops",
    "cycle_halo_radii",
    "cycle_radii",
    "from_reference",
    "halo_exchange",
    "ihalo_exchange",
    "make_halo_plan",
    "make_halo_step",
    "make_halo_types",
    "op_sequence",
    "stencil26",
    "stencil_apply",
    "stencil_cycle",
    "stencil_iterations",
    "stencil_steps",
]
