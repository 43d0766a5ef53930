"""Roofline analysis from the dry run's per-device walk (the port of the
reference's ``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = collective_bytes / link_bw

The FLOPs, bytes and collective bytes are one device's, counted by
:func:`repro_torch.roofline.op_cost.walk_cost` at the shard shapes, so the
terms divide by one chip's rates.  The collective bytes are the walk's
per-kind result bytes times :data:`_COLLECTIVES`' ring multipliers (the
reference reads them from the partitioned HLO text; the port's eager
walk sees the collectives themselves).

Hardware: one NVIDIA H100 SXM (:data:`HW_H100`).  The reference's TPU
v5e constants are not the port's and are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["HW_H100", "Hardware", "RooflineReport", "analyze", "collective_bytes",
           "model_flops_estimate"]


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per chip, within a node
    dcn_bw: float = 25e9       # bytes/s per chip, across nodes


#: One H100.  ``peak_flops`` and ``hbm_bw`` are measured by
#: ``chip_smoke.py`` ``[dryrun]`` (``dryrun_peaks``) on an NVIDIA H100 80GB
#: HBM3 at a 700.00 W power limit: a bf16 ``torch.matmul`` at 8192^3,
#: 1.393 ms (the data sheet says 989 TFLOP/s), and a 4 GiB device-to-device
#: copy, read and written in 2.819 ms (the data sheet says 3.35 TB/s).
#: ``link_bw`` is NVLink 4's published 900 GB/s a GPU, 450 GB/s each way,
#: and ``dcn_bw`` one ConnectX-7 NDR port's published 400 Gb/s: published,
#: not measured.
HW_H100 = Hardware("nvidia_h100_sxm", peak_flops=789.05e12, hbm_bw=3.047e12, link_bw=450e9,
                   dcn_bw=50e9)

#: ops we count as collectives, with an approximate wire-bytes multiplier
#: per *operand shard byte* (ring algorithms)
_COLLECTIVES = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather ring
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(coll: Dict[str, float]) -> Dict[str, float]:
    """Approximate wire bytes by kind: the walk's per-kind collective
    result bytes (``OpCost.coll``) times :data:`_COLLECTIVES`'
    multipliers; every kind present, 0 where none ran."""
    return {k: coll.get(k, 0.0) * m for k, m in _COLLECTIVES.items()}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    coll_bytes: float           # per device (wire estimate)
    coll_by_kind: Dict[str, float]
    model_flops: float          # 6 N D (global, useful)
    hw: Hardware = HW_H100

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips x counted FLOPs): remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """fraction of the dominant-term-bound step time that is the
        compute term — i.e. how close the step is to compute-roofline."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / t if t else 0.0

    def row(self) -> str:
        return (
            f"| {self.arch} | {self.shape} | {self.mesh} | "
            f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
            f"{self.t_collective*1e3:.2f} | {self.bottleneck} | "
            f"{self.useful_flops_ratio:.2f} | {self.roofline_fraction:.2f} |"
        )


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for train; for
    inference shapes, 2 N D per generated/prefilled token."""
    n = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                   ("train", "prefill") else 1)
    per_tok = 6 * n if shape.kind == "train" else 2 * n
    return float(per_tok) * tokens


def analyze(arch, shape, mesh_name, chips, cost, cfg, shape_cfg,
            hw: Hardware = HW_H100) -> RooflineReport:
    """The report of one cell from its walk, ``cost`` an
    :class:`~repro_torch.roofline.op_cost.OpCost` (per device)."""
    coll = collective_bytes(cost.coll)
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=cost.flops,
        hlo_bytes=cost.bytes,
        coll_bytes=sum(coll.values()),
        coll_by_kind=coll,
        model_flops=model_flops_estimate(cfg, shape_cfg),
        hw=hw,
    )
