"""Two-level link topology: which ranks share a node (paper scale regime).

The paper's 3072-process halo exchange is dominated by the slow
inter-node tier, yet a flat ``t_link`` table prices every hop the same.
A :class:`Topology` is the missing map: rank -> node, from which every
edge of a wire plan gets a **link class** — ``intra`` (both endpoints on
one node: ICI/NVLink-fast) or ``inter`` (the edge crosses nodes:
DCN/IB-slow).  The model then prices each delta class by the slowest
tier it crosses, and the planner can *coalesce* all classes crossing to
the same peer node into one slow-tier message (the ``tiered`` wire
schedule — see ``repro_torch.comm.wireplan``).

A topology is deliberately tiny and frozen (hashable — it rides through
the ``plan_wire`` cache and fingerprints decision rows):

* :meth:`Topology.flat` — every rank on one node (single-host; the
  pre-hierarchy behaviour);
* :meth:`Topology.blocked` — contiguous rank blocks of
  ``ranks_per_node``, the standard slowest-axis-major placement (with a
  row-major process grid, block size = the product of the trailing grid
  dims puts one leading-axis slab per node).

:func:`classify_and_coalesce` is the shared geometry kernel: given each
delta class's destination vector it returns the per-class link classes
and the **tier bundles** — inter-crossing classes whose destination-NODE
vectors are identical, which is exactly the condition under which their
payloads can ride one slow-tier collective and be corrected to their
true destination ranks with cheap intra-node hops.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

__all__ = [
    "LINK_CLASSES",
    "Topology",
    "classify_and_coalesce",
]

#: the two tiers of the link hierarchy, fast first
LINK_CLASSES: Tuple[str, ...] = ("intra", "inter")


@dataclass(frozen=True)
class Topology:
    """Rank -> node map of a two-level machine.

    ``nodes[r]`` is the node id hosting rank ``r``.  Node ids need not
    be contiguous; only equality matters (same id = same fast tier).
    """

    nodes: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(int(n) for n in self.nodes))
        if not self.nodes:
            raise ValueError("a topology needs at least one rank")

    # -- constructors ----------------------------------------------------
    @staticmethod
    def flat(nranks: int) -> "Topology":
        """Every rank on one node — the single-host (no-hierarchy) map."""
        return Topology(nodes=(0,) * int(nranks))

    @staticmethod
    def blocked(nranks: int, ranks_per_node: int) -> "Topology":
        """Contiguous blocks of ``ranks_per_node`` ranks per node (the
        slowest-axis-major placement every launcher defaults to)."""
        if ranks_per_node <= 0:
            raise ValueError(f"ranks_per_node must be > 0, got {ranks_per_node}")
        return Topology(
            nodes=tuple(r // int(ranks_per_node) for r in range(int(nranks)))
        )

    # -- queries ---------------------------------------------------------
    @property
    def nranks(self) -> int:
        return len(self.nodes)

    @property
    def nnodes(self) -> int:
        return len(set(self.nodes))

    def link_class(self, src: int, dst: int) -> str:
        """``intra`` | ``inter`` for one edge."""
        return "intra" if self.nodes[src] == self.nodes[dst] else "inter"

    @property
    def fingerprint(self) -> str:
        """Stable content hash — the key component that makes wire and
        program decisions topology-specific (a pin recorded on one
        machine shape is never replayed on another)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            key = ("topology.v1", self.nodes)
            fp = hashlib.sha256(repr(key).encode()).hexdigest()[:16]
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def __repr__(self) -> str:
        return (
            f"Topology(nranks={self.nranks}, nnodes={self.nnodes}, "
            f"fp={self.fingerprint})"
        )


def classify_and_coalesce(
    dsts: Sequence[Sequence[int]], topology: Topology
) -> Tuple[Tuple[str, ...], Tuple[Tuple[int, ...], ...]]:
    """Link classes and tier bundles of a rank-uniform exchange.

    ``dsts[g][r]`` is the destination rank of delta class ``g`` as seen
    from rank ``r`` (one full permutation per class).  A class is
    ``inter`` when ANY of its edges crosses nodes — a bulk-synchronous
    collective completes at its slowest edge, so the whole class prices
    at the slow tier (the paper's "slowest tier it crosses" rule).

    Bundles group the inter classes by their destination-**node**
    vector: classes where every rank targets the same peer node (if not
    the same peer *rank*).  Such a bundle can travel as ONE slow-tier
    collective along any member's permutation — the concatenated payload
    lands on the right node, and each non-representative member is
    forwarded to its true destination rank by an intra-node correction
    hop (the correction edge ``dst_g0(r) -> dst_g(r)`` stays on-node
    precisely because the bundle key guarantees
    ``node(dst_g(r)) == node(dst_g0(r))`` for every rank).
    """
    nodes = topology.nodes
    link_classes: List[str] = []
    for ds in dsts:
        if len(ds) != topology.nranks:
            raise ValueError(
                f"class destination vector has {len(ds)} ranks; "
                f"topology has {topology.nranks}"
            )
        link_classes.append(
            "inter"
            if any(nodes[d] != nodes[r] for r, d in enumerate(ds))
            else "intra"
        )
    key_to_bundle: Dict[Tuple[int, ...], int] = {}
    bundles: List[List[int]] = []
    for g, ds in enumerate(dsts):
        if link_classes[g] != "inter":
            continue
        key = tuple(nodes[d] for d in ds)
        i = key_to_bundle.setdefault(key, len(bundles))
        if i == len(bundles):
            bundles.append([])
        bundles[i].append(g)
    return tuple(link_classes), tuple(tuple(b) for b in bundles)
