"""Canonicalization of the Type IR (paper §3.2, Algorithms 1-3).

Two rewrites are iterated to a fixpoint:

* **Dense folding** (Alg. 2) — a ``StreamData`` whose stride equals the
  extent of its ``DenseData`` child describes one big contiguous run; the
  pair collapses into a single larger ``DenseData``.
* **Stream elision** (Alg. 3) — a child ``StreamData`` with ``count == 1``
  contributes nothing but an offset and is removed.

After the fixpoint, equivalent datatype constructions (Fig. 2) have
identical trees, which is what makes the compact ``StridedBlock``
representation (``repro_torch.core.strided_block``) and the small generic
kernel family possible.

Deviations from the paper's pseudocode (documented, both strictly more
correct): (1) when a count-1 stream child is elided, its ``offset`` is
absorbed into the parent rather than dropped; (2) a count-1 *root* stream
is also elided (the paper's Alg. 3 only ever deletes child nodes, leaving
e.g. ``Vector(1, ...)`` roots uncanonical).
"""

from __future__ import annotations

from repro_torch.core.ir import DenseData, StreamData, Type

__all__ = ["dense_folding", "stream_elision", "simplify"]


def dense_folding(ty: Type) -> bool:
    """Alg. 2.  Applied depth-first (fold from the bottom up).  Returns
    True iff the tree was modified.  Mutates ``ty`` in place."""
    changed = False
    for child in ty.children:
        changed = dense_folding(child) or changed

    if not isinstance(ty.data, StreamData):
        return changed
    if not ty.children:
        return changed
    child = ty.children[0]
    if not isinstance(child.data, DenseData):
        return changed

    c_data = child.data
    p_data = ty.data
    if c_data.extent == p_data.stride:
        # Replace the (stream over dense) pair with one large DenseData.
        ty.data = DenseData(
            offset=c_data.offset + p_data.offset,
            extent=p_data.count * p_data.stride,
        )
        ty.children = list(child.children)  # DenseData has none; keep shape
        changed = True
    return changed


def stream_elision(ty: Type) -> bool:
    """Alg. 3.  Applied depth-first.  Returns True iff modified.  Mutates
    ``ty`` in place."""
    changed = False
    for child in ty.children:
        changed = stream_elision(child) or changed

    if not isinstance(ty.data, StreamData):
        return changed
    if not ty.children:
        return changed
    child = ty.children[0]
    if not isinstance(child.data, StreamData):
        return changed

    c_data = child.data
    if c_data.count == 1:
        # The child is a single element: splice it out, keeping its offset.
        ty.data.offset += c_data.offset
        ty.children = list(child.children)
        changed = True
    return changed


def _elide_root(ty: Type) -> bool:
    """Elide a count-1 StreamData at the *root* (see module docstring)."""
    if (
        isinstance(ty.data, StreamData)
        and ty.data.count == 1
        and ty.children
    ):
        child = ty.children[0]
        child.data.offset += ty.data.offset
        ty.data = child.data
        ty.children = child.children
        return True
    return False


def simplify(ty: Type) -> Type:
    """Alg. 1: iterate the rewrites until neither changes the tree.

    Mutates and returns ``ty``.
    """
    changed = True
    while changed:
        changed = False
        changed = dense_folding(ty) or changed
        changed = stream_elision(ty) or changed
        changed = _elide_root(ty) or changed
    return ty
