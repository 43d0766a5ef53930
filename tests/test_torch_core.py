"""The port's datatype engine against ``repro.core``, exactly.

``repro_torch.core`` is a transcription of ``repro.core`` (it may not
import it).  On the datatype generators of ``tests/test_core_property.py``
and the constructions of ``tests/test_core_ir.py``, both packages must
commit every datatype to the same canonical IR tree, ``StridedBlock``,
``KernelKind``, word width, fingerprint, packed extent and wire segment.
The fingerprint is the key of plan caches and decisions, so its hex
string must be equal too.
"""

import dataclasses

import pytest

pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core as rc
import repro_torch.core as tc
from repro.core.commit import _tree_key as ref_tree_key
from repro_torch.core.commit import _tree_key
from tests.test_core_property import NAMED, datatypes


def port(dt):
    """The port's datatype with the same description as a reference one."""
    cls = getattr(tc, type(dt).__name__)
    fields = {}
    for f in dataclasses.fields(dt):
        v = getattr(dt, f.name)
        fields[f.name] = port(v) if isinstance(v, rc.Datatype) else v
    return cls(**fields)


def _block(sb):
    return None if sb is None else (sb.start, sb.counts, sb.strides)


def assert_same_commit(dt, incounts=(1, 2, 3)):
    ref_ct, ct = rc.TypeRegistry().commit(dt), tc.TypeRegistry().commit(port(dt))
    assert (ct.size, ct.extent) == (ref_ct.size, ref_ct.extent)
    assert _tree_key(ct.tree) == ref_tree_key(ref_ct.tree)
    assert _block(ct.block) == _block(ref_ct.block)
    assert ct.kernel.value == ref_ct.kernel.value
    assert ct.word_bytes == ref_ct.word_bytes
    assert ct.structure_key() == ref_ct.structure_key()
    assert ct.fingerprint == ref_ct.fingerprint
    for incount in incounts:
        assert ct.packed_extent(incount) == ref_ct.packed_extent(incount)
        seg, ref_seg = ct.wire_segment(17, incount), ref_ct.wire_segment(17, incount)
        assert (seg.fingerprint, seg.offset, seg.nbytes, seg.end) == (
            ref_seg.fingerprint, ref_seg.offset, ref_seg.nbytes, ref_seg.end
        )
    if ct.block is not None:
        sb, ref_sb = ct.block, ref_ct.block
        assert (sb.size, sb.extent, sb.num_blocks) == (ref_sb.size, ref_sb.extent, ref_sb.num_blocks)
        for w in (1, 2, 4, 8):
            assert sb.word_bytes(max_word=w) == ref_sb.word_bytes(max_word=w)
        assert list(tc.block_offsets(sb, incount=2, extent=ct.extent)) == list(
            rc.block_offsets(ref_sb, incount=2, extent=ref_ct.extent)
        )


@settings(max_examples=150, deadline=None)
@given(datatypes)
def test_random_datatypes_commit_identically(dt):
    assert_same_commit(dt)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 8), st.integers(1, 16), st.integers(0, 16), st.integers(1, 4), NAMED)
def test_equivalent_descriptions_commit_identically(c, l, pad, outer, named):
    e = named.extent
    stride = l + pad
    for dt in (
        rc.Vector(c, l, stride, named),
        rc.Hvector(c, l, stride * e, named),
        rc.Subarray((stride, c), (l, c), (0, 0), named),
        rc.Contiguous(outer, rc.Hvector(c, l, stride * e, named)),
        rc.Vector(1, 1, 1, rc.Contiguous(1, rc.Vector(c, l, stride, named))),
    ):
        assert_same_commit(dt)


ALLOC, EXT = (256, 512, 1024), (100, 13, 47)

CONSTRUCTIONS = {
    "fig2_subarray": rc.make_cuboid_subarray(ALLOC, EXT),
    "fig2_hvector": rc.make_cuboid_hvector(ALLOC, EXT),
    "fig2_vector_of_hvector": rc.make_cuboid_vector_of_hvector(ALLOC, EXT),
    "float_subarray": rc.Subarray((16, 32, 16), (4, 8, 4), (0, 0, 0), rc.FLOAT),
    "row_contig_float": rc.Contiguous(24, rc.FLOAT),
    "row_vector": rc.Vector(1, 96, 96, rc.BYTE),
    "row_hvector": rc.Hvector(96, 1, 1, rc.BYTE),
    "row_subarray": rc.Subarray((256,), (96,), (0,), rc.BYTE),
    "subarray_offsets": rc.Subarray((8, 4), (2, 2), (3, 1), rc.INT32),
    "full_subsize_folds": rc.Subarray((8, 4, 5), (8, 4, 2), (0, 0, 0), rc.BYTE),
    "elision_keeps_offset": rc.Subarray((8, 4, 5), (2, 1, 3), (0, 2, 1), rc.BYTE),
    "stream_elision": rc.Hvector(13, 1, 256, rc.Vector(100, 1, 1, rc.BYTE)),
    "count_one_root": rc.Vector(1, 3, 5, rc.BYTE),
    "eight_byte_words": rc.Vector(4, 2, 4, rc.Contiguous(2, rc.INT32)),
    "misaligned_bytes": rc.Subarray((256,), (3,), (1,), rc.BYTE),
    "halo_face": rc.Subarray((260, 260, 260), (2, 256, 256), (256, 2, 2), rc.FLOAT),
    "halo_corner": rc.Subarray((260, 260, 260), (2, 2, 2), (0, 0, 0), rc.FLOAT),
    "vector_of_vectors_4d": rc.Vector(3, 1, 2, rc.Subarray((8, 6, 4), (2, 3, 2), (1, 1, 1), rc.INT16)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTIONS))
def test_constructions_commit_identically(name):
    assert_same_commit(CONSTRUCTIONS[name])


def test_extents_and_validation_match():
    for dt in (rc.Vector(3, 2, 5, rc.FLOAT), rc.Hvector(3, 2, 100, rc.FLOAT),
               rc.Subarray((8, 4), (2, 2), (1, 1), rc.FLOAT, order="C")):
        p = port(dt)
        assert (p.size, p.extent) == (dt.size, dt.extent)
    with pytest.raises(ValueError):
        tc.Vector(3, 4, 2, tc.BYTE)
    with pytest.raises(ValueError):
        tc.Subarray((4,), (2,), (3,), tc.BYTE)


def test_registry_caches_commits():
    reg = tc.TypeRegistry()
    dt = port(rc.Vector(13, 25, 64, rc.FLOAT))
    assert reg.commit(dt) is reg.commit(dt)
    assert (reg.hits, reg.misses, len(reg)) == (1, 1, 1)
