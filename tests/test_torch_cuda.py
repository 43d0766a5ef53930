"""The port on the card: tests that need an NVIDIA GPU.

They import only torch and the port (the machine with the card has no
JAX), carry the ``cuda`` marker, and skip with a reason where there is
no card.  Run them there with::

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comm import Communicator, policy_for_mode
from repro_torch.core import StridedBlock
from repro_torch.halo import HaloSpec, from_reference, make_halo_step
from repro_torch.kernels import launch_counts, plan_geometry, reset_launch_counts
from repro_torch.kernels.pack import pack_dma, pack_plain, pack_rows
from repro_torch.kernels.unpack import unpack_dma, unpack_plain, unpack_rows

BLOCKS = [
    StridedBlock(12, (8, 5, 3), (1, 40, 400)),
    StridedBlock(1, (100, 13), (1, 512)),
    StridedBlock(4, (1040, 4, 3), (1, 2080, 10400)),
    StridedBlock(2, (96, 24), (1, 320)),
    # planes that share rows: the last plane wins
    StridedBlock(4, (8, 6, 3), (1, 16, 32)),
    StridedBlock(1, (5, 4, 5), (1, 7, 7)),
    StridedBlock(2, (6, 3, 4), (1, 10, 20)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_kernels_match_their_plain_versions(batch):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(batch)
    for sb in BLOCKS:
        geom = plan_geometry(sb)
        n = (geom.span_bytes + 8) // 8 * 8
        src = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
        want = pack_plain(src, geom, torch.empty((batch, geom.packed_bytes),
                                                 dtype=torch.uint8, device=dev))
        for fn in (pack_rows, pack_dma):
            assert torch.equal(fn(src, geom), want), (fn.__name__, sb)
        dst0 = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
        want_dst = unpack_plain(dst0.clone(), want, geom)
        for fn in (unpack_dma,) if geom.interleaved else (unpack_rows, unpack_dma):
            d = dst0.clone()
            fn(d, want, geom)
            assert torch.equal(d, want_dst), (fn.__name__, sb)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rows", "dma", "tempi"])
def test_halo_exchange_on_the_card_equals_the_cpu(mode):
    dev = _card()
    spec = HaloSpec(grid=(2, 2, 2), interior=(6, 5, 4), radius=2)
    start = np.random.default_rng(4).normal(size=(8,) + spec.alloc).astype(np.float32)
    want = make_halo_step(spec, Communicator(policy=policy_for_mode(mode), device="cpu"),
                          device="cpu")(from_reference(start, spec, device="cpu"))
    reset_launch_counts()
    step = make_halo_step(spec, Communicator(policy=policy_for_mode(mode), device=dev),
                          device=dev)
    got = step(from_reference(start, spec, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    counts = launch_counts()
    if mode != "tempi":
        assert counts[f"pack_{mode}"] == 26 and counts[f"unpack_{mode}"] == 26, counts


@pytest.mark.cuda
def test_kernels_take_offsets_past_32_bits():
    """A block whose bytes lie past 1 GiB: the SIMT kernels switch their
    index arithmetic to 64 bits there."""
    dev = _card()
    sb = StridedBlock((1 << 30) + 3, (5, 7, 2), (1, 1000, 40000))
    geom = plan_geometry(sb)
    assert geom.word_bytes == 1 and geom.span_bytes > 1 << 30
    src = torch.randint(0, 256, (1, geom.span_bytes + 5), dtype=torch.uint8, device=dev)
    want = pack_plain(src, geom, torch.empty((1, geom.packed_bytes), dtype=torch.uint8,
                                             device=dev))
    for fn in (pack_rows, pack_dma):
        assert torch.equal(fn(src, geom), want), fn.__name__
    want_dst = unpack_plain(src.clone(), want.flip(1).contiguous(), geom)
    for fn in (unpack_rows, unpack_dma):
        d = src.clone()
        fn(d, want.flip(1).contiguous(), geom)
        assert torch.equal(d, want_dst), fn.__name__
    torch.cuda.synchronize()
