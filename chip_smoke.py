#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Runs the paper's 26-neighbour halo exchange plus 26-point stencil at full
width on one card, through the hand-written CUDA pack/unpack kernels:

1. build   the kernels under ``src/repro_torch/kernels/csrc`` with nvcc,
           all sources at once (seconds printed);
2. kernels hold each of the four exchange kernels against its plain
           PyTorch version on the card, bit-exact: on a subset of the CPU test
           sweeps, on planes that share rows, on alignment cases that
           drive the row kernels through every vector width V (16, 8, 4,
           2, 1 bytes) on both their paths (a warp per row, one thread
           per vector) and the dma kernels through every V on their
           narrow path (rows of at most 16 bytes) and through their
           tiled path, on the 26 send and 26 receive types of the
           full-width halo at radius 1, 2 and 3 (the shapes the main
           path and the s = 1, 2, 3 programs launch), and at every point of the calibration sweep
           (``Vector(nblocks, blk, pitch, BYTE)``, blk 8-512 bytes, up to
           524,288 rows), 8 ranks per launch.  Then the stencil kernel
           (``csrc/stencil.cu``) at both windows of the s = 2 cycle on the
           iterate cell's state (8 x 512^3 float32, halo depth 2),
           ``torch.equal`` to its plain version (the second window with
           the rim it reads copied, ``copy_rim``), each timed beside its
           plain version and its byte bound, and the fused pair on the
           auto cell's state (8 x 512^3 at halo depth 3, a 518-float row
           pitch) ``torch.equal`` to the two launches it replaces, timed
           beside them, its plain version and its byte bound
           (``[stencil]``);
3. main    8 ranks on a periodic 2x2x2 grid, 256^3 float32 interior per
           rank, radius 2, all ranks in one (8, 260, 260, 260) tensor.
           One exchange under ``tempi``, ``rows``, ``dma`` and
           ``baseline``: every cell equals the periodic global field
           bit-exactly and the transport's byte count equals the plan's
           (and ``plan.wire_bytes`` in 7 wire ops under the exact
           schedule).  Then 5 iterations of exchange + 2 stencil
           applications against a ``torch.roll`` periodic oracle
           (rtol = atol = 1e-5: float32 sums in another order), ms per
           iteration back to back and synchronized each, and the
           device's idle share over 2 iterations (``torch.profiler``).  Kernel
           launch counts are zeroed just before this phase and read just
           after it; every kernel must have run, and each mode's launches
           per exchange must match its plan.  The step replays each
           buffer's exchange from a CUDA graph from its third call on:
           the wrappers count the eager calls and the capture, the graph
           keeps the captured call's launches (one exchange's, the
           plan's), and each replay is counted as those again; one replay
           runs the same kernels as one eager exchange under
           ``torch.profiler``, by name and count.  The iterations copy no
           window into the state (``splice_copies``);
4. measure the §5 model's tables calibrated on the card (full grid, 8
           ranks a launch) through ``production_communicator`` into a
           temporary store; launch counts are zeroed before the
           calibration and read after it, and every kernel must have run.
           Then the full-width ``tempi`` exchange with the measured and
           with the analytic tables and with the measured plan
           rescheduled to ``grouped`` and to ``uniform``, each bit-exact
           (launches zeroed before, read after, equal to the plans'): the
           picks, schedules and host-clock ms per exchange.  Rows, dma and
           xla pack + unpack are timed for each of the 26 send types and
           the measured pick is held against the fastest.  A second
           communicator reloads the store and replays every pick from the
           saved decisions file, and a third replays them over the
           analytic table;
5. program the deep-halo programs and the overlapped iteration at the same
           full width (launch counts zeroed before, read after; every
           kernel must run and each variant's launches must be its
           plan's): the s = 2 ``HaloProgram`` ``torch.equal`` to the main
           path's loop; s = 1, 2, 3 with equal interiors after 6
           applications, ms per iteration and per application;
           ``steps="auto"`` under the analytic and the calibrated tables
           (now with a stencil table), pinned by a reloaded decisions
           file; the overlapped iteration in ``monolithic``, ``region``
           and ``auto`` modes, each ``torch.equal`` to the plain program
           and computing as many stencil cells as it (none twice), with
           ms per iteration, its probe and the device's idle share from
           ``torch.profiler``;
6. dist    one process per rank through ``torch.distributed``: a
           world-size-1 NCCL group started in-process over a ``file://``
           store, on a (1, 1, 1) grid of one 256^3 block, radius 2, where
           all 26 neighbours are the process itself.  The exchange under
           ``grouped``, ``uniform``, ``ragged`` and ``tiered`` (one node, no
           bundle), the s = 2 program plain,
           ``monolithic`` and ``region``, and one ``sendrecv``, each
           ``torch.equal`` to the same run through the local mesh at R = 1
           with equal wire op and byte counts (launch counts zeroed before
           and read after each NCCL run; every kernel must have run); ms
           per exchange and per s = 2 iteration under NCCL and the local
           mesh; the group is torn down before the next phase;
7. compress the compressed wire at full width (launch counts zeroed before,
           read after; every kernel must run): ``rlewire`` at capacity on
           the 8-rank grid under ``uniform``, ``grouped`` and ``ragged``,
           on a seeded normal field (every region stored) and on a point
           source (regions rle), each ``torch.equal`` to ``tempi`` and the
           periodic field; ``int8wire`` (interior bit-exact, every halo
           value within its block's ``max|block| / 254``, 811,296 wire
           bytes a rank) and one lossy iteration beside the plain one; a
           27-rank 3x3x3 grid of 256^3 blocks with a point source in the
           centre rank, planned with a probe of that rank's block, on the
           ``varlen`` schedule, ``torch.equal`` to the capacity run,
           ``tempi`` and the periodic field, its stream bytes a rank below
           the 3,195,136-byte packed extent; ms per exchange and the
           codecs' encode and decode per exchange (CUDA events).  The
           dist phase runs a probed one-transfer ``varlen`` exchange
           through NCCL too, and the measure phase prints the compress
           sweep's rows;
8. tiered  the two-level machine at full width: 8 ranks with 4 a node
           (``Topology.blocked(8, 4)``) and 27 ranks with 9 a node, the
           ``tiered`` exchange (one slow-tier message per peer node, then
           intra-node correction hops) and ``grouped``, each
           ``torch.equal`` to the other and the periodic field, with the
           plan's ops and bytes (7 and 4,276,480 a rank at 8 ranks) and
           slow-tier messages (launch counts zeroed before and read after
           the tiered runs alone; every kernel must run); ms per exchange
           of both (on one card both tiers are the same memory, so these
           times say nothing of coalescing); the link-class sweep on the
           card; the model's picks at 8 ranks under the card's tables
           (never ``tiered``), with the measured link-class tables and
           made two-tier; the simulated-scale ladder to 3072 ranks; a
           ``replan_on_remesh`` to ``blocked(8, 2)`` and a tiered exchange
           planned after it;
9. obs     the observed main path at full width: the ``auto`` program on
           the 8-rank grid through ``production_communicator(telemetry=True,
           tracer=True)``, 8 traced iterations each ``torch.equal`` to the
           untraced one with equal launches (zeroed and read around every
           iteration), the span tree validated (one exchange with
           pack/wire/unpack and ``steps`` stencil spans an iteration, every
           child inside its parent), the Chrome trace, ``telemetry.json``
           and ``metrics.json`` saved to ``build/obs`` and loaded back, the
           probe's host cost against the 2% budget, the drift audit, the
           worst term re-measured (reduced sweep) and 8 more traced
           iterations audited under the new tables; prints an
           ``{"obs": ...}`` line;
10. smoother the smoother workload (``repro_torch.launch.smoother``) at the
           paper's width: 8 ranks of 256^3 on the grid (8, 1, 1), the
           ``predictor-corrector`` cycle, ``halo_steps="auto"``, through
           ``production_communicator`` over a temporary store with the
           measure phase's tables: the first run records a
           ``program/s=N`` row and its field after one iteration agrees
           with a ``torch.roll`` oracle of the cycle (rtol = atol = 1e-5);
           a second communicator over the store pins it, ``torch.equal``
           with a bit-equal checksum; ms per iteration (synchronized); a
           telemetered and traced iteration; the serve deployment's
           default (``smooth``, 8^3 a rank, 1 iteration).  Launch counts
           are zeroed before and read after every run; some kernel must
           have run.  Prints a ``{"smoother": ...}`` line;
11. serve  qwen2-0.5b at full width (24 layers, d_model 896, 494M
           parameters, bf16, weights drawn on the card from a seed) under
           the serve CLI's defaults (batch 4, 8 requests, 16 new tokens,
           max_len 128) with the smoother at startup: 8 of 8 served, a
           second loop from the same seed gives the same tokens, every
           logit finite, and teacher-forced decode logits agree with
           ``forward`` to 5% of the largest logit; tokens/s, ms per decode
           step (synchronized, median), the device's idle share, peak
           memory and the weight-read bound.  The decode path launches no
           pack/unpack kernel (checked); prints a ``{"serve": ...}`` line;
12. timing CUDA-event times of each kernel (L2 flushed before every
           call), beside its plain version, one PyTorch strided copy
           (``library_ms``) and two bounds at 3.35 TB/s: ``bound_ms``
           counts the block bytes read and written, ``bound_sectors_ms``
           the 32-byte sectors they touch (pack: sectors read + packed
           bytes written; unpack: packed bytes read + sectors written
           back + partly written sectors filled first).  At the x-, y-
           and z-face shapes for all four kernels, and at every distinct
           shape the ``tempi`` plan and the s = 1 and s = 3 programs'
           plans launch each kernel at, with its launches per exchange and the vector width, path and (dma)
           rows per tile it took; the dma kernels at the x faces at
           three tile sizes (``dma_tile_sweep``); each kernel and the
           library call also by ``repro_torch.measure.time_fn`` (200
           back-to-back launches between two synchronizations, L2 warm,
           the host's enqueue included); the timer's floor (an
           empty launch; the y/z-face row kernels with L2 left clean);
           host-clock ms per exchange and CUDA-event ms per stencil
           application.

The ``[train]`` phase (:func:`phase_train`) runs the training entry point
``repro_torch.launch.train.main`` at the full width of qwen2-0.5b (4
steps after the startup smoother), the flash backward and a bf16 step
against float32, the gradient wire's four modes from one state, and a
checkpoint with two resumes.  The ``[families]`` phase
(:func:`phase_families`) then serves, prefills, teacher-forces and
trains (two steps through ``train()``) qwen2-vl-2b and
seamless-m4t-large-v2 whole and mixtral-8x22b at full width with its
depth cut (8 of 56 layers; 1 for the train step), each held to its own
``forward``, and prints a ``{"families": ...}`` line.  The
``[recurrent]`` phase (:func:`phase_recurrent`) holds the chunked linear
attention to its single steps at full head sizes and runs a train step
past float32's ``exp`` range, serves zamba2-2.7b whole through the serve
CLI (its startup smoother through the four kernels) and zamba2-2.7b and
rwkv6-7b whole through ``ServeLoop``, holds decode to ``forward``, and
trains zamba2-2.7b whole and rwkv6-7b at 16 of 32 layers; it prints a
``{"recurrent": ...}`` line.  After ``[mesh]``, the ``[dryrun]`` phase
(:func:`phase_dryrun`) measures the card's bf16 GEMM and HBM copy rates
beside ``HW_H100``, walks eight full-width cells of the dry run on the
16 x 16 and 2 x 16 x 16 production meshes in child processes under fake
process groups (no device) and prints ``report.py``'s two tables, walks
the ``[train]`` step beside ``train_bound`` and its measured time, and
decodes qwen2-0.5b on the card's (1, 1) mesh against unsharded decode;
it prints a ``{"dryrun": ...}`` line.

Prints a ``{"measure": ...}`` line, a ``{"program": ...}`` line, a
``{"dist": ...}`` line, a ``{"compress": ...}`` line, a ``{"tiered": ...}``
line, an ``{"obs": ...}`` line, a ``{"smoother": ...}`` line, a
``{"serve": ...}`` line, a ``{"train": ...}`` line, a ``{"families": ...}``
line, a ``{"recurrent": ...}`` line, a ``{"dryrun": ...}`` line, one JSON
line ``{"kernels": [...]}``
(``launches``: the main path's loop, the launches its CUDA graphs
replayed (``launches_main_loop_replayed``: each graph's replays times
its captured call's launches, which no wrapper counts), and the program,
dist, compress, tiered, obs, smoother, serve, train, families and
recurrent phases),
the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed check ends the run with a non-zero exit and no result line.
Needs one card; run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SENTINEL = -1.0e30
FLUSH_BYTES = 256 << 20    # > the 50 MB L2
SLEEP_CYCLES = 2_000_000   # keeps the card busy while the host enqueues a timed call
REPS = 20
TIME_FN_ITERS = 200        # launches per time_fn reading
RECALIBRATIONS = 4         # calibrations past the stored one, for the spread of the picks
PROGRAM_ITERS = 3          # iterations a [program] variant is checked over
PROGRAM_REPS = 5           # timed [program] iterations a variant and round
PROGRAM_DEPTHS = (1, 2, 3)  # the deep-halo programs' s, and their halo radii
DIST_REPS = 5              # timed [dist] calls a reading
DIST_ROUNDS = 2            # [dist] rounds of NCCL, local, local, NCCL readings
BALL_RADIUS = 24           # the [compress] point source: a ball this many cells wide,
BALL_INSET = 8             # centred this many cells inside its block's +x face
VARLEN_RANK = 13           # the centre rank of the 3x3x3 grid, which the probe reads
INT8_ULPS = 2.0 ** -14     # float32 rounding of an int8 value against its bound
TIERED_GRIDS = (((2, 2, 2), 4), ((3, 3, 3), 9))  # [tiered] grids and ranks a node
# [tiered] at 256^3, radius 2, by ranks: ops, slow-tier messages tiered and grouped, bytes
# a rank (3,195,136 + the correction: 1,081,344 at 2x2x2; 1,081,536 at 3x3x3, whose two
# bundles' representatives are 32-byte corner classes)
TIERED_EXPECT = {8: (7, 1, 4, 4_276_480), 27: (26, 2, 18, 4_276_672)}
SCALE_RANKS = (8, 16, 64, 256, 1024, 3072)  # the simulated-scale ladder, 8 ranks a node
OBS_ITERS = 8              # traced iterations an [obs] run: the drift audit's min_samples
SMOOTHER_RANKS = 8         # [smoother]: the local mesh's ranks, on the grid (8, 1, 1)
SMOOTHER_INTERIOR = (256, 256, 256)
SMOOTHER_TIMED = 3         # synchronized [smoother] iterations timed after the checked one
SERVE_ARCH = "qwen2-0.5b"  # [serve]: the model, at full width
SERVE_DEFAULTS = {"batch": 4, "requests": 8, "max_new": 16, "max_len": 128}  # serve CLI defaults
SERVE_REL = 0.05           # teacher-forced decode vs forward: max |diff| <= 5% of max |logit|
SERVE_TIMED_STEPS = 20     # synchronized decode steps timed a reading
TRAIN_ARCH = "qwen2-0.5b"  # [train]: the model, at full width
TRAIN_DEFAULTS = {"seq_len": 256, "global_batch": 8, "steps": 4}  # the train CLI's seq and batch
TRAIN_FIXED_STEPS = 8      # [train] steps on one fixed batch, no warmup: the loss must fall
TRAIN_WIRE_STEPS = 2       # [train] steps each gradient-wire mode runs from one initial state
FLASH_F32_TOL = 1e-4       # flash backward against autograd, float32 (rtol = atol)
FLASH_BF16_REL = 0.02      # ... bf16: max |diff| <= 2% of the largest gradient
BF16_LOSS_REL = 0.01       # one step, bf16 model against its float32 copy: loss
BF16_GNORM_REL = 0.05      # ... and grad norm
BF16_FLOPS = 989e12        # H100 SXM data sheet, bf16 dense
F32_FLOPS = 67e12          # ... float32 outside the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        fail("nvidia-smi printed nothing")
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call, L2 flushed before it, the host's enqueue
    hidden behind a spin kernel; median of ``REPS`` calls.  The flush
    writes a 256 MB buffer, which leaves L2 full of dirty lines; with
    ``clean_l2`` it reads the buffer instead (a diagnostic of what those
    lines' write-back costs a timed call; the reported times keep the
    writing flush)."""

    def __init__(self, torch, dev, clean_l2=False):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        self.clean_l2 = clean_l2

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        pairs = []
        for _ in range(reps):
            if self.clean_l2:
                self.flush.sum()
            else:
                self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def wall_ms(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

KERNEL_INFO = {
    "pack_rows": ("src/repro_torch/kernels/csrc/rows.cuh", "src/repro/kernels/pack.py:106"),
    "pack_dma": ("src/repro_torch/kernels/csrc/narrow.cuh", "src/repro/kernels/pack.py:157"),
    "unpack_rows": ("src/repro_torch/kernels/csrc/rows.cuh", "src/repro/kernels/unpack.py:83"),
    "unpack_dma": ("src/repro_torch/kernels/csrc/narrow.cuh", "src/repro/kernels/unpack.py:128"),
    "stencil": ("src/repro_torch/kernels/csrc/stencil.cu",
                "none: the reference's stencil is jnp (src/repro/halo/stencil.py)"),
    "stencil_pairs": ("src/repro_torch/kernels/csrc/stencil.cu",
                      "none: two of the reference's jnp stencil applications"),
}
#: the exchange's kernels: pack and unpack, timed at the halo's shapes
EXCHANGE_KERNELS = ("pack_rows", "pack_dma", "unpack_rows", "unpack_dma")
#: the iterate cell's state (``bench/configs/stencil26_r2_512.json``): 8
#: ranks of 512^3 float32 at halo depth 2, where the stencil kernel is
#: held to its plain version and timed; at halo depth 3, the auto cell's
#: (``stencil26_auto_512.json``), the fused pair
STENCIL_INTERIOR = (512, 512, 512)
STENCIL_REPS = 5           # timed calls of the plain stencil (179 ms each at that shape)


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    secs = time.perf_counter() - t0
    for name in build.SOURCES:
        build.library(name)
    regs = sorted({ln.split("Used ")[1].split(",")[0] for log in build.BUILD_LOG.values()
                   for ln in log.splitlines() if "Used " in ln})
    print(f"[build] {len(build.SOURCES)} sources in {secs:.2f} s; ptxas registers: {regs}")
    return secs


class KernelCheck:
    """Holds every kernel against its plain version; keeps the largest
    difference seen per kernel (0 when bit-exact) and, per kernel, the
    (vector bytes, path) pairs it ran."""

    def __init__(self, torch, dev):
        from repro_torch.kernels.pack import pack_dma, pack_plain, pack_rows
        from repro_torch.kernels.unpack import unpack_dma, unpack_plain, unpack_rows

        self.torch, self.dev = torch, dev
        self.pack = {"pack_rows": pack_rows, "pack_dma": pack_dma}
        self.unpack = {"unpack_rows": unpack_rows, "unpack_dma": unpack_dma}
        self.pack_plain, self.unpack_plain = pack_plain, unpack_plain
        self.err = dict.fromkeys(KERNEL_INFO, 0.0)
        self.paths = {name: set() for name in EXCHANGE_KERNELS}
        self.checks = 0

    def _diff(self, name, got, want, what):
        d = (got.to(self.torch.int16) - want.to(self.torch.int16)).abs().max().item()
        self.err[name] = max(self.err[name], float(d))
        self.checks += 1
        if d != 0 or not self.torch.equal(got, want):
            fail(f"{name} differs from its plain version on {what}")

    def _ran(self, name, geom, a, b):
        self.paths[name].add(kernel_launch(name, geom, a, b)[:2])

    def pack_side(self, src, geom, what, wire_offset=None):
        """Pack ``src`` with every pack kernel and the plain version;
        returns the plain result.  With ``wire_offset`` each kernel packs
        into the slot at that byte of a wider wire, whose other bytes
        must stay as they were; the result is then that slot (a view)."""
        torch = self.torch
        B, size = src.shape[0], geom.packed_bytes
        want = self.pack_plain(src, geom, torch.empty((B, size), dtype=torch.uint8,
                                                      device=self.dev))
        for name, fn in self.pack.items():
            if wire_offset is None:
                got = fn(src, geom)
            else:
                wire = torch.full((B, wire_offset + size + 8), 0x5A, dtype=torch.uint8,
                                  device=self.dev)
                got = fn(src, geom, wire[:, wire_offset:wire_offset + size])
                rest = torch.cat([wire[:, :wire_offset], wire[:, wire_offset + size:]], 1)
                self._diff(name, rest, torch.full_like(rest, 0x5A),
                           f"{what}: wire bytes around the slot")
            self._ran(name, geom, src, got)
            self._diff(name, got, want, what)
        return want if wire_offset is None else got

    def unpack_side(self, dst, packed, geom, what, want=None):
        """Unpack ``packed`` into a copy of ``dst`` with every unpack
        kernel and hold each against the plain version (and, when given,
        against ``want``)."""
        plain = self.unpack_plain(dst.clone(), packed, geom)
        if want is not None and not self.torch.equal(plain, want):
            fail(f"the plain unpack differs from the expected bytes on {what}")
        want = plain
        for name, fn in self.unpack.items():
            if name == "unpack_rows" and geom.interleaved:
                continue  # the rows kernel takes disjoint planes only
            got = dst.clone()
            fn(got, packed, geom)
            self._ran(name, geom, got, packed)
            self._diff(name, got, want, what)


def sweep_blocks():
    from repro_torch.core import BYTE, FLOAT, INT16, StridedBlock, Subarray, TypeRegistry, Vector

    reg = TypeRegistry()
    types = [
        Vector(13, 100, 512, BYTE), Vector(64, 128, 512, BYTE), Vector(24, 24, 160, FLOAT),
        Vector(24, 48, 320, INT16), Subarray((256, 40), (100, 24), (3, 7), BYTE),
        Subarray((256, 40), (100, 24), (64, 7), BYTE),
        Subarray((64, 32, 16), (40, 13, 7), (8, 3, 2), BYTE),
        Subarray((512, 4, 4), (12, 3, 2), (64, 1, 1), BYTE),
        Subarray((32, 32, 32), (2, 32, 32), (0, 0, 0), FLOAT),
        Subarray((32, 32, 32), (2, 2, 2), (30, 30, 30), FLOAT),
    ]
    blocks = [reg.commit(t).block for t in types]
    # planes that share rows (the last plane wins)
    blocks += [StridedBlock(4, (8, 6, 3), (1, 16, 32)), StridedBlock(1, (5, 4, 5), (1, 7, 7)),
               StridedBlock(2, (6, 3, 4), (1, 10, 20))]
    return blocks


def kernel_launch(kernel, geom, a, b):
    """The (vector bytes, path name, rows per tile or None) ``kernel``
    takes on the strided ``a`` and the packed ``b``."""
    from repro_torch.kernels.pack import DMA_PATHS, ROW_PATHS, dma_args, row_args

    if kernel.endswith("rows"):
        vec, path = row_args(geom, a, b)
        return vec, ROW_PATHS[path], None
    vec, path, tile_rows = dma_args(geom, a, b)
    return vec, DMA_PATHS[path], tile_rows


def vector_cases():
    """Blocks that drive the row kernels through every vector width V and
    both paths, and the dma kernels through every V on their narrow path:
    ``(block, word_bytes or None, odd, wire offset or None)``.  The
    buffers are the span rounded up to 16 bytes, plus one when ``odd``
    (an odd batch stride); a wire offset packs into a slot that many
    bytes into a wider wire buffer."""
    from repro_torch.core import StridedBlock as SB

    face = SB(8, (1024, 4, 2), (1, 1040, 4160))      # a halo face: rows at 8 mod 16
    xface = SB(8, (8, 64, 4), (1, 1040, 66560))      # a cut x face: 8-byte rows
    return [
        (xface, None, 0, None),                                  # dma narrow, V 8
        (xface, None, 0, 4),                                     # slot 4 B into a wire: V 4
        (xface, 1, 0, 1),                                        # slot at an odd offset: V 1
        (xface, 1, 1, None),                                     # odd batch stride: V 1
        (SB(16, (16, 5, 3), (1, 64, 512)), None, 0, None),       # 16-byte rows: narrow V 16
        (SB(8, (8, 200, 200), (1, 40, 8000)), None, 0, None),    # ragged last tile, pitch 40
        (SB(0, (1024, 3, 2), (1, 2048, 8192)), None, 0, None),  # V 16, warp
        (SB(16, (48, 5, 3), (1, 64, 512)), None, 0, None),       # V 16, flat
        (face, None, 0, None),                                   # V 8, warp
        (SB(8, (8, 2, 2), (1, 1040, 4160)), None, 0, None),      # V 8, flat (corner)
        (SB(4, (1024, 3, 2), (1, 1040, 4160)), None, 0, None),   # rows at 4 mod 8: V 4
        (SB(16, (12, 5, 2), (1, 64, 320)), None, 0, None),       # 12-byte rows: V 4, flat
        (SB(0, (1036, 3, 2), (1, 2048, 8192)), None, 0, None),   # 1036 B: V 4, 3 chunks
        (face, None, 0, 4),                                      # slot 4 B into a wire: V 4
        (SB(2, (514, 3, 2), (1, 1030, 4120)), None, 0, None),    # W 2: V 2, warp
        (SB(6, (10, 4, 3), (1, 30, 150)), None, 0, None),        # W 2: V 2, flat
        (SB(3, (513, 3, 2), (1, 1027, 4108)), None, 0, None),    # W 1: V 1, warp
        (SB(1, (13, 4, 2), (1, 100, 500)), None, 0, None),       # W 1: V 1, flat
        (face, 1, 1, None),                                      # odd batch stride: V 1
        (SB(0, (1024, 3, 2), (1, 2048, 8192)), 1, 0, None),      # W 1 but V 16
        (SB(8, (1024, 7), (1, 1040)), None, 0, None),            # 2D: V 8
        (SB(16, (65536, 3), (1, 65552)), None, 0, None),         # 64 KB rows: 32 chunks
    ]


def phase_kernels(torch, dev, spec, check):
    from repro_torch.comm import Communicator
    from repro_torch.halo import HaloSpec, make_halo_types
    from repro_torch.kernels.geometry import plan_geometry
    from repro_torch.kernels.pack import ROW_PATHS, VECTOR_BYTES

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = [(sb, None, None, None) for sb in sweep_blocks()] + vector_cases()
    for sb, word, odd, wire_offset in cases:
        geom = plan_geometry(sb, word_bytes=word)
        if geom is None:
            fail(f"no kernel geometry for sweep block {sb}")
        if odd is None:  # the CPU tests' sweeps: a ragged tail, 8-byte batch stride
            n = (geom.span_bytes + 13 + 7) // 8 * 8
        else:
            n = (geom.span_bytes + 15) // 16 * 16 + odd
        for batch in (1, 8):
            what = f"{sb} W {geom.word_bytes} batch {batch} wire offset {wire_offset}"
            src = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
            packed = check.pack_side(src, geom, what, wire_offset)
            dst = torch.randint(0, 256, (batch, n), dtype=torch.uint8, device=dev, generator=gen)
            check.unpack_side(dst, packed, geom, what)
    want = {(v, path) for v in VECTOR_BYTES for path in ROW_PATHS}
    want_dma = {(v, "narrow") for v in VECTOR_BYTES} | {(w, "tiled") for w in (1, 2, 4)}
    for name, ran in check.paths.items():
        need = want if name.endswith("rows") else want_dma
        if not need <= ran:
            fail(f"{name} never ran (vector bytes, path) {sorted(need - ran)}")
    # the 52 region types of the full-width halo at radius 1, 2 and 3 (the
    # main path's, and the programs' at s = 1, 2, 3), all 8 ranks per
    # launch.  A region that is one contiguous run (at radius 1 the
    # corners and the dx = 0 edges along z) is one slice copy: no kernel
    # takes it.
    contiguous = {}
    for radius in PROGRAM_DEPTHS:
        rspec = HaloSpec(grid=spec.grid, interior=spec.interior, radius=radius)
        types = make_halo_types(rspec, Communicator(device=dev))
        state = torch.randint(0, 256, (rspec.nranks, 4 * math.prod(rspec.alloc)),
                              dtype=torch.uint8, device=dev, generator=gen)
        contiguous[radius] = 0
        for d, (send_ct, recv_ct) in types.items():
            blocks = (send_ct.block, recv_ct.block)
            if all(b.ndims == 1 for b in blocks):
                contiguous[radius] += 1
                continue
            sg, rg = (plan_geometry(b) for b in blocks)
            if sg is None or rg is None:
                fail(f"radius {radius} region {d}: no kernel geometry for {blocks}")
            packed = check.pack_side(state, sg, f"radius {radius} send {d}")
            check.unpack_side(state, packed, rg, f"radius {radius} recv {d}")
        torch.cuda.synchronize()
        del state
    sweep_check(torch, dev, spec.nranks, check, gen)
    print(f"[kernels] {check.checks} comparisons, all bit-exact (the halo's region types "
          f"at radius 1, 2, 3; contiguous regions, no kernel: {contiguous}); "
          f"max |diff| per kernel {check.err}; (vector bytes, path) pairs run: "
          f"{ {k: sorted(v) for k, v in check.paths.items()} }")


def phase_stencil(torch, dev, check, card):
    """The stencil kernel at both windows of the s = 2 cycle, on the
    iterate cell's state (:data:`STENCIL_INTERIOR`, 8 ranks, halo depth
    2, ``STENCIL26``), held with ``torch.equal`` to its plain version:
    application 1 reads the state and writes its 514^3 window into the
    scratch; application 2 reads the scratch and writes its 512^3 window
    into the state, with the 514^3 rim it reads copied unchanged
    (``copy_rim``).  Times each (CUDA events, :data:`REPS` calls; the
    plain version :data:`STENCIL_REPS`) beside its byte bound at HBM
    rate: each cell it reads once, each cell it writes once.  Returns the
    ``{"kernels": ...}`` line's timing fields: sums over the cycle."""
    from repro_torch.halo import STENCIL26, HaloSpec
    from repro_torch.kernels.ops import stencil_window_plain, stencil_window_update

    spec = HaloSpec(grid=(2, 2, 2), interior=STENCIL_INTERIOR, radius=2)
    R, r, n = spec.nranks, spec.radius, spec.interior
    op = STENCIL26
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    state = torch.randn((R,) + spec.alloc, generator=gen, device=dev)
    scratch = torch.empty_like(state)

    def view(t, origin, shape):
        (z, y, x), (nz, ny, nx) = origin, shape
        return t[..., z:z + nz, y:y + ny, x:x + nx]

    outer = ((r - 1,) * 3, tuple(m + 2 * r - 2 for m in n))  # application 1's window
    inner = ((r,) * 3, tuple(n))                              # application 2's window
    es = state.element_size()

    def with_rim(plain):
        """Application 2's destination as the plain path leaves it: the
        scratch's 514^3 window with the plain 512^3 result inside it."""
        want = view(scratch, *outer).clone()
        view(want, (1, 1, 1), n).copy_(plain)
        return want

    # (name, the kernel, its plain version, the plain result as the kernel
    # leaves its destination, the destination, the window computed, the
    # cells read, the cells written)
    apps = (
        ("application 1",
         lambda: stencil_window_update(state, op.offsets, op.weight, *outer,
                                       out=view(scratch, *outer)),
         lambda: stencil_window_plain(state, op.offsets, op.weight, *outer),
         lambda plain: plain,
         lambda: view(scratch, *outer), outer[1], tuple(m + 2 for m in outer[1]), outer[1]),
        ("application 2, copy_rim",
         lambda: stencil_window_update(scratch, op.offsets, op.weight, *inner,
                                       out=view(state, *outer), copy_rim=True),
         lambda: stencil_window_plain(scratch, op.offsets, op.weight, *inner),
         with_rim,
         lambda: view(state, *outer), inner[1], outer[1], outer[1]),
    )
    timer = Timer(torch, dev)
    windows = []
    for name, fn, plain, placed, dest, window, read, written in apps:
        want = placed(plain())
        fn()
        torch.cuda.synchronize()
        d = (dest() - want).abs().max().item()
        check.err["stencil"] = max(check.err["stencil"], d)
        check.checks += 1
        if not torch.equal(dest(), want):
            fail(f"stencil differs from its plain version at {name}: max |diff| {d}")
        del want
        nbytes = es * R * (math.prod(read) + math.prod(written))
        windows.append({"application": name, "window": list(window), "ms": timer.ms(fn),
                        "plain_ms": timer.ms(plain, reps=STENCIL_REPS), "bytes": nbytes,
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        torch.cuda.empty_cache()
    del state, scratch, timer
    torch.cuda.empty_cache()
    out = {"ms": sum(w["ms"] for w in windows), "plain_ms": sum(w["plain_ms"] for w in windows),
           "bound_ms": sum(w["bound_ms"] for w in windows), "bound_by": "bytes",
           "ranks": R, "interior": list(n), "windows": windows}
    print("[stencil] 8 x " + "x".join(map(str, n)) + " float32, the s = 2 cycle's two "
          "windows bit-exact to the plain version; "
          + "; ".join(f"{w['application']}: {w['ms']:.3f} ms (plain {w['plain_ms']:.3f}, "
                      f"bound {w['bound_ms']:.3f})" for w in windows) + f"; {card}")
    return out


def phase_stencil_pair(torch, dev, check, card):
    """The fused pair on the auto cell's state (:data:`STENCIL_INTERIOR`,
    8 ranks, halo depth 3, rows of 518 floats): applications 2 and 3 of
    the s = 3 cycle read the scratch's 516^3 block and write the state's,
    held with ``torch.equal`` to the two launches and the splice copy they
    replace (application 2 with ``copy_rim`` into the state, application 3
    into the scratch, its window copied back).  Times the pair, those
    launches and the two plain updates (CUDA events) beside the pair's
    byte bound: the block read once and written once.  Returns the
    ``{"kernels": ...}`` line's timing fields."""
    from repro_torch.halo import STENCIL26, HaloSpec
    from repro_torch.kernels.ops import (stencil_window_pair, stencil_window_plain,
                                         stencil_window_update)

    spec = HaloSpec(grid=(2, 2, 2), interior=STENCIL_INTERIOR, radius=3)
    R, n = spec.nranks, spec.interior
    op, w = STENCIL26, STENCIL26.weight
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    scratch = torch.randn((R,) + spec.alloc, generator=gen, device=dev)
    state = torch.randn((R,) + spec.alloc, generator=gen, device=dev)

    def view(t, origin, shape):
        (z, y, x), (nz, ny, nx) = origin, shape
        return t[..., z:z + nz, y:y + ny, x:x + nx]

    block = ((1,) * 3, tuple(m + 4 for m in n))   # application 1's window: what the pair reads
    second = ((2,) * 3, tuple(m + 2 for m in n))  # application 2's window
    third = ((3,) * 3, tuple(n))                  # application 3's window

    def pair():
        stencil_window_pair(scratch, op.offsets, (w, w), *second, out=view(state, *block))

    def launches():
        stencil_window_update(scratch, op.offsets, w, *second, out=view(state, *block),
                              copy_rim=True)
        stencil_window_update(state, op.offsets, w, *third, out=view(scratch, *third))
        view(state, *third).copy_(view(scratch, *third))

    def plain():
        mid = view(scratch, *block).clone()
        view(mid, (1, 1, 1), second[1]).copy_(
            stencil_window_plain(scratch, op.offsets, w, *second))
        view(mid, (2, 2, 2), third[1]).copy_(
            stencil_window_plain(mid, op.offsets, w, (2, 2, 2), third[1]))
        return mid

    want = plain()
    keep = scratch.clone()  # the launches write application 3 into the scratch
    launches()
    torch.cuda.synchronize()
    if not torch.equal(view(state, *block), want):
        fail("the two stencil launches differ from the plain updates on the auto cell's state")
    scratch.copy_(keep)
    del keep
    state.normal_(generator=gen)
    pair()
    torch.cuda.synchronize()
    d = (view(state, *block) - want).abs().max().item()
    check.err["stencil_pairs"] = max(check.err["stencil_pairs"], d)
    check.checks += 1
    if not torch.equal(view(state, *block), want):
        fail(f"the fused pair differs from its two launches: max |diff| {d}")
    del want
    torch.cuda.empty_cache()
    timer = Timer(torch, dev)
    es = state.element_size()
    nbytes = 2 * es * R * math.prod(block[1])
    out = {"ms": timer.ms(pair), "two_launches_ms": timer.ms(launches),
           "plain_ms": timer.ms(plain, reps=STENCIL_REPS), "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "ranks": R,
           "interior": list(n), "window": list(block[1])}
    del state, scratch, timer
    torch.cuda.empty_cache()
    print(f"[stencil] the fused pair on 8 x {'x'.join(map(str, spec.alloc))} float32 bit-exact "
          f"to its two launches: {out['ms']:.3f} ms (two launches and the splice copy "
          f"{out['two_launches_ms']:.3f}, plain {out['plain_ms']:.3f}, bound "
          f"{out['bound_ms']:.3f}); {card}")
    return out


def sweep_check(torch, dev, ranks, check, gen):
    """Every kernel against its plain version at every (blk, total) point
    of the calibration sweep, ``ranks`` ranks a launch, and the ``xla``
    strategy's per-block copies against the plain pack where the sweep
    times them (up to its calibration cap)."""
    from repro_torch.comm import resolve_strategy
    from repro_torch.kernels.geometry import plan_geometry
    from repro_torch.kernels.pack import pack_plain
    from repro_torch.measure.bench import BLOCK_BYTES, TOTAL_BYTES, sweep_types

    xla = resolve_strategy("xla")
    points = 0
    for blk, nblocks, ct in sweep_types(BLOCK_BYTES, TOTAL_BYTES):
        geom = plan_geometry(ct.block)
        if geom is None:
            fail(f"no kernel geometry for sweep type {ct.block}")
        n = ct.extent + 64
        what = f"sweep blk {blk} total {nblocks * blk} ({nblocks} rows, pitch {geom.pitch * geom.word_bytes} B)"
        src = torch.randint(0, 256, (ranks, n), dtype=torch.uint8, device=dev, generator=gen)
        packed = check.pack_side(src, geom, what)
        if nblocks <= xla.calibration_cap:
            got = xla.pack(src, ct, batched=True)
            if not torch.equal(got, packed):
                fail(f"xla differs from the plain pack on {what}")
            want = src.clone()
            xla.unpack(want, packed.flip(0), ct, batched=True)
            check.unpack_side(src, packed.flip(0), geom, what, want=want)
        else:
            check.unpack_side(src, packed.flip(0), geom, what)
        del src, packed
        points += 1
    torch.cuda.synchronize()
    print(f"[kernels] {points} sweep points at {ranks} ranks a launch: every kernel "
          f"bit-exact against its plain version, xla against the plain pack up to "
          f"{xla.calibration_cap} blocks")


def global_layout(torch, spec, dev, g=None):
    """The global field (seeded normal values unless ``g`` is given),
    every rank's block with poisoned halos, and every cell as the
    periodic field has it (the exchange oracle)."""
    r = spec.radius
    n = spec.interior
    g_shape = tuple(p * k for p, k in zip(spec.grid, n))
    if g is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        g = torch.randn(g_shape, generator=gen, device=dev, dtype=torch.float32)
    start = torch.full((spec.nranks,) + spec.alloc, SENTINEL, device=dev)
    want = torch.empty_like(start)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        start[rank, r:r + n[0], r:r + n[1], r:r + n[2]] = g[
            c[0] * n[0]:(c[0] + 1) * n[0], c[1] * n[1]:(c[1] + 1) * n[1],
            c[2] * n[2]:(c[2] + 1) * n[2]]
        idx = [(torch.arange(a, device=dev) - r + ci * k) % gk
               for a, ci, k, gk in zip(spec.alloc, c, n, g_shape)]
        want[rank] = g.index_select(0, idx[0]).index_select(1, idx[1]).index_select(2, idx[2])
    return g, start, want


def stencil_roll(torch, g, op):
    acc = torch.zeros_like(g)
    for dz, dy, dx in op.offsets:
        acc += torch.roll(g, (-dz, -dy, -dx), (0, 1, 2))
    return (1 - op.weight) * g + (op.weight / op.nneighbors) * acc


def replayed_launches(steps):
    """The kernel launches the CUDA graphs of ``steps`` (halo steps)
    replayed, by ``launch_counts()`` name: each graph's replays times
    the launches of the call it captured (no wrapper counts a replay)."""
    out = {}
    for step in steps:
        for req in step.requests.values():
            if req.graph is not None:
                for k, n in req.graph.launches.items():
                    out[k] = out.get(k, 0) + req.graph.replays * n
    return out


def device_kernel_counts(torch, fn):
    """The card's activities during one call of ``fn`` under
    ``torch.profiler``, by name: their counts (the profiler names each
    kernel a CUDA graph launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def phase_main(torch, dev, spec, timings):
    import repro_torch.halo.stencil as halo_stencil
    from repro_torch.comm import Communicator, FixedPolicy, policy_for_mode
    from repro_torch.halo import STENCIL26, halo_exchange, make_halo_step, stencil_iterations
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts

    g, start, want = global_layout(torch, spec, dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    per_mode, replayed_by_mode, halo_steps = {}, {}, []
    for mode in ("tempi", "rows", "dma", "baseline"):
        before = launch_counts()
        comm = Communicator(policy=policy_for_mode(mode), device=dev)
        step = make_halo_step(spec, comm, device=dev)
        halo_steps.append(step)
        local = start.clone()
        t0 = time.perf_counter()
        step(local)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(local, want):
            bad = (local != want).sum().item()
            fail(f"{mode}: {bad} cells differ from the periodic global field")
        if comm.wire_payload_bytes != step.plan.wire.issued_bytes:
            fail(f"{mode}: transport counted {comm.wire_payload_bytes} bytes, plan "
                 f"issues {step.plan.wire.issued_bytes}")
        if mode == "baseline":
            ms, exchanges = first_ms, 1  # per-block copies are slow on purpose
        else:
            ms, exchanges = wall_ms(torch, lambda: step(local), 5), 6
        timings[f"exchange_ms_{mode}"] = ms
        per_mode[mode] = {k: launch_counts()[k] - before[k] for k in before}
        replayed = replayed_by_mode[mode] = replayed_launches([step])
        planned = plan_launches(step.plan, comm)
        # the wrappers count the eager calls and the capture; the graph
        # holds one exchange's launches, which each replay launches again
        (req,) = step.requests.values()
        if req.graph is not None and \
                any(req.graph.launches.get(k, 0) != planned[k] for k in planned):
            fail(f"{mode}: the captured exchange launched {req.graph.launches}; the plan "
                 f"launches {planned} per exchange")
        if any(per_mode[mode][k] + replayed.get(k, 0) != exchanges * planned[k]
               for k in planned):
            fail(f"{mode}: {per_mode[mode]} launches and {replayed} replayed in {exchanges} "
                 f"exchanges; the plan launches {planned} per exchange")
        if req.graph is not None:
            # the profiler, not the counters: one replay runs the kernels
            # of one eager exchange, by name and count
            graph_kernels = device_kernel_counts(torch, lambda: step(local))
            eager_kernels = device_kernel_counts(
                torch, lambda: halo_exchange(local, spec, comm, plan=step.plan))
            if graph_kernels != eager_kernels:
                fail(f"{mode}: a replay ran {graph_kernels} on the card; an eager exchange "
                     f"runs {eager_kernels}")
        if mode == "tempi":
            timings["tempi_launches_per_exchange"] = planned
        print(f"[main] {mode}: exchange bit-exact, schedule {step.plan.wire.schedule}, "
              f"{step.plan.wire.issued_bytes} bytes/rank issued, "
              f"strategies {sorted({s.name for s in step.plan.strategies})}, "
              f"{ms:.3f} ms/exchange (host clock), launches {per_mode[mode]} and "
              f"{replayed} replayed from a CUDA graph in {exchanges} exchanges, per exchange "
              f"{planned}")
        del local

    comm = Communicator(policy=FixedPolicy("rows"), device=dev)
    step = make_halo_step(spec, comm, device=dev, schedule_policy="exact")
    local = start.clone()
    step(local)
    torch.cuda.synchronize()
    if not torch.equal(local, want):
        fail("exact schedule: exchange differs from the periodic global field")
    if (comm.wire_ops, comm.wire_payload_bytes) != (7, step.plan.wire_bytes):
        fail(f"exact schedule: {comm.wire_ops} ops, {comm.wire_payload_bytes} bytes; "
             f"want 7 ops, {step.plan.wire_bytes} bytes")
    print(f"[main] exact schedule: 7 wire ops, {comm.wire_payload_bytes} bytes/rank "
          f"== plan.wire_bytes")
    del local, want

    # 5 iterations of exchange + 2 stencil applications under tempi
    step = make_halo_step(spec, device=dev)
    halo_steps.append(step)
    local = start.clone()
    del start
    iters, steps = 5, 2
    splices = halo_stencil.splice_copies
    t0 = time.perf_counter()
    for _ in range(iters):
        step(local)
        stencil_iterations(local, spec, steps=steps)
    torch.cuda.synchronize()
    timings["iteration_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    timings["splice_copies"] = halo_stencil.splice_copies - splices
    if timings["splice_copies"]:
        fail(f"{iters} iterations of the s = 2 cycle copied {timings['splice_copies']} "
             f"windows into the state; the scratch chain copies none")
    for _ in range(iters * steps):
        g = stencil_roll(torch, g, STENCIL26)
    r, n = spec.radius, spec.interior
    err = 0.0
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        got = local[rank, r:r + n[0], r:r + n[1], r:r + n[2]]
        ref = g[c[0] * n[0]:(c[0] + 1) * n[0], c[1] * n[1]:(c[1] + 1) * n[1],
                c[2] * n[2]:(c[2] + 1) * n[2]]
        if not torch.isfinite(got).all():
            fail(f"rank {rank}: non-finite values after {iters} iterations")
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        err = max(err, (got - ref).abs().max().item())
    timings["stencil_max_abs_err"] = err

    def iteration():
        step(local)
        stencil_iterations(local, spec, steps=steps)

    timings["iteration_ms_synchronized"] = wall_ms(torch, iteration, iters)
    timings["iteration_profile"] = device_busy(torch, iteration)
    print(f"[main] {iters} iterations of exchange + {steps} stencil applications match "
          f"the roll oracle, max |err| {err:.3e}; {timings['iteration_ms']:.3f} ms/iteration "
          f"back to back, {timings['iteration_ms_synchronized']:.3f} synchronized each, "
          f"device idle {timings['iteration_profile']['idle_share']:.4f} of 2 iterations")
    counts = launch_counts()
    zero = [k for k in KERNELS if counts[k] == 0]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    replayed = replayed_launches(halo_steps)
    print(json.dumps({"launches": counts, "launches_by_mode": per_mode,
                      "replayed": replayed, "replayed_by_mode": replayed_by_mode}))

    # stencil application alone (device time)
    timer = Timer(torch, dev)
    from repro_torch.halo import stencil_apply
    timings["stencil_apply_ms"] = timer.ms(lambda: stencil_apply(local, spec, valid=1), reps=5)
    timings["stencil_iterations2_ms"] = timer.ms(
        lambda: stencil_iterations(local, spec, steps=2), reps=5)
    del local, g, timer
    torch.cuda.empty_cache()
    return counts, replayed


def region_names(plan):
    """``{"-0+": strategy}``: each region's direction (dz, dy, dx) and the
    strategy the plan picked for it."""
    from repro_torch.halo import DIRECTIONS

    return {"".join("-0+"[c + 1] for c in d): s.name
            for d, s in zip(DIRECTIONS, plan.strategies)}


def phase_measure(torch, dev, spec, card):
    """Calibrate the §5 model's tables on the card through
    ``production_communicator`` into a temporary store, then run the
    full-width ``tempi`` exchange with them: the measured picks beside
    those of the analytic and the checked-in H100 tables, the picks of
    ``RECALIBRATIONS`` more calibrations (their spread), ms per exchange
    under each table and under both wire schedules, the measured pick
    against the fastest of rows, dma and xla for each of the 26 send
    types, and a second communicator that replays every region pick
    from the saved decisions file."""
    import dataclasses
    import tempfile

    from repro_torch.comm import Communicator, H100_ANALYTIC, reschedule
    from repro_torch.halo import DIRECTIONS, halo_exchange, make_halo_plan, make_halo_types
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.measure import (calibrate_params, load_h100_params,
                                     production_communicator, time_fn)

    out = {"card": card, "ranks": spec.nranks}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_measure_") as root:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        comm, save = production_communicator(root, ranks=spec.nranks, device=dev)
        torch.cuda.synchronize()
        out["calibration_s"] = time.perf_counter() - t0
        out["calibration_launches"] = launch_counts()
        if not all(out["calibration_launches"][k] for k in KERNELS):
            fail(f"calibration never launched a kernel: {out['calibration_launches']}")
        params, model = comm.model.params, comm.model
        for name in ("rows", "dma"):
            for look in (model.measured, model.measured_unpack):
                if look(name, 8, 1 << 14) is None:
                    fail(f"no measured {look.__name__} table for {name}")
        if params.wire_latency is None or params.wire_bw is None:
            fail(f"the wire fit came back empty: {params.wire_latency}, {params.wire_bw}")
        out.update(
            wire_latency=params.wire_latency, wire_bw=params.wire_bw, hbm_bw=params.hbm_bw,
            rows={f"{kind}/{k}": len(v) for kind, tables in
                  (("pack", params.pack_table), ("unpack", params.unpack_table))
                  for k, v in tables.items()},
        )
        out["rows"].update(wire=len(params.wire_table), copy=len(params.copy_table))
        if set(params.compress_table or ()) != {"rlewire", "int8wire"}:
            fail(f"no compress sweep for both codecs: {params.compress_table}")
        out["compress_table"] = params.compress_table
        print(json.dumps({"measure_params": json.loads(params.to_json()), "card": card}))

        # the picks, measured against analytic and the checked-in table
        comms = {"measured": comm,
                 "analytic": Communicator(params=H100_ANALYTIC, device=dev),
                 "checked_in": Communicator(params=load_h100_params(), device=dev)}
        analytic = comms["analytic"]
        plans = {k: make_halo_plan(spec, c) for k, c in comms.items()}
        for key, plan in plans.items():
            m = comms[key].model
            out[f"picks_{key}"] = region_names(plan)
            out[f"schedule_{key}"] = plan.wire.schedule
            out[f"issued_bytes_{key}"] = plan.wire.issued_bytes
            out[f"priced_{key}"] = m.price_wire_schedules(plan.wire, comm.transport.native_ragged)
        base = plans["measured"]
        for sched in ("grouped", "uniform"):
            plans[sched] = dataclasses.replace(base, wire=reschedule(base.wire, sched))
            comms[sched] = comm

        # the spread of the picks over calibrations of this card
        out["recalibrations"] = []
        for _ in range(RECALIBRATIONS):
            c = Communicator(params=calibrate_params(ranks=spec.nranks, device=dev), device=dev)
            plan = make_halo_plan(spec, c)
            names = list(region_names(plan).values())
            out["recalibrations"].append({
                "schedule": plan.wire.schedule,
                "picks": {n: names.count(n) for n in sorted(set(names))},
                "priced": c.model.price_wire_schedules(plan.wire, c.transport.native_ragged),
                "wire_latency": c.model.params.wire_latency, "wire_bw": c.model.params.wire_bw})

        # ms per exchange under each, bit-exact against the periodic field
        _, start, want = global_layout(torch, spec, dev)
        local = start.clone()
        order = list(plans)
        ms = {k: [] for k in order}
        reps, rounds = 10, 6
        reset_launch_counts()
        for rnd in range(rounds):
            for key in (order if rnd % 2 == 0 else order[::-1]):
                c = comms[key]
                run = lambda: halo_exchange(local, spec, c, plan=plans[key])
                local.copy_(start)  # poisoned halos
                run()
                torch.cuda.synchronize()
                if not torch.equal(local, want):
                    fail(f"measured-params exchange ({key}) differs from the periodic field")
                ms[key].append(wall_ms(torch, run, reps))
        counts = launch_counts()
        planned = {k: 0 for k in counts}
        for key, plan in plans.items():
            for k, v in plan_launches(plan, comms[key]).items():
                planned[k] += rounds * (reps + 1) * v
        if counts != planned:
            fail(f"measured-params exchanges launched {counts}; the plans launch {planned}")
        out["exchange_ms"] = ms
        out["exchange_launches"] = counts
        del local, start, want

        # each send type: rows, dma and xla pack + unpack, 8 ranks a launch
        types = make_halo_types(spec, comm)
        state = torch.randn((spec.nranks,) + spec.alloc, device=dev).view(spec.nranks, -1)
        state = state.view(torch.uint8)
        per_type, hits, hits_analytic = [], 0, 0
        for d in DIRECTIONS:
            send_ct, recv_ct = types[d]
            times = {}
            for rnd in range(3):  # rows and dma in turns, the least of 3 readings
                for name in ("rows", "dma", "xla") if rnd == 0 else ("dma", "rows"):
                    strat = comm.strategies.get(name)

                    def both(strat=strat):
                        strat.unpack(state, strat.pack(state, send_ct, batched=True), recv_ct,
                                     batched=True)

                    t = time_fn(both, iters=1 if name == "xla" else 20) * 1e3
                    times[name] = min(times.get(name, t), t)
            fastest = min(times, key=times.get)
            pick = model.select(send_ct, 1, allow_bounding=False).strategy
            pick_a = analytic.model.select(send_ct, 1, allow_bounding=False).strategy
            hits += pick == fastest
            hits_analytic += pick_a == fastest
            per_type.append({"region": list(d), "ms": times, "fastest": fastest,
                             "measured_pick": pick, "analytic_pick": pick_a,
                             "predicted_ms": {n: model.estimate(send_ct, 1, n).t_pack * 1e3
                                              + model.estimate(send_ct, 1, n).t_unpack * 1e3
                                              for n in times}})
        del state
        out["fastest_matches"] = {"measured": hits, "analytic": hits_analytic,
                                  "types": len(per_type)}
        print(json.dumps({"measure_types": per_type, "card": card}))

        # a second communicator replays every pick from the saved pins
        save()
        out["decisions"] = len(comm.model.decisions)
        for key, params2 in (("pinned", None), ("pinned_over_analytic", H100_ANALYTIC)):
            again, _ = production_communicator(root, params=params2, ranks=spec.nranks,
                                                device=dev)
            if params2 is None and again.model.params != params:
                fail("the stored envelope did not load back as the calibrated params")
            plan2 = make_halo_plan(spec, again)
            hits2 = again.model.decisions.pinned_hits
            # one hit a region: the schedule is re-priced, not pinned
            if region_names(plan2) != out["picks_measured"] or hits2 < len(plan2.strategies):
                fail(f"{key}: picks {region_names(plan2)} from {hits2} pins; "
                     f"recorded {out['picks_measured']}")
            if params2 is None and plan2.wire.schedule != base.wire.schedule:
                fail(f"pinned rerun picked schedule {plan2.wire.schedule}")
            out[f"{key}_hits"] = hits2
            out[f"{key}_schedule"] = plan2.wire.schedule
    torch.cuda.empty_cache()
    print(f"[measure] calibrated in {out['calibration_s']:.2f} s; wire fit "
          f"{out['wire_latency'] * 1e6:.2f} us + n / {out['wire_bw'] / 1e9:.1f} GB/s; "
          f"schedule measured {out['schedule_measured']}, analytic {out['schedule_analytic']}, "
          f"checked-in {out['schedule_checked_in']}, recalibrated "
          f"{[r['schedule'] for r in out['recalibrations']]}; "
          f"measured pick fastest in {hits}/{len(per_type)} send types (analytic {hits_analytic})")
    for name, rows in out["compress_table"].items():
        print(f"[measure] compress sweep {name} (log2 bytes a rank, encode us, decode us, "
              f"ratio; 8 ranks a call): "
              + ", ".join(f"({r[0]:.0f}, {r[1] * 1e6:.1f}, {r[2] * 1e6:.1f}, {r[3]:.4f})"
                          for r in rows))
    print(json.dumps({"measure": out}))
    return out, params


class CellCount:
    """While active, counts the computed cells (all ranks; a copied rim
    is not computed) of every stencil window update the halo layer asks
    for, from the windows it passes: single updates (the plain path, the
    shell slabs, the rim regions), both updates of a fused pair and each
    stage of a chain (the interior chain)."""

    def __init__(self):
        import repro_torch.halo.stencil as stencil

        self.stencil = stencil
        self.orig = (stencil.stencil_window_update, stencil.stencil_window_pair,
                     stencil.stencil_window_chain)
        self.cells = 0

    def _add(self, arr, shape):
        self.cells += arr[..., 0, 0, 0].numel() * shape[0] * shape[1] * shape[2]

    def __enter__(self):
        update, pair, chain = self.orig

        def counted_update(arr, offsets, weight, origin, shape, **kw):
            self._add(arr, shape)
            return update(arr, offsets, weight, origin, shape, **kw)

        def counted_pair(arr, offsets, weights, origin, shape, **kw):
            self._add(arr, shape)
            self._add(arr, [m - 2 for m in shape])
            return pair(arr, offsets, weights, origin, shape, **kw)

        def counted_chain(arr, stages):
            shape = arr.shape[-3:]
            for _, _, radii in stages:
                shape = [n - 2 * r for n, r in zip(shape, radii)]
                self._add(arr, shape)
            return chain(arr, stages)

        self.stencil.stencil_window_update = counted_update
        self.stencil.stencil_window_pair = counted_pair
        self.stencil.stencil_window_chain = counted_chain
        return self

    def __exit__(self, *exc):
        (self.stencil.stencil_window_update, self.stencil.stencil_window_pair,
         self.stencil.stencil_window_chain) = self.orig


def rank_blocks(torch, spec, g):
    """Every rank's block of the global field ``g`` inside halos of
    ``spec.radii``, the halo cells poisoned."""
    n, r = spec.interior, spec.radii
    out = torch.full((spec.nranks,) + spec.alloc, SENTINEL, device=g.device)
    for rank in range(spec.nranks):
        c = spec.coords(rank)
        out[rank, r[0]:r[0] + n[0], r[1]:r[1] + n[1], r[2]:r[2] + n[2]] = g[
            c[0] * n[0]:(c[0] + 1) * n[0], c[1] * n[1]:(c[1] + 1) * n[1],
            c[2] * n[2]:(c[2] + 1) * n[2]]
    return out


def interior_of(spec, x):
    n, r = spec.interior, spec.radii
    return x[:, r[0]:r[0] + n[0], r[1]:r[1] + n[1], r[2]:r[2] + n[2]]


def device_busy(torch, fn, iters=2, top=0):
    """``torch.profiler`` over ``iters`` back-to-back calls of ``fn``,
    synchronized before and after: the wall time, the union of the
    card's activity intervals (busy), the sum of their durations (above
    busy where two streams ran at once), the idle share, and the host's
    stream synchronizations (``cudaStreamSynchronize`` calls); with
    ``top``, also :func:`kernels_by_name` of the same profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail("torch.profiler recorded no activity on the card")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    syncs = sum(e.name == "cudaStreamSynchronize" for e in prof.events())
    out = {"wall_us": wall, "busy_us": busy, "activity_sum_us": sum(b - a for a, b in spans),
           "activities": len(spans), "idle_share": 1.0 - busy / wall, "stream_syncs": syncs}
    if top:
        out.update(kernels_by_name(torch, prof, top))
    return out


def split_application(torch, dev, spec, x):
    """CUDA-event ms of the first application of an s = 2 iteration
    (``STENCIL26``, valid depth ``spec.radii``) computed whole, against
    the overlapped path's split of it: the chain block (the interior
    shrunk by the stencil radius) and the six shell slabs around it."""
    from repro_torch.halo import STENCIL26
    from repro_torch.halo.stencil import _shell_slabs
    from repro_torch.kernels.ops import stencil_window_update

    timer = Timer(torch, dev)
    op = STENCIL26

    def update(origin, shape):
        return timer.ms(lambda: stencil_window_update(x, op.offsets, op.weight, origin, shape),
                        reps=5)

    shell = tuple(v - r for v, r in zip(spec.radii, op.radii))
    origin = tuple(hr - s for hr, s in zip(spec.radii, shell))
    shape = tuple(n + 2 * s for n, s in zip(spec.interior, shell))
    inner = tuple(hr + r for hr, r in zip(spec.radii, op.radii))
    inner_shape = tuple(n - 2 * r for n, r in zip(spec.interior, op.radii))
    slabs = [{"origin": list(o), "shape": list(s), "ms": update(o, s)}
             for o, s in _shell_slabs(origin, shape, inner, inner_shape)]
    out = {"window": list(shape), "window_ms": update(origin, shape),
           "chain_block": list(inner_shape), "chain_block_ms": update(inner, inner_shape),
           "slabs": slabs, "slabs_ms": sum(s["ms"] for s in slabs)}
    del timer
    return out


def phase_program(torch, dev, spec, card, measured):
    """The deep-halo programs and the overlapped iteration at full width
    (8 ranks, 256^3 each).  Launch counts are zeroed just before and read
    just after; every kernel must have run, and each variant's launches
    must be its plan's per exchange.

    * the s = 2 program against the main-path loop (``make_halo_step`` +
      ``stencil_iterations(steps=2)``) from the same start: ``torch.equal``;
    * s = 1, 2, 3 over 6 applications each: equal interiors; ms per
      iteration and per application (host clock, synchronized each
      iteration, and back to back);
    * ``steps="auto"`` under the analytic and the calibrated tables, the
      candidates' predicted seconds per application, and a reloaded
      decisions file that must pin the pick;
    * the overlapped iteration in each mode against the plain s = 2
      program: ``torch.equal``, stencil cells computed equal to the plain
      path's (no cell of an application twice), ms per iteration, the
      probe, and the device's idle share under ``torch.profiler``; and
      the first application whole against its chain block + shell slabs
      (:func:`split_application`)."""
    import tempfile

    from repro_torch.comm import H100_ANALYTIC, Communicator
    from repro_torch.halo import (OVERLAP_MODES, build_halo_program, make_halo_step,
                                  overlap_region_descriptors, stencil_iterations)
    from repro_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from repro_torch.measure import DecisionCache

    if not measured.stencil_table:
        fail("the calibration filled no stencil table")
    grid, interior = spec.grid, spec.interior
    out = {"card": card, "ranks": spec.nranks, "interior": list(interior)}
    g, start, want = global_layout(torch, spec, dev)
    del want
    torch.cuda.synchronize()
    reset_launch_counts()
    comm = Communicator(device=dev)
    progs = {s: build_halo_program(grid, interior, comm, steps=s) for s in PROGRAM_DEPTHS}
    p2 = progs[2]

    def run(prog, x, n, what, overlap=False, probe=None):
        before = launch_counts()
        for _ in range(n):
            prog.iteration(x, comm, overlap=overlap, probe=probe)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        planned = plan_launches(prog.plan, comm)
        if any(got[k] != n * planned[k] for k in planned):
            fail(f"{what}: {got} launches in {n} iterations; the plan launches {planned} "
                 f"per exchange")
        return planned

    # the s = 2 program against today's main-path loop
    loop = make_halo_step(spec, device=dev)
    want = start.clone()
    for _ in range(PROGRAM_ITERS):
        loop(want)
        stencil_iterations(want, spec, steps=2)
    got = start.clone()
    run(p2, got, PROGRAM_ITERS, "program s=2")
    if not torch.equal(got, want):
        fail(f"the s = 2 program differs from the main-path loop after {PROGRAM_ITERS} "
             f"iterations: {(got != want).sum().item()} cells")
    del got, want

    # fixed depths: 6 applications each, equal interiors, then timings
    apps, states, first = 6, {}, None
    out["depths"] = {}
    for s, prog in progs.items():
        x = rank_blocks(torch, prog.spec, g)
        planned = run(prog, x, apps // s, f"program s={s}")
        inner = interior_of(prog.spec, x)
        if not torch.isfinite(inner).all():
            fail(f"s={s}: non-finite values after {apps} applications")
        if first is None:
            first = inner.clone()
        elif not torch.equal(inner, first):
            fail(f"s={s}: the interior after {apps} applications differs from s=1's")
        states[s] = x
        out["depths"][s] = {"radius": list(prog.spec.radii), "schedule": prog.plan.wire.schedule,
                            "issued_bytes": prog.plan.wire.issued_bytes,
                            "launches_per_exchange": planned,
                            "predicted_per_step_ms": prog.estimate.per_step * 1e3,
                            "ms_per_iteration": [], "back_to_back_ms_per_application": []}
    del first
    for rnd in range(2):
        for s in ((1, 2, 3) if rnd == 0 else (3, 2, 1)):
            row, prog, x = out["depths"][s], progs[s], states[s]
            row["ms_per_iteration"].append(wall_ms(torch, lambda: prog.iteration(x, comm),
                                                   PROGRAM_REPS))
            t0 = time.perf_counter()
            for _ in range(apps // s):
                prog.iteration(x, comm)
            torch.cuda.synchronize()
            row["back_to_back_ms_per_application"].append(
                (time.perf_counter() - t0) * 1e3 / apps)
    for s, row in out["depths"].items():
        row["ms_per_application"] = [t / s for t in row["ms_per_iteration"]]
    del states

    # steps="auto": the model's pick under both tables, pinned on reload
    out["auto"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_program_") as root:
        for key, params in (("analytic", H100_ANALYTIC), ("measured", measured)):
            decisions = DecisionCache()
            c = Communicator(params=params, device=dev, decisions=decisions)
            prog = build_halo_program(grid, interior, c, steps="auto")
            path = decisions.save(os.path.join(root, f"{key}.json"))
            again = build_halo_program(
                grid, interior,
                Communicator(params=params, device=dev, decisions=DecisionCache.load(path)),
                steps="auto")
            if prog.pinned or not again.pinned or again.steps != prog.steps:
                fail(f"{key}: steps={prog.steps} (pinned {prog.pinned}), reloaded "
                     f"steps={again.steps} (pinned {again.pinned})")
            out["auto"][key] = {
                "steps": prog.steps, "reloaded_steps": again.steps, "reloaded_pinned": True,
                "program_rows": len(decisions.program_rows()),
                "candidates": {e.steps: {"per_step_ms": e.per_step * 1e3,
                                         "t_exchange_ms": e.t_exchange * 1e3,
                                         "t_redundant_ms": e.t_redundant * 1e3}
                               for e in prog.candidates}}
    measured_fastest = min(out["depths"], key=lambda s: min(out["depths"][s]["ms_per_application"]))
    out["fastest_depth_measured"] = measured_fastest

    # the overlapped iteration in each mode against the plain s = 2 program
    modes = ("plain",) + OVERLAP_MODES
    overlap = {m: (False if m == "plain" else m) for m in modes}
    out["overlap"] = {m: {"ms_per_iteration": [], "back_to_back_ms_per_iteration": []}
                      for m in modes}
    finals, xs = {}, {}
    for m in modes:
        x, probe = start.clone(), {}
        with CellCount() as cc:
            run(p2, x, 1, f"overlap {m}", overlap[m], probe)
        run(p2, x, PROGRAM_ITERS - 1, f"overlap {m}", overlap[m])
        row = out["overlap"][m]
        row["cells_first_iteration"] = cc.cells
        row["probe"] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in probe.items()
                        if k != "region_order"}
        if m == "plain":
            finals[m] = x
        else:
            if not torch.equal(x, finals["plain"]):
                fail(f"overlap {m}: {(x != finals['plain']).sum().item()} cells differ from "
                     f"the plain program after {PROGRAM_ITERS} iterations")
            if cc.cells != out["overlap"]["plain"]["cells_first_iteration"]:
                fail(f"overlap {m}: computed {cc.cells} stencil cells in one iteration; the "
                     f"plain path computes {out['overlap']['plain']['cells_first_iteration']}")
        xs[m] = x
    del finals
    windows = sum(
        spec.nranks * ((interior[0] + 2 * v) * (interior[1] + 2 * v) * (interior[2] + 2 * v))
        for v in (1, 0))
    if out["overlap"]["plain"]["cells_first_iteration"] != windows:
        fail(f"the plain s = 2 iteration computed "
             f"{out['overlap']['plain']['cells_first_iteration']} cells; its windows hold {windows}")
    out["overlap_auto_resolved"] = out["overlap"]["auto"]["probe"]["overlap_mode"]
    core, rims = overlap_region_descriptors(p2.spec, p2.ops, p2.plan.wire)
    for key, c in (("analytic", comm), ("measured", Communicator(params=measured, device=dev))):
        mode, ests, _ = c.model.choose_overlap_mode(p2.plan.wire, rims, core,
                                                    p2.ops[0].nneighbors)
        out[f"overlap_pick_{key}"] = {"mode": mode, **{f"{m}_ms": e.t_total * 1e3
                                                       for m, e in ests.items()}}
    for rnd in range(2):
        for m in (modes if rnd == 0 else modes[::-1]):
            row, x = out["overlap"][m], xs[m]
            row["ms_per_iteration"].append(
                wall_ms(torch, lambda: p2.iteration(x, comm, overlap=overlap[m]), PROGRAM_REPS))
            t0 = time.perf_counter()
            for _ in range(PROGRAM_REPS):
                p2.iteration(x, comm, overlap=overlap[m])
            torch.cuda.synchronize()
            row["back_to_back_ms_per_iteration"].append(
                (time.perf_counter() - t0) * 1e3 / PROGRAM_REPS)
    for m in ("plain", "monolithic", "region"):
        x = xs[m]
        out["overlap"][m]["profile"] = device_busy(
            torch, lambda: p2.iteration(x, comm, overlap=overlap[m]))
    out["first_application"] = split_application(torch, dev, p2.spec, xs["plain"])
    del xs, start, g
    torch.cuda.empty_cache()
    counts = launch_counts()
    zero = [k for k in KERNELS if counts[k] == 0]
    if zero:
        fail(f"kernels never launched in the program phase: {zero}")
    out["launches"] = counts
    d = out["depths"]
    print(f"[program] s=2 program == main-path loop; s=1,2,3 interiors equal after {apps} "
          f"applications; ms/application (synchronized iterations) "
          + ", ".join(f"s={s} {min(r['ms_per_application']):.3f}" for s, r in d.items())
          + f"; auto picks s={out['auto']['analytic']['steps']} (analytic), "
          f"s={out['auto']['measured']['steps']} (calibrated), pinned on reload; overlap "
          + ", ".join(f"{m} {min(r['ms_per_iteration']):.3f}" for m, r in out["overlap"].items())
          + f" ms/iteration, all torch.equal to the plain path, auto -> "
          f"{out['overlap_auto_resolved']}; {card}")
    print(json.dumps({"program": out}))
    return counts, out["first_application"]["window_ms"]


def phase_dist(torch, dev, card):
    """One process per rank through ``torch.distributed``: a world-size-1
    NCCL group started in this process over a ``file://`` store, on
    ``HaloSpec(grid=(1, 1, 1), interior=256^3, radius=2)``, where all 26
    neighbours are the process itself (real NCCL collectives and
    send/receive pairs to itself).  Every run is held ``torch.equal`` to
    the same run through the local mesh at R = 1 on this card, with equal
    wire op and byte counts: the exchange under ``grouped``, ``uniform``,
    ``ragged`` and ``tiered`` (on one node: no bundle, so grouped's
    sends); the s = 2 program plain, ``monolithic`` and
    ``region`` (the local mesh runs the NCCL program's plan); the +x face
    region of a point source sent to itself by ``rlewire``, planned with a
    probe of the block and run on the ``varlen`` schedule (the stream prefix as the
    split size of one ``all_to_all_single``); one ``sendrecv`` of the
    x-face type.  Launch counts are zeroed before and
    read after each NCCL run (the local-mesh runs are not counted); every
    kernel must have run.  Times: host clock, synchronized, median of
    ``DIST_REPS`` calls a reading, NCCL and the local mesh in turns.  The
    group is torn down before the phase returns."""
    import dataclasses
    import tempfile

    from repro_torch.comm import (Communicator, DistributedTransport, FixedPolicy, Topology,
                                  reschedule)
    from repro_torch.halo import (HaloSpec, build_halo_program, halo_exchange,
                                  make_halo_plan, make_halo_types)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group

    spec = HaloSpec(grid=(1, 1, 1), interior=(256, 256, 256), radius=2)
    out = {"card": card, "grid": list(spec.grid), "interior": list(spec.interior),
           "radius": spec.radius, "exchange": {}, "program": {}}
    counts = dict.fromkeys(EXCHANGE_KERNELS, 0)

    def counted(fn):
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launched = launch_counts()
        for k in counts:  # the pack and unpack kernels
            counts[k] += launched[k]

    def same(what, xd, xl, cd, cl):
        if not torch.equal(xd, xl):
            fail(f"[dist] {what}: {(xd != xl).sum().item()} cells differ between NCCL and "
                 f"the local mesh")
        got = (cd.wire_ops, cd.wire_payload_bytes)
        if got != (cl.wire_ops, cl.wire_payload_bytes):
            fail(f"[dist] {what}: NCCL counted {got} wire ops and bytes, the local mesh "
                 f"{(cl.wire_ops, cl.wire_payload_bytes)}")
        return {"wire_ops": cd.wire_ops, "wire_bytes": cd.wire_payload_bytes}

    def in_turns(nccl_fn, local_fn):
        """ms per call under NCCL and the local mesh, ``DIST_ROUNDS``
        rounds of NCCL, local, local, NCCL, each reading the median of
        ``DIST_REPS`` synchronized calls."""
        ms = {"ms_nccl": [], "ms_local": []}
        for _ in range(DIST_ROUNDS):
            for key, fn in (("ms_nccl", nccl_fn), ("ms_local", local_fn),
                            ("ms_local", local_fn), ("ms_nccl", nccl_fn)):
                ms[key].append(wall_ms(torch, fn, DIST_REPS))
        return ms

    t_phase = time.perf_counter()
    g, start, want = global_layout(torch, spec, dev)
    del g
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as root:
        t0 = time.perf_counter()
        info = init_process_group("nccl", dev, store_path=os.path.join(root, "store"),
                                  rank=0, world_size=1)
        out["init_s"] = time.perf_counter() - t0
        out["nccl_socket_ifname"] = os.environ.get("NCCL_SOCKET_IFNAME")
        try:
            def nccl(topology=None):
                return Communicator(transport=DistributedTransport(device=info.device),
                                    topology=topology)

            out["model_schedule"] = make_halo_plan(spec, nccl()).wire.schedule
            for sched in ("grouped", "uniform", "ragged", "tiered"):
                # tiered on one node: no class crosses a node, so no bundle
                topo = Topology.flat(1) if sched == "tiered" else None
                cd, cl = nccl(topo), Communicator(device=dev, topology=topo)
                pd, pl = (make_halo_plan(spec, c, schedule_policy="exact") for c in (cd, cl))
                pd = dataclasses.replace(pd, wire=reschedule(pd.wire, sched))
                pl = dataclasses.replace(pl, wire=reschedule(pl.wire, sched))
                xd, xl = start.clone(), start.clone()
                counted(lambda: halo_exchange(xd, spec, cd, plan=pd))
                halo_exchange(xl, spec, cl, plan=pl)
                torch.cuda.synchronize()
                if not torch.equal(xd, want):
                    fail(f"[dist] {sched}: the NCCL exchange differs from the periodic field")
                row = same(f"exchange {sched}", xd, xl, cd, cl)
                row.update(in_turns(lambda: halo_exchange(xd, spec, cd, plan=pd),
                                    lambda: halo_exchange(xl, spec, cl, plan=pl)))
                out["exchange"][sched] = row
                del xd, xl

            pd = build_halo_program(spec.grid, spec.interior, nccl(), steps=2)
            pl = dataclasses.replace(
                build_halo_program(spec.grid, spec.interior, Communicator(device=dev), steps=2),
                plan=pd.plan)
            out["program_schedule"] = pd.plan.wire.schedule
            for mode in ("plain", "monolithic", "region"):
                ov = False if mode == "plain" else mode
                cd, cl = nccl(), Communicator(device=dev)
                xd, xl = start.clone(), start.clone()
                counted(lambda: [pd.iteration(xd, cd, overlap=ov) for _ in range(2)])
                for _ in range(2):
                    pl.iteration(xl, cl, overlap=ov)
                torch.cuda.synchronize()
                if not torch.isfinite(xd).all():
                    fail(f"[dist] program {mode}: non-finite values")
                row = same(f"program {mode}", xd, xl, cd, cl)
                row.update(in_turns(lambda: pd.iteration(xd, cd, overlap=ov),
                                    lambda: pl.iteration(xl, cl, overlap=ov)))
                out["program"][mode] = row
                del xd, xl

            # the +x face region of a point source to itself, probed, varlen
            _, pstart, _ = global_layout(torch, spec, dev, point_field(torch, spec, dev, 0))
            rle = FixedPolicy("rlewire")
            cd = Communicator(transport=DistributedTransport(device=info.device), policy=rle)
            cl = Communicator(device=dev, policy=rle)
            xd, xl = pstart.clone(), pstart.clone()
            del pstart
            plans = {}
            for c, x in ((cd, xd), (cl, xl)):
                send_ct, recv_ct = make_halo_types(spec, c)[(0, 0, 1)]
                strats, wire = c.plan_neighbor([send_ct], [[(0, 0)]], probe=x[0])
                if not wire.stream_bytes:
                    fail("[dist] varlen: the probe annotated no stream length")
                plans[c] = (send_ct, recv_ct, strats, reschedule(wire, "varlen"), wire.schedule)

            def varlen(c, x):
                send_ct, recv_ct, strats, wire, _ = plans[c]
                c.neighbor_alltoallv(x, [send_ct], [recv_ct], [[(0, 0)]], plan=wire,
                                     strategies=strats)

            counted(lambda: varlen(cd, xd))
            varlen(cl, xl)
            torch.cuda.synchronize()
            row = same("varlen", xd, xl, cd, cl)
            _, _, strats, wire, picked = plans[cd]
            row.update(model_schedule=picked, strategy=strats[0].name,
                       stream_bytes=wire.stream_bytes[0], capacity_bytes=wire.wire_bytes)
            row.update(in_turns(lambda: varlen(cd, xd), lambda: varlen(cl, xl)))
            out["varlen"] = row
            del xd, xl

            cd, cl = nccl(), Communicator(device=dev)
            send_ct, recv_ct = make_halo_types(spec, cd)[(0, 0, 1)]
            xd, xl = start.clone(), start.clone()
            counted(lambda: cd.sendrecv(xd.view(1, -1), xd.view(1, -1), send_ct, [(0, 0)],
                                        recv_ct))
            cl.sendrecv(xl.view(1, -1), xl.view(1, -1), send_ct, [(0, 0)], recv_ct)
            torch.cuda.synchronize()
            out["sendrecv"] = same("sendrecv", xd, xl, cd, cl)
            out["sendrecv"]["strategy"] = cd.select(send_ct).name
            del xd, xl
        finally:
            destroy_process_group()
    del start, want
    torch.cuda.empty_cache()
    zero = [k for k, v in counts.items() if v == 0]
    if zero:
        fail(f"kernels never launched through the NCCL transport: {zero}")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    ex, pr = out["exchange"], out["program"]

    def span(v):
        return f"{min(v):.3f}-{max(v):.3f}"

    print(f"[dist] world of 1 under NCCL (group and communicator up in {out['init_s']:.2f} s, "
          f"phase {out['phase_s']:.1f} s), ms: exchange "
          + ", ".join(f"{k} {span(r['ms_nccl'])} (local mesh {span(r['ms_local'])})"
                      for k, r in ex.items())
          + "; s=2 iteration " + ", ".join(f"{k} {span(r['ms_nccl'])} (local mesh "
                                           f"{span(r['ms_local'])})" for k, r in pr.items())
          + f"; varlen +x face ({out['varlen']['strategy']}, model "
          f"{out['varlen']['model_schedule']}, {out['varlen']['stream_bytes']} of "
          f"{out['varlen']['capacity_bytes']} bytes) {span(out['varlen']['ms_nccl'])} (local mesh "
          f"{span(out['varlen']['ms_local'])})"
          + f"; all torch.equal to the local mesh at R=1, counts equal; launches {counts}; "
          f"{card}")
    print(json.dumps({"dist": out}))
    return counts


def point_field(torch, spec, dev, rank, radius=BALL_RADIUS, inset=BALL_INSET):
    """A global field that is zero but for a ball of seeded normal values
    inside ``rank``'s block: radius ``radius`` cells, centred ``inset``
    cells inside the block's +x face and cut off at the block, so that
    ``rank``'s +x send region carries a disc and every other region of
    every rank is zero."""
    n = spec.interior
    g = torch.zeros(tuple(p * k for p, k in zip(spec.grid, n)), device=dev)
    lo = [c * k for c, k in zip(spec.coords(rank), n)]
    z, y, x = (torch.arange(k, device=dev) for k in n)
    d2 = ((z[:, None, None] - n[0] // 2) ** 2 + (y[None, :, None] - n[1] // 2) ** 2
          + (x[None, None, :] - (n[2] - inset)) ** 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    vals = torch.randn(n, generator=gen, device=dev)
    g[lo[0]:lo[0] + n[0], lo[1]:lo[1] + n[1], lo[2]:lo[2] + n[2]] = torch.where(
        d2 <= radius * radius, vals, 0.0)
    return g


def region_members(torch, state, cts):
    """Each type's member bytes out of every rank of ``state``, gathered
    by the plain path (no kernel launch)."""
    from repro_torch.kernels import ops

    return [ops.pack(state, ct, 1, "ref", batched=True) for ct in cts]


def codec_ms(torch, timer, codec, members):
    """CUDA-event ms of one exchange's encodes (every region's member
    bytes, all ranks) and of its decodes, L2 flushed first: median of 5."""
    wires = [codec.encode_wire(m) for m in members]
    if codec.name == "rlewire":  # lossless
        for m, w in zip(members, wires):
            if not torch.equal(codec.decode_wire(w, m.shape[1]), m):
                fail("rlewire: a region does not decode to its member bytes")
    enc = timer.ms(lambda: [codec.encode_wire(m) for m in members], reps=5)
    dec = timer.ms(lambda: [codec.decode_wire(w, m.shape[1]) for m, w in zip(members, wires)],
                   reps=5)
    return {"encode_ms": enc, "decode_ms": dec}


def int8_bound(torch, want, recv_cts):
    """Per received float, ``max|block| / 254`` of its quantization block:
    each receive region's true values (``want``) in packed order, in
    blocks of 256, the bound laid back into the region (plain path).  The
    float32 rounding of the scale, the quotient and the product adds at
    most 509 units of 2^-24 of it (``INT8_ULPS``)."""
    from repro_torch.kernels import ops

    bound = torch.zeros_like(want)
    for ct in recv_cts:
        member = ops.pack(want, ct, 1, "ref", batched=True).view(torch.float32)
        nf = member.shape[1]
        blocks = torch.nn.functional.pad(member.abs(), (0, -nf % 256))
        per = blocks.view(member.shape[0], -1, 256).amax(2) / 254
        b = per[:, :, None].expand(-1, -1, 256).reshape(member.shape[0], -1)[:, :nf]
        ops.unpack(bound, (b * (1 + INT8_ULPS)).contiguous().view(torch.uint8), ct, 1, "ref",
                   batched=True)
    return bound


def phase_compress(torch, dev, spec, card):
    """The compressed wire at full width.  Launch counts are zeroed before
    and read after each run through a codec alone (``FixedPolicy``
    ``rlewire`` or ``int8wire``: the 8-rank exchanges, the 27-rank probe,
    ``varlen`` and capacity exchanges); the ``tempi`` exchanges, the
    model's probed mix of codec and kernel regions, the timed repeats and
    the plain-path oracles are not counted.  Every kernel must have run
    in the counted runs.

    * 8 ranks (``spec``, the paper's 2x2x2 grid): ``rlewire`` at capacity
      (``FixedPolicy``, planned ``exact``) under ``uniform``, ``grouped``
      and ``ragged``, on the seeded normal field (every region ships
      stored) and on a point source in rank 0 (regions ship rle), each
      ``torch.equal`` to the ``tempi`` exchange and to the periodic
      field; ``int8wire`` on the normal field: the interior bit-exact,
      every halo value within its block's ``max|block| / 254``, and one
      lossy iteration (exchange + 2 applications) timed beside the plain
      one.
    * 27 ranks on a 3x3x3 grid of 256^3 blocks, a point source in the
      centre rank (13), planned by ``plan_neighbor(probe=rank 13's
      block)`` under ``tempi`` and under ``FixedPolicy("rlewire")``: the
      model's schedule pick, then the ``varlen`` exchange ``torch.equal``
      to the capacity (``grouped``) exchange, to ``tempi`` and to the
      periodic field, with its stream bytes per rank against the
      capacity and the packed extent.
    ms per exchange on the host clock (median of 5, synchronized each);
    the codecs' encode and decode per exchange in CUDA events."""
    import dataclasses

    from repro_torch.comm import INT8_WIRE, RLE_WIRE, Communicator, FixedPolicy, reschedule
    from repro_torch.halo import (DIRECTIONS, HaloPlan, HaloSpec, halo_exchange, make_halo_plan,
                                  make_halo_types, stencil_iterations)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    timer = Timer(torch, dev)
    out = {"card": card, "capacity": {}, "varlen": {}}
    counts = dict.fromkeys(EXCHANGE_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launched = launch_counts()
        for k in counts:  # the pack and unpack kernels
            counts[k] += launched[k]
        return got

    # 8 ranks, capacity wires
    for field in ("normal", "point"):
        g = None if field == "normal" else point_field(torch, spec, dev, 0)
        _, start, want = global_layout(torch, spec, dev, g)
        del g
        tempi = Communicator(device=dev)
        tplan = make_halo_plan(spec, tempi)
        ref = start.clone()
        halo_exchange(ref, spec, tempi, plan=tplan)
        if not torch.equal(ref, want):
            fail(f"[compress] {field}: the tempi exchange differs from the periodic field")
        row = {"tempi_ms": wall_ms(torch, lambda: halo_exchange(ref, spec, tempi, plan=tplan),
                                   5)}
        comm = Communicator(policy=FixedPolicy("rlewire"), device=dev)
        plan = make_halo_plan(spec, comm, schedule_policy="exact")
        members = region_members(torch, start, plan.send_cts)
        modes = [RLE_WIRE.encode_wire(m)[:, 0].tolist() for m in members]
        row["stored_regions"] = sum(v.count(0) for v in modes)
        row["rle_regions"] = sum(v.count(1) for v in modes)
        if field == "normal" and row["rle_regions"]:
            fail(f"[compress] normal field: {row['rle_regions']} regions ship rle, want none")
        if field == "point" and row["rle_regions"] <= row["stored_regions"]:
            fail(f"[compress] point source: {row['rle_regions']} regions ship rle of "
                 f"{row['rle_regions'] + row['stored_regions']}")
        row["wire_bytes"] = plan.wire_bytes
        for sched in ("uniform", "grouped", "ragged"):
            p = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
            local = start.clone()
            counted(lambda: halo_exchange(local, spec, comm, plan=p))
            if not (torch.equal(local, ref) and torch.equal(local, want)):
                fail(f"[compress] rlewire {sched} on the {field} field differs from tempi or "
                     f"the periodic field")
            row[f"rlewire_{sched}_ms"] = wall_ms(
                torch, lambda: halo_exchange(local, spec, comm, plan=p), 5)
            del local
        row.update(codec_ms(torch, timer, RLE_WIRE, members))
        del members
        if field == "normal":
            i8 = Communicator(policy=FixedPolicy("int8wire"), device=dev)
            iplan = make_halo_plan(spec, i8, schedule_policy="exact")
            # one int8 a float and one float32 scale a block of 256 floats
            i8_bytes = tplan.wire_bytes // 4 + 4 * sum(-(-ct.size // 1024)
                                                       for ct in iplan.send_cts)
            if iplan.wire_bytes != i8_bytes:
                fail(f"[compress] int8wire plans {iplan.wire_bytes} wire bytes a rank, "
                     f"want {i8_bytes}")
            local = start.clone()
            counted(lambda: halo_exchange(local, spec, i8, plan=iplan))
            if i8.wire_payload_bytes != iplan.wire_bytes:
                fail(f"[compress] int8wire moved {i8.wire_payload_bytes} bytes a rank")
            if not torch.equal(interior_of(spec, local), interior_of(spec, start)):
                fail("[compress] int8wire changed an interior cell")
            err = (local - want).abs()
            if not bool((err <= int8_bound(torch, want, iplan.recv_cts)).all()):
                fail("[compress] int8wire: a halo value is outside its block's bound")
            i8row = {"wire_bytes": iplan.wire_bytes, "packed_bytes": tplan.wire_bytes,
                     "max_abs_err": err.max().item(),
                     "exchange_ms": wall_ms(torch, lambda: halo_exchange(local, spec, i8,
                                                                         plan=iplan), 5)}
            i8row.update(codec_ms(torch, timer, INT8_WIRE,
                                  region_members(torch, start, iplan.send_cts)))
            lossy, plain = start.clone(), start.clone()

            def lossy_it():
                halo_exchange(lossy, spec, i8, plan=iplan)
                stencil_iterations(lossy, spec, steps=2)

            def plain_it():
                halo_exchange(plain, spec, tempi, plan=tplan)
                stencil_iterations(plain, spec, steps=2)

            lossy_it()
            plain_it()
            torch.cuda.synchronize()
            i8row["iteration_max_abs_diff"] = (interior_of(spec, lossy)
                                               - interior_of(spec, plain)).abs().max().item()
            i8row["iteration_ms"] = wall_ms(torch, lossy_it, 5)
            i8row["plain_iteration_ms"] = wall_ms(torch, plain_it, 5)
            out["int8wire"] = i8row
            del local, lossy, plain, err
        out["capacity"][field] = row
        del start, want, ref
        torch.cuda.empty_cache()

    # 27 ranks, probed on the centre rank, on the varlen schedule
    spec27 = HaloSpec(grid=(3, 3, 3), interior=spec.interior, radius=spec.radius)
    g = point_field(torch, spec27, dev, VARLEN_RANK)
    _, start, want = global_layout(torch, spec27, dev, g)
    del g
    tempi = Communicator(device=dev)
    tplan = make_halo_plan(spec27, tempi)
    packed = sum(ct.size for ct in tplan.send_cts)
    ref = start.clone()
    halo_exchange(ref, spec27, tempi, plan=tplan)
    if not torch.equal(ref, want):
        fail("[compress] 27 ranks: the tempi exchange differs from the periodic field")
    out["varlen_tempi_ms"] = wall_ms(torch, lambda: halo_exchange(ref, spec27, tempi,
                                                                   plan=tplan), 5)
    out["packed_bytes"] = packed
    for policy in ("tempi", "rlewire"):
        comm = Communicator(device=dev, **({} if policy == "tempi"
                                           else {"policy": FixedPolicy(policy)}))
        count = counted if policy == "rlewire" else (lambda fn: fn())
        types = make_halo_types(spec27, comm)
        send = tuple(types[d][0] for d in DIRECTIONS)
        recv = tuple(types[d][1] for d in DIRECTIONS)
        perms = tuple(tuple(spec27.perm(d)) for d in DIRECTIONS)
        t0 = time.perf_counter()
        strats, wire = count(lambda: comm.plan_neighbor(send, perms, probe=start[VARLEN_RANK]))
        row = {"plan_s": time.perf_counter() - t0, "model_schedule": wire.schedule,
               "priced": comm.model.price_wire_schedules(wire),
               "picks": {n: [s.name for s in strats].count(n)
                         for n in sorted({s.name for s in strats})}}
        if not wire.stream_bytes:
            fail(f"[compress] {policy}: the probe annotated no stream lengths")
        if wire.schedule != "varlen":
            print(f"[compress] {policy}: the model picks {wire.schedule}, not varlen; "
                  f"running reschedule(plan, 'varlen')")
        plan = HaloPlan(spec27, send, recv, perms, strats, reschedule(wire, "varlen"))
        cap = dataclasses.replace(plan, wire=reschedule(wire, "grouped"))
        stream = sum(wire.stream_bytes)
        row.update(stream_bytes=stream, capacity_bytes=wire.wire_bytes,
                   ratio=wire.stream_ratio, stream_over_packed=stream / packed)
        if stream >= packed:
            fail(f"[compress] {policy}: {stream} stream bytes a rank, not below the packed "
                 f"extent {packed}")
        local = start.clone()
        before = comm.wire_payload_bytes
        count(lambda: halo_exchange(local, spec27, comm, plan=plan))
        if comm.wire_payload_bytes - before != stream:
            fail(f"[compress] {policy}: varlen moved {comm.wire_payload_bytes - before} bytes "
                 f"a rank, its streams hold {stream}")
        capx = start.clone()
        count(lambda: halo_exchange(capx, spec27, comm, plan=cap))
        if not (torch.equal(local, capx) and torch.equal(local, ref)
                and torch.equal(local, want)):
            fail(f"[compress] {policy}: the varlen exchange differs from the capacity run, "
                 f"tempi or the periodic field")
        del capx
        row["varlen_ms"] = wall_ms(torch, lambda: halo_exchange(local, spec27, comm,
                                                                plan=plan), 5)
        row["capacity_ms"] = wall_ms(torch, lambda: halo_exchange(local, spec27, comm,
                                                                  plan=cap), 5)
        rle = [ct for s, ct in zip(strats, send) if s.name == "rlewire"]
        row.update(codec_ms(torch, timer, RLE_WIRE, region_members(torch, start, rle)))
        row["compress_counters"] = [comm.compress_exchanges, comm.compress_capacity_bytes,
                                    comm.compress_stream_bytes]
        out["varlen"][policy] = row
        del local
    del start, want, ref, timer
    torch.cuda.empty_cache()
    zero = [k for k, v in counts.items() if v == 0]
    if zero:
        fail(f"kernels never launched through a codec's exchange: {zero}")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    cap, v = out["capacity"], out["varlen"]
    print(f"[compress] 8 ranks rlewire at capacity, ms/exchange: "
          + "; ".join(f"{f} field ({r['stored_regions']} stored, {r['rle_regions']} rle "
                      f"regions) uniform {r['rlewire_uniform_ms']:.3f}, grouped "
                      f"{r['rlewire_grouped_ms']:.3f}, ragged {r['rlewire_ragged_ms']:.3f} "
                      f"against tempi {r['tempi_ms']:.3f}, codec {r['encode_ms']:.3f} + "
                      f"{r['decode_ms']:.3f}" for f, r in cap.items())
          + f"; int8wire {out['int8wire']['wire_bytes']} wire bytes a rank, "
          f"{out['int8wire']['exchange_ms']:.3f} ms, iteration "
          f"{out['int8wire']['iteration_ms']:.3f} against {out['int8wire']['plain_iteration_ms']:.3f}"
          f"; 27 ranks varlen: " + "; ".join(
              f"{p} (model {r['model_schedule']}) {r['stream_bytes']} of {packed} packed bytes "
              f"a rank, {r['varlen_ms']:.3f} ms against capacity {r['capacity_ms']:.3f} and "
              f"tempi {out['varlen_tempi_ms']:.3f}" for p, r in v.items())
          + f"; all torch.equal; launches through the codecs {counts}; phase "
          f"{out['phase_s']:.1f} s; {card}")
    print(json.dumps({"compress": out}))
    return counts


def phase_tiered(torch, dev, spec, card, measured):
    """The two-level machine at full width (``spec``'s 256^3 blocks,
    radius 2, float32).  On one card both tiers are the same memory, so
    this shows that the ``tiered`` schedule is right and counts its
    messages and bytes; whether coalescing pays is the model's to say.

    * 8 ranks, ``Topology.blocked(8, 4)`` (one z slab a node), and 27
      ranks, ``Topology.blocked(27, 9)``: ``tiered`` and ``grouped``
      exchanges of the model-planned layout, each ``torch.equal`` to the
      other and to the periodic field; the transport's ops and bytes equal
      the plan's, and at full width the fixed figures of ``TIERED_EXPECT``
      (7 ops, 4,276,480 bytes a rank, 1 against 4 slow-tier messages at 8
      ranks; 26, 4,276,672, 2 against 18 at 27).  Launch counts are zeroed before and
      read after the ``tiered`` runs alone; every kernel must run there.
      ms per exchange on the host clock (median of 5 synchronized calls),
      ``tiered``, ``grouped``, ``grouped``, ``tiered``.
    * ``measure_link_class_tables`` for ``blocked(8, 4)`` on the card, its
      two tables and fits.
    * The model's picks at 8 ranks, planned only: under the card's
      tables (``measured``, the [measure] phase's calibration, no link
      tables) it must not pick ``tiered``; its pick and prices with the
      measured link-class tables and under ``synthetic_two_tier``; the
      simulated-scale ladder from 8 to 3072 ranks at 8 a node on the
      card's tables made two-tier (pure host).
    * ``replan_on_remesh`` from ``blocked(8, 4)`` to ``blocked(8, 2)``: the
      decision rows it prunes, then a ``tiered`` exchange planned under
      the new topology, ``torch.equal`` to the periodic field."""
    import dataclasses

    from repro_torch.comm import (Communicator, PerfModel, Topology, reschedule, scale_ladder,
                                  synthetic_two_tier)
    from repro_torch.halo import HaloSpec, halo_exchange, make_halo_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.measure import (DecisionCache, fit_latency_bandwidth,
                                     measure_link_class_tables)
    from repro_torch.train import replan_on_remesh

    t_phase = time.perf_counter()
    out = {"card": card, "grids": {}}
    counts = dict.fromkeys(EXCHANGE_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launched = launch_counts()
        for k in counts:  # the pack and unpack kernels
            counts[k] += launched[k]

    def exchange(comm, s, x, plan, sched, count=False):
        """One exchange of ``plan`` rescheduled to ``sched``; returns the
        plan and the transport's ops and bytes for it."""
        plan = dataclasses.replace(plan, wire=reschedule(plan.wire, sched))
        ops, nbytes = comm.wire_ops, comm.wire_payload_bytes
        if count:
            counted(lambda: halo_exchange(x, s, comm, plan=plan))
        else:
            halo_exchange(x, s, comm, plan=plan)
        torch.cuda.synchronize()
        return plan, comm.wire_ops - ops, comm.wire_payload_bytes - nbytes

    for grid, rpn in TIERED_GRIDS:
        s = HaloSpec(grid=grid, interior=spec.interior, radius=spec.radius)
        topo = Topology.blocked(s.nranks, rpn)
        _, start, want = global_layout(torch, s, dev)
        comm = Communicator(device=dev, topology=topo)
        plan = make_halo_plan(s, comm)
        row = {"ranks": s.nranks, "ranks_per_node": rpn, "topology": topo.fingerprint,
               "model_schedule": plan.wire.schedule, "link_classes": plan.wire.link_classes,
               "tier_bundles": plan.wire.tier_bundles}
        xs = {}
        for sched in ("grouped", "tiered"):
            x = start.clone()
            p, ops, nbytes = exchange(comm, s, x, plan, sched, count=sched == "tiered")
            if not torch.equal(x, want):
                fail(f"[tiered] {s.nranks} ranks, {sched}: the exchange differs from the "
                     f"periodic field")
            if (ops, nbytes) != (p.wire.wire_ops, p.wire.issued_bytes):
                fail(f"[tiered] {s.nranks} ranks, {sched}: {ops} ops and {nbytes} bytes a "
                     f"rank, the plan holds {p.wire.wire_ops} and {p.wire.issued_bytes}")
            row[sched] = {"wire_ops": ops, "bytes": nbytes,
                          "inter_messages": p.wire.inter_messages,
                          "correction_bytes": p.wire.correction_bytes}
            xs[sched] = (x, p)
        if not torch.equal(xs["tiered"][0], xs["grouped"][0]):
            fail(f"[tiered] {s.nranks} ranks: tiered differs from grouped")
        t, g = row["tiered"], row["grouped"]
        if t["wire_ops"] != plan.wire.ngroups or t["inter_messages"] != len(
                plan.wire.tier_bundles) or g["inter_messages"] != plan.wire.link_classes.count(
                "inter"):
            fail(f"[tiered] {s.nranks} ranks: ops or slow-tier messages off: {row}")
        if s.interior == (256, 256, 256) and s.radius == 2:
            ops, inter_t, inter_g, nbytes = TIERED_EXPECT[s.nranks]
            if (t["wire_ops"], t["inter_messages"], g["inter_messages"], t["bytes"]) != (
                    ops, inter_t, inter_g, nbytes):
                fail(f"[tiered] {s.nranks} ranks: want {ops} ops, {nbytes} bytes a rank, "
                     f"{inter_t} against {inter_g} slow-tier messages; got {row}")
        ms = {"tiered": [], "grouped": []}
        for sched in ("tiered", "grouped", "grouped", "tiered"):
            x, p = xs[sched]
            ms[sched].append(wall_ms(torch, lambda: halo_exchange(x, s, comm, plan=p), 5))
        row["ms"] = ms
        if s.nranks == 8:
            # a reshape: the pins recorded under blocked(8, 4) are pruned,
            # and the exchange is planned again under blocked(8, 2)
            dc = DecisionCache()
            rcomm = Communicator(device=dev, params=synthetic_two_tier(measured), decisions=dc,
                                 topology=topo)
            old = make_halo_plan(s, rcomm)
            rows_before = len(dc.log)
            new_topo = Topology.blocked(8, 2)
            report = replan_on_remesh(rcomm, new_topo)
            if report.npruned < 1 or rcomm.model.topology != new_topo:
                fail(f"[tiered] replan pruned nothing: {report}")
            new = make_halo_plan(s, rcomm)
            if new.wire.fingerprint == old.wire.fingerprint:
                fail("[tiered] the plan did not change with the topology")
            x = start.clone()
            p, ops, nbytes = exchange(rcomm, s, x, new, "tiered", count=True)
            if not torch.equal(x, want) or (ops, nbytes) != (p.wire.wire_ops,
                                                            p.wire.issued_bytes):
                fail("[tiered] the exchange planned after the replan differs from the "
                     "periodic field or from its plan's counts")
            out["replan"] = {"old": topo.fingerprint, "new": new_topo.fingerprint,
                             "rows_before": rows_before, "pruned": list(report.pruned),
                             "rows_after": len(dc.log), "old_schedule": old.wire.schedule,
                             "new_schedule": new.wire.schedule,
                             "new_link_classes": new.wire.link_classes,
                             "new_tier_bundles": new.wire.tier_bundles,
                             "tiered_bytes": nbytes, "tiered_ops": ops}
            del x
        out["grids"][f"{s.nranks}"] = row
        del start, want, xs
        torch.cuda.empty_cache()
    zero = [k for k, v in counts.items() if v == 0]
    if zero:
        fail(f"kernels never launched through a tiered exchange: {zero}")
    out["launches"] = counts

    # the link-class sweep on the card, and the model's picks at 8 ranks
    topo = Topology.blocked(8, 4)
    t0 = time.perf_counter()
    tables = measure_link_class_tables(topo, iters=20, device=dev)
    out["link_sweep_s"] = time.perf_counter() - t0
    fits = {cls: fit_latency_bandwidth(rows) for cls, rows in tables.items()}
    if set(tables) != {"intra", "inter"}:
        fail(f"[tiered] link-class sweep measured {sorted(tables)}")
    out["link_tables"], out["link_fits"] = tables, fits
    picks = {}
    for name, params in (("card", measured),
                         ("card_link_tables", dataclasses.replace(
                             measured, link_tables=tables, link_fits=fits)),
                         ("card_two_tier", synthetic_two_tier(measured))):
        comm = Communicator(device=dev, params=params, topology=topo)
        plan = make_halo_plan(spec, comm)
        picks[name] = {"schedule": plan.wire.schedule,
                       "priced": comm.model.price_wire_schedules(plan.wire)}
    if picks["card"]["schedule"] not in ("grouped", "uniform"):
        fail(f"[tiered] under the card's tables the model picks {picks['card']['schedule']}")
    out["picks"] = picks
    ladder = scale_ladder(PerfModel(synthetic_two_tier(measured)), SCALE_RANKS, 8,
                          interior=spec.interior, radius=spec.radius, pin=False)
    out["ladder"] = [{"ranks": e.ranks, "nodes": e.nodes, "grid": e.grid,
                      "schedule": e.schedule, "costs": e.costs,
                      "inter_messages": e.inter_messages, "wire_bytes": e.wire_bytes,
                      "correction_bytes": e.correction_bytes} for e in ladder]
    out["phase_s"] = time.perf_counter() - t_phase

    def span(v):
        return f"{min(v):.3f}-{max(v):.3f}"

    print("[tiered] " + "; ".join(
        f"{n} ranks ({r['ranks_per_node']} a node): tiered {r['tiered']['wire_ops']} ops, "
        f"{r['tiered']['bytes']} bytes a rank, {r['tiered']['inter_messages']} slow-tier "
        f"messages against grouped's {r['grouped']['inter_messages']}, ms tiered "
        f"{span(r['ms']['tiered'])} grouped {span(r['ms']['grouped'])} (one card: both tiers "
        f"are HBM)" for n, r in out["grids"].items())
        + f"; all torch.equal to grouped and the periodic field; link sweep fits "
        + ", ".join(f"{c} {f[0] if f[0] is None else f'{f[0] * 1e6:.2f} us'} + n / "
                    f"{f[1] if f[1] is None else f'{f[1] / 1e9:.1f} GB/s'}"
                    for c, f in fits.items())
        + "; picks " + ", ".join(f"{k} {v['schedule']}" for k, v in picks.items())
        + "; ladder " + ", ".join(f"{e['ranks']}:{e['schedule']}" for e in out["ladder"])
        + f"; replan pruned {len(out['replan']['pruned'])} rows; launches {counts}; phase "
        f"{out['phase_s']:.1f} s; {card}")
    print(json.dumps({"tiered": out}))
    return counts


def phase_obs(torch, dev, spec, card, program_window_ms):
    """The observed main path at full width (8 ranks, 256^3 each, the
    ``auto`` program): ``production_communicator(telemetry=True,
    tracer=True)`` over a fresh store in the ignored ``build/obs``.

    * one warm-up iteration with nothing attached (a plan's first use
      pays its setup), then ``OBS_ITERS`` traced, telemetered iterations,
      each ``torch.equal`` to the same iteration untraced, with the four
      kernels' launches of each traced exchange equal to the untraced
      one's (counts zeroed and read around every iteration);
    * the span tree through ``repro_torch.obs.export.validate`` plus one
      ``exchange`` (with ``pack``/``wire``/``unpack``) and ``steps``
      ``stencil`` spans an iteration, every child inside its parent (a
      ``wire_class`` span inside the exchange that issued it);
    * the Chrome trace, ``telemetry.json`` and ``metrics.json`` saved and
      loaded back: equal to what the process holds;
    * ms per traced and untraced iteration and per span phase, the traced
      ``stencil`` span against CUDA-event ms of the same windows and the
      ``[program]`` phase's, the observed/predicted ratio per phase, the
      probe's host cost (``observe()``, ``attribute_program_iteration()``)
      against an iteration beside the reference's 2% budget;
    * ``DriftDetector().audit`` over the decisions, the params in use, the
      telemetry and the phase aggregates; ``remeasure_term`` of the worst
      term (reduced sweep, on the card); then a communicator over the
      re-measured params and the saved decisions (the depth pinned),
      ``OBS_ITERS`` more traced iterations (``torch.equal`` again) and a
      second audit.  The flagged terms of both audits are printed."""
    import shutil

    from repro_torch.comm import H100_ANALYTIC, Communicator
    from repro_torch.fleet import (DEFAULT_MIN_SAMPLES, DriftDetector, ExchangeTelemetry,
                                   predict_program_phases, remeasure_term)
    from repro_torch.halo import build_halo_program
    from repro_torch.halo.stencil import _window_of, op_sequence
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import stencil_window_update
    from repro_torch.measure import production_communicator
    from repro_torch.obs import (MetricsRegistry, Tracer, aggregate_events,
                                 attribute_program_iteration, default_metrics,
                                 load_chrome_trace, save_chrome_trace, to_chrome_trace,
                                 validate)

    if OBS_ITERS < DEFAULT_MIN_SAMPLES:
        fail(f"{OBS_ITERS} traced iterations < the audit's {DEFAULT_MIN_SAMPLES} samples")
    store = os.path.join(HERE, "build", "obs")
    shutil.rmtree(store, ignore_errors=True)
    grid, interior = spec.grid, spec.interior
    comm, save = production_communicator(store, params=H100_ANALYTIC, telemetry=True,
                                         tracer=True, device=dev)
    tracer = comm.tracer
    prog = build_halo_program(grid, interior, comm, steps="auto")
    plain = Communicator(device=dev)
    plain_prog = build_halo_program(grid, interior, plain, steps=prog.steps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(tuple(p * k for p, k in zip(grid, interior)), generator=gen, device=dev)
    x = rank_blocks(torch, prog.spec, g)
    y = x.clone()
    del g
    out = {"card": card, "ranks": spec.nranks, "interior": list(interior),
           "steps": prog.steps, "radius": list(prog.spec.radii),
           "schedule": prog.plan.wire.schedule, "iterations": OBS_ITERS}
    total = dict.fromkeys(KERNEL_INFO, 0)

    def observed_run(c, p, tr, n, what):
        """A warm-up iteration with nothing attached to ``c`` (a plan's
        first use pays its setup, which at ``n`` samples would set the
        trace's means), then ``n`` iterations of ``p`` on ``c`` (traced)
        beside ``plain_prog`` (untraced) from the same state: equal after
        each, and so are the launches; returns ms per iteration (host
        clock, synchronized)."""
        ms = {"traced": [], "untraced": []}
        probes = (c.telemetry, c.tracer)
        for i in range(-1, n):
            c.telemetry, c.tracer = (None, None) if i < 0 else probes
            launches = {}
            for key, cc, pp, state in (("untraced", plain, plain_prog, y),
                                       ("traced", c, p, x)):
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                pp.iteration(state, cc)
                torch.cuda.synchronize()
                t = (time.perf_counter() - t0) * 1e3
                if i < 0:
                    ms[f"warmup_{key}"] = t
                else:
                    ms[key].append(t)
                launches[key] = launch_counts()
            if launches["traced"] != launches["untraced"]:
                fail(f"{what} iteration {i}: {launches['traced']} launches traced, "
                     f"{launches['untraced']} untraced")
            if not torch.equal(x, y):
                fail(f"{what} iteration {i}: {(x != y).sum().item()} cells differ from the "
                     f"untraced iteration")
            for k in total:
                total[k] += launches["traced"][k]
        iters = [s for s in tr.spans if s.name == "program_iteration"]
        if len(iters) != n:
            fail(f"{what}: {len(iters)} program_iteration spans for {n} iterations")
        out.setdefault("launches_per_exchange", launches["traced"])
        # the first iteration's spans apart: a cold start shows there
        first = {s.span_id for s in tr.spans if s.span_id >= iters[0].span_id
                 and s.span_id < (iters[1].span_id if n > 1 else 1 << 62)}
        ms["first_iteration_span_ms"] = {}
        for s in tr.spans:
            if s.span_id in first and s.name != "wire_class":
                ms["first_iteration_span_ms"][s.name] = (
                    ms["first_iteration_span_ms"].get(s.name, 0.0) + s.duration * 1e3)
        return ms

    def check_tree(tr, what):
        errors = validate(to_chrome_trace(tr))
        if errors:
            fail(f"{what}: the trace is invalid: {errors[:3]}")
        by_id = {s.span_id: s for s in tr.spans}
        kids = {}
        for s in tr.spans:
            kids.setdefault(s.parent_id, []).append(s)
            p = by_id.get(s.parent_id)
            if p is not None and s.name == "wire_class":
                p = by_id[p.parent_id]  # timed from the wire's issue
            if p is not None and not (p.start <= s.start
                                      and s.start + s.duration <= p.start + p.duration):
                fail(f"{what}: a {s.name} span lies outside its {p.name} span")
        for it in (s for s in tr.spans if s.name == "program_iteration"):
            names = [c.name for c in kids.get(it.span_id, ())]
            ex = [c for c in kids.get(it.span_id, ()) if c.name == "exchange"]
            apps = sum(c.attrs.get("applications", 1) for c in kids.get(it.span_id, ())
                       if c.name == "stencil")  # a fused pair's span holds two
            if len(ex) != 1 or apps != prog.applications:
                fail(f"{what}: an iteration holds {names}")
            phases = [c.name for c in kids.get(ex[0].span_id, ())]
            if phases != ["pack", "wire", "unpack"]:
                fail(f"{what}: an exchange holds {phases}")
        return {n: sum(s.name == n for s in tr.spans)
                for n in ("plan", "program_iteration", "exchange", "pack", "wire", "unpack",
                          "wire_class", "stencil")}

    def phase_stats(tr):
        ms = {}
        for name in ("program_iteration", "exchange", "pack", "wire", "unpack", "stencil"):
            d = [s.duration * 1e3 for s in tr.spans if s.name == name]
            ms[name] = {"mean": statistics.fmean(d), "min": min(d), "max": max(d)}
        ratios = {}
        for fp, rec in tr.phase_aggregates().items():
            for ph, r in rec.items():
                if r["predicted"] > 0:
                    ratios[ph] = r["observed"] / r["predicted"]
        return ms, ratios

    def audit(c, params, tr):
        rep = DriftDetector().audit(c.model.decisions, params, telemetry=c.telemetry,
                                    trace=tr.phase_aggregates(), system=card)
        flagged = [{"fingerprint": f.fingerprint, "strategy": f.strategy, "term": f.term,
                    "ratio": f.ratio, "source": f.source, "samples": f.samples,
                    "observed_ratio": f.observed_ratio, "phase_ratios": f.phase_ratios}
                   for f in rep.drifted]
        return rep, {"findings": len(rep.findings), "drifted": rep.drifted_count,
                     "drifted_terms": list(rep.drifted_terms), "flagged": flagged}

    # -- the traced iterations, the tree, the phases
    ms = observed_run(comm, prog, tracer, OBS_ITERS, "obs")
    out["ms_per_traced_iteration"] = ms["traced"]
    out["ms_per_untraced_iteration"] = ms["untraced"]
    out["first_iteration_span_ms"] = ms["first_iteration_span_ms"]
    out["warmup_ms"] = {k: ms[f"warmup_{k}"] for k in ("untraced", "traced")}
    out["spans"] = check_tree(tracer, "obs")
    out["span_ms"], out["obs_over_pred"] = phase_stats(tracer)
    phases = predict_program_phases(prog, comm.model)
    out["pred_ms"] = {k: v * 1e3 for k, v in phases.items()}

    # the traced stencil span against CUDA-event ms of the same windows
    timer = Timer(torch, dev)
    valid, event_ms = prog.spec.radii, []
    for o in op_sequence(prog.ops, prog.steps):
        origin, shape = _window_of(prog.spec, valid, o)
        event_ms.append(timer.ms(
            lambda: stencil_window_update(x, o.offsets, o.weight, origin, shape), reps=5))
        valid = tuple(v - r for v, r in zip(valid, o.radii))
    del timer
    out["stencil_ms"] = {"span_mean": out["span_ms"]["stencil"]["mean"],
                         "cuda_event_per_application": event_ms,
                         "program_phase_first_application_window": program_window_ms}

    # the probe's host cost against an iteration
    probe_tel, probe_tr = ExchangeTelemetry(), Tracer()
    classes = comm.model.price_class_completions(prog.plan.wire)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        probe_tel.observe("probe", 1e-3)
    observe_us = (time.perf_counter() - t0) * 1e6 / n
    n = 500
    t0 = time.perf_counter()
    for i in range(n):
        attribute_program_iteration(probe_tr, prog, t0, 1e-3, phases, i, classes)
    attribute_us = (time.perf_counter() - t0) * 1e6 / n
    iter_us = statistics.median(ms["untraced"]) * 1e3
    out["probe"] = {"observe_us": observe_us, "attribute_us": attribute_us,
                    "untraced_iteration_us": iter_us,
                    "observe_share": observe_us / iter_us,
                    "attribute_share": attribute_us / iter_us, "budget_share": 0.02}

    # export and reload
    trace_path = save_chrome_trace(tracer, os.path.join(store, "trace.json"))
    save()
    trace = load_chrome_trace(trace_path)
    if validate(trace):
        fail("the saved trace does not validate")
    live, loaded = tracer.phase_aggregates(), aggregate_events(trace)
    if live.keys() != loaded.keys() or any(
            live[fp][ph]["count"] != loaded[fp][ph]["count"]
            or not math.isclose(live[fp][ph]["observed"], loaded[fp][ph]["observed"],
                                rel_tol=1e-9)
            for fp in live for ph in live[fp]):
        fail("the saved trace's phase aggregates differ from the tracer's")
    tel_back = ExchangeTelemetry.load(os.path.join(store, "telemetry.json"))
    if tel_back.to_json() != comm.telemetry.to_json():
        fail("telemetry.json does not round-trip")
    metrics_back = MetricsRegistry.load(os.path.join(store, "metrics.json"))
    if metrics_back.snapshot() != default_metrics().snapshot():
        fail("metrics.json does not round-trip")
    if metrics_back.counter("comm.exchanges") != comm.wire_ops:
        fail("metrics.json holds another exchange count than the communicator")
    out["files"] = {name: os.path.getsize(os.path.join(store, name))
                    for name in ("trace.json", "telemetry.json", "metrics.json",
                                 "decisions.json")}
    out["telemetry_keys"] = len(comm.telemetry)

    # the drift audit, the worst term re-measured, the audit again
    rep, out["drift_before"] = audit(comm, H100_ANALYTIC, tracer)
    worst, worst_r = "", 1.0
    for f in rep.findings:
        for term, r in ([(f.term, f.ratio)] if f.term else list(f.phase_ratios.items())):
            if abs(math.log(r)) > abs(math.log(worst_r)):
                worst, worst_r = term, r
    if not worst:
        fail("the audit found no term to re-measure")
    t0 = time.perf_counter()
    fresh = remeasure_term(H100_ANALYTIC, worst, reduced=True, device=dev)
    out["remeasured"] = {"term": worst, "ratio_before": worst_r,
                         "seconds": time.perf_counter() - t0}
    tracer2 = Tracer()
    comm2, _ = production_communicator(store, params=fresh, telemetry=ExchangeTelemetry(),
                                       tracer=tracer2, device=dev)
    prog2 = build_halo_program(grid, interior, comm2, steps="auto")
    if not prog2.pinned or prog2.steps != prog.steps:
        fail(f"the re-measured communicator built s={prog2.steps} (pinned {prog2.pinned}); "
             f"the saved decision is s={prog.steps}")
    ms2 = observed_run(comm2, prog2, tracer2, OBS_ITERS, "obs after re-measurement")
    check_tree(tracer2, "obs after re-measurement")
    out["ms_per_traced_iteration_after"] = ms2["traced"]
    out["ms_per_untraced_iteration_after"] = ms2["untraced"]
    out["first_iteration_span_ms_after"] = ms2["first_iteration_span_ms"]
    out["warmup_ms_after"] = {k: ms2[f"warmup_{k}"] for k in ("untraced", "traced")}
    out["span_ms_after"], out["obs_over_pred_after"] = phase_stats(tracer2)
    _, out["drift_after"] = audit(comm2, fresh, tracer2)
    del x, y
    torch.cuda.empty_cache()
    zero = [k for k, v in total.items() if v == 0]
    if zero:
        fail(f"kernels never launched in the obs phase: {zero}")
    out["launches"] = total
    before, after = out["drift_before"], out["drift_after"]
    print(f"[obs] {2 * OBS_ITERS} traced s={prog.steps} iterations torch.equal to the untraced "
          f"ones with equal launches; {statistics.median(ms['traced']):.3f} ms traced against "
          f"{statistics.median(ms['untraced']):.3f} untraced; stencil obs/pred "
          f"{out['obs_over_pred'].get('stencil', float('nan')):.1f}; drift flagged "
          f"{before['drifted_terms']} -> re-measured {worst} -> {after['drifted_terms']}; "
          f"probe {100 * (observe_us + attribute_us) / iter_us:.4f}% of an iteration; {card}")
    print(json.dumps({"obs": out}))
    return total


def smoother_oracle(torch, dev, R, interior, ops, applications, seed=0):
    """The smoother's global field (R*nz, ny, nx) after ``applications``
    applications of the cycle ``ops``, from the smoother's own seed, by
    ``torch.roll`` on the periodic field."""
    import numpy as np

    nz, ny, nx = interior
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(R, nz, ny, nx)).astype(
        np.float32)).to(dev).reshape(R * nz, ny, nx)
    for i in range(applications):
        g = stencil_roll(torch, g, ops[i % len(ops)])
    return g


def phase_smoother(torch, dev, card, measured):
    """The smoother workload (``repro_torch.launch.smoother``) at the
    paper's width: 8 ranks of 256^3 on the grid (8, 1, 1), the
    ``predictor-corrector`` cycle, ``halo_steps="auto"``, through
    ``production_communicator`` over a temporary store with the
    ``[measure]`` phase's tables.

    * the first run records a ``program/s=N`` row; its field after one
      iteration agrees with the ``torch.roll`` oracle of the cycle to
      rtol = atol = 1e-5;
    * a second communicator over the same store pins the row, and its run
      is ``torch.equal`` to the first with a bit-equal checksum;
    * ``SMOOTHER_TIMED`` synchronized iterations on the host clock;
    * the telemetered and traced variant, one iteration: one attributed
      ``program_iteration`` tree and one telemetry sample;
    * the serve deployment's default: ``smooth``, 8^3 a rank, 1 iteration.

    Launch counts are zeroed before and read after every run; the phase
    fails if no kernel launched.  Returns the phase's launches."""
    import tempfile

    from repro_torch.halo import make_program_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.smoother import run_smoother, smoother_cycle
    from repro_torch.measure import production_communicator

    R, interior, cycle = SMOOTHER_RANKS, SMOOTHER_INTERIOR, "predictor-corrector"
    out = {"card": card, "ranks": R, "interior": list(interior), "cycle": cycle}
    total = dict.fromkeys(KERNEL_INFO, 0)
    by_run = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launch_counts()
        for k in total:
            total[k] += got[k]
        by_run[name] = got
        out[f"{name}_s"] = secs
        return result

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_smoother_") as store:
        comm, save = production_communicator(store, params=measured, device=dev,
                                             halo_steps="auto")
        rep = counted("record", lambda: run_smoother(comm, iters=1, interior=interior,
                                                     cycle=cycle, keep_state=True))
        prog = rep.program
        if not rep.decision_recorded or prog.pinned:
            fail(f"smoother: the first run recorded {rep.decision_recorded}, pinned "
                 f"{prog.pinned}")
        if not math.isfinite(rep.checksum):
            fail(f"smoother: checksum {rep.checksum}")
        checksum, out["summary"] = rep.checksum, rep.summary
        print(rep.summary)
        save()
        comm2, _ = production_communicator(store, params=measured, device=dev,
                                           halo_steps="auto")
        rep2 = counted("pinned", lambda: run_smoother(comm2, iters=1, interior=interior,
                                                      cycle=cycle, keep_state=True))
        if not rep2.program.pinned or rep2.program.steps != prog.steps:
            fail(f"smoother: the rerun built s={rep2.program.steps} (pinned "
                 f"{rep2.program.pinned}); recorded s={prog.steps}")
        if rep2.checksum != rep.checksum or not torch.equal(rep2.state, rep.state):
            fail(f"smoother: the pinned rerun's checksum {rep2.checksum!r} (or field) differs "
                 f"from {rep.checksum!r}")
        del rep2
        x = rep.state
        nz, ny, nx = interior
        rz, ry, rx = prog.spec.radii
        got = x[:, rz:rz + nz, ry:ry + ny, rx:rx + nx].reshape(R * nz, ny, nx)
        want = smoother_oracle(torch, dev, R, interior, smoother_cycle(cycle), prog.applications)
        if not torch.isfinite(got).all():
            fail("smoother: non-finite values after one iteration")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        out["max_abs_err"] = (got - want).abs().max().item()
        del got, want
        step = make_program_step(prog, comm, device=dev)
        out["ms_per_iteration"] = counted(
            "timed", lambda: wall_ms(torch, lambda: step(x), SMOOTHER_TIMED))
        del x, rep
        torch.cuda.empty_cache()

        comm3, _ = production_communicator(store, params=measured, device=dev, telemetry=True,
                                           tracer=True, halo_steps="auto")
        rep3 = counted("traced", lambda: run_smoother(comm3, iters=1, interior=interior,
                                                      cycle=cycle))
        iters = [s for s in comm3.tracer.spans if s.name == "program_iteration"]
        agg = comm3.telemetry.get(rep3.program.fingerprint)
        if len(iters) != 1 or not iters[0].attrs.get("attributed") or agg is None \
                or agg.count != 1:
            fail(f"smoother: traced run left {len(iters)} attributed iterations, telemetry "
                 f"{agg and agg.count}")
        if not rep3.program.pinned or rep3.checksum != checksum:
            fail(f"smoother: the traced run (pinned {rep3.program.pinned}) ended at checksum "
                 f"{rep3.checksum!r}, the first run at {checksum!r}")
        out["traced_ms_per_iteration"] = agg.mean * 1e3
        out["traced_obs_over_pred"] = agg.ratio
        torch.cuda.empty_cache()

        deploy = counted("serve_default", lambda: run_smoother(comm, iters=1, cycle="smooth"))
        if not math.isfinite(deploy.checksum) or not deploy.decision_recorded:
            fail(f"smoother: the serve default ran to {deploy.summary}")
    out.update(steps=prog.steps, radius=list(prog.spec.radii),
               schedule=prog.plan.wire.schedule, issued_bytes=prog.plan.wire.issued_bytes,
               applications=prog.applications, candidates={
                   e.steps: e.per_step for e in prog.candidates},
               serve_default_summary=deploy.summary,
               launches=total, launches_by_run=by_run, phase_s=time.perf_counter() - t_phase)
    if not any(total.values()):
        fail(f"smoother: no kernel launched: {total}")
    unused = [k for k, v in total.items() if v == 0]
    out["kernels_not_launched"] = unused
    print(f"[smoother] 8 ranks x 256^3 {cycle}: auto picked s={prog.steps} (radius "
          f"{tuple(prog.spec.radii)}, {prog.plan.wire.schedule}, "
          f"{prog.plan.wire.issued_bytes} bytes/rank), recorded then pinned bit-equal, roll "
          f"oracle max |err| {out['max_abs_err']:.3e}; {out['ms_per_iteration']:.3f} ms/iteration "
          f"synchronized, traced {out['traced_ms_per_iteration']:.3f}; serve default "
          f"s={deploy.program.steps}; launches {total}"
          + (f" (not launched: {unused})" if unused else "") + f"; {card}")
    print(json.dumps({"smoother": out}))
    return total


def decode_kernel_share(torch, fn, top=6):
    """The device kernels of one call of ``fn`` under ``torch.profiler``,
    grouped by name: the ``top`` by device µs, with their count, and the
    total device µs and kernel count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernels_by_name(torch, prof, top)


def kernels_by_name(torch, prof, top):
    """A profile's device kernels grouped by name: the ``top`` by device
    µs, with their count, and the total device µs and kernel count."""
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_us": sum(us for us, _ in by_name.values()),
            "kernels": sum(n for _, n in by_name.values()),
            "top": [{"name": k[:80], "us": us, "count": n} for k, (us, n) in rows[:top]]}


def phase_serve(torch, dev, card, measured):
    """The serve path at the full width of qwen2-0.5b (24 layers, d_model
    896, 14 heads, 2 KV heads, d_ff 4864, vocab 151,936, bf16, tied
    embeddings; weights drawn on the card from seed 0) with the serve
    serve CLI's defaults: batch 4, 8 requests of 16 new tokens, max_len 128,
    the smoother (``smooth``, 8^3 a rank) at startup through a
    production communicator.

    Checks: 8 of 8 requests served with 16 tokens each; a second loop
    from the same seed gives the same tokens, with every logit finite;
    teacher-forced, the decode logits at each position agree with the
    model's ``forward`` over the same tokens to ``SERVE_REL`` of the
    largest logit.  Measures tokens/s of the loop, ms per decode step
    (median of ``SERVE_TIMED_STEPS``, synchronized each), the device's
    idle share over decode steps, ``max_memory_allocated``, and the
    step's bound (weight and cache bytes over 3.35 TB/s).  The decode
    path launches no pack/unpack kernel; the startup smoother's launches
    are returned."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import ServeLoop, make_requests
    from repro_torch.launch.smoother import run_smoother
    from repro_torch.measure import production_communicator

    cfg = get_config(SERVE_ARCH)
    B, nreq, max_new, max_len = (SERVE_DEFAULTS[k] for k in ("batch", "requests", "max_new",
                                                            "max_len"))
    out = {"card": card, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": B, "requests": nreq,
           "max_new": max_new, "max_len": max_len}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as store:
        comm, _ = production_communicator(store, params=measured, device=dev,
                                          halo_steps="auto")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        report = run_smoother(comm, iters=1, cycle="smooth")
        torch.cuda.synchronize()
        out["smoother_s"] = time.perf_counter() - t0
        smoother_launches = launch_counts()
        out["smoother_summary"] = report.summary
        print(report.summary)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loop = ServeLoop(cfg, B, max_len, comm=comm, device=dev, seed=SEED)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        params = sum(p.numel() for p in loop.model.parameters())
        weight_bytes = sum(p.numel() * p.element_size() for p in loop.model.parameters())
        cache_bytes = sum(v.numel() * v.element_size() for v in loop.cache.values())
        steps = [0]
        decode = loop._decode

        def counting(*a):
            steps[0] += 1
            return decode(*a)

        loop._decode = counting
        t0 = time.perf_counter()
        done = loop.run(make_requests(cfg, nreq, max_new))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        decode_launches = launch_counts()
        if any(decode_launches.values()):
            fail(f"serve: the decode loop launched pack/unpack kernels: {decode_launches}")
        tokens = sum(len(v) for v in done.values())
        if len(done) != nreq or any(len(v) != max_new for v in done.values()):
            fail(f"serve: {len(done)}/{nreq} requests served, lengths "
                 f"{sorted(len(v) for v in done.values())}")
        print(f"served {len(done)}/{nreq} requests, {tokens} tokens in {run_s:.1f}s "
              f"({tokens / run_s:.1f} tok/s, batch={B}, {cfg.name})")
        del loop, decode, counting
        torch.cuda.empty_cache()

        loop2 = ServeLoop(cfg, B, max_len, comm=comm, device=dev, seed=SEED)
        model = loop2.model
        finite = torch.ones((), dtype=torch.bool, device=dev)

        def checked(*a):
            nonlocal finite
            logits, cache = model.decode_step(*a)
            finite = finite & torch.isfinite(logits).all()
            return logits, cache

        loop2._decode = checked
        reqs2 = make_requests(cfg, nreq, max_new)
        done2 = loop2.run(reqs2)
        if done2 != done:
            fail("serve: a second loop from the same seed gave other tokens")
        if not bool(finite):
            fail("serve: a decode step returned a non-finite logit")

        # teacher-forced: decode over the served tokens against forward
        seqs = [r.prompt + r.out for r in reqs2[:B]]
        S = min(len(s) for s in seqs)
        toks = torch.tensor([s[:S] for s in seqs], device=dev)
        with torch.inference_mode():
            fwd, _ = model.forward(toks)
            cache = model.init_cache(B, max_len)
            dec = []
            for t in range(S):
                lg, cache = model.decode_step(cache, toks[:, t], t)
                dec.append(lg)
            dec = torch.stack(dec, 1)
            if not (torch.isfinite(fwd).all() and torch.isfinite(dec).all()):
                fail("serve: non-finite logits in the teacher-forced pass")
            diff = (dec - fwd).abs().max().item()
            scale = fwd.abs().max().item()
            if diff > SERVE_REL * scale:
                fail(f"serve: decode differs from forward by {diff:.4f}, > {SERVE_REL} x "
                     f"max |logit| {scale:.4f}")
            same = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()

            # ms per decode step, synchronized each
            cache = model.init_cache(B, max_len)
            times = []
            for t in range(SERVE_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.decode_step(cache, toks[:, t % S], t)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            profile = device_busy(torch, lambda: model.decode_step(cache, toks[:, 0],
                                                                   SERVE_TIMED_STEPS), iters=3)
            top = decode_kernel_share(torch, lambda: model.decode_step(cache, toks[:, 0],
                                                                       SERVE_TIMED_STEPS))
        del loop2, model, cache, fwd, dec
    torch.cuda.synchronize()
    out.update(
        params=params, weight_bytes=weight_bytes, kv_cache_bytes=cache_bytes,
        served=len(done), tokens=tokens, decode_steps=steps[0], run_s=run_s,
        tokens_per_s=tokens / run_s, ms_per_loop_step=run_s * 1e3 / steps[0],
        ms_per_decode_step=statistics.median(times), ms_per_decode_step_all=times,
        bound_ms=(weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
        weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        teacher_forced_positions=S, decode_vs_forward_max_abs=diff,
        forward_max_abs_logit=scale, decode_vs_forward_rel=diff / scale,
        decode_vs_forward_argmax_agree=same, tolerance_rel=SERVE_REL,
        decode_profile=profile, decode_top_kernels=top, max_memory_allocated=peak,
        smoother_launches=smoother_launches, decode_launches=decode_launches,
        first_tokens={rid: done[rid][:8] for rid in sorted(done)[:3]},
        phase_s=time.perf_counter() - t_phase)
    if not any(smoother_launches.values()):
        fail(f"serve: the startup smoother launched no kernel: {smoother_launches}")
    torch.cuda.empty_cache()
    print(f"[serve] {cfg.name} full width ({params:,} parameters, {weight_bytes / 1e9:.3f} GB "
          f"bf16): {len(done)}/{nreq} served, deterministic, decode vs forward max |diff| "
          f"{diff:.4f} ({diff / scale:.4f} of max |logit|, bound {SERVE_REL}); "
          f"{out['ms_per_decode_step']:.3f} ms/decode step (bound {out['bound_ms']:.3f}), "
          f"{out['tokens_per_s']:.1f} tok/s, device idle {profile['idle_share']:.3f}, peak "
          f"{out['max_memory_allocated'] / 2**30:.2f} GiB; startup smoother launches "
          f"{smoother_launches}; {card}")
    print(json.dumps({"serve": out}))
    return smoother_launches


def recurrent_flops(cfg, B, S):
    """The forward operations of a recurrent family's layers, from the
    code's own shapes: ``(dense, attn, chunk)``.  ``dense`` the bf16
    projections (Mamba2: ``in_proj`` and ``out_proj``; RWKV6: ``wr``,
    ``wk``, ``wv``, ``wg``, ``wo``, ``cr``, the decay LoRA, ``ck`` and
    ``cv``; the hybrid's shared block at each of its ``L / attn_every``
    applications), ``attn`` the shared block's S x S products, and
    ``chunk`` the float32 chunk products of the recurrence as the code
    computes them: per chunk of C, the C x C intra-chunk matrix (Mamba2:
    one ``q . k`` for all heads, as B/C are shared; RWKV6: one per
    head), its product with v per head, and the state's dk x dv products
    (into ``y`` and into the carried state) per token and head."""
    from repro_torch.models import blocks, linear_attn

    T, D, L = B * S, cfg.d_model, cfg.num_layers
    attn = 0
    if cfg.family == "rwkv":
        H, hd = blocks._rwkv_dims(cfg)
        C = S // max(S // linear_attn.VEC_CHUNK, 1)
        dense = 2 * T * L * (6 * D * D + 2 * blocks.RWKV_LORA * D + 2 * D * cfg.d_ff)
        chunk = 2 * T * L * H * (2 * C * hd + 2 * hd * hd)
        return dense, attn, chunk
    d_inner, H, ds, _ = blocks._mamba_dims(cfg)
    hd = cfg.ssm_head_dim
    C = S // max(S // linear_attn.SCALAR_CHUNK, 1)
    dense = 2 * T * L * (D * (2 * d_inner + 2 * ds + H) + d_inner * D)
    chunk = 2 * T * L * (C * ds + H * C * hd + 2 * H * ds * hd)
    if cfg.family == "hybrid":
        G, Ha, KV, ahd = L // cfg.attn_every, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        dense += 2 * T * G * (D * (Ha + 2 * KV) * ahd + Ha * ahd * D + 3 * D * cfg.d_ff)
        attn = 2 * B * G * S * S * Ha * ahd
    return dense, attn, chunk


def train_bound(cfg, B, S, nparams=None):
    """The least time one fused train step of ``cfg`` could take on the
    card, from the code's own shapes: the GEMM operations with remat
    (forward, the backward's recompute, the backward's two products per
    weight), the attention's chunked products (the full S x S computed,
    as the code computes it), the head (forward and two backward
    products), and AdamW's bytes (each parameter, gradient and moment
    read once, each parameter and moment written once; with
    ``microbatches`` > 1 the float32 accumulator's traffic besides).  The
    MoE experts run over every capacity slot of a group (``E * cap / gs``
    slots a token, as the dispatch computes them); the encoder-decoder
    adds its encoder over ``enc_embeds`` of the batch's length and a
    cross-attention a layer; the recurrent families count
    :func:`recurrent_flops`, their float32 chunk products (forward,
    recompute and two backward products each) at the float32 rate.
    ``nparams`` defaults to the dense family's count (pass the module
    count for the others).  The head runs as a float32 GEMM (the port
    upcasts it), which the card does at 67 TFLOP/s outside the tensor
    cores; the rest at the bf16 dense rate.  Returns the operation
    counts, the bytes and the bounds in ms."""
    T, D, H, KV, hd, F, V, L = (B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                                cfg.d_ff, cfg.vocab_size, cfg.num_layers)
    proj = D * (H + 2 * KV) * hd + H * hd * D
    mlp = 3 * D * F
    if cfg.family == "moe":
        gs = min(cfg.moe_group_size, S)
        cap = max(int(gs * cfg.experts_per_token / cfg.num_experts * cfg.moe_capacity_factor), 1)
        mlp = mlp * cfg.num_experts * cap / gs
    dense = 2 * T * L * (proj + mlp)
    attn = 2 * B * L * S * S * H * hd                    # one S x S product
    chunk = 0
    if cfg.family == "encdec":
        Le = cfg.encoder_layers
        dense += 2 * T * Le * (proj + mlp) + 2 * T * L * 2 * (D * H * hd + D * KV * hd)
        attn += 2 * B * Le * S * S * H * hd + 2 * B * L * S * S * H * hd
    if cfg.family in ("ssm", "rwkv", "hybrid"):
        dense, attn, chunk = recurrent_flops(cfg, B, S)
    layer_flops = 4 * dense + (2 + 2 + 5) * attn         # fwd, recompute, bwd (2x / 5 products)
    chunk_flops = 4 * chunk                              # fwd, recompute, bwd (2 products each)
    head_flops = 3 * 2 * T * D * V
    if nparams is None:
        nparams = (V * D + D + L * (2 * D + D * (H + 2 * KV) * hd + (H + 2 * KV) * hd
                                    + H * hd * D + 3 * D * F))
    mb = 4 if cfg.opt_moment_dtype == "float32" else 2
    n_micro = max(cfg.microbatches, 1)
    opt_bytes = nparams * (2 + 2 + (4 if n_micro > 1 else 2) + 4 * mb)
    if n_micro > 1:  # each micro-batch's bf16 gradient written and read, the accumulator r/w
        opt_bytes += nparams * n_micro * (2 + 2 + 4 + 4)
    ops_ms = ((layer_flops + head_flops) / BF16_FLOPS + chunk_flops / F32_FLOPS) * 1e3
    ops_f32_head_ms = (layer_flops / BF16_FLOPS + (head_flops + chunk_flops) / F32_FLOPS) * 1e3
    bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"layer_gemm_tflop": layer_flops / 1e12, "head_tflop": head_flops / 1e12,
            "chunk_f32_tflop": chunk_flops / 1e12,
            "params": nparams, "adamw_bytes": opt_bytes, "ops_bf16_ms": ops_ms,
            "ops_with_f32_head_ms": ops_f32_head_ms, "adamw_bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes"}


def int8_wire_error(grads, out):
    """The int8 wire's error against its own per-block bound
    (:func:`repro_torch.train.grad_wire.int8_block_bound`), leaf by leaf.
    Returns (worst error / bound, the leaves whose per-leaf bound ``2
    (max|g| / 127 + 1e-7)`` plus half a bf16 ulp fails)."""
    from repro_torch.train.grad_wire import int8_block_bound

    worst, leaf_fails = 0.0, []
    for k, bound in int8_block_bound(grads).items():
        gf = grads[k].float()
        err = (out[k].float() - gf).abs()
        worst = max(worst, float((err / bound).max()))
        top = float(gf.abs().max())
        if float(err.max()) > 2 * (top / 127 + 1e-7) + top * 2.0 ** -8:
            leaf_fails.append(k)
    return worst, leaf_fails


def phase_train(torch, dev, card, measured):
    """The training path at the full width of qwen2-0.5b (494,032,768
    bf16 parameters, 24 layers, remat on; drawn on the card from seed 0)
    with the train CLI's defaults (seq 256, global batch 8, AdamW with
    float32 moments), in a temporary measure store (seeded with the
    ``[measure]`` phase's tables, so nothing recalibrates) and temporary
    checkpoint directories, all removed after.

    1. ``repro_torch.launch.train.main`` with ``--scale full --arch
       qwen2-0.5b --steps 4``: the startup smoother (through the four
       kernels: launch counts zeroed before, read after; fails if none
       launched), then 4 fused steps; every loss and grad norm finite;
       the step-0 loss beside ln(vocab).  ms per step (synchronized, median
       of the steps after the first), tokens/s, ``max_memory_allocated``,
       device busy/idle share and host stream syncs of a step and its
       largest device kernels (``torch.profiler``), the step's bound.
    2. Numerics: the ``FlashAttention`` backward against autograd through
       the plain chunked forward at the model's attention shape (float32
       to ``FLASH_F32_TOL``, bf16 to ``FLASH_BF16_REL`` of the largest
       gradient); one step of the bf16 model and of a float32 copy made
       from its own values (losses to ``BF16_LOSS_REL``, grad norms to
       ``BF16_GNORM_REL``);
       ``TRAIN_FIXED_STEPS`` steps on one batch with no warmup: the last
       loss below the first.
    3. Determinism, then GradWire: 2 fused steps twice from the same
       state (their spread); then 2 steps under ``rle``, ``auto`` and
       ``int8`` from that state.  Lossless modes: every exchanged
       gradient, the losses and the final parameters equal ``off``'s
       within the measured spread (``torch.equal`` when it is 0); int8:
       every element within the wire's own bound (``int8_wire_error``).
    4. Checkpoint: 3 steps with ``ckpt_every=2`` (one checkpoint, bytes
       and seconds to save); the restored tree ``torch.equal`` to the
       saved state (seconds to restore); two resumes give equal losses,
       the first equal to batch 2's loss on the restored state.
    Returns the phase's launches and its ms per step."""
    import shutil
    import tempfile

    from repro_torch.comm import Communicator
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as launch_train
    from repro_torch.measure import ParamsStore
    from repro_torch.models import build_model, layers
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.grad_wire import GradWire
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_grad_step, make_loss_fn, make_train_step

    sync = torch.cuda.synchronize
    cfg = launch_train.resolve_config(TRAIN_ARCH, "full")
    S, B, steps = (TRAIN_DEFAULTS[k] for k in ("seq_len", "global_batch", "steps"))
    shape = ShapeConfig("train", S, B, "train")
    out = {"card": card, "arch": cfg.name, "scale": "full", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat,
           "seq_len": S, "global_batch": B, "moment_dtype": cfg.opt_moment_dtype}
    t_phase = time.perf_counter()

    def fresh():
        model = build_model(cfg, device=dev).init(SEED)
        return model, model.trainable()

    def free():
        sync()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        store = os.path.join(root, "store")
        ParamsStore(store, device=dev).save(measured)

        # -- 1. the entry point ------------------------------------------
        free()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        run = launch_train.main(["--arch", TRAIN_ARCH, "--scale", "full", "--steps", str(steps),
                                 "--seq-len", str(S), "--global-batch", str(B),
                                 "--comm-cache", store, "--ckpt-dir",
                                 os.path.join(root, "ckpt_main")])
        sync()
        out["main_s"] = time.perf_counter() - t0
        launches = launch_counts()
        if not any(launches.values()):
            fail(f"train: the startup smoother launched no kernel: {launches}")
        out["launches_main"] = dict(launches)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        losses, gnorms = run["losses"], run["grad_norms"]
        if len(losses) != steps or not all(math.isfinite(x) for x in losses + gnorms):
            fail(f"train: losses {losses}, grad norms {gnorms}")
        step_ms = [s * 1e3 for s in run["step_s"]]
        out.update(losses=losses, grad_norms=gnorms, step_ms_all=step_ms,
                   ms_per_step=statistics.median(step_ms[1:]),
                   uniform_logits_loss=math.log(cfg.vocab_size))
        out["tokens_per_s"] = B * S / out["ms_per_step"] * 1e3
        model, params, opt_state = run["model"], run["params"], run["opt_state"]
        out["param_count"] = sum(p.numel() for p in params.values())
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype, total_steps=10)
        step_fn = make_train_step(model, opt_cfg)
        batch = synthetic_batch(cfg, shape, steps, device=dev)
        # one profiled step: the profiler's own bookkeeping takes seconds a step
        out["step_profile"] = device_busy(
            torch, lambda: step_fn(params, opt_state, batch), iters=1, top=8)
        out["bound"] = train_bound(cfg, B, S)
        del run, model, params, opt_state, step_fn, batch
        free()
        out["entry_point_s"] = time.perf_counter() - t_phase

        # -- 2. numerics at full width -------------------------------------
        t_part = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
        qkv = [torch.randn(s, generator=gen, device=dev) * 0.5
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
        flash = {}
        for dtype, tol in ((torch.float32, None), (torch.bfloat16, FLASH_BF16_REL)):
            grads, ms = [], []
            for fn in (lambda q, k, v: layers.flash_attention(q, k, v),
                       lambda q, k, v: layers._flash_forward(q, k, v, True, None, 0,
                                                             layers.ATTN_CHUNK, False)[0]):
                ts = [t.to(dtype).clone().requires_grad_(True) for t in qkv]

                def fwd_bwd():
                    for t in ts:
                        t.grad = None
                    torch.sin(fn(*ts).float()).sum().backward()

                fwd_bwd()
                ms.append(wall_ms(torch, fwd_bwd, 5))
                grads.append([t.grad.float() for t in ts])
            errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
            scale_ = [float(b.abs().max()) for b in grads[1]]
            name = str(dtype).split(".")[1]
            flash[name] = {"max_abs_err": errs, "max_abs_grad": scale_,
                           "ms_function": ms[0], "ms_autograd": ms[1]}
            for e, m_, (a, b) in zip(errs, scale_, zip(*grads)):
                if tol is None:
                    torch.testing.assert_close(a, b, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
                elif e > tol * m_:
                    fail(f"train: bf16 flash backward differs by {e} > {tol} x {m_}")
        out["flash_backward"] = flash
        del qkv, grads
        free()

        # one step (the split halves: the fused step's ops) of the bf16
        # model and of a float32 copy holding its values (so only the
        # compute's precision differs), with each leaf's gradient norm
        batch = synthetic_batch(cfg, shape, 0, device=dev)
        pair, leaf_norms = {}, {}
        model, params = fresh()
        f32_values = {k: v.float() for k, v in model.state_dict().items()}
        for dtype in (cfg.dtype, "float32"):
            if dtype == "float32":
                model = build_model(cfg.replace(dtype="float32"), device=dev)
                model.load_state_dict(f32_values)
                params = model.trainable()
                del f32_values
            grad_fn, update_fn = make_grad_step(model, opt_cfg)
            loss, m0, grads = grad_fn(params, batch)
            leaf_norms[dtype] = {k: float(g.float().norm()) for k, g in grads.items()}
            _, _, m = update_fn(params, init_opt_state(params, opt_cfg), grads, loss, m0)
            pair[dtype] = {k: float(m[k]) for k in ("loss", "grad_norm")}
            del model, params, grads, m, grad_fn, update_fn
            free()
        lb, lf = pair[cfg.dtype], pair["float32"]
        nb, nf = leaf_norms[cfg.dtype], leaf_norms["float32"]
        gap = sorted(nb, key=lambda k: -abs(nb[k] ** 2 - nf[k] ** 2))
        out["bf16_vs_f32"] = dict(pair, loss_rel=abs(lb["loss"] - lf["loss"]) / abs(lf["loss"]),
                                  grad_norm_rel=abs(lb["grad_norm"] - lf["grad_norm"])
                                  / abs(lf["grad_norm"]),
                                  widest_leaf_norms={k: [nb[k], nf[k]] for k in gap[:4]})
        if out["bf16_vs_f32"]["loss_rel"] > BF16_LOSS_REL:
            fail(f"train: bf16 and float32 losses differ: {pair}")
        if out["bf16_vs_f32"]["grad_norm_rel"] > BF16_GNORM_REL:
            fail(f"train: bf16 and float32 grad norms differ: {pair}")

        # a fixed batch, no warmup: the loss falls
        model, params = fresh()
        fixed_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype, warmup_steps=0,
                                total_steps=TRAIN_FIXED_STEPS)
        step_fn, opt = make_train_step(model, fixed_cfg), init_opt_state(params, fixed_cfg)
        curve = []
        for _ in range(TRAIN_FIXED_STEPS):
            params, opt, m = step_fn(params, opt, batch)
            curve.append(float(m["loss"]))
        out["fixed_batch_curve"] = curve
        if not curve[-1] < curve[0]:
            fail(f"train: {TRAIN_FIXED_STEPS} steps on one batch did not lower the loss: {curve}")
        del model, params, opt, step_fn, m
        free()

        out["numerics_s"] = time.perf_counter() - t_part

        # -- 3. determinism, then the gradient wire ------------------------
        t_part = time.perf_counter()
        comm = Communicator(params=measured, device=dev)

        def wire_run(mode):
            model, params = fresh()
            opt = init_opt_state(params, opt_cfg)
            rec = {"losses": []}
            if mode == "off":
                step_fn = make_train_step(model, opt_cfg)
            else:
                grad_fn, update_fn = make_grad_step(model, opt_cfg)
                wire, rec["exchange_ms"], rec["exchanges_equal"] = GradWire(comm, mode), [], True
            for s in range(TRAIN_WIRE_STEPS):
                batch = synthetic_batch(cfg, shape, s, device=dev)
                if mode == "off":
                    params, opt, m = step_fn(params, opt, batch)
                else:
                    loss, m0, grads = grad_fn(params, batch)
                    if not wire.planned:
                        wire.plan_for(grads)
                    sync()
                    t0 = time.perf_counter()
                    sent = wire.exchange(grads)
                    sync()
                    rec["exchange_ms"].append((time.perf_counter() - t0) * 1e3)
                    if mode == "int8":
                        worst, leaf_fails = int8_wire_error(grads, sent)
                        rec["int8_worst_over_bound"] = max(worst, rec.get(
                            "int8_worst_over_bound", 0.0))
                        rec["int8_per_leaf_bound_fails"] = leaf_fails
                        if worst > 1.0:
                            fail(f"train: int8 wire error {worst:.3f} x its bound")
                    else:
                        rec["exchanges_equal"] &= all(torch.equal(sent[k], grads[k])
                                                      for k in grads)
                    params, opt, m = update_fn(params, opt, sent, loss, m0)
                    del grads, sent
                rec["losses"].append(float(m["loss"]))
            if mode != "off":
                p = wire._plan_fwd
                rec.update(strategy=wire._strats[0].name, schedule=p.schedule,
                           wire_bytes=p.wire_bytes, issued_bytes=p.issued_bytes,
                           stream_bytes=list(p.stream_bytes or ()), ratio=p.stream_ratio,
                           describe=wire.describe())
            final = {k: v.detach() for k, v in params.items()}
            del model, opt
            return rec, final

        reset_launch_counts()
        wires = {}
        wires["off"], ref_params = wire_run("off")
        again, again_params = wire_run("off")
        spread = max(float((a.float() - again_params[k].float()).abs().max())
                     for k, a in ref_params.items())
        loss_spread = max(abs(a - b) for a, b in zip(wires["off"]["losses"], again["losses"]))
        out["determinism"] = {"losses": [wires["off"]["losses"], again["losses"]],
                              "max_abs_param_spread": spread, "max_abs_loss_spread": loss_spread,
                              "equal": spread == 0.0 and loss_spread == 0.0}
        del again_params
        free()

        def same(a, b):  # bit-equal, or within the measured same-run spread
            if spread == 0.0:
                return torch.equal(a, b)
            return float((a.float() - b.float()).abs().max()) <= spread

        for mode in ("rle", "auto", "int8"):
            rec, final = wire_run(mode)
            if mode != "int8":
                rec["params_equal_off"] = all(same(final[k], v) for k, v in ref_params.items())
                rec["losses_equal_off"] = all(
                    abs(a - b) <= loss_spread for a, b in zip(rec["losses"],
                                                              wires["off"]["losses"]))
                if not (rec["exchanges_equal"] and rec["params_equal_off"]
                        and rec["losses_equal_off"]):
                    fail(f"train: the lossless {mode} wire changed the step: {rec}")
            wires[mode] = rec
            del final
            free()
        out["grad_wire"] = wires
        out["launches_grad_wire"] = dict(launch_counts())
        del ref_params
        free()

        out["grad_wire_s"] = time.perf_counter() - t_part

        # -- 4. checkpoint and resume --------------------------------------
        t_part = time.perf_counter()
        ckdir = os.path.join(root, "ckpt")
        timed = {}
        save = ckpt.save_checkpoint

        def timed_save(*a, **k):
            sync()
            t0 = time.perf_counter()
            path = save(*a, **k)
            timed["save_s"] = time.perf_counter() - t0
            return path

        ckpt.save_checkpoint = timed_save
        try:
            run3 = launch_train.train(cfg, 3, S, B, ckdir, ckpt_every=2, device=dev)
        finally:
            ckpt.save_checkpoint = save
        names = sorted(os.listdir(ckdir))
        if names != ["step_00000002"]:
            fail(f"train: checkpoints {names}, want step_00000002")
        path = os.path.join(ckdir, "step_00000002")
        out["checkpoint_bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                      for f in os.listdir(path))
        t0 = time.perf_counter()
        step, tree = ckpt.restore_checkpoint(ckdir)
        out["restore_s"] = time.perf_counter() - t0
        saved = ckpt._flatten(ckpt.train_state(run3["model"], run3["params"],
                                               run3["opt_state"]))
        got = ckpt._flatten(tree)
        if sorted(got) != sorted(saved) or not all(
                torch.equal(got[k].to(dev), v) for k, v in saved.items()):
            fail("train: the restored checkpoint differs from the saved state")
        if step != 2 or int(got["opt.step"]) != 3:
            fail(f"train: checkpoint step {step}, opt.step {int(got['opt.step'])}")
        del saved, run3
        free()
        model = build_model(cfg, device=dev)
        sync()
        t0 = time.perf_counter()
        params, _ = ckpt.load_train_state(model, tree)
        sync()
        out["load_to_card_s"] = time.perf_counter() - t0
        del tree, got
        with torch.no_grad():
            batch2 = synthetic_batch(cfg, shape, 2, device=dev)
            direct = float(make_loss_fn(model)(params, batch2)[0])
        del model, params
        free()
        resumes = []
        for _ in range(2):
            r = launch_train.train(cfg, 4, S, B, ckdir, ckpt_every=100, device=dev)
            resumes.append(r["losses"])
            del r
            free()
        out.update(save_s=timed["save_s"], resumed_losses=resumes, batch2_loss_on_saved=direct)
        if len(resumes[0]) != 2 or any(abs(a - b) > loss_spread
                                       for a, b in zip(*resumes)):
            fail(f"train: two resumes gave {resumes}")
        if abs(resumes[0][0] - direct) > loss_spread:
            fail(f"train: the first resumed loss {resumes[0][0]} is not batch 2's loss "
                 f"{direct} on the saved state")
        out["checkpoint_s"] = time.perf_counter() - t_part
        out["launches"] = {k: out["launches_main"][k] + out["launches_grad_wire"][k]
                           for k in out["launches_main"]}
    out["phase_s"] = time.perf_counter() - t_phase
    free()
    b = out["bound"]
    prof = out["step_profile"]
    print(f"[train] {cfg.name} full width ({out['param_count']:,} parameters), seq {S} x "
          f"batch {B}: losses {['%.4f' % x for x in losses]} (step 0 against ln(V) = "
          f"{out['uniform_logits_loss']:.4f}), grad norms {['%.3f' % x for x in gnorms]}; "
          f"{out['ms_per_step']:.2f} ms/step (bound {b['bound_ms']:.2f} by {b['bound_by']}, "
          f"{b['ops_with_f32_head_ms']:.2f} with the float32 head), {out['tokens_per_s']:.0f} "
          f"tok/s, idle {prof['idle_share']:.3f}, "
          f"{prof['stream_syncs']} syncs a step, peak "
          f"{out['max_memory_allocated'] / 2**30:.2f} GiB; bf16 vs f32 loss "
          f"{out['bf16_vs_f32']['loss_rel']:.4f}, gnorm {out['bf16_vs_f32']['grad_norm_rel']:.4f};"
          f" fixed batch {curve[0]:.4f} -> {curve[-1]:.4f}; deterministic "
          f"{out['determinism']['equal']} (spread {spread}); wire "
          + ", ".join(f"{k} {v.get('strategy', '-')}/{v.get('schedule', '-')} "
                      f"{statistics.median(v['exchange_ms']) if v.get('exchange_ms') else 0:.1f}"
                      f" ms" for k, v in wires.items())
          + f"; checkpoint {out['checkpoint_bytes'] / 1e9:.2f} GB saved {out['save_s']:.1f} s, "
          f"restored {out['restore_s']:.1f} s; resumed {resumes[0]}; launches "
          f"{out['launches']}; phase {out['phase_s']:.1f} s; {card}")
    print(json.dumps({"train": out}))
    return out["launches"], out["ms_per_step"]



FAMILY_ARCHS = ("qwen2-vl-2b", "seamless-m4t-large-v2", "mixtral-8x22b")  # [families]
FAMILY_MOE_LAYERS = 8        # mixtral-8x22b's depth for forward, prefill and serving (of 56)
FAMILY_MOE_TRAIN_LAYERS = 1  # ... and for the train step
FAMILY_TF_TOKENS = 32        # teacher-forced positions; the prefill held to decode's K/V
FAMILY_PREFILL_SEQ = {"qwen2-vl-2b": 512, "mixtral-8x22b": 256}  # timed prefill (vlm: 256
#                              patches + 256 text); mixtral's gs = 128 drops read there too
FAMILY_TRAIN_SEQ = {"qwen2-vl-2b": 512, "seamless-m4t-large-v2": 256, "mixtral-8x22b": 256}
FAMILY_TRAIN = {"steps": 2, "global_batch": 8}
FAMILY_TIE = 5e-3            # a top-K expert within this probability of the next: a near-tie
PREFILL_LOGIT_REL = 1e-4     # prefill's last logits vs forward's last row: the float32 head
#                              GEMM at another shape, of max |logit|
PREFILL_KV_REL = 0.05        # prefill's K/V vs teacher-forced decode's, bf16: of each layer's
#                              largest |K| / |V|
STEP0_LOSS_TOL = 0.05        # step-0 logits' label-free loss against the init's expectation
STEP0_DIRECT_REL = 1e-4      # train()'s step-0 loss against the same forward run directly


def init_loss(cfg):
    """The expected cross-entropy of the init's logits against labels
    they carry no information about: random logits of variance ``s2``
    over V classes give ``ln V + s2 / 2``.  The final norm leaves each row
    at unit RMS, so ``s2`` is the head's column variance times D: 1 for
    an untied head (``1/sqrt(D)`` draws), D / V for the tied embedding
    (``1/sqrt(V)`` draws)."""
    s2 = cfg.d_model / cfg.vocab_size if cfg.tie_embeddings else 1.0
    return math.log(cfg.vocab_size) + s2 / 2


def step0_logits(torch, dev, cfg, S, B):
    """The logits ``train()`` starts from, by its own ops: a model drawn
    from seed 0, batch 0, split into the config's micro-batches.  Returns
    the loss the step computes (cross-entropy plus ``AUX_WEIGHT * aux``,
    averaged over the micro-batches), its label-free part (the mean of
    ``logsumexp(z) - mean_v(z)``: the loss against labels the logits know
    nothing of) and the labels' mean excess logit (the rest)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.train_step import AUX_WEIGHT, cross_entropy

    model = build_model(cfg, device=dev).init(SEED)
    batch = synthetic_batch(cfg, ShapeConfig("train", S, B, "train"), 0, device=dev)
    n_micro = max(cfg.microbatches, 1)
    loss, free_part, excess = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for i in range(n_micro):
            mb = {k: v.reshape(n_micro, -1, *v.shape[1:])[i] for k, v in batch.items()}
            logits, aux = model.forward(mb["tokens"], mb.get("positions"),
                                        patch_embeds=mb.get("patch_embeds"),
                                        enc_embeds=mb.get("enc_embeds"))
            loss += float(cross_entropy(logits, mb["labels"]) + AUX_WEIGHT * aux) / n_micro
            zbar = logits.mean(-1)
            free_part += float((torch.logsumexp(logits, -1) - zbar).mean()) / n_micro
            label = torch.gather(logits, -1, mb["labels"].long()[..., None])[..., 0]
            excess += float((label - zbar).mean()) / n_micro
            del logits
    del model, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return loss, free_part, excess


def expert_sets(torch, routes, B, K, steps=None):
    """Recorded MoE routing (``recording_routes``) as (layers, B, S, K)
    sorted experts and (layers, B, S) top-K margins: a forward's records
    (one a layer) or ``steps`` decode steps' (one a layer a step)."""
    idx, gap = [], []
    for r in routes:
        top = torch.sort(r["probs"].float(), dim=-1, descending=True).values
        gap.append((top[..., K - 1] - top[..., K]).reshape(B, -1))
        idx.append(torch.sort(r["gate_idx"].reshape(B, -1, K), dim=-1).values)
    if steps is None:
        return torch.stack(idx), torch.stack(gap)
    L = len(idx) // steps
    return (torch.stack([torch.cat(idx[l::L], 1) for l in range(L)]),
            torch.stack([torch.cat(gap[l::L], 1) for l in range(L)]))


def route_match(torch, fwd, dec):
    """Where the forward's and the decode's experts differ: the (B, S)
    positions of each row before its first flip, the flipped decisions,
    and each row's first flip's margin in the forward (earliest position,
    lowest layer there; later flips follow from it)."""
    (fi, fg), (di, _) = fwd, dec
    flipped = (fi != di).any(-1)                              # (layers, B, S)
    ok = torch.cumprod((~flipped.any(0)).int(), dim=1).bool()
    first = []
    for b in range(ok.shape[0]):
        s = int(ok[b].sum())
        if s < ok.shape[1]:
            first.append(float(fg[int(flipped[:, b, s].int().argmax()), b, s]))
    return ok, int(flipped.sum()), first


def family_run(torch, dev, card, arch):
    """One model of the ``[families]`` phase: serving (twice), the
    teacher-forced and prefill checks on the first loop's model, timings,
    then two train steps through ``train()``."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import ServeLoop, make_requests
    from repro_torch.models import blocks
    from repro_torch.models.frontends import random_frontend_batch

    sync = torch.cuda.synchronize

    def free():
        sync()
        torch.cuda.empty_cache()

    full = get_config(arch)
    cfg, reduced = full, []
    B, nreq, max_new, max_len = (SERVE_DEFAULTS[k] for k in ("batch", "requests", "max_new",
                                                            "max_len"))
    moe, encdec, vlm = (full.family == f for f in ("moe", "encdec", "vlm"))
    free()
    if moe:  # the deepest cut up to FAMILY_MOE_LAYERS whose bf16 weights fit with 25% spare
        free_bytes = torch.cuda.mem_get_info()[0]
        depth = FAMILY_MOE_LAYERS
        while depth > 1 and 2 * full.replace(num_layers=depth).param_count() > 0.75 * free_bytes:
            depth -= 1
        cfg = full.replace(num_layers=depth)
        reduced.append(f"forward, prefill and serving at {depth} of {full.num_layers} layers")
    K = cfg.experts_per_token
    out = {"card": card, "arch": arch, "family": full.family, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": B, "requests": nreq,
           "max_new": max_new, "max_len": max_len, "reduced": reduced}
    t_model = time.perf_counter()

    # -- serving, run 1; its model carries the checks and the timings -----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = ServeLoop(cfg, B, max_len, device=dev, seed=SEED)
    sync()
    out["init_s"] = time.perf_counter() - t0
    model = loop.model
    out["params"] = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_bytes = sum(v.numel() * v.element_size() for v in loop.cache.values())
    steps = [0]
    decode = loop._decode

    def counting(*a):
        steps[0] += 1
        return decode(*a)

    loop._decode = counting
    t0 = time.perf_counter()
    done = loop.run(make_requests(cfg, nreq, max_new))
    sync()
    run_s = time.perf_counter() - t0
    tokens = sum(len(v) for v in done.values())
    if len(done) != nreq or any(len(v) != max_new for v in done.values()):
        fail(f"families: {arch}: {len(done)}/{nreq} requests served, lengths "
             f"{sorted(len(v) for v in done.values())}")

    S = FAMILY_TF_TOKENS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    with torch.inference_mode():
        kw = {}
        if vlm:  # served text has no patches: an empty prefix
            kw["patch_embeds"] = torch.zeros((B, 0, cfg.d_model), dtype=torch.bfloat16,
                                             device=dev)
        if encdec:
            kw["enc_embeds"] = random_frontend_batch(cfg, gen, B, S)["enc_embeds"]
        # MoE at group size 1 in forward and prefill, as decode routes: nothing drops
        model.cfg = cfg.replace(moe_group_size=1) if moe else cfg
        with blocks.recording_routes() as f_routes:
            fwd, _ = model.forward(toks, **kw)
        cache = model.init_cache(B, max_len, enc_len=S)
        if encdec:
            cache["xk"], cache["xv"] = model.make_cross_cache(model.encode(kw["enc_embeds"]))
        dec = []
        with blocks.recording_routes() as d_routes:
            for t in range(S):
                lg, cache = model.decode_step(cache, toks[:, t], t)
                dec.append(lg)
        dec = torch.stack(dec, 1)
        if not (torch.isfinite(fwd).all() and torch.isfinite(dec).all()):
            fail(f"families: {arch}: non-finite logits in the teacher-forced pass")
        ok = torch.ones((B, S), dtype=torch.bool, device=dev)
        if moe:
            ok, flips, first = route_match(torch, expert_sets(torch, f_routes, B, K),
                                           expert_sets(torch, d_routes, B, K, steps=S))
            out["teacher_forced_route_flips"] = flips
            out["teacher_forced_first_flip_margins"] = first
            out["teacher_forced_positions_compared"] = int(ok.sum())
            if any(g >= FAMILY_TIE for g in first):
                fail(f"families: {arch}: decode routed a token to other experts than forward "
                     f"at a margin of {max(first)} >= {FAMILY_TIE}")
        scale = float(fwd.abs().max())
        diff = float((dec - fwd).abs().amax(-1)[ok].max())
        if diff > SERVE_REL * scale:
            fail(f"families: {arch}: decode differs from forward by {diff:.4f} > {SERVE_REL} x "
                 f"max |logit| {scale:.4f}")
        out.update(decode_vs_forward_max_abs=diff, forward_max_abs_logit=scale,
                   decode_vs_forward_rel=diff / scale,
                   decode_vs_forward_argmax_agree=float((dec.argmax(-1) == fwd.argmax(-1))[ok]
                                                        .float().mean()))
        if encdec:
            try:
                model.prefill(toks)
            except NotImplementedError:
                out["prefill"] = "raises NotImplementedError, as the reference's"
            else:
                fail("families: the encoder-decoder's prefill did not raise as the reference's")
        else:
            with blocks.recording_routes() as p_routes:
                plog, pcache = model.prefill(toks)
            if moe and not all(torch.equal(a["gate_idx"], b["gate_idx"])
                               for a, b in zip(p_routes, f_routes)):
                fail(f"families: {arch}: prefill routed otherwise than forward on one input")
            pdiff = float((plog - fwd[:, -1]).abs().max())
            if pdiff > PREFILL_LOGIT_REL * scale:
                fail(f"families: {arch}: prefill's last logits differ from forward's by {pdiff}")
            kv_rel = []
            for key in ("k", "v"):
                for layer in range(cfg.num_layers):
                    want = pcache[key][layer].float()
                    got = cache[key][layer, :, :S].float()
                    err = float((got - want).abs().amax((-2, -1))[ok].max())
                    kv_rel.append(err / float(want.abs().max()))
            out.update(prefill_vs_forward_max_abs=pdiff,
                       prefill_vs_forward_equal=bool(torch.equal(plog, fwd[:, -1])),
                       prefill_kv_vs_decode_max_rel=max(kv_rel), prefill_kv_rel_bound=PREFILL_KV_REL)
            if max(kv_rel) > PREFILL_KV_REL:
                fail(f"families: {arch}: prefill's K/V differ from decode's by {max(kv_rel):.4f} "
                     f"of the largest value")
        model.cfg = cfg
        del fwd, dec, cache, f_routes, d_routes

        # the timed prefill, and what the gs = 128 forward drops at its length
        if not encdec:
            Sp = FAMILY_PREFILL_SEQ[arch]
            ptoks = torch.randint(0, cfg.vocab_size, (B, Sp), generator=gen, device=dev)
            pkw = {}
            if vlm:
                pkw["patch_embeds"] = random_frontend_batch(cfg, gen, B, Sp)["patch_embeds"]
            if moe:
                with blocks.recording_routes() as routes:
                    model.forward(ptoks)
                kept = sum(float(r["keep"].sum()) for r in routes)
                out["forward_drop_share"] = 1.0 - kept / (B * Sp * K * cfg.num_layers)
                out["forward_drop_share_by_layer"] = [
                    1.0 - float(r["keep"].sum()) / (B * Sp * K) for r in routes]
                del routes
            model.prefill(ptoks, **pkw)
            out["prefill_seq"] = Sp
            out["ms_per_prefill"] = wall_ms(torch, lambda: model.prefill(ptoks, **pkw), 3)

        # ms per decode step, synchronized each
        cache = model.init_cache(B, max_len, enc_len=S)
        times = []
        for t in range(SERVE_TIMED_STEPS):
            sync()
            t0 = time.perf_counter()
            model.decode_step(cache, toks[:, t % S], t)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        del cache
    out.update(weight_bytes=weight_bytes, kv_cache_bytes=cache_bytes, served=len(done),
               tokens=tokens, decode_steps=steps[0], run_s=run_s, tokens_per_s=tokens / run_s,
               ms_per_decode_step=statistics.median(times), ms_per_decode_step_all=times,
               weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
               bound_ms=(weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
               tolerance_rel=SERVE_REL, max_memory_allocated_serve=torch.cuda.max_memory_allocated(),
               first_tokens={rid: done[rid][:8] for rid in sorted(done)[:3]})
    del loop, model, decode, counting
    free()

    # -- serving, run 2: the same tokens, every logit finite ---------------
    loop2 = ServeLoop(cfg, B, max_len, device=dev, seed=SEED)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    decode2 = loop2.model.decode_step

    def checked(*a):
        nonlocal finite
        logits, c = decode2(*a)
        finite = finite & torch.isfinite(logits).all()
        return logits, c

    loop2._decode = checked
    if loop2.run(make_requests(cfg, nreq, max_new)) != done:
        fail(f"families: {arch}: a second loop from the same seed gave other tokens")
    if not bool(finite):
        fail(f"families: {arch}: a decode step returned a non-finite logit")
    del loop2, decode2, checked
    free()

    # -- two train steps through train() -------------------------------------
    tcfg = full
    if moe:
        tcfg = full.replace(num_layers=FAMILY_MOE_TRAIN_LAYERS)
        reduced.append(f"train step at {FAMILY_MOE_TRAIN_LAYERS} of {full.num_layers} layers")
    St, Bt = FAMILY_TRAIN_SEQ[arch], FAMILY_TRAIN["global_batch"]
    direct, label_free, excess = step0_logits(torch, dev, tcfg, St, Bt)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_families_") as ckdir:
        run = launch_train.train(tcfg, FAMILY_TRAIN["steps"], St, Bt, ckdir, device=dev)
    sync()
    losses, step_ms = run["losses"], [x * 1e3 for x in run["step_s"]]
    nparams = sum(p.numel() for p in run["params"].values())
    peak_train = torch.cuda.max_memory_allocated()
    del run
    free()
    expect = init_loss(tcfg)
    if len(losses) != FAMILY_TRAIN["steps"] or not all(math.isfinite(x) for x in losses):
        fail(f"families: {arch}: train losses {losses}")
    if abs(losses[0] - direct) > STEP0_DIRECT_REL * abs(direct):
        fail(f"families: {arch}: train()'s step-0 loss {losses[0]:.6f} is not its forward's "
             f"{direct:.6f}")
    if abs(label_free - expect) > STEP0_LOSS_TOL:
        fail(f"families: {arch}: the step-0 logits' label-free loss {label_free:.4f} is not "
             f"within {STEP0_LOSS_TOL} of {expect:.4f} (ln V + s2 / 2)")
    bound = train_bound(tcfg, Bt, St, nparams)
    out.update(train_layers=tcfg.num_layers, train_params=nparams, train_seq=St,
               train_batch=Bt, microbatches=tcfg.microbatches,
               moment_dtype=tcfg.opt_moment_dtype, losses=losses, step0_expected=expect,
               step0_direct=direct, step0_label_free=label_free,
               step0_label_excess_logit=excess,
               ln_vocab=math.log(tcfg.vocab_size), step_ms_all=step_ms,
               ms_per_train_step=step_ms[-1], train_tokens_per_s=Bt * St / step_ms[-1] * 1e3,
               train_bound=bound, max_memory_allocated_train=peak_train,
               phase_s=time.perf_counter() - t_model)
    return out


def phase_families(torch, dev, card):
    """The attention families at full width (weights drawn on the card
    from seed 0), after the earlier phases' models are freed:
    qwen2-vl-2b (vlm: M-RoPE, 256 patches) and seamless-m4t-large-v2
    (encdec) whole, mixtral-8x22b (moe, GShard dispatch) at full width
    with its depth cut (``FAMILY_MOE_LAYERS`` for serving, prefill and
    forward, ``FAMILY_MOE_TRAIN_LAYERS`` for the train step; each cut in
    ``reduced``).  For each (:func:`family_run`):

    1. ``ServeLoop`` at the serve CLI's defaults (batch 4, 8 requests of
       16 new tokens, max_len 128): all served; a second loop from the
       same seed gives the same tokens with every logit finite.
    2. ``FAMILY_TF_TOKENS`` tokens teacher-forced: decode against
       ``forward`` within ``SERVE_REL`` of the largest logit (vlm: text
       only, as served; encdec: the cross cache from ``encode`` +
       ``make_cross_cache`` of drawn audio embeddings; moe: forward at
       group size 1, where nothing drops, and each row compared before its
       first position routed to other experts than decode's, which must
       be a near-tie, ``FAMILY_TIE``); ``prefill``'s last logits against
       forward's last row (``PREFILL_LOGIT_REL``) and its K/V against the
       decode's (``PREFILL_KV_REL``); encdec's prefill raises, as the
       reference's.
    3. ms per prefill (``FAMILY_PREFILL_SEQ``; vlm with its patches), the
       share of (token, choice) pairs mixtral's ``gs = 128`` forward drops
       at that length, ms per decode step (median of
       ``SERVE_TIMED_STEPS``, synchronized) against the weight-bytes
       bound, tokens/s of the loop, peak memory.
    4. ``train()`` for two steps (global batch 8, seq
       ``FAMILY_TRAIN_SEQ``): finite losses; the step-0 loss equal to the
       same forward run directly (:func:`step0_logits`,
       ``STEP0_DIRECT_REL``), whose label-free part is within
       ``STEP0_LOSS_TOL`` of :func:`init_loss`; ms per step against
       :func:`train_bound`.

    No smoother runs, so no pack/unpack kernel should launch: the counts
    are zeroed before and read after, and returned."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    reset_launch_counts()
    runs = []
    for arch in FAMILY_ARCHS:
        r = family_run(torch, dev, card, arch)
        runs.append(r)
        print(f"[families] {arch} ({r['params']:,} parameters, {r['layers']} layers"
              + (f" + {r['encoder_layers']} encoder" if r["encoder_layers"] else "")
              + f"; reduced: {r['reduced'] or 'none'}): {r['served']}/{r['requests']} served, "
              f"deterministic; decode vs forward {r['decode_vs_forward_rel']:.4f} of max |logit|"
              + (f" ({r['teacher_forced_route_flips']} route flips, "
                 f"{r['teacher_forced_positions_compared']} positions compared)"
                 if "teacher_forced_route_flips" in r else "")
              + (f"; prefill logits {r['prefill_vs_forward_max_abs']:.2e}, K/V "
                 f"{r['prefill_kv_vs_decode_max_rel']:.4f}; {r['ms_per_prefill']:.2f} ms/prefill "
                 f"(seq {r['prefill_seq']})" if "ms_per_prefill" in r else "; no prefill")
              + (f"; gs=128 forward drops {r['forward_drop_share']:.4f}"
                 if "forward_drop_share" in r else "")
              + f"; {r['ms_per_decode_step']:.2f} ms/decode step (weight bound "
              f"{r['weight_bound_ms']:.3f}), {r['tokens_per_s']:.1f} tok/s, peak "
              f"{r['max_memory_allocated_serve'] / 2**30:.2f} GiB; train {r['train_layers']} "
              f"layers seq {r['train_seq']}: losses {['%.4f' % x for x in r['losses']]} "
              f"(label-free {r['step0_label_free']:.4f} against ln V + s2/2 "
              f"{r['step0_expected']:.4f}, ln V {r['ln_vocab']:.4f}; labels' excess logit "
              f"{r['step0_label_excess_logit']:+.4f}), "
              f"{r['ms_per_train_step']:.1f} ms/step (bound {r['train_bound']['bound_ms']:.2f} "
              f"by {r['train_bound']['bound_by']}), peak "
              f"{r['max_memory_allocated_train'] / 2**30:.2f} GiB; {r['phase_s']:.1f} s; {card}")
    launches = dict(launch_counts())
    out = {"card": card, "models": runs, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"families": out}))
    return launches


RECURRENT_ARCHS = ("zamba2-2.7b", "rwkv6-7b")  # [recurrent]: whole for serving
RECURRENT_TRAIN_LAYERS = {"rwkv6-7b": 16}      # train depth (of 32): its parameters,
#                              gradients and two float32 moments whole need about 90 GB
RECURRENT_TRAIN = {"steps": 2, "seq_len": 256, "global_batch": 8}
RECURRENT_CHECK = {"batch": 2, "seq": 128}      # chunk vs step checks: 2 Mamba2 chunks of 64,
#                              4 RWKV6 chunks of 32
RECURRENT_TOL = 1e-4           # float32: chunked vs single steps, and teacher-forced decode vs
#                              forward, of the largest value
BF16_DECODE_FACTOR = 1.5       # bf16 decode's distance from the float32 logits, at most this
#                              times bf16 forward's: at random weights these deep stacks amplify
#                              a rounding of their input 13-29x (measured on an H100 by
#                              scripts/recurrent_bf16_sensitivity.py), so bf16 forward is
#                              7-13% of max |logit| from float32 and SERVE_REL cannot hold
#                              between the two bf16 paths
RECURRENT_DT_BIAS = 3.0        # dt_bias for the large-decay step: softplus(3 + dt) ~ 3 a token
OVERFLOW_LOG = 88.72           # ln(float32 max): exp overflows past it


def _no_tf32(torch):
    """Turn TF32 off for cuBLAS and cuDNN; returns a function restoring
    the previous settings."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    return restore


def recurrent_numerics(torch, dev):
    """On the card, float32 with TF32 off, at the full head sizes
    (Mamba2: H = 80, dk = dv = 64, B/C shared across heads; RWKV6: H =
    64, dk = dv = 64): each chunked form's ``y`` and final state, from a
    carried ``state0``, against ``RECURRENT_CHECK["seq"]`` single steps
    within ``RECURRENT_TOL`` of the largest value.  Then one train step
    (``make_train_step``, AdamW) of a one-layer ``ssm`` model at
    zamba2-2.7b's width in float32 with every ``dt_bias`` at
    ``RECURRENT_DT_BIAS``, so a chunk's cumulative log decay passes
    ``OVERFLOW_LOG`` (the reference's gradient is NaN there): the loss,
    the gradient norm and every updated parameter must be finite."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import blocks, build_model, linear_attn as la
    from repro_torch.models.layers import rms_norm
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    restore = _no_tf32(torch)
    out = {"tf32": False}
    try:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        Bc, S = RECURRENT_CHECK["batch"], RECURRENT_CHECK["seq"]
        rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        un = lambda *shape: torch.rand(shape, generator=gen, device=dev)   # noqa: E731

        def compare(name, chunked, steps):
            worst = 0.0
            for a, b in zip(chunked, steps):
                worst = max(worst, float((a - b).abs().max()) / float(b.abs().max()))
            out[name] = {"max_rel_err": worst, "tolerance_rel": RECURRENT_TOL}
            if not worst <= RECURRENT_TOL:
                fail(f"recurrent: {name}: chunked vs single steps {worst:.3e} > {RECURRENT_TOL}")

        H, dk = 80, 64                      # Mamba2 at zamba2-2.7b: d_inner 5120 / 64
        q, k = rn(Bc, S, dk), rn(Bc, S, dk) * 0.125
        v, ld = rn(Bc, S, H, dk), -un(Bc, S, H)
        s0 = rn(Bc, H, dk, dk)
        y, st = la.chunked_scalar_decay(q, k, v, ld, s0)
        ys, state = [], s0
        for s in range(S):
            yy, state = la.step_scalar_decay(q[:, s, None].expand(Bc, H, dk),
                                             k[:, s, None].expand(Bc, H, dk), v[:, s],
                                             ld[:, s], state)
            ys.append(yy)
        compare("mamba2_chunk_vs_steps", (y, st), (torch.stack(ys, 1), state))
        H = 64                              # RWKV6 at rwkv6-7b: 4096 / 64
        q, k, v = rn(Bc, S, H, dk), rn(Bc, S, H, dk) * 0.125, rn(Bc, S, H, dk)
        ld, u, s0 = -un(Bc, S, H, dk) * 1.5, rn(H, dk) * 0.1, rn(Bc, H, dk, dk)
        y, st = la.chunked_vector_decay(q, k, v, ld, u, s0)
        ys, state = [], s0
        for s in range(S):
            yy, state = la.step_vector_decay(q[:, s], k[:, s], v[:, s], ld[:, s], u, state)
            ys.append(yy)
        compare("rwkv6_chunk_vs_steps", (y, st), (torch.stack(ys, 1), state))
        del q, k, v, ld, u, s0, y, st, ys, state

        # the large-decay train step
        cfg = get_config("zamba2-2.7b").replace(family="ssm", num_layers=1, dtype="float32")
        model = build_model(cfg, device=dev).init(SEED)
        with torch.no_grad():
            for layer in model.layers:
                layer.ssm.dt_bias.fill_(RECURRENT_DT_BIAS)
        Sb = 2 * la.SCALAR_CHUNK
        batch = synthetic_batch(cfg, ShapeConfig("train", Sb, 2, "train"), 0, device=dev)
        with torch.no_grad():           # the decay the step's chunks see, by the block's ops
            ps = model.layers[0].ssm
            h = rms_norm(model._embed(batch["tokens"]), ps.norm, cfg.norm_eps)
            _, _, dt = blocks._mamba_inner(ps, h, cfg)
            ldk = torch.exp(ps.A_log) * torch.nn.functional.softplus(dt.float() + ps.dt_bias)
            cum = ldk.reshape(2, Sb // la.SCALAR_CHUNK, la.SCALAR_CHUNK, -1).sum(2).max()
        params = model.trainable()
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype, total_steps=10)
        params, _, metrics = make_train_step(model, opt_cfg)(
            params, init_opt_state(params, opt_cfg), batch)
        finite = all(bool(torch.isfinite(p).all()) for p in params.values())
        out["large_decay_step"] = {
            "dt_bias": RECURRENT_DT_BIAS, "max_chunk_cumulative_log_decay": float(cum),
            "overflow_at": OVERFLOW_LOG, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "params_finite": finite}
        if not float(cum) > OVERFLOW_LOG:
            fail(f"recurrent: the large-decay step's chunks reach {float(cum):.1f}, not past "
                 f"{OVERFLOW_LOG}: it does not test the overflow")
        if not (math.isfinite(float(metrics["loss"])) and math.isfinite(float(metrics["grad_norm"]))
                and finite):
            fail(f"recurrent: the large-decay train step is not finite: {out['large_decay_step']}")
        del model, params, batch, metrics
    finally:
        restore()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def recurrent_decode_bound(cfg, model, cache):
    """Bytes a decode step must move at least: every weight read once
    (the hybrid's shared block once at each of its ``L / attn_every``
    applications), the recurrent state read and written (``ssm``/``wkv``
    float32, ``conv``/``shift_*`` in the model's dtype), the shared
    block's K/V read.  Returns the bytes by part and the bound in ms."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    weights = nbytes(model.parameters())
    shared = 0
    if cfg.family == "hybrid":
        shared = nbytes(model.shared.parameters()) * (cfg.num_layers // cfg.attn_every - 1)
    state = nbytes(v for k, v in cache.items() if k not in ("shared_k", "shared_v", "kpos"))
    kv = nbytes(v for k, v in cache.items() if k in ("shared_k", "shared_v"))
    total = weights + shared + 2 * state + kv
    return {"weight_bytes": weights, "shared_reuse_bytes": shared, "state_bytes": state,
            "kv_bytes": kv, "bytes": total, "bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "weight_bound_ms": weights / HBM_BYTES_PER_S * 1e3}


def train_state_bytes(torch, cfg):
    """``(parameters, bytes)`` a train step of ``cfg`` holds at least
    (the reason a depth is cut):
    each parameter (model dtype), its gradient, the float32 accumulator
    under micro-batches and the two moments; the parameters counted from
    ``meta`` builds of one layer (and the hybrid's shared block)."""
    from repro_torch.models import blocks, model as model_mod

    count = lambda cls: sum(p.numel() for p in cls(cfg, torch.bfloat16,  # noqa: E731
                                                   torch.device("meta")).parameters())
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = cfg.num_layers * count(model_mod._BLOCKS[cfg.family][0]) + embed + cfg.d_model
    if cfg.family == "hybrid":
        n += count(blocks.DenseBlock)
    mb = 4 if cfg.opt_moment_dtype == "float32" else 2
    return n, n * (2 + 2 + (4 if cfg.microbatches > 1 else 0) + 2 * mb)


def recurrent_run(torch, dev, card, arch, store):
    """One model of the ``[recurrent]`` phase: for the hybrid the serve
    CLI first (``launch.serve.main`` at full scale over ``store``: the
    startup smoother and the loop); then a direct ``ServeLoop`` twice,
    the teacher-forced checks, ``prefill`` raising, the decode timings,
    and two train steps through ``train()``.  Returns the run's record
    and the serve CLI's kernel launches."""
    import contextlib
    import gc
    import io
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import ServeLoop, make_requests
    from repro_torch.models import build_model

    sync = torch.cuda.synchronize

    def free():
        gc.collect()
        sync()
        torch.cuda.empty_cache()

    cfg = get_config(arch)
    B, nreq, max_new, max_len = (SERVE_DEFAULTS[k] for k in ("batch", "requests", "max_new",
                                                            "max_len"))
    out = {"card": card, "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "ssm_state": cfg.ssm_state, "ssm_head_dim": cfg.ssm_head_dim,
           "attn_every": cfg.attn_every, "heads": cfg.num_heads, "dtype": cfg.dtype,
           "batch": B, "requests": nreq, "max_new": max_new, "max_len": max_len,
           "reduced": [], "config_param_count": cfg.param_count()}
    t_model = time.perf_counter()
    cli = {}
    free()
    if cfg.family == "hybrid":  # 1. the serve CLI at full scale, the startup smoother first
        before = dict(launch_counts())
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = launch_serve.main(["--arch", arch, "--scale", "full", "--comm-cache", store])
        sync()
        cli = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        print(text.getvalue(), end="")
        served = [ln for ln in text.getvalue().splitlines() if ln.startswith("served ")]
        out["serve_cli"] = {"rc": rc, "s": time.perf_counter() - t0, "launches": cli,
                            "served_line": served[0] if served else None}
        if rc != 0 or not served or not served[0].startswith(f"served {nreq}/{nreq} requests"):
            fail(f"recurrent: {arch}: the serve CLI: rc {rc}, {served}")
        if not any(cli.values()):
            fail(f"recurrent: {arch}: the serve CLI's startup smoother launched no kernel")
        free()

    # 2. a direct ServeLoop; its model carries the checks and the timings
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = ServeLoop(cfg, B, max_len, device=dev, seed=SEED)
    sync()
    out["init_s"] = time.perf_counter() - t0
    model = loop.model
    out["params"] = sum(p.numel() for p in model.parameters())
    bound = recurrent_decode_bound(cfg, model, loop.cache)
    steps = [0]
    decode = loop._decode

    def counting(*a):
        steps[0] += 1
        return decode(*a)

    loop._decode = counting
    t0 = time.perf_counter()
    done = loop.run(make_requests(cfg, nreq, max_new))
    sync()
    run_s = time.perf_counter() - t0
    out["max_memory_allocated_serve"] = torch.cuda.max_memory_allocated()
    tokens = sum(len(v) for v in done.values())
    if len(done) != nreq or any(len(v) != max_new for v in done.values()):
        fail(f"recurrent: {arch}: {len(done)}/{nreq} requests served, lengths "
             f"{sorted(len(v) for v in done.values())}")

    # 3. teacher-forced: decode over FAMILY_TF_TOKENS drawn tokens against
    #    forward, in bf16 and in a float32 copy of the same weights
    S = FAMILY_TF_TOKENS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)

    def teacher_forced(m):
        fwd, _ = m.forward(toks)
        cache = m.init_cache(B, max_len)
        dec = []
        for t in range(S):
            lg, cache = m.decode_step(cache, toks[:, t], t)
            dec.append(lg)
        dec = torch.stack(dec, 1)
        if not (torch.isfinite(fwd).all() and torch.isfinite(dec).all()):
            fail(f"recurrent: {arch}: non-finite logits in the teacher-forced pass")
        return fwd, dec

    with torch.inference_mode():
        fwd, dec = teacher_forced(model)
        m32 = build_model(cfg.replace(dtype="float32", kv_cache_dtype="float32"), device=dev)
        m32.load_state_dict(model.state_dict())  # each bf16 value copied exactly to float32
        fwd32, dec32 = teacher_forced(m32)
        del m32
        scale = float(fwd32.abs().max())
        rel = lambda a, b: float((a - b).abs().max()) / scale  # noqa: E731
        f32_rel, bf16_rel = rel(dec32, fwd32), rel(dec, fwd)
        fwd_err, dec_err = rel(fwd, fwd32), rel(dec, dec32)
        if f32_rel > RECURRENT_TOL:
            fail(f"recurrent: {arch}: float32 decode differs from forward by {f32_rel:.3e} of "
                 f"max |logit|, > {RECURRENT_TOL}")
        if dec_err > BF16_DECODE_FACTOR * fwd_err:
            fail(f"recurrent: {arch}: bf16 decode is {dec_err:.4f} of max |logit| from float32, "
                 f"> {BF16_DECODE_FACTOR} x bf16 forward's {fwd_err:.4f}")
        out.update(f32_decode_vs_forward_rel=f32_rel, decode_vs_forward_rel=bf16_rel,
                   bf16_forward_vs_f32_rel=fwd_err, bf16_decode_vs_f32_rel=dec_err,
                   forward_max_abs_logit=scale, tolerance_f32_rel=RECURRENT_TOL,
                   bf16_decode_factor=BF16_DECODE_FACTOR,
                   decode_vs_forward_argmax_agree=float((dec.argmax(-1) == fwd.argmax(-1))
                                                        .float().mean()),
                   bf16_forward_vs_f32_argmax_agree=float(
                       (fwd.argmax(-1) == fwd32.argmax(-1)).float().mean()))
        try:
            model.prefill(toks)
        except NotImplementedError:
            out["prefill"] = "raises NotImplementedError, as the reference's"
        else:
            fail(f"recurrent: {arch}: prefill did not raise as the reference's")
        del fwd, dec, fwd32, dec32

        # 4. ms per decode step, synchronized each; one profiled window
        cache = model.init_cache(B, max_len)
        times = []
        for t in range(SERVE_TIMED_STEPS):
            sync()
            t0 = time.perf_counter()
            model.decode_step(cache, toks[:, t % S], t)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        profile = device_busy(torch, lambda: model.decode_step(cache, toks[:, 0],
                                                               SERVE_TIMED_STEPS), iters=3)
        del cache
    out.update(served=len(done), tokens=tokens, decode_steps=steps[0], run_s=run_s,
               tokens_per_s=tokens / run_s, ms_per_decode_step=statistics.median(times),
               ms_per_decode_step_all=times, decode_bound=bound, decode_profile=profile,
               max_memory_allocated_with_f32_copy=torch.cuda.max_memory_allocated(),
               first_tokens={rid: done[rid][:8] for rid in sorted(done)[:3]})
    del loop, model, decode, counting
    free()

    # the same tokens from a second loop, every logit finite
    loop2 = ServeLoop(cfg, B, max_len, device=dev, seed=SEED)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    decode2 = loop2.model.decode_step

    def checked(*a):
        nonlocal finite
        logits, c = decode2(*a)
        finite = finite & torch.isfinite(logits).all()
        return logits, c

    loop2._decode = checked
    if loop2.run(make_requests(cfg, nreq, max_new)) != done:
        fail(f"recurrent: {arch}: a second loop from the same seed gave other tokens")
    if not bool(finite):
        fail(f"recurrent: {arch}: a decode step returned a non-finite logit")
    del loop2, decode2, checked
    free()

    # 5. two train steps through train(), remat on, float32 moments
    St, Bt = RECURRENT_TRAIN["seq_len"], RECURRENT_TRAIN["global_batch"]
    depth = RECURRENT_TRAIN_LAYERS.get(arch, cfg.num_layers)
    tcfg = cfg.replace(num_layers=depth)
    direct, label_free, excess = step0_logits(torch, dev, tcfg, St, Bt)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recurrent_") as ckdir:
        run = launch_train.train(tcfg, RECURRENT_TRAIN["steps"], St, Bt, ckdir, device=dev)
    if depth < cfg.num_layers:
        out["reduced"].append(
            f"train step at {depth} of {cfg.num_layers} layers (full width): whole, the "
            f"parameters, gradients, accumulator and float32 moments need "
            f"{train_state_bytes(torch, cfg)[1] / 1e9:.1f} GB")
    sync()
    losses, step_ms = run["losses"], [x * 1e3 for x in run["step_s"]]
    nparams = sum(p.numel() for p in run["params"].values())
    peak_train = torch.cuda.max_memory_allocated()
    del run
    free()
    expect = init_loss(tcfg)
    if len(losses) != RECURRENT_TRAIN["steps"] or not all(math.isfinite(x) for x in losses):
        fail(f"recurrent: {arch}: train losses {losses}")
    if abs(losses[0] - direct) > STEP0_DIRECT_REL * abs(direct):
        fail(f"recurrent: {arch}: train()'s step-0 loss {losses[0]:.6f} is not its forward's "
             f"{direct:.6f}")
    if abs(label_free - expect) > STEP0_LOSS_TOL:
        fail(f"recurrent: {arch}: the step-0 logits' label-free loss {label_free:.4f} is not "
             f"within {STEP0_LOSS_TOL} of {expect:.4f} (ln V + s2 / 2)")
    out.update(train_layers=depth, train_params=nparams,
               train_config_param_count=tcfg.param_count(), train_seq=St, train_batch=Bt,
               microbatches=tcfg.microbatches, remat=tcfg.remat,
               moment_dtype=tcfg.opt_moment_dtype, losses=losses, step0_expected=expect,
               step0_direct=direct, step0_label_free=label_free,
               step0_label_excess_logit=excess, ln_vocab=math.log(tcfg.vocab_size),
               step_ms_all=step_ms, ms_per_train_step=step_ms[-1],
               train_tokens_per_s=Bt * St / step_ms[-1] * 1e3,
               train_bound=train_bound(tcfg, Bt, St, nparams),
               max_memory_allocated_train=peak_train, phase_s=time.perf_counter() - t_model)
    return out, cli


def phase_recurrent(torch, dev, card, measured):
    """The recurrent families at full width (weights drawn on the card
    from seed 0), after the earlier phases' models are freed.

    * :func:`recurrent_numerics`: the chunked forms against single steps
      at the full head sizes, and a large-decay train step, float32 with
      TF32 off.
    * zamba2-2.7b (``hybrid``: 54 Mamba2 layers, d_inner 5120, 80 SSM
      heads of 64, state 64; the shared attention block after every 6)
      whole: the serve CLI (``launch.serve.main``, the startup smoother
      through the four kernels over a temporary store seeded with the
      ``[measure]`` tables), then :func:`recurrent_run`.
    * rwkv6-7b (``rwkv``: 32 layers, D = 4096, 64 heads of 64, vocab
      65,536) whole for serving; its train step at
      ``RECURRENT_TRAIN_LAYERS`` layers (in ``reduced``).

    Each model: ``ServeLoop`` at the serve defaults (batch 4, 8 requests
    of 16 new tokens, max_len 128), all served, a second loop from the
    same seed giving the same tokens with every logit finite;
    ``FAMILY_TF_TOKENS`` teacher-forced tokens, decode against
    ``forward`` in a float32 copy of the weights within ``RECURRENT_TOL``
    of the largest logit, and in bf16 the decode no further from the
    float32 logits than ``BF16_DECODE_FACTOR`` times the forward is;
    ``prefill`` raising, as the reference's; ms per decode step (median of
    ``SERVE_TIMED_STEPS``, synchronized) against
    :func:`recurrent_decode_bound`, the device's idle share, tokens/s,
    peak memory; ``train()`` for ``RECURRENT_TRAIN["steps"]`` steps
    (remat, float32 moments) with the step-0 check of ``[families]`` and
    ms per step against :func:`train_bound`.  Launch counts are zeroed
    before the phase and read after; only the serve CLI's smoother
    launches kernels.  Prints a ``{"recurrent": ...}`` line and returns
    the launches."""
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.measure import ParamsStore

    t_phase = time.perf_counter()
    reset_launch_counts()
    numerics = recurrent_numerics(torch, dev)
    big = numerics["large_decay_step"]
    print(f"[recurrent] float32 at full head sizes: Mamba2 chunk vs steps "
          f"{numerics['mamba2_chunk_vs_steps']['max_rel_err']:.2e}, RWKV6 "
          f"{numerics['rwkv6_chunk_vs_steps']['max_rel_err']:.2e} of the largest value (bound "
          f"{RECURRENT_TOL}); large-decay step (chunk cumulative "
          f"{big['max_chunk_cumulative_log_decay']:.1f} > {OVERFLOW_LOG}): loss "
          f"{big['loss']:.4f}, grad norm {big['grad_norm']:.4f}, finite; {card}")
    runs, cli = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recurrent_store_") as store:
        ParamsStore(store, device=dev).save(measured)
        for arch in RECURRENT_ARCHS:
            r, launched = recurrent_run(torch, dev, card, arch, store)
            runs.append(r)
            for k, v in launched.items():
                cli[k] = cli.get(k, 0) + v
            b = r["decode_bound"]
            print(f"[recurrent] {arch} ({r['params']:,} parameters in the modules, "
                  f"param_count {r['config_param_count']:,}; {r['layers']} layers; reduced: "
                  f"{r['reduced'] or 'none'}): {r['served']}/{r['requests']} served, "
                  f"deterministic; decode vs forward {r['f32_decode_vs_forward_rel']:.2e} of max "
                  f"|logit| in float32, {r['decode_vs_forward_rel']:.4f} in bf16 (bf16 forward "
                  f"{r['bf16_forward_vs_f32_rel']:.4f}, decode {r['bf16_decode_vs_f32_rel']:.4f} "
                  f"from float32); {r['ms_per_decode_step']:.2f} ms/decode step (bound "
                  f"{b['bound_ms']:.3f}, weights alone {b['weight_bound_ms']:.3f}), device idle "
                  f"{r['decode_profile']['idle_share']:.3f} ({r['decode_profile']['activities']} "
                  f"activities in 3 steps), {r['tokens_per_s']:.1f} tok/s, peak "
                  f"{r['max_memory_allocated_serve'] / 2**30:.2f} GiB; train "
                  f"{r['train_layers']} layers seq {r['train_seq']} x {r['train_batch']}: losses "
                  f"{['%.4f' % x for x in r['losses']]} (label-free {r['step0_label_free']:.4f} "
                  f"against {r['step0_expected']:.4f}), {r['ms_per_train_step']:.1f} ms/step "
                  f"(bound {r['train_bound']['bound_ms']:.2f} by "
                  f"{r['train_bound']['bound_by']}), peak "
                  f"{r['max_memory_allocated_train'] / 2**30:.2f} GiB; {r['phase_s']:.1f} s; "
                  f"{card}")
    launches = dict(launch_counts())
    if launches != cli:
        fail(f"recurrent: kernels launched outside the serve CLI's smoother: {launches} "
             f"against {cli}")
    out = {"card": card, "numerics": numerics, "models": runs, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"recurrent": out}))
    return launches


def plan_launches(plan, comm):
    """Kernel launches one exchange of ``plan`` on ``comm`` makes: per
    region, a pack by its send strategy (for ``bounding``, the receiver's
    extraction from the window, by the static choice) and an unpack by
    the strategy ``comm`` selects for the receive type (the halo's planes
    never share rows, so a ``rows`` unpack is ``unpack_rows``)."""
    from repro_torch.comm import static_choice
    from repro_torch.core import StridedBlock
    from repro_torch.kernels.geometry import plan_geometry

    counts = dict.fromkeys(EXCHANGE_KERNELS, 0)
    for strat, send_ct, recv_ct in zip(plan.strategies, plan.send_cts, plan.recv_cts):
        packer = strat.name
        if strat.name == "bounding":
            sb = send_ct.block
            rb = StridedBlock(0, sb.counts, sb.strides)
            packer = static_choice(plan_geometry(rb)).name if rb.ndims > 1 else None
        for kernel in (f"pack_{packer}", f"unpack_{comm.select(recv_ct, 1, wire=False).name}"):
            if kernel in counts:
                counts[kernel] += 1
    return counts


# ---------------------------------------------------------------------------
# [mesh]: training on a device mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 2             # [mesh]: steps of train() with the mesh and without it
MESH_REL = 1e-3            # [mesh]: mesh vs no mesh, losses and grad norms (bf16 model)
MESH_WORLDS = ((256, False), (512, True))  # [mesh] planning: fake worlds, multi-pod
MESH_CHILD_TIMEOUT_S = 600


def phase_mesh(torch, dev, card):
    """Training on a device mesh, at the full width of qwen2-0.5b (bf16,
    remat on, float32 moments, seq 256 x batch 8, as ``[train]``).  Two
    child processes, each started after this process has emptied its
    allocator's cache:

    1. A world of one through NCCL (a ``file://`` store) with the (1, 1)
       ``("data", "model")`` mesh of ``make_test_mesh``: ``MESH_STEPS``
       steps of ``train()`` without the mesh and with it, in turns
       (plain, mesh, mesh, plain), each from ``Model.init`` (seed 0):
       losses and grad norms must agree within ``MESH_REL`` (and whether
       they are bit-equal is printed); ms per step (the host clock around
       each step, which ends in a host read of its metrics), each run's
       ``max_memory_allocated``.  The first plain run saves its final
       state (the 4.94 GB checkpoint); it is restored with
       ``shardings=train_state_shardings(model, mesh)`` onto the mesh
       (seconds), and every leaf must be ``torch.equal`` to the same
       checkpoint restored on the host.
    2. Planning at production size under a fake process group of 256,
       then 512: ``make_production_mesh`` must give (16, 16) and (2, 16,
       16); for every registry config at full width (built on ``meta``)
       the reference's rules give each leaf's spec: the count of sharded
       leaves and the parameter bytes one device holds, from the shapes.
    Returns the phase's record."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"card": card, "arch": TRAIN_ARCH, "steps": MESH_STEPS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        train = _mesh_child("train", root)
        plan = _mesh_child("plan", root)
    out["phase_s"] = time.perf_counter() - t0
    plain, meshed = train["runs"]["plain"], train["runs"]["mesh"]
    for key in ("losses", "grad_norms"):
        for a, b in zip(plain[0][key], meshed[0][key]):
            if not (math.isfinite(a) and math.isfinite(b)) or abs(a - b) > MESH_REL * abs(a):
                fail(f"[mesh] {key}: {plain[0][key]} without the mesh, {meshed[0][key]} on it")
        for runs in (plain, meshed):
            if runs[0][key] != runs[1][key]:
                fail(f"[mesh] {key} differ between two equal runs: {runs[0][key]}, "
                     f"{runs[1][key]}")
    out["bit_equal"] = {k: plain[0][k] == meshed[0][k] for k in ("losses", "grad_norms")}
    out["losses"] = {"plain": plain[0]["losses"], "mesh": meshed[0]["losses"]}
    out["grad_norms"] = {"plain": plain[0]["grad_norms"], "mesh": meshed[0]["grad_norms"]}
    out["step_ms"] = {k: [r["step_ms"] for r in v] for k, v in train["runs"].items()}
    out["max_memory_allocated"] = {k: [r["max_memory_allocated"] for r in v]
                                   for k, v in train["runs"].items()}
    out["placements"] = train["placements"]
    out["restore"] = train["restore"]
    out["plan"] = plan
    print(f"[mesh] qwen2-0.5b on the (1, 1) mesh vs none: losses {out['losses']}, bit-equal "
          f"{out['bit_equal']}; ms/step {out['step_ms']}; restore onto the mesh "
          f"{train['restore']['seconds']:.2f} s ({train['restore']['bytes']} bytes, "
          f"{train['restore']['leaves']} leaves equal)")
    for world, rec in plan.items():
        for arch, c in rec["configs"].items():
            print(f"[mesh] {rec['mesh']}: {arch}: {c['sharded_leaves']}/{c['leaves']} leaves "
                  f"sharded, {c['bytes_per_device']} of {c['param_bytes']} parameter bytes a "
                  f"device")
    print(json.dumps({"mesh": out}))
    return out


def _mesh_child(what: str, root: str) -> dict:
    """Run ``chip_smoke.py --mesh-child WHAT ROOT``; returns what it wrote."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-child", what, root],
                          capture_output=True, text=True, timeout=MESH_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        fail(f"[mesh] the {what} child failed (rc={proc.returncode}):\n{proc.stdout[-4000:]}\n"
             f"{proc.stderr[-4000:]}")
    with open(os.path.join(root, f"{what}.json")) as f:
        return json.load(f)


def mesh_child(what: str, root: str) -> None:
    """A ``[mesh]`` or ``[dryrun]`` child process: ``train`` and
    ``decode`` on the card, ``plan`` on the host under a fake process
    group.  Writes ``ROOT/WHAT.json``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    out = {"train": mesh_child_train, "decode": mesh_child_decode,
           "plan": lambda _: mesh_child_plan()}[what](root)
    with open(os.path.join(root, f"{what}.json"), "w") as f:
        json.dump(out, f)


def mesh_child_train(root: str) -> dict:
    import torch

    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_process_group("nccl", store_path=os.path.join(root, "store"), rank=0, world_size=1)
    try:
        mesh = make_test_mesh(data=1, model=1, device_type="cuda")
        cfg = launch_train.resolve_config(TRAIN_ARCH, "full")
        S, B = TRAIN_DEFAULTS["seq_len"], TRAIN_DEFAULTS["global_batch"]
        runs, placements = {"plain": [], "mesh": []}, None
        for i, label in enumerate(("plain", "mesh", "mesh", "plain")):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = launch_train.train(
                cfg, MESH_STEPS, S, B, os.path.join(root, f"ckpt{i}"),
                ckpt_every=MESH_STEPS if i == 0 else 10 * MESH_STEPS, device=dev,
                mesh=mesh if label == "mesh" else None, log_every=100)
            torch.cuda.synchronize()
            runs[label].append({"losses": run["losses"], "grad_norms": run["grad_norms"],
                                "step_ms": [s * 1e3 for s in run["step_s"]],
                                "max_memory_allocated": torch.cuda.max_memory_allocated()})
            if label == "mesh" and placements is None:
                p = run["params"]["layers.0.attn.wq"]
                if not hasattr(p, "placements"):
                    raise SystemExit("[mesh] train(mesh=...) left a plain parameter")
                placements = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
                              "layers.0.attn.wq": [repr(x) for x in p.placements],
                              "embed.vocab": [repr(x) for x in
                                              run["params"]["embed.vocab"].placements]}
            del run
        # the plain run's checkpoint onto the mesh
        torch.cuda.empty_cache()
        shardings = ckpt.train_state_shardings(build_model(cfg, device="meta"), mesh)
        src = os.path.join(root, "ckpt0")
        t0 = time.perf_counter()
        step, placed = ckpt.restore_checkpoint(src, shardings=shardings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        _, host = ckpt.restore_checkpoint(src, step=step)
        placed, host = ckpt._flatten(placed), ckpt._flatten(host)
        nbytes = 0
        for k, want in host.items():
            got = full_tensor(placed[k]).cpu()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise SystemExit(f"[mesh] restored leaf {k} differs from the checkpoint")
            nbytes += want.numel() * want.element_size()
        return {"runs": runs, "placements": placements,
                "restore": {"step": step, "seconds": seconds, "bytes": nbytes,
                            "leaves": len(host)}}
    finally:
        destroy_process_group()


def mesh_child_plan() -> dict:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES, mesh_axes, param_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model

    out = {}
    for world, multi_pod in MESH_WORLDS:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        names, sizes = mesh_axes(mesh)
        want = (2, 16, 16) if multi_pod else (16, 16)
        if tuple(mesh.shape) != want:
            raise SystemExit(f"[mesh] make_production_mesh gave {tuple(mesh.shape)}, want {want}")
        configs = {}
        for arch in ARCH_IDS:
            model = build_model(get_config(arch), device="meta")
            specs = param_specs(model, DEFAULT_RULES, mesh)
            total = per_device = sharded = 0
            for name, p in model.named_parameters():
                ways = math.prod(sizes[a] for e in specs[name] if e is not None
                                 for a in ((e,) if isinstance(e, str) else e))
                total += p.numel() * p.element_size()
                per_device += p.numel() * p.element_size() // ways
                sharded += ways > 1
            configs[arch] = {"leaves": len(specs), "sharded_leaves": sharded,
                             "param_bytes": total, "bytes_per_device": per_device}
        out[str(world)] = {"mesh": [list(names), list(mesh.shape)], "configs": configs}
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# [dryrun]: the dry run and the roofline
# ---------------------------------------------------------------------------

#: [dryrun] cells walked at full width on both production meshes, a child
#: process per group and mesh (the groups run at once, on the host's cores)
DRYRUN_GROUPS = (
    (("mixtral-8x22b", "train_4k"),),
    (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"), ("qwen2-0.5b", "decode_32k"),
     ("qwen2-0.5b", "long_500k"), ("zamba2-2.7b", "decode_32k"), ("zamba2-2.7b", "long_500k")),
    (("seamless-m4t-large-v2", "prefill_32k"),),
)
DRYRUN_SKIPS = {("qwen2-0.5b", "long_500k")}  # the reference's rule: full attention at 500k
DRYRUN_CHILD_TIMEOUT_S = 600
GEMM_N = 8192              # [dryrun]: the bf16 GEMM that measures the peak, N^3
COPY_BYTES = 4 << 30       # ... and the device-to-device copy that measures HBM
PEAK_REPS = 10
DRYRUN_DECODE = {"batch": 4, "max_len": 128, "steps": 16}  # the (1, 1) mesh decode


def dryrun_peaks(torch, dev) -> dict:
    """The card's bf16 GEMM rate (``torch.matmul`` at ``GEMM_N``^3) and its
    HBM rate (a ``COPY_BYTES`` device-to-device ``copy_``: read and
    written, ``2 * COPY_BYTES`` a copy), each the median of ``PEAK_REPS``
    calls timed by CUDA events after a warm-up."""
    def median_ms(fn):
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(PEAK_REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    g = torch.Generator(device=dev).manual_seed(SEED)
    a, b = (torch.randn((GEMM_N, GEMM_N), generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    c = torch.empty_like(a)
    gemm_ms = median_ms(lambda: torch.matmul(a, b, out=c))
    del a, b, c
    src = torch.ones(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src))
    if not torch.equal(dst[:1 << 20], src[:1 << 20]):
        fail("[dryrun] the measured copy did not copy")
    del src, dst
    torch.cuda.empty_cache()
    return {"gemm_n": GEMM_N, "gemm_ms": gemm_ms, "peak_flops": 2 * GEMM_N ** 3 / gemm_ms * 1e3,
            "copy_bytes": COPY_BYTES, "copy_ms": copy_ms,
            "hbm_bw": 2 * COPY_BYTES / copy_ms * 1e3}


def dryrun_train_walk(train_ms: float) -> dict:
    """The ``[train]`` step (qwen2-0.5b full width, seq 256 x 8, one
    device, no mesh) walked on the ``meta`` device: its counted FLOPs and
    bytes, the roofline terms from ``HW_H100``, beside
    :func:`train_bound`'s inputs and the step ``[train]`` measured."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import input_specs_train
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import HW_H100
    from repro_torch.roofline.op_cost import walk_cost
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = launch_train.resolve_config(TRAIN_ARCH, "full")
    S, B = TRAIN_DEFAULTS["seq_len"], TRAIN_DEFAULTS["global_batch"]
    model = build_model(cfg, device="meta")
    params = model.trainable()
    opt_cfg = AdamWConfig(moment_dtype=cfg.opt_moment_dtype, total_steps=10)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in input_specs_train(cfg, ShapeConfig("train", S, B, "train")).items()}
    t0 = time.perf_counter()
    _, cost = walk_cost(make_train_step(model, opt_cfg), params, init_opt_state(params, opt_cfg),
                        batch)
    bound = train_bound(cfg, B, S)
    return {"walk_s": time.perf_counter() - t0, "flops": cost.flops, "bytes": cost.bytes,
            "coll_bytes": cost.coll_bytes, "temp_size_in_bytes": cost.temp_size_in_bytes,
            "top_bytes": cost.top_ops(6), "t_compute_ms": cost.flops / HW_H100.peak_flops * 1e3,
            "t_memory_ms": cost.bytes / HW_H100.hbm_bw * 1e3,
            "bound_flops": (bound["layer_gemm_tflop"] + bound["head_tflop"]) * 1e12,
            "bound_bytes": bound["adamw_bytes"], "bound_ms": bound["bound_ms"],
            "measured_ms_per_step": train_ms}


def phase_dryrun(torch, dev, card, train_ms: float):
    """The dry run and the roofline:

    1. The card's bf16 GEMM and HBM copy rates (:func:`dryrun_peaks`),
       printed beside ``HW_H100``'s constants.
    2. In child processes under a fake process group of 256, then 512
       (one per group of :data:`DRYRUN_GROUPS` and mesh, all at once, on
       the host), the cells at full width walked on the 16 x 16 and 2 x
       16 x 16 production meshes by ``repro_torch.launch.dryrun.run_cell``
       (no device); ``report.py``'s two tables.  Every cell must be OK,
       but qwen2-0.5b ``long_500k``, which must be the reference's SKIP.
    3. The ``[train]`` step walked on one device (:func:`dryrun_train_walk`).
    4. qwen2-0.5b decode at full width in a child: ``DRYRUN_DECODE``
       steps on the (1, 1) mesh through NCCL in a world of one against as
       many unsharded steps from the same state (greedy tokens equal,
       logits within ``MESH_REL`` of the largest).
    Returns the phase's record."""
    import tempfile

    from repro_torch.roofline.analysis import HW_H100
    from repro_torch.roofline.report import dryrun_table, roofline_table

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as root:
        children = []
        for multi_pod in (False, True):
            for i, cells in enumerate(DRYRUN_GROUPS):
                name = f"cells{i}_{'2x16x16' if multi_pod else '16x16'}"
                children.append((name, subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dryrun-child", root, name,
                     str(int(multi_pod)), json.dumps(cells)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            out["peaks"] = dryrun_peaks(torch, dev)
            out["train_walk"] = dryrun_train_walk(train_ms)
            out["decode"] = _mesh_child("decode", root)
            records = []
            for name, proc in children:
                stdout, stderr = proc.communicate(timeout=DRYRUN_CHILD_TIMEOUT_S)
                if proc.returncode != 0:
                    fail(f"[dryrun] child {name} failed (rc={proc.returncode}):\n"
                         f"{stdout[-3000:]}\n{stderr[-3000:]}")
                with open(os.path.join(root, f"{name}.json")) as f:
                    records += json.load(f)
        finally:
            for _, proc in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    out["phase_s"] = time.perf_counter() - t0
    for r in records:
        want = "SKIP" if (r["arch"], r["shape"]) in DRYRUN_SKIPS else "OK"
        if r["status"] != want:
            fail(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: {r['status']}, want {want}")
    out["records"] = records
    pk, tw, dec = out["peaks"], out["train_walk"], out["decode"]
    print(f"[dryrun] {card}: bf16 GEMM {GEMM_N}^3 {pk['gemm_ms']:.3f} ms = "
          f"{pk['peak_flops'] / 1e12:.1f} TFLOP/s (HW_H100.peak_flops "
          f"{HW_H100.peak_flops / 1e12:.1f}); copy {COPY_BYTES >> 30} GiB {pk['copy_ms']:.3f} ms = "
          f"{pk['hbm_bw'] / 1e12:.3f} TB/s read + write (HW_H100.hbm_bw "
          f"{HW_H100.hbm_bw / 1e12:.3f})")
    print("[dryrun] cells walked (fake process groups of 256 and 512; terms from HW_H100, "
          f"{card}):")
    print(dryrun_table(records))
    print(roofline_table(records))
    print("[dryrun] walk_s: " + ", ".join(f"{r['arch']} {r['shape']} {r['mesh']} {r['walk_s']}"
                                          for r in records if r["status"] == "OK"))
    print(f"[dryrun] [train] step walked on one device: {tw['flops']:.4e} FLOPs, "
          f"{tw['bytes']:.4e} bytes -> compute {tw['t_compute_ms']:.2f} ms, memory "
          f"{tw['t_memory_ms']:.2f} ms (HW_H100); train_bound: {tw['bound_flops']:.4e} GEMM "
          f"FLOPs, {tw['bound_bytes']:.4e} AdamW bytes, {tw['bound_ms']:.2f} ms; measured "
          f"{tw['measured_ms_per_step']:.1f} ms a step")
    print(f"[dryrun] qwen2-0.5b decode, {DRYRUN_DECODE['steps']} steps: tokens equal on the "
          f"(1, 1) mesh; logits {dec['max_abs_diff']:.3g} apart (largest {dec['max_logit']:.3g}); "
          f"ms a step {dec['ms_plain']:.2f} unsharded, {dec['ms_mesh']:.2f} on the mesh")
    print(json.dumps({"dryrun": {k: v for k, v in out.items() if k != "records"}}))
    return out


def dryrun_child(root: str, name: str, multi_pod: str, cells: str) -> None:
    """A ``[dryrun]`` child: walk ``cells`` on a production mesh over a
    fake process group; writes ``ROOT/NAME.json``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.launch.dryrun import production_mesh, run_cell

    mesh = production_mesh(bool(int(multi_pod)))
    recs = [run_cell(arch, shape, mesh, verbose=False) for arch, shape in json.loads(cells)]
    with open(os.path.join(root, f"{name}.json"), "w") as f:
        json.dump(recs, f)


def mesh_child_decode(root: str) -> dict:
    """qwen2-0.5b at full width (bf16, seed 0): ``DRYRUN_DECODE`` greedy
    decode steps without a mesh, then from the same parameters and a
    fresh cache on the (1, 1) mesh of a world of one through NCCL."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.dryrun import _cache_shardings, place
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.procgroup import destroy_process_group, init_process_group
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_process_group("nccl", store_path=os.path.join(root, "store_decode"), rank=0,
                       world_size=1)
    try:
        mesh = make_test_mesh(data=1, model=1, device_type="cuda")
        cfg = launch_train.resolve_config(TRAIN_ARCH, "full")
        B, L, steps = (DRYRUN_DECODE[k] for k in ("batch", "max_len", "steps"))
        model = build_model(cfg, device=dev).init(SEED)
        first = torch.arange(B, dtype=torch.int32, device=dev) * 7919 % cfg.vocab_size
        rows = sh.placements((sh.DEFAULT_RULES.resolve("batch", mesh, B),), mesh)

        def run(cache, on_mesh):
            tokens, logits, ms = first, [], []
            for t in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    lg, cache = model.decode_step(cache, sh.distribute(tokens, mesh, rows)
                                                  if on_mesh else tokens, t)
                lg = sh.full_tensor(lg).float()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg)
                tokens = lg.argmax(-1).to(torch.int32)
            return torch.stack(logits), statistics.median(ms[1:])

        plain, ms_plain = run(model.init_cache(B, L), False)
        sh.shard_model(model, mesh)
        with sh.use_rules(mesh):
            cache = model.init_cache(B, L)
            meshed, ms_mesh = run(place(cache, _cache_shardings(cache, sh.DEFAULT_RULES, mesh)),
                                  True)
        diff, top = float((meshed - plain).abs().max()), float(plain.abs().max())
        if not torch.equal(meshed.argmax(-1), plain.argmax(-1)):
            raise SystemExit("[dryrun] decode on the (1, 1) mesh chose other tokens")
        if not diff <= MESH_REL * top:
            raise SystemExit(f"[dryrun] decode on the (1, 1) mesh: logits {diff} apart, largest "
                             f"{top}")
        return {"steps": steps, "batch": B, "max_abs_diff": diff, "max_logit": top,
                "bit_equal": diff == 0.0, "ms_plain": ms_plain, "ms_mesh": ms_mesh}
    finally:
        destroy_process_group()


def main_path_shapes(spec, dev):
    """Every distinct (kernel, lanes, rows, planes) among the 52 region
    launches of one ``tempi`` exchange: its geometry, the first region
    that launches it, and its launches per exchange."""
    from repro_torch.comm import Communicator, policy_for_mode
    from repro_torch.halo import make_halo_plan

    return plan_shapes(make_halo_plan(spec, Communicator(policy=policy_for_mode("tempi"),
                                                         device=dev)))


def plan_shapes(plan):
    """:func:`main_path_shapes` for the exchange of any halo plan.  A
    region that is one contiguous run is a slice copy (no kernel)."""
    from repro_torch.halo import DIRECTIONS
    from repro_torch.kernels.geometry import plan_geometry

    shapes = {}
    for d, strat, send_ct, recv_ct in zip(DIRECTIONS, plan.strategies, plan.send_cts,
                                          plan.recv_cts):
        if send_ct.block.ndims == 1 and recv_ct.block.ndims == 1:
            continue
        for side, ct in (("pack", send_ct), ("unpack", recv_ct)):
            kernel = f"{side}_{strat.name}"
            if kernel not in KERNEL_INFO:
                fail(f"tempi picked {strat.name!r} for region {d}: no kernel to time")
            geom = plan_geometry(ct.block)
            key = (kernel, geom.lanes, geom.rows, geom.planes)
            shapes.setdefault(key, {"kernel": kernel, "geom": geom, "region": d,
                                    "launches": 0})["launches"] += 1
    return list(shapes.values())


def face_shapes(spec, dev):
    """The x-, y- and z-face send and receive geometries of the full-width
    halo (directions (0,0,1), (0,1,0), (1,0,0))."""
    from repro_torch.comm import Communicator
    from repro_torch.halo import make_halo_types
    from repro_torch.kernels.geometry import plan_geometry

    types = make_halo_types(spec, Communicator(device=dev))
    faces = {}
    for name, d in (("x", (0, 0, 1)), ("y", (0, 1, 0)), ("z", (1, 0, 0))):
        send_ct, recv_ct = types[d]
        faces[name] = (plan_geometry(send_ct.block), plan_geometry(recv_ct.block))
    return faces


def sector_bytes(kernel, geom):
    """Bytes one buffer's block costs in 32-byte sectors (the buffer
    starts on a sector boundary): a pack reads every sector the block
    touches and writes the packed bytes; an unpack reads the packed
    bytes, writes back every sector it touches and first fills each
    sector it writes only in part."""
    from repro_torch.kernels.pack import SECTOR_BYTES, block_sectors

    touched, whole = block_sectors(geom)
    if kernel.startswith("pack"):
        return SECTOR_BYTES * touched + geom.packed_bytes
    return geom.packed_bytes + SECTOR_BYTES * (2 * touched - whole)


def time_kernel(torch, timer, kernel, geom, words):
    """Times of one kernel at one geometry on the float32 state ``words``
    (``(R, n)``): the kernel, its plain version, one PyTorch strided copy
    of the same bytes, and two bounds at HBM rate: the block bytes read
    and written, and the sectors they touch (:func:`sector_bytes`)."""
    from repro_torch.kernels.pack import pack_dma, pack_plain, pack_rows
    from repro_torch.kernels.unpack import unpack_dma, unpack_plain, unpack_rows
    from repro_torch.measure import time_fn

    R = words.shape[0]
    state = words.view(torch.uint8)
    if geom.word_bytes != 4:
        fail(f"{kernel} at {geom}: word {geom.word_bytes}, expected 4-byte words")
    packed = torch.empty((R, geom.packed_bytes), dtype=torch.uint8, device=words.device)
    strided = words.view(torch.int32).as_strided(
        (R, geom.planes, geom.rows, geom.lanes),
        (words.stride(0), geom.plane_rows * geom.pitch, geom.pitch, 1),
        geom.q * geom.pitch + geom.r,
    )
    pk_words = packed.view(torch.int32).view(R, geom.planes, geom.rows, geom.lanes)
    fn = {"pack_rows": pack_rows, "pack_dma": pack_dma,
          "unpack_rows": unpack_rows, "unpack_dma": unpack_dma}[kernel]
    if kernel.startswith("pack"):
        fns = (lambda: fn(state, geom, packed), lambda: pack_plain(state, geom, packed),
               lambda: strided.contiguous())
    else:
        fns = (lambda: fn(state, packed, geom), lambda: unpack_plain(state, packed, geom),
               lambda: strided.copy_(pk_words))
    ms, plain_ms, library_ms = (timer.ms(f) for f in fns)
    # the port's own timer: N back-to-back launches between two
    # synchronizations, L2 left warm, the host's enqueue included
    ms_fn, library_ms_fn = (time_fn(f, iters=TIME_FN_ITERS) * 1e3 for f in (fns[0], fns[2]))
    if state.stride(0) % 32:
        fail(f"state buffers {state.stride(0)} bytes apart: not on sector boundaries")
    nbytes, sectors = R * geom.packed_bytes, R * sector_bytes(kernel, geom)
    row = {"kernel": kernel, "lanes": geom.lanes, "rows": geom.rows, "planes": geom.planes,
           "pitch": geom.pitch, "batch": R, "bytes": 2 * nbytes, "sector_bytes": sectors,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "time_fn_ms": ms_fn, "library_time_fn_ms": library_ms_fn,
           "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_sectors_ms": sectors / HBM_BYTES_PER_S * 1e3}
    row["vector_bytes"], row["path"], tile_rows = kernel_launch(kernel, geom, state, packed)
    if tile_rows is not None:
        row["tile_rows"] = tile_rows
    return row


#: rows per tile the dma kernels are timed at at the x faces: 256
#: threads with 2, 4 and 8 rows each (dma_args picks 512)
DMA_TILE_SWEEP = (512, 1024, 2048)


def dma_tile_sweep(torch, timer, faces, words):
    """Both dma kernels at the x-face shape at each size of
    :data:`DMA_TILE_SWEEP`, launched through their C entries, each held
    bit-exact against the plain version first: ms by kernel and size."""
    from repro_torch.kernels.pack import dma_args, launch, pack_plain
    from repro_torch.kernels.unpack import unpack_plain

    R, state = words.shape[0], words.view(torch.uint8)
    times = {}
    for kernel, geom in (("pack_dma", faces["x"][0]), ("unpack_dma", faces["x"][1])):
        side = kernel.split("_")[0]
        packed = torch.randint(0, 256, (R, geom.packed_bytes), dtype=torch.uint8,
                               device=words.device)
        want = pack_plain(state, geom, torch.empty_like(packed)) if side == "pack" else packed
        vec, path, _ = dma_args(geom, state, packed)
        for tile in DMA_TILE_SWEEP:
            def run(tile=tile):
                launch(side, f"tempi_{kernel}", state, packed, geom, vec, path, tile)
            if side == "pack":
                packed.zero_()
            else:
                unpack_plain(state, torch.zeros_like(packed), geom)
            run()
            # an unpack of the x faces' disjoint rows packs back to its input
            got = packed if side == "pack" else pack_plain(state, geom, torch.empty_like(packed))
            if not torch.equal(got, want):
                fail(f"{kernel} at {tile} rows per tile differs from its plain version")
            times[f"{kernel}_{tile}"] = timer.ms(run)
    return times


def phase_timing(torch, dev, spec):
    """Every kernel at the x-, y- and z-face shapes, at
    each shape the ``tempi`` exchange launches it at, and at each shape
    the exchange of the s = 1 and s = 3 programs launches it at."""
    from repro_torch.comm import Communicator
    from repro_torch.halo import build_halo_program

    timer = Timer(torch, dev)
    R = spec.nranks
    words = torch.randn((R,) + spec.alloc, device=dev).view(R, -1)  # float32 state
    faces = []
    face_geoms = face_shapes(spec, dev)
    for face, (sg, rg) in face_geoms.items():
        for kernel in EXCHANGE_KERNELS:
            geom = sg if kernel.startswith("pack") else rg
            faces.append(dict(face=face, **time_kernel(torch, timer, kernel, geom, words)))
    shapes = []
    for shape in main_path_shapes(spec, dev):
        row = time_kernel(torch, timer, shape["kernel"], shape["geom"], words)
        shapes.append(dict(region=list(shape["region"]), launches_per_exchange=shape["launches"],
                           **row))
    sweep = dma_tile_sweep(torch, timer, face_geoms, words)
    # the programs at the other depths: every shape their exchange
    # launches, on a state of their own halo radius
    program_shapes = []
    for s in PROGRAM_DEPTHS:
        if s == spec.radius:
            continue  # the s = 2 program's exchange is the main path's
        prog = build_halo_program(spec.grid, spec.interior, Communicator(device=dev), steps=s)
        deep = torch.randn((R,) + prog.spec.alloc, device=dev).view(R, -1)
        for shape in plan_shapes(prog.plan):
            row = time_kernel(torch, timer, shape["kernel"], shape["geom"], deep)
            program_shapes.append(dict(steps=s, region=list(shape["region"]),
                                       launches_per_exchange=shape["launches"], **row))
        del deep
    # the timer's floor: an empty launch, and the y/z-face row kernels and
    # library call after a flush that leaves L2 clean
    clean = Timer(torch, dev, clean_l2=True)
    floor = {"empty_launch_ms": timer.ms(lambda: torch.cuda._sleep(0)),
             "empty_launch_ms_clean_l2": clean.ms(lambda: torch.cuda._sleep(0))}
    for face, (sg, rg) in face_geoms.items():
        if face != "x":
            for kernel, geom in (("pack_rows", sg), ("unpack_rows", rg)):
                row = time_kernel(torch, clean, kernel, geom, words)
                floor[f"{kernel}_{face}_ms_clean_l2"] = row["ms"]
                floor[f"library_{kernel}_{face}_ms_clean_l2"] = row["library_ms"]
    del words, timer, clean
    torch.cuda.empty_cache()
    return faces, shapes, program_shapes, floor, sweep


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.halo import HaloSpec

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {name}; {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    timings = {"build_s": phase_build()}
    spec = HaloSpec(grid=(2, 2, 2), interior=(256, 256, 256), radius=2)
    check = KernelCheck(torch, dev)
    phase_kernels(torch, dev, spec, check)
    stencil = phase_stencil(torch, dev, check, card)
    stencil_pair = phase_stencil_pair(torch, dev, check, card)
    counts, replayed = phase_main(torch, dev, spec, timings)
    measure, measured = phase_measure(torch, dev, spec, card)
    program, program_window_ms = phase_program(torch, dev, spec, card, measured)
    dist = phase_dist(torch, dev, card)
    compress = phase_compress(torch, dev, spec, card)
    tiered = phase_tiered(torch, dev, spec, card, measured)
    obs = phase_obs(torch, dev, spec, card, program_window_ms)
    smoother = phase_smoother(torch, dev, card, measured)
    serve = phase_serve(torch, dev, card, measured)
    train, train_ms = phase_train(torch, dev, card, measured)
    families = phase_families(torch, dev, card)
    recurrent = phase_recurrent(torch, dev, card, measured)
    mesh = phase_mesh(torch, dev, card)
    dryrun = phase_dryrun(torch, dev, card, train_ms)
    faces, shapes, program_shapes, floor, sweep = phase_timing(torch, dev, spec)

    by_phase = {"main_loop": counts, "main_loop_replayed": replayed, "program": program,
                "dist": dist, "compress": compress,
                "tiered": tiered, "obs": obs, "smoother": smoother, "serve": serve,
                "train": train, "families": families, "recurrent": recurrent}
    kernels = []
    for kernel, (source, replaces) in KERNEL_INFO.items():
        launches = {f"launches_{k}": v.get(kernel, 0) for k, v in by_phase.items()}
        row = {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(launches.values()), "max_abs_err": check.err[kernel],
               **launches,
               "launches_calibration": measure["calibration_launches"][kernel],
               "launches_measured_exchanges": measure["exchange_launches"][kernel]}
        if kernel in ("stencil", "stencil_pairs"):
            kernels.append({**row, **(stencil if kernel == "stencil" else stencil_pair)})
            continue
        mine = [f for f in faces if f["kernel"] == kernel]
        kernels.append({
            **row,
            "ms": sum(f["ms"] for f in mine), "plain_ms": sum(f["plain_ms"] for f in mine),
            "bound_ms": sum(f["bound_ms"] for f in mine), "bound_by": "bytes",
            "bound_sectors_ms": sum(f["bound_sectors_ms"] for f in mine),
            "library_ms": sum(f["library_ms"] for f in mine),
            "time_fn_ms": sum(f["time_fn_ms"] for f in mine),
            "library_time_fn_ms": sum(f["library_time_fn_ms"] for f in mine),
            "ms_per_tempi_exchange": sum(r["ms"] * r["launches_per_exchange"]
                                         for r in shapes if r["kernel"] == kernel),
            "ms_per_program_exchange": {
                s: sum(r["ms"] * r["launches_per_exchange"] for r in program_shapes
                       if r["kernel"] == kernel and r["steps"] == s)
                for s in PROGRAM_DEPTHS if s != spec.radius},
        })
    for f in faces:
        print(json.dumps({"face": f, "card": card}))
    for r in shapes:
        print(json.dumps({"main_path_shape": r, "card": card}))
    for r in program_shapes:
        print(json.dumps({"program_shape": r, "card": card}))
    print(json.dumps({"timer_floor": floor, "card": card}))
    print(json.dumps({"dma_tile_sweep": sweep, "card": card}))
    timings["mesh_s"] = mesh["phase_s"]
    timings["dryrun_s"] = dryrun["phase_s"]
    timings["total_s"] = time.perf_counter() - t_start
    print(json.dumps({"timings": timings, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        mesh_child(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child(*sys.argv[2:6])
        sys.exit(0)
    sys.exit(main())
