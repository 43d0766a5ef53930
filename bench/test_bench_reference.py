"""The plain reference against hand-built periodic fields at a tiny size,
and its independence from the program."""

import ast
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import inputs, reference

ROOT = Path(__file__).resolve().parents[1]


def _hand_field(seed, grid, n):
    """The global field, rank by rank with numpy slicing."""
    pz, py, px = grid
    g = np.zeros((pz * n, py * n, px * n), np.float32)
    for r in range(pz * py * px):
        cz, cy, cx = r // (py * px), (r // px) % py, r % px
        g[cz * n:(cz + 1) * n, cy * n:(cy + 1) * n, cx * n:(cx + 1) * n] = \
            inputs.interior(seed, r, (n, n, n), "cpu").numpy()
    return g


@pytest.mark.parametrize("grid", [(2, 2, 2), (4, 1, 1), (2, 2, 1)])
def test_expected_blocks_are_the_wrapped_field(grid):
    n, radii = 5, (2, 1, 3)
    g = _hand_field(7, grid, n)
    assert np.array_equal(reference.global_field(7, grid, (n, n, n), "cpu").numpy(), g)
    padded = np.pad(g, [(r, r) for r in radii], mode="wrap")
    pz, py, px = grid
    for r in range(pz * py * px):
        c = inputs.rank_coords(r, grid)
        want = padded[c[0] * n:c[0] * n + n + 2 * radii[0], c[1] * n:c[1] * n + n + 2 * radii[1],
                      c[2] * n:c[2] * n + n + 2 * radii[2]]
        got = reference.expected_block(torch.from_numpy(g), grid, r, radii).numpy()
        assert np.array_equal(got, want)


def _hand_stencil(g, radii, weight):
    """One application with np.roll, float64, the float32 factors."""
    a, b = reference.coefficients(radii, weight)
    acc = np.zeros_like(g)
    rz, ry, rx = radii
    for d in itertools.product(range(-rz, rz + 1), range(-ry, ry + 1), range(-rx, rx + 1)):
        if d != (0, 0, 0):
            acc += np.roll(g, tuple(-x for x in d), axis=(0, 1, 2))
    return a * acc + b * g


@pytest.mark.parametrize("ops", [[((1, 1, 1), 0.4)], [((2, 1, 1), 0.5), ((1, 1, 1), 0.25)]])
def test_fft_stencil_against_hand_passes(ops):
    g = _hand_field(3, (2, 2, 2), 6).astype(np.float64)
    want = g
    for _ in range(3):
        for radii, w in ops:
            want = _hand_stencil(want, radii, w)
    got = reference.stencil_fft(torch.from_numpy(g), ops, 3).numpy()
    assert np.abs(got - want).max() < 1e-13
    direct = reference.stencil_direct(torch.from_numpy(g), ops, 3, torch.float64, torch.float32)
    assert np.abs(direct.numpy() - want).max() < 1e-13


def test_judges_zero_on_the_reference_and_catch_one_cell():
    grid, n = (2, 2, 2), (4, 4, 4)
    fields = [reference.global_field(5, grid, n, "cpu", buffer=b) for b in (0, 1)]
    assert not torch.equal(fields[0], fields[1])
    blocks = torch.stack([torch.stack([reference.expected_block(g, grid, r, (2, 2, 2))
                                       for r in range(8)]) for g in fields])
    assert reference.judge_exchange(blocks, list(range(8)), 5, grid, n, (2, 2, 2)) == \
        {"mismatched_cells": 0}
    # the buffers swapped: every cell is the other field's
    assert reference.judge_exchange(blocks.flip(0), list(range(8)), 5, grid, n, (2, 2, 2)) == \
        {"mismatched_cells": blocks.numel()}
    blocks[1, 3, 0, 1, 2] = float("nan")
    assert reference.judge_exchange(blocks, list(range(8)), 5, grid, n, (2, 2, 2)) == \
        {"mismatched_cells": 1}
    g = fields[0]
    ops = [((1, 1, 1), 0.4)]
    out = reference.stencil_fft(g.double(), ops, 4).float()
    interiors = torch.stack([out[c[0] * 4:c[0] * 4 + 4, c[1] * 4:c[1] * 4 + 4, c[2] * 4:c[2] * 4 + 4]
                             for c in (inputs.rank_coords(r, grid) for r in range(8))])
    assert reference.judge_iterate(interiors, 5, grid, ops, 4)["max_rel_err"] < 1e-6
    interiors[0, 0, 0, 0] = float("inf")
    assert reference.judge_iterate(interiors, 5, grid, ops, 4)["max_rel_err"] == float("inf")


def test_iterate_gap_is_over_the_surviving_amplitude():
    grid, n, ops = (2, 2, 2), (4, 4, 4), [((1, 1, 1), 0.4)]
    ref = reference.stencil_fft(reference.global_field(9, grid, n, "cpu", torch.float64), ops, 30)
    interiors = torch.stack([ref[c[0] * 4:c[0] * 4 + 4, c[1] * 4:c[1] * 4 + 4,
                                 c[2] * 4:c[2] * 4 + 4]
                             for c in (inputs.rank_coords(r, grid) for r in range(8))])
    scale = float(ref.abs().max())
    interiors[2, 1, 1, 1] += 1e-3 * scale
    got = reference.judge_iterate(interiors.float(), 9, grid, ops, 30)["max_rel_err"]
    assert got == pytest.approx(1e-3, rel=1e-3)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "inputs.py"):
        tree = ast.parse((ROOT / "bench" / name).read_text())
        mods = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
        mods |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
        assert not {m.split(".")[0] for m in mods} & {"repro_torch", "repro", "jax"}, (name, mods)
    code = ("import sys; import bench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
