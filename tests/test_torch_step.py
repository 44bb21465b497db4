"""K4 ``sketch_step``'s layout on the CPU: the split of R's rows over the
row-tile blocks of a slice and over their warps, the sums each lane
finishes, the trace partials and the arrival-counter protocol that sums
them in tile order, and the wrapper's counters, zeroed once.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there, two launches bitwise equal, and
``tools/chip_mutants.py`` breaks it on purpose); these tests keep the
Python mirror of its layout honest: the constants are read from
``csrc/sketch_step.cu`` and its index arithmetic and counter protocol are
replayed in Python.  The plain step's parity with the JAX reference is in
``test_torch_kernels.py``.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, sketch_traces
import torch_threads  # noqa: F401  (the worker's share of the cores)

CU = (Path(sketch_traces.__file__).resolve().parent / "csrc" /
      "sketch_step.cu").read_text()


def _cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def test_layout_constants_mirror_the_kernel_source():
    assert sketch_traces.STEP_THREADS == _cu_const("THREADS")
    assert sketch_traces.STEP_GROUP_SUMS == _cu_const("GROUP_SUMS")
    assert sketch_traces.STEP_WARPS == sketch_traces.STEP_THREADS // 32
    # K5's row group: the same rows a warp, so the same order of every sum
    for p in (1, 8, 9, 16):
        assert sketch_traces.step_rows_a_warp(p) == \
            sketch_traces.chain_rows_a_warp(p)
    # a V tile holds whole k steps of every instantiation (32 VEC columns,
    # VEC = 1, 4 or 8)
    assert _cu_const("KT") % 256 == 0


def _warp_rows(n: int, p: int):
    """The kernel's split: block `tile` of a slice, warp w, owns rows
    [row0, row0 + rows) with row0 = tile BLOCK_ROWS + w ROWS and rows =
    max(0, min(ROWS, n - row0))."""
    per = sketch_traces.step_rows_a_warp(p)
    block_rows = sketch_traces.STEP_WARPS * per
    out = []
    for tile in range(sketch_traces.step_tiles(n, p)):
        for w in range(sketch_traces.STEP_WARPS):
            row0 = tile * block_rows + w * per
            rows = max(0, min(per, n - row0))
            out.append((tile, w, list(range(row0, row0 + rows))))
    return out


@pytest.mark.parametrize("p", [1, 8, 9, 16])
def test_every_row_has_exactly_one_warp(p):
    for n in list(range(1, 300)) + [1024, 4096, 1000, 4095]:
        split = _warp_rows(n, p)
        rows = [r for _, _, rs in split for r in rs]
        assert sorted(rows) == list(range(n))
        # no block is empty: the last tile holds the ragged edge
        last = max(t for t, _, _ in split)
        assert any(rs for t, _, rs in split if t == last)


@pytest.mark.parametrize("n,p,batch", [(1024, 8, 40), (1024, 8, 20),
                                       (4096, 8, 4), (300, 5, 3),
                                       (37, 12, 2), (5, 1, 1)])
def test_every_partial_has_exactly_one_block(n, p, batch):
    """Block (tile, b) writes partial[b, tile] of a [batch, tiles] buffer:
    each entry exactly once, and the last block of a slice reads that
    slice's entries only."""
    tiles = sketch_traces.step_tiles(n, p)
    written = np.zeros(batch * tiles, dtype=int)
    for b in range(batch):
        for tile in range(tiles):
            written[b * tiles + tile] += 1
    assert np.all(written == 1)
    if (n, p, batch) == (1024, 8, 40):
        assert tiles == 16 and batch * tiles == 640


@pytest.mark.parametrize("pb", [8, 16])
def test_each_sum_lands_on_exactly_one_lane(pb):
    """After the reduce-scatter lane L holds the sums i = 2 L + m, m < 2,
    of the warp's [rows a warp, PB] group: row i // PB, column i % PB."""
    per = sketch_traces.STEP_GROUP_SUMS // pb
    per_lane = sketch_traces.STEP_GROUP_SUMS // 32
    seen = [(i // pb, i % pb) for lane in range(32)
            for i in (lane * per_lane + m for m in range(per_lane))]
    assert sorted(seen) == [(j, c) for j in range(per) for c in range(pb)]


def _launch_model(partials, counter, order):
    """One launch of the counter protocol for one slice, blocks arriving
    in ``order``: each stores its partial, then adds one to the counter;
    the block that sees tiles - 1 adds the partials in tile order (fp32)
    and sets the counter back to zero.  Returns (t, counter)."""
    tiles = len(partials)
    stored = [None] * tiles
    t = None
    for tile in order:
        stored[tile] = partials[tile]
        arrived, counter = counter, counter + 1
        if arrived == tiles - 1:
            assert all(v is not None for v in stored)
            s = np.float32(0)
            for v in stored:
                s = np.float32(s + v)
            t = s
            counter = 0
    return t, counter


def test_counter_protocol_sums_in_tile_order_and_resets():
    """Whatever order the blocks arrive in, the trace is the partials'
    sum in tile order, bit for bit, and the counter is zero again, so a
    second launch on the same counter gives the same trace; a counter left
    unreset gives none."""
    src = CU
    assert "atomicAdd(counter + b, 1) == tiles - 1" in src
    assert "for (int i = 0; i < tiles; ++i)" in src
    assert "atomicExch(counter + b, 0);" in src
    rng = np.random.default_rng(0)
    for tiles in (1, 2, 5, 16, 64):
        partials = rng.standard_normal(tiles).astype(np.float32) * 1e3
        want = None
        counter = 0
        for _ in range(6):
            t, counter = _launch_model(partials, counter,
                                       rng.permutation(tiles))
            assert counter == 0
            if want is None:
                want = t
            assert t.tobytes() == want.tobytes()
        # without the reset the second launch never sees tiles - 1
        t, left = _launch_model(partials, 0, range(tiles))
        t2, _ = _launch_model(partials, left + tiles, range(tiles))
        assert t2 is None


def test_step_wrapper_zeroes_its_counters_once(monkeypatch):
    """The wrapper (its kernel launch stood in for) allocates each
    (device, stream)'s counters once, zeroed, and reuses them: no fill per
    call; a larger batch grows them once; another stream has its own."""
    r = torch.zeros((3, 100, 100))
    v = torch.zeros((3, 100, 8))
    st = torch.zeros((100, 8))
    r5, v5 = torch.zeros((5, 100, 100)), torch.zeros((5, 100, 8))
    launches, zeros = [], []
    stream = [7]
    real_zeros = torch.zeros

    def counting_zeros(*a, **k):
        zeros.append(a)
        return real_zeros(*a, **k)

    monkeypatch.setattr(_build, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(_build, "check_companion", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda *a: None)
    monkeypatch.setattr(_build, "stream_handle", lambda t: stream[0])
    monkeypatch.setattr(_build, "launch",
                        lambda name, lib, sym, *args: launches.append(args))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch, "zeros", counting_zeros)
    monkeypatch.setattr(sketch_traces, "_COUNTERS", {})
    for _ in range(3):
        sketch_traces.sketch_step(r, v, st)
    assert len(zeros) == 1 and len(launches) == 3
    assert len({a[6] for a in launches}) == 1   # one counter buffer
    n_args = launches[0][7:11]
    assert n_args == (3, 100, 8, sketch_traces.step_tiles(100, 8))
    sketch_traces.sketch_step(r5, v5, st)      # grows once
    sketch_traces.sketch_step(r, v, st)
    sketch_traces.sketch_step(r5, v5, st)
    assert len(zeros) == 2
    stream[0] = 9                               # another stream
    sketch_traces.sketch_step(r, v, st)
    assert len(zeros) == 3
    assert all(c.dtype == torch.int32 and int(c.abs().sum()) == 0
               for c in sketch_traces._COUNTERS.values())
