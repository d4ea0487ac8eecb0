"""A NumPy model of the segment kernel's persistent pass 3
(``cols_inverse_ring`` and ``Pass3`` in ``csrc/segment_filter.cuh``): its
CTAs walk (pair, column tile) items and bring each item's tile of the
scratch into a ring of shared-memory stages by 2-D tile copies through a
tensor map, ahead of the item being transformed.

The CUDA pass runs only on the card; this model repeats its index maths
and its program order, in every mode (f64, f32, i16) and at every split
``with_split`` dispatches (B = 2^2 .. 2^26):

- ``Pass3``'s sizes: the stage (the tile, the size of ``Cols``' exchange
  tile, which it replaces), the tables and barriers after the stages, the
  ring's depth (none where ``Cols`` aims at two or more CTAs an SM or a
  tile's row is not a multiple of 16 bytes, else what a CTA's shared
  memory holds beside its tables, at most 2), and that it fits a CTA
  (227 KB) and the CTA an SM it aims for;
- which mode and split take a ring: f64 from 512-point columns, never
  f32 or i16; at the cells' f64 splits the stages and tables are the
  shared bytes of pass 1's ring;
- the walk: the CTAs take items one at a time from the chunk's counter
  (the word after the peak's), each thread 0 one item ahead of the item
  its CTA transforms; under any interleaving of the CTAs every (pair,
  column tile) of every chunk is transformed once, a CTA stops at the
  first take past the last item, and the last CTA to finish leaves the
  counter and the count of finished CTAs zero for the next chunk's
  launch, on the cells' geometries (their ragged last chunks too);
- the boxes: kBoxes boxes of at most 256 rows and 2 kW reals (a multiple
  of 16 bytes) tile an item's kW columns of its pair exactly, inside the
  tensor map of the chunk's scratch, and bring as many bytes as the
  stage's barrier expects;
- the registers: thread (t, w) reads the stage at pos<kFirst>(t, m) and
  gets what ``cols_inverse_load`` read from the scratch (with and without
  the arithmetic, and for the contiguous-run layout of the ``no_tr``
  probe through its 1-D copy); every element of a stage is read once;
- the ring's order, checked on every CTA of those walks with pass 2's
  model of a ring (``test_torch_pass2_ring``): a stage is refilled only
  after the item read from it was exchanged through, and read only once
  its own copy landed, never a phase early or late.
"""

import numpy as np
import pytest

from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from test_torch_pass1_ring import (CTA_RESERVED, CTA_SMEM_MAX, MODES, SM_SMEM, SMS,
                                   SPLITS, Pass1)
from test_torch_pass2_ring import GEOMETRIES, _Ring

# Two mbarriers and the item each stage holds.
BAR_BYTES = 32
BOX_ROWS_MAX = 256


def _pos(log, s, t, m):
    """``Fft<LOG>::pos<S>``: the row register m of thread t holds in stage s."""
    e_regs = 8 if log >= 3 else 1 << log
    nt = (1 << log) // e_regs
    r0 = log if log < 3 else (log % 3 or 3)
    lrad = r0 if s == 0 else 3
    if lrad < 3:
        return t + m * nt
    e = log - r0 - 3 * s
    return ((t >> e) << (e + 3)) | (t & ((1 << e) - 1)) | (m << e)


def _stages(log):
    return 1 if log < 3 else (log + 2) // 3


class Pass3:
    """``Pass3<T, IO, Split<l1, l2>>`` and the ``Cols`` it sits on."""

    def __init__(self, mode, l1, l2):
        f64 = mode == "f64"
        self.l1, self.l2 = l1, l2
        self.n1, self.n2 = 1 << l1, 1 << l2
        self.elem = 16 if f64 else 8                  # sizeof(Cx<T>)
        self.real = self.elem // 2
        self.E = 8 if l1 >= 3 else self.n1            # registers a thread
        self.NT = self.n1 // self.E                   # threads a column
        self.W = min(max(4096 >> l1, 1), 8, self.n2)  # Split::kTc
        self.threads = self.W * self.NT
        self.min_blocks = min(max((512 if f64 else 1024) // self.threads, 1), 16)
        table = 0 if (l1 == 13 and f64) else self.n1 - 1
        self.table_bytes = table * self.elem
        self.cols_smem = self.table_bytes + self.W * self.n1 * self.elem
        self.tiles = self.n2 // self.W
        self.stage_elems = self.W * self.n1
        self.stage_bytes = self.stage_elems * self.elem
        self.row_bytes = self.W * self.elem
        self.box_rows = min(BOX_ROWS_MAX, self.n1)
        self.boxes = self.n1 // self.box_rows
        # A ring only where one CTA holds the SM and a box's rows are a
        # multiple of 16 bytes; 0: cols_inverse, one CTA an item.
        self.depth = 0 if self.min_blocks > 1 or self.row_bytes % 16 else min(max(
            (CTA_SMEM_MAX - self.table_bytes - BAR_BYTES) // self.stage_bytes, 1), 2)
        # The stages from offset 0, then the tables, then the barriers and
        # the stages' items.
        self.tab_off = self.depth * self.stage_bytes
        self.bar_off = self.tab_off + self.table_bytes
        self.smem = self.bar_off + BAR_BYTES if self.depth else self.cols_smem

    def grid(self, items):
        """One CTA an item without a ring, else ``pass_grid``: at most the
        resident CTAs (one an SM)."""
        return items if self.depth == 0 else min(self.min_blocks * SMS, items)

    def first(self, arith):
        """kFirst: the stage whose positions the registers are read at."""
        return _stages(self.l1) - 1 if arith else 0

    def regs(self, t, arith=True):
        return [_pos(self.l1, self.first(arith), t, m) for m in range(self.E)]


CASES = [(mode, l1, l2) for mode in MODES for l1, l2 in SPLITS]
RING_CASES = [c for c in CASES if Pass3(*c).depth]


def _id(case):
    return f"{case[0]}-2^{case[1]}x2^{case[2]}"


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_shared_memory_fits_a_cta_and_the_ctas_an_sm_aims_for(case):
    p = Pass3(*case)
    assert p.tiles * p.W == p.n2 and p.threads <= 1024 and p.E * p.NT == p.n1
    # A stage is the exchange tile of Cols, which it replaces: every
    # thread's registers, one expect_tx.
    assert p.stage_bytes == p.threads * p.E * p.elem == p.cols_smem - p.table_bytes
    assert p.stage_bytes < 1 << 20
    assert p.smem <= CTA_SMEM_MAX
    assert p.min_blocks * (p.smem + CTA_RESERVED) <= SM_SMEM
    assert 0 <= p.depth <= 2
    assert (p.depth == 0) == (p.min_blocks > 1 or p.row_bytes % 16 != 0)
    if p.depth:
        # Tile copies land 128-byte aligned; the barriers 8-byte aligned.
        assert p.stage_bytes % 128 == 0 and p.bar_off % 8 == 0
        assert p.smem == p.depth * p.stage_bytes + p.table_bytes + BAR_BYTES
    # The wrapper's split of this B is the model's.
    assert sf.split(1 << (case[1] + case[2])) == (p.l1, p.l2)


def test_which_mode_and_split_take_a_ring():
    # 2^18: f64 runs one 512-thread CTA an SM, so it takes the ring; f32 and
    # i16 run two, with no ring, and keep cols_inverse.
    assert [Pass3(m, 9, 9).depth for m in MODES] == [2, 0, 0]
    # f64 from 512-point columns: two stages up to 4096 points, one at 8192
    # (a 128 KB stage; no tables there, they are read from device memory);
    # below 512 points two CTAs an SM.
    rings = {l1: Pass3("f64", l1, max(l1 - 1, 1)).depth for l1 in range(1, 14)}
    assert rings == {**{l1: 0 for l1 in range(1, 9)}, 9: 2, 10: 2, 11: 2, 12: 2, 13: 1}
    assert Pass3("f64", 13, 13).smem == 131_072 + BAR_BYTES
    # f32 and i16: only 8192-point columns hold one CTA an SM, and there a
    # tile is one column, 8-byte rows, which no box takes.
    for mode in ("f32", "i16"):
        assert [Pass3(mode, a, b).depth for a, b in SPLITS] == [0] * len(SPLITS)
        assert Pass3(mode, 13, 13).min_blocks == 1 and Pass3(mode, 13, 13).row_bytes == 8
    assert {(m, a) for m, a, _ in RING_CASES} == {("f64", a) for a in range(9, 14)}
    assert set(RING_GEOMETRIES) == {"hires96k", "long96k", "one-pair", "two-pairs-long"}


# The f64 splits of the cells: hires96k's 512 x 512 (B = 2^18) and
# long96k's 1024 x 512 (B = 2^19): column tile, threads, stages and tables,
# shared bytes, tiles a pair, boxes an item and a box row's bytes.
CELL_SPLITS = {
    "hires96k-9x9": ((9, 9), 8, 512, 139_248, 139_280, 64, 2, 128),
    "long96k-10x9": ((10, 9), 4, 512, 147_440, 147_472, 128, 4, 64),
}


@pytest.mark.parametrize("name", CELL_SPLITS)
def test_the_f64_ring_at_each_cells_split(name):
    (l1, l2), w, threads, ring_and_tables, smem, tiles, boxes, row = CELL_SPLITS[name]
    p = Pass3("f64", l1, l2)
    assert (p.W, p.threads, p.depth, p.tiles, p.boxes, p.row_bytes) == (
        w, threads, 2, tiles, boxes, row)
    # Two 64 KB stages and the tables: the shared bytes of pass 1's ring at
    # the same split (its tables and exchange tile and two stages), so the
    # L1 keeps the same room; the two mbarriers and the stages' items on
    # top.
    assert p.stage_bytes == 65_536
    assert 2 * p.stage_bytes + p.table_bytes == ring_and_tables == Pass1("f64", l1, l2).smem
    assert p.smem == smem == ring_and_tables + BAR_BYTES
    assert p.min_blocks == 1 and p.grid(10 ** 6) == SMS
    assert sf.split(1 << (l1 + l2)) == (l1, l2)


class _Counter:
    """The two words after the peak's: the chunk's next item and the CTAs
    that finished, both zero at a launch's start."""

    def __init__(self):
        self.next = self.done = 0

    def take(self, items):
        """``Pass3::take``: an atomicAdd on the next item."""
        it, self.next = self.next, self.next + 1
        return it if it < items else -1

    def finish(self, grid):
        """A CTA's end: the last of ``grid`` zeroes both words."""
        old, self.done = self.done, self.done + 1
        if old == grid - 1:
            self.next = self.done = 0


def _cta(p, ring, words, items, grid, got):
    """``cols_inverse_ring``'s loop for one CTA, in program order, as a
    generator that yields where other CTAs may run (a barrier, a take):
    thread 0's prologue, then in each item a fence and a barrier, the take
    and copy into the stage used one item earlier, the item of this stage
    (past a second barrier with one stage), its wait, reads and
    exchanges."""
    d = p.depth
    held = [None] * d
    for k in range(d - 1):
        held[k] = words.take(items)
        if held[k] >= 0:
            ring.load(held[k], k)
        yield
    stage, phase = 0, 0
    while True:
        ring.barrier()
        yield
        fill = d - 1 if stage == 0 else stage - 1
        held[fill] = words.take(items)
        if held[fill] >= 0:
            ring.load(held[fill], fill)
        yield
        it = held[stage]
        if it < 0:
            break
        ring.wait_read(it, stage, phase)
        ring.exchange(stage)
        got.append(it)
        stage += 1
        if stage == d:
            stage, phase = 0, phase ^ 1
    words.finish(grid)


def _run_chunk(p, items, grid, words, rng):
    """Every CTA of one launch, stepped in a random interleaving; the items
    each CTA transformed, in its order."""
    got = [[] for _ in range(grid)]
    rings = [_Ring(p.depth) for _ in range(grid)]
    live = {b: _cta(p, rings[b], words, items, grid, got[b]) for b in range(grid)}
    while live:
        b = list(live)[rng.integers(len(live))]
        try:
            next(live[b])
        except StopIteration:
            del live[b]
    for ring, mine in zip(rings, got):
        assert ring.read == mine and sum(ring.uses) == len(mine)
        assert all(ring.landed)        # no copy left in flight
    return got


# The f64 calls of test_torch_pass2_ring's geometries (the CD cells' f32
# and i16 keep cols_inverse, one CTA an item).
RING_GEOMETRIES = [n for n, (mode, split, _) in GEOMETRIES.items()
                   if Pass3(mode, *split).depth]


@pytest.mark.parametrize("name", RING_GEOMETRIES)
def test_the_counter_gives_every_item_of_every_chunk_once(name):
    # The chunks of one call in turn on the same two words, as the C loop
    # launches them.
    mode, split, chunks = GEOMETRIES[name]
    p = Pass3(mode, *split)
    rng = np.random.default_rng(len(chunks))
    words = _Counter()
    for np_ in chunks:
        items = np_ * p.tiles
        grid = p.grid(items)
        got = _run_chunk(p, items, grid, words, rng)
        assert sorted(it for mine in got for it in mine) == list(range(items))
        # Each item's (pair, tile) is its index's.
        assert all(it == (it >> (p.tiles.bit_length() - 1)) * p.tiles
                   + (it & (p.tiles - 1)) for mine in got for it in mine)
        assert (words.next, words.done) == (0, 0)


@pytest.mark.parametrize("case", RING_CASES, ids=map(_id, RING_CASES))
def test_the_counter_covers_small_chunks_at_every_split(case):
    # Fewer items than resident CTAs, a CTA alone, and a few CTAs, each
    # launch on the words the one before left.
    p = Pass3(*case)
    rng = np.random.default_rng(p.l1 * 16 + p.l2)
    words = _Counter()
    for np_ in (1, 2, 5):
        items = np_ * p.tiles
        for grid in sorted({p.grid(items), 1, min(7, items)}):
            got = _run_chunk(p, items, grid, words, rng)
            assert sorted(it for mine in got for it in mine) == list(range(items))
            assert (words.next, words.done) == (0, 0)


def _boxes(p, it):
    """The tile copies of item ``it`` (``Pass3::load``): (the stage element
    it lands at, the map's first real column, its first row) a box."""
    pl, tile = divmod(it, p.tiles)
    c0 = tile * p.W
    return [(h * p.box_rows * p.W, 2 * c0, pl * p.n1 + h * p.box_rows)
            for h in range(p.boxes)]


@pytest.mark.parametrize("case", RING_CASES, ids=map(_id, RING_CASES))
def test_the_boxes_tile_an_item_exactly(case):
    p = Pass3(*case)
    pairs = 3
    # The map: the chunk's scratch as [pairs * N1 rows, 2 * N2 reals]; a
    # box of box_rows rows of 2 kW reals. TMA's limits: at most 256 rows
    # and 256 reals a box, its rows a multiple of 16 bytes, the map's
    # row pitch too.
    rows, cols = pairs * p.n1, 2 * p.n2
    inner = 2 * p.W
    assert p.box_rows <= BOX_ROWS_MAX and inner <= 256
    assert (inner * p.real) % 16 == 0 and (cols * p.real) % 16 == 0
    # The boxes' bytes are what the stage's barrier expects.
    assert p.boxes * p.box_rows * inner * p.real == p.stage_bytes
    items = pairs * p.tiles
    for it in range(items) if items <= 512 else (0, 1, p.tiles - 1, p.tiles, items - 1):
        pl, tile = divmod(it, p.tiles)
        boxes = _boxes(p, it)
        # Every box at the tile's columns, their rows end to end over the
        # pair's N1 rows, each landing right after the one before.
        assert all(c == 2 * tile * p.W for _, c, _ in boxes)
        starts = [r for _, _, r in boxes]
        assert starts == list(range(pl * p.n1, (pl + 1) * p.n1, p.box_rows))
        assert starts[-1] + p.box_rows <= rows and 2 * (tile + 1) * p.W <= cols
        assert [d for d, _, _ in boxes] == [
            h * p.box_rows * p.W for h in range(p.boxes)]
        assert p.boxes * p.box_rows * p.W == p.stage_elems


def _tile_copy(p, it):
    """The stage after item ``it``'s copies, as the real index of the
    tensor map's [rows, 2 * N2] reals (the chunk's scratch) each real of
    the stage came from: each box row-major, 2 kW reals a row."""
    stage = np.empty(2 * p.stage_elems, dtype=np.int64)
    box = np.arange(p.box_rows)[:, None] * 2 * p.n2 + np.arange(2 * p.W)[None, :]
    for dst, c, r in _boxes(p, it):
        stage[2 * dst:2 * dst + box.size] = (r * 2 * p.n2 + c + box).reshape(-1)
    return stage


def _threads(p, arith=True):
    """Each thread's stage element of each register, and its rows."""
    tid = np.arange(p.threads)
    t, w = tid >> (p.W.bit_length() - 1), tid & (p.W - 1)
    rows = np.array([p.regs(tt, arith) for tt in range(p.NT)])[t]     # [threads, E]
    return rows * p.W + w[:, None], rows, w[:, None]


@pytest.mark.parametrize("arith", [True, False], ids=["shipped", "no_arith"])
@pytest.mark.parametrize("case", RING_CASES, ids=map(_id, RING_CASES))
def test_the_stage_gives_each_thread_what_cols_inverse_load_read(case, arith):
    p = Pass3(*case)
    pairs = 3
    at, rows, w = _threads(p, arith)
    # Every element of a stage is read once.
    assert np.array_equal(np.sort(at, axis=None), np.arange(p.stage_elems))
    for it in sorted({0, 1, p.tiles - 1, p.tiles, pairs * p.tiles - 1}):
        pl, tile = divmod(it, p.tiles)
        c0 = tile * p.W
        stage = _tile_copy(p, it)
        # cols_inverse_load: blk[p * N2 + c0 + w], blk the pair's scratch;
        # its real and imaginary parts, the two reals of the stage element.
        want = pl * p.n1 * p.n2 + rows * p.n2 + c0 + w
        np.testing.assert_array_equal(stage[2 * at], 2 * want)
        np.testing.assert_array_equal(stage[2 * at + 1], 2 * want + 1)


@pytest.mark.parametrize("split", [(9, 9), (10, 9)])
def test_the_tile_copies_bring_the_scratch_values(split):
    # The data itself at the cells' two f64 splits, two pairs: the boxes
    # copied from the scratch as the map sees it (complex128 as pairs of
    # float64) and read at the threads' registers equal cols_inverse_load's
    # reads of the pair's column.
    p = Pass3("f64", *split)
    rng = np.random.default_rng(11)
    scratch = (rng.standard_normal((2, p.n1, p.n2))
               + 1j * rng.standard_normal((2, p.n1, p.n2)))
    reals = scratch.reshape(-1).view(np.float64)
    at, rows, w = _threads(p)
    for it in (0, 1, p.tiles - 1, p.tiles, 2 * p.tiles - 1):
        pl, tile = divmod(it, p.tiles)
        stage = reals[_tile_copy(p, it)].view(np.complex128)
        np.testing.assert_array_equal(stage[at], scratch[pl][rows, tile * p.W + w])


@pytest.mark.parametrize("case", RING_CASES, ids=map(_id, RING_CASES))
def test_a_contiguous_tile_comes_by_one_bulk_copy(case):
    # The no_tr probe (kStrided off): a tile is one run of the pair's
    # scratch at c0 * N1, element (p, w) at p * kW + w; one 1-D bulk copy of
    # the stage's bytes brings it, and the registers read from the stage are
    # cols_inverse_load's kStrided = false reads.
    p = Pass3(*case)
    pairs = 2
    assert p.stage_bytes % 16 == 0
    at, rows, w = _threads(p)
    for it in (0, p.tiles - 1, pairs * p.tiles - 1):
        pl, tile = divmod(it, p.tiles)
        c0 = tile * p.W
        src = pl * p.n1 * p.n2 + c0 * p.n1            # the run's first element
        assert (src * p.elem) % 16 == 0
        stage = src + np.arange(p.stage_elems)         # what the copy brings
        want = pl * p.n1 * p.n2 + c0 * p.n1 + rows * p.W + w
        np.testing.assert_array_equal(stage[at], want)
