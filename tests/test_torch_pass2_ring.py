"""A NumPy model of the segment kernel's persistent pass 2
(``rows_multiply_ring`` and ``Pass2`` in ``csrc/segment_filter.cuh``): its
CTAs walk (pair, row tile) items and bring each item's rows into a ring of
shared-memory stages, one bulk copy a stage completing on the stage's
mbarrier, ahead of the item being transformed.

The CUDA pass runs only on the card; this model repeats its index maths
and its program order, in every mode (f64, f32, i16) and at every split
``with_split`` dispatches (B = 2^2 .. 2^26):

- ``Pass2``'s sizes: row tile, threads, the tables of ``Rows``, the stage
  (one contiguous run of kR rows, the size of ``Rows``' exchange tile,
  which it replaces), the ring's depth (none where ``Rows`` aims at two or
  more CTAs an SM, else what a CTA's shared memory holds beside its tables
  and barriers, at most 2), and that it fits a CTA (227 KB) and the CTAs
  an SM aims for (228 KB, 1 KB reserved a CTA);
- which mode and split take a ring: f64 from 512-point rows, f32 and i16
  only at 8192, none at the cells' 2^18 in f32 or i16;
- the walk: CTA b of G takes items b, b + G, ... (G the resident CTAs with
  a ring, else one CTA an item), each (pair, row tile) of every chunk
  once, on the cells' geometries (their ragged last chunks too), long96k's
  1024 x 512 split among them;
- the ring's order: thread 0 starts the prologue's copies, then in each
  item, past a fence and a barrier, refills the stage used one item
  earlier, and every thread waits on this item's stage barrier with the
  phase parity the loop carries, reads its registers and exchanges
  through that stage; a stage is refilled only after every thread has
  read and exchanged through it, and read only once its own copy landed,
  never a phase early or late;
- the rows: item it's stage is scratch[it * kR * N2, +kR * N2), and the
  registers thread (r, t) reads from it at pos<0>(t, m) are the ones
  ``rows_multiply`` reads from the scratch (row tile * kR + r of the pair),
  with H's row alike; every element of a stage is read once.
"""

import numpy as np
import pytest

from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from test_torch_pass1_ring import (CTA_RESERVED, CTA_SMEM_MAX, MODES, SM_SMEM, SMS,
                                   SPLITS, _cell_chunks, _pos0)

BAR_BYTES = 16
RING_THREADS = 128


class Pass2:
    """``Pass2<T, Split<l1, l2>>`` and the ``Rows`` it sits on."""

    def __init__(self, mode, l1, l2):
        f64 = mode == "f64"
        self.l1, self.l2 = l1, l2
        self.n1, self.n2 = 1 << l1, 1 << l2
        self.E = 8 if l2 >= 3 else self.n2            # registers a thread
        self.NT = self.n2 // self.E                   # threads a row
        self.elem = 16 if f64 else 8
        # rows_multiply (Rows): kR rows a CTA, the CTAs an SM it aims at.
        rows_r = min(max(4096 >> l2, 1), 8, self.n1)  # Split::kTr
        self.rows_min_blocks = _min_blocks(rows_r * self.NT, f64)
        table = 0 if (l2 == 13 and f64) else self.n2 - 1
        self.rows_smem = (table + rows_r * self.n2) * self.elem
        self.rows_r = rows_r
        # The ring: the rows of 128 threads an item.
        self.R = min(max(RING_THREADS // self.NT, 1), rows_r)
        self.threads = self.R * self.NT
        self.min_blocks = _min_blocks(self.threads, f64)
        self.tiles = self.n1 // self.R
        self.stage_elems = self.R * self.n2
        self.stage_bytes = self.elem * self.stage_elems
        # The stages follow the tables (a stage is its item's exchange
        # tile), 16-byte aligned.
        self.ring_off = -(-table * self.elem // 16) * 16
        budget = (SM_SMEM // self.min_blocks - CTA_RESERVED if self.min_blocks > 1
                  else CTA_SMEM_MAX)
        # A ring only where rows_multiply holds the SM alone; 0: it runs as
        # it is, one CTA an item.
        self.depth = 0 if self.rows_min_blocks > 1 else min(max(
            (budget - self.ring_off - BAR_BYTES) // self.stage_bytes, 0), 2)
        self.smem = (self.ring_off + self.depth * self.stage_bytes + BAR_BYTES
                     if self.depth else self.rows_smem)

    def grid(self, items):
        """One CTA an item without a ring, else ``pass_grid``: at most the
        resident CTAs (min_blocks of them an SM)."""
        return items if self.depth == 0 else min(self.min_blocks * SMS, items)

    def regs(self, t):
        return [_pos0(self.l2, t, m) for m in range(self.E)]


def _min_blocks(threads, f64):
    """``fourstep.cuh`` min_blocks: the CTAs an SM the register cap aims at."""
    return min(max((512 if f64 else 1024) // threads, 1), 16)


CASES = [(mode, l1, l2) for mode in MODES for l1, l2 in SPLITS]


def _id(case):
    return f"{case[0]}-2^{case[1]}x2^{case[2]}"


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_shared_memory_fits_a_cta_and_the_ctas_an_sm_aims_for(case):
    p = Pass2(*case)
    assert p.tiles * p.R == p.n1 and p.rows_r % p.R == 0
    assert p.E * p.NT == p.n2 and p.threads <= 1024
    # One bulk copy a stage: 16-byte multiple, below the mbarrier's
    # transaction limit; the stage is every thread's registers.
    assert p.stage_bytes % 16 == 0 and p.stage_bytes < 1 << 20
    assert p.stage_bytes == p.threads * p.E * p.elem
    assert p.ring_off % 16 == 0
    assert p.smem <= CTA_SMEM_MAX
    if p.depth:
        # The ring's CTAs an SM, their shared memory, and registers: the
        # cap gives a thread 65,536 / (threads x CTAs), as many as
        # rows_multiply's threads had.
        assert p.min_blocks * (p.smem + CTA_RESERVED) <= SM_SMEM
        assert p.threads * p.min_blocks == p.rows_r * p.NT * p.rows_min_blocks
        assert p.threads <= RING_THREADS or p.R == 1
    else:
        assert p.rows_min_blocks * (p.smem + CTA_RESERVED) <= SM_SMEM
    assert 0 <= p.depth <= 2
    # The wrapper's split of this B is the model's.
    assert sf.split(1 << (case[1] + case[2])) == (p.l1, p.l2)


def test_which_mode_and_split_take_a_ring():
    # 2^18 in f64: rows_multiply held an SM with one CTA of 8 rows (72 KB);
    # the ring's CTAs take 2 rows (128 threads), four an SM, each 8 KB of
    # tables and two 16 KB stages (each its item's exchange tile) with
    # their barriers. f32 / i16 run two rows_multiply CTAs an SM: no ring.
    assert [Pass2(m, 9, 9).depth for m in MODES] == [2, 0, 0]
    p = Pass2("f64", 9, 9)
    assert (p.R, p.threads, p.min_blocks) == (2, 128, 4)
    assert p.smem == 8_176 + 2 * 16_384 + BAR_BYTES == 40_960
    assert p.rows_smem == 73_712
    assert Pass2("f32", 9, 9).smem == 36_856
    # f64 from 512-point rows: two stages up to 4096 points, one at 8192
    # (no tables there: they are read from device memory); below 512
    # points rows_multiply runs two CTAs an SM.
    rings = {l2: Pass2("f64", min(l2 + 1, 13), l2).depth for l2 in range(1, 14)}
    assert rings == {**{l2: 0 for l2 in range(1, 9)}, 9: 2, 10: 2, 11: 2, 12: 2, 13: 1}
    # The ring's CTAs an SM: four of 128 threads at 512 and 1024 points, two
    # of 256 at 2048, one from 4096.
    assert [Pass2("f64", 13, l2).min_blocks for l2 in (10, 11, 12, 13)] == [4, 2, 1, 1]
    assert Pass2("f64", 10, 9).min_blocks == 4
    # f32 and i16: only 8192-point rows hold one CTA an SM, with two stages.
    for mode in ("f32", "i16"):
        assert [Pass2(mode, a, b).depth for a, b in SPLITS] == \
            [2 if b == 13 else 0 for a, b in SPLITS]


# The f64 splits of the cells: hires96k's 512 x 512 (B = 2^18) and
# long96k's 1024 x 512 (B = 2^19, M = 76,800): row tile, threads, ring
# depth, shared bytes and tiles a pair.
CELL_SPLITS = {
    "hires96k-9x9": ((9, 9), 2, 128, 2, 40_960, 256),
    "long96k-10x9": ((10, 9), 2, 128, 2, 40_960, 512),
}


@pytest.mark.parametrize("name", CELL_SPLITS)
def test_the_f64_ring_at_each_cells_split(name):
    (l1, l2), r, threads, depth, smem, tiles = CELL_SPLITS[name]
    p = Pass2("f64", l1, l2)
    assert (p.R, p.threads, p.depth, p.smem, p.tiles) == (r, threads, depth, smem, tiles)
    # Four CTAs an SM, each its tables and two 16 KB stages, where
    # rows_multiply held the SM with one CTA of 8 rows.
    assert p.min_blocks == 4 and p.rows_min_blocks == 1 and p.stage_bytes == 16_384
    assert 4 * (p.smem + CTA_RESERVED) <= SM_SMEM
    assert p.grid(10 ** 6) == 4 * SMS
    assert sf.split(1 << (l1 + l2)) == (l1, l2)


def _walk(items, grid):
    return [list(range(b, items, grid)) for b in range(grid)]


# The cells' calls, as test_torch_pass1_ring's, and small calls with fewer
# items than resident CTAs.
GEOMETRIES = {
    "hires96k": ("f64", (9, 9), _cell_chunks(2, 345_600_000, 38_400, 1 << 18, 16)),
    "cd44k": ("f32", (9, 9), _cell_chunks(2, 158_760_000, 17_640, 1 << 18, 8)),
    "cd44k-i16": ("i16", (9, 9), _cell_chunks(2, 158_760_000, 17_640, 1 << 18, 8)),
    "long96k": ("f64", (10, 9), _cell_chunks(2, 345_600_000, 76_800, 1 << 19, 16)),
    "one-pair": ("f64", (9, 9), [1]),
    "two-pairs-long": ("f64", (10, 9), [2]),
}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_the_walk_takes_every_item_of_every_chunk_once(name):
    mode, split, chunks = GEOMETRIES[name]
    p = Pass2(mode, *split)
    if name in ("hires96k", "cd44k", "long96k"):
        assert len(chunks) > 1 and chunks[-1] < chunks[0]   # ragged last chunk
    log_tiles = p.tiles.bit_length() - 1
    for np_ in chunks:
        items = np_ * p.tiles
        grid = p.grid(items)
        if p.depth:
            assert grid == min(p.min_blocks * SMS, items)
        seen = np.zeros((np_, p.tiles), dtype=np.int64)
        for walk in _walk(items, grid):
            for it in walk:
                pl, tile = it >> log_tiles, it & (p.tiles - 1)
                assert it == pl * p.tiles + tile
                seen[pl, tile] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_the_walk_covers_small_chunks_at_every_split(case):
    p = Pass2(*case)
    for np_ in (1, 2, 5):
        items = np_ * p.tiles
        for grid in {p.grid(items), 1, min(7, items)}:
            got = sorted(it for w in _walk(items, grid) for it in w)
            assert got == list(range(items))


class _Ring:
    """One CTA's stages and their mbarriers, in program order: thread 0's
    copies, every thread's waits and reads, the item's exchanges through
    its stage, and the fence and barrier at the start of each item."""

    def __init__(self, depth):
        self.depth = depth
        self.item = [None] * depth       # the item a stage holds or awaits
        self.landed = [True] * depth
        self.free = [True] * depth       # no item reads or exchanges through it
        self.phases = [0] * depth        # the barrier's completed phases
        self.uses = [0] * depth
        self.exchanging = None           # the stage the current item exchanges in
        self.read = []

    def load(self, item, s):
        assert self.free[s], "refilled while an item still reads or exchanges in it"
        assert self.landed[s], "a stage holds one copy at a time"
        self.item[s], self.landed[s], self.free[s] = item, False, False

    def wait_read(self, item, s, parity):
        assert self.item[s] == item
        # The wait does not pass before the copy lands: the phase it waits
        # for is the one this copy completes.
        assert not self.landed[s] and (self.phases[s] & 1) == parity
        self.landed[s] = True                  # the copy's bytes complete
        self.phases[s] += 1
        assert (self.phases[s] & 1) != parity  # try_wait.parity passes
        self.uses[s] += 1
        assert self.phases[s] == self.uses[s]  # never a phase early or late
        self.read.append(item)

    def exchange(self, s):
        assert self.item[s] == self.read[-1] and self.landed[s]
        self.exchanging = s

    def barrier(self):
        """Every thread fenced its exchange writes and passed the barrier:
        the last item's stage is free."""
        if self.exchanging is not None:
            self.free[self.exchanging] = True
            self.exchanging = None


def _program(ring, walk):
    """``rows_multiply_ring``'s loop for one CTA that walks ``walk``."""
    d = ring.depth
    for k in range(d - 1):                     # the prologue (thread 0)
        if k < len(walk):
            ring.load(walk[k], k)
    stage, phase = 0, 0
    for i, it in enumerate(walk):
        ring.barrier()                         # every thread
        fill = d - 1 if stage == 0 else stage - 1
        if i + d - 1 < len(walk):              # thread 0
            ring.load(walk[i + d - 1], fill)
        ring.wait_read(it, stage, phase)       # every thread
        ring.exchange(stage)                   # past the first exchange's barrier
        stage += 1
        if stage == d:
            stage, phase = 0, phase ^ 1


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("n_items", [0, 1, 2, 3, 4, 5, 31])
def test_a_stage_is_refilled_only_after_its_item_was_read(depth, n_items):
    ring = _Ring(depth)
    walk = list(range(5, 5 + 132 * n_items, 132))
    _program(ring, walk)
    assert ring.read == walk
    assert sum(ring.uses) == len(walk) and all(ring.landed)


def _check_rows(p, pairs, items):
    """Items of a chunk of ``pairs`` pairs, by flat scratch index: what the
    bulk copy brings to each register thread (r, t) reads from the stage
    at pos<0>(t, m) against what rows_multiply reads (row tile * kR + r of
    the pair), the H row the thread multiplies by, and the stage read
    once whole."""
    tid = np.arange(p.threads)
    t, r = tid & (p.NT - 1), tid >> (p.NT.bit_length() - 1)
    pos = np.array([p.regs(tt) for tt in range(p.NT)])[t]     # [threads, E]
    at = r[:, None] * p.n2 + pos                               # stage element
    assert np.array_equal(np.sort(at, axis=None), np.arange(p.stage_elems))
    for it in items:
        assert 0 <= it < pairs * p.tiles
        pl, tile = it >> (p.tiles.bit_length() - 1), it & (p.tiles - 1)
        assert it == pl * p.tiles + tile
        src = it * p.stage_elems + at                          # the bulk copy
        row = tile * p.R + r                                   # rows_multiply's row
        np.testing.assert_array_equal(src, (pl * p.n1 + row[:, None]) * p.n2 + pos)
        # The H row: the same row of the pair's spectrum.
        np.testing.assert_array_equal((it & (p.tiles - 1)) * p.R + r, row)


RING_CASES = [(mode, l1, l2) for mode, l1, l2 in CASES if Pass2(mode, l1, l2).depth]


@pytest.mark.parametrize("case", RING_CASES, ids=map(_id, RING_CASES))
def test_the_rows_a_stage_delivers_are_rows_multiplys(case):
    p = Pass2(*case)
    pairs = 3
    n = pairs * p.tiles
    # Every item where a chunk has few; else both ends of each pair and a
    # middle tile.
    items = range(n) if n <= 1024 else sorted(
        {pl * p.tiles + k for pl in range(pairs) for k in (0, 1, p.tiles // 2, p.tiles - 1)})
    _check_rows(p, pairs, items)


def test_the_ring_cases_are_the_f64_and_8192_point_splits():
    assert {(m, b) for m, _, b in RING_CASES} == (
        {("f64", b) for b in (9, 10, 11, 12, 13)} | {("f32", 13), ("i16", 13)})


def test_a_bulk_copy_brings_the_scratch_rows_of_its_item():
    # The data itself at the cells' two f64 splits, two pairs: the stage
    # (one run of the scratch) read at the threads' registers equals the
    # pair's rows as rows_multiply reads them.
    rng = np.random.default_rng(7)
    for split in ((9, 9), (10, 9)):
        p = Pass2("f64", *split)
        scratch = (rng.standard_normal((2, p.n1, p.n2))
                   + 1j * rng.standard_normal((2, p.n1, p.n2)))
        flat = scratch.reshape(-1)
        tid = np.arange(p.threads)
        t, r = tid & (p.NT - 1), tid >> (p.NT.bit_length() - 1)
        pos = np.array([p.regs(tt) for tt in range(p.NT)])[t]
        for it in (0, 1, p.tiles - 1, p.tiles, 2 * p.tiles - 1):
            stage = flat[it * p.stage_elems:(it + 1) * p.stage_elems]
            got = stage[r[:, None] * p.n2 + pos]
            pl, tile = divmod(it, p.tiles)
            want = scratch[pl][(tile * p.R + r)[:, None], pos]
            np.testing.assert_array_equal(got, want)
