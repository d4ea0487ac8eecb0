"""A NumPy model of the segment kernel's pass 1 (``cols_forward`` in
``csrc/segment_filter.cuh``): a persistent column pass whose CTAs walk
(pair, column tile) items and gather each item's signal into a ring of
shared-memory stages ahead of the item being transformed.

The CUDA pass runs only on the card; this model repeats its index maths
and its program order, in every mode (f64, f32, i16) and at every split
``with_split`` dispatches (B = 2^2 .. 2^26):

- ``Pass1``'s sizes: column tile, threads, the tables and exchange tile
  of ``Cols``, the stage, the ring's depth (none where ``Cols`` aims at
  two or more CTAs an SM, else what a CTA's shared memory holds beside
  its tables and tile, at most 2), and that it fits a CTA (227 KB) and
  the CTAs an SM aims for (228 KB, 1 KB reserved a CTA);
- the walk: CTA b of G takes items b, b + G, ... (G the resident CTAs
  with a ring, else one CTA an item), each item of every chunk once, on
  the cells' geometries (their ragged last chunks too), long96k's
  1024 x 512 split among them;
- the ring's order: the prologue's gathers, then in each item a refill of
  the stage read one item earlier, a commit, a wait that leaves at most
  depth - 1 groups pending, a read of this item's stage; a stage is
  refilled only after the item read from it is done, and read only once
  its item's group has landed;
- the copies, in every mode at each split tried (a ring runs in f64 from
  512-point columns and in every mode at 8192): one 4-byte word a sample
  (for int16 the aligned word that holds it, the half picked on read),
  zero words outside [0, n_in); the
  registers they fill equal the plain version's zero-padded windows
  (``segment_filter.windows``) at both ends of the signal, for even and
  odd ``left`` and both alignments of an int16 signal.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch.ops import segment_filter as sf

# fourstep.cuh LOWCUT_SPLITS: every split with_split dispatches.
SPLITS = [(a, b) for a in range(1, 14) for b in (a - 1, a) if b >= 1]
MODES = ("f64", "f32", "i16")
SM_SMEM, CTA_SMEM_MAX, CTA_RESERVED = 233472, 232448, 1024
SMS = 132


def _pos0(log, t, m):
    """``Fft<LOG>::pos<0>``: the row register m of thread t gathers."""
    e_regs = 8 if log >= 3 else 1 << log
    nt = (1 << log) // e_regs
    r0 = log if log < 3 else (log % 3 or 3)
    if r0 < 3:
        return t + m * nt
    e = log - r0
    return ((t >> e) << (e + 3)) | (t & ((1 << e) - 1)) | (m << e)


class Pass1:
    """``Pass1<T, IO, Split<l1, l2>>`` and the ``Cols`` it sits on."""

    def __init__(self, mode, l1, l2):
        f64 = mode == "f64"
        self.l1, self.l2 = l1, l2
        self.n1, self.n2 = 1 << l1, 1 << l2
        self.E = 8 if l1 >= 3 else self.n1            # registers a thread
        self.NT = self.n1 // self.E                   # threads a column
        self.W = min(max(4096 >> l1, 1), 8, self.n2)  # Split::kTc
        self.threads = self.W * self.NT
        self.min_blocks = min(max((512 if f64 else 1024) // self.threads, 1), 16)
        table = 0 if (l1 == 13 and f64) else self.n1 - 1
        self.cols_smem = (table + self.W * self.n1) * (16 if f64 else 8)
        self.tiles = self.n2 // self.W
        self.stage_words = 2 * self.E * self.threads
        self.stage_bytes = 4 * self.stage_words
        # A ring only where one CTA holds the SM; 0: one CTA an item.
        self.depth = 0 if self.min_blocks > 1 else min(
            max((CTA_SMEM_MAX - self.cols_smem) // self.stage_bytes, 1), 2)
        self.smem = self.cols_smem + self.depth * self.stage_bytes

    def grid(self, items):
        """``pass1_grid``: one CTA an item without a ring, else at most the
        resident CTAs (min_blocks of them an SM)."""
        return items if self.depth == 0 else min(self.min_blocks * SMS, items)

    def slot(self, win, m, tid):
        return (win * self.E + m) * self.threads + tid

    def rows(self, t):
        return [_pos0(self.l1, t, m) for m in range(self.E)]


def _cases():
    return [(mode, l1, l2) for mode in MODES for l1, l2 in SPLITS]


def _id(case):
    return f"{case[0]}-2^{case[1]}x2^{case[2]}"


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_shared_memory_fits_a_cta_and_the_ctas_an_sm_aims_for(case):
    p = Pass1(*case)
    assert p.tiles * p.W == p.n2 and p.threads <= 1024
    assert p.E * p.NT == p.n1
    assert p.smem <= CTA_SMEM_MAX
    assert p.min_blocks * (p.smem + CTA_RESERVED) <= SM_SMEM
    assert 0 <= p.depth <= 2 and (p.depth == 0) == (p.min_blocks > 1)
    # The wrapper's split of this B is the model's.
    assert sf.split(1 << (case[1] + case[2])) == (p.l1, p.l2)


def test_the_ring_depths_at_the_cells_split_and_the_largest_sides():
    # 2^18: one f64 CTA of 72 KB tables and tile with two 32 KB stages (a
    # third would fit); two f32 / i16 CTAs of 36 KB an SM, with no ring.
    assert [Pass1(m, 9, 9).depth for m in MODES] == [2, 0, 0]
    assert Pass1("f64", 9, 9).smem == 73712 + 2 * 32768
    assert Pass1("f32", 9, 9).smem == 36856
    # 2^13 columns: no second 64 KB stage fits beside a 128 KB tile.
    assert [Pass1(m, 13, 13).depth for m in MODES] == [1, 1, 1]
    assert Pass1("f64", 12, 11).depth == 2 and Pass1("f32", 12, 11).depth == 0
    # Below 512-point columns f64 holds two CTAs an SM too.
    assert Pass1("f64", 8, 8).depth == 0


# The f64 splits of the cells: hires96k's 512 x 512 (B = 2^18) and
# long96k's 1024 x 512 (B = 2^19, M = 76,800): column tile, threads, ring
# depth, shared bytes and tiles a pair.
CELL_SPLITS = {
    "hires96k-9x9": ((9, 9), 8, 512, 2, 139_248, 64),
    "long96k-10x9": ((10, 9), 4, 512, 2, 147_440, 128),
}


@pytest.mark.parametrize("name", CELL_SPLITS)
def test_the_f64_ring_at_each_cells_split(name):
    (l1, l2), w, threads, depth, smem, tiles = CELL_SPLITS[name]
    p = Pass1("f64", l1, l2)
    assert (p.W, p.threads, p.depth, p.smem, p.tiles) == (w, threads, depth, smem, tiles)
    # One CTA an SM: its tables, tile and two 32 KB stages fit a CTA.
    assert p.min_blocks == 1 and p.stage_bytes == 32768
    assert p.smem <= CTA_SMEM_MAX and p.smem + CTA_RESERVED <= SM_SMEM
    assert sf.split(1 << (l1 + l2)) == (l1, l2)


def _walk(items, grid):
    return [list(range(b, items, grid)) for b in range(grid)]


def _cell_chunks(channels, frames, m, b, element_size):
    pairs = sf.call_pairs(channels, frames, b - m)
    chunk = sf.scratch_pairs(pairs, b, element_size)
    return [min(chunk, pairs - p0) for p0 in range(0, pairs, chunk)]


# The cells: 1 h stereo at 96 kHz (M = 38,400, f64) and at 44.1 kHz
# (M = 17,640, f32), B = 2^18; 1 h at 96 kHz with M = 76,800, f64 at
# B = 2^19 (32-pair chunks, 1024 x 512); an i16 call of the CD hour; and
# small calls with fewer items than resident CTAs.
GEOMETRIES = {
    "hires96k": ("f64", (9, 9), _cell_chunks(2, 345_600_000, 38_400, 1 << 18, 16)),
    "cd44k": ("f32", (9, 9), _cell_chunks(2, 158_760_000, 17_640, 1 << 18, 8)),
    "cd44k-i16": ("i16", (9, 9), _cell_chunks(2, 158_760_000, 17_640, 1 << 18, 8)),
    "one-pair": ("f64", (9, 9), [1]),
    "three-pairs": ("f32", (9, 9), [3]),
    "long96k": ("f64", (10, 9), _cell_chunks(2, 345_600_000, 76_800, 1 << 19, 16)),
}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_the_walk_takes_every_item_of_every_chunk_once(name):
    mode, split, chunks = GEOMETRIES[name]
    p = Pass1(mode, *split)
    if name == "long96k":
        assert len(chunks) == 25 and chunks[0] == 32 and chunks[-1] == 6
    if name in ("hires96k", "cd44k", "long96k"):
        assert len(chunks) > 1 and chunks[-1] < chunks[0]   # ragged last chunk
    for np_ in chunks:
        items = np_ * p.tiles
        grid = p.grid(items)
        seen = np.zeros((np_, p.tiles), dtype=np.int64)
        for walk in _walk(items, grid):
            for it in walk:
                pl, tile = it >> (p.tiles.bit_length() - 1), it & (p.tiles - 1)
                assert it == pl * p.tiles + tile
                seen[pl, tile] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("case", CASES, ids=map(_id, CASES))
def test_the_walk_covers_small_chunks_at_every_split(case):
    p = Pass1(*case)
    for np_ in (1, 2, 5):
        items = np_ * p.tiles
        for grid in {p.grid(items), 1, min(7, items)}:
            got = sorted(it for w in _walk(items, grid) for it in w)
            assert got == list(range(items))


class _Ring:
    """The copy groups and stages of one thread, in program order."""

    def __init__(self, depth):
        self.depth = depth
        self.stage = [None] * depth     # (item, group, read?)
        self.groups = []                # items of each committed group
        self.pending = []               # items started, not yet committed
        self.read = []

    def gather(self, item, s):
        prev = self.stage[s]
        assert prev is None or prev[2], "refilled before its item was read"
        self.pending.append(item)
        self.stage[s] = (item, len(self.groups), False)

    def commit(self):
        self.groups.append(self.pending)
        self.pending = []

    def wait_read(self, item, s, leave):
        landed = len(self.groups) - leave       # groups done after the wait
        held, group, done = self.stage[s]
        assert held == item and not done and group < landed
        self.stage[s] = (item, group, True)
        self.read.append(item)


def _program(ring, walk):
    """``cols_forward``'s loop for one thread whose CTA walks ``walk``."""
    d = ring.depth
    for k in range(d - 1):                       # the prologue
        if k < len(walk):
            ring.gather(walk[k], k)
        ring.commit()
    stage = 0
    for i, it in enumerate(walk):
        fill = d - 1 if stage == 0 else stage - 1
        if i + d - 1 < len(walk):
            ring.gather(walk[i + d - 1], fill)
        ring.commit()
        ring.wait_read(it, stage, d - 1)
        stage = 0 if stage + 1 == d else stage + 1


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("n_items", [0, 1, 2, 3, 4, 31])
def test_a_stage_is_refilled_only_after_its_item_was_read(depth, n_items):
    ring = _Ring(depth)
    walk = list(range(5, 5 + 132 * n_items, 132))
    _program(ring, walk)
    assert ring.read == walk
    assert not ring.pending and sum(map(len, ring.groups)) == len(walk)
    # Every group but the last depth - 1 held an item; the rest are empty.
    assert all(len(g) <= 1 for g in ring.groups)


def _gathered(p, mode, x, n_in, hop, left, pl, c0, shift, pairs_per_ch):
    """The registers of every thread of item (pl, tile at c0) as the
    kernel's copies and read fill them: [threads, E] complex. ``x`` is the
    channels' samples laid out flat after ``shift`` leading elements (the
    signal's element offset from a 4-byte boundary, int16 only)."""
    ch, k = divmod(pl, pairs_per_ch)
    base = ch * n_in
    s0 = 2 * k * hop - left
    mem = np.concatenate([np.zeros(shift, x.dtype), x.ravel(), np.zeros(2, x.dtype)])
    ring = np.zeros(p.stage_words, dtype=np.int64 if mode == "i16" else np.float64)
    half = np.zeros(p.stage_words, dtype=np.int64)
    for tid in range(p.threads):
        w, t = tid & (p.W - 1), tid >> (p.W.bit_length() - 1)
        a = shift + base + s0 + c0 + w                 # read's parity
        h = (a & 1, (a + hop) & 1)
        for win in range(2):
            s = s0 + win * hop + c0 + w
            for m, row in enumerate(p.rows(t)):
                i = s + row * p.n2
                slot = p.slot(win, m, tid)
                half[slot] = h[win]
                if not 0 <= i < n_in:
                    continue                           # src_bytes 0: a zero word
                if mode == "i16":
                    e = shift + base + i               # element offset in mem
                    word = (e & ~1)
                    ring[slot] = (int(mem[word]) & 0xFFFF) | \
                        ((int(mem[word + 1]) & 0xFFFF) << 16)
                    assert (e & 1) == h[win]           # the half read picks
                else:
                    ring[slot] = mem[base + i]
    if mode == "i16":
        u = np.where(half == 1, ring >> 16, ring) & 0xFFFF
        vals = (u - ((u & 0x8000) << 1)).astype(np.float64)
    else:
        vals = ring
    out = np.zeros((p.threads, p.E), dtype=np.complex128)
    for tid in range(p.threads):
        for m in range(p.E):
            out[tid, m] = vals[p.slot(0, m, tid)] + 1j * vals[p.slot(1, m, tid)]
    return out


def _plain(p, x, b, hop, left, pl, c0, pairs_per_ch):
    """The same registers from the plain version's zero-padded windows."""
    ch, k = divmod(pl, pairs_per_ch)
    wins = sf.windows(torch.from_numpy(x.astype(np.float32)), b, hop, left,
                      2 * pairs_per_ch).numpy()[ch].astype(np.float64)
    z = (wins[2 * k] + 1j * wins[2 * k + 1]).reshape(p.n1, p.n2)
    out = np.zeros((p.threads, p.E), dtype=np.complex128)
    for tid in range(p.threads):
        w, t = tid & (p.W - 1), tid >> (p.W.bit_length() - 1)
        for m, row in enumerate(p.rows(t)):
            out[tid, m] = z[row, c0 + w]
    return out


# Splits small enough to gather whole signals, the cells' split, and the
# column tiles narrower than 8 (4, 2 and 1 columns: 2^10 .. 2^12 rows)
# with a short signal.
ZERO_FILL_SPLITS = [(1, 1), (2, 1), (3, 3), (5, 4), (9, 9), (10, 9), (11, 10),
                    (12, 11)]


@pytest.mark.parametrize("left_odd", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("split", ZERO_FILL_SPLITS,
                         ids=[f"2^{a}x2^{b}" for a, b in ZERO_FILL_SPLITS])
def test_zero_filled_words_are_the_plain_windows_zero_padding(split, mode, left_odd):
    l1, l2 = split
    p = Pass1(mode, l1, l2)
    b = p.n1 * p.n2
    hop, left = b - 2, 1 if left_odd else 2     # M = 2; "same" left = 1
    # Two channels; two pairs a channel where B is small, else a signal
    # shorter than one window, so both ends fall in one item's rows.
    n_in = 3 * hop + 5 if b <= 1 << 12 else 3 * p.n2 + 7
    rng = np.random.default_rng(b + left)
    if mode == "i16":
        x = rng.integers(-32768, 32768, (2, n_in)).astype(np.int16)
    else:
        x = rng.uniform(-1, 1, (2, n_in)).astype(np.float32)
    pairs_per_ch = (-(-n_in // hop) + 1) // 2
    pairs = 2 * pairs_per_ch
    items = [(pl, tile) for pl in range(pairs) for tile in range(p.tiles)]
    if len(items) > 64:                      # both ends and a middle tile
        items = [it for it in items
                 if it[1] in (0, 1, p.tiles // 2, p.tiles - 1)]
    for shift in ((0, 1) if mode == "i16" else (0,)):
        for pl, tile in items:
            got = _gathered(p, mode, x, n_in, hop, left, pl, tile * p.W, shift,
                            pairs_per_ch)
            want = _plain(p, x, b, hop, left, pl, tile * p.W, pairs_per_ch)
            np.testing.assert_array_equal(got, want)
