"""A NumPy model of the register-resident FFT engine of ``csrc/fourstep.cuh``,
held against ``np.fft`` on the CPU.

The CUDA engine runs only on the card; this model repeats its index maths
step for step, so a wrong shift or mask shows here first:

- the stage plan of a length-2^LOG transform: one radix-2^r stage for the
  remainder r = LOG mod 3 (largest span first), then radix-8 stages down to
  span 1; LOG < 3 is one stage of radix 2^LOG;
- the thread -> element map: thread t of NT = L / 8 holds 8 registers; in
  stage s register m holds position ``pos(s, t, m)``;
- the butterflies: a radix-R DFT of registers i + q * (8 / R) in natural
  order, output k to register i + bitrev(k) * (8 / R) times the stage
  twiddle w_L^(j k u), read from the per-stage tables the kernel builds from
  the host's half table (exp(-2 pi i k / L), k < L / 2, negated above);
- the exchanges through shared memory at the swizzled position
  ``p ^ ((p >> 3) & 15)``, and that no warp access in them conflicts on a
  bank.

Forward (decimation in frequency) must give ``np.fft.fft`` in bit-reversed
order and the inverse (decimation in time, unscaled) ``np.fft.ifft`` * L in
natural order, for every side 2^1 .. 2^13 the kernels compile.
"""

import numpy as np
import pytest

from audio_fir_filter_tpu_torch.ops import segment_filter as sf

LOGS = range(1, sf._MAX_LOG_SIDE + 1)
R2 = 1.0 / np.sqrt(2.0)


class Plan:
    """``fourstep.cuh`` ``Fft<LOG>``: the stage plan and the element map."""

    def __init__(self, log):
        self.log, self.L = log, 1 << log
        self.E = 8 if log >= 3 else self.L           # registers per thread
        self.NT = self.L // self.E                   # threads per transform
        self.LNT = self.NT.bit_length() - 1
        rem = log % 3
        self.r0 = log if log < 3 else (rem if rem else 3)
        self.NS = 1 if log < 3 else (log + 2) // 3

    def lrad(self, s):
        return self.r0 if s == 0 else 3

    def ld(self, s):
        return self.log - self.r0 - 3 * s

    def pos(self, s, t, m):
        """Position of register m of thread t in stage s."""
        if self.lrad(s) < 3:
            return t + m * self.NT
        e = self.ld(s)
        return ((t >> e) << (e + 3)) | (t & ((1 << e) - 1)) | (m << e)

    def j(self, s, t, i):
        """The butterfly's offset inside its span (twiddle exponent / u)."""
        if self.lrad(s) < 3:
            return t + i * self.NT
        return t & ((1 << self.ld(s)) - 1)


def swizzle(p):
    return p ^ ((p >> 3) & 15)


def bitrev(k, bits):
    r = 0
    for b in range(bits):
        r |= ((k >> b) & 1) << (bits - 1 - b)
    return r


def brev(k, bits):
    """The kernel's loop-free ``brev`` (bits <= 3), which picks the
    registers a butterfly's outputs go to."""
    if bits == 1:
        return k
    if bits == 2:
        return ((k & 1) << 1) | (k >> 1)
    return ((k & 1) << 2) | (k & 2) | (k >> 2)


def half_table(L):
    return np.exp(-2j * np.pi * np.arange(max(L // 2, 1)) / L)


def twiddle_raw(tab, L, e):
    """w_L^e from the half table, e < L: negated above L / 2."""
    e = np.asarray(e)
    h = L // 2
    return np.where(e < h, tab[np.minimum(e, h - 1)], -tab[np.maximum(e - h, 0)])


def stage_tables(p, tab):
    """Per stage s, [(R - 1) * d]: entry (k - 1) * d + j = w_L^(j k u),
    u = L / (R d); the layout the kernel builds in shared memory."""
    out = []
    for s in range(p.NS):
        R, d = 1 << p.lrad(s), 1 << p.ld(s)
        u = p.L // (R * d)
        if p.lrad(s) < 3:
            d = p.L // R                              # spans the whole transform
        k = np.arange(1, R)[:, None]
        j = np.arange(d)[None, :]
        out.append(twiddle_raw(tab, p.L, (j * k * u)).reshape(-1))
    return out


def dft(a, inverse=False):
    """Radix-R DFT of a list of R arrays (natural order in and out), with
    the kernel's formulas; the inverse is unscaled."""
    neg_i = (lambda x: 1j * x) if inverse else (lambda x: -1j * x)
    R = len(a)
    if R == 1:
        return a
    if R == 2:
        return [a[0] + a[1], a[0] - a[1]]
    if R == 4:
        t0, t1, t2 = a[0] + a[2], a[0] - a[2], a[1] + a[3]
        t3 = neg_i(a[1] - a[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    b0 = [a[q] + a[q + 4] for q in range(4)]
    b1 = [a[q] - a[q + 4] for q in range(4)]
    c0, c1 = b0[0] + b0[2], b0[0] - b0[2]
    c2, c3 = b0[1] + b0[3], neg_i(b0[1] - b0[3])
    d0, d2 = b1[0], neg_i(b1[2])
    d1 = (b1[1] + neg_i(b1[1])) * R2
    d3 = (neg_i(b1[3]) - b1[3]) * R2
    e0, e1, e2 = d0 + d2, d0 - d2, d1 + d3
    e3 = neg_i(d1 - d3)
    return [c0 + c2, e0 + e2, c1 + c3, e1 + e3, c0 - c2, e0 - e2, c1 - c3,
            e1 - e3]


def butterflies(p, s, v, t, tabs, inverse):
    """Stage s on the registers v [E][NT] of threads t, in place."""
    R = 1 << p.lrad(s)
    sub = p.E // R
    d = (p.L // R) if p.lrad(s) < 3 else (1 << p.ld(s))
    tab = tabs[s]
    for i in range(sub):
        j = p.j(s, t, i)
        w = [np.ones_like(t, dtype=complex)] + [tab[(k - 1) * d + j]
                                                 for k in range(1, R)]
        slots = [i + brev(k, p.lrad(s)) * sub for k in range(R)]
        if not inverse:
            y = dft([v[i + q * sub] for q in range(R)])
            for k in range(R):
                v[slots[k]] = y[k] * w[k]
        else:
            u = [v[slots[k]] * np.conj(w[k]) for k in range(R)]
            y = dft(u, inverse=True)
            for q in range(R):
                v[i + q * sub] = y[q]


def exchange(p, v, t, s_from, s_to):
    smem = np.full(p.L, np.nan + 0j)
    for m in range(p.E):
        smem[swizzle(p.pos(s_from, t, m))] = v[m]
    assert not np.isnan(smem).any()                  # every slot written once
    return [smem[swizzle(p.pos(s_to, t, m))] for m in range(p.E)]


def forward(x, log):
    p = Plan(log)
    t = np.arange(p.NT)
    tabs = stage_tables(p, half_table(p.L))
    v = [x[p.pos(0, t, m)] for m in range(p.E)]
    butterflies(p, 0, v, t, tabs, False)
    for s in range(1, p.NS):
        v = exchange(p, v, t, s - 1, s)
        butterflies(p, s, v, t, tabs, False)
    y = np.empty(p.L, complex)
    for m in range(p.E):
        y[p.pos(p.NS - 1, t, m)] = v[m]
    return y


def inverse(y, log):
    p = Plan(log)
    t = np.arange(p.NT)
    tabs = stage_tables(p, half_table(p.L))
    v = [y[p.pos(p.NS - 1, t, m)] for m in range(p.E)]
    butterflies(p, p.NS - 1, v, t, tabs, True)
    for s in range(p.NS - 2, -1, -1):
        v = exchange(p, v, t, s + 1, s)
        butterflies(p, s, v, t, tabs, True)
    x = np.empty(p.L, complex)
    for m in range(p.E):
        x[p.pos(0, t, m)] = v[m]
    return x


@pytest.mark.parametrize("log", LOGS)
def test_forward_is_the_fft_in_bit_reversed_order(log):
    rng = np.random.default_rng(log)
    L = 1 << log
    x = rng.standard_normal(L) + 1j * rng.standard_normal(L)
    want = np.fft.fft(x)[sf._bitrev(log)]
    got = forward(x, log)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("log", LOGS)
def test_inverse_takes_bit_reversed_order_to_natural_times_l(log):
    rng = np.random.default_rng(100 + log)
    L = 1 << log
    y = rng.standard_normal(L) + 1j * rng.standard_normal(L)
    want = np.fft.ifft(y[np.argsort(sf._bitrev(log))]) * L
    got = inverse(y, log)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_loop_free_brev_is_the_bit_reversal(bits):
    assert [brev(k, bits) for k in range(1 << bits)] == [
        bitrev(k, bits) for k in range(1 << bits)]


@pytest.mark.parametrize("log", LOGS)
def test_element_maps_cover_each_position_once_per_stage(log):
    p = Plan(log)
    t = np.arange(p.NT)
    for s in range(p.NS):
        pos = np.concatenate([np.atleast_1d(p.pos(s, t, m)) for m in range(p.E)])
        assert sorted(pos) == list(range(p.L))
    assert sorted(swizzle(np.arange(p.L))) == list(range(p.L))
    assert sum((len(tb)) for tb in stage_tables(p, half_table(p.L))) == p.L - 1


def _max_conflict(addrs, lanes, units):
    """Worst bank-conflict degree of one warp access: per phase of
    ``lanes`` lanes, distinct addresses that share a bank unit."""
    worst = 1
    for ph in range(0, 32, lanes):
        a = set(int(x) for x in addrs[ph : ph + lanes])
        if not a:
            continue
        per = {}
        for x in a:
            per.setdefault(x % units, set()).add(x)
        worst = max(worst, max(len(v) for v in per.values()))
    return worst


def _accesses(p):
    """Every exchange access of a forward and an inverse transform: the
    positions each thread writes and then reads."""
    pats = []
    for s in range(p.NS - 1):
        pats += [s, s + 1]
    return pats


@pytest.mark.parametrize("log", range(7, sf._MAX_LOG_SIDE + 1))
def test_row_exchanges_are_free_of_bank_conflicts(log):
    """Pass 2: lanes on consecutive threads of one transform (NT >= 16).
    8-byte elements are served 16 lanes at a time over 16 bank units,
    16-byte elements 8 lanes at a time over 8."""
    p = Plan(log)
    for s in _accesses(p):
        for m in range(p.E):
            for w0 in range(0, p.NT, 32):
                t = np.arange(w0, min(w0 + 32, p.NT))
                addr = swizzle(p.pos(s, t, m))
                assert _max_conflict(addr, 16, 16) == 1
                assert _max_conflict(addr, 8, 8) == 1


@pytest.mark.parametrize("log", range(3, sf._MAX_LOG_SIDE + 1))
def test_column_exchanges_are_free_of_bank_conflicts(log):
    """Passes 1 and 3: column w in the low lane bits, element (pos, w) at
    swizzle(pos) * W + w, W = the kernels' tile width for this side."""
    p = Plan(log)
    W = max(1, min(8, 4096 >> log))
    lane = np.arange(32)
    w, tl = lane % W, lane // W
    for s in _accesses(p):
        for m in range(p.E):
            for t0 in range(0, p.NT, 32 // W):
                t = t0 + tl
                ok = t < p.NT
                addr = (swizzle(p.pos(s, t[ok], m)) * W + w[ok])
                assert _max_conflict(addr, 16, 16) == 1
                assert _max_conflict(addr, 8, 8) == 1
