"""The factored four-step twiddle of the column passes, on the CPU.

Where the full [N1, N2] twiddle table would exceed 4 MiB (f64 from
B = 2^19, f32 from 2^20), ``ops/segment_filter.kernel_tables`` hands the
kernels two factor tables in its place and the column passes
(``csrc/fourstep.cuh`` ``Twiddle``, ``ColTwiddle``) multiply them: scratch
row p holds k1 = bitrev(p) = k_hi * 2^h + k_lo, h = L1 - 3, and the
twiddle of column c is hi[k_hi, c] * lo[k_lo, c]; register m of thread t
holds row 8 t + m, so k_lo = bitrev(t) and k_hi = bitrev(m). Held here:

- the factors multiply back to the full table within 4 ulp of its type
  (and within 1.5 ulp of the exact twiddle in float64);
- the rule, by table bytes, at every split and type the kernels compile,
  and the layout ``kernel_tables`` hands over;
- a NumPy mirror of the kernel's row-index split (register m of thread t
  holds row pos<kLast>(t, m); bitrev; k_hi, k_lo) at every factored split;
- the kernel's three passes (``test_torch_segment_filter._kernel_mirror``)
  run with twiddles made from the factor tables, against the float64
  oracle.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch.ops import kernel_design as kd
from audio_fir_filter_tpu_torch.ops import oracle
from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from test_torch_fft_stages import Plan, bitrev, brev
from test_torch_segment_filter import _kernel_mirror

CPU = torch.device("cpu")
# Every split the kernels compile (fourstep.cuh LOWCUT_SPLITS): B = 2^2 .. 2^26.
LOG_BS = range(2, 27)
TYPES = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def _from_factors(packed, b):
    """The [N1, N2] twiddle the factor tables give: row pos takes
    hi[k1 >> h] * lo[k1 & (2^h - 1)], k1 = bitrev(pos), in the tables' type."""
    lo_rows, _ = sf.twiddle_rows(b)
    h = lo_rows.bit_length() - 1
    k1 = sf._bitrev(sf.split(b)[0])
    return packed[lo_rows + (k1 >> h)] * packed[k1 & (lo_rows - 1)]


def _ulps(a, b, eps):
    return max(np.abs(a.real - b.real).max(), np.abs(a.imag - b.imag).max()) / eps


@pytest.mark.parametrize("log_b,dtype", [(19, torch.complex128),
                                         (20, torch.complex64),
                                         (21, torch.complex64)])
def test_the_factors_multiply_back_to_the_full_table(log_b, dtype):
    """(10, 9) in complex128, (10, 10) and (11, 10) in complex64: each
    factor rounded once to the type, the product taken in the type, as the
    kernel does."""
    b = 1 << log_b
    npdt = TYPES[dtype]
    eps = np.finfo(npdt).eps
    packed = sf.kernel_tables(b, dtype, CPU)[0].numpy()
    assert packed.dtype == npdt
    np.testing.assert_array_equal(packed, sf.twiddle_factors(b).astype(npdt))
    got = _from_factors(packed, b)
    full = sf.four_step_twiddle(b).astype(npdt)
    assert _ulps(got, full, eps) <= 4.0
    if dtype == torch.complex128 and np.finfo(np.longdouble).eps < eps:
        # Against the exact twiddle, in extended precision where the
        # platform has it.
        l1, l2 = sf.split(b)
        k = (np.arange(1 << l2)[None, :] * sf._bitrev(l1)[:, None]) % b
        ang = -2 * np.arccos(np.longdouble(-1)) * k.astype(np.longdouble) / b
        exact_re, exact_im = np.cos(ang), np.sin(ang)
        err = max(np.abs(got.real - exact_re).max(), np.abs(got.imag - exact_im).max())
        assert float(err) <= 1.5 * eps


def test_unit_roots_are_the_roots_of_unity():
    """The octant-reduced roots equal exp(-2 pi i k / b) for every k and
    every quarter-turn and octant, to an ulp or two of float64's own exp."""
    for b in (8, 64, 1 << 12):
        k = np.arange(-b, 3 * b)
        got = sf.unit_roots(k, b)
        want = np.exp(-2j * np.pi * (k % b) / b)
        assert _ulps(got, want, np.finfo(np.float64).eps) <= 4.0
        # The quarter turns are exact.
        for kk, w in ((0, 1), (b // 4, -1j), (b // 2, -1), (3 * b // 4, 1j)):
            assert sf.unit_roots(np.array([kk]), b)[0] == w


@pytest.mark.parametrize("log_b", LOG_BS)
@pytest.mark.parametrize("dtype", list(TYPES))
def test_the_rule_by_table_bytes_at_every_split(log_b, dtype):
    b = 1 << log_b
    l1, l2 = sf.split(b)
    layout = sf.twiddle_layout(b, dtype)
    full = dtype.itemsize << log_b
    assert layout["factored"] == (full > 4 << 20)
    assert layout["factored"] == (log_b >= (19 if dtype == torch.complex128 else 20))
    if layout["factored"]:
        assert (layout["lo_rows"], layout["hi_rows"]) == (1 << (l1 - 3), 8)
        assert layout["bytes"] == ((1 << (l1 - 3)) + 8) * (1 << l2) * dtype.itemsize
        assert layout["bytes"] <= full // 7
    else:
        assert (layout["lo_rows"], layout["hi_rows"], layout["bytes"]) == (0, 0, full)
    tw4 = sf.kernel_tables(b, dtype, CPU)[0]
    assert tw4.dtype == dtype and tw4.is_contiguous()
    assert tw4.nbytes == layout["bytes"]
    rows = layout["lo_rows"] + layout["hi_rows"] if layout["factored"] else 1 << l1
    assert tuple(tw4.shape) == (rows, 1 << l2)


def test_the_long_filter_reads_an_eighth_of_the_table():
    # (10, 9) in f64: 128 + 8 rows of 512 complex128, 1 MiB + 64 KiB for
    # 8 MiB; 2^18 f64 and f32 keep their 4 MiB and 2 MiB tables.
    assert sf.twiddle_layout(1 << 19, torch.complex128) == {
        "factored": True, "bytes": 1_114_112, "lo_rows": 128, "hi_rows": 8}
    assert sf.twiddle_layout(1 << 18, torch.complex128)["bytes"] == 4_194_304
    assert sf.twiddle_layout(1 << 18, torch.complex64)["bytes"] == 2_097_152
    assert not sf.twiddle_layout(1 << 19, torch.complex64)["factored"]


FACTORED_SPLITS = [(l1, l2) for l1, l2 in (sf.split(1 << k) for k in LOG_BS)
                   if sf.twiddle_layout(1 << (l1 + l2), torch.complex64)["factored"]
                   or sf.twiddle_layout(1 << (l1 + l2), torch.complex128)["factored"]]


@pytest.mark.parametrize("l1,l2", FACTORED_SPLITS)
def test_the_column_passes_row_split_mirrors_the_tables(l1, l2):
    """ColTwiddle: register m of thread t holds row p = pos<kLast>(t, m)
    (8 t + m); k_lo = bt, t bit-reversed over h = L1 - 3 bits (one load a
    thread), k_hi = brev(m) (the same 8 rows for every thread). Their rows
    of the packed table give row p's twiddle at every column."""
    assert (l1, l2) in [(10, 9), (10, 10), (11, 10), (11, 11), (12, 11),
                        (12, 12), (13, 12), (13, 13)]
    b = 1 << (l1 + l2)
    f = Plan(l1)
    last = f.NS - 1
    assert f.lrad(last) == 3 and f.ld(last) == 0         # the static_asserts
    lo_rows, hi_rows = sf.twiddle_rows(b)
    h = lo_rows.bit_length() - 1
    assert (h, hi_rows, f.NT) == (l1 - 3, 8, lo_rows)
    packed = sf.twiddle_factors(b) if l1 <= 11 else None
    full = sf.four_step_twiddle(b) if l1 <= 11 else None
    seen = set()
    for t in range(f.NT):
        k_lo = bitrev(t, h)
        for m in range(8):
            p = f.pos(last, t, m)
            assert p == 8 * t + m
            k_hi = brev(m, 3)
            assert k_hi * lo_rows + k_lo == bitrev(p, l1)
            seen.add(p)
            if packed is not None and t % 7 == 0:
                got = packed[lo_rows + k_hi] * packed[k_lo]
                assert _ulps(got, full[p], np.finfo(np.float64).eps) <= 4.0
    assert seen == set(range(1 << l1))


@pytest.mark.parametrize("b,n", [(2048, 5000), (4096, 9000)])
def test_the_kernel_mirror_with_factored_twiddles_matches_the_oracle(b, n):
    """The three passes of csrc/segment_filter.cu (NumPy mirror) with the
    four-step twiddle made from the factor tables, at small splits, against
    the float64 direct filter: within the mirror's own 0.5 LSB @ 24-bit."""
    taps = kd.highpass_taps(0.05, 200)
    x = np.random.default_rng(b).uniform(-1, 1, (2, n))
    tw4 = _from_factors(sf.twiddle_factors(b), b)
    assert not np.array_equal(tw4, sf.four_step_twiddle(b))
    y = _kernel_mirror(x, taps, b, len(taps) // 2, n, tw4=tw4)
    want = np.stack([oracle.direct_filter(xi, taps) for xi in x])
    assert oracle.max_lsb_error(y, want, bits=24) <= 0.5


def test_the_library_query_reads_the_compiled_rule(monkeypatch):
    """``library_twiddle_layout`` asks ``lowcut_segment_twiddle_layout``
    with the mode's id and the split, and reads its four numbers in the
    host rule's form (here from a stand-in library that answers with the
    host rule)."""
    import ctypes

    from audio_fir_filter_tpu_torch.ops import _build

    asked = []

    def entry(mode, l1, l2, out):
        asked.append((mode, l1, l2))
        dtype = torch.complex128 if mode == 1 else torch.complex64
        lay = sf.twiddle_layout(1 << (l1 + l2), dtype)
        vals = (ctypes.c_longlong * 4).from_address(out)
        vals[:] = [int(lay["factored"]), lay["bytes"], lay["lo_rows"], lay["hi_rows"]]
        return 0

    lib = type("Lib", (), {"lowcut_segment_twiddle_layout": staticmethod(entry)})()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    for mode, dtype in (("f32", torch.complex64), ("f64", torch.complex128),
                        ("i16", torch.complex64)):
        for log_b in (18, 19, 20):
            assert sf.library_twiddle_layout(mode, 1 << log_b) == \
                sf.twiddle_layout(1 << log_b, dtype)
    assert asked[:3] == [(0, 9, 9), (0, 10, 9), (0, 10, 10)]
    assert {a[0] for a in asked} == {0, 1, 2}


def test_the_ablation_script_refuses_an_unknown_shape(capsys):
    from audio_fir_filter_tpu_torch.experiments import fast_decomp_r05 as fd

    with pytest.raises(SystemExit) as e:
        fd.main(["--shapes", "headline,huge"])
    assert e.value.code == 2
    assert "unknown shapes ['huge']" in capsys.readouterr().err
