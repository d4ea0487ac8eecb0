"""The card probes' plain versions against the JAX package, on the CPU.

The probes of ``audio_fir_filter_tpu_torch/experiments/`` hold CUDA kernels
(``csrc/probe_*.cu``) that run only on the card; here their plain PyTorch
versions, which ``chip_smoke.py`` holds the kernels against, are held
against the JAX package's own functions and NumPy float64:

- stages: ``fft_core.fft_dif_rows`` / ``ifft_dit_rows`` with the same plan
  (float32 arithmetic: 2e-5 of max |ref|) and ``fft_core.dif_fft_np``
  (float64: 1e-10); the roll stage against its formula in
  ``experiments/mosaic_stages.py``;
- passes: K3(K2(K1)) and ``full`` against ``pallas_fft._conv_xla_mirror``
  (float32 outputs: 2e-5 of max |ref|) and ``ops.conv_blocks.reference``;
  K2a(K1) against ``fft_core.fourstep_fft_np`` mapped to the kernel's
  bit-reversed order (1e-10);
- ablations: ``ac_only`` is x / N2, ``b_only`` a row-wise circular
  convolution, ``no_tr`` a permutation that is the identity with a flat
  spectrum, the copy variants equal x;
- the device rule: no probe runs on ``cuda`` without a card or on the CPU,
  and the CPU wrappers build nothing;
- NumPy mirrors of the two redesigned floor kernels of
  ``csrc/probe_floors.cu``: the cluster variant's two all-to-alls through
  distributed shared memory, and ``bw``'s ring of TMA bulk copies (which
  tile each CTA walks, when a stage is refilled, what each bulk copy and
  ``mbarrier`` phase covers);
- the ring chain of ``csrc/probe_stages.cu`` (``fwd ring``, ``fwd ring
  r8``): its plain versions are the sweeps', and NumPy mirrors of its store
  map, its persistent walk, its shared memory and its ring of bulk copies
  (the model of ``Fft<T, 9>`` is ``test_torch_fft_stages``');
- the fused block of ``csrc/probe_phases.cu`` (``fused_block``): the plain
  versions of ``full`` and ``copy`` against the JAX probe kernel itself
  (``experiments/fused_phase_decomp.make_variant`` in interpret mode, f32
  and df64), the real-input split step against ``torch.fft.rfft`` /
  ``irfft``, the phases composing to the block convolution, each ablation's
  defined output, NumPy mirrors of the kernel's slab, warp and band maps,
  and the wrapper's shapes, scratch and device rule.
"""

import re

import numpy as np
import pytest
import torch
import test_torch_fft_stages as fs

from audio_fir_filter_tpu_torch.experiments import copy_floor_probe as cfp
from audio_fir_filter_tpu_torch.experiments import dispatch_floor_probe as dfp
from audio_fir_filter_tpu_torch.experiments import dma_bw_micro as bwm
from audio_fir_filter_tpu_torch.experiments import fused_phase_decomp as fpd
from audio_fir_filter_tpu_torch.experiments import mosaic_stages as ms
from audio_fir_filter_tpu_torch.experiments import mosaic_stages2 as ms2
from audio_fir_filter_tpu_torch.experiments import pallas_micro as pm
from audio_fir_filter_tpu_torch.ops import _build
from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
from audio_fir_filter_tpu_torch.ops import segment_filter as sf

MODULES = (dfp, bwm, cfp, fpd, pm, ms, ms2)
REL_F32, REL_F64 = 2e-5, 1e-10


def _rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _z(seed, batch=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, ms.N, ms.N))
            + 1j * rng.standard_normal((batch, ms.N, ms.N)))


# ----------------------------------------------------------------- stages

def test_stage_plans_are_the_jax_plans():
    from audio_fir_filter_tpu.ops import fft_core as fc

    for n in (2, 4, 8, 64, 256, 512, 1024, 4096):
        assert ms.dif_plan(n) == fc.dif_plan(n)
        assert ms.dif_plan_r8(n) == fc.dif_plan_r8(n)
    assert ms.r2_plan(512) == tuple(("r2", 512 >> k) for k in range(1, 10))


_PLANS = {"r2": ms.r2_plan(512), "r4": ms.dif_plan(512),
          "r8": ms.dif_plan_r8(512)}
_STAGE_CASES = [("r2 d=128", (("r2", 128),)), ("r2 d=1", (("r2", 1),)),
                ("r4 d=16", (("r4", 16),)), ("r4 d=1", (("r4", 1),)),
                ("fwd r2", _PLANS["r2"]), ("fwd r4", _PLANS["r4"]),
                ("fwd r8", _PLANS["r8"]), ("fwd ring", _PLANS["r2"]),
                ("fwd ring r8", _PLANS["r8"])]


def _jax_rows(z, plan, inverse=False):
    """fc.fft_dif_rows / ifft_dit_rows in float32 with fc.dif_tables, on
    the first 16 of the 512 independent transforms (columns)."""
    import jax

    from audio_fir_filter_tpu.ops import fft_core as fc

    a = fc.ARITH_F32
    tabs = fc.dif_tables(512, a.name, plan)
    f = fc.ifft_dit_rows if inverse else fc.fft_dif_rows
    y = jax.jit(lambda re, im: f(a.from_f32(re, im), 512, a, tabs=tabs,
                                 plan=plan))(z.real.astype(np.float32),
                                             z.imag.astype(np.float32))
    return np.asarray(y.re) + 1j * np.asarray(y.im)


_COLS = slice(0, 16)


@pytest.mark.parametrize("name,plan", _STAGE_CASES)
def test_stage_matches_jax_float32_and_numpy_float64(name, plan):
    from audio_fir_filter_tpu.ops import fft_core as fc

    z = _z(1)
    got32 = ms.stage(torch.from_numpy(z).to(torch.complex64), name).numpy()
    assert _rel_err(got32[..., _COLS], _jax_rows(z[..., _COLS], plan)) < REL_F32
    got64 = ms.stage(torch.from_numpy(z), name).numpy()
    want = np.swapaxes(fc.dif_fft_np(np.swapaxes(z, -1, -2), plan), -1, -2)
    assert _rel_err(got64, want) < REL_F64


@pytest.mark.parametrize("kind", ["r2", "r4", "r8"])
def test_inverse_chain_matches_jax_and_inverts(kind):
    plan = _PLANS[kind]
    z = _z(2)
    y = _jax_rows(z[..., _COLS], plan)
    got = ms.stage(torch.from_numpy(np.tile(y, 32).astype(np.complex64)),
                   f"inv {kind}")
    assert _rel_err(got.numpy()[..., _COLS],
                    _jax_rows(y, plan, inverse=True)) < REL_F32
    back = ms.stage(ms.stage(torch.from_numpy(z), f"fwd {kind}"), f"inv {kind}")
    assert _rel_err(back.numpy(), z) < REL_F64


def test_forward_plus_inverse_is_the_identity_and_matches_jax():
    z = _z(3)
    got = ms2.chain(torch.from_numpy(z), "inv r2")
    assert got.shape == z.shape
    fi = ms.stage(torch.from_numpy(z), "fwd+inv").numpy()
    assert _rel_err(fi, z) < REL_F64
    fi32 = ms.stage(torch.from_numpy(z).to(torch.complex64), "fwd+inv").numpy()
    want = _jax_rows(_jax_rows(z[..., _COLS], _PLANS["r2"]), _PLANS["r2"],
                     inverse=True)
    assert _rel_err(fi32[..., _COLS], want) < REL_F32


@pytest.mark.parametrize("e", [1, 8])
def test_roll_stage_matches_its_formula(e):
    """mosaic_stages.py roll_r2_stage: y[i] = x[i] + x[i+e] where (i // e)
    is even, (x[i-e] - x[i]) * w where odd, along the transform axis."""
    z = _z(4)
    w = np.exp(-2j * np.pi * np.arange(ms.N)[None, :] / 64.0)
    u, v = np.roll(z, -e, axis=1), np.roll(z, e, axis=1)
    lower = ((np.arange(ms.N) // e) % 2 == 0)[:, None]
    want = np.where(lower, z + u, (v - z) * w)
    got = ms.stage(torch.from_numpy(z), f"shuffle e={e}").numpy()
    assert _rel_err(got, want) < REL_F64


def test_copy_cases_transpose_and_cmul():
    z = torch.from_numpy(_z(5, batch=2))
    assert torch.equal(ms.stage(z, "noop"), z)
    for t in ("transpose 32", "transpose 64"):
        assert torch.equal(ms.stage(z, t), z.transpose(1, 2))
    tw4 = sf.kernel_tables(512 * 512, torch.complex128, torch.device("cpu"))[0]
    assert torch.equal(ms.stage(z, "cmul"), z * tw4)


# ----------------------------------------------------------------- passes

def _blocks(nb, b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (nb, b)).astype(np.float32))


def _taps(b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(b // 2) * np.exp(-np.arange(b // 2) / 30.0)


@pytest.mark.parametrize("b,precision", [(256, "high"), (256, "fast"),
                                         (1024, "fast")])
def test_passes_compose_to_the_jax_block_convolution(b, precision):
    import jax.numpy as jnp

    from audio_fir_filter_tpu.ops import fft_core as fc
    from audio_fir_filter_tpu.ops import pallas_fft as pf

    x = _blocks(4, b, seed=b)
    taps = _taps(b, seed=b + 1)
    cdt = torch.complex128 if precision == "high" else torch.complex64
    H = torch.from_numpy(sf.spectrum_layout(taps, b)).to(cdt)
    y = pm.k3(pm.k2(pm.k1(x, H), H), H)
    full = fpd.phases(x, H, "full")
    ref = cb.reference(x, pm.conv_plan(H))

    arith = fc.ARITH_DF64 if precision == "high" else fc.ARITH_F32
    karith = pf._kernel_arith(arith)
    hp = np.zeros(b)
    hp[: len(taps)] = taps[::-1]      # spectrum_layout reverses the taps
    H2 = pf.wrap_spectrum(pf.kernel_spectrum_np(hp, b, arith), arith)
    cc = dict(pf.conv_tables(b, karith.name), H=H2)
    r, c = fc.fourstep_split(b)
    yj = np.asarray(pf._conv_xla_mirror(jnp.asarray(x.numpy()), cc, r, c,
                                        karith))
    for got in (y, full):
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert _rel_err(got.numpy(), yj) < REL_F32
        assert _rel_err(got.numpy(), ref.numpy()) < REL_F32


@pytest.mark.parametrize("b", [256, 2048])
def test_k1_then_k2a_is_the_fourstep_fft_in_the_kernels_order(b):
    from audio_fir_filter_tpu.ops import fft_core as fc

    x = _blocks(2, b, seed=7)
    H = torch.from_numpy(sf.spectrum_layout(_taps(b, 8), b))
    got = pm.k2a(pm.k1(x, H), H)[0].numpy()
    z = x[0].double().numpy() + 1j * x[1].double().numpy()
    r, c = fc.fourstep_split(b)
    y = fc.fourstep_fft_np(z, r, c)                 # [c, r]
    natural = np.empty(b, complex)
    sr, sc = fc.pease_sigma(r), fc.pease_sigma(c)
    natural[sr[None, :] + r * sc[:, None]] = y
    l1, l2 = sf.split(b)
    order = sf._bitrev(l1)[:, None] + (1 << l1) * sf._bitrev(l2)[None, :]
    assert _rel_err(got, natural[order]) < REL_F64
    assert _rel_err(got, np.fft.fft(z)[order]) < REL_F64


def test_k2_is_the_row_convolution_times_n2():
    b = 256
    x = _blocks(2, b, seed=9)
    H = torch.from_numpy(sf.spectrum_layout(_taps(b, 10), b))
    s = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 16, 16)) + 0j)
    got = pm.k2(s.clone(), H)[0].numpy()
    n2 = 16
    hnat = H.numpy()[:, sf._bitrev(4)]              # natural row spectra
    h = np.fft.ifft(hnat, axis=1)
    z = s[0].numpy()
    want = np.array([[sum(z[r, m] * h[r, (k - m) % n2] for m in range(n2))
                      for k in range(n2)] for r in range(16)]) * n2
    assert _rel_err(got, want) < REL_F64
    assert pm.k1(x, H).shape == (1, 16, 16)


@pytest.mark.parametrize("b", [256, 1 << 14])
def test_ablations_have_their_defined_outputs(b):
    x = _blocks(4, b, seed=12)
    H = torch.from_numpy(sf.spectrum_layout(_taps(b, 13), b))
    n1, n2 = sf.split_shape(b)
    ac = pm.k3_reference(pm.k1_reference(x, H), H)
    assert _rel_err(ac.numpy(), x.numpy() / n2) < 1e-6   # float32 output
    assert torch.equal(fpd.phases(x, H, "ac_only"), (x.double() / n2).float())
    assert torch.equal(fpd.phases(x, H, "copy"), x)
    b_only = fpd.phases(x, H, "b_only")
    want = pm.blocks_of(pm.k2_reference(pm.pairs_of(x, H.dtype), H))
    assert torch.equal(b_only, want)
    ones = torch.ones_like(H)
    assert _rel_err(fpd.phases(x, ones, "no_tr").numpy(), x.numpy()) < 1e-6
    no_tr, full = fpd.phases(x, H, "no_tr"), fpd.phases(x, H, "full")
    assert no_tr.shape == full.shape and bool(torch.isfinite(no_tr).all())
    # The contiguous tile store is a different layout only where a tile
    # holds fewer than N2 columns (tc = 8 from N2 = 16 up).
    assert torch.equal(no_tr, full) == (fpd.tile_columns(b) == n2)


def test_tile_layouts_are_inverse_permutations():
    s = torch.arange(2 * 128 * 128).reshape(2, 128, 128)
    for tc in (16, 64, 128):
        c = fpd._tiles_contiguous(s, tc)
        assert torch.equal(fpd._tiles_strided(c, tc), s)
        # column tile t is one contiguous run
        assert torch.equal(c.reshape(2, -1)[0, : 128 * tc],
                           s[0, :, :tc].reshape(-1))


# ------------------------------------------------------------ fused block

_ROOT = pm.__file__.rsplit("/audio_fir_filter_tpu_torch/", 1)[0]


def _jax_fused_probe():
    """``experiments/fused_phase_decomp.py`` of the JAX package's probes,
    loaded from its file (``experiments/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_fused_phase_decomp", f"{_ROOT}/experiments/fused_phase_decomp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_FLAGS = {"full": dict(do_a=True, do_tr=True, do_b=True, do_c=True),
              "copy": dict(do_a=False, do_tr=False, do_b=False, do_c=False)}


@pytest.mark.parametrize("variant", ["full", "copy"])
@pytest.mark.parametrize("arith", ["f32", "df64"])
def test_fused_plain_versions_match_the_jax_probe_kernel(arith, variant,
                                                         monkeypatch):
    """The TPU probe's kernel (``make_variant``, its 38,401 seeded taps)
    run in interpret mode on one pair at B = 2^16, the smallest B those
    taps allow; the port's spectrum gets the taps reversed, since
    ``spectrum_layout`` reverses them."""
    import functools

    from jax.experimental import pallas as pl

    from audio_fir_filter_tpu.ops import fft_core as fc
    from audio_fir_filter_tpu_torch.experiments import _probe

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jfpd = _jax_fused_probe()
    b = 1 << 16
    r, c = fc.fourstep_split(b)
    x = np.random.default_rng(21).uniform(-1, 1, (1, 2, r, c)).astype(np.float32)
    a = fc.ARITH_F32 if arith == "f32" else fc.ARITH_DF64
    yj = np.array(jfpd.make_variant(b, a, **_JAX_FLAGS[variant])(x))
    taps = np.random.default_rng(0).standard_normal(pm.TAPS) / 196.0
    cdt = torch.complex64 if arith == "f32" else torch.complex128
    plan = fpd.fused_plan(torch.from_numpy(sf.spectrum_layout(taps[::-1], b)).to(cdt))
    got = fpd.fused(torch.from_numpy(x.reshape(2, b)), plan, variant)
    rel = _probe.REL_F32 if arith == "f32" else _probe.REL_F64
    _probe.expect(f"fused {arith} {variant}", got,
                  torch.from_numpy(yj.reshape(2, b)),
                  None if variant == "copy" else rel)


@pytest.mark.parametrize("b", [16, 256, 4096])
def test_split_step_is_rfft_and_irfft(b):
    m = b // 2
    rng = np.random.default_rng(b)
    x = torch.from_numpy(rng.standard_normal((3, b)))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    X = fpd.split_forward(torch.fft.fft(z))
    assert _rel_err(X.numpy(), torch.fft.rfft(x).numpy()) < REL_F64
    hn = np.fft.rfft(rng.standard_normal(b))
    Y = torch.fft.rfft(x) * torch.from_numpy(hn)
    zy = torch.fft.ifft(fpd.split_inverse(Y))
    y = torch.fft.irfft(Y, n=b)
    assert _rel_err(zy.real.numpy(), y[:, 0::2].numpy()) < REL_F64
    assert _rel_err(zy.imag.numpy(), y[:, 1::2].numpy()) < REL_F64
    # alpha, beta: the split, the product and the inverse split in one step
    ab = fpd.split_coefficients(hn)
    Z = torch.fft.fft(z).numpy()
    k = np.arange(m)
    widely = ab[:, 0] * Z + ab[:, 1] * np.conj(Z[:, (m - k) % m])
    assert _rel_err(widely, fpd.split_inverse(Y).numpy()) < REL_F64


@pytest.mark.parametrize("b,cdt", [(256, torch.complex128), (256, torch.complex64),
                                   (1 << 12, torch.complex64),
                                   (1 << 16, torch.complex128)])
def test_fused_phases_compose_to_the_block_convolution(b, cdt):
    x = _blocks(3, b, seed=22)
    plan = fpd.fused_plan(torch.from_numpy(sf.spectrum_layout(_taps(b, 23), b)).to(cdt))
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    z = fpd._z(x, rdt)
    y = fpd._real(fpd.cols_inverse(fpd.rows_phase(fpd.cols_forward(z, plan), plan),
                                   plan))
    ref = cb.reference(x, pm.conv_plan(plan.H))
    assert _rel_err(y.numpy(), ref.numpy()) < (REL_F32 if rdt == torch.float32
                                               else 1e-7)
    assert torch.equal(fpd.fused(x, plan, "full"), ref)
    # kernel order of alpha / beta only where the kernel runs (B = 2^18)
    assert plan.ab_lanes is None and plan.ab.shape == (*sf.split_shape(b // 2), 2)


def test_fused_ablations_have_their_defined_outputs():
    b = fpd.BLOCK
    x = _blocks(2, b, seed=24)
    for cdt in (torch.complex64, torch.complex128):
        H = torch.from_numpy(sf.spectrum_layout(_taps(b, 25), b)).to(cdt)
        plan, flat = fpd.fused_plan(H), fpd.fused_plan(torch.ones_like(H))
        rdt = torch.float64 if cdt == torch.complex128 else torch.float32
        assert torch.equal(fpd.fused(x, plan, "copy"), x)
        assert torch.equal(fpd.fused(x, plan, "ac_only"), (x.to(rdt) / 256).float())
        ac = fpd._real(fpd.cols_inverse(fpd.cols_forward(fpd._z(x, rdt), plan), plan))
        assert _rel_err(ac.numpy(), x.numpy() / 256) < 1e-6
        # b_only: the row phase on the natural rows; with a flat spectrum
        # (alpha 1, beta 0) each row's FFT and unscaled inverse: x * 256
        assert torch.equal(fpd.fused(x, plan, "b_only"),
                           fpd._real(fpd.rows_phase(fpd._z(x, rdt), plan)))
        assert _rel_err(fpd.fused(x, flat, "b_only").numpy(), x.numpy() * 256) < 1e-6
        # no_tr: a permutation around the row phase, the identity when the
        # row phase is one, not the convolution otherwise
        assert _rel_err(fpd.fused(x, flat, "no_tr").numpy(), x.numpy()) < 1e-6
        no_tr, full = fpd.fused(x, plan, "no_tr"), fpd.fused(x, plan, "full")
        assert bool(torch.isfinite(no_tr).all())
        assert _rel_err(no_tr.numpy(), full.numpy()) > 0.1
        assert plan.ab_lanes.shape == (512, 8, 32, 2)
        # register m of lane t holds column q = 8 t + m
        assert torch.equal(plan.ab_lanes[:, 3, 5], plan.ab[:, 8 * 5 + 3])
    small = fpd.fused_plan(torch.from_numpy(sf.spectrum_layout(_taps(256, 26), 256)))
    with pytest.raises(ValueError, match="B = 2\\^18"):
        fpd.fused(_blocks(2, 256, seed=27), small, "no_tr")


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_band_as_slab_is_the_kernels_band_read_as_its_slab(mode):
    """CTA r's home holds its band as [kCols / kW][512][kW] (batch, row,
    column); no_tr reads those bytes as its slab [kRows][256], whose row j
    the row phase treats as row prow(r, j)."""
    c, w = fpd.CLUSTER[mode], fpd.THREADS[mode] // 64
    cols, rows = 256 // c, 512 // c
    z = torch.arange(2 * 512 * 256, dtype=torch.float64).reshape(2, 512, 256)
    s = fpd.band_as_slab(z, mode)
    for r in (0, 1, c - 1):
        home = np.stack([z[1, :, cols * r + w * bb: cols * r + w * (bb + 1)].numpy()
                         for bb in range(cols // w)]).reshape(-1)
        for j in (0, rows // 2, rows - 1):
            assert np.array_equal(s[1, fpd.prow(mode, r, j)].numpy(),
                                  home[256 * j: 256 * (j + 1)])
    assert torch.equal(fpd.band_as_slab(s, mode, inverse=True), z)


# Mirrors of csrc/probe_phases.cu's maps (prow is fpd.prow).

def _warp_rows(rows, r, i):
    """Slab rows of row pair i (warp i % warps takes pairs i, i + warps, ...)."""
    if r:
        return i, rows - 1 - i
    if i == 0:
        return 0, 1
    h = 1 << (i.bit_length() - 1)
    return i + h, 5 * h - 1 - i


def _brev8(v):
    return int(fs.bitrev(np.int64(v), 8))


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_fused_maps_pair_every_bin_within_a_warp(mode):
    c = fpd.CLUSTER[mode]
    rows, warps = 512 // c, fpd.THREADS[mode] // 32
    assert rows // 2 % warps == 0           # kPairs pairs a warp
    m = fpd.BLOCK // 2
    partner = fpd._partner_np(m).reshape(512, 256)
    assert sorted(fpd.prow(mode, r, j) for r in range(c)
                  for j in range(rows)) == list(range(512))
    for r in range(c):
        seen = []
        for i in range(rows // 2):
            ja, jb = _warp_rows(rows, r, i)
            seen += [ja, jb]
            pa, pb = fpd.prow(mode, r, ja), fpd.prow(mode, r, jb)
            own = r == 0 and i == 0
            for q in range(256):
                # the kernel's partner of (pa, q) and of (pb, q)
                qa = _brev8((256 - _brev8(q)) & 255) if own else 255 - q
                assert partner[pa, q] == (pa if own else pb) * 256 + qa
                assert partner[pb, q] == (pb if own else pa) * 256 + 255 - q
        assert sorted(seen) == list(range(rows))


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_fused_exchange_covers_every_band_place_once(mode):
    """Element n2 = pos<0>(t, m) = t + 32 m of row p goes to CTA n2 // kCols,
    region (n2 % kCols) // kW, place p kW + n2 % kW (band_addr): each place
    of every CTA's home once; a warp's lanes cover runs of kW elements."""
    c, w = fpd.CLUSTER[mode], fpd.THREADS[mode] // 64
    cols = 256 // c
    nbat = cols // w
    p, n2 = np.meshgrid(np.arange(512), np.arange(256), indexing="ij")
    cc = n2 % cols
    flat = ((n2 // cols) * nbat + cc // w) * 512 * w + p * w + cc % w
    assert np.array_equal(np.sort(flat.ravel()), np.arange(512 * 256))
    elem = 8 if mode == "f32" else 16
    lanes = (((np.arange(32) % cols) // w) * 512 * w + np.arange(32) % cols % w) * elem
    runs = lanes.reshape(-1, w)
    assert (np.diff(runs, axis=1) == elem).all()
    # shared memory: the 128 KB home, the 64 KB stage, the two stage-table
    # sets (511 + 255 entries), two mbarriers; one CTA a SM
    smem = 131072 + 65536 + (511 + 255) * elem + 16
    assert smem <= SMEM_PER_CTA < 2 * smem
    assert (w * 64, nbat * w * c) == (fpd.THREADS[mode], 256)


def test_fused_wrapper_rejects_shapes_and_launches_with_no_scratch(monkeypatch):
    from audio_fir_filter_tpu_torch.experiments import _probe

    H = torch.from_numpy(sf.spectrum_layout(_taps(256, 28), 256)).to(torch.complex64)
    small = fpd.fused_plan(H)
    with pytest.raises(ValueError, match="blocks must be"):
        fpd.fused(torch.zeros((2, 128)), small, "full")
    with pytest.raises(ValueError, match="blocks must be"):
        fpd.fused(torch.zeros((2, 256), dtype=torch.float64), small, "full")
    with pytest.raises(ValueError, match="blocks must be"):
        fpd.fused(torch.zeros((0, 256)), small, "full")
    with pytest.raises(ValueError, match="variant"):
        fpd.fused(torch.zeros((2, 256)), small, "passes full")
    with pytest.raises(ValueError, match="complex64 or complex128"):
        fpd.fused_plan(H.real.contiguous())
    calls, made = [], []
    monkeypatch.setattr(_probe, "on_card", lambda *t: True)
    monkeypatch.setattr(_probe, "launch", lambda *a: calls.append(a))
    for name in ("empty", "zeros", "empty_like"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (
            made.append(_n), _r(*a, **k))[1])
    with pytest.raises(ValueError, match="B = 2\\^18"):
        fpd.fused(torch.zeros((2, 256)), small, "full")
    plan = fpd.fused_plan(torch.ones((512, 512), dtype=torch.complex128))
    before = dict(fpd.launches)
    x = torch.zeros((3, fpd.BLOCK))
    made.clear()
    for v in fpd.VARIANTS:
        out = fpd.fused(x, plan, v)
        assert out.shape == x.shape and out.dtype == torch.float32
    assert made == ["empty_like"] * len(fpd.VARIANTS)     # the output only
    assert [a[9:] for a in calls] == [(None, 3, 9, 8, fpd.FUSED_IDS[v])
                                      for v in fpd.VARIANTS]
    assert all(a[1] == "lowcut_probe_phases_f64" for a in calls)
    assert fpd.launches["probe_phases_f64"] == before["probe_phases_f64"] + 5


def test_fused_cpu_path_builds_nothing_and_counts_no_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(fpd.launches)
    plan = fpd.fused_plan(torch.from_numpy(sf.spectrum_layout(_taps(1024, 29), 1024)))
    for v in ("full", "copy", "ac_only", "b_only"):
        fpd.fused(_blocks(2, 1024, seed=30), plan, v)
    assert dict(fpd.launches) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fpd.fused_occupancy("cuda")
    with pytest.raises(ValueError, match="time a CUDA card"):
        fpd.fused_occupancy("cpu")


# ------------------------------------------------------- floors, copies

@pytest.mark.parametrize("variant", cfp.VARIANTS)
def test_copy_floor_variants_are_the_identity(variant):
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1, 2, 512, 512)).astype(np.float32))
    assert torch.equal(cfp.copy_floor(x, variant), x)


def test_passthru_and_bw_plain_versions():
    x = torch.rand((2, 2, 512, 512))
    assert torch.equal(dfp.passthru(x), x)
    xb = torch.rand((3, 32, 512)) - 0.5
    assert torch.equal(bwm.bw(xb, "both", 4), xb)
    s = bwm.bw(xb, "in", 1)
    assert s.dtype == torch.float64 and torch.allclose(
        s, torch.from_numpy(xb.numpy().astype(np.float64).sum(axis=(1, 2))))
    out = bwm.bw(xb, "out", 1)
    assert out[2, 17, 5].item() == 2 * 8192 + 1 * 512 + 5
    assert torch.equal(bwm.bw(xb, "none"), torch.ones((3, 8, 512)))
    assert bwm.moved_bytes("both", 128, 512) == 2 * 128 * 512 * 512 * 4


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):
        bwm.bw(torch.zeros((2, 20, 512)), "both")
    with pytest.raises(ValueError, match="mode"):
        bwm.bw(torch.zeros((2, 16, 512)), "sideways")
    with pytest.raises(ValueError, match="split"):
        bwm.bw(torch.zeros((2, 16, 512)), "in", 3)
    with pytest.raises(ValueError, match="variant"):
        cfp.copy_floor(torch.zeros((1, 2, 512, 512)), "fast")
    with pytest.raises(ValueError, match=r"\[g, 2, 512, 512\]"):
        dfp.passthru(torch.zeros((1, 2, 512, 256)))
    H = torch.zeros((16, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="even"):
        fpd.phases(torch.zeros((3, 256)), H, "full")
    with pytest.raises(ValueError, match="complex64 or complex128"):
        pm.k1(torch.zeros((2, 256)), H.real)
    with pytest.raises(ValueError, match="scratch"):
        pm.k2(torch.zeros((1, 16, 8), dtype=torch.complex64), H)
    with pytest.raises(ValueError, match="unknown case"):
        ms.stage(torch.zeros((1, 512, 512), dtype=torch.complex64), "r16")
    with pytest.raises(ValueError, match="case must be one of"):
        ms2.chain(torch.zeros((1, 512, 512), dtype=torch.complex64), "cmul")


def test_cluster_and_ring_plain_versions_count_no_launch_on_the_cpu(monkeypatch):
    from audio_fir_filter_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(cfp.launches), dict(bwm.launches)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (2, 2, 512, 512)).astype(np.float32))
    assert torch.equal(cfp.copy_floor(x, "cluster"), x)
    xb = torch.rand((3, 48, 512)) - 0.5
    for ring in bwm.RINGS:
        assert torch.equal(bwm.bw_ring(xb, *ring), xb)
    assert torch.equal(cfp.copy_floor(x, "cluster16"), x)
    assert (dict(cfp.launches), dict(bwm.launches)) == before
    assert cfp.moved_bytes("cluster", x) == 2 * x.numel() * 4
    assert cfp.moved_bytes("cluster16", x) == 2 * x.numel() * 4
    assert cfp.moved_bytes("tr", x) == 6 * x.numel() * 4


def test_ring_and_cluster_wrappers_reject_what_the_kernels_do_not_take(
        monkeypatch):
    x = torch.zeros((2, 16, 512))
    with pytest.raises(ValueError, match="stages"):
        bwm.bw_ring(x, 3, False)
    with pytest.raises(ValueError, match="stages"):
        bwm.bw_ring(x, 6, False)
    with pytest.raises(ValueError, match="ctas"):
        bwm.bw_ring(x, 4, True, -1)
    with pytest.raises(ValueError, match="multiple of 16"):
        bwm.bw_ring(torch.zeros((2, 24, 512)), 4, True)
    with pytest.raises(ValueError, match="split"):
        bwm.bw(x, "both", 2)
    with pytest.raises(ValueError, match="variant"):
        cfp.copy_floor(torch.zeros((1, 2, 512, 512)), "clusters")
    with pytest.raises(ValueError, match=r"\[pairs, 2, 512, 512\]"):
        cfp.copy_floor(torch.zeros((1, 2, 256, 512)), "cluster")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cfp.cluster_occupancy("cuda")
    with pytest.raises(ValueError, match="time a CUDA card"):
        cfp.cluster_occupancy("cpu")


# ------------------------------- mirror: the cluster-resident copy floor
# csrc/probe_floors.cu cf_cluster<C>: CTA r of a plane's cluster of C
# holds its slab ([R][128] float4, rows R r .., R = 512 / C), then its band
# ([512][R / 4] float4, columns R r ..), then its slab again; thread
# t = g * B + e (B = R * R / 4, the float4 of a block) moves, in round
# K = G k + g (G = threads / B), the float4 (lr, q) = (e // (R / 4),
# e % (R / 4)) of the R x R block it shares with peer p = (r + K) % C.

SMEM_PER_CTA = 232448          # 227 KB: what a CTA of the card may use


def _cluster_maps(c):
    """Per (CTA r, thread t, k): the round, the peer read and the float4
    index read there and written locally, for the first and the second
    all-to-all."""
    threads = cfp.CLUSTER_THREADS[c]
    rows = 512 // c
    row4, block4 = rows // 4, rows * rows // 4
    groups = threads // block4
    r, t, k = np.meshgrid(np.arange(c), np.arange(threads),
                          np.arange(c // groups), indexing="ij")
    g, e = t // block4, t % block4
    lr, q = e // row4, e % row4
    rnd = groups * k + g
    p = (r + rnd) % c
    first = dict(round=rnd, peer=p, src=lr * 128 + r * row4 + q,
                 dst=p * block4 + e)
    second = dict(round=rnd, peer=p, src=r * block4 + e,
                  dst=lr * 128 + p * row4 + q)
    return first, second


def _exchange(own, m):
    """One all-to-all: every read (into registers) before any write, as the
    kernel's cluster.sync between them orders it."""
    v = own[m["peer"], m["src"]]
    out = np.empty_like(own)
    out[np.arange(own.shape[0])[:, None, None], m["dst"]] = v
    return out


@pytest.mark.parametrize("variant", sorted(cfp.CLUSTERS))
def test_cluster_exchange_maps_are_permutations_that_compose_to_identity(
        variant):
    c = cfp.CLUSTERS[variant]
    first, second = _cluster_maps(c)
    n4 = 512 * 512 // 4                        # float4 of a plane
    for m in (first, second):
        # Each CTA's shared-memory float4 is read once and written once.
        read = m["peer"] * (n4 // c) + m["src"]
        assert np.array_equal(np.sort(read.ravel()), np.arange(n4))
        wrote = np.arange(c)[:, None, None] * (n4 // c) + m["dst"]
        assert np.array_equal(np.sort(wrote.ravel()), np.arange(n4))
    plane = np.random.default_rng(16).standard_normal((512, 512)).astype(np.float32)
    slabs = plane.reshape(c, n4 // c, 4)       # CTA r: rows [R r, R r + R)
    bands = _exchange(slabs, first)
    w = 512 // c
    for r in range(c):                         # band r: columns R r .., row-major
        assert np.array_equal(bands[r].reshape(512, w),
                              plane[:, w * r: w * (r + 1)])
    assert np.array_equal(_exchange(bands, second), slabs)


@pytest.mark.parametrize("variant", sorted(cfp.CLUSTERS))
def test_cluster_rounds_read_distinct_peers_and_fit_shared_memory(variant):
    c = cfp.CLUSTERS[variant]
    for m in _cluster_maps(c):
        for rnd in range(c):
            at = m["round"] == rnd
            peers = [set(m["peer"][r][at[r]].tolist()) for r in range(c)]
            assert all(len(ps) == 1 for ps in peers)
            assert len({ps.pop() for ps in peers}) == c  # no two CTAs on one peer
        # 16 bytes a thread on consecutive addresses: each 8-lane phase of a
        # 16-byte access covers 128 contiguous bytes, every bank once.
        for key in ("src", "dst"):
            lanes = m[key][0, :, 0].reshape(-1, 8)
            assert (np.diff(lanes, axis=1) == 1).all()
    # The slab, then the band in its place, and an mbarrier; the block in
    # flight sits in registers (32 floats a thread): a second buffer of the
    # 128 KB slab would not fit beside it.
    smem = cfp.cluster_smem(c)
    assert smem == 512 * 512 * 4 // c + 16 <= SMEM_PER_CTA
    assert cfp.CLUSTER_THREADS[c] * 32 * 4 == smem - 16
    assert 2 * cfp.cluster_smem(8) > SMEM_PER_CTA
    # cluster16: two CTAs (of two planes) fit one SM; cluster: one.
    assert (SMEM_PER_CTA // smem, 2048 // cfp.CLUSTER_THREADS[c]) >= (
        (1, 2) if c == 8 else (2, 2))


# --------------------------------------------- mirror: bw's TMA ring
# csrc/probe_floors.cu bw_ring: CTA c of G walks the 32 KB tiles c, c + G,
# c + 2 G, ... (strided) or [c T // G, (c + 1) T // G) (contiguous); its
# j-th tile uses stage j % S; thread 0 issues the bulk copies. Each
# function below is the issuing thread's program as the kernel runs it,
# replayed against a model of the bulk groups (a store group has read its
# stage once a later wait_group.read N leaves at most N groups after it).

_TILE = bwm.TILE_ROWS * bwm.COLS * 4           # bytes a stage


class _Ring:
    def __init__(self, c, ctas, tiles, stages, split, strided):
        if strided:                             # tiles c, c + G, ...
            self.tile = lambda j: c + j * ctas
            self.n = (tiles - c + ctas - 1) // ctas
        else:                                   # [c T // G, (c + 1) T // G)
            t0 = tiles * c // ctas
            self.tile = lambda j: t0 + j
            self.n = tiles * (c + 1) // ctas - t0
        self.S, self.split = stages, split
        self.slot = [None] * stages             # (tile, state) per stage
        self.groups = 0                         # store groups committed
        self.read_done = 0                      # groups that have read
        self.loaded, self.stored = [], []       # tiles
        self.copies = {"load": [], "store": []}  # (byte offset, bytes)

    def _copies(self, kind, j):
        piece = _TILE // self.split
        base = self.tile(j) * _TILE
        for g in range(self.split):
            self.copies[kind].append((base + g * piece, piece))
        assert _TILE < 1 << 20                  # one mbarrier phase's expect_tx

    def load(self, j):
        s = j % self.S
        prev = self.slot[s]
        if prev is not None:                    # refill: that tile is done with
            assert prev[1] in ("stored", "consumed")
            if prev[1] == "stored":
                assert prev[2] < self.read_done, "refilled before its store read it"
        self._copies("load", j)
        self.slot[s] = (j, "loaded")
        self.loaded.append(self.tile(j))

    def write(self, j):                          # `out`: the threads' pattern
        s = j % self.S
        prev = self.slot[s]
        if prev is not None:
            assert prev[1] == "stored" and prev[2] < self.read_done
        self.slot[s] = (j, "loaded")

    def store(self, j):
        s = j % self.S
        assert self.slot[s] == (j, "loaded")
        self._copies("store", j)
        self.slot[s] = (j, "stored", self.groups)
        self.groups += 1
        self.stored.append(self.tile(j))

    def consume(self, j):
        s = j % self.S
        assert self.slot[s] == (j, "loaded")
        self.slot[s] = (j, "consumed")

    def wait_read(self, n_pending):
        self.read_done = max(self.read_done, self.groups - n_pending)


def _both(ring):
    S, n = ring.S, ring.n
    for j in range(min(S, n)):
        ring.load(j)
    for j in range(n):
        ring.store(j)
        if j >= 1 and j - 1 + S < n:
            ring.wait_read(1)
            ring.load(j - 1 + S)
    ring.wait_read(0)


def _in(ring):
    S, n = ring.S, ring.n
    for j in range(n):
        if j >= S:
            ring.consume(j - S)                 # the consumers' empty arrival
        ring.load(j)
    for j in range(max(n - S, 0), n):
        ring.consume(j)


def _out(ring):
    S, n = ring.S, ring.n
    released = set(range(min(S, n)))           # first use: no wait
    for j in range(n):
        assert j in released                    # the writers' empty wait
        ring.write(j)
        ring.store(j)
        if j + 1 >= S and j + 1 < n:
            ring.wait_read(S - 1)
            released.add(j + 1)
    ring.wait_read(0)


def _cover(copies, total):
    """The bulk copies: 16-byte aligned multiples of 16 bytes that cover
    [0, total) once."""
    copies = sorted(copies)
    assert all(a % 16 == 0 and ln % 16 == 0 for a, ln in copies)
    ends = [a + ln for a, ln in copies]
    assert copies[0][0] == 0 and ends[-1] == total
    assert all(e == a for e, (a, _) in zip(ends, copies[1:]))


@pytest.mark.parametrize("split", bwm.SPLITS)
@pytest.mark.parametrize("rows", bwm.ROWS)
def test_bw_ring_schedule_moves_each_byte_once_and_waits_for_reads(rows, split):
    tiles = bwm.STEPS * rows // bwm.TILE_ROWS
    total = tiles * _TILE
    assert total == bwm.moved_bytes("in", bwm.STEPS, rows)
    # 132 resident CTAs (one a SM) and the sweep's grids, every ring the
    # kernel is built for (the shipped one for `in` and `out`, and for
    # `both` at split 4).
    shipped = ((bwm.STAGES, bwm.STRIDED),)
    for ctas in (132, *[c for c in bwm.RING_CTAS if c]):
        for mode, program, rings in (
                ("both", _both, bwm.RINGS if split == 1 else shipped),
                ("in", _in, shipped), ("out", _out, shipped)):
            for stages, strided in rings:
                loads, stores = [], []
                copies = {"load": [], "store": []}
                for c in range(ctas):
                    ring = _Ring(c, ctas, tiles, stages, split, strided)
                    program(ring)
                    assert ring.read_done == ring.groups  # all read at exit
                    loads += ring.loaded
                    stores += ring.stored
                    for kind in copies:
                        copies[kind] += ring.copies[kind]
                want = list(range(tiles))
                # Each byte loaded once (both, in) and stored once (both, out).
                assert sorted(loads) == (want if mode != "out" else [])
                assert sorted(stores) == (want if mode != "in" else [])
                for kind in copies:
                    if copies[kind]:
                        _cover(copies[kind], total)


def test_bw_ring_fits_shared_memory_and_mbarrier_counts():
    for stages in {s for s, _ in bwm.RINGS}:
        smem = stages * _TILE + 2 * stages * 8 + stages * 8 * 8
        assert smem <= SMEM_PER_CTA
    # Two rings of the shipped depth do not fit one SM: one CTA a SM.
    assert 2 * (bwm.STAGES * _TILE) > SMEM_PER_CTA
    for split in bwm.SPLITS:
        assert _TILE % split == 0 and (_TILE // split) % 16 == 0


# --------------------------------------------------- device rule, build

@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__.split(".")[-1])
def test_probe_refuses_cuda_without_a_card_and_the_cpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (mod.run, mod.verify):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn("cuda")
        with pytest.raises(ValueError, match="time a CUDA card"):
            fn("cpu")


def test_cpu_wrappers_build_nothing_and_count_no_launch(monkeypatch):
    from audio_fir_filter_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    before = [dict(m.launches) for m in MODULES]
    x = torch.zeros((2, 256))
    H = torch.ones((16, 16), dtype=torch.complex64)
    fpd.phases(x, H, "full")
    pm.k3(pm.k2(pm.k1(x, H), H), H)
    ms.stage(torch.zeros((1, 512, 512), dtype=torch.complex64), "fwd r4")
    ms2.chain(torch.zeros((1, 512, 512), dtype=torch.complex64), "fwd r8")
    cfp.copy_floor(torch.zeros((1, 2, 512, 512)), "hint")
    dfp.passthru(torch.zeros((1, 2, 512, 512)))
    bwm.bw(torch.zeros((1, 16, 512)), "in")
    assert [dict(m.launches) for m in MODULES] == before


def test_probe_families_are_built_with_their_argtypes():
    import ctypes

    from audio_fir_filter_tpu_torch.ops import _build

    assert list(_build.FAMILIES) == ["segment_filter", "conv_blocks",
                                     "probe_floors", "probe_phases",
                                     "probe_stages", "probe_segment"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries, args = _build.FAMILIES["probe_floors"]
    assert entries == ("lowcut_probe_empty", "lowcut_probe_passthru",
                       "lowcut_probe_bw", "lowcut_probe_bw_ring",
                       "lowcut_probe_copy_floor",
                       "lowcut_probe_cluster_occupancy")
    assert args == [p, p, p, ll, ll, ll, i, p]
    entries, args = _build.FAMILIES["probe_phases"]
    assert entries == ("lowcut_probe_phases_f32", "lowcut_probe_phases_f64",
                       "lowcut_probe_fused_occupancy")
    assert args == [p] * 7 + [ll, i, i, i, p]
    entries, args = _build.FAMILIES["probe_stages"]
    assert entries == ("lowcut_probe_stages_f32", "lowcut_probe_stages_f64")
    assert args == [p, p, p, ll, i, i, p]
    for name in _build.FAMILIES:
        assert (_build.CSRC / f"{name}.cu").is_file()


# ------------------------------------------- mirror: the ring chain
# csrc/probe_stages.cu ring_chain: CTA c of G walks the items c, c + G, ...
# of batch x (512 / kW) column slabs [512, kW] (128 B a row, 64 KB), each
# through a ring of kRingStages shared-memory stages with one mbarrier a
# stage; Fft<T, 9> in registers with its exchanges through the stage; the
# slab stored back in the output order. Thread 0 issues the copies: two
# tensor-map boxes of 256 rows each way a slab.


def _cu_const(name):
    src = (_build.CSRC / "probe_stages.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


_RING_S, _BOX_ROWS = _cu_const("kRingStages"), _cu_const("kBoxRows")
_ELEM = {"f32": 8, "f64": 16}                   # bytes of a complex element
_KW = {m: 128 // e for m, e in _ELEM.items()}   # transforms a slab
_SLAB = 512 * 128                               # bytes a slab


def _ring_out_row(order, p):
    """out_row<kOrder>: the row bin bitrev9(p) is stored at."""
    p = np.asarray(p)
    if order == "r2":
        return p
    return ((fs.bitrev(p >> 6, 3) << 6) | (fs.bitrev((p >> 3) & 7, 3) << 3)
            | fs.bitrev(p & 7, 3))


def _ring_items(c, ctas, items):
    n = (items - c + ctas - 1) // ctas
    return [c + j * ctas for j in range(n)]


def test_ring_cases_give_the_sweeps_plain_outputs():
    for dtype in (torch.complex64, torch.complex128):
        z = torch.from_numpy(_z(20, batch=2)).to(dtype)
        assert torch.equal(ms.stage(z, "fwd ring"), ms.stage(z, "fwd r2"))
        assert torch.equal(ms.stage(z, "fwd ring r8"), ms.stage(z, "fwd r8"))
        assert torch.equal(ms2.chain(z, "fwd ring r8"), ms2.chain(z, "fwd r8"))
        assert torch.equal(ms2.chain(z, "fwd reg"), ms.stage(z, "fwd r2"))


@pytest.mark.parametrize("order", ["r2", "r8"])
def test_ring_store_map_gives_the_chains_order(order):
    """Fft<T, 9>'s registers (the NumPy model of test_torch_fft_stages,
    positions pos<kStages - 1>) stored at out_row: the r2 plan's order
    (bit-reversed) or the r8 plan's (base-8 digit-reversed), as
    fc.dif_fft_np gives them."""
    from audio_fir_filter_tpu.ops import fft_core as fc

    p = fs.Plan(9)
    t = np.arange(p.NT)
    rows = np.concatenate([p.pos(p.NS - 1, t, m) for m in range(p.E)])
    assert sorted(_ring_out_row(order, rows)) == list(range(512))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512))
    got = np.empty_like(x)
    for i in range(len(x)):
        y = fs.forward(x[i], 9)                 # y[pos(last, t, m)] = v[m]
        for m in range(p.E):
            pp = p.pos(p.NS - 1, t, m)
            got[i, _ring_out_row(order, pp)] = y[pp]
    want = fc.dif_fft_np(x, _PLANS[order])
    assert _rel_err(got, want) < 1e-12


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_ring_walk_covers_every_slab_once(mode):
    kw = _KW[mode]
    slabs = 512 // kw
    for batch in (1, 8, 256):
        items = batch * slabs
        for resident in (132, 264):
            ctas = min(resident, items)
            walked = [i for c in range(ctas)
                      for i in _ring_items(c, ctas, items)]
            assert sorted(walked) == list(range(items))
            assert {(i // slabs, i % slabs * kw) for i in walked} == {
                (b, v) for b in range(batch) for v in range(0, 512, kw)}
            # No CTA idles while another has two more items than it.
            per = [len(_ring_items(c, ctas, items)) for c in range(ctas)]
            assert max(per) - min(per) <= 1


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_ring_fits_shared_memory_one_cta_a_sm(mode):
    """The ring, Fft<T, 9>'s table (kTableElems = kL - 1) and a barrier a
    stage fit a CTA; a second such CTA does not fit the SM, so the grid is
    one CTA a SM, as the source note says."""
    smem = _RING_S * _SLAB + (fs.Plan(9).L - 1) * _ELEM[mode] + _RING_S * 8
    assert smem <= SMEM_PER_CTA < 2 * smem


def _ring_copies(mode, item):
    """The (global byte offset, bytes) runs one item's load brings, and the
    bytes of each of its copies (two tensor-map boxes of 256 rows); z
    viewed as [batch * 512, 512] complex."""
    e, kw = _ELEM[mode], _KW[mode]
    slabs = 512 // kw
    row0, col0 = item // slabs * 512, item % slabs * kw
    box = (kw * e, _BOX_ROWS)                    # inner bytes, rows
    assert box[0] % 16 == 0 and 2 * kw <= 256 and _BOX_ROWS <= 256
    runs = [((row0 + h * _BOX_ROWS + r) * 512 + col0) * e
            for h in range(512 // _BOX_ROWS) for r in range(_BOX_ROWS)]
    copies = [box[0] * box[1]] * (512 // _BOX_ROWS)
    return [(a, kw * e) for a in runs], copies


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_ring_copies_match_expect_tx_and_cover_the_blocks(mode):
    slabs = 512 // _KW[mode]
    batch = 2
    runs = []
    for item in range(batch * slabs):
        r, copies = _ring_copies(mode, item)
        assert sum(copies) == _SLAB < 1 << 20    # one expect_tx a slab
        assert sum(n for _, n in r) == _SLAB
        runs += r
    _cover(runs, batch * 512 * 512 * _ELEM[mode])


class _RingChain:
    """One CTA's issuing thread as ring_chain runs it, against a model of
    its bulk groups, mbarrier phases and stages."""

    def __init__(self, n, stages):
        self.n, self.S = n, stages
        self.stage = [None] * stages            # (item j, state, group)
        self.phase = [0] * stages               # completed loads a stage
        self.groups = self.read_done = 0
        self.done = []

    def load(self, j):
        s = j % self.S
        prev = self.stage[s]
        if prev is not None:
            assert prev[1] == "stored" and prev[2] < self.read_done, \
                "stage refilled before its store read it"
        self.stage[s] = (j, "loaded", None)
        self.phase[s] += 1                      # expect_tx met by the copies

    def wait(self, j):
        s = j % self.S
        # mbar_wait(parity (j / S) & 1) returns once use j / S completed.
        assert self.phase[s] == j // self.S + 1 and self.stage[s][0] == j

    def compute_and_store(self, j):
        s = j % self.S
        assert self.stage[s][:2] == (j, "loaded")
        self.stage[s] = (j, "stored", self.groups)
        self.groups += 1
        self.done.append(j)

    def wait_read(self, pending):
        self.read_done = max(self.read_done, self.groups - pending)


def _ring_chain_program(cta):
    S, n = cta.S, cta.n
    for j in range(min(S, n)):
        cta.load(j)
    for j in range(n):
        cta.wait(j)
        cta.compute_and_store(j)
        if j >= 1 and j - 1 + S < n:
            cta.wait_read(1)
            cta.load(j - 1 + S)
    cta.wait_read(0)


@pytest.mark.parametrize("n", range(0, 12))
def test_ring_refills_a_stage_only_after_its_store_read_it(n):
    for stages in sorted({2, _RING_S}):
        cta = _RingChain(n, stages)
        _ring_chain_program(cta)
        assert cta.done == list(range(n))
        assert cta.read_done == cta.groups == n   # every store read at exit


@pytest.mark.parametrize("mode", ["f32", "f64"])
def test_ring_shared_accesses_are_free_of_bank_conflicts(mode):
    """Thread (t, w) = tid >> log2 kW, & (kW - 1): the slab load (row-major,
    pos<0>), the two exchanges (swizzled, stride kW) and the store in
    either order; 8-byte elements 16 lanes a phase over 16 bank units,
    16-byte ones 8 over 8."""
    kw = _KW[mode]
    lanes = 16 if mode == "f32" else 8
    p = fs.Plan(9)
    lane = np.arange(32)
    for warp in range(kw * p.NT // 32):
        tid = warp * 32 + lane
        w, t = tid % kw, tid // kw
        for m in range(p.E):
            pats = [p.pos(0, t, m) * kw + w]
            pats += [fs.swizzle(p.pos(s, t, m)) * kw + w for s in range(p.NS)]
            pats += [_ring_out_row(o, p.pos(p.NS - 1, t, m)) * kw + w
                     for o in ("r2", "r8")]
            for addr in pats:
                assert fs._max_conflict(addr, lanes, lanes) == 1


@pytest.mark.parametrize("fn,name", [(ms.stage, "fwd ring"),
                                     (ms2.chain, "fwd ring r8")])
def test_ring_wrappers_reject_what_the_kernel_does_not_take(fn, name):
    z = torch.zeros((2, 512, 512), dtype=torch.complex64)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((1, 512, 256), dtype=torch.complex64), name)
    with pytest.raises(ValueError, match="contiguous"):
        fn(z.transpose(1, 2), name)
    with pytest.raises(ValueError, match="complex64 or complex128"):
        fn(torch.zeros((1, 512, 512)), name)
    with pytest.raises(ValueError, match="batch"):
        fn(torch.zeros((0, 512, 512), dtype=torch.complex64), name)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fn(torch.zeros((1, 512, 512), dtype=torch.complex64, device="meta"),
           name)


def test_ring_cases_build_nothing_and_count_no_launch_on_the_cpu(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(ms.launches), dict(ms2.launches)
    z = torch.zeros((1, 512, 512), dtype=torch.complex128)
    ms.stage(z, "fwd ring")
    ms2.chain(z, "fwd ring r8")
    assert (dict(ms.launches), dict(ms2.launches)) == before
    assert ms.CASES["fwd ring"][0] == 14
    assert ms.CASES["fwd ring r8"][0] == 15
    assert "fwd ring r8" in ms2.CASES and "fwd ring r8" in ms2.LARGE
    assert "fwd ring" in ms.LARGE
