"""The port's ``range_filter_packed``, ``bloom_probe`` and ``ssm_scan``
against the JAX package's, on the CPU.

No engine configuration reaches these three kernels: the paper's Figure-5
pipeline (``examples/filter_analytics.py``) and the kernel micro-bench
(``benchmarks/bench_kernels.py``) do.  Each plain PyTorch version (what a
wrapper runs for tensors on the CPU) is held against the reference's
Pallas kernel in interpret mode at its (256, 128) tile and against its
``kernels.ops`` entry point:

* ``range_filter_packed``: bitmaps and per-tile counts bit for bit at
  widths 1-32, the plain version on the words as they are (a partial last
  tile read in place) and on the reference's padded input, with ranges
  reaching ``2**width - 1`` (the padding words' fields match them and are
  counted), empty ``lo > hi`` ranges, width 32 with ``hi = 0xFFFFFFFF``,
  and last tiles 5 words short, 3 words long and 1 word short of 3 tiles;
* ``bloom_probe``: hits bit for bit, including a bloom whose ``nbits``
  exceeds its words (the kernel reads the missing words as 0, a miss,
  where ``ref.bloom_probe`` clamps the index and hits), and no false
  negative for keys inserted by mix32;
* ``ssm_scan``: y and the final state within the reference test's own
  tolerance (rtol = atol = 3e-5) at its shapes and at state dimensions 48
  and 64, chunk 16 and 32; and the kernel's lane layout (``scan_layout``),
  which the CPU never launches but chooses from shapes alone.

The CUDA kernels are held against these plain versions on the card in
``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sct import bitpack as np_bitpack
from repro.kernels import bloom_probe as jbloom
from repro.kernels import ops as jops
from repro.kernels import packed_filter as jpacked
from repro.kernels import ref as jref
from repro_torch.kernels import bloom_probe, ops, packed_filter, ssm_scan
from test_torch_kernels import _t, _u32

WIDTHS = [1, 2, 4, 8, 16, 32]
BLOCK_ROWS = 256            # the reference kernels' default tile rows
TILE = BLOCK_ROWS * 128


def _pad(a: np.ndarray, fill) -> np.ndarray:
    out = np.full(-(-a.shape[0] // TILE) * TILE, fill, a.dtype)
    out[:a.shape[0]] = a
    return out


# --------------------------------------------------------------------------- #
# range_filter_packed
# --------------------------------------------------------------------------- #
def _range(kind, width, rng):
    top = 2 ** width - 1
    maxv = 2 ** min(width, 16)
    if kind == "top":            # reaches 2**width - 1: padding fields match
        return int(rng.integers(0, maxv)) % (top + 1), top
    if kind == "empty":
        return 5, 2
    a, b = sorted(rng.integers(0, maxv, 2).tolist())
    return a, b


@pytest.mark.parametrize("kind", ["mid", "top", "empty"])
@pytest.mark.parametrize("width", WIDTHS)
def test_range_filter_packed_plain_matches_pallas(width, kind):
    rng = np.random.default_rng(10 * width + len(kind))
    per = 32 // width
    n_words = TILE + 1000 + 7 * width          # two tiles, the last partial
    n = n_words * per - (per - 1)              # and a part-filled last word
    codes = rng.integers(0, 2 ** min(width, 16), n).astype(np.int32)
    words = np_bitpack(codes, width)
    assert words.shape[0] == n_words
    lo, hi = _range(kind, width, rng)
    flat = _pad(words, np.uint32(0xFFFFFFFF))
    jb, jc = jpacked.range_filter_packed_2d(
        jnp.asarray(flat.reshape(-1, 128)), jnp.uint32(lo), jnp.uint32(hi),
        width=width, block_rows=BLOCK_ROWS, interpret=True)
    pb, pc = packed_filter.packed_range_filter_plain(_t(flat), lo, hi, width,
                                                     TILE)
    assert np.array_equal(_u32(pb), np.asarray(jb).reshape(-1))
    assert pc.dtype == torch.int32
    assert np.array_equal(pc.numpy(), np.asarray(jc).reshape(-1))
    # the words as they are: the partial last tile read in place, its count
    # with the padding words' matches
    ub, uc = packed_filter.packed_range_filter_plain(_t(words), lo, hi, width,
                                                     TILE)
    assert np.array_equal(_u32(ub), np.asarray(jb).reshape(-1)[:n_words])
    assert uc.dtype == torch.int32
    assert np.array_equal(uc.numpy(), np.asarray(jc).reshape(-1))
    # the op-level entry point: padded, cut back to the real words
    got = ops.range_filter_packed(_t(words), width, lo, hi)
    assert got.shape == (n_words,)
    assert np.array_equal(_u32(got), jops.range_filter_packed(words, width,
                                                              lo, hi))
    mask = ops.bitmap_to_mask(got, width, n).numpy()
    assert np.array_equal(mask, (codes >= lo) & (codes <= hi))
    pad_fields = (flat.shape[0] - n_words) * per
    if lo <= hi == 2 ** width - 1:   # every field of the padding words counts
        assert int(pc.sum()) == int(mask.sum()) + pad_fields
    else:
        assert int(pc.sum()) == int(mask.sum())


def test_range_filter_packed_width_32_full_uint32_range():
    """Width 32 with hi = 0xFFFFFFFF: the uint32 bound must not wrap to -1
    (every code matches, and so does every padding word)."""
    rng = np.random.default_rng(32)
    words = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    for lo in (0, 2**31, 0xFFFFFFFF):
        got = ops.range_filter_packed(_t(words), 32, lo, 0xFFFFFFFF)
        want = jops.range_filter_packed(words, 32, lo, 0xFFFFFFFF)
        assert np.array_equal(_u32(got), want)
        assert np.array_equal(_u32(got) == 1, words >= lo)
    _, counts = packed_filter.packed_range_filter_plain(
        _t(_pad(words, np.uint32(0xFFFFFFFF))), 0, 0xFFFFFFFF, 32, TILE)
    assert int(counts.sum()) == TILE
    _, counts = packed_filter.packed_range_filter_plain(
        _t(words), 0, 0xFFFFFFFF, 32, TILE)
    assert counts.tolist() == [TILE]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("short", [5, -3, 1])
def test_range_filter_packed_partial_tiles_match_pallas(width, short):
    """The plain version on words that end inside a tile (``short`` words
    before the end of 1, 1, and 3 tiles of 1,024 words) against the Pallas
    kernel on the reference's padded input, for a range in the middle, one
    reaching 2**width - 1 and an empty one."""
    rows, tile = 8, 8 * 128
    n_words = {5: tile - 5, -3: tile + 3, 1: 3 * tile - 1}[short]
    rng = np.random.default_rng(1000 * width + n_words)
    words = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    flat = np.full(-(-n_words // tile) * tile, 0xFFFFFFFF, np.uint32)
    flat[:n_words] = words
    for kind in ("mid", "top", "empty"):
        lo, hi = _range(kind, width, rng)
        jb, jc = jpacked.range_filter_packed_2d(
            jnp.asarray(flat.reshape(-1, 128)), jnp.uint32(lo),
            jnp.uint32(hi), width=width, block_rows=rows, interpret=True)
        pb, pc = packed_filter.packed_range_filter_plain(_t(words), lo, hi,
                                                         width, tile)
        assert np.array_equal(_u32(pb), np.asarray(jb).reshape(-1)[:n_words])
        assert np.array_equal(pc.numpy(), np.asarray(jc).reshape(-1)), kind


def test_range_filter_packed_rejects_bad_operands():
    words = torch.zeros(TILE, dtype=torch.int32)
    # words that end inside a tile: the counts of the reference's padded
    # input, padding words (fields 255) counted where the range holds 255
    for lo, hi in ((0, 1), (200, 255)):
        flat = _pad(words[:-1].numpy().view(np.uint32), np.uint32(0xFFFFFFFF))
        _, jc = jpacked.range_filter_packed_2d(
            jnp.asarray(flat.reshape(-1, 128)), jnp.uint32(lo),
            jnp.uint32(hi), width=8, block_rows=BLOCK_ROWS, interpret=True)
        bitmap, counts = packed_filter.packed_range_filter(words[:-1], lo, hi,
                                                           8)
        assert bitmap.shape == (TILE - 1,)
        assert np.array_equal(counts.numpy(), np.asarray(jc).reshape(-1))
    with pytest.raises(ValueError, match="width"):
        packed_filter.packed_range_filter(words, 0, 1, 3)
    with pytest.raises(ValueError, match="uint32"):
        packed_filter.packed_range_filter(words, -1, 1, 8)
    with pytest.raises(ValueError, match="uint32"):
        ops.range_filter_packed(words, 32, 0, 2**32)
    assert ops.range_filter_packed(torch.zeros(0, dtype=torch.int32), 8,
                                   0, 3).shape == (0,)


# --------------------------------------------------------------------------- #
# bloom_probe
# --------------------------------------------------------------------------- #
def _bloom_case(seed, nbits, n_words, n_keys):
    rng = np.random.default_rng(seed)
    bloom = rng.integers(0, 2**32, n_words, dtype=np.uint64).astype(np.uint32)
    keys = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    return bloom, keys


@pytest.mark.parametrize("scale", [1, 3, 5])
@pytest.mark.parametrize("n_hashes", [1, 6])
def test_bloom_probe_plain_matches_pallas(scale, n_hashes):
    nbits = 1 << (10 + scale)
    bloom, keys = _bloom_case(scale * 7 + n_hashes, nbits, nbits // 32, 1500)
    got = ops.bloom_probe(_t(bloom), nbits, _t(keys), n_hashes)
    assert got.dtype == torch.bool and got.shape == (1500,)
    want = jops.bloom_probe(bloom, nbits, keys, n_hashes)
    assert np.array_equal(got.numpy(), want)
    oracle = jref.bloom_probe(jnp.asarray(bloom), nbits, jnp.asarray(keys),
                              n_hashes)
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    assert 0 < int(got.sum()) < 1500
    # the Pallas kernel itself, at its padded layout
    kq = np.zeros(2048, np.uint32)
    kq[:1500] = keys
    bw = np.zeros(-(-bloom.shape[0] // 128) * 128, np.uint32)
    bw[:bloom.shape[0]] = bloom
    j2 = jbloom.bloom_probe_2d(jnp.asarray(bw.reshape(-1, 128)),
                               jnp.asarray(kq.reshape(-1, 128)), nbits,
                               n_hashes, interpret=True)
    plain = bloom_probe.bloom_probe_plain(_t(bloom), nbits, _t(kq), n_hashes)
    assert plain.dtype == torch.int8
    assert np.array_equal(plain.numpy(), np.asarray(j2).reshape(-1))


def test_bloom_probe_bits_past_the_words_miss_as_in_the_kernel():
    """nbits > 32 * len(words): the kernel (and the port) read the missing
    words as 0, a miss; ``ref.bloom_probe`` clamps the index, a hit."""
    bloom = np.full(4, 0xFFFFFFFF, np.uint32)          # 128 bits of ones
    keys = np.random.default_rng(3).integers(0, 2**32, 300, dtype=np.uint64
                                             ).astype(np.uint32)
    got = ops.bloom_probe(_t(bloom), 4096, _t(keys))
    want = jops.bloom_probe(bloom, 4096, keys)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == 0
    oracle = np.asarray(jref.bloom_probe(jnp.asarray(bloom), 4096,
                                         jnp.asarray(keys)))
    assert oracle.all()
    # with one hash, a key hits exactly when its bit lies in the 128 bits
    one = ops.bloom_probe(_t(bloom), 4096, _t(keys), 1).numpy()
    h = np.asarray(jref.mix32(jnp.asarray(keys), jref.BLOOM_SEEDS32[0])) % 4096
    assert np.array_equal(one, h < 128)
    assert np.array_equal(one, jops.bloom_probe(bloom, 4096, keys, 1))


def test_bloom_probe_no_false_negatives():
    """Keys inserted by mix32 always probe positive (the bloom contract)."""
    nbits = 1 << 13
    keys = np.random.default_rng(42).integers(0, 2**32, 200, dtype=np.uint64
                                              ).astype(np.uint32)
    words = np.zeros(nbits // 32, np.uint32)
    for s in range(6):
        h = np.asarray(jref.mix32(jnp.asarray(keys), jref.BLOOM_SEEDS32[s])) \
            % nbits
        np.bitwise_or.at(words, h >> 5,
                         np.uint32(1) << (h & 31).astype(np.uint32))
    assert ops.bloom_probe(_t(words), nbits, _t(keys)).all()
    assert jops.bloom_probe(words, nbits, keys).all()
    # the port's mix32 is the reference's
    k64 = torch.from_numpy(keys.astype(np.int64))
    for seed in jref.BLOOM_SEEDS32:
        assert np.array_equal(
            bloom_probe.mix32(k64, seed).numpy(),
            np.asarray(jref.mix32(jnp.asarray(keys), seed)).astype(np.int64))


def test_bloom_probe_rejects_bad_operands():
    words, keys = torch.zeros(8, dtype=torch.int32), torch.zeros(
        4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_hashes"):
        ops.bloom_probe(words, 256, keys, 7)
    with pytest.raises(ValueError, match="nbits"):
        ops.bloom_probe(words, 0, keys)
    with pytest.raises(ValueError, match="1-D"):
        ops.bloom_probe(words.reshape(2, 4), 256, keys)
    assert ops.bloom_probe(words, 256, keys, 0).all()
    assert ops.bloom_probe(words, 256, keys[:0]).shape == (0,)


# the kernel's remainder without a divide: the documented blooms' nbits
# (powers of two), the card tests' other ones, and divisors at the edges of
# the uint32 range and of the shifts
FASTMOD_DIVISORS = [1, 2, 3, 7, 641, 1000, 1 << 14, 1 << 16, (1 << 16) + 1,
                    20000 * 32, 6700417, (1 << 31) - 1, 1 << 31,
                    (1 << 31) + 1, 2**32 - 2, 2**32 - 1]


def _fastmod_check(nbits, rng):
    """fastmod_plain against % over seeded random h and 0, d - 1, d and
    2^32 - 1 (those below 2^32)."""
    m, s1, s2 = bloom_probe.fastmod_constants(nbits)
    assert 1 <= m < 2**32 and s1 in (0, 1) and 0 <= s2 <= 31
    h = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        np.asarray([0, nbits - 1, nbits, 2**32 - 1],
                                   np.uint64)])
    h = torch.from_numpy(h[h < 2**32].astype(np.int64))
    assert torch.equal(bloom_probe.fastmod_plain(h, nbits), h % nbits)


@pytest.mark.parametrize("nbits", FASTMOD_DIVISORS)
def test_fastmod_matches_the_modulo_at_edge_divisors(nbits):
    _fastmod_check(nbits, np.random.default_rng(nbits % 1009))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fastmod_matches_the_modulo_at_random_divisors(seed):
    """100 seeded random divisors a seed, from every bit length."""
    rng = np.random.default_rng(seed)
    for bits in rng.integers(1, 33, 100):
        _fastmod_check(int(rng.integers(1 << (bits - 1), 1 << bits)), rng)


def test_fastmod_rejects_nbits_outside_uint32():
    for nbits in (0, 2**32):
        with pytest.raises(ValueError, match="nbits"):
            bloom_probe.fastmod_constants(nbits)


# --------------------------------------------------------------------------- #
# ssm_scan
# --------------------------------------------------------------------------- #
def _ssm_inputs(shape, seed):
    B, L, D, N = shape
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, L, D)).astype(np.float32)
    dt = np.abs(rng.normal(size=(B, L, D))).astype(np.float32) * 0.1
    A = -np.abs(rng.normal(size=(D, N))).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return u, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", [(1, 32, 128, 8), (2, 64, 256, 16),
                                   (3, 96, 384, 16), (1, 32, 128, 48),
                                   (1, 32, 128, 64)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssm_scan_plain_matches_pallas(shape, chunk):
    arrays = _ssm_inputs(shape, sum(shape) + chunk)
    y, state = ops.ssm_scan(*(torch.from_numpy(a) for a in arrays),
                            chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    B, L, D, N = shape
    assert y.shape == (B, L, D) and state.shape == (B, D, N)
    jy, js = jops.ssm_scan(*arrays, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(js), rtol=3e-5,
                               atol=3e-5)
    ry, rs = jref.ssm_scan_batched(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(rs), rtol=3e-5,
                               atol=3e-5)


def test_ssm_scan_takes_other_float_types_as_float32():
    arrays = [torch.from_numpy(a) for a in _ssm_inputs((1, 32, 128, 16), 5)]
    half = [a.to(torch.bfloat16) for a in arrays]
    y, state = ops.ssm_scan(*half)
    wy, ws = ops.ssm_scan(*(a.to(torch.float32) for a in half))
    assert y.dtype == torch.float32 and torch.equal(y, wy) and \
        torch.equal(state, ws)


@pytest.mark.parametrize("bad", ["D", "L", "A", "BC"])
def test_ssm_scan_keeps_the_reference_shape_contract(bad):
    u, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssm_inputs((1, 32, 128, 16), 6))
    if bad == "D":
        u, dt, A = u[..., :100], dt[..., :100], A[:100]
    elif bad == "L":
        u, dt, Bm, Cm = u[:, :24], dt[:, :24], Bm[:, :24], Cm[:, :24]
    elif bad == "A":
        A = A[:64]
    else:
        Cm = Cm[:, :, :8]
    with pytest.raises(ValueError):
        ops.ssm_scan(u, dt, A, Bm, Cm, chunk=32)


@pytest.mark.parametrize("n,want", [
    (16, 4),      # falcon-mamba-7b: 4 lanes of 4 states a channel
    (1, 1), (4, 1), (5, 2), (8, 2), (13, 4), (30, 8), (48, 16), (64, 16),
    (300, 32),    # past 128 states the kernel runs passes
])
def test_ssm_scan_layout_fills_the_card(n, want):
    """A channel takes the lanes its states need, a power of two of
    ``STATES_PER_LANE`` states each, at most a warp (the kernel runs
    passes past that)."""
    g = ssm_scan.scan_layout(n)
    assert g == want
    assert g & (g - 1) == 0 and g <= ssm_scan.WARP
    per_pass = g * ssm_scan.STATES_PER_LANE
    assert per_pass >= min(n, ssm_scan.WARP * ssm_scan.STATES_PER_LANE)
    assert g == 1 or per_pass // 2 < n


def test_ssm_scan_build_takes_the_states_per_lane():
    """The kernel is built with the wrapper's states per lane, so the
    layout the host computes is the one the kernel runs."""
    from repro_torch.kernels import _build

    flag = f"-DREPRO_SSM_STATES={ssm_scan.STATES_PER_LANE}"
    assert _build._flags().count(flag) == 1
