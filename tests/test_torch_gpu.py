"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one:
a CUDA kernel has no CPU mode.  Each kernel is held bit for bit against its
plain PyTorch version (which ``test_torch_kernels.py`` holds against the
JAX package), and a small tree on the card against the same tree on the
CPU.  The file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import AggSpec, GroupBy, ScanServer
from repro_torch.kernels import (agg_scan, bitpack, bloom_probe, fused_scan,
                                 merge_remap, multi_filter, opd_filter, ops,
                                 packed_filter, ssm_scan)

pytestmark = pytest.mark.gpu
WIDTHS = [1, 2, 4, 8, 16, 32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _codes(n, width, rng):
    return torch.from_numpy(
        rng.integers(0, 2 ** width, n, dtype=np.int64).astype(np.int32))


def _level(width, ns, k, rng):
    """SCTs with sorted codes, 146-entry block zones and narrow ranges
    (every fourth empty), so zones prune tiles."""
    packed, zones, ranges = [], [], []
    epb = 146
    for n in ns:
        codes = torch.sort(_codes(n, min(width, 16), rng)).values
        packed.append(bitpack.pack_codes_plain(codes, width))
        nb = max(1, -(-n // epb))
        pad = nb * epb - n
        c64 = codes.to(torch.int64)
        lo = torch.cat([c64, torch.full((pad,), 0xFFFFFFFF)]).reshape(nb, epb)
        hi = torch.cat([c64, torch.zeros(pad, dtype=torch.int64)]).reshape(nb, epb)
        zones.append((lo.amin(1), hi.amax(1), epb))
        r = np.sort(rng.integers(0, 2 ** min(width, 16), (k, 2)), axis=1)
        r[:, 1] = np.minimum(r[:, 1], r[:, 0] + 3)
        r[3::4] = (1, 0)
        ranges.append(torch.from_numpy(r.astype(np.int64)))
    return packed, zones, ranges


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_match_plain(card, width):
    rng = np.random.default_rng(width)
    for n in (0, 1, 12345):
        codes = _codes(n, width, rng).to(card)
        words = bitpack.pack_codes(codes, width)
        assert torch.equal(words.cpu(), bitpack.pack_codes_plain(codes.cpu(), width))
        assert torch.equal(bitpack.unpack_codes(words, width, n).cpu(), codes.cpu())



def _pack_launches_once(card, codes, width, want):
    before = ops.LAUNCHES["pack_codes"]
    got = bitpack.pack_codes(codes, width)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pack_codes"] == before + (codes.shape[0] > 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_codes_edges_match_plain(card, width):
    """n at the edges of a group of 4 codes and of a word, and over three
    grid-stride rounds of the card's resident threads; each call with
    n > 0 launches the kernel once."""
    rng = np.random.default_rng(200 + width)
    per = 32 // width
    rounds = 3 * _resident_threads(card) * bitpack.PACK_GROUPS * 4
    for n in [0, 1] + [4 * per + d for d in range(-1, 6)] + [rounds + 3]:
        codes = _codes(n, width, rng)
        _pack_launches_once(card, codes.to(card), width,
                            bitpack.pack_codes_plain(codes, width))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_pack_codes_on_a_code_view_at_an_offset(card, width, offset):
    """A view of the codes 4, 8 or 12 bytes into a 16-byte line takes the
    kernel's 4-byte loads, not the plain version."""
    rng = np.random.default_rng(20 * width + offset)
    per = 32 // width
    n = 3 * bitpack.PACK_TILE_CODES + 4 * per + 1
    codes = _codes(n + offset, width, rng)
    view = codes.to(card)[offset:]
    assert view.data_ptr() % 16 == 4 * offset
    _pack_launches_once(card, view, width,
                        bitpack.pack_codes_plain(codes[offset:], width))


@pytest.mark.parametrize("width", [1, 32])
def test_pack_codes_past_2_31_codes(card, width):
    """n >= 2^31 takes the kernel's 64-bit indices; held against the plain
    version on windows at the start, across 2^31 and at the ragged end."""
    n = 2**31 + 7
    per = 32 // width
    codes = torch.randint(0, 2**min(width, 30), (n,), dtype=torch.int32,
                          device=card)
    before = ops.LAUNCHES["pack_codes"]
    got = bitpack.pack_codes(codes, width)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pack_codes"] == before + 1
    m = got.shape[0]
    assert m == bitpack.n_words_for(n, width)
    for w0 in (0, 2**31 // per - 64, m - 64):
        k = min(per * 128, n - per * w0)
        want = bitpack.pack_codes_plain(codes[per * w0:per * w0 + k].cpu(),
                                        width)
        assert torch.equal(got[w0:w0 + want.shape[0]].cpu(), want)
    del got, codes
    torch.cuda.empty_cache()


def _resident_threads(card):
    p = torch.cuda.get_device_properties(card)
    return p.multi_processor_count * getattr(
        p, "max_threads_per_multi_processor", 2048)


def _words(m, rng):
    return torch.from_numpy(rng.integers(-2**31, 2**31, m).astype(np.int32))


def _unpack_launches_once(card, words, width, n, want):
    before = ops.LAUNCHES["unpack_codes"]
    got = bitpack.unpack_codes(words, width, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack_codes"] == before + (n > 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_unpack_codes_edges_match_plain(card, width):
    """n at the edges of a group of 4 codes and of a word, and over three
    grid-stride rounds of the card's resident threads; each call with
    n > 0 launches the kernel once."""
    rng = np.random.default_rng(100 + width)
    per = 32 // width
    rounds = 3 * _resident_threads(card) * bitpack.UNPACK_GROUPS * 4
    for n in (0, 1, 4 * per - 1, 4 * per, 4 * per + 1, rounds + 3):
        words = _words(bitpack.n_words_for(n, width), rng)
        _unpack_launches_once(card, words.to(card), width, n,
                              bitpack.unpack_codes_plain(words, width, n))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unpack_codes_on_a_word_view_at_an_offset(card, width, offset):
    """A view of the words 4, 8 or 12 bytes into a 16-byte line takes the
    kernel's 4-byte loads, not the plain version."""
    rng = np.random.default_rng(10 * width + offset)
    per = 32 // width
    n = 3 * bitpack.UNPACK_TILE_CODES + 4 * per + 1
    words = _words(bitpack.n_words_for(n, width) + offset, rng)
    view = words.to(card)[offset:]
    assert view.data_ptr() % 16 == 4 * offset
    _unpack_launches_once(card, view, width, n,
                          bitpack.unpack_codes_plain(words[offset:], width, n))


def test_unpack_codes_past_2_31_codes(card):
    """n >= 2^31 takes the kernel's 64-bit indices; held against the plain
    version on windows at the start, across 2^31 and at the ragged end."""
    n, width = 2**31 + 6, 1
    m = bitpack.n_words_for(n, width)
    words = torch.randint(-2**31, 2**31 - 1, (m,), dtype=torch.int32,
                          device=card)
    before = ops.LAUNCHES["unpack_codes"]
    got = bitpack.unpack_codes(words, width, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack_codes"] == before + 1
    for w0 in (0, 2**31 // 32 - 64, m - 64):
        k = min(32 * 128, n - 32 * w0)
        want = bitpack.unpack_codes_plain(words[w0:w0 + 128].cpu(), width, k)
        assert torch.equal(got[32 * w0:32 * w0 + k].cpu(), want)
    del got, words
    torch.cuda.empty_cache()


@pytest.mark.parametrize("width,k", [(1, 1), (4, 4), (8, 16), (16, 16),
                                     (32, 16), (32, 4)])
def test_fused_level_filter_matches_plain(card, width, k):
    rng = np.random.default_rng(width * k)
    ns = [50000, 1, 3000]
    packed, zones, ranges = _level(width, ns, k, rng)
    want, want_info = ops.fused_level_filter(packed, ns, ranges, zones, width)
    got, info = ops.fused_level_filter(
        [p.to(card) for p in packed], ns, [r.to(card) for r in ranges],
        [(lo.to(card), hi.to(card), epb) for lo, hi, epb in zones], width)
    assert info == want_info
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_fused_kernel_skips_tiles_and_zeroes_them(card):
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, 3 * 1024).astype(np.int32))
    meta = torch.tensor([[0, 10, 0, 0], [0xFFFFFFFF - 2**32, 0, 0, 0],
                         [5, 6, 0, 0]], dtype=torch.int32)
    ranges = torch.tensor([[7, 9], [1, 0]], dtype=torch.int32)
    want = fused_scan.fused_zone_filter_plain(words, meta, ranges, 8, 2)
    got = fused_scan.fused_zone_filter(words.to(card), meta.to(card),
                                       ranges.to(card), 8, 2)
    assert got[1].tolist() == [1, 0, 0]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("width", WIDTHS)
def test_remap_pack_matches_plain(card, width):
    rng = np.random.default_rng(width)
    n, t = 100_003, 70_000
    table = torch.from_numpy(rng.integers(-1, 2 ** min(width, 16), t).astype(np.int32))
    offsets = torch.tensor([0, 30_000], dtype=torch.int32)
    srcs = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    evs = torch.from_numpy(rng.integers(-1, 30_000, n).astype(np.int32))
    want = merge_remap.remap_pack_codes_plain(evs, srcs, table, offsets, width)
    got = merge_remap.remap_pack_codes(evs.to(card), srcs.to(card),
                                       table.to(card), offsets.to(card), width)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_src", [6, 1500])
@pytest.mark.parametrize("n", [0, 3, 100_003, 1_200_000])
def test_remap_codes_matches_plain(card, n, n_src):
    """Dead entries, unused-code (-1) slots, n that 4 does not divide, the
    per-source bases in shared memory (6 sources) and past it (1,500);
    then misaligned operands raise instead of launching."""
    rng = np.random.default_rng(n + n_src)
    t = 400_000 - 400_000 % n_src
    table = torch.from_numpy(rng.integers(-1, 2 ** 20, t).astype(np.int32))
    offsets = torch.from_numpy((np.arange(n_src) * (t // n_src)).astype(np.int32))
    srcs = torch.from_numpy(rng.integers(0, n_src, n).astype(np.int32))
    evs = torch.from_numpy(rng.integers(-1, t // n_src, n).astype(np.int32))
    want = merge_remap.remap_codes_plain(evs, srcs, table, offsets)
    before = ops.LAUNCHES["remap_codes"]
    got = merge_remap.remap_codes(evs.to(card), srcs.to(card), table.to(card),
                                  offsets.to(card))
    assert torch.equal(got.cpu(), want)
    assert ops.LAUNCHES["remap_codes"] == before + (n > 0)
    dead = torch.full((5,), -1, dtype=torch.int32, device=card)
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    assert merge_remap.remap_codes(dead, dead + 1, empty,
                                   offsets[:2].to(card)).tolist() == [-1] * 5
    if n > 4:
        e, s = evs.to(card), srcs.to(card)
        with pytest.raises(ValueError, match="aligned"):
            merge_remap.remap_codes(e[1:], s[1:], table.to(card),
                                    offsets.to(card))
        with pytest.raises(ValueError, match="aligned"):
            merge_remap.remap_codes(e[:-1], s[1:], table.to(card),
                                    offsets.to(card))


# entries one round of a block of the CUDA remap covers
REMAP_TILE = 4 * merge_remap.REMAP_GROUPS * merge_remap.REMAP_THREADS


@pytest.mark.parametrize("n_src", [1, 1024, 1025])
@pytest.mark.parametrize("n", [1, 5, REMAP_TILE - 1, REMAP_TILE + 1,
                               1_200_000])
def test_remap_codes_edges_match_plain(card, n, n_src):
    """n at the edges of a thread's groups and of a block's tile, the
    per-source bases in shared memory (1 and 1,024 sources) and read from
    device memory (1,025), a third of the entries dead, -1 table slots;
    then every entry dead."""
    rng = np.random.default_rng(n * 7 + n_src)
    per_src = 300
    table = torch.from_numpy(rng.integers(-1, 2 ** 20, n_src * per_src)
                             .astype(np.int32))
    offsets = torch.from_numpy((np.arange(n_src) * per_src).astype(np.int32))
    srcs = torch.from_numpy(rng.integers(0, n_src, n).astype(np.int32))
    evs = rng.integers(0, per_src, n).astype(np.int32)
    evs[rng.random(n) < 1 / 3] = -1
    evs = torch.from_numpy(evs)
    dev = [t.to(card) for t in (evs, srcs, table, offsets)]
    for e in (evs, torch.full_like(evs, -1)):
        want = merge_remap.remap_codes_plain(e, srcs, table, offsets)
        before = ops.LAUNCHES["remap_codes"]
        got = merge_remap.remap_codes(e.to(card), *dev[1:])
        torch.cuda.synchronize()
        assert ops.LAUNCHES["remap_codes"] == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n_src", [1, 1024, 1025])
@pytest.mark.parametrize("t", [403_041, 929_601])
def test_remap_pack_edges_match_plain(card, width, n_src, t):
    """The main path's largest merge table (403,041 slots) and one over
    twice its size (3.7 MB), the bases in shared memory (1 and 1,024
    sources) and read from device memory
    (1,025), n at the edges of a thread's groups and of a block's tile, a
    third of the entries dead and -1 table slots, the last source's codes
    reaching the table's last slot; then every entry dead."""
    rng = np.random.default_rng(width * 31 + n_src + t)
    per_src = t // n_src
    table = torch.from_numpy(rng.integers(-1, 2 ** min(width, 20), t)
                             .astype(np.int32))
    offsets = torch.from_numpy((np.arange(n_src) * per_src).astype(np.int32))
    offsets[-1] = t - per_src
    dev = [x.to(card) for x in (table, offsets)]
    for n in (0, 3, REMAP_TILE - 1, REMAP_TILE + 1, 1_200_000):
        srcs = torch.from_numpy(rng.integers(0, n_src, n).astype(np.int32))
        evs = rng.integers(0, per_src, n).astype(np.int32)
        evs[rng.random(n) < 1 / 3] = -1
        if n:
            srcs[-1], evs[-1] = n_src - 1, per_src - 1
        for e in (torch.from_numpy(evs),
                  torch.full((n,), -1, dtype=torch.int32)):
            want = merge_remap.remap_pack_codes_plain(e, srcs, table, offsets,
                                                      width)
            before = ops.LAUNCHES["remap_pack_codes"]
            got = merge_remap.remap_pack_codes(e.to(card), srcs.to(card),
                                               *dev, width)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["remap_pack_codes"] == before + (n > 0)
            assert torch.equal(got.cpu(), want), n


def test_remap_pack_on_views_off_a_16_byte_line(card):
    """ev and src views 4 bytes into a line are copied onto a line first,
    not refused; a table view is read where it lies."""
    rng = np.random.default_rng(7)
    n, t = 100_001, 50_001
    table = torch.from_numpy(rng.integers(-1, 2**16, t).astype(np.int32))
    offsets = torch.tensor([0, 20_000], dtype=torch.int32)
    srcs = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    evs = torch.from_numpy(rng.integers(-1, 30_000, n).astype(np.int32))
    want = merge_remap.remap_pack_codes_plain(evs[1:], srcs[1:], table[1:],
                                              offsets, 16)
    got = merge_remap.remap_pack_codes(evs.to(card)[1:], srcs.to(card)[1:],
                                       table.to(card)[1:], offsets.to(card),
                                       16)
    assert torch.equal(got.cpu(), want)


def test_remap_pack_past_2_31_entries(card):
    """n >= 2^31 takes the kernel's 64-bit indices; held against the plain
    version on windows at the start, across 2^31 and at the ragged end."""
    n, per_src = 2**31 + 7, 1000
    table = torch.randint(-1, 2**16, (3 * per_src,), dtype=torch.int32,
                          device=card)
    offsets = torch.tensor([0, per_src, 2 * per_src], dtype=torch.int32,
                           device=card)
    evs = torch.randint(-1, per_src, (n,), dtype=torch.int32, device=card)
    srcs = torch.randint(0, 3, (n,), dtype=torch.int32, device=card)
    before = ops.LAUNCHES["remap_pack_codes"]
    got = merge_remap.remap_pack_codes(evs, srcs, table, offsets, 16)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["remap_pack_codes"] == before + 1
    for i in (0, 2**31 - 4096, n - 4095):
        want = merge_remap.remap_pack_codes_plain(
            evs[i:i + 8192].cpu(), srcs[i:i + 8192].cpu(), table.cpu(),
            offsets.cpu(), 16)
        assert torch.equal(got[i // 2:i // 2 + want.shape[0]].cpu(), want)
    del got, evs, srcs
    torch.cuda.empty_cache()


def test_remap_codes_past_2_31_entries(card):
    """n >= 2^31 takes the kernel's 64-bit indices; held against the plain
    version on windows at the start, across 2^31 and at the ragged end."""
    n, per_src = 2**31 + 7, 1000
    table = torch.randint(-1, 2**20, (3 * per_src,), dtype=torch.int32,
                          device=card)
    offsets = torch.tensor([0, per_src, 2 * per_src], dtype=torch.int32,
                           device=card)
    evs = torch.randint(-1, per_src, (n,), dtype=torch.int32, device=card)
    srcs = torch.randint(0, 3, (n,), dtype=torch.int32, device=card)
    before = ops.LAUNCHES["remap_codes"]
    got = merge_remap.remap_codes(evs, srcs, table, offsets)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["remap_codes"] == before + 1
    for i in (0, 2**31 - 4096, n - 4096):
        want = merge_remap.remap_codes_plain(
            evs[i:i + 8192].cpu(), srcs[i:i + 8192].cpu(), table.cpu(),
            offsets.cpu())
        assert torch.equal(got[i:i + 8192].cpu(), want)
    del got, evs, srcs
    torch.cuda.empty_cache()


@pytest.mark.parametrize("backend,kernel", [("jax", "remap_codes"),
                                            ("numpy", None)])
def test_compaction_backend_on_the_card_matches_the_cpu(card, backend, kernel):
    """A tree compacted under 'jax' or 'numpy' on the card writes the
    CPU tree's SCTs; neither launches the fused remap-pack kernel."""
    cfg = T.LSMConfig(value_width=24, file_bytes=8 * 1024, l0_limit=2,
                      size_ratio=3, compaction_backend=backend)
    trees = [T.LSMTree(cfg, device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(6)
    ops.reset_launches()
    for _ in range(3):
        keys = rng.integers(0, 3000, 1500).astype(np.uint64)
        vals = np.asarray([b"tag_%05d" % i for i in rng.integers(0, 400, 1500)],
                          "S24")
        dels = rng.integers(0, 3000, 80).tolist()
        for t in trees:
            t.put_batch(keys, vals)
            for k in dels:
                t.delete(k)
    for t in trees:
        t.compact()
    assert trees[1].n_compactions > 0
    for la, lb in zip(trees[0].levels, trees[1].levels):
        for a, b in zip(la, lb):
            assert torch.equal(a.packed, b.packed.cpu())
            assert torch.equal(a.blocks.code_lo, b.blocks.code_lo.cpu())
            assert torch.equal(a.blocks.weight_sums, b.blocks.weight_sums.cpu())
    ra, rb = (t.range_lookup(0, 3000) for t in trees)
    assert np.array_equal(ra[0], rb[0]) and np.array_equal(ra[1], rb[1])
    assert ops.LAUNCHES["remap_pack_codes"] == 0, ops.LAUNCHES
    assert ops.LAUNCHES["pack_codes"] > 0
    if kernel is None:
        assert ops.LAUNCHES["remap_codes"] == 0
    else:
        assert ops.LAUNCHES[kernel] > 0


def test_tree_on_the_card_matches_the_cpu(card):
    """The same stream into a tree on the card and one on the CPU: same
    SCT words, zones and results, with every kernel launched."""
    cfg = T.LSMConfig(value_width=24, file_bytes=8 * 1024, l0_limit=2,
                      size_ratio=3)
    trees = [T.LSMTree(cfg, device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(5)
    ops.reset_launches()
    for _ in range(3000):
        k = int(rng.integers(0, 1500))
        v = b"tag_%05d" % int(rng.integers(0, 200))
        delete = rng.random() < 0.1
        for t in trees:
            t.delete(k) if delete else t.put(k, v)
    preds = [T.Predicate("prefix", b"tag_0"), T.Predicate("eq", b"tag_00037"),
             T.Predicate("range", b"tag_00020", b"tag_00090")]
    res = [t.filter_many(preds) for t in trees]
    for a, b in zip(*res):
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.values, b.values)
    for la, lb in zip(trees[0].levels, trees[1].levels):
        for a, b in zip(la, lb):
            assert torch.equal(a.packed, b.packed.cpu())
            assert torch.equal(a.blocks.code_lo, b.blocks.code_lo.cpu())
    for k in range(0, 1500, 7):
        assert trees[0].get(k) == trees[1].get(k)
    main_path = ("pack_codes", "unpack_codes", "fused_zone_filter",
                 "remap_pack_codes")
    assert all(ops.LAUNCHES[k] > 0 for k in main_path), ops.LAUNCHES


# --------------------------------------------------------------------------- #
# analytics: fused_zone_agg and zone_histogram
# --------------------------------------------------------------------------- #
def _agg_level(width, rng, ns=(50000, 1, 3000)):
    """SCTs whose first column is sorted (tiles short-circuit and skip),
    the rest uniform, with 146-entry block zones and weight totals, and a
    weight table per SCT."""
    packed, zones, weights = [], [], []
    epb, maxv = 146, 2 ** min(width, 12)
    for j, n in enumerate(ns):
        codes = torch.from_numpy(rng.integers(1 if j == 0 else 0, maxv, n))
        if j == 0:
            codes = torch.sort(codes).values
        wt = torch.from_numpy(rng.integers(0, 1000, maxv).astype(np.int32))
        packed.append(bitpack.pack_codes_plain(codes.to(torch.int32), width))
        nb = -(-n // epb)
        pad = nb * epb - n
        lo = torch.cat([codes, torch.full((pad,), 0xFFFFFFFF)]).reshape(nb, epb)
        hi = torch.cat([codes, torch.zeros(pad, dtype=torch.int64)]).reshape(nb, epb)
        ws = torch.cat([wt.to(torch.int64)[codes],
                        torch.zeros(pad, dtype=torch.int64)]).reshape(nb, epb)
        zones.append((lo.amin(1), hi.amax(1), epb, ws.sum(1)))
        weights.append(wt)
    return packed, zones, weights


def _to(card, zones):
    return [tuple(z.to(card) if torch.is_tensor(z) else z for z in zs)
            for zs in zones]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_level_agg_matches_plain(card, width, with_sum):
    rng = np.random.default_rng(width + 7 * with_sum)
    ns = [50000, 1, 3000]
    packed, zones, weights = _agg_level(width, rng, ns)
    maxv = 2 ** min(width, 12)
    ranges = torch.tensor([(1, maxv - 1), (1, 0), (maxv // 4, maxv // 2),
                           (0, maxv - 1), (maxv // 3, maxv // 3)])
    w = weights if with_sum else None
    want, want_info = ops.fused_level_agg(packed, ns, [ranges] * 3, zones,
                                          width, weights_list=w)
    before = ops.LAUNCHES["fused_zone_agg"]
    got, info = ops.fused_level_agg(
        [p.to(card) for p in packed], ns, [ranges.to(card)] * 3,
        _to(card, zones), width,
        weights_list=[x.to(card) for x in w] if with_sum else None)
    assert ops.LAUNCHES["fused_zone_agg"] == before + 1
    assert info == want_info
    assert info["tiles_evaluated"] > 0
    for g, r in zip(got, want):
        for key in r:
            assert np.array_equal(g[key], r[key]), key


def agg_tiles(width, rng, tile_words):
    """Raw operands of five tiles: skipped (empty zone), closed form,
    evaluated, evaluated with a part-padding tail, and closed form without
    SUM but evaluated with it (unknown weight total).  Two groups of 11
    ranges (more than one register chunk): group 0 contains the closed
    tiles' zone or is empty, group 1 is narrow and mixed."""
    per = 32 // width
    maxv = 2 ** min(width, 12)
    full = tile_words * per
    words = torch.from_numpy(
        rng.integers(-2**31, 2**31, 5 * tile_words).astype(np.int32))
    meta = torch.tensor([
        [0xFFFFFFFF, 0, 0, full, 0, 0],
        [1, maxv - 1, 0, full, 0, 4242],
        [0, maxv - 1, 11, full, 0, 7],
        [0, maxv - 1, 11, full // 2 + 1, 3, 0xFFFFFFFF],
        [1, maxv - 1, 0, full, 5, 0xFFFFFFFF]], dtype=torch.int64)
    wide = [(0, maxv - 1), (1, 0), (1, maxv - 1)] * 3 + [(maxv, 0), (0, maxv)]
    narrow = [tuple(sorted(rng.integers(0, maxv, 2).tolist()))
              for _ in range(9)] + [(1, 0), (maxv - 1, maxv - 1)]
    ranges = torch.tensor(wide + narrow, dtype=torch.int64)
    weights = torch.from_numpy(rng.integers(-5000, 5000, maxv + 8)
                               .astype(np.int32))
    return (words, bitpack.to_u32_bits(meta), bitpack.to_u32_bits(ranges),
            weights, 11)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_zone_agg_tiles_match_plain(card, width, with_sum):
    tw = fused_scan.DEFAULT_TILE_WORDS
    words, meta, ranges, weights, k = agg_tiles(
        width, np.random.default_rng(3 * width + with_sum), tw)
    want = agg_scan.fused_zone_agg_plain(words, meta, ranges, weights, width,
                                         k, with_sum, tw)
    got = agg_scan.fused_zone_agg(words.to(card), meta.to(card),
                                  ranges.to(card), weights.to(card), width,
                                  k, with_sum, tw)
    assert want[4].tolist() == [0, 2, 1, 1, 1 if with_sum else 2]
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)


def _agg_case(n_tiles, tile_words, width, k, rng):
    """Raw operands of ``n_tiles`` tiles of random codes below 2^12, each
    tile at random skipped (empty zone), closed (zone inside group 0's
    ranges), closed without SUM only (unknown weight total), evaluated
    (group 1's narrow ranges) or evaluated with a padding tail."""
    per = 32 // width
    maxv = 2 ** min(width, 12)
    full = tile_words * per
    codes = rng.integers(0, maxv, n_tiles * full).astype(np.int32)
    words = bitpack.pack_codes_plain(torch.from_numpy(codes), width)
    wide = [(0, maxv - 1), (1, 0), (1, maxv - 1)]
    group0 = [wide[i % 3] for i in range(k)]
    group1 = [tuple(sorted(rng.integers(0, maxv, 2).tolist()))
              for _ in range(k)]
    group1[4::5] = [(1, 0)] * len(group1[4::5])
    ranges = torch.tensor(group0 + group1, dtype=torch.int64)
    kind = rng.integers(0, 5, n_tiles)
    wb = rng.integers(0, 64, n_tiles)
    rows = {0: lambda i: (0xFFFFFFFF, 0, 0, full, 0, 0),
            1: lambda i: (1, maxv - 1, 0, full, wb[i], 4242),
            2: lambda i: (1, maxv - 1, 0, full, wb[i], 0xFFFFFFFF),
            3: lambda i: (0, maxv - 1, k, full, wb[i], 7),
            4: lambda i: (0, maxv - 1, k, int(rng.integers(1, full)), wb[i],
                          0xFFFFFFFF)}
    meta = torch.tensor([rows[int(c)](i) for i, c in enumerate(kind)],
                        dtype=torch.int64)
    weights = torch.from_numpy(rng.integers(-2**31, 2**31, maxv + 64)
                               .astype(np.int32))
    return (words, bitpack.to_u32_bits(meta), bitpack.to_u32_bits(ranges),
            weights)


def _check_agg_on_card(card, words, meta, ranges, weights, width, k,
                       with_sum, tile_words, offset=0):
    """The kernel against the plain version, both on the card, with the
    words ``offset`` int32 into their buffer (off a 16-byte line unless 0
    or 4)."""
    buf = torch.empty(words.shape[0] + offset, dtype=torch.int32,
                      device=card)
    w = buf[offset:]
    w.copy_(words.to(card))
    ops_ = (meta.to(card), ranges.to(card), weights.to(card))
    want = agg_scan.fused_zone_agg_plain(w, *ops_, width, k, with_sum,
                                         tile_words)
    before = ops.LAUNCHES["fused_zone_agg"]
    got = agg_scan.fused_zone_agg(w, *ops_, width, k, with_sum, tile_words)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_zone_agg"] == before + 1
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    return got[4]


@pytest.mark.parametrize("k", [1, 3, 4, 8, 9, 66])
@pytest.mark.parametrize("tile_words", [1024, 256, 1000, 1022])
@pytest.mark.parametrize("with_sum", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_zone_agg_instantiations_match_plain(card, k, tile_words,
                                                   with_sum, offset):
    """Every register-slot count, 16-byte and 4-byte loads (1022 words a
    tile, or words one int32 off a 16-byte line), partial rounds (1000 and
    256 words), padding tails and closed tiles, bit for bit."""
    width = WIDTHS[(k + tile_words // 8) % len(WIDTHS)]
    rng = np.random.default_rng(k * 7 + tile_words + 2 * with_sum + offset)
    words, meta, ranges, weights = _agg_case(40, tile_words, width, k, rng)
    slots, vec = agg_scan.agg_route(words.to(card)[offset:], k, tile_words)
    assert vec == (tile_words % 4 == 0 and offset % 4 == 0)
    flags = _check_agg_on_card(card, words, meta, ranges, weights, width, k,
                               with_sum, tile_words, offset)
    assert set(flags.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 9])
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_zone_agg_every_width_and_slot_count(card, width, k, with_sum):
    """Every (width, slots, SUM) instantiation of the 16-byte-load path:
    K = 1, 2, 3, 4, 8 and 9 take 1, 2, 4, 4, 8 and 8 slots (9 in two
    chunks); the same K in the 8-slot instantiation (empty ranges past K)
    gives the same results."""
    tile_words = 256
    rng = np.random.default_rng(1000 + 10 * width + k + 7 * with_sum)
    words, meta, ranges, weights = _agg_case(40, tile_words, width, k, rng)
    want = {1: 1, 2: 2, 3: 4, 4: 4, 8: 8, 9: 8}[k]
    assert agg_scan.agg_route(words.to(card), k, tile_words) == (want, True)
    flags = _check_agg_on_card(card, words, meta, ranges, weights, width, k,
                               with_sum, tile_words)
    assert set(flags.tolist()) == {0, 1, 2}
    ops_ = [t.to(card) for t in (words, meta, ranges, weights)]
    got = agg_scan._launch_agg(*ops_, width, k, with_sum, tile_words, 8, True)
    want = agg_scan.fused_zone_agg_plain(*ops_, width, k, with_sum,
                                         tile_words)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_sum", [False, True])
def test_fused_zone_agg_more_tiles_than_the_grid(card, width, with_sum):
    """More tiles than the grid has warps (each warp walks several tiles of
    its block's share, with the next tile's words loaded ahead), at K=4,
    the analytics path's launch."""
    tile_words = 64
    # twice the warps of a grid of 2,048 threads on every SM
    n_tiles = 2 * torch.cuda.get_device_properties(card).multi_processor_count \
        * 64
    rng = np.random.default_rng(90 + width + with_sum)
    words, meta, ranges, weights = _agg_case(n_tiles, tile_words, width, 4,
                                             rng)
    _check_agg_on_card(card, words, meta, ranges, weights, width, 4,
                       with_sum, tile_words)


@pytest.mark.parametrize("width", WIDTHS)
def test_level_histogram_matches_plain(card, width):
    rng = np.random.default_rng(40 + width)
    ns = [50000, 1, 3000]
    packed, zones, _ = _agg_level(width, rng, ns)
    maxv = 2 ** min(width, 12)
    cuts = [np.unique(np.concatenate([[1], rng.integers(1, maxv, b), [maxv]]))
            for b in (63, 3, 10)]
    before = ops.LAUNCHES["zone_histogram"]
    want, want_info = ops.level_histogram(packed, ns, cuts, zones, width)
    got, info = ops.level_histogram([p.to(card) for p in packed], ns, cuts,
                                    _to(card, zones), width)
    assert ops.LAUNCHES["zone_histogram"] == before + 1
    assert info == want_info
    for g, r in zip(got, want):
        assert np.array_equal(g, r)


def _hist_case(n_tiles, tile_words, width, n_bins, rng, n_segs=7):
    """Raw operands of ``n_tiles`` tiles of random codes below 2^12 over
    ``n_segs`` SCTs in runs of tiles (a block's share crosses SCTs), with
    ascending edge rows full of repeated edges (row 0 padded by repeating an
    edge, so its upper bins are empty); each tile at random skipped (empty
    zone, or no entry), closed (its zone inside one bin), evaluated, or
    evaluated with a padding tail that ends mid-word and mid-tile."""
    per = 32 // width
    maxv = 2 ** min(width, 12)
    full = tile_words * per
    codes = rng.integers(0, maxv, n_tiles * full).astype(np.int32)
    words = bitpack.pack_codes_plain(torch.from_numpy(codes), width)
    edges = np.sort(rng.integers(0, maxv + 1, (n_segs, n_bins + 1)), axis=1)
    edges[0, (n_bins + 1) // 2:] = edges[0, (n_bins + 1) // 2]
    seg = np.sort(rng.integers(0, n_segs, n_tiles))
    rows = []
    for s, kind in zip(seg, rng.integers(0, 6, n_tiles)):
        e = edges[s]
        wide = [b for b in range(n_bins) if max(e[b], 1) < e[b + 1]]
        if kind == 0:
            rows.append((0xFFFFFFFF, 0, s, full))
        elif kind == 1:
            rows.append((0, maxv - 1, s, 0))
        elif kind == 2 and wide:
            b = wide[int(rng.integers(0, len(wide)))]
            lo = int(rng.integers(max(e[b], 1), e[b + 1]))
            rows.append((lo, int(rng.integers(lo, e[b + 1])), s, full))
        elif kind == 3:
            rows.append((0, maxv - 1, s, int(rng.integers(1, full))))
        else:
            rows.append((0, maxv - 1, s, full))
    meta = np.zeros((n_tiles, 6), np.int64)
    meta[:, :4] = np.asarray(rows, np.int64)
    return (words, bitpack.to_u32_bits(torch.from_numpy(meta)),
            bitpack.to_u32_bits(torch.from_numpy(edges.astype(np.int64))))


def _check_hist_on_card(card, words, meta, edges, width, n_bins, tile_words,
                        offset=0, route=None):
    """The kernel (at ``route``, else the one ``hist_route`` picks) against
    the plain version, both on the card, with the words ``offset`` int32
    into their buffer (off a 16-byte line unless 0 or 4)."""
    buf = torch.empty(words.shape[0] + offset, dtype=torch.int32,
                      device=card)
    w = buf[offset:]
    w.copy_(words.to(card))
    meta, edges = meta.to(card), edges.to(card)
    want = agg_scan.zone_histogram_plain(w, meta, edges, width, n_bins,
                                         tile_words)
    before = ops.LAUNCHES["zone_histogram"]
    if route is None:
        got = agg_scan.zone_histogram(w, meta, edges, width, n_bins,
                                      tile_words)
    else:
        got = agg_scan._launch_hist(w, meta, edges, width, n_bins,
                                    tile_words, *route)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["zone_histogram"] == before + 1
    for g, r in zip(got, want):
        assert torch.equal(g, r), route
    return got[1]


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n_bins", [1, 2, 16, 17, 64])
def test_zone_histogram_every_instantiation_matches_plain(card, width,
                                                          n_bins):
    """Every (width, bins) instantiation of the 16-byte-load path that
    holds n_bins, the 4-byte one (words one int32 off a 16-byte line) and
    the route zone_histogram picks, bit for bit, flags included."""
    tile_words = 256
    rng = np.random.default_rng(2000 + 10 * width + n_bins)
    words, meta, edges = _hist_case(60, tile_words, width, n_bins, rng)
    for bins in agg_scan.HIST_BINS:
        if n_bins <= bins:
            flags = _check_hist_on_card(card, words, meta, edges, width,
                                        n_bins, tile_words,
                                        route=(bins, True))
    assert {0, 1} <= set(flags.tolist())
    _check_hist_on_card(card, words, meta, edges, width, n_bins, tile_words,
                        route=(64, False), offset=1)
    _check_hist_on_card(card, words, meta, edges, width, n_bins, tile_words)


@pytest.mark.parametrize("tile_words", [1024, 1000, 1022, 7])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_bins", [16, 64])
def test_zone_histogram_tile_shapes_match_plain(card, tile_words, offset,
                                                n_bins):
    """Partial rounds (1000 words a tile), a tile_words that is not a
    multiple of 4 (1022, 7) or words off a 16-byte line (4-byte loads),
    padding tails and closed tiles, through the route zone_histogram
    picks."""
    width = WIDTHS[(tile_words + offset + n_bins) % len(WIDTHS)]
    rng = np.random.default_rng(tile_words + 7 * offset + n_bins)
    words, meta, edges = _hist_case(40, tile_words, width, n_bins, rng)
    route = agg_scan.hist_route(words.to(card)[offset:], n_bins, tile_words)
    assert route[1] == (tile_words % 4 == 0 and offset % 4 == 0)
    flags = _check_hist_on_card(card, words, meta, edges, width, n_bins,
                                tile_words, offset)
    assert set(flags.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("width", WIDTHS)
def test_zone_histogram_more_tiles_than_the_grid(card, width):
    """More tiles than the grid has warps (each warp walks several tiles of
    its block's share, the next tile's edges, class and words loaded
    ahead), over SCTs that change inside the shares, at 16 bins (the
    analytics path's buckets) in every instantiation."""
    tile_words = 64
    n_tiles = 2 * torch.cuda.get_device_properties(card).multi_processor_count \
        * 64
    rng = np.random.default_rng(300 + width)
    words, meta, edges = _hist_case(n_tiles, tile_words, width, 16, rng,
                                    n_segs=97)
    for bins in agg_scan.HIST_BINS:
        _check_hist_on_card(card, words, meta, edges, width, 16, tile_words,
                            route=(bins, True))


def test_tree_aggregates_on_the_card_match_the_cpu(card):
    """A compacted tree with sequential keys (the fast path) and the same
    tree with fresh writes (the general path) answer alike on the card and
    the CPU, with both aggregate kernels launched."""
    cfg = T.LSMConfig(value_width=16, file_bytes=64 * 1024, l0_limit=2,
                      size_ratio=3)
    trees = [T.LSMTree(cfg, device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(8)
    n = 30000
    keys = np.arange(n, dtype=np.uint64)
    vals = np.asarray([b"c%03d_%05d" % (i % 37, i)
                       for i in rng.integers(0, 400, n)], "S16")
    specs = [AggSpec("count"), AggSpec("sum"), AggSpec("min"), AggSpec("max"),
             AggSpec("count", pred=T.Predicate("prefix", b"c01")),
             AggSpec("sum", pred=T.Predicate("range", b"c005", b"c020")),
             AggSpec("group_count", group=GroupBy("prefix", prefix_len=4),
                     top_k=5),
             AggSpec("group_count", group=GroupBy("bucket", n_buckets=16))]
    ops.reset_launches()
    for t in trees:
        t.put_batch(keys, vals)
        t.compact()
    res = [t.aggregate_many(specs) for t in trees]
    assert res[0] == res[1]
    assert trees[1].agg_stats.counts["agg_fastpath_runs"] > 0
    for t in trees:
        t.put_batch(keys[:700], vals[700:1400])
        for k in range(2000, 2100):
            t.delete(k)
    res = [t.aggregate_many(specs) for t in trees]
    assert res[0] == res[1]
    agg = lambda t: {k: v for k, v in t.agg_stats.counts.items()
                     if k.startswith("agg_")}
    assert agg(trees[0]) == agg(trees[1])
    assert ops.LAUNCHES["fused_zone_agg"] > 0, ops.LAUNCHES
    assert ops.LAUNCHES["zone_histogram"] > 0, ops.LAUNCHES


# --------------------------------------------------------------------------- #
# staged filter backends: multi_range_filter ('jax_packed') and
# code_range_filter ('jax')
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("width,k", [(1, 1), (2, 3), (4, 16), (8, 16),
                                     (16, 3), (32, 1), (32, 16)])
@pytest.mark.parametrize("tile", [multi_filter.DEFAULT_TILE_WORDS, 1000])
def test_multi_range_filter_matches_plain(card, width, k, tile):
    """Bitmaps and per-tile counts, with padding words, empty ranges and a
    range reaching 2**width - 1; tiles of 1,000 words split blocks."""
    rng = np.random.default_rng(width * k + tile)
    n_words = 2 * tile + 777
    words = torch.from_numpy(rng.integers(-2**31, 2**31, n_words)
                             .astype(np.int32))
    words = torch.cat([words, torch.full((-n_words % tile,), -1,
                                         dtype=torch.int32)])
    r = np.sort(rng.integers(0, 2 ** min(width, 16), (k, 2)), axis=1)
    r[0, 1] = 2 ** width - 1
    r[3::4] = (1, 0)
    ranges = bitpack.to_u32_bits(torch.from_numpy(r.astype(np.int64)))
    want = multi_filter.multi_range_filter_plain(words, ranges, width, tile)
    got = multi_filter.multi_range_filter(words.to(card), ranges.to(card),
                                          width, tile)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("lo,hi", [(0, 3), (-1, 40), (9, 2), (-5, -1)])
@pytest.mark.parametrize("tile", [opd_filter.DEFAULT_TILE_CODES, 1000])
def test_code_range_filter_matches_plain(card, lo, hi, tile):
    rng = np.random.default_rng(tile + lo + 100)
    n = 3 * tile
    codes = torch.from_numpy(rng.integers(-1, 60, n).astype(np.int32))
    want = opd_filter.code_range_filter_plain(codes, lo, hi, tile)
    got = opd_filter.code_range_filter(codes.to(card), lo, hi, tile)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(ops.range_filter_codes(codes[:-5].to(card), lo, hi).cpu(),
                       ops.range_filter_codes(codes[:-5], lo, hi))


@pytest.mark.parametrize("backend,kernel", [
    ("jax_packed", "multi_range_filter_packed"), ("jax", "range_filter_codes")])
def test_staged_backend_on_the_card_matches_the_cpu(card, backend, kernel):
    """filter_many, aggregate_many and a ScanServer batch under a staged
    backend answer alike on the card and the CPU, through its kernel and
    not the fused filter."""
    cfg = T.LSMConfig(value_width=16, file_bytes=16 * 1024, l0_limit=2,
                      size_ratio=3, filter_backend=backend)
    trees = [T.LSMTree(cfg, device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(9)
    for _ in range(4):
        keys = rng.integers(0, 3000, 800).astype(np.uint64)
        vals = np.asarray([b"c%03d_%05d" % (i % 37, i)
                           for i in rng.integers(0, 900, 800)], "S16")
        dels = rng.integers(0, 3000, 60).tolist()
        for t in trees:
            t.put_batch(keys, vals)
            for k in dels:
                t.delete(k)
    preds = [T.Predicate("prefix", b"c00%d" % i) for i in range(8)] + [
        T.Predicate("range", b"c005", b"c020"), T.Predicate("prefix", b"zzz")]
    specs = [AggSpec("count", pred=T.Predicate("prefix", b"c01")),
             AggSpec("sum", pred=T.Predicate("range", b"c005", b"c020"))]
    ops.reset_launches()
    res = [t.filter_many(preds) for t in trees]
    for a, b in zip(*res):
        assert np.array_equal(a.keys, b.keys) and \
            np.array_equal(a.values, b.values)
    assert ops.LAUNCHES[kernel] > 0 and ops.LAUNCHES["fused_zone_filter"] == 0
    agg_cpu, agg_card = (t.aggregate_many(specs) for t in trees)
    assert agg_cpu == agg_card
    outs = []
    for t in trees:
        srv = ScanServer(t, max_batch=4)
        srv.submit_many(preds[:5])
        srv.submit_aggs(specs)
        outs.append(srv.drain())
        assert srv.stats.batch_sizes == [4, 3]
    for rid, a in outs[0].items():
        b = outs[1][rid]
        if hasattr(a, "keys"):
            assert np.array_equal(a.keys, b.keys)
        else:
            assert a == b
    assert ops.LAUNCHES["fused_zone_filter"] == 0, ops.LAUNCHES


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("tile", [packed_filter.DEFAULT_TILE_WORDS, 1000])
def test_packed_range_filter_matches_plain(card, width, tile):
    rng = np.random.default_rng(width * 7 + tile)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, 3 * tile,
                                          dtype=np.int64).astype(np.int32))
    top = 2 ** width - 1
    ranges = [(1, min(200, top)), (top // 3, top), (5, 2), (0, 0)]
    if width == 32:
        ranges += [(0, 0xFFFFFFFF), (2**31, 0xFFFFFFFF)]
    for lo, hi in ranges:
        want = packed_filter.packed_range_filter_plain(words, lo, hi, width,
                                                       tile)
        got = packed_filter.packed_range_filter(words.to(card), lo, hi, width,
                                                tile)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (lo, hi)
        assert torch.equal(
            ops.range_filter_packed(words[:-5].to(card), width, lo, hi).cpu(),
            ops.range_filter_packed(words[:-5], width, lo, hi))


def _filter_lengths(tile):
    """0, one tile, 37 tiles (fig5's largest SCT at 32,768), more tiles than
    the card holds blocks at once, and last tiles 5 short, 3 long and 1
    short of 3 tiles."""
    many = 140 if tile > 4096 else 1500
    return [0, tile, 37 * tile, many * tile, tile - 5, tile + 3, 3 * tile - 1]


def _check_filter_on_card(name, fn, plain, x, *args):
    """``fn`` on the card against ``plain`` on the same operands (on the
    card too: the same PyTorch code), outputs bit for bit, one launch of
    the kernel ``name`` for a non-empty input."""
    before = ops.LAUNCHES[name]
    got = fn(x, *args)
    torch.cuda.synchronize()
    want = plain(x, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), args
    assert ops.LAUNCHES[name] == before + (x.shape[0] > 0)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("tile", [packed_filter.DEFAULT_TILE_WORDS, 1000])
@pytest.mark.parametrize("cluster", packed_filter.CLUSTER_SIZES)
def test_packed_range_filter_every_shape_matches_plain(card, width, tile,
                                                       cluster):
    """Every cluster size the build instantiates, at partial last tiles,
    on words[1:] views (4-byte loads), with a range in the middle, one
    reaching 2**width - 1 (the padding words' fields count) and an empty
    one; width 32 also with hi = 0xFFFFFFFF over all of uint32."""
    rng = np.random.default_rng(width * 31 + tile + cluster)
    top = 2 ** width - 1
    ranges = [(1, min(200, top)), (top // 3, top), (5, 2), (0, top)]
    fn = functools.partial(packed_filter._launch, width=width,
                           tile_words=tile, cluster=cluster)
    plain = functools.partial(packed_filter.packed_range_filter_plain,
                              width=width, tile_words=tile)
    for n in _filter_lengths(tile):
        words = torch.from_numpy(rng.integers(-2**31, 2**31, n + 1,
                                              dtype=np.int64)
                                 .astype(np.int32)).to(card)
        for lo, hi in ranges:
            _check_filter_on_card("range_filter_packed", fn, plain,
                                  words[:n], lo, hi)
            _check_filter_on_card("range_filter_packed", fn, plain,
                                  words[1:], lo, hi)


@pytest.mark.parametrize("tile", [opd_filter.DEFAULT_TILE_CODES, 1000])
@pytest.mark.parametrize("cluster", packed_filter.CLUSTER_SIZES)
def test_code_range_filter_every_shape_matches_plain(card, tile, cluster):
    """Every cluster size, at partial last tiles, on codes[1:] views
    (4-byte loads), with ranges that hold -1 (the padding codes count),
    an empty one and all of int32."""
    rng = np.random.default_rng(tile + cluster)
    ranges = [(0, 3), (-1, 40), (9, 2), (-5, -1), (-2**31, 2**31 - 1)]
    fn = functools.partial(opd_filter._launch, tile_codes=tile,
                           cluster=cluster)
    plain = functools.partial(opd_filter.code_range_filter_plain,
                              tile_codes=tile)
    for n in _filter_lengths(tile):
        codes = torch.from_numpy(rng.integers(-1, 60, n + 1)
                                 .astype(np.int32)).to(card)
        for lo, hi in ranges:
            _check_filter_on_card("range_filter_codes", fn, plain,
                                  codes[:n], lo, hi)
            _check_filter_on_card("range_filter_codes", fn, plain,
                                  codes[1:], lo, hi)


def test_filters_write_counts_without_a_fill(card):
    """The counts are stored, not added: outputs allocated over memory left
    full of other values still come out equal to plain."""
    rng = np.random.default_rng(5)
    n = 37 * packed_filter.DEFAULT_TILE_WORDS - 26044
    words = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                             .astype(np.int32)).to(card)
    for _ in range(3):
        junk = torch.full((4 * n,), 12345, dtype=torch.int32, device=card)
        del junk
        _check_filter_on_card("range_filter_packed",
                              packed_filter.packed_range_filter,
                              packed_filter.packed_range_filter_plain,
                              words, 0, 2**31, 32)
        junk = torch.full((4 * n,), 777, dtype=torch.int32, device=card)
        del junk
        _check_filter_on_card("range_filter_codes",
                              opd_filter.code_range_filter,
                              opd_filter.code_range_filter_plain,
                              words, -2**30, 2**30)


@pytest.mark.parametrize("n_words,nbits,n_keys", [
    (512, 1 << 14, 4096), (2048, 1 << 16, 1 << 20), (4, 4096, 3000),
    (20000, 20000 * 32, 100_003), (0, 64, 10)])
@pytest.mark.parametrize("n_hashes", [0, 1, 6])
def test_bloom_probe_matches_plain(card, n_words, nbits, n_keys, n_hashes):
    """The micro-bench's bloom, the kernel's largest documented one (2,048
    words) with 2^20 keys, nbits past the words, a bloom above 48 KB (read
    through __ldg) and no words at all."""
    rng = np.random.default_rng(n_words + n_hashes)
    bloom = torch.from_numpy(rng.integers(-2**31, 2**31, n_words,
                                          dtype=np.int64).astype(np.int32))
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, n_keys,
                                         dtype=np.int64).astype(np.int32))
    want = bloom_probe.bloom_probe_plain(bloom, nbits, keys, n_hashes)
    got = bloom_probe.bloom_probe(bloom.to(card), nbits, keys.to(card),
                                  n_hashes)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_words,nbits", [
    (1, 1), (1, 3), (4, 3), (100, 1000), (2048, 1 << 16), (16384, 1 << 19),
    (20000, 20000 * 32), (20000, 2**32 - 1), (3, 4096)])
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("n_hashes", [0, 1, 6])
def test_bloom_probe_every_instantiation_matches_plain(card, n_words, nbits,
                                                       view, n_hashes):
    """Power-of-two nbits (a mask) and others (the magic-number remainder),
    from 1 to 2^32 - 1; blooms in shared memory and above 48 KB (64 and 80
    KB, read through __ldg); bits past the words (a miss, staged as zeros
    or tested); 10,007 keys (not a multiple of 4) and a keys[1:] view off a
    16-byte line (4-byte key loads)."""
    rng = np.random.default_rng(n_words + nbits % 997 + 3 * n_hashes + view)
    bloom = torch.from_numpy(rng.integers(-2**31, 2**31, n_words,
                                          dtype=np.int64).astype(np.int32))
    full = torch.from_numpy(rng.integers(-2**31, 2**31, 10_008,
                                         dtype=np.int64).astype(np.int32))
    keys = full[1:] if view else full[:-1]
    want = bloom_probe.bloom_probe_plain(bloom, nbits, keys, n_hashes)
    kc = full.to(card)[1:] if view else full.to(card)[:-1]
    assert (kc.data_ptr() % 16 == 0) != view
    before = ops.LAUNCHES["bloom_probe"]
    got = bloom_probe.bloom_probe(bloom.to(card), nbits, kc, n_hashes)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bloom_probe"] == before + 1
    assert torch.equal(got.cpu(), want)
    if n_hashes == 1 and 1000 <= nbits <= 32 * n_words:
        assert 0 < int(want.sum()) < keys.shape[0]


def test_bloom_probe_has_no_false_negatives(card):
    keys = torch.arange(5000, dtype=torch.int64) * 2654435761 % 2**32
    nbits = 1 << 16
    h = torch.stack([bloom_probe.mix32(keys, s) % nbits
                     for s in bloom_probe.BLOOM_SEEDS32])
    bits = torch.zeros(nbits, dtype=torch.int64)
    bits[h.reshape(-1)] = 1
    words = (bits.reshape(-1, 32) << torch.arange(32)).sum(1)
    got = ops.bloom_probe(bitpack.to_u32_bits(words).to(card), nbits,
                          bitpack.to_u32_bits(keys).to(card))
    assert bool(got.all())


def _ssm_operands(shape, seed):
    B, L, D, N = shape
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32))
    dt = torch.from_numpy(np.abs(rng.normal(size=(B, L, D))).astype(
        np.float32) * 0.1)
    A = torch.from_numpy(-np.abs(rng.normal(size=(D, N))).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, L, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(B, L, N)).astype(np.float32))
    return u, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", [(1, 32, 128, 8), (2, 64, 256, 16),
                                   (1, 64, 128, 5), (1, 32, 256, 32),
                                   (1, 32, 128, 1)])
def test_ssm_scan_matches_plain(card, shape):
    u, dt, A, Bm, Cm = _ssm_operands(shape, sum(shape))
    want = ssm_scan.ssm_scan_plain(u, dt, A, Bm, Cm)
    got = ssm_scan.ssm_scan(*(t.to(card) for t in (u, dt, A, Bm, Cm)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [
    (1, 64, 128, 48), (1, 64, 128, 64), (1, 512, 1024, 16), (2, 96, 384, 64),
    (1, 64, 128, 300), (3, 160, 256, 13), (1, 96, 128, 7), (1, 64, 128, 129),
    (1, 32, 128, 2), (2, 64, 256, 30), (1, 32, 128, 512), (1, 128, 4096, 16)])
def test_ssm_scan_layouts_match_plain_on_the_card(card, shape):
    """State dimensions past the old limit of 32 (48, 64; 129, 300 and 512
    in passes of 128 states), every lane count a channel takes (1 to 32),
    L over several staged chunks, B and C rows off a 16-byte line (N = 13,
    7, 129, 2, 30), against the plain version on the card."""
    ops_ = [t.to(card) for t in _ssm_operands(shape, sum(shape) + 3)]
    want = ssm_scan.ssm_scan_plain(*ops_)
    before = ops.LAUNCHES["ssm_scan"]
    got = ssm_scan.ssm_scan(*ops_)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_ssm_scan_holds_plain_where_decays_are_near_1(card):
    """|A| scaled by 0.05 (decays exp(dt A) near 1, as in a trained
    mamba): over 2,048 steps the state keeps a long memory, so any
    reordering of the recurrence drifts from the plain version.  The
    kernel rounds the state as the plain version does: its final state
    equals the plain version's, its y stays within rtol = atol = 1e-4, and
    against a float64 run it is no further off than the plain version."""
    u, dt, A, Bm, Cm = (t.to(card) for t in
                        _ssm_operands((1, 2048, 1024, 16), 5))
    A = A * 0.05
    want = ssm_scan.ssm_scan_plain(u, dt, A, Bm, Cm)
    got = ssm_scan.ssm_scan(u, dt, A, Bm, Cm)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(got[1], want[1])
    x = torch.zeros((1, 1024, 16), dtype=torch.float64, device=card)
    y64 = torch.empty((1, 2048, 1024), dtype=torch.float64, device=card)
    u, dt, A, Bm, Cm = (t.double() for t in (u, dt, A, Bm, Cm))
    for t in range(2048):
        d = dt[:, t, :, None]
        x = torch.exp(d * A) * x + (d * u[:, t, :, None]) * Bm[:, t, None, :]
        y64[:, t] = (x * Cm[:, t, None, :]).sum(dim=-1)
    err_kernel = float((got[0].double() - y64).abs().max())
    err_plain = float((want[0].double() - y64).abs().max())
    assert err_kernel <= 1.05 * err_plain + 1e-6


def test_ssm_scan_takes_more_batch_rows_than_a_grid_dimension(card):
    """65,543 batch rows (the old kernel's grid.y held 65,535)."""
    ops_ = [t.to(card) for t in _ssm_operands((65543, 4, 128, 2), 11)]
    want = ssm_scan.ssm_scan_plain(*ops_, chunk=4)
    got = ssm_scan.ssm_scan(*ops_, chunk=4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_spilled_tree_restores_on_the_card(card, tmp_path):
    """A tree spilled on the card (WAL 'group') and restored on the card,
    after a planned close: every SCT equal to its counterpart before the
    close (the packed words by ``torch.equal`` on the card), ``filter_many``
    equal, the restored filter through ``fused_zone_filter`` and the next
    compaction through ``unpack_codes`` and ``remap_pack_codes``."""
    from repro_torch.core.sct import sct_to_arrays

    cfg = T.LSMConfig(value_width=16, file_bytes=16 * 1024, l0_limit=2,
                      size_ratio=3, wal_sync="group")
    tree = T.LSMTree(cfg, spill_dir=str(tmp_path), device=card)
    rng = np.random.default_rng(12)
    for _ in range(3):
        keys = rng.integers(0, 4000, 900).astype(np.uint64)
        vals = np.asarray([b"c%03d_%05d" % (i % 37, i)
                           for i in rng.integers(0, 900, 900)], "S16")
        tree.put_batch(keys, vals)
        for k in rng.integers(0, 4000, 50).tolist():
            tree.delete(k)
    assert tree.n_compactions > 0 and tree.memtable.n_versions > 0
    preds = [T.Predicate("prefix", b"c00%d" % i) for i in range(8)] + [
        T.Predicate("range", b"c005", b"c020")]
    want = tree.filter_many(preds)
    before = {s.file_id: s for s in tree.all_runs()}
    tree.close()
    back = T.LSMTree.restore(cfg, str(tmp_path), device=card)
    assert back._seqno == tree._seqno and back.wal_replayed > 0
    assert [[s.file_id for s in lvl] for lvl in back.levels] == \
        [[s.file_id for s in lvl] for lvl in tree.levels]
    for s in back.all_runs():
        old = before[s.file_id]
        assert s.packed.device.type == "cuda"
        assert torch.equal(s.packed, old.packed)
        for f in ("code_lo", "code_hi", "weight_sums"):
            assert torch.equal(getattr(s.blocks, f), getattr(old.blocks, f))
        a, b = sct_to_arrays(s), sct_to_arrays(old)
        for f in ("keys", "seqnos", "tombs", "opd_values", "bloom_words"):
            assert np.array_equal(a[f], b[f]), f
    ops.reset_launches()
    got = back.filter_many(preds)
    assert ops.LAUNCHES["fused_zone_filter"] > 0
    for a, b in zip(want, got):
        assert np.array_equal(a.keys, b.keys) and \
            np.array_equal(a.values, b.values)
    back.compact()
    assert ops.LAUNCHES["unpack_codes"] > 0
    assert ops.LAUNCHES["remap_pack_codes"] > 0
    for a, b in zip(want, back.filter_many(preds)):
        assert np.array_equal(a.keys, b.keys) and \
            np.array_equal(a.values, b.values)
    back.close()


def test_launch_counts_hold_under_threads(card):
    """8 threads each launch ``pack_codes`` N times at once: the launch
    count grows by exactly 8 N (the count is taken under a lock) and every
    result equals the plain version.  The first launches also race the
    build, which runs once under its own lock."""
    import threading

    n_threads, n_calls = 8, 200
    rng = np.random.default_rng(40)
    inputs = [_codes(4096 + 97 * t, 16, rng) for t in range(n_threads)]
    wants = [bitpack.pack_codes_plain(c, 16) for c in inputs]
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(t):
        try:
            codes = inputs[t].to(card)
            barrier.wait(timeout=60)
            outs = [bitpack.pack_codes(codes, 16) for _ in range(n_calls)]
            torch.cuda.synchronize()
            for got in outs:
                assert torch.equal(got.cpu(), wants[t])
        except BaseException as e:
            errors.append(e)

    before = ops.LAUNCHES["pack_codes"]
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors, errors[0]
    assert ops.LAUNCHES["pack_codes"] - before == n_threads * n_calls


def test_background_tree_on_the_card_matches_a_sync_tree_on_the_cpu(card):
    """A background-mode tree on the card, its flushes and compactions on
    the workers and a reader thread filtering beside the writer: after
    ``drain`` its answers equal a sync tree's on the CPU, and the workers
    launched the pack, unpack and remap kernels."""
    import threading

    kw = dict(value_width=16, file_bytes=16 * 1024, l0_limit=2, size_ratio=3)
    preds = [T.Predicate("prefix", b"c00%d" % i) for i in range(8)] + [
        T.Predicate("range", b"c005", b"c020")]
    rng = np.random.default_rng(13)
    batches = [(rng.integers(0, 4000, 900).astype(np.uint64),
                np.asarray([b"c%03d_%05d" % (i % 37, i)
                            for i in rng.integers(0, 900, 900)], "S16"))
               for _ in range(6)]
    sync = T.LSMTree(T.LSMConfig(**kw), device="cpu")
    stop, errors = threading.Event(), []
    ops.reset_launches()
    with T.LSMTree(T.LSMConfig(maintenance="background", **kw),
                   device=card) as tree:

        def reader():
            try:
                while not stop.is_set():
                    for r in tree.filter_many(preds):
                        ks = r.keys.tolist()
                        assert ks == sorted(set(ks))
            except BaseException as e:
                errors.append(e)

        th = threading.Thread(target=reader)
        th.start()
        try:
            for keys, vals in batches:
                tree.put_batch(keys, vals)
                sync.put_batch(keys, vals)
        finally:
            stop.set()
            th.join(timeout=60)
        assert not th.is_alive() and not errors, errors
        tree.flush()
        sync.flush()
        tree.drain(timeout=60)
        assert tree._sched.n_bg_flushes > 0
        assert tree._sched.n_bg_compactions > 0
        for name in ("pack_codes", "unpack_codes", "remap_pack_codes",
                     "fused_zone_filter"):
            assert ops.LAUNCHES[name] > 0, name
        for a, b in zip(tree.filter_many(preds), sync.filter_many(preds)):
            assert np.array_equal(a.keys, b.keys) and \
                np.array_equal(a.values, b.values)
        ka, va = tree.range_lookup(0, 4000)
        kb, vb = sync.range_lookup(0, 4000)
        assert np.array_equal(ka, kb) and np.array_equal(va, vb)
