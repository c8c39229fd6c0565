"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one:
a CUDA kernel has no CPU mode.  Each kernel is held bit for bit against its
plain PyTorch version (which ``test_torch_kernels.py`` holds against the
JAX package), and a small tree on the card against the same tree on the
CPU.  The file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch import AggSpec, GroupBy, ScanServer
from repro_torch.kernels import (_build, agg_scan, bitpack, bloom_probe,
                                 fused_scan, merge_remap, multi_filter,
                                 opd_filter, ops, packed_filter, ssm_scan)

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


def test_tiered_tree_on_the_card_matches_the_cpu(card):
    """A tiered tree on the card with two stacked runs at L1 (run depth 2):
    'fused' ``filter_many`` reads the stacked level through
    ``fused_zone_filter`` and equals the same tree on the CPU; a migration
    to leveling then merges the whole level into L2 through
    ``unpack_codes`` and ``remap_pack_codes``, and every SCT equals the
    CPU's (the packed words by ``torch.equal``)."""
    from repro_torch.core.sct import sct_to_arrays

    cfg = T.LSMConfig(value_width=16, file_bytes=16 * 1024, l0_limit=2,
                      size_ratio=3, compaction_policy="tiered", tier_runs=3)
    preds = [T.Predicate("prefix", b"c00%d" % i) for i in range(8)] + [
        T.Predicate("range", b"c005", b"c020")]
    rng = np.random.default_rng(14)
    batches = [(rng.integers(0, 4000, 900).astype(np.uint64),
                np.asarray([b"c%03d_%05d" % (i % 37, i)
                            for i in rng.integers(0, 900, 900)], "S16"),
                rng.integers(0, 4000, 40).tolist()) for _ in range(2)]
    trees = [T.LSMTree(cfg, device=dev) for dev in (card, "cpu")]
    for tree in trees:
        for keys, vals, dels in batches:
            tree.put_batch(keys, vals)
            for k in dels:
                tree.delete(k)
            tree.compact()

    def same_trees():
        ids = [[[s.file_id for s in lvl] for lvl in t.levels] for t in trees]
        assert ids[0] == ids[1]
        for a, b in zip(trees[0].all_runs(), trees[1].all_runs()):
            assert a.packed.device.type == "cuda"
            assert torch.equal(a.packed.cpu(), b.packed)
            for f in ("code_lo", "code_hi", "weight_sums"):
                assert torch.equal(getattr(a.blocks, f).cpu(),
                                   getattr(b.blocks, f))
            x, y = sct_to_arrays(a), sct_to_arrays(b)
            for f in ("keys", "seqnos", "tombs", "opd_values", "bloom_words"):
                assert np.array_equal(x[f], y[f]), f

    def same_reads():
        for a, b in zip(*(t.filter_many(preds) for t in trees)):
            assert np.array_equal(a.keys, b.keys) and \
                np.array_equal(a.values, b.values)
        ka, va = trees[0].range_lookup(0, 4000)
        kb, vb = trees[1].range_lookup(0, 4000)
        assert np.array_equal(ka, kb) and np.array_equal(va, vb)

    assert trees[0].shape_report()["run_depths"][1] == 2
    same_trees()
    ops.reset_launches()
    same_reads()
    assert ops.LAUNCHES["fused_zone_filter"] > 0
    for tree in trees:
        tree.set_policy(T.CompactionPolicy(kind="leveled"))
        tree.compact()
    assert ops.LAUNCHES["unpack_codes"] > 0
    assert ops.LAUNCHES["remap_pack_codes"] > 0
    rep = trees[0].shape_report()
    assert rep["levels"][1] == 0 and rep["levels"][2] > 0
    assert max(rep["run_depths"]) <= 1
    same_trees()
    same_reads()


def _shard_stream(seed, n_batches=6, key_space=8000):
    """Batches of puts skewed to the lowest eighth of the keys (so that a
    rebalancing engine splits), with a few deletes each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        keys = np.concatenate([
            rng.integers(0, key_space // 8, 700),
            rng.integers(0, key_space, 200)]).astype(np.uint64)
        vals = np.asarray([b"c%03d_%05d" % (i % 37, i)
                           for i in rng.integers(0, 900, 900)], "S16")
        out.append((keys, vals, rng.integers(0, key_space, 30).tolist()))
    return out


def _shard_reads(eng, preds, key_space=8000):
    aggs = [AggSpec("count"), AggSpec("sum"), AggSpec("min"),
            # resolved edges: shared by every shard and tree shape
            AggSpec("group_count", group=GroupBy(
                "bucket", n_buckets=6,
                edges=(b"c005", b"c012", b"c020", b"c027", b"c033"))),
            AggSpec("group_count", group=GroupBy("prefix", prefix_len=3),
                    top_k=5)]
    got = [(r.keys.tolist(), r.values.tolist()) for r in eng.filter_many(preds)]
    k, v = eng.range_lookup(0, key_space)
    return (got, k.tolist(), v.tolist(),
            [(r.count, r.total, r.min_value, r.groups)
             for r in eng.aggregate_many(aggs)],
            [eng.get(x) for x in range(0, key_space, 37)])


SHARD_PREDS = [T.Predicate("prefix", b"c00%d" % i) for i in range(8)] + [
    T.Predicate("range", b"c005", b"c020")]


def test_sharded_engine_with_a_split_on_the_card(card):
    """A 4-shard engine on the card that splits a hot shard, compacted:
    every shard tree's runs on the card, its answers (filter_many, the
    range scan, aggregates with one set of bucket edges for every shard,
    gets) equal to a one-shard engine's of the same stream, and the
    split's merges launched ``unpack_codes`` and ``remap_pack_codes``."""
    from repro_torch.shard import RebalanceConfig, ShardedLSM

    cfg = T.LSMConfig(value_width=16, file_bytes=16 * 1024, l0_limit=2,
                      size_ratio=3)
    reb = RebalanceConfig(split_threshold_bytes=64 * 1024, skew_factor=1.5,
                          max_shards=5)
    stream = _shard_stream(15)
    with ShardedLSM(cfg, n_shards=4, key_max=8000, rebalance=reb,
                    device=card) as eng, \
            ShardedLSM(cfg, n_shards=1, key_max=8000, device=card) as one:
        ops.reset_launches()
        for keys, vals, dels in stream:
            for e in (eng, one):
                e.put_batch(keys, vals)
                for k in dels:
                    e.delete(k)
        assert eng.n_splits == 1 and eng.n_shards == 5
        assert ops.LAUNCHES["unpack_codes"] > 0
        assert ops.LAUNCHES["remap_pack_codes"] > 0
        for e in (eng, one):
            e.compact_all()
        assert all(s.packed.device.type == "cuda"
                   for t in eng.shards for s in t.all_runs())
        assert _shard_reads(eng, SHARD_PREDS) == _shard_reads(one, SHARD_PREDS)
        assert ops.LAUNCHES["fused_zone_agg"] > 0
        assert ops.LAUNCHES["zone_histogram"] > 0


def test_background_sharded_engine_on_the_card_matches_sync(card):
    """A background 4-shard engine on the card, one scheduler on its pool
    for every shard: drained, it answers as its sync twin; its workers
    launched the pack, unpack and remap kernels."""
    from repro_torch.shard import ShardedLSM

    kw = dict(value_width=16, file_bytes=16 * 1024, l0_limit=2,
              size_ratio=3)
    stream = _shard_stream(16)
    ops.reset_launches()
    with ShardedLSM(T.LSMConfig(maintenance="background", **kw),
                    n_shards=4, key_max=8000, n_workers=4,
                    device=card) as bg, \
            ShardedLSM(T.LSMConfig(**kw), n_shards=4, key_max=8000,
                       device=card) as sync:
        assert all(t._sched is bg.scheduler for t in bg.shards)
        for keys, vals, dels in stream:
            for e in (bg, sync):
                e.put_batch(keys, vals)
                for k in dels:
                    e.delete(k)
        bg.flush()
        sync.flush()
        bg.drain(timeout=60)
        assert bg.scheduler.n_bg_flushes > 0
        assert bg.scheduler.n_bg_compactions > 0
        for name in ("pack_codes", "unpack_codes", "remap_pack_codes"):
            assert ops.LAUNCHES[name] > 0, name
        assert _shard_reads(bg, SHARD_PREDS) == \
            _shard_reads(sync, SHARD_PREDS)


def test_sharded_restore_on_the_card(card, tmp_path):
    """A spilled sharded engine on the card (WAL 'group', a split in the
    stream), closed and ``ShardedLSM.restore``d on the card: the boundary
    table, every shard's runs (the packed words by ``torch.equal`` on the
    card) and the answers equal the engine's before the close."""
    from repro_torch.shard import RebalanceConfig, ShardedLSM

    cfg = T.LSMConfig(value_width=16, file_bytes=16 * 1024, l0_limit=2,
                      size_ratio=3, wal_sync="group")
    reb = RebalanceConfig(split_threshold_bytes=64 * 1024, skew_factor=1.5,
                          max_shards=3)
    eng = ShardedLSM(cfg, n_shards=2, key_max=8000, rebalance=reb,
                     spill_dir=str(tmp_path), device=card)
    for keys, vals, dels in _shard_stream(17):
        eng.put_batch(keys, vals)
        for k in dels:
            eng.delete(k)
    assert eng.n_splits == 1
    want = _shard_reads(eng, SHARD_PREDS)
    before = {s.file_id: s for t in eng.shards for s in t.all_runs()}
    uppers = eng.router.uppers
    eng.close()
    back = ShardedLSM.restore(cfg, str(tmp_path), device=card)
    try:
        assert back.router.uppers == uppers
        assert back.device.type == "cuda"
        assert sum(t.wal_replayed for t in back.shards) > 0
        for t in back.shards:
            assert t.device.type == "cuda"
            for s in t.all_runs():
                assert s.packed.device.type == "cuda"
                assert torch.equal(s.packed, before[s.file_id].packed)
        ops.reset_launches()
        assert _shard_reads(back, SHARD_PREDS) == want
        assert ops.LAUNCHES["fused_zone_filter"] > 0
    finally:
        back.close()


def test_replicated_group_on_the_card(card, tmp_path):
    """A leader and 2 followers on the card (WAL 'group'): the followers'
    flushes launch ``pack_codes`` while the leader's writes are shipped,
    every follower answers as the leader; a kill, a promote and
    ``compact()`` on the new leader launch ``unpack_codes`` and
    ``remap_pack_codes``; the old leader resynced on the card and the
    group restored on the card answer alike."""
    from repro_torch.replica import ReadPolicy, ReplicatedShard

    cfg = T.LSMConfig(value_width=16, memtable_bytes=32 * 1024,
                      file_bytes=16 * 1024, l0_limit=2, size_ratio=3,
                      wal_sync="group")
    root = str(tmp_path)
    grp = ReplicatedShard(cfg, root, n_followers=2, auto_pump=False,
                          read_policy=ReadPolicy(max_lag_seqnos=0),
                          device=card)
    flushes = 0
    for keys, vals, dels in _shard_stream(18):
        grp.put_batch(keys, vals)
        for k in dels:
            grp.delete(k)
        before = ops.LAUNCHES["pack_codes"]
        grp.pump()
        torch.cuda.synchronize()
        flushes += ops.LAUNCHES["pack_codes"] - before
    assert flushes > 0
    assert all(t.n_flushes > 0 for t in grp.replicas.values())
    assert all(s.packed.device.type == "cuda"
               for t in grp.replicas.values() for s in t.all_runs())
    want = _shard_reads(grp.leader, SHARD_PREDS)
    for i in (1, 2):
        assert _shard_reads(grp.replicas[i], SHARD_PREDS) == want
    snap = grp.snapshot()
    assert snap.follower and snap.lag == 0
    grp.kill_leader()
    assert grp.promote(grp.best_follower()) == grp.replicas[0]._seqno
    ops.reset_launches()
    grp.compact()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack_codes"] > 0
    assert ops.LAUNCHES["remap_pack_codes"] > 0
    assert _shard_reads(grp.leader, SHARD_PREDS) == want
    t = grp.resync_follower(0)
    assert t.device.type == "cuda"
    assert _shard_reads(t, SHARD_PREDS) == want
    grp.close()
    back = ReplicatedShard.restore(cfg, root, device=card)
    try:
        assert (back.epoch, back.leader_idx) == (2, 1)
        assert all(t.device.type == "cuda" for t in back.replicas.values())
        for t in back.replicas.values():
            assert _shard_reads(t, SHARD_PREDS) == want
    finally:
        back.close()


# --------------------------------------------------------------------------- #
# the engine's consumers and the dense decoder on the card
# --------------------------------------------------------------------------- #
def _fill_store(store, n, seed):
    rng = np.random.default_rng(seed)
    domains = [b"web/high", b"web/low", b"code/high", b"code/low",
               b"math/high"]
    for i in range(n):
        toks = rng.integers(0, 1000, int(rng.integers(50, 300)))
        store.put_sample(i, toks.astype(np.int32),
                         domains[int(rng.integers(0, len(domains)))])
        if i % 16 == 5:
            j = int(rng.integers(0, i + 1))
            if i % 32 == 5:
                store.delete_sample(j)
            else:
                store.put_sample(j, toks[:60].astype(np.int32), b"code/low")


def test_consumers_on_the_card_match_the_cpu(card):
    """A TokenStore and a PrefixCacheIndex on the card answer as the same
    on the CPU, I/O counters included, and their selection scans launch
    ``fused_zone_filter``."""
    from repro_torch.core import Predicate
    from repro_torch.pipeline import TokenStore, TokenStoreConfig
    from repro_torch.serving.prefix_cache import (PrefixCacheConfig,
                                                  PrefixCacheIndex)

    cfg = TokenStoreConfig(file_bytes=32 * 1024)
    stores = [TokenStore(cfg, device=d) for d in (card, "cpu")]
    for s in stores:
        _fill_store(s, 3000, seed=3)
    assert stores[0].lsm.n_compactions == stores[1].lsm.n_compactions > 0
    pred = Predicate("prefix", b"code/")
    ops.reset_launches()
    got = [stores[0].select(pred, dp_rank=r, dp_size=4) for r in range(4)]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_zone_filter"] > 0
    for r in range(4):
        assert np.array_equal(got[r], stores[1].select(pred, r, 4))
    a, b = (list(s.batches(pred, 4, 32, seed=2, max_batches=6))
            for s in stores)
    assert len(a) == len(b) == 6
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    io = [vars(s.lsm.store.stats) for s in stores]
    assert {k: v for k, v in io[0].items() if k != "_lock"} == \
        {k: v for k, v in io[1].items() if k != "_lock"}

    idx = [PrefixCacheIndex(PrefixCacheConfig(file_bytes=8 * 1024,
                                              l0_limit=2), device=d)
           for d in (card, "cpu")]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 50_000, 16) for _ in range(2000)]
    for i, p in enumerate(prompts):
        for x in idx:
            x.admit(p, [i], b"tenantA/hot" if i % 3 else b"tenantB/cold")
    for x in idx:
        x.retag(prompts[1], b"tenantB/cold")
        x.evict_prefixes(prompts[10:50])
    ops.reset_launches()
    cands = idx[0].eviction_candidates(b"tenantB/cold")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_zone_filter"] > 0
    assert cands == idx[1].eviction_candidates(b"tenantB/cold")
    assert [1] in cands
    assert np.array_equal(idx[0].scan(Predicate("prefix", b"tenantA/")),
                          idx[1].scan(Predicate("prefix", b"tenantA/")))
    for p in prompts[::37]:
        assert idx[0].lookup(p) == idx[1].lookup(p)
    assert idx[0].stats == idx[1].stats


def _reduced_dense(card, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    on_card = model.init(0, device="cpu").to(card)
    return cfg, model, cpu, on_card


def test_dense_model_on_the_card_matches_the_cpu(card, monkeypatch):
    """The reduced dense model's forward and decode logits (float32, TF32
    off) on the card within 1e-4 of the same parameters on the CPU."""
    from repro_torch.models import transformer

    cfg, model, cpu, on_card = _reduced_dense(card, monkeypatch)
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    want, _ = transformer.forward(cpu, tok, cfg)
    got, _ = transformer.forward(on_card, tok.to(card), cfg)
    assert got.device.type == card.type
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = [model.init_cache(2, 12, device=d) for d in ("cpu", card)]
    for t in range(12):
        a, caches[0] = model.decode_step(cpu, caches[0], tok[:, t:t + 1], t)
        b, caches[1] = model.decode_step(on_card, caches[1],
                                         tok[:, t:t + 1].to(card), t)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(b.cpu(), want[:, t], rtol=2e-4, atol=2e-4)


def test_serving_engine_on_the_card_matches_the_cpu(card, monkeypatch):
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, _, cpu, on_card = _reduced_dense(card, monkeypatch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
               for _ in range(10)]
    out = []
    for params, device in ((cpu, "cpu"), (on_card, card)):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=48,
                            device=device)
        out.append(eng.run([Request(i, p, 8) for i, p in enumerate(prompts)]))
    assert out[0] == out[1]
    assert sorted(out[1]) == list(range(10))


# --------------------------------------------------------------------------- #
# the moe, ssm and hybrid families on the card
# --------------------------------------------------------------------------- #
FAMILY_ARCHS = ["falcon-mamba-7b", "granite-moe-1b-a400m", "hymba-1.5b",
                "phi3.5-moe-42b-a6.6b"]


def _reduced_family(arch, card, monkeypatch):
    """The reduced model of ``arch`` on the CPU and the same parameters on
    the card, TF32 off for the matmuls and cuDNN's convolutions."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    return cfg, model, cpu, model.init(0, device="cpu").to(card)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_model_on_the_card_matches_the_cpu(card, monkeypatch, arch):
    """Forward logits and aux, and every decode step, on the card within
    1e-4 of the same parameters on the CPU (decode against forward within
    2e-4); the SSM layers scan with the kernel, the CPU with its plain
    version."""
    from repro_torch.models import transformer

    cfg, model, cpu, on_card = _reduced_family(arch, card, monkeypatch)
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    want, want_aux = transformer.forward(cpu, tok, cfg)
    got, aux = transformer.forward(on_card, tok.to(card), cfg)
    assert got.device.type == card.type
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)
    caches = [model.init_cache(2, 12, device=d) for d in ("cpu", card)]
    for t in range(12):
        a, caches[0] = model.decode_step(cpu, caches[0], tok[:, t:t + 1], t)
        b, caches[1] = model.decode_step(on_card, caches[1],
                                         tok[:, t:t + 1].to(card), t)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(b.cpu(), want[:, t], rtol=2e-4, atol=2e-4)
    for name, leaf in caches[1].items():
        torch.testing.assert_close(leaf.cpu(), caches[0][name], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_serving_engine_on_the_card_matches_the_cpu(card, monkeypatch,
                                                           arch):
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, _, cpu, on_card = _reduced_family(arch, card, monkeypatch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
               for _ in range(10)]
    out = []
    for params, device in ((cpu, "cpu"), (on_card, card)):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=48,
                            device=device)
        out.append(eng.run([Request(i, p, 8) for i, p in enumerate(prompts)]))
    assert out[0] == out[1]
    assert sorted(out[1]) == list(range(10))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_forward_on_the_card_launches_the_scan_once_a_layer(card,
                                                               monkeypatch,
                                                               arch):
    from repro_torch.models import transformer

    cfg, _, _, on_card = _reduced_family(arch, card, monkeypatch)
    tok = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (3, 21))).to(card)
    ops.reset_launches()
    transformer.forward(on_card, tok, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == cfg.n_layers


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_decode_step_on_the_card_gives_the_same_bits_twice(card,
                                                              monkeypatch,
                                                              arch):
    """The combine adds each token's contributions in a fixed order (no
    float atomics): one decode step run twice from equal caches gives
    bit-equal logits, in float32 and in bf16."""
    import dataclasses

    from repro_torch.models import build_model

    cfg, _, _, on_card = _reduced_family(arch, card, monkeypatch)
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (4, 6))).to(card)
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        params = on_card.to(getattr(torch, dtype))
        logits = []
        for _ in range(2):
            cache = model.init_cache(4, 8, device=card)
            for t in range(6):
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
            logits.append(lg)
        assert logits[0].dtype == getattr(torch, dtype)
        assert torch.equal(logits[0], logits[1])


# --------------------------------------------------------------------------- #
# the encoder-decoder (whisper-small) on the card
# --------------------------------------------------------------------------- #
def _reduced_whisper(card, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    return cfg, model, cpu, model.init(0, device="cpu").to(card)


@pytest.mark.parametrize("kv_block", [1024, 8])
def test_encdec_decode_on_the_card_matches_decode_train(card, monkeypatch,
                                                       kv_block):
    """float32, TF32 off: prefill (enc_out, xk, xv) and decode_train on the
    card within 1e-4 of the CPU's on the same parameters, and 20
    teacher-forced decode steps over the prefilled cache (dec_len 16, so
    the last 4 roll) each within 1e-4 of the CPU's step; the first 16
    within 2e-4 of decode_train.  kv_block 8 puts every attention of the
    forward on the flash path."""
    from repro_torch.models import encdec, flags

    monkeypatch.setattr(flags, "kv_block", kv_block)
    cfg, model, cpu, on_card = _reduced_whisper(card, monkeypatch)
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model))
                              .astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
    caches, outs = [], []
    for params, dev in ((cpu, "cpu"), (on_card, card)):
        enc_out, xk, xv = model.prefill(params, {"frames": frames.to(dev)})
        full = encdec.decode_train(params, tok[:, :16].to(dev), enc_out, cfg)
        cache = model.init_cache(2, 24, device=dev)
        cache["xk"], cache["xv"] = xk, xv
        caches.append(cache)
        outs.append((enc_out, xk, xv, full))
    for a, b in zip(*outs):
        assert b.device.type == card.type
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    full = outs[1][3]
    for t in range(20):
        a, caches[0] = model.decode_step(cpu, caches[0], tok[:, t:t + 1], t)
        b, caches[1] = model.decode_step(on_card, caches[1],
                                         tok[:, t:t + 1].to(card), t)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
        if t < 16:
            torch.testing.assert_close(b, full[:, t], rtol=2e-4, atol=2e-4)
    for name, leaf in caches[1].items():
        torch.testing.assert_close(leaf.cpu(), caches[0][name], rtol=1e-4,
                                   atol=1e-4)


def test_encdec_serving_engine_on_the_card_matches_its_replay(card,
                                                              monkeypatch):
    """The engine on the card gives the CPU engine's tokens, and each of the
    first four requests (served from pos 0 in fresh slots) equals a
    teacher-forced replay of ``decode_step`` on the engine's cache: no
    prefill, enc_len max_seq, a self cache of dec_len_for(max_seq) slots
    that rolls."""
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, model, cpu, on_card = _reduced_whisper(card, monkeypatch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 8).astype(np.int32)
               for _ in range(10)]
    out = []
    for params, device in ((cpu, "cpu"), (on_card, card)):
        eng = ServingEngine(cfg, params, batch_size=4, max_seq=40,
                            device=device)
        out.append(eng.run([Request(i, p, 8) for i, p in enumerate(prompts)]))
    assert out[0] == out[1]
    seq = torch.from_numpy(np.stack([np.concatenate([prompts[i], out[1][i]])
                                     for i in range(4)])).to(card)
    cache = model.init_cache(4, 40, device=card)
    assert cache["k"].shape[2] == 16
    replay = []
    for t in range(seq.shape[1] - 1):
        lg, cache = model.decode_step(on_card, cache, seq[:, t:t + 1], t)
        replay.append(lg.argmax(-1))
    assert torch.equal(torch.stack(replay, 1)[:, 7:], seq[:, 8:])


# --------------------------------------------------------------------------- #
# training: the scan's backward kernel, train steps, checkpoints
# --------------------------------------------------------------------------- #
def _close_to_plain(got, want, tol=1e-4):
    """Each output within ``tol`` of the plain version's largest magnitude:
    the kernel sums over states, channels and steps in another order."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        scale = float(w.abs().max()) if w.numel() else 0.0
        assert float((g - w).abs().max()) <= tol * max(scale, 1.0)


@pytest.mark.parametrize("shape,a_scale", [
    ((2, 37, 128, 1), 1.0), ((3, 50, 256, 16), 1.0), ((1, 33, 128, 32), 1.0),
    ((2, 20, 128, 40), 1.0), ((1, 16, 256, 3), 1.0), ((4, 100, 384, 16), 1.0),
    ((2, 1024, 128, 16), 1.0), ((1, 7, 128, 64), 1.0),
    pytest.param((2, 1024, 3200, 16), 1.0, id="hymba"),
    pytest.param((1, 256, 8192, 16), 1.0, id="falcon_width"),
    pytest.param((2, 1024, 256, 16), 0.05, id="decays_near_1")])
def test_ssm_scan_bwd_matches_plain_and_repeats_its_bits(card, shape,
                                                         a_scale):
    """N 1, 3, 16, 32, 40 and 64 (past the kernel's states a pass in
    passes), L not a multiple of its 32-step chunk, several batch rows,
    hymba-1.5b's first layer in training (checkpoints in device memory),
    falcon-mamba-7b's width, and decays near 1 (A scaled by 0.05, where a
    reordered recurrence drifts): the kernel's du, ddelta, dA, dB, dC
    within 1e-4 of the plain backward's largest magnitude on the card, one
    launch, and the same bits on a rerun."""
    ops_ = [t.to(card) for t in _ssm_operands(shape, sum(shape) + 7)]
    ops_[2] = ops_[2] * a_scale
    dy = torch.randn(ops_[0].shape, generator=torch.Generator().manual_seed(
        sum(shape))).to(card)
    want = ssm_scan.ssm_scan_bwd_plain(*ops_, dy)
    before = ops.LAUNCHES["ssm_scan_bwd"]
    got = ssm_scan.ssm_scan_bwd(*ops_, dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan_bwd"] == before + 1
    _close_to_plain(got, want)
    again = ssm_scan.ssm_scan_bwd(*ops_, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("shape,rank", [
    pytest.param((2, 1024, 3200, 16), 100, id="hymba"),
    pytest.param((2, 64, 8192, 16), 256, id="falcon_width"),
    ((3, 50, 256, 16), 4), ((2, 40, 256, 16), 100), ((1, 33, 128, 2), 2),
    ((2, 20, 128, 300), 10)])
def test_ssm_scan_bwd_reads_bf16_as_its_float32_copies(card, shape, rank):
    """bf16 u, delta, B and C as the mamba block hands them over (u laid
    out steps first, as its causal conv leaves it; B and C strided slices
    of one projection [Bt, L, rank + 2N] behind ``rank`` columns of dt,
    hymba-1.5b's 100 and falcon-mamba-7b's 256), read by the kernel as
    they are: B and C at every shape (falcon's on 16-byte lines, the
    kernel's 16-byte copies, the others its 4-byte copies), u where L
    fills 16-byte lines (L 1,024, 64 and 40; 50, 33 and 20 copy u).  The
    same bits as the kernel on contiguous float32 copies (widening is
    exact), and within 1e-4 of the plain backward of those copies."""
    B, L, D, N = shape
    u, dt, A, Bm, Cm = (t.to(card) for t in _ssm_operands(shape, 11))
    proj = torch.zeros((B, L, rank + 2 * N), device=card,
                       dtype=torch.bfloat16)
    proj[..., rank:rank + N], proj[..., rank + N:] = Bm, Cm
    u_cols = u.bfloat16().transpose(1, 2).contiguous().transpose(1, 2)
    bf = [u_cols, dt.bfloat16(), A, proj[..., rank:rank + N],
          proj[..., rank + N:]]
    b_in, c_in = ssm_scan._bc_operands(bf[3], bf[4], torch.bfloat16)
    assert b_in.data_ptr() == bf[3].data_ptr()
    assert c_in.data_ptr() == bf[4].data_ptr()
    vec = all(x % 16 == 0 for x in (bf[3].data_ptr(), bf[4].data_ptr(),
                                    2 * bf[3].stride(0), 2 * bf[3].stride(1),
                                    2 * N))
    assert vec == (rank == 256)
    f32 = [t.float().contiguous() for t in bf]
    dy = torch.randn(u.shape, generator=torch.Generator().manual_seed(
        12)).to(card)
    got = ssm_scan.ssm_scan_bwd(*bf, dy)
    want = ssm_scan.ssm_scan_bwd(*f32, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _close_to_plain(got, ssm_scan.ssm_scan_bwd_plain(*f32, dy))


def test_ssm_scan_autograd_on_the_card_matches_the_cpu(card):
    """``SSMScan`` on bf16 u, delta, B, C and float32 A (the model path):
    gradients in the inputs' dtypes, within bf16 rounding of the CPU's."""
    ops_ = _ssm_operands((2, 45, 256, 16), 3)
    leaves = {}
    for dev in ("cpu", card):
        xs = [t.to(dev, torch.float32 if i == 2 else torch.bfloat16)
              .detach().requires_grad_(True) for i, t in enumerate(ops_)]
        y = ssm_scan.SSMScan.apply(*xs, 5)
        y.square().sum().backward()
        leaves[str(dev)] = [x.grad for x in xs]
    for g, w, x in zip(leaves[str(card)], leaves["cpu"], ops_):
        assert g.dtype == w.dtype
        scale = float(w.float().abs().max())
        assert float((g.cpu().float() - w.float()).abs().max()) <= \
            2e-2 * scale


def _state_on(state, device):
    from repro_torch.train import tree as T

    return T.map_tree(lambda t: t.to(device), state)


@pytest.mark.parametrize("arch,n_mb", [
    ("llama3-8b", 1), ("hymba-1.5b", 2), ("falcon-mamba-7b", 1),
    ("granite-moe-1b-a400m", 2), ("whisper-small", 1)])
def test_train_step_on_the_card_matches_the_cpu(card, monkeypatch, arch,
                                               n_mb):
    """A reduced float32 train step (TF32 off) of each family on the card
    against the same step on the CPU: loss and metrics within 1e-4, every
    updated parameter within 2e-4 (AdamW's first step divides each
    gradient element by its own magnitude, so an element near zero turns
    small differences into up to 1 lr of update: atol 1e-3 = lr)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": np.ones((4, 16), np.float32)}
    if cfg.enc_dec:
        batch["frames"] = rng.normal(size=(4, 24, cfg.d_model)).astype(
            np.float32)
    step = make_train_step(model, ocfg, num_microbatches=n_mb)
    want_state, want = step(state, batch)
    ops.reset_launches()
    got_state, got = step(_state_on(state, card), batch)
    torch.cuda.synchronize()
    if cfg.has_ssm:     # forward, remat's recompute, backward: a layer a mb
        assert ops.LAUNCHES["ssm_scan"] == 2 * cfg.n_layers * n_mb
        assert ops.LAUNCHES["ssm_scan_bwd"] == cfg.n_layers * n_mb
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v, rtol=1e-4, atol=1e-4)
    for g, w in zip(T.leaves(got_state), T.leaves(want_state)):
        assert g.device.type == card.type
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=1e-3)
    if cfg.has_ssm:     # a replayed step gives the same bits
        again, _ = step(_state_on(state, card), batch)
        assert all(torch.equal(a, b) for a, b in
                   zip(T.leaves(again), T.leaves(got_state)))


def test_checkpoint_round_trips_onto_the_card(card, tmp_path):
    """A bf16 state with float32 moments saved from the card restores onto
    the card bit for bit, by default and through ``AsyncCheckpointer``."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state

    cfg = get_config("hymba-1.5b").reduced()
    state = make_train_state(build_model(cfg), AdamWConfig(), 3, device=card)
    state["opt"]["mu"] = T.map_tree(lambda t: torch.randn_like(t.float()),
                                    state["opt"]["mu"])
    ckpt.save(str(tmp_path / "a"), 5, state)
    writer = ckpt.AsyncCheckpointer(str(tmp_path / "b"))
    writer.submit(6, state)
    writer.wait()
    writer.close()
    for d, want_step in (("a", 5), ("b", 6)):
        step, back = ckpt.restore(str(tmp_path / d), state)
        assert step == want_step
        for a, b in zip(T.leaves(back), T.leaves(state)):
            assert a.device.type == card.type and a.dtype == b.dtype
            assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the mesh on one card, and the launchers on a second card
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small"])
def test_host_mesh_keeps_every_leaf_bit_for_bit(card, arch):
    """``make_host_mesh()`` starts a one-rank NCCL group and gives the
    (1, 1) mesh; every leaf of the reduced model, distributed by its spec
    in both layouts through ``tree_shardings``, is its whole leaf on
    cuda:0, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import flatten_tree
    from repro_torch.parallel.sharding import tree_shardings

    assert not dist.is_initialized()
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    leaves = flatten_tree(model.init(0, device=card).tree())
    try:
        mesh = make_host_mesh()
        assert dist.get_backend() == "nccl"
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        for layout in ("train", "serve2d"):
            placements = flatten_tree(tree_shardings(
                mesh, model.param_specs(mesh, layout=layout)))
            assert placements.keys() == leaves.keys()
            for name, x in leaves.items():
                local = distribute_tensor(x, mesh,
                                          placements[name]).to_local()
                assert local.device == torch.device("cuda", 0), name
                assert local.dtype == x.dtype and torch.equal(local, x), name
    finally:
        dist.destroy_process_group()


def test_launchers_on_a_second_card_after_the_first(card):
    """The launchers that size their grids and raise their shared-memory
    limits once a card: the SSM forward (a 56 KB ring at G 4, N 16), pack,
    unpack, remap-pack and remap on cuda:1 after cuda:0 in one process,
    each against its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a per-card limit shows only on a "
                    "second card, and the single H100 cannot show it")
    rng = np.random.default_rng(7)
    scan_ops = _ssm_operands((1, 64, 256, 16), 3)
    want_scan = ssm_scan.ssm_scan_plain(*scan_ops)
    codes = _codes(100_003, 16, rng)
    words = bitpack.pack_codes_plain(codes, 16)
    table = torch.from_numpy(rng.integers(-1, 2 ** 16, 70_000).astype(np.int32))
    offsets = torch.tensor([0, 30_000], dtype=torch.int32)
    srcs = torch.from_numpy(rng.integers(0, 2, 100_003).astype(np.int32))
    evs = torch.from_numpy(rng.integers(-1, 30_000, 100_003).astype(np.int32))
    remap_args = (evs, srcs, table, offsets)
    for index in (0, 1):
        dev = torch.device("cuda", index)
        got = ssm_scan.ssm_scan(*(t.to(dev) for t in scan_ops))
        for g, w in zip(got, want_scan):
            assert g.device == dev
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
        assert torch.equal(bitpack.pack_codes(codes.to(dev), 16).cpu(), words)
        assert torch.equal(bitpack.unpack_codes(words.to(dev), 16,
                                                codes.shape[0]).cpu(), codes)
        on = [t.to(dev) for t in remap_args]
        assert torch.equal(merge_remap.remap_pack_codes(*on, 16).cpu(),
                           merge_remap.remap_pack_codes_plain(*remap_args, 16))
        assert torch.equal(merge_remap.remap_codes(*on).cpu(),
                           merge_remap.remap_codes_plain(*remap_args))


# --------------------------------------------------------------------------- #
# the mesh in the training path, on one card: the (1, 1) host mesh
# --------------------------------------------------------------------------- #
@pytest.fixture
def host_mesh(card):
    """``make_host_mesh()``: a one-rank NCCL group and its (1, 1) mesh,
    destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,layers,dtype", [
    ("hymba-1.5b", None, "float32"), ("hymba-1.5b", 2, "bfloat16")])
def test_mesh_step_is_the_meshless_step_bit_for_bit(card, host_mesh, arch,
                                                    layers, dtype):
    """One step of 2 microbatches on the host mesh (the state and batch as
    DTensors, ``ShardCtx`` in the forward, each scan through
    ``local_map``) against the same step without a mesh: the loss, every
    metric and every leaf of the new state bit for bit, and the scan's
    kernels launched as many times on the mesh path as off it.  The
    reduced config in float32; 2 layers at full width in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config(arch)
    cfg = (cfg.reduced() if layers is None else
           dataclasses.replace(cfg, n_layers=layers))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device=card)
    rng = np.random.default_rng(5)
    S = 16 if layers is None else 512
    toks = rng.integers(0, cfg.vocab, (4, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
             "mask": torch.ones((4, S))}
    out = []
    for mesh in (None, host_mesh):
        step = make_train_step(model, ocfg, mesh, num_microbatches=2)
        ops.reset_launches()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        out.append((new, {k: float(v) for k, v in metrics.items()},
                    {k: ops.LAUNCHES[k] for k in ("ssm_scan",
                                                  "ssm_scan_bwd")}))
    (want, want_m, want_n), (got, got_m, got_n) = out
    assert got_n == want_n == {"ssm_scan": 2 * cfg.n_layers * 2,
                               "ssm_scan_bwd": cfg.n_layers * 2}
    assert got_m == want_m
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert is_dtensor(a)
        a = a.to_local()
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["gather", "ep"])
def test_moe_mesh_step_is_the_meshless_step_bit_for_bit(card, host_mesh,
                                                        monkeypatch, impl):
    """Reduced granite-moe-1b-a400m in float32, one step of 2 microbatches
    on the host mesh under ``moe_impl`` (each moe layer's dispatch through
    ``local_map``) against the same step without a mesh: the loss, every
    metric and every leaf of the new state bit for bit.  'gather' at the
    published capacity_factor 1.25, where assignments drop; 'ep' at
    E / k, where its per-shard capacity T drops nothing, as the mesh-less
    one does not."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, flags, moe
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = get_config("granite-moe-1b-a400m").reduced()
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    cf = 1.25 if impl == "gather" else E / k
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    monkeypatch.setattr(flags, "moe_impl", impl)
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device=card)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
             "mask": torch.ones((4, 16))}
    dispatch, dropped = moe.dispatch, [0]

    def counting(gate_idx, C, n):
        order, slot, keep = dispatch(gate_idx, C, n)
        dropped[0] += int((gate_idx < n).sum()) - int(keep.sum())
        return order, slot, keep

    monkeypatch.setattr(moe, "dispatch", counting)
    out = []
    for mesh in (None, host_mesh):
        step = make_train_step(model, ocfg, mesh, num_microbatches=2)
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        out.append((new, {k: float(v) for k, v in metrics.items()}))
    (want, want_m), (got, got_m) = out
    assert (dropped[0] > 0) == (impl == "gather"), dropped
    assert got_m == want_m
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert is_dtensor(a)
        a = a.to_local()
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_mesh_checkpoint_round_trips_on_the_card(card, host_mesh, tmp_path):
    """A state on the host mesh (DTensors) saved, then restored onto the
    mesh through its specs and without a mesh, bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import is_dtensor, place_tree
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state, state_specs

    cfg = get_config("hymba-1.5b").reduced()
    model = build_model(cfg)
    state = make_train_state(model, AdamWConfig(), 3, device=card)
    state["opt"]["mu"] = T.map_tree(lambda t: torch.randn_like(t.float()),
                                    state["opt"]["mu"])
    specs = state_specs(model, host_mesh)
    on_mesh = place_tree(state, host_mesh, specs)
    ckpt.save(str(tmp_path), 7, on_mesh)
    for kw in ({"mesh": host_mesh, "spec_tree": specs}, {}):
        step, back = ckpt.restore(str(tmp_path), state, **kw)
        assert step == 7
        for a, b in zip(T.leaves(back), T.leaves(state)):
            assert is_dtensor(a) == bool(kw)
            a = a.to_local() if kw else a
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)


def _decode_steps(model, params, cache, toks, ctx=None):
    from repro_torch.parallel.sharding import whole
    out = []
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t,
                                          ctx)
        out.append(whole(logits))
    torch.cuda.synchronize()
    return out, {k: whole(v) for k, v in cache.items()}


@pytest.mark.parametrize("layout", ["batch", "tp2d"])
@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b",
                                  "hymba-1.5b", "granite-moe-1b-a400m"])
def test_mesh_decode_is_the_meshless_decode_bit_for_bit(card, host_mesh,
                                                        monkeypatch, arch,
                                                        layout):
    """8 ``decode_step``s of a reduced config in float32 under ``ShardCtx``
    on the host mesh (the cache as DTensors, K/V written and read through
    ``attention.cache_update_mesh`` and ``decode_attention_mesh``) against
    the same steps without a mesh: every step's logits and the cache bit
    for bit, under both serving layouts."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, flags
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.parallel.sharding import place_tree
    from repro_torch.train import tree as T

    monkeypatch.setattr(flags, "serving_layout", layout)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), model.init(0, device=card).tree())
    on_mesh = place_tree(tree, host_mesh, model.param_specs(
        host_mesh, layout="serve2d" if layout == "tp2d" else "train"))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 8))).to(card)
    want = _decode_steps(model, tree, model.init_cache(2, 16, device=card),
                         toks)
    got = _decode_steps(model, on_mesh, model.init_cache(2, 16, device=card),
                        toks, ShardCtx(host_mesh))
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert sorted(got[1]) == sorted(want[1])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_mesh_encdec_is_the_meshless_encdec_bit_for_bit(card, host_mesh):
    """Reduced whisper-small in float32 on the host mesh: ``lm_loss`` and
    every gradient, ``prefill`` and 8 ``decode_step``s against its cross
    K/V, bit for bit the mesh-less ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.parallel.sharding import P, place_tree, whole
    from repro_torch.train import tree as T

    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), model.init(0, device=card).tree())
    ctx = ShardCtx(host_mesh)
    on_mesh = place_tree(tree, host_mesh, model.param_specs(host_mesh))
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17))).to(card)
    frames = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)).to(card)
    batch = {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((2, 16), device=card)}
    placed = place_tree(batch, host_mesh, {
        k: P("data", *([None] * (v.dim() - 1))) for k, v in batch.items()})
    out = []
    for p, b, c in ((tree, batch, None), (on_mesh, placed, ctx)):
        paths, leaves = T.flatten(p)
        live = [t.detach().requires_grad_(True) for t in leaves]
        with (c or ShardCtx()).scope():
            loss, _ = model.loss(T.unflatten(paths, live), b, c)
            grads = [whole(g) for g in torch.autograd.grad(loss, live)]
        pre = [whole(t) for t in model.prefill(p, {"frames": b["frames"]}, c)]
        cache = model.init_cache(2, 24, device=card)
        cache["xk"], cache["xv"] = pre[1].clone(), pre[2].clone()
        out.append((whole(loss), grads, pre,
                    _decode_steps(model, p, cache, toks[:, :8], c)))
    (l0, g0, p0, d0), (l1, g1, p1, d1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(d0[0], d1[0]))
    assert all(torch.equal(d0[1][k], d1[1][k]) for k in d0[1])


def test_scan_ops_under_fake_mode_on_cuda_tensors(card):
    """The scan's custom ops on fake tensors of the card: float32 outputs of
    the kernels' shapes, nothing launched, the FLOP formula counted; on
    real tensors the same ops launch the kernels."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    ops_ = _ssm_operands((2, 64, 256, 16), 9)
    ops_ = [t.to(card) for t in ops_]
    _build.reset_launches()
    y, state = ssm_scan.ssm_scan(*ops_)
    grads = ssm_scan.ssm_scan_bwd(*ops_, y)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssm_scan"] == _build.LAUNCHES["ssm_scan_bwd"] == 1
    mode = FakeTensorMode()
    fake = [mode.from_tensor(t) for t in ops_]
    _build.reset_launches()
    with mode, FlopCounterMode(display=False) as count:
        fy, fstate = ssm_scan.ssm_scan(*fake)
        fgrads = ssm_scan.ssm_scan_bwd(*fake, fy)
    assert _build.LAUNCHES["ssm_scan"] == _build.LAUNCHES["ssm_scan_bwd"] == 0
    for f, r in zip((fy, fstate, *fgrads), (y, state, *grads)):
        assert f.device.type == "cuda"
        assert (f.shape, f.dtype) == (r.shape, r.dtype)
    u, A = ops_[0], ops_[2]
    assert count.get_total_flops() == (
        ssm_scan.scan_flops(u.shape, A.shape)
        + ssm_scan.scan_flops(u.shape, A.shape, backward=True))
