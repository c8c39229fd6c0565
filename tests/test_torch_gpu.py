"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one:
a CUDA kernel has no CPU mode.  Each kernel is held bit for bit against its
plain PyTorch version (which ``test_torch_kernels.py`` holds against the
JAX package), and a small tree on the card against the same tree on the
CPU.  The file imports no JAX, so it runs on a machine with a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import bitpack, fused_scan, merge_remap, ops

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


@pytest.mark.parametrize("width", [1, 8, 32])
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
    assert all(v > 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
