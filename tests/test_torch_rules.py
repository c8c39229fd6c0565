"""The port's rules, enforced.

* ``src/repro_torch`` and ``chip_smoke.py`` never import ``jax`` or
  ``repro`` (the JAX engine reaches its Pallas kernels through deferred
  imports, so a port importing ``repro.core`` would silently run them).
* Entry points run on the card by default and raise without one; they do
  not carry on on the CPU.
* A kernel wrapper handed tensors on the card launches its kernel or
  raises: it never falls back to its plain version.
* Configuration values outside the ported slice (``codec='blob'`` among
  them; 'plain' and 'heavy' are ported) raise ``ValueError`` naming their
  ROADMAP item, and values the reference does not take (the
  retired ``compaction_backend='packed'``, ``filter_backend='pallas'``)
  raise naming the accepted ones; the compaction backends ``'numpy'`` and
  ``'jax'`` build the same tree as ``'jax_packed'``, and the filter
  backends ``'jax_packed'``, ``'jax'`` and ``'numpy'`` build the same tree
  as ``'fused'``.
* ``chip_smoke.py`` gives no result without a card or outside the repo.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.lsm import SUPPORTED
from repro_torch.kernels import (_build, agg_scan, bitpack, bloom_probe,
                                 fused_scan, merge_remap, multi_filter,
                                 opd_filter, ops, packed_filter, ssm_scan)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("modules", [
    "repro_torch, repro_torch.core, repro_torch.kernels.ops, repro_torch.query",
    "repro_torch.serving.scan_server",
    "repro_torch.core.iterator",
    "repro_torch.kernels.packed_filter, repro_torch.kernels.bloom_probe, "
    "repro_torch.kernels.ssm_scan",
    "repro_torch.core.wal, repro_torch.storage, repro_torch.testing, "
    "repro_torch.testing.crash_driver, repro_torch.testing.workload",
])
def test_importing_the_port_loads_neither_jax_nor_repro(modules):
    code = (f"import sys, {modules}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_is_the_card_and_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.LSMTree(T.LSMConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.LSMTree(T.LSMConfig(), device="cuda")
    assert T.LSMTree(T.LSMConfig(), device="cpu").device.type == "cpu"


OTHER_VALUES = {"codec": "lz4", "filter_backend": "pallas",
                "compaction_backend": "packed", "compaction_policy": "tiered",
                "policy_autotune": True, "maintenance": "eager",
                "wal_sync": "sometimes", "blob_compress": "zstd",
                "level_modes": ("L", "T")}


@pytest.mark.parametrize("field", sorted(SUPPORTED))
def test_unsupported_config_value_raises(field):
    """An unported value names its ROADMAP item; where the port takes every
    value of the reference, a value outside them names the accepted ones."""
    accepted, item = SUPPORTED[field]
    want = "ROADMAP" if item is not None else \
        " or ".join(repr(v) for v in accepted)
    with pytest.raises(ValueError, match=re.escape(want)):
        T.LSMConfig(**{field: OTHER_VALUES[field]})


@pytest.mark.parametrize("value,item", [
    (("compaction_policy", "tiered"), "policy"),
])
def test_rejected_backend_names_its_kernel(value, item):
    """A value that is not ported yet names its ROADMAP item."""
    with pytest.raises(ValueError, match=item):
        T.LSMConfig(**dict([value]))


@pytest.mark.parametrize("codec", ["plain", "heavy"])
def test_ported_competitor_codec_is_accepted(codec):
    """'plain' and 'heavy' are ported; the tree they configure writes SCTs
    of that codec."""
    tree = T.LSMTree(T.LSMConfig(codec=codec, value_width=16), device="cpu")
    tree.put(1, b"v")
    tree.flush()
    assert [s.codec for s in tree.all_runs()] == [codec]
    assert tree.get(1) == b"v"


@pytest.mark.parametrize("backend", ["jax_packed", "jax", "numpy"])
def test_ported_filter_backend_builds_the_fused_tree(backend):
    """The filter backend touches only reads: a tree configured with
    another ported backend writes the same SCTs as under 'fused' and
    answers the same filter."""
    kw = dict(value_width=16, file_bytes=8 * 1024, l0_limit=2, size_ratio=3)
    trees = [T.LSMTree(T.LSMConfig(filter_backend=name, **kw), device="cpu")
             for name in (backend, "fused")]
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 3000, 4000).astype(np.uint64)
    vals = np.asarray([b"v_%04d" % v for v in rng.integers(0, 500, 4000)],
                      "S16")
    for t in trees:
        t.put_batch(keys, vals)
        t.delete(int(keys[0]))
    a, b = trees
    assert a.cfg.filter_backend == backend
    assert a.n_compactions == b.n_compactions > 0
    assert [[s.file_id for s in lvl] for lvl in a.levels] == \
        [[s.file_id for s in lvl] for lvl in b.levels]
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            assert torch.equal(x.packed, y.packed)
            assert np.array_equal(x.keys, y.keys)
    p = T.Predicate("range", b"v_0100", b"v_0300")
    ra, rb = a.filter(p), b.filter(p)
    assert ra.keys.shape[0] > 0
    assert np.array_equal(ra.keys, rb.keys) and \
        np.array_equal(ra.values, rb.values)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_jax_packed_compaction_builds_the_same_tree_as_packed(backend):
    """The compaction backends 'numpy' and 'jax' write the same trees as
    'jax_packed' (the reference's contract for its three backends)."""
    trees = [T.LSMTree(T.LSMConfig(value_width=16, file_bytes=8 * 1024,
                                   l0_limit=2, size_ratio=3,
                                   compaction_backend=name), device="cpu")
             for name in ("jax_packed", backend)]
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 3000, 4000).astype(np.uint64)
    vals = np.asarray([b"v_%04d" % v for v in rng.integers(0, 500, 4000)],
                      "S16")
    for t in trees:
        t.put_batch(keys, vals)
        t.compact()
    a, b = trees
    assert a.n_compactions == b.n_compactions > 0
    assert [[s.file_id for s in lvl] for lvl in a.levels] == \
        [[s.file_id for s in lvl] for lvl in b.levels]
    for la, lb in zip(a.levels, b.levels):
        for x, y in zip(la, lb):
            assert torch.equal(x.packed, y.packed)
            assert np.array_equal(x.keys, y.keys)
            assert np.array_equal(x.opd.values, y.opd.values)


def test_spill_dir_raises(tmp_path):
    """A WAL needs a spill directory to live in: without one the tree
    raises, as the reference's does; with one it logs."""
    with pytest.raises(ValueError, match="spill_dir"):
        T.LSMTree(T.LSMConfig(wal_sync="group"), device="cpu")
    tree = T.LSMTree(T.LSMConfig(wal_sync="group"), spill_dir=str(tmp_path),
                     device="cpu")
    assert tree.wal is not None


@pytest.mark.parametrize("wal", ["off", "group", "every"])
def test_wal_sync_modes_are_accepted(tmp_path, wal):
    """Every ``wal_sync`` of the reference is ported: a tree with a spill
    directory logs under 'group' and 'every' and restores its writes."""
    cfg = T.LSMConfig(value_width=16, wal_sync=wal)
    with T.LSMTree(cfg, spill_dir=str(tmp_path), device="cpu") as tree:
        tree.put(1, b"v")
        assert (tree.wal is None) == (wal == "off")
    back = T.LSMTree.restore(cfg, str(tmp_path), device="cpu")
    assert back.get(1) == (None if wal == "off" else b"v")


def _no_plain(*_a, **_k):
    raise AssertionError("a request for the card fell back to the plain version")


@pytest.fixture
def pretend_card(monkeypatch):
    """Every operand counts as lying on the card, the plain versions are
    booby-trapped, and the kernel library cannot be found or built."""
    monkeypatch.setattr(_build, "on_card", lambda *t: True)
    for mod, name in ((bitpack, "pack_codes_plain"),
                      (bitpack, "unpack_codes_plain"),
                      (fused_scan, "fused_zone_filter_plain"),
                      (merge_remap, "remap_pack_codes_plain"),
                      (merge_remap, "remap_codes_plain"),
                      (agg_scan, "fused_zone_agg_plain"),
                      (agg_scan, "zone_histogram_plain"),
                      (multi_filter, "multi_range_filter_plain"),
                      (opd_filter, "code_range_filter_plain"),
                      (packed_filter, "packed_range_filter_plain"),
                      (bloom_probe, "bloom_probe_plain"),
                      (ssm_scan, "ssm_scan_plain")):
        monkeypatch.setattr(mod, name, _no_plain)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "check_operand", lambda *a, **k: None)


def test_card_requests_raise_instead_of_falling_back(pretend_card, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    i32 = torch.zeros(64, dtype=torch.int32)
    f32 = torch.zeros((1, 32, 128))
    calls = [
        lambda: ops.pack_codes(i32, 8),
        lambda: ops.unpack_codes(i32, 8, 64),
        lambda: ops.remap_pack_codes(i32, i32, i32, i32[:1], 8),
        lambda: ops.remap_codes(i32, i32, i32, i32[:1]),
        lambda: fused_scan.fused_zone_filter(
            torch.zeros(1024, dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), 8, 1),
        lambda: agg_scan.fused_zone_agg(
            torch.zeros(1024, dtype=torch.int32), torch.zeros((1, 6), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), i32, 8, 1, True),
        lambda: agg_scan.zone_histogram(
            torch.zeros(1024, dtype=torch.int32), torch.zeros((1, 6), dtype=torch.int32),
            torch.zeros((1, 5), dtype=torch.int32), 8, 4),
        lambda: ops.multi_range_filter_packed(i32, 8, [(0, 3), (1, 0)]),
        lambda: ops.range_filter_codes(i32, 0, 3),
        lambda: ops.range_filter_packed(i32, 8, 0, 3),
        lambda: ops.bloom_probe(i32, 2048, i32),
        lambda: ops.ssm_scan(f32, f32, torch.zeros((128, 16)),
                             torch.zeros((1, 32, 16)), torch.zeros((1, 32, 16))),
    ]
    before = dict(ops.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert ops.LAUNCHES == before


def test_cpu_tensor_on_card_path_is_rejected(monkeypatch):
    """The operand check refuses a CPU tensor before any pointer reaches C."""
    monkeypatch.setattr(_build, "on_card", lambda *t: True)
    with pytest.raises(ValueError, match="card"):
        ops.pack_codes(torch.zeros(8, dtype=torch.int32), 8)


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        _build.on_card(torch.zeros(1), torch.zeros(1, device="meta"))


def test_chip_smoke_gives_no_result_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the repository, it fails as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
