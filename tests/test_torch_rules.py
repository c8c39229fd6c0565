"""The port's rules, enforced.

* ``src/repro_torch`` and ``chip_smoke.py`` never import ``jax`` or
  ``repro`` (the JAX engine reaches its Pallas kernels through deferred
  imports, so a port importing ``repro.core`` would silently run them).
* Entry points run on the card by default and raise without one; they do
  not carry on on the CPU.
* A kernel wrapper handed tensors on the card launches its kernel or
  raises: it never falls back to its plain version.
* Configuration values the reference does not take (the retired
  ``compaction_backend='packed'``, ``filter_backend='pallas'``, an unknown
  compaction policy, a level-mode vector with a letter other than 'L' and
  'T') raise ``ValueError`` naming the accepted ones or, for the policy
  fields, with the reference's message; the compaction backends ``'numpy'`` and
  ``'jax'`` build the same tree as ``'jax_packed'``, and the filter
  backends ``'jax_packed'``, ``'jax'`` and ``'numpy'`` build the same tree
  as ``'fused'``.
* ``chip_smoke.py`` gives no result without a card or outside the repo.
* ``src/repro_torch`` never imports ``torch.testing`` (the fake process
  group is the tests'); the mesh builders default to the card.
* No CUDA launcher keeps a per-process cache of a fact of the card: the
  resident-block counts and the raised shared-memory limits are looked up
  per card through ``csrc/launch_grid.cuh``.
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
    "repro_torch.shard, repro_torch.shard.router, "
    "repro_torch.shard.rebalance, repro_torch.shard.sharded_lsm",
    "repro_torch.replica, repro_torch.replica.link, "
    "repro_torch.replica.replicated",
    "repro_torch.configs, repro_torch.configs.base, "
    "repro_torch.configs.llama3_8b, repro_torch.configs.whisper_small",
    "repro_torch.models, repro_torch.models.flags, repro_torch.models.layers, "
    "repro_torch.models.attention, repro_torch.models.transformer, "
    "repro_torch.models.registry, repro_torch.models.weights",
    "repro_torch.serving.engine, repro_torch.serving.prefix_cache, "
    "repro_torch.pipeline, repro_torch.pipeline.tokenstore",
    "repro_torch.models.moe, repro_torch.models.ssm",
    "repro_torch.models.encdec, repro_torch.launch, repro_torch.launch.serve",
    "repro_torch.train, repro_torch.train.tree, repro_torch.train.optimizer, "
    "repro_torch.train.train_step, repro_torch.train.loop",
    "repro_torch.checkpoint, repro_torch.checkpoint.ckpt, "
    "repro_torch.runtime, repro_torch.runtime.fault, "
    "repro_torch.launch.train",
    "repro_torch.parallel, repro_torch.parallel.sharding, "
    "repro_torch.runtime.elastic, repro_torch.launch.mesh",
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


def _consumers_and_model(tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    from repro_torch.pipeline import TokenStore
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.prefix_cache import PrefixCacheIndex
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_state

    cfg = get_config("llama3-8b").reduced()
    whisper = get_config("whisper-small").reduced()
    ckpt.save(str(tmp_path / "ck"), 1, {"w": torch.ones(2)})
    return {
        "TokenStore": lambda device=None: TokenStore(device=device),
        "PrefixCacheIndex": lambda device=None: PrefixCacheIndex(device=device),
        "build_model(cfg).init": lambda device=None: build_model(cfg).init(
            0, device=device),
        "ServingEngine": lambda device=None: ServingEngine(
            cfg, build_model(cfg).init(0, device="cpu"), device=device),
        "build_model(whisper).init": lambda device=None: build_model(
            whisper).init(0, device=device),
        "ServingEngine(whisper)": lambda device=None: ServingEngine(
            whisper, build_model(whisper).init(0, device="cpu"),
            device=device),
        "launch.serve.main": lambda device=None: serve.main(
            ["--arch", "whisper-small", "--reduced", "--requests", "1",
             "--new-tokens", "1"] + (["--device", device] if device else [])),
        "make_train_state": lambda device=None: make_train_state(
            build_model(cfg), AdamWConfig(), 0, device=device),
        "ckpt.restore": lambda device=None: ckpt.restore(
            str(tmp_path / "ck"), {"w": torch.zeros(2)}, device=device),
        "launch.train.main": lambda device=None: train.main(
            ["--arch", "llama3-8b", "--reduced", "--steps", "1",
             "--ckpt", str(tmp_path / f"train_{device}")]
            + (["--device", device] if device else [])),
    }


@pytest.mark.parametrize("entry", ["TokenStore", "PrefixCacheIndex",
                                   "build_model(cfg).init", "ServingEngine",
                                   "build_model(whisper).init",
                                   "ServingEngine(whisper)",
                                   "launch.serve.main", "make_train_state",
                                   "ckpt.restore", "launch.train.main"])
def test_model_and_consumer_entry_points_need_the_card(monkeypatch, tmp_path,
                                                       entry):
    """The consumers, the models' init, the serving engine, the serving
    launcher, the train state, a checkpoint restore and the training
    launcher run on the card by default and raise without one;
    ``device='cpu'`` runs them on the CPU."""
    make = _consumers_and_model(tmp_path)[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device)
    assert make("cpu") is not None


OTHER_VALUES = {"codec": "lz4", "filter_backend": "pallas",
                "compaction_backend": "packed", "compaction_policy": "nope",
                "policy_autotune": "yes", "maintenance": "eager",
                "wal_sync": "sometimes", "blob_compress": "zstd",
                "level_modes": ("L", "X")}


@pytest.mark.parametrize("field", sorted(SUPPORTED))
def test_unsupported_config_value_raises(field):
    """A value outside an enumerated field's accepted ones names them;
    ``level_modes`` is checked by ``make_policy`` with the reference's
    message."""
    accepted = SUPPORTED[field]
    want = "bad level_modes" if accepted is None else \
        " or ".join(repr(v) for v in accepted)
    with pytest.raises(ValueError, match=re.escape(want)):
        T.LSMConfig(**{field: OTHER_VALUES[field]})


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
                      (ssm_scan, "ssm_scan_plain"),
                      (ssm_scan, "ssm_scan_bwd_plain")):
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
        lambda: ssm_scan.ssm_scan_bwd(f32, f32, torch.zeros((128, 16)),
                                      torch.zeros((1, 32, 16)),
                                      torch.zeros((1, 32, 16)), f32),
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



def test_port_sources_never_import_torch_testing():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m == "torch.testing" or m.startswith("torch.testing.")]
    assert not bad, bad


def test_mesh_builders_default_to_the_card():
    import inspect

    from repro_torch.launch import mesh
    from repro_torch.parallel import sharding
    from repro_torch.runtime import elastic
    for fn in (sharding.compat_make_mesh, elastic.make_elastic_mesh,
               mesh.make_production_mesh, mesh.make_host_mesh):
        param = inspect.signature(fn).parameters["device_type"]
        assert param.default == "cuda", fn.__name__


CSRC = PORT / "kernels" / "csrc"
HELPERS = "launch_grid.cuh"


def _code(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_per_card_facts_are_looked_up_per_card():
    """Outside ``launch_grid.cuh`` no launcher declares ``static`` storage
    (only ``static_cast``, ``static_assert`` and ``static constexpr``
    constants), sets a function attribute or asks for occupancy itself;
    a resident-block count comes from ``repro::resident_blocks`` (the
    current card, every call) or ``repro::card_resident_blocks`` (once a
    card), and a shared-memory limit from ``repro::raise_smem_once``."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert (CSRC / HELPERS) in sources and len(sources) > 10
    bad = []
    for path in sources:
        if path.name == HELPERS:
            continue
        code = _code(path)
        for m in re.finditer(r"\bstatic\b(?!_)(?!\s+constexpr\b)", code):
            bad.append((path.name, code[m.start():m.start() + 60]))
        for name in ("cudaFuncSetAttribute", "cudaOccupancy"):
            if name in code:
                bad.append((path.name, name))
        for m in re.finditer(r"(\w+::)?\bresident_blocks\b", code):
            if m.group(1) != "repro::":
                bad.append((path.name, m.group(0)))
    assert not bad, bad
    helpers = _code(CSRC / HELPERS)
    for name in ("PerCard", "card_resident_blocks", "raise_smem_once",
                 "std::call_once", "cudaErrorInvalidDevice", "kMaxCards"):
        assert name in helpers, name
    # the four launchers sized once per card, and the two smem raises
    uses = {p.name: _code(p) for p in sources}
    for name in ("bitpack.cu", "merge_remap.cu"):
        assert "card_resident_blocks<" in uses[name], name
    for name in ("ssm_scan.cu", "ssm_scan_bwd.cu"):
        assert "raise_smem_once<" in uses[name], name
