"""The port's own copy of the architecture configs, held field for field
against the JAX package's: the ten registered configs, their ``reduced()``
forms, the shape suite, and the reference's applicability and
parameter-count tests run on the port's configs."""

import dataclasses

import pytest

from repro.configs import base as ref_base
from repro_torch.configs import base

ARCHS = sorted(ref_base.all_archs())


def test_the_same_ten_architectures_register():
    assert sorted(base.all_archs()) == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    got, want = base.get_config(arch), ref_base.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())
    for cfg, ref in ((got, want), (got.reduced(), want.reduced())):
        assert cfg.param_count() == ref.param_count()
        assert (cfg.head_dim, cfg.padded_vocab, cfg.d_inner, cfg.dt_rank,
                cfg.has_attn, cfg.has_mlp, cfg.has_ssm) == \
            (ref.head_dim, ref.padded_vocab, ref.d_inner, ref.dt_rank,
             ref.has_attn, ref.has_mlp, ref.has_ssm)


def test_shapes_and_reduced_shapes_equal_reference():
    assert sorted(base.SHAPES) == sorted(ref_base.SHAPES)
    for name, shape in base.SHAPES.items():
        ref = ref_base.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref)
        assert dataclasses.asdict(base.reduced_shape(shape)) == \
            dataclasses.asdict(ref_base.reduced_shape(ref))
        for arch in ARCHS:
            assert base.applicability(base.get_config(arch), shape) == \
                ref_base.applicability(ref_base.get_config(arch), ref)


def test_unknown_arch_raises_with_the_options():
    with pytest.raises(KeyError, match="llama3-8b"):
        base.get_config("llama4")


def test_applicability_matrix():
    """long_500k runs only for ssm/hybrid; everything else runs all (the
    body of tests/test_models_smoke.py's, on the port's configs)."""
    runs = {}
    for name, cfg in base.all_archs().items():
        for sname, shape in base.SHAPES.items():
            ok, reason = base.applicability(cfg, shape)
            runs[(name, sname)] = ok
            if sname != "long_500k":
                assert ok
    assert runs[("falcon-mamba-7b", "long_500k")]
    assert runs[("hymba-1.5b", "long_500k")]
    assert not runs[("llama3-405b", "long_500k")]
    assert not runs[("whisper-small", "long_500k")]
    assert sum(runs.values()) == 32  # 40 cells - 8 documented skips


def test_param_counts_match_public_sizes():
    """Computed parameter totals are near the advertised sizes (the body of
    tests/test_models_smoke.py's, on the port's configs)."""
    expect = {
        "llama3-8b": 8.0e9, "llama3-405b": 405e9, "glm4-9b": 9.4e9,
        "deepseek-coder-33b": 33e9, "chameleon-34b": 34e9,
        "falcon-mamba-7b": 7.3e9, "hymba-1.5b": 1.5e9,
        "phi3.5-moe-42b-a6.6b": 42e9, "granite-moe-1b-a400m": 1.3e9,
        "whisper-small": 0.24e9,
    }
    for name, target in expect.items():
        n_total, n_active = base.all_archs()[name].param_count()
        assert 0.6 < n_total / target < 1.45, (name, n_total, target)
    for name in ("phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m"):
        n_total, n_active = base.all_archs()[name].param_count()
        assert n_active < 0.5 * n_total


def test_llama3_8b_counts_8_03e9_parameters():
    """The served configuration's size, as the card's phase states it."""
    n_total, _ = base.get_config("llama3-8b").param_count()
    assert n_total == 8_029_995_008
