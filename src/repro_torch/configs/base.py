"""Architecture + shape configuration system.

One ``ArchConfig`` per assigned architecture (see configs/<id>.py, exact
numbers from the public sources cited there), plus the four assigned
input-shape suites.  ``reduced()`` derives the tiny CPU smoke-test
variant of any config (same family/topology, small dims).

The port's own copy of ``repro/configs/base.py``, field for field: configs
are plain Python, and the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                      # 0 for pure-ssm blocks
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    attn_window: int = 0           # 0 = full attention; >0 = sliding window
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128  # pad embedding rows for even TP sharding
    dtype: str = "bfloat16"
    remat: bool = True
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def dt_rank(self) -> int:
        if not self.ssm:
            return 0
        return self.ssm.dt_rank or math.ceil(self.d_model / 16)

    @property
    def has_attn(self) -> bool:
        return self.n_heads > 0

    @property
    def has_mlp(self) -> bool:
        return self.d_ff > 0 and self.moe is None

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    # ------------------------------------------------------------------ #
    def param_count(self) -> Tuple[int, int]:
        """(N_total, N_active) — used for MODEL_FLOPS = 6*N*D."""
        D, F, dh = self.d_model, self.d_ff, self.head_dim
        per_layer = 0
        per_layer_active = 0
        if self.has_attn:
            attn = D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh \
                + self.n_heads * dh * D
            per_layer += attn
            per_layer_active += attn
        if self.moe:
            expert = 3 * D * F
            per_layer += self.moe.n_experts * expert + D * self.moe.n_experts
            per_layer_active += self.moe.top_k * expert + D * self.moe.n_experts
        elif F > 0:
            per_layer += 3 * D * F
            per_layer_active += 3 * D * F
        if self.has_ssm:
            di, N, dtr = self.d_inner, self.ssm.d_state, self.dt_rank
            ssm = (D * 2 * di + di * self.ssm.d_conv + di * (dtr + 2 * N)
                   + dtr * di + di * N + di + di * D)
            per_layer += ssm
            per_layer_active += ssm
        n_layers_total = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        if self.enc_dec:  # decoder layers add cross-attention
            xattn = 2 * (D * self.n_heads * dh + self.n_heads * dh * D)
            total = (self.n_enc_layers + self.n_layers) * per_layer + self.n_layers * xattn
            active = total
        else:
            total = self.n_layers * per_layer
            active = self.n_layers * per_layer_active
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        return total + emb, active + emb

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            n_enc_layers=2 if self.enc_dec else 0,
            d_model=64,
            n_heads=4 if self.has_attn else 0,
            n_kv_heads=2 if self.has_attn else 0,
            d_head=16 if self.has_attn else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            vocab_pad_multiple=32,
            moe=MoECfg(4, min(2, self.moe.top_k), capacity_factor=4.0)
            if self.moe else None,
            ssm=SSMCfg(d_state=8, d_conv=4, expand=2, dt_rank=8) if self.ssm else None,
            attn_window=32 if self.attn_window else 0,
            dtype="float32",
        )


# --------------------------------------------------------------------------- #
# shapes (assigned suite)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def applicability(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, (
            "long_500k needs sub-quadratic attention; "
            f"{cfg.name} is pure full-attention ({cfg.family})"
        )
    return True, ""


def reduced_shape(shape: ShapeCfg) -> ShapeCfg:
    return ShapeCfg(shape.name + "-reduced", min(shape.seq_len, 64),
                    min(shape.global_batch, 2), shape.kind)


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_REGISTRY)}")


def all_archs() -> Dict[str, ArchConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b, deepseek_coder_33b, falcon_mamba_7b, glm4_9b,
        granite_moe_1b, hymba_1_5b, llama3_8b, llama3_405b, phi35_moe,
        whisper_small,
    )
