"""Model/config system: one `ModelConfig` covers all 10 assigned archs.

Every architecture file in this package registers an exact full-size config
(the dry-run target) plus a `.smoke()` reduction of the same family for
CPU tests.  Input shapes are the four assigned LM shapes; `input_specs()`
returns `(shape, torch.dtype)` pairs (no device allocation).

The configs are plain data, copied from the JAX package's
`repro.configs` so that this package never imports it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable

import torch

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free (rwkv6)
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    tie_embeddings: bool = False
    mlp: str = "swiglu"            # swiglu | gelu
    pos: str = "rope"              # rope | mrope | none
    rope_theta: float = 10_000.0

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE layer stride (llama4: 2)
    dense_ff_residual: int = 0     # arctic's parallel dense FFN width
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm: str = ""                  # "rwkv6" | "" (attention archs)
    pattern: tuple = ()            # hybrid block pattern, e.g. ("rec","rec","attn")
    lru_width: int = 0             # RG-LRU recurrence width
    conv_width: int = 4
    window: int = 0                # local-attention window (0 = global)

    # --- modality frontend stubs ---
    embed_inputs: bool = True      # False => input_specs feeds embeddings
    mrope_sections: tuple = ()     # qwen2-vl m-rope head_dim split

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    scan_layers: bool = True
    loss_chunk: int = 0            # 0 = unchunked vocab loss
    # attention sharding strategy (see repro.sharding.partition):
    #   heads: TP over query heads (requires num_heads % tp == 0)
    #   seq:   sequence-parallel attention (any head count)
    attn_sharding: str = "heads"

    # which shapes this arch skips (+reason) — e.g. long_500k for O(L^2) archs
    skip_shapes: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        """The working dtype (`dtype`) as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def attention_free(self) -> bool:
        return self.ssm == "rwkv6"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def moe_layer_mask(self) -> list[bool]:
        if not self.is_moe:
            return [False] * self.num_layers
        return [(i % self.moe_every) == self.moe_every - 1
                for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Total parameters (for 6ND roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.ssm == "rwkv6":
            h = self.d_model // self.head_dim
            tmix = 6 * d * d + 4 * d  # r,k,v,g,w,o + decay/bonus vectors
            cmix = 2 * d * f + d * d
            return emb + self.num_layers * (tmix + cmix)
        att = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim \
            + self.num_heads * self.head_dim * d
        mlp_mats = 3 if self.mlp in ("swiglu", "gelu_glu") else 2
        dense_mlp = mlp_mats * d * f
        total = emb
        if self.pattern:  # hybrid: rec blocks replace attention
            n_attn = sum(1 for i in range(self.num_layers)
                         if self.pattern[i % len(self.pattern)] == "attn")
            n_rec = self.num_layers - n_attn
            rec = 3 * d * self.lru_width + self.lru_width * (
                self.conv_width + 4)
            total += n_attn * att + n_rec * rec + self.num_layers * dense_mlp
            return total
        for i, is_moe in enumerate(self.moe_layer_mask()):
            total += att
            if is_moe:
                total += self.num_experts * mlp_mats * d * f
                total += d * self.num_experts  # router
                if self.dense_ff_residual:
                    total += mlp_mats * d * self.dense_ff_residual
            else:
                total += dense_mlp
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: 6*N_active*D rooflines)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        mlp_mats = 3 if self.mlp in ("swiglu", "gelu_glu") else 2
        n_moe = sum(self.moe_layer_mask())
        inactive = n_moe * (self.num_experts - self.top_k) * \
            mlp_mats * self.d_model * self.d_ff
        return full - inactive

    # ------------------------------------------------------------------
    def input_specs(self, shape: str | ShapeSpec) -> dict:
        """`(shape, torch.dtype)` stand-ins for every model input of this
        shape.

        Modality archs ([vlm]/[audio]) feed *precomputed* frontend
        embeddings (the stub mandated by the assignment); LM archs feed
        token ids.  Decode shapes describe ONE decode step: a single new
        token against a full cache (built separately by `cache_specs`).
        """
        s = SHAPES[shape] if isinstance(shape, str) else shape
        b, t = s.global_batch, s.seq_len
        f32, i32 = self.torch_dtype, torch.int32
        specs: dict = {}
        if s.kind in ("train", "prefill"):
            if self.embed_inputs:
                specs["tokens"] = ((b, t), i32)
            else:
                specs["embeds"] = ((b, t, self.d_model), f32)
                specs["labels"] = ((b, t), i32)
            if self.pos == "mrope":
                specs["positions"] = ((b, t, 3), i32)
        else:  # decode: one new token
            if self.embed_inputs:
                specs["tokens"] = ((b, 1), i32)
            else:
                specs["embeds"] = ((b, 1, self.d_model), f32)
            specs["positions"] = ((b,), i32)
        return specs

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        def rd(x, lo):  # reduce but keep divisibility-friendly sizes
            return max(lo, x)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if not self.pattern
                           else len(self.pattern)),
            d_model=64,
            num_heads=(0 if self.attention_free else
                       max(2, min(4, self.num_heads))),
            num_kv_heads=0, d_ff=128, vocab=256, head_dim=16,
            lru_width=64 if self.lru_width else 0,
            window=min(self.window, 32) if self.window else 0,
            num_experts=8 if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # ample capacity: smoke tests must not drop tokens, so the
            # prefill->decode golden check isolates cache correctness
            capacity_factor=8.0 if self.num_experts else self.capacity_factor,
            dense_ff_residual=64 if self.dense_ff_residual else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            dtype="float32", remat="none", loss_chunk=0,
        )
        kw["num_kv_heads"] = (0 if self.attention_free else
                              (kw["num_heads"] if self.num_kv_heads ==
                               self.num_heads else 2))
        if self.ssm == "rwkv6":
            kw["head_dim"] = 16  # 4 heads of 16
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    """Import every arch module so registration side-effects run."""
    import importlib
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


ARCH_MODULES = [
    "granite_3_2b", "qwen1_5_110b", "minitron_4b", "qwen1_5_4b",
    "llama4_maverick_400b_a17b", "arctic_480b", "qwen2_vl_7b",
    "rwkv6_7b", "recurrentgemma_9b", "musicgen_medium",
]

ARCH_IDS = [
    "granite-3-2b", "qwen1.5-110b", "minitron-4b", "qwen1.5-4b",
    "llama4-maverick-400b-a17b", "arctic-480b", "qwen2-vl-7b",
    "rwkv6-7b", "recurrentgemma-9b", "musicgen-medium",
]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honouring documented skips."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            skipped = shape in cfg.skip_shapes
            if skipped and not include_skipped:
                continue
            out.append((arch, shape))
    return out
