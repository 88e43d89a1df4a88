"""Configuration: the model config with its architecture registry, and
the protocol and training configs.

Own copy of the reference's ``repro.configs.base`` (``ModelConfig`` with
its sub-configs, ``register``/``get_config``/``list_archs``,
``smoke_variant``, ``EasterConfig``, ``TrainConfig``, ``InputShape`` and
``INPUT_SHAPES``, the dry run's input shapes). The port runs
every family: dense, MoE, SSM (Mamba-2), hybrid (RG-LRU), the
encoder-decoder (whisper) and vision (qwen2-vl) ones.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Tuple


# ---------------------------------------------------------------------------
# model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared_experts: int = 0       # always-on shared experts (qwen2-moe)
    d_expert_ff: int = 0            # per-expert FFN hidden size
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    capacity_factor: float = 1.25   # dispatch-buffer slack


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128              # SSD state size per head
    d_conv: int = 4                 # depthwise conv width
    expand: int = 2                 # d_inner = expand * d_model
    head_dim: int = 64              # SSD head dim (P)
    chunk: int = 256                # SSD chunk length


@dataclass(frozen=True)
class HybridConfig:
    lru_width: int = 0              # RG-LRU recurrence width (0 -> d_model)
    window: int = 2048              # local-attention window
    pattern: Tuple[str, ...] = ("lru", "lru", "attn")  # repeating block types


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "dense"           # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""                # citation of the published config
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu
    norm: str = "rms"               # rms | layer
    # sliding-window layout for dense models: window 0 -> full attention;
    # swa_pattern (l, g): l local layers then g global layers, repeating
    window: int = 0
    swa_pattern: Tuple[int, int] = (0, 1)
    # >0: the explicit sliding-window variant for the long_500k decode shape
    long_ctx_window: int = 0
    # multimodal / enc-dec extras
    n_encoder_layers: int = 0       # encdec only
    n_audio_frames: int = 1500      # whisper stub frontend output length
    n_vision_tokens: int = 0        # vlm stub frontend output length
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # qwen2-vl M-RoPE
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    dtype: str = "bfloat16"         # activation/param dtype
    remat: str = "none"             # none | full | dots (reference's scan remat)
    scan_layers: bool = True        # reference: lax.scan over the layer stack
    kv_quant: bool = False          # int8 KV cache (+ per-slot scales)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + hd * nq * d
        if self.qkv_bias:
            attn += hd * (nq + 2 * nkv)
        if self.family == "moe":
            m = self.moe
            ff_r = 3 * d * m.d_expert_ff * m.n_experts
            ff_s = 3 * d * m.d_expert_ff * m.n_shared_experts
            router = d * m.n_experts
            ff = ff_r + ff_s + router
            block = attn + ff + 2 * d
            body = self.n_layers * block
        elif self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            zxbcdt = d_in * 2 + 2 * s.d_state + nh
            block = d * zxbcdt + s.d_conv * (d_in + 2 * s.d_state) \
                + nh + nh + d_in * d + d
            body = self.n_layers * block
        elif self.family == "hybrid":
            h = self.hybrid
            w = h.lru_width or d
            lru = 2 * d * w + w * d + 3 * w + 2 * w * (w // 4)
            attn_b = attn
            ff = 3 * d * self.d_ff
            pat = h.pattern
            n_lru = sum(1 for p in pat if p == "lru")
            n_att = len(pat) - n_lru
            per_rep = n_lru * (lru + ff + 2 * d) + n_att * (attn_b + ff + 2 * d)
            body = (self.n_layers // len(pat)) * per_rep
            rem = self.n_layers % len(pat)
            for p in pat[:rem]:
                body += (lru if p == "lru" else attn_b) + ff + 2 * d
        else:  # dense / encdec / vlm
            ff = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            block = attn + ff + 2 * d
            body = self.n_layers * block
            if self.family == "encdec":
                body += self.n_encoder_layers * block
                body += self.n_layers * (attn + d)
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return int(emb + body + head + d)

    def active_param_count(self) -> int:
        """MoE: params touched per token (top_k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        ff_all = 3 * self.d_model * m.d_expert_ff * m.n_experts * self.n_layers
        ff_act = 3 * self.d_model * m.d_expert_ff * m.top_k * self.n_layers
        return int(full - ff_all + ff_act)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def _import_archs() -> None:
    import importlib
    from repro_torch import configs
    for mod in configs.ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _import_archs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    _import_archs()
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests: 2 layers
    (or one pattern repeat for hybrids), d_model <= 256, <= 4 experts."""
    d = min(cfg.d_model, 256)
    hd = 64
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        n_layers=2, d_model=d, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=hd, d_ff=min(cfg.d_ff, 512) or 512,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32", remat="none",
    )
    if cfg.family == "moe":
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=2,
                            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
                            d_expert_ff=128)
    if cfg.family == "ssm":
        kw["ssm"] = replace(cfg.ssm, d_state=32, head_dim=32, chunk=32)
    if cfg.family == "hybrid":
        kw["n_layers"] = len(cfg.hybrid.pattern)
        kw["hybrid"] = replace(cfg.hybrid, lru_width=d, window=32)
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = 2
        kw["n_audio_frames"] = 16
    if cfg.family == "vlm":
        kw["n_vision_tokens"] = 8
        kw["mrope_sections"] = (8, 12, 12)
    if cfg.window:
        kw["window"] = min(cfg.window, 32)
    return replace(cfg, **kw)


# ---------------------------------------------------------------------------
# EASTER / training configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EasterConfig:
    """EASTER protocol configuration (paper §IV)."""
    num_passive: int = 3            # K; C = K + 1 (paper uses C = 4)
    d_embed: int = 128              # shared embedding space (paper Fig. 6: 128)
    mask_mode: str = "float"        # float (paper) | int32 | int8 (ring wire)
    fresh_masks: bool = True        # per-round PRF fold-in (beyond-paper)
    decision_layers: int = 2        # PL depth; paper finds EL:PL = 1:1 best
    # passive parties run reduced "proxy" backbones (heterogeneous setting):
    passive_depth_frac: float = 0.25
    passive_width_frac: float = 1.0
    # passive parties of an MoE active use dense FFN proxies (LLM system)
    moe_dense_passive: bool = False
    enabled: bool = True


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"         # sgd | momentum | adagrad | adam
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    param_dtype: str = "float32"
    batch: int = 8
    seq: int = 128
    steps: int = 100
    seed: int = 0


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
