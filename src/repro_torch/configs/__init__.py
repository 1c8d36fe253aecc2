"""Architecture configs — the 10 assigned architectures + reduced smoke twins.

A copy of ``repro.configs`` (the JAX package's module imports no JAX, but
the port keeps its own copy and imports nothing of ``repro``). ``ArchConfig``
is consumed here by:
  * ``repro_torch.models``        — the PyTorch model (prefill / decode)
  * ``repro_torch.soc.workloads`` — lowers the arch to a systolic GEMM
    workload (paper role)

``get_config(name)`` returns the exact published config; ``get_config(name,
smoke=True)`` (or ``"<name>@smoke"``) returns the same *family* reduced to
CPU-runnable size (few layers, narrow width, tiny vocab) for smoke tests.

Shapes (assigned): ``train_4k``, ``prefill_32k``, ``decode_32k``, ``long_500k``
— see ``SHAPES`` and ``runnable_cells()`` for the skip matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
    "runnable_cells", "cell_skip_reason",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    # backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention flavor
    attn_kind: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    window: Optional[int] = None    # sliding-window size (local attention)
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25   # MoE expert capacity multiplier
    first_dense_layers: int = 0     # leading dense layers (deepseek style)
    dense_d_ff: int = 0             # ff of those dense layers
    # MLA
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_width: int = 4
    # hybrid (recurrentgemma / griffin): pattern = [r, r, a] repeating
    lru_width: int = 0
    attn_period: int = 3            # attention every `attn_period`-th layer
    # encoder-decoder (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    enc_len: int = 0
    # modality frontend stub: input_specs provides precomputed embeddings
    frontend: Optional[str] = None  # None | audio | vision
    n_patches: int = 0              # vision: patch embeddings per image
    max_pos: int = 0                # learned abs positions (0 = RoPE only)
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # training-time knobs (overridable per shape at launch)
    remat: bool = True
    microbatch: int = 0             # 0 = no gradient accumulation

    @property
    def q_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        for layer in range(L):
            p += self._layer_params(layer)
        if self.is_encdec:
            for _ in range(self.enc_layers):
                p += (4 * d * self.n_heads * self.head_dim) + 3 * d * self.d_ff
        return p

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        d, L = self.d_model, self.n_layers
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        for layer in range(L):
            p += self._layer_params(layer, active_only=True)
        if self.is_encdec:
            for _ in range(self.enc_layers):
                p += (4 * d * self.n_heads * self.head_dim) + 3 * d * self.d_ff
        return p

    def _layer_params(self, layer: int, active_only: bool = False) -> int:
        d = self.d_model
        p = 0
        if self.family == "ssm":
            d_in = self.ssm_heads * self.ssm_head_dim
            conv_dim = d_in + 2 * self.ssm_groups * self.ssm_state
            p += d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads)
            p += conv_dim * self.conv_width + 2 * self.ssm_heads + d_in
            p += d_in * d
            return p
        if self.family == "hybrid" and (layer + 1) % self.attn_period != 0:
            w = self.lru_width
            p += d * 2 * w + w * self.conv_width + 3 * w + w * d  # rg-lru block
        else:  # attention
            if self.attn_kind == "mla":
                qd = self.qk_nope_dim + self.qk_rope_dim
                if self.q_lora:
                    p += d * self.q_lora + self.q_lora * self.n_heads * qd
                else:
                    p += d * self.n_heads * qd
                p += d * (self.kv_lora + self.qk_rope_dim)
                p += self.kv_lora * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
            else:
                p += d * self.n_heads * self.head_dim
                p += 2 * d * self.n_kv_heads * self.head_dim
                p += self.n_heads * self.head_dim * d
        # feed-forward / MoE
        if self.n_experts and layer >= self.first_dense_layers:
            full = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            act = (self.top_k + self.n_shared) * 3 * d * self.moe_d_ff \
                + d * self.n_experts
            shared = self.n_shared * 3 * d * self.moe_d_ff
            p += (act if active_only else full + shared)
        elif self.family not in ("ssm",):
            ff = self.dense_d_ff if (self.n_experts and layer <
                                     self.first_dense_layers) else self.d_ff
            p += 3 * d * ff
        return p


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# ---------------------------------------------------------------- the 10 archs
# [source; verified-tier] comments are from the assignment block.


def _mamba2_370m(smoke: bool) -> ArchConfig:
    # SSD (state-space duality) [arXiv:2405.21060]
    if smoke:
        return ArchConfig("mamba2-370m@smoke", "ssm", n_layers=2, d_model=64,
                          n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=256,
                          attn_kind="none", ssm_state=16, ssm_heads=4,
                          ssm_head_dim=32, ssm_chunk=32, tie_embeddings=True)
    return ArchConfig("mamba2-370m", "ssm", n_layers=48, d_model=1024,
                      n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50280,
                      attn_kind="none", ssm_state=128, ssm_heads=32,
                      ssm_head_dim=64, ssm_chunk=256, tie_embeddings=True)


def _phi35_moe(smoke: bool) -> ArchConfig:
    # 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]
    if smoke:
        return ArchConfig("phi3.5-moe-42b-a6.6b@smoke", "moe", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=128, vocab=256, n_experts=4, top_k=2,
                          moe_d_ff=128, capacity_factor=8.0)
    return ArchConfig("phi3.5-moe-42b-a6.6b", "moe", n_layers=32, d_model=4096,
                      n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400,
                      vocab=32064, n_experts=16, top_k=2, moe_d_ff=6400,
                      rope_theta=1e4)


def _deepseek_v2_lite(smoke: bool) -> ArchConfig:
    # MLA kv_lora=512, 2 shared + 64 routed top-6 [arXiv:2405.04434; hf].
    # (The pool line reads "160 routed" — that is DeepSeek-V2-236B; the
    # -Lite-16B hf config has 64 routed experts. We follow hf for 16B.)
    if smoke:
        return ArchConfig("deepseek-v2-lite-16b@smoke", "moe", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          d_ff=64, vocab=256, attn_kind="mla", n_experts=4,
                          top_k=2, n_shared=1, moe_d_ff=64,
                          first_dense_layers=1, dense_d_ff=128, kv_lora=32,
                          q_lora=0, qk_nope_dim=16, qk_rope_dim=8,
                          v_head_dim=16, capacity_factor=8.0)
    return ArchConfig("deepseek-v2-lite-16b", "moe", n_layers=27, d_model=2048,
                      n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408,
                      vocab=102400, attn_kind="mla", n_experts=64, top_k=6,
                      n_shared=2, moe_d_ff=1408, first_dense_layers=1,
                      dense_d_ff=10944, kv_lora=512, q_lora=0, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128)


def _mistral_nemo(smoke: bool) -> ArchConfig:
    # 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]
    if smoke:
        return ArchConfig("mistral-nemo-12b@smoke", "dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=128, vocab=256)
    return ArchConfig("mistral-nemo-12b", "dense", n_layers=40, d_model=5120,
                      n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
                      vocab=131072, rope_theta=1e6)


def _qwen3_14b(smoke: bool) -> ArchConfig:
    # qk_norm, GQA [hf:Qwen/Qwen3-8B family scaled per assignment]
    if smoke:
        return ArchConfig("qwen3-14b@smoke", "dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab=256, qk_norm=True)
    return ArchConfig("qwen3-14b", "dense", n_layers=40, d_model=5120,
                      n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408,
                      vocab=151936, qk_norm=True, rope_theta=1e6)


def _minicpm3(smoke: bool) -> ArchConfig:
    # MLA [hf:openbmb/MiniCPM3-4B]: kv_lora 256, q_lora 768, nope 64, rope 32
    if smoke:
        return ArchConfig("minicpm3-4b@smoke", "dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                          vocab=256, attn_kind="mla", kv_lora=32, q_lora=48,
                          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return ArchConfig("minicpm3-4b", "dense", n_layers=62, d_model=2560,
                      n_heads=40, n_kv_heads=40, head_dim=64, d_ff=6400,
                      vocab=73448, attn_kind="mla", kv_lora=256, q_lora=768,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)


def _starcoder2(smoke: bool) -> ArchConfig:
    # GQA kv=2, RoPE [arXiv:2402.19173]
    if smoke:
        return ArchConfig("starcoder2-3b@smoke", "dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                          d_ff=256, vocab=256)
    return ArchConfig("starcoder2-3b", "dense", n_layers=30, d_model=3072,
                      n_heads=24, n_kv_heads=2, head_dim=128, d_ff=12288,
                      vocab=49152, rope_theta=1e5)


def _recurrentgemma(smoke: bool) -> ArchConfig:
    # RG-LRU + local attn, 1:2 [arXiv:2402.19427] — pattern (r, r, attn)
    if smoke:
        return ArchConfig("recurrentgemma-9b@smoke", "hybrid", n_layers=3,
                          d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
                          d_ff=128, vocab=256, window=32, lru_width=64,
                          attn_period=3)
    return ArchConfig("recurrentgemma-9b", "hybrid", n_layers=38, d_model=4096,
                      n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
                      vocab=256000, window=2048, lru_width=4096, attn_period=3)


def _whisper_tiny(smoke: bool) -> ArchConfig:
    # enc-dec, conv frontend (stub) [arXiv:2212.04356]
    if smoke:
        return ArchConfig("whisper-tiny@smoke", "audio", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          d_ff=128, vocab=256, is_encdec=True, enc_layers=2,
                          enc_len=64, frontend="audio", max_pos=128)
    return ArchConfig("whisper-tiny", "audio", n_layers=4, d_model=384,
                      n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
                      vocab=51865, is_encdec=True, enc_layers=4, enc_len=1500,
                      frontend="audio", max_pos=32768)


def _pixtral(smoke: bool) -> ArchConfig:
    # pixtral-ViT frontend (stub) + mistral-nemo backbone
    # [hf:mistralai/Pixtral-12B-2409]
    if smoke:
        return ArchConfig("pixtral-12b@smoke", "vlm", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                          vocab=256, frontend="vision", n_patches=16)
    return ArchConfig("pixtral-12b", "vlm", n_layers=40, d_model=5120,
                      n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
                      vocab=131072, rope_theta=1e6, frontend="vision",
                      n_patches=1024)


_FACTORIES = {
    "mamba2-370m": _mamba2_370m,
    "phi3.5-moe-42b-a6.6b": _phi35_moe,
    "deepseek-v2-lite-16b": _deepseek_v2_lite,
    "mistral-nemo-12b": _mistral_nemo,
    "qwen3-14b": _qwen3_14b,
    "minicpm3-4b": _minicpm3,
    "starcoder2-3b": _starcoder2,
    "recurrentgemma-9b": _recurrentgemma,
    "whisper-tiny": _whisper_tiny,
    "pixtral-12b": _pixtral,
}

ARCH_IDS = tuple(_FACTORIES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name.endswith("@smoke"):
        name, smoke = name[: -len("@smoke")], True
    if name not in _FACTORIES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _FACTORIES[name](smoke)


# ------------------------------------------------------------- skip matrix
# long_500k needs sub-quadratic attention / bounded per-token state. We run
# it for the SSM and hybrid archs (recurrent state + bounded local window)
# and — as bonus cells — for the two MLA archs, whose per-token cache is the
# compressed latent (deepseek 512+64 B/tok·layer, minicpm3 256+32): decode
# cost is linear in cache length and the cache shards over the mesh. The six
# pure full-attention archs skip it (see DESIGN.md §Arch-applicability).
_LONG_OK = {"mamba2-370m", "recurrentgemma-9b",
            "deepseek-v2-lite-16b", "minicpm3-4b"}


def cell_skip_reason(arch_id: str, shape: str) -> Optional[str]:
    base = arch_id.split("@")[0]
    if shape == "long_500k" and base not in _LONG_OK:
        return ("pure full-attention family: 500k-token decode is "
                "KV-cache-degenerate; skipped per assignment rule")
    return None


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells that run (the skip matrix applied)."""
    cells = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if cell_skip_reason(a, s) is None:
                cells.append((a, s))
    return cells
