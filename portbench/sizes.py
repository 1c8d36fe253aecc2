"""The sizes of a configuration, read from its file under ``configs/``, and
the yardstick's arithmetic on them: the leaves of the model (names, shapes,
fan-in), parameter counts, and the operations and bytes that the FLOP, MFU
and roofline readers divide by. Nothing here imports the program.

A configuration file holds the published config's keys (Hugging Face
names) as the configuration is run; ``Sizes.from_config`` maps them onto the
few sizes the reference and the counts need.
"""
from __future__ import annotations

import dataclasses

#: published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
#: sheet, dense rates): the bf16 tensor-core rate and the HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Sizes:
    name: str
    attn: str                 # "gqa" | "mla"
    n_layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int             # GQA head size (q, k, v)
    vocab: int
    ff: int                   # the dense MLP's width (a MoE model's dense layers)
    rope_theta: float
    eps: float
    # MLA
    kv_lora: int = 0
    q_lora: int = 0
    nope: int = 0
    rope_dim: int = 0
    v_dim: int = 0
    # MoE
    experts: int = 0
    top_k: int = 0
    shared: int = 0
    moe_ff: int = 0
    first_dense: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    aux_coef: float = 0.01

    @classmethod
    def from_config(cls, name: str, c: dict) -> "Sizes":
        if c.get("rope_scaling") and c.get("rope_scaling_applied") is not False:
            raise ValueError(f"{name}: neither the program nor the reference applies "
                             "rope_scaling; a file that keeps the published group has "
                             "to say so with rope_scaling_applied false")
        mla = "kv_lora_rank" in c
        moe = bool(c.get("n_routed_experts"))
        kw = dict(name=name, attn="mla" if mla else "gqa",
                  n_layers=c["num_hidden_layers"], d=c["hidden_size"],
                  heads=c["num_attention_heads"],
                  kv_heads=c["num_key_value_heads"],
                  head_dim=c.get("head_dim") or 0, vocab=c["vocab_size"],
                  ff=c["intermediate_size"], rope_theta=float(c["rope_theta"]),
                  eps=float(c["rms_norm_eps"]))
        if mla:
            kw.update(kv_lora=c["kv_lora_rank"], q_lora=c.get("q_lora_rank") or 0,
                      nope=c["qk_nope_head_dim"], rope_dim=c["qk_rope_head_dim"],
                      v_dim=c["v_head_dim"])
        if moe:
            kw.update(experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      shared=c.get("n_shared_experts") or 0,
                      moe_ff=c["moe_intermediate_size"],
                      first_dense=c.get("first_k_dense_replace", 0),
                      capacity_factor=float(c["capacity_factor"]),
                      norm_topk=bool(c["norm_topk_prob"]),
                      aux_coef=float(c["aux_loss_coef"]))
        return cls(**kw)

    # ------------------------------------------------------------ shapes
    @property
    def dqk(self) -> int:
        return self.nope + self.rope_dim if self.attn == "mla" else self.head_dim

    @property
    def dv(self) -> int:
        return self.v_dim if self.attn == "mla" else self.head_dim

    @property
    def attn_kv_heads(self) -> int:
        """Key/value heads as attention sees them (MLA expands its latent
        to every head)."""
        return self.heads if self.attn == "mla" else self.kv_heads

    def is_moe_layer(self, layer: int) -> bool:
        return bool(self.experts) and layer >= self.first_dense

    def leaves(self) -> dict[str, tuple[tuple[int, ...], object]]:
        """``{name: (shape, fan_in)}`` of every weight, in the program's
        naming (``embed``, ``layers.3.attn.wq``, ...). ``fan_in`` is the
        contracted size (the draw is normal with std 1/sqrt(fan_in)),
        ``"norm"`` for a norm scale (ones) and ``"embed"`` for the table
        (std 1/sqrt(d))."""
        d, H, V = self.d, self.heads, self.vocab
        out = {"embed": ((V, d), "embed"), "head": ((d, V), d),
               "final_ln": ((d,), "norm")}
        for i in range(self.n_layers):
            p = f"layers.{i}."
            out[p + "ln1"] = ((d,), "norm")
            out[p + "ln2"] = ((d,), "norm")
            if self.attn == "mla":
                qd = self.nope + self.rope_dim
                if self.q_lora:
                    out[p + "attn.wq_a"] = ((d, self.q_lora), d)
                    out[p + "attn.wq_b"] = ((self.q_lora, H, qd), self.q_lora)
                else:
                    out[p + "attn.wq"] = ((d, H, qd), d)
                out[p + "attn.wkv_a"] = ((d, self.kv_lora + self.rope_dim), d)
                out[p + "attn.wkv_b"] = ((self.kv_lora, H, self.nope + self.v_dim),
                                         self.kv_lora)
                out[p + "attn.wo"] = ((H, self.v_dim, d), H * self.v_dim)
                out[p + "attn.kv_norm"] = ((self.kv_lora,), "norm")
            else:
                K, hd = self.kv_heads, self.head_dim
                out[p + "attn.wq"] = ((d, H, hd), d)
                out[p + "attn.wk"] = ((d, K, hd), d)
                out[p + "attn.wv"] = ((d, K, hd), d)
                out[p + "attn.wo"] = ((H, hd, d), H * hd)
            if self.is_moe_layer(i):
                E, f = self.experts, self.moe_ff
                out[p + "moe.router"] = ((d, E), d)
                out[p + "moe.wg"] = ((E, d, f), d)
                out[p + "moe.wu"] = ((E, d, f), d)
                out[p + "moe.wd"] = ((E, f, d), f)
                if self.shared:
                    s = self.shared * f
                    out[p + "moe.shared.wg"] = ((d, s), d)
                    out[p + "moe.shared.wu"] = ((d, s), d)
                    out[p + "moe.shared.wd"] = ((s, d), s)
            else:
                out[p + "mlp.wg"] = ((d, self.ff), d)
                out[p + "mlp.wu"] = ((d, self.ff), d)
                out[p + "mlp.wd"] = ((self.ff, d), self.ff)
        return out

    # ------------------------------------------------------------ counts
    def attn_params(self) -> int:
        d, H = self.d, self.heads
        if self.attn == "mla":
            qd = self.nope + self.rope_dim
            q = d * self.q_lora + self.q_lora * H * qd if self.q_lora else d * H * qd
            return (q + d * (self.kv_lora + self.rope_dim)
                    + self.kv_lora * H * (self.nope + self.v_dim) + H * self.v_dim * d)
        return d * H * self.head_dim * 2 + 2 * d * self.kv_heads * self.head_dim

    def layer_params(self, layer: int, active: bool) -> int:
        """One layer's matrix parameters; ``active``: those one token
        multiplies by (a MoE layer's routed top-k and shared experts and its
        router, not all experts)."""
        d = self.d
        p = self.attn_params()
        if self.is_moe_layer(layer):
            n = (self.top_k if active else self.experts) + self.shared
            p += n * 3 * d * self.moe_ff + d * self.experts
        else:
            p += 3 * d * self.ff
        return p

    def trunk_params(self, active: bool = True) -> int:
        return sum(self.layer_params(i, active) for i in range(self.n_layers))

    def head_params(self) -> int:
        return self.d * self.vocab


def k5_pairs(S: int, window=None, causal: bool = True) -> int:
    """(query, key) pairs the attention mask leaves a (batch, head): key j
    of query i when j <= i and, with a window W, j > i - W."""
    if not causal:
        return S * S
    W = min(window or S, S)
    return W * (W + 1) // 2 + (S - W) * W


def k5_bytes_ops(B, S, H, K, dqk, dv, window=None, causal: bool = True,
                 elem_bytes: int = 2) -> tuple[int, int]:
    """Bytes the attention kernel must move (q, k, v read and o written
    once) and its operations 2·B·H·pairs·(dqk + dv) (QKᵀ and PV)."""
    return (elem_bytes * B * S * (H * dqk + K * dqk + K * dv + H * dv),
            2 * B * H * k5_pairs(S, window, causal) * (dqk + dv))


def k5_bwd_bytes_ops(B, S, H, K, dqk, dv, window=None,
                     causal: bool = True) -> tuple[int, int]:
    """Bytes the attention backward must move (q, k, v, o, do read and dq,
    dk, dv written once in bf16; the float32 row statistic read once) and
    its operations: five products over the unmasked pairs,
    2·pairs·(3·dqk + 2·dv) a (batch, head)."""
    n_bytes = 2 * B * S * (2 * (H * dqk + K * dqk + K * dv) + 2 * H * dv) \
        + 4 * B * H * S
    return n_bytes, 2 * B * H * k5_pairs(S, window, causal) * (3 * dqk + 2 * dv)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the bf16 rate, whichever is longer."""
    return max(n_bytes / PEAK_HBM_BYTES_S, n_ops / PEAK_BF16_FLOPS)


def attn_fwd_flops(s: Sizes, B: int, S: int) -> int:
    """Causal attention's q·k and p·v over every layer of a forward."""
    return s.n_layers * 2 * B * s.heads * k5_pairs(S) * (s.dqk + s.dv)


def prefill_flops(s: Sizes, B: int, S: int) -> int:
    """Model FLOPs of a prefill of B prompts of S tokens: 2 × the active
    trunk parameters × tokens, the head at each prompt's last position
    (the only logits a prefill needs), and causal attention."""
    return 2 * s.trunk_params() * B * S + 2 * s.head_params() * B \
        + attn_fwd_flops(s, B, S)


def decode_step_flops(s: Sizes, B: int, slots: int) -> int:
    """Model FLOPs of one decode step of B sequences over ``slots`` cache
    slots in use: 2 × active parameters (head included) × B, and attention
    of one query over the slots."""
    return 2 * (s.trunk_params() + s.head_params()) * B \
        + s.n_layers * 2 * B * s.heads * slots * (s.dqk + s.dv)


def decode_step_bytes(s: Sizes, B: int, slots: int) -> int:
    """Bytes one decode step must move in bf16: every weight once (the
    embedding: B rows), the K/V of the slots in use read and one slot
    written a layer (a GQA cache; MLA: the latent and rope key)."""
    per_slot = 2 * s.kv_heads * s.head_dim if s.attn == "gqa" \
        else s.kv_lora + s.rope_dim
    weights = s.trunk_params(active=False) + s.head_params() + B * s.d
    return 2 * weights + s.n_layers * 2 * B * per_slot * (slots + 1)


def train_step_flops(s: Sizes, B: int, S: int) -> int:
    """Model FLOPs of a training step: 6 × active parameters (head
    included) × tokens and 3 × attention's forward; remat's recompute is
    not counted."""
    return 6 * (s.trunk_params() + s.head_params()) * B * S \
        + 3 * attn_fwd_flops(s, B, S)
