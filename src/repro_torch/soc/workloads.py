"""DNN workloads lowered to systolic-array layer lists.

A workload is an array [L, 5] of (M, K, N, reps, kind) GEMMs (convolutions
are im2col'd):
  kind 0 — weights stream from DRAM (conv / linear)
  kind 1 — both operands are activations (attention score / AV)
  kind 2 — depthwise-style: ``reps`` tiny GEMMs (poor array utilization)

The paper's benchmarks (§IV-A): ResNet-50, MobileNet(V1), Transformer (6
decoder blocks). The 10 assigned LM architectures are lowered from their
``ArchConfig`` (decode-step and short-prefill variants). A copy of
``repro.soc.workloads``, on the port's own copy of the configs;
``pad_workloads`` waits for the fleet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["WORKLOADS", "get_workload", "resnet50", "mobilenet", "transformer",
           "from_arch_config", "pad_workloads"]


def _l(M, K, N, reps=1, kind=0):
    return [float(M), float(K), float(N), float(reps), float(kind)]


def resnet50() -> np.ndarray:
    L = [_l(112 * 112, 3 * 49, 64)]  # conv1 7x7/2
    c_in = 64
    stages = [(64, 256, 3, 56), (128, 512, 4, 28), (256, 1024, 6, 14),
              (512, 2048, 3, 7)]
    for c_mid, c_out, blocks, out_hw in stages:
        for b in range(blocks):
            m = out_hw * out_hw
            L.append(_l(m, c_in if b == 0 else c_out, c_mid))      # 1x1 reduce
            L.append(_l(m, 9 * c_mid, c_mid))                      # 3x3
            L.append(_l(m, c_mid, c_out))                          # 1x1 expand
            if b == 0:
                L.append(_l(m, c_in, c_out))                       # shortcut 1x1
        c_in = c_out
    L.append(_l(1, 2048, 1000))  # fc
    return np.asarray(L, np.float64)


def mobilenet() -> np.ndarray:
    L = [_l(112 * 112, 27, 32)]  # conv 3x3/2
    # (channels_in, channels_out, stride) for the 13 dw/pw pairs
    plan = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
            (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 \
        + [(512, 1024, 2), (1024, 1024, 1)]
    hw = 112
    for cin, cout, s in plan:
        hw = hw // s
        L.append(_l(hw * hw, 9, 1, reps=cin, kind=2))  # depthwise 3x3
        L.append(_l(hw * hw, cin, cout))               # pointwise 1x1
    L.append(_l(1, 1024, 1000))
    return np.asarray(L, np.float64)


def transformer(seq: int = 128, d: int = 512, heads: int = 8,
                ffn: int = 2048, blocks: int = 6) -> np.ndarray:
    hd = d // heads
    L = []
    for _ in range(blocks):
        L.append(_l(seq, d, 3 * d))                      # QKV
        L.append(_l(seq, hd, seq, reps=heads, kind=1))   # scores
        L.append(_l(seq, seq, hd, reps=heads, kind=1))   # AV
        L.append(_l(seq, d, d))                          # out proj
        L.append(_l(seq, d, ffn))                        # FFN up
        L.append(_l(seq, ffn, d))                        # FFN down
    return np.asarray(L, np.float64)


# ----------------------------------------------------- LM archs (ArchConfig)
def from_arch_config(cfg, mode: str = "decode", seq: int = 256,
                     ctx: int = 256) -> np.ndarray:
    """Lower an ``repro_torch.configs.ArchConfig`` into a systolic workload.

    ``mode='decode'``: one-token step with ``ctx`` cached positions.
    ``mode='prefill'``: ``seq``-token prefill.
    MoE lowers only activated (top-k + shared) experts; attention-free blocks
    lower their SSD/RG-LRU matmuls. Frontends lower as one im2col GEMM.
    """
    M = 1 if mode == "decode" else seq
    L: list[list[float]] = []
    d = cfg.d_model

    def attn_gqa(heads, kv_heads, hd):
        L.append(_l(M, d, heads * hd))               # Q
        L.append(_l(M, d, 2 * kv_heads * hd))        # KV
        span = ctx if mode == "decode" else seq
        if cfg.window:
            span = min(span, cfg.window)
        L.append(_l(M, hd, span, reps=heads, kind=1))   # scores
        L.append(_l(M, span, hd, reps=heads, kind=1))   # AV
        L.append(_l(M, heads * hd, d))               # out

    def attn_mla():
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora:
            L.append(_l(M, d, cfg.q_lora))
            L.append(_l(M, cfg.q_lora, cfg.n_heads * qd))
        else:
            L.append(_l(M, d, cfg.n_heads * qd))
        L.append(_l(M, d, cfg.kv_lora + cfg.qk_rope_dim))     # latent down
        L.append(_l(M, cfg.kv_lora,
                    cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)))  # up
        span = ctx if mode == "decode" else seq
        L.append(_l(M, qd, span, reps=cfg.n_heads, kind=1))
        L.append(_l(M, span, cfg.v_head_dim, reps=cfg.n_heads, kind=1))
        L.append(_l(M, cfg.n_heads * cfg.v_head_dim, d))

    def mlp(ff):
        L.append(_l(M, d, 2 * ff))   # gate+up (gated MLP)
        L.append(_l(M, ff, d))       # down

    def moe():
        L.append(_l(M, d, cfg.n_experts))  # router
        act = cfg.top_k + cfg.n_shared
        L.append(_l(M, d, 2 * cfg.moe_d_ff, reps=act))
        L.append(_l(M, cfg.moe_d_ff, d, reps=act))

    def mamba2():
        d_in = cfg.ssm_heads * cfg.ssm_head_dim
        n = cfg.ssm_state
        L.append(_l(M, d, 2 * d_in + 2 * n + cfg.ssm_heads))  # in_proj
        L.append(_l(M, 4, 1, reps=d_in + 2 * n, kind=2))      # conv1d
        if mode == "decode":
            L.append(_l(cfg.ssm_heads, cfg.ssm_head_dim, n, kind=1))  # state upd
            L.append(_l(cfg.ssm_heads, n, cfg.ssm_head_dim, kind=1))  # out read
        else:
            ch = min(seq, 64)
            nch = max(1, seq // ch)
            L.append(_l(ch, cfg.ssm_head_dim, ch, reps=cfg.ssm_heads * nch, kind=1))
            L.append(_l(ch, ch, cfg.ssm_head_dim, reps=cfg.ssm_heads * nch, kind=1))
            L.append(_l(cfg.ssm_head_dim, ch, n, reps=cfg.ssm_heads * nch, kind=1))
        L.append(_l(M, d_in, d))                              # out_proj

    def rglru():
        w = cfg.lru_width
        L.append(_l(M, d, 2 * w))   # input + gate branches
        L.append(_l(M, 4, 1, reps=w, kind=2))  # temporal conv
        L.append(_l(M, w, w // 8, kind=1))     # recurrence gates (block diag)
        L.append(_l(M, w, d))       # out

    n_layers = cfg.n_layers
    for layer in range(n_layers):
        if cfg.family == "ssm":
            mamba2()
        elif cfg.family == "hybrid":
            if (layer + 1) % 3 == 0:
                attn_gqa(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
            else:
                rglru()
            mlp(cfg.d_ff)
        else:
            if cfg.attn_kind == "mla":
                attn_mla()
            else:
                attn_gqa(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
            if cfg.n_experts and layer >= cfg.first_dense_layers:
                moe()
            else:
                mlp(cfg.d_ff if not cfg.n_experts else cfg.dense_d_ff)
    if cfg.is_encdec:  # encoder side, prefill-like over enc_len
        enc_m = cfg.enc_len
        for _ in range(cfg.enc_layers):
            L.append(_l(enc_m, d, 3 * d))
            L.append(_l(enc_m, cfg.head_dim, enc_m, reps=cfg.n_heads, kind=1))
            L.append(_l(enc_m, enc_m, cfg.head_dim, reps=cfg.n_heads, kind=1))
            L.append(_l(enc_m, d, d))
            L.append(_l(enc_m, d, cfg.d_ff))
            L.append(_l(enc_m, cfg.d_ff, d))
    if cfg.frontend == "audio":   # conv frontend as im2col GEMMs
        L.append(_l(3000, 80 * 3, d))
        L.append(_l(1500, d * 3, d))
    elif cfg.frontend == "vision":
        L.append(_l(1024, 16 * 16 * 3, d))  # patchify 16x16
    L.append(_l(M, d, cfg.vocab))  # LM head
    return np.asarray(L, np.float64)


# ---------------------------------------------------------- fleet batching
def pad_workloads(layer_lists: "list[np.ndarray]"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Stack workloads [L_w, 5] onto a common layer axis: ``(layers
    [W, Lmax, 5], mask [W, Lmax])`` for ``soc_metrics_multi``. Pad rows are
    the benign GEMM (M, K, N, reps, kind) = (1, 1, 1, 0, 0): ``reps = 0``
    zeroes every traffic and MAC term without 0/0, and the mask (a prefix
    of ones) removes the per-layer launch constants."""
    lmax = max(int(np.asarray(l).shape[0]) for l in layer_lists)
    layers = np.tile(np.asarray([1.0, 1.0, 1.0, 0.0, 0.0]),
                     (len(layer_lists), lmax, 1))
    mask = np.zeros((len(layer_lists), lmax))
    for w, l in enumerate(layer_lists):
        l = np.asarray(l, np.float64)
        layers[w, : l.shape[0]] = l
        mask[w, : l.shape[0]] = 1.0
    return layers, mask


# ------------------------------------------------------------------- registry
WORKLOADS = {
    "resnet50": resnet50,
    "mobilenet": mobilenet,
    "transformer": transformer,
}


def get_workload(name: str, mode: str = "decode") -> np.ndarray:
    if name in WORKLOADS:
        return WORKLOADS[name]()
    # LM arch by config id, e.g. "qwen3-14b" or "qwen3-14b:prefill"
    if ":" in name:
        name, mode = name.split(":", 1)
    from repro_torch.configs import ARCH_IDS, get_config

    if name not in ARCH_IDS:
        raise KeyError(f"unknown workload {name!r}; DNN workloads: "
                       f"{tuple(WORKLOADS)}; LM archs (':decode'/':prefill'): "
                       f"{ARCH_IDS}")
    return from_arch_config(get_config(name), mode=mode)
