"""Configurations at the program's smoke-twin sizes (its ``@smoke``
registry entries), in the files' key names, and a driver context for a
CPU run of a cell at those sizes."""
import time
import types

import torch

from portbench.sizes import Sizes

NEMO = {"registry": "mistral-nemo-12b@smoke", "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-6}
DEEPSEEK = {"registry": "deepseek-v2-lite-16b@smoke", "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "vocab_size": 256, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-6, "kv_lora_rank": 32, "q_lora_rank": None,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
            "moe_intermediate_size": 64, "first_k_dense_replace": 1,
            "capacity_factor": 8.0, "norm_topk_prob": True, "aux_loss_coef": 0.01}
SERVE_MIX = {"kind": "serve", "batch": 3, "prompt_len": 20, "new_tokens": 4,
             "max_len": 24, "warmup_batches": 1, "warmup_new_tokens": 2}
TRAIN_MIX = {"kind": "train", "batch": 2, "seq_len": 16, "remat": True, "check_steps": 3,
             "optimizer": {"lr": 3e-4, "warmup": 100, "total_steps": 10000,
                           "min_lr_ratio": 0.1, "weight_decay": 0.1, "grad_clip": 1.0,
                           "b1": 0.9, "b2": 0.95, "eps": 1e-8}}


def context(config, mix, cell, seed=2**33 + 5, seconds=0.5, **extra):
    ctx = types.SimpleNamespace(
        name="smoke", chips=1, config=config, mix=mix,
        sizes=Sizes.from_config("smoke", config), cell=cell, seed=seed,
        seconds=seconds, trace=False, device=torch.device("cpu"),
        t0=time.perf_counter())
    vars(ctx).update(extra)
    return ctx
