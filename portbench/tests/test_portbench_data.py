"""The harness is driven by data: a configuration, a mix, a cell and a
metric added as new files are found and validated with no existing file
changed; a broken entry is refused. And the yardstick's counts against
counts worked out by hand at the smoke sizes."""
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench import bench
from portbench.sizes import (PEAK_BF16_FLOPS, PEAK_HBM_BYTES_S, Sizes, bound_s,
                             decode_step_bytes, decode_step_flops, k5_bwd_bytes_ops,
                             k5_bytes_ops, prefill_flops, train_step_flops)

from smoke import DEEPSEEK, NEMO

ROOT = Path(__file__).resolve().parents[2]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def tree(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_the_benchmark_as_committed_validates():
    assert bench.validate(bench.load_benchmark(ROOT), ROOT) == []


def test_new_files_are_found_and_validated(tree):
    before = _digest(tree / "portbench")
    pkg = tree / "portbench"
    (pkg / "configs" / "tiny-dense.json").write_text(json.dumps(NEMO))
    (pkg / "mixes" / "serve-short.json").write_text(json.dumps(
        {"kind": "serve", "batch": 2, "prompt_len": 8, "new_tokens": 2, "max_len": 10,
         "warmup_batches": 1, "warmup_new_tokens": 2}))
    (pkg / "cells" / "tiny-short.json").write_text(json.dumps(
        {"check_requests": 2, "limits": {"widest_gap": 0.5}}))
    (pkg / "metrics" / "batches_done.py").write_text(
        "def read(rec):\n    return len(rec.get('batches', [])) or None\n")
    b = bench.load_benchmark(tree)
    b["configs"].append({"name": "tiny-dense", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny-dense.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "tiny-short", "config": "tiny-dense",
                           "traffic": "serve-short", "chips": 1, "why": "a test"})
    b["end_to_end"][0]["workloads"].append("tiny-short")
    b["per_layer"].append({"name": "batches_done", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "serve engine",
                           "moves": "ttft_p95_ms", "workloads": ["tiny-short"]})
    assert bench.validate(b, tree, pkg) == []
    assert [m["name"] for m in bench.metrics_of(b, "tiny-short", False)] == \
        ["ttft_p95_ms", "setup_s"]
    assert [m["name"] for m in bench.metrics_of(b, "tiny-short", True)] == ["batches_done"]
    assert bench.reader("batches_done", pkg)({"batches": [1, 2]}) == 2
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
    # a layer metric in a cell that does not report the metric it moves
    b["per_layer"][-1]["moves"] = "tpot_ms"
    assert any("does not report tpot_ms" in e for e in bench.validate(b, tree, pkg))
    b["per_layer"][-1]["moves"] = "ttft_p95_ms"
    b["per_layer"][-1]["unit"] = "batches per run"
    assert any("unit" in e for e in bench.validate(b, tree, pkg))
    b["per_layer"][-1]["unit"] = "batches"
    (pkg / "metrics" / "batches_done.py").unlink()
    assert any("no reader" in e for e in bench.validate(b, tree, pkg))


def test_a_rope_scaling_group_has_to_be_marked_not_run():
    c = json.loads((ROOT / "portbench/configs/deepseek-v2-lite-16b-stage.json").read_text())
    assert Sizes.from_config("stage", c).rope_theta == 10000.0
    del c["rope_scaling_applied"]
    with pytest.raises(ValueError, match="rope_scaling_applied"):
        Sizes.from_config("stage", c)


def test_counts_by_hand_at_smoke_sizes():
    n = Sizes.from_config("nemo", NEMO)
    # a layer: q, o 64·4·16 each, k, v 64·2·16 each, the MLP 3·64·128
    layer = 2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128
    assert n.trunk_params() == 2 * layer
    pairs = 20 * 21 // 2
    attn = 2 * (2 * 3 * 4 * pairs * (16 + 16))
    assert prefill_flops(n, 3, 20) == 2 * 2 * layer * 60 + 2 * 64 * 256 * 3 + attn
    assert train_step_flops(n, 3, 20) == 6 * (2 * layer + 64 * 256) * 60 + 3 * attn
    assert decode_step_flops(n, 3, 21) == 2 * (2 * layer + 64 * 256) * 3 \
        + 2 * 2 * 3 * 4 * 21 * 32
    assert decode_step_bytes(n, 3, 21) == 2 * (2 * layer + 64 * 256 + 3 * 64) \
        + 2 * 2 * 3 * (2 * 2 * 16) * 22
    assert k5_bytes_ops(3, 20, 4, 2, 16, 16) == (2 * 3 * 20 * (64 + 32 + 32 + 64),
                                                 2 * 3 * 4 * pairs * 32)
    assert k5_bwd_bytes_ops(3, 20, 4, 2, 16, 16) == (
        2 * 3 * 20 * (2 * (64 + 32 + 32) + 2 * 64) + 4 * 3 * 4 * 20,
        2 * 3 * 4 * pairs * (3 * 16 + 2 * 16))
    d = Sizes.from_config("ds", DEEPSEEK)
    mla = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    # layer 0 dense (ff 128); layer 1: top-2 + 1 shared expert of 64, router
    assert d.trunk_params() == 2 * mla + 3 * 64 * 128 + 3 * 3 * 64 * 64 + 64 * 4
    assert d.trunk_params(active=False) == 2 * mla + 3 * 64 * 128 \
        + 5 * 3 * 64 * 64 + 64 * 4
    assert (d.dqk, d.dv, d.attn_kv_heads) == (24, 16, 4)


def test_readers_on_a_record_worked_by_hand():
    n = Sizes.from_config("nemo", NEMO)
    batches = [{"requests": 3, "prompt_len": 20, "new_tokens": 4, "t_submit": 0.0,
                "t_first": 0.5, "t_last": 0.8},
               {"requests": 3, "prompt_len": 20, "new_tokens": 4, "t_submit": 1.0,
                "t_first": 1.7, "t_last": 2.3}]
    spans = [("prefill", 0.1, 0.5), ("decode", 0.5, 0.6), ("prefill", 1.2, 1.7)]
    trace = {"names": ["flash_attn_tc_kernel<128, 128>", "nvjet_gemm"],
             "idx": np.array([0, 1, 0]), "start": np.array([0.1, 0.3, 1.0]),
             "end": np.array([0.2, 0.5, 1.2]), "launch": np.array([0.05, 0.55, 0.9]),
             "window_s": 2.5}
    rec = {"sizes": n, "batches": batches, "spans": spans, "trace": trace}
    read = lambda name: bench.reader(name)(rec)  # noqa: E731
    assert read("ttft_p95_ms") == pytest.approx(np.percentile([500] * 3 + [700] * 3, 95))
    # (0.3 + 0.6) s over 2 × 3 intervals
    assert read("tpot_ms") == pytest.approx(900 / 6)
    assert read("prefill_mfu") == pytest.approx(
        100 * 2 * prefill_flops(n, 3, 20) / 0.9 / PEAK_BF16_FLOPS)
    steps = sum(decode_step_flops(n, 3, 21 + i) for i in range(4))
    assert read("decode_mfu") == pytest.approx(100 * 2 * steps / 0.9 / PEAK_BF16_FLOPS)
    moved = sum(decode_step_bytes(n, 3, 21 + i) for i in range(4))
    assert read("decode_hbm_share") == pytest.approx(100 * 2 * moved / 0.9 / PEAK_HBM_BYTES_S)
    # busy [0.1, 0.2] ∪ [0.3, 0.5] ∪ [1.0, 1.2] = 0.5 s of 2.5
    assert read("device_idle.ttft") == pytest.approx(80.0)
    assert read("k5_roofline.prefill") == pytest.approx(
        100 * 2 * bound_s(*k5_bytes_ops(3, 20, 4, 2, 16, 16)) / 0.3)
    assert read("launches_per_step.decode") == 1.0
    assert bench.reader("launches_per_step.train")(dict(rec, steps=3)) == 1.0
    d = Sizes.from_config("ds", DEEPSEEK)
    trace = {"names": ["flash_attn_tc_kernel<192, 128>", "bwd_dq_kernel", "bwd_dkdv_kernel"],
             "idx": np.array([0, 0, 1, 2]), "start": np.array([0.0, 0.1, 0.2, 0.3]),
             "end": np.array([0.05, 0.15, 0.25, 0.4]), "launch": np.full(4, np.nan),
             "window_s": 2.0}
    rec = {"sizes": d, "steps": 4, "tokens": 4 * 2 * 16, "window_s": 2.0, "batch": 2,
           "seq_len": 16, "trace": trace}
    assert bench.reader("train_tokens_per_s")(rec) == 64.0
    assert bench.reader("train_mfu")(rec) == pytest.approx(
        100 * 4 * train_step_flops(d, 2, 16) / 2.0 / PEAK_BF16_FLOPS)
    shape = (2, 16, 4, 4, 24, 16)
    assert bench.reader("k5_roofline.train")(rec) == pytest.approx(
        100 * (2 * bound_s(*k5_bytes_ops(*shape)) + bound_s(*k5_bwd_bytes_ops(*shape))) / 0.25)
    assert bench.reader("launches_per_step.train")(rec) == 1.0
