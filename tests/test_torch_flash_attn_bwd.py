"""K5's backward on the CPU: the yardstick the card's kernel is held to, the
rounding scheme of that kernel, its plan, and the kernels' build hash.

- ``flash_attention_backward_plain`` (what ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` hold ``csrc/flash_attn_bwd.cu`` against)
  and the row statistic of ``flash_attention_lse_plain`` against the JAX
  package: ``jax.vjp`` of the reference's ``_sdpa`` over ``_repeat_kv``'d
  K/V (``repro/models/attention.py``), and the logsumexp of its masked
  logits, in float32 from the same numpy inputs, with fewer KV heads than
  query heads, one KV head, as many as query heads, ragged S and S 1;
  and at MLA's unequal head dims (96/64, 192/128, and the smoke dims' 24/16
  zero-padded to 32/16 at scale 1/√24). Tolerance: float32 work summed in another order, rtol = atol = 2e-5 (the
  reference's own kernel-test bound).
- The kernel's roundings emulated in float32: P and dS rounded to bf16 once
  before their products, D from the bf16 output and its low part (the
  forward's float32 output to ~16 bits), dK and dV of a KV head
  summed over each split's query heads and the splits' float32 partials
  added in split order (``bwd_plan``), each output rounded to bf16. The
  emulation sits inside ``chip_smoke.py``'s unchanged ``K5_BWD_*``
  tolerance, and the four planted faults of ``chip_smoke.bwd_faults_plain``
  fall outside it, at the small shapes of ``K5_BWD_SHAPES`` and
  ``K5_BWD_MLA_SHAPES``.
- ``bwd_plan``'s splits, grids and partial bytes.
- ``kernels/build.py``: an edited ``*.cuh`` header gives the library
  another name, so a stale library is never reused.
"""
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import attention as jattn
from repro_torch.kernels import build
from repro_torch.kernels import flash_attn as K5

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=2e-5, atol=2e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _inputs(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd))]


@pytest.mark.parametrize("B,S,H,K,hd", [
    (2, 37, 8, 2, 16),     # GQA, ragged S
    (1, 64, 4, 1, 16),     # one KV head
    (2, 50, 4, 4, 64),     # as many KV heads as query heads
    (1, 1, 4, 2, 64)])     # one position
def test_plain_backward_and_lse_match_jax_vjp_of_sdpa(B, S, H, K, hd):
    q, k, v, dout = _inputs(B, S, H, K, hd, seed=S + H)
    scale = 1.0 / np.sqrt(hd)

    pos = jnp.broadcast_to(jnp.arange(S), (B, S))   # the causal mask's

    def ref(q, k, v):
        return jattn._sdpa(q, jattn._repeat_kv(k, H), jattn._repeat_kv(v, H),
                           scale, qpos=pos, kpos=pos)

    @jax.jit
    def reference(q, k, v, dout):
        out, vjp = jax.vjp(ref, q, k, v)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q,
                            jattn._repeat_kv(k, H)) * scale
        logits = jnp.where(jnp.tril(jnp.ones((S, S), bool)), logits,
                           K5.NEG_INF)
        return out, vjp(dout), jax.nn.logsumexp(logits, axis=-1) * K5.LOG2E

    out_j, want, lse_j = reference(q, k, v, dout)

    tq, tk, tv, td = map(torch.from_numpy, (q, k, v, dout))
    got = K5.flash_attention_backward_plain(tq, tk, tv, td, scale)
    out_t, lse_t, _ = K5.flash_attention_lse_plain(tq, tk, tv, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32)
    # the wrapper runs the plain version on CPU tensors
    wrapped = K5.flash_attention_backward(tq, tk, tv, out_t, lse_t, td, scale)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _mla_inputs(B, S, H, K, dqk, dv, used, seed):
    """q, k [.., dqk] whose columns from ``used`` on are 0 (the MLA smoke
    dims' q·k of 24 zero-padded to 32), v [.., dv], dout [.., dv]."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, S, n, dqk)).astype(np.float32)
            for n in (H, K))
    q[..., used:] = 0
    k[..., used:] = 0
    v = rng.normal(size=(B, S, K, dv)).astype(np.float32)
    dout = rng.normal(size=(B, S, H, dv)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("B,S,H,K,dqk,dv,used", [
    (2, 37, 4, 4, 96, 64, 96),      # minicpm3-4b's pair, ragged S
    (1, 70, 4, 2, 192, 128, 192),   # deepseek-v2-lite-16b's, GQA
    (2, 40, 4, 4, 32, 16, 24)])     # the smoke dims: 24 zero-padded to 32
def test_plain_backward_matches_jax_vjp_of_sdpa_at_unequal_head_dims(
        B, S, H, K, dqk, dv, used):
    """MLA's pairs (q·k head dim ≠ v's): dq and dk at Dqk, dv at Dv, and the
    row statistic, against ``jax.vjp`` of the reference's ``_sdpa`` over
    the ``used`` q·k columns, at scale 1/√used (the padded smoke pair keeps
    the unpadded 1/√24); the padded columns' dq and dk are 0."""
    q, k, v, dout = _mla_inputs(B, S, H, K, dqk, dv, used, seed=S + dqk)
    scale = 1.0 / np.sqrt(used)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def ref(q, k, v):
        return jattn._sdpa(q, jattn._repeat_kv(k, H), jattn._repeat_kv(v, H),
                           scale, qpos=pos, kpos=pos)

    @jax.jit
    def reference(q, k, v, dout):
        out, vjp = jax.vjp(ref, q, k, v)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q,
                            jattn._repeat_kv(k, H)) * scale
        logits = jnp.where(jnp.tril(jnp.ones((S, S), bool)), logits,
                           K5.NEG_INF)
        return out, vjp(dout), jax.nn.logsumexp(logits, axis=-1) * K5.LOG2E

    out_j, (dq_j, dk_j, dv_j), lse_j = reference(
        q[..., :used], k[..., :used], v, dout)
    tq, tk, tv, td = map(torch.from_numpy, (q, k, v, dout))
    dq, dk, dvv = K5.flash_attention_backward_plain(tq, tk, tv, td, scale)
    out_t, lse_t, _ = K5.flash_attention_lse_plain(tq, tk, tv, scale)
    assert (dq.shape, dk.shape, dvv.shape) == (tq.shape, tk.shape, tv.shape)
    np.testing.assert_allclose(dq[..., :used].numpy(), np.asarray(dq_j),
                               **F32)
    np.testing.assert_allclose(dk[..., :used].numpy(), np.asarray(dk_j),
                               **F32)
    np.testing.assert_allclose(dvv.numpy(), np.asarray(dv_j), **F32)
    assert not dq[..., used:].any() and not dk[..., used:].any()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32)


def emulate_kernel(q, k, v, out, out_lo, lse, dout, scale):
    """The backward kernel's arithmetic in float32 on the CPU (bf16 inputs,
    the forward's bf16 ``out`` and its low part ``out_lo``, float32
    ``lse``): D from out + out_lo, dS from float32 P,
    P and dS rounded to bf16 for their products, dq = bf16(scale dS K), and
    dk, dv of each KV head as the sum of ``bwd_plan``'s splits' float32
    partials in split order, then bf16 (dk times the scale)."""
    B, S, H, dqk = q.shape
    K, dv = k.shape[2], v.shape[3]
    G = H // K
    splits = K5.bwd_plan(B, S, H, K, dqk, dv)["splits"]
    qf = q.float().transpose(1, 2)                          # [B, H, S, D]
    kf = k.repeat_interleave(G, 2).float().transpose(1, 2)
    vf = v.repeat_interleave(G, 2).float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    delta = (dout.float() * (out.float() + out_lo.float())).sum(
        -1).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * K5.LOG2E)
    causal = torch.ones((S, S), dtype=torch.bool).tril()
    p = torch.where(causal, torch.exp2(s - lse[..., None]), 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = (torch.matmul(ds, kf) * scale).transpose(1, 2).bfloat16()
    # [B, K, splits, G / splits, S, D]: a split's heads, then the splits
    dk_h = torch.matmul(ds.transpose(-1, -2), qf).view(B, K, splits, -1, S,
                                                       dqk)
    dv_h = torch.matmul(p.transpose(-1, -2), dof).view(B, K, splits, -1, S,
                                                       dv)
    dk_s, dv_s = dk_h.sum(3), dv_h.sum(3)
    dk, dvv = dk_s[:, :, 0], dv_s[:, :, 0]
    for sp in range(1, splits):                             # split order
        dk, dvv = dk + dk_s[:, :, sp], dvv + dv_s[:, :, sp]
    return (dq, (dk * scale).transpose(1, 2).bfloat16(),
            dvv.transpose(1, 2).bfloat16())


@pytest.mark.parametrize("B,S,H,K,hd", [
    shape for shape in CS.K5_BWD_SHAPES if shape[0] * shape[1] <= 2048])
def test_kernel_roundings_sit_inside_the_card_tolerance(B, S, H, K, hd):
    """The emulated kernel passes chip_smoke's _bwd_close against the plain
    backward; every planted fault fails it."""
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in
                     _inputs(B, S, H, K, hd, seed=B * S + H))
    scale = 1.0 / hd ** 0.5
    out, lse, out_lo = K5.flash_attention_lse_plain(q, k, v, scale)
    want = K5.flash_attention_backward_plain(q, k, v, dout, scale)
    got = emulate_kernel(q, k, v, out, out_lo, lse, dout, scale)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    err, worst, ok = CS._bwd_close(got, want)
    assert ok, (err, worst)
    faults = CS.bwd_faults_plain(q, k, v, out, dout, lse, scale)
    assert set(faults) == {"no_delta", "mask_shift", "last_key_tile",
                           "late_lse"}
    for name, f_grads in faults.items():
        f_err, f_worst, f_ok = CS._bwd_close(f_grads, want)
        assert not f_ok, (name, f_err, f_worst)


@pytest.mark.parametrize("B,S,H,K,dqk,dv,used", [
    shape for shape in CS.K5_BWD_MLA_SHAPES if shape[0] * shape[1] <= 2048])
def test_kernel_roundings_at_mla_dims_sit_inside_the_card_tolerance(
        B, S, H, K, dqk, dv, used):
    """The emulated kernel at chip_smoke's MLA backward shapes (Dqk ≠ Dv;
    the smoke pair zero-padded, scale 1/√24) passes ``_bwd_close`` against
    the plain backward; every planted fault fails it."""
    q, k, v, dout = (torch.from_numpy(a).bfloat16() for a in
                     _mla_inputs(B, S, H, K, dqk, dv, used, seed=B * S + H))
    scale = 1.0 / used ** 0.5
    out, lse, out_lo = K5.flash_attention_lse_plain(q, k, v, scale)
    want = K5.flash_attention_backward_plain(q, k, v, dout, scale)
    got = emulate_kernel(q, k, v, out, out_lo, lse, dout, scale)
    err, worst, ok = CS._bwd_close(got, want)
    assert ok, (err, worst)
    for name, f_grads in CS.bwd_faults_plain(q, k, v, out, dout, lse,
                                             scale).items():
        f_err, f_worst, f_ok = CS._bwd_close(f_grads, want)
        assert not f_ok, (name, f_err, f_worst)


@pytest.mark.parametrize("shape,splits,blocks", [
    ((2, 2048, 24, 2, 128), 2, 256),      # starcoder2-3b: 32 tiles x 2 x 2
    ((1, 4096, 32, 8, 128), 1, 512),      # 64 tiles x 8 KV heads: no split
    ((16, 128, 8, 4, 64), 2, 256),        # qwen3-100m: G 2
    ((2, 300, 16, 1, 128), 8, 80),        # none reaches 132: at most 8
    ((1, 256, 4, 4, 128), 1, 16),         # G 1
    ((1, 333, 6, 2, 128), 3, 36),         # G 3
    ((2, 40, 8, 4, 64), 2, 16)])
def test_bwd_plan(shape, splits, blocks):
    B, S, H, K, hd = shape
    plan = K5.bwd_plan(B, S, H, K, hd, hd)
    assert (plan["splits"], plan["blocks"]) == (splits, blocks)
    assert plan["key_rows"] == 64
    if splits == 1:
        assert plan["partial_bytes"] == plan["tickets"] == 0
    else:
        assert plan["partial_bytes"] == 4 * splits * B * S * K * 2 * hd
        assert plan["tickets"] == blocks // splits
    if shape == (2, 2048, 24, 2, 128):      # the design note's figure
        assert plan["partial_bytes"] == 16_777_216
    forced = K5.bwd_plan(B, S, H, K, hd, hd, splits=1)
    assert forced["splits"] == 1 and forced["partial_bytes"] == 0
    assert forced["blocks"] == blocks // splits
    with pytest.raises(ValueError, match="divide"):
        K5.bwd_plan(B, S, H, K, hd, hd, splits=H // K + 1)


def test_editing_a_header_changes_the_build_tag(tmp_path, monkeypatch):
    """The library is named by a hash of the sources and the headers they
    include: an edited header (or source) names another library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")), "no header to edit"
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path()
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path()
    assert after != before and after.parent == before.parent
    src = csrc / "flash_attn_bwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path() not in (before, after)
