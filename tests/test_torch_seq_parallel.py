"""K5 with a query-row offset (sequence parallelism), on the CPU against the
live JAX package.

A query shard is q's rows ``o … o + Sq`` of a sequence whose keys are all
``Sk`` positions: ``flash_attention_plain(..., q_offset=o)`` (the card's
yardstick for the kernel) must compute the reference's ``_sdpa`` with
``qpos = o + arange(Sq)`` and ``kpos = arange(Sk)``.

- The plain forward against ``_sdpa`` (K/V repeated to H heads) under the
  causal mask, a window and no causal mask, at the head-dim pairs 16/16
  and 32/16 (MLA's smoke width, q·k at 32 with a scale of its own), at
  offsets that are not tile multiples and at the sequence's last shard.
- The plain backward with the offset against ``jax.vjp`` of the same
  ``_sdpa`` (the K/V repeat inside the function, so their cotangents sum
  over each group).
- The shards of a sequence, concatenated, equal the unsharded plain call,
  and their dk/dv (zeros for the keys a shard does not see) sum to its.
- ``flash_attention`` refuses a causal shard that reaches past the keys.
"""
import math

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import attention as jattn
from repro_torch.kernels import flash_attn as K5

#: float32 in both frameworks, sums in another order over at most 200
#: keys of O(1) terms
F32 = dict(rtol=1e-4, atol=1e-5)
#: the shards concatenated against the unsharded plain call: the same
#: float32 products and softmax row by row, so equal but for the matmul's
#: blocking over a shorter query dim
SHARDS = dict(rtol=1e-6, atol=1e-6)

#: (B, Sk, H, K, Dqk, Dv, the q·k columns in use, window, causal, offset,
#: Sq): causal at an offset off the 64-row tile and at the last shard;
#: windows that end inside and before the shard; no causal mask
CASES = [
    (2, 200, 4, 2, 16, 16, 16, None, True, 37, 50),
    (2, 200, 4, 2, 16, 16, 16, None, True, 150, 50),
    (1, 200, 4, 4, 32, 16, 24, None, True, 101, 64),
    (2, 160, 4, 2, 16, 16, 16, 32, True, 70, 40),
    (1, 200, 4, 4, 32, 16, 24, 24, True, 130, 70),
    (2, 120, 4, 2, 16, 16, 16, None, False, 45, 30),
    (1, 120, 4, 4, 32, 16, 24, None, False, 0, 90),
]
IDS = ["causal-16-o37", "causal-16-last", "causal-32-o101", "window-16",
       "window-32-last", "noncausal-16", "noncausal-32"]


def _inputs(B, Sk, H, K, dqk, dv, used, seed):
    """float32 q, k, v, dout [B, Sk, ...] from a seed; q and k zero past
    the ``used`` q·k columns (MLA's smoke width padded to 32)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, Sk, H, dqk), (B, Sk, K, dqk), (B, Sk, K, dv),
                    (B, Sk, H, dv)))
    q[..., used:] = 0
    k[..., used:] = 0
    return q, k, v, do


def _reference(q, k, v, H, scale, o, window, causal):
    """The reference's ``_sdpa`` of the shard q at positions o + arange(Sq)
    over k/v at arange(Sk), K/V repeated to H heads inside."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qpos = jnp.broadcast_to(o + jnp.arange(Sq), (B, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk), (B, Sk))
    return jattn._sdpa(q, jattn._repeat_kv(k, H), jattn._repeat_kv(v, H),
                       scale, qpos=qpos, kpos=kpos, causal=causal,
                       window=window)


@pytest.mark.parametrize("B,Sk,H,K,dqk,dv,used,window,causal,o,Sq", CASES,
                         ids=IDS)
def test_plain_forward_with_offset_matches_reference_sdpa(
        B, Sk, H, K, dqk, dv, used, window, causal, o, Sq):
    q, k, v, _ = _inputs(B, Sk, H, K, dqk, dv, used, Sk + o)
    qs = q[:, o:o + Sq]
    scale = 1.0 / math.sqrt(used)
    want = _reference(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), H,
                      scale, o, window, causal)
    got = K5.flash_attention(torch.from_numpy(qs), torch.from_numpy(k),
                             torch.from_numpy(v), scale, window, causal,
                             q_offset=o)
    assert got.shape == (B, Sq, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("B,Sk,H,K,dqk,dv,used,window,causal,o,Sq", CASES,
                         ids=IDS)
def test_plain_backward_with_offset_matches_vjp_of_reference_sdpa(
        B, Sk, H, K, dqk, dv, used, window, causal, o, Sq):
    q, k, v, dout = _inputs(B, Sk, H, K, dqk, dv, used, Sk + o + 1)
    qs, ds = q[:, o:o + Sq], dout[:, o:o + Sq]
    scale = 1.0 / math.sqrt(used)
    _, vjp = jax.vjp(lambda q, k, v: _reference(q, k, v, H, scale, o,
                                                window, causal),
                     *(jnp.asarray(t) for t in (qs, k, v)))
    want = vjp(jnp.asarray(ds))
    got = K5.flash_attention_backward_plain(
        *(torch.from_numpy(t) for t in (qs, k, v, ds)), scale, window,
        causal, o)
    assert [t.shape for t in got] == [qs.shape, k.shape, v.shape]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    # autograd through the plain forward on the CPU gives the same
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (qs, k, v)]
    K5.flash_attention(*leaves, scale, window, causal,
                       q_offset=o).backward(torch.from_numpy(ds))
    for t, g in zip(leaves, got):
        torch.testing.assert_close(t.grad, g, **F32)


@pytest.mark.parametrize("window,causal,rows", [
    (None, True, (37, 64, 99)), (32, True, (100, 100)),
    (None, False, (50, 150))], ids=["causal", "window", "noncausal"])
def test_shards_reassemble_the_unsharded_call(window, causal, rows):
    """Rows o … o + n of each shard, in order, are the unsharded call's;
    the shards' dq concatenated are its dq, their dk and dv (every key:
    zeros where a shard's rows see none) sum to its."""
    B, Sk, H, K, d = 2, sum(rows), 4, 2, 16
    q, k, v, dout = (torch.from_numpy(t) for t in
                     _inputs(B, Sk, H, K, d, d, d, 5))
    full = K5.flash_attention_plain(q, k, v, window=window, causal=causal)
    fdq, fdk, fdv = K5.flash_attention_backward_plain(q, k, v, dout,
                                                      window=window,
                                                      causal=causal)
    outs, dqs = [], []
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    o = 0
    for n in rows:
        sl = slice(o, o + n)
        outs.append(K5.flash_attention(q[:, sl], k, v, window=window,
                                       causal=causal, q_offset=o))
        g = K5.flash_attention_backward_plain(q[:, sl], k, v, dout[:, sl],
                                              window=window, causal=causal,
                                              q_offset=o)
        if causal:  # keys past the shard's last position: exact zeros
            assert not g[1][:, o + n:].any() and not g[2][:, o + n:].any()
        dqs.append(g[0])
        dk += g[1]
        dv += g[2]
        o += n
    torch.testing.assert_close(torch.cat(outs, dim=1), full, **SHARDS)
    torch.testing.assert_close(torch.cat(dqs, dim=1), fdq, **SHARDS)
    torch.testing.assert_close(dk, fdk, **F32)
    torch.testing.assert_close(dv, fdv, **F32)


def test_a_causal_shard_past_the_keys_is_refused():
    """``o + Sq > Sk`` under the causal mask is refused before anything
    runs, by every entry that takes an offset; a negative offset and more
    queries than keys too; without the causal mask the offset changes
    nothing."""
    q = torch.zeros((1, 32, 2, 16))
    k = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="reaches past"):
        K5.flash_attention(q, k, k, q_offset=33)
    with pytest.raises(ValueError, match="reaches past"):
        K5.flash_attention_lse(q, k, k, q_offset=40)
    with pytest.raises(ValueError, match="reaches past"):
        K5.flash_attention_backward(q, k, k, q, torch.zeros((1, 2, 32)), q,
                                    q_offset=64)
    with pytest.raises(ValueError, match="q_offset"):
        K5.flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="disagree"):
        K5.flash_attention(k, q, q)
    K5.flash_attention(q, k, k, q_offset=32)         # the last shard
    assert torch.equal(K5.flash_attention(q, k, k, causal=False, q_offset=40),
                       K5.flash_attention(q, k, k, causal=False))
