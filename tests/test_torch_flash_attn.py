"""K5 ``flash_attn`` and the model's attention, on the CPU: the port's plain
versions against the live JAX package.

- K5's plain version (``repro_torch.kernels.flash_attn``) against the JAX
  oracle ``flash_attn/ref.py::attention`` and the Pallas kernel run in
  interpret mode (``flash_attn/ops.py``, as ``tests/test_kernels.py`` runs
  it), in float32 and bf16, at ragged and tile-multiple S, head dims 16, 64
  and 128, with fewer KV heads than query heads (the JAX side gets K/V
  repeated to H heads, as its callers pass them).
- The arithmetic of the bf16 tensor-core kernel (``csrc/flash_attn_tc.cu``),
  emulated in plain torch (bf16 products summed in float32, the scale on the
  float32 logits, online softmax over the kernel's key tiles, P multiplied
  as bf16 hi + lo), against K5's plain version and the JAX oracle at the
  bf16 tolerance: the rounding scheme fits before any card runs it.
- The port's ``_sdpa`` against the reference's, unchunked and on its
  Sk = 4096 online-softmax chunk path, with causal, sliding-window and
  decode (``valid_to``) masks.
- ``causal=False`` (the whisper encoder's bidirectional attention): the
  plain version against ``ref.py::attention(causal=False)`` and the
  reference's ``_sdpa(causal=False)`` at ragged and tile-multiple S, the
  Pallas kernel in interpret mode at tile multiples of S only (its wrapper
  pads S with zero keys and masks nothing without ``causal``, so at a
  ragged S the padded keys take softmax mass: one test records that
  difference at S 100), and the tensor-core emulation without the mask.

Inputs are made with numpy from a seed. Tolerances: float32 work in two
frameworks sums in another order (rtol = atol = 2e-5, the reference's own
kernel-test bound); bf16 outputs are rounded from float32 values that
differ in the last bits, so a result may flip by one bf16 ulp (2^-7
relative at most; atol 1e-3 for outputs near 0).
"""
import math

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attn import ops as fa_ops
from repro.kernels.flash_attn import ref as fa_ref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attn as K5
from repro_torch.models import attention as tattn

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-3)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(B, S, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, K, hd)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype, causal=True):
    t = [torch.as_tensor(a).to(TORCH_DT[dtype]) for a in (q, k, v)]
    return K5.flash_attention(*t, causal=causal).float().numpy()


def _jax_repeat(a, H, dtype):
    return jnp.repeat(jnp.asarray(a, JAX_DT[dtype]), H // a.shape[2], axis=2)


SHAPES = [  # (B, S, H, K, hd): ragged and tile-multiple S, GQA and MHA
    (2, 77, 4, 2, 16), (1, 128, 4, 1, 64), (1, 200, 4, 4, 128),
    (2, 256, 4, 2, 64), (1, 33, 2, 2, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_ref(shape, dtype):
    B, S, H, K, hd = shape
    q, k, v = _qkv(*shape, seed=S + hd)
    got = _port(q, k, v, dtype)

    def fold(t):
        return jnp.moveaxis(t, 2, 1).reshape(B * H, S, hd)

    want = fa_ref.attention(fold(jnp.asarray(q, JAX_DT[dtype])),
                            fold(_jax_repeat(k, H, dtype)),
                            fold(_jax_repeat(v, H, dtype)),
                            scale=1.0 / math.sqrt(hd), causal=True)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)).reshape(
        B, H, S, hd), 1, 2)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 100, 4, 2, 16), (1, 256, 2, 1, 64),
                                   (1, 130, 2, 2, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_kernel_in_interpret_mode(shape, dtype):
    B, S, H, K, hd = shape
    q, k, v = _qkv(*shape, seed=7 * S + hd)
    got = _port(q, k, v, dtype)
    want = fa_ops.flash_attention(jnp.asarray(q, JAX_DT[dtype]),
                                  _jax_repeat(k, H, dtype),
                                  _jax_repeat(v, H, dtype), causal=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="head dim"):
        K5.flash_attention(*(torch.zeros((1, 8, 4, 32)),) * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K5.flash_attention(*(q.half(),) * 3)
    with pytest.raises(ValueError, match="do not divide"):
        K5.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                           torch.zeros((1, 8, 3, 16)))
    # more queries than keys (fewer is a query shard, which K5 takes)
    with pytest.raises(ValueError, match="disagree"):
        K5.flash_attention(q, torch.zeros((1, 7, 2, 16)),
                           torch.zeros((1, 7, 2, 16)))
    before = K5.launches
    K5.flash_attention(q, q, q)  # CPU: the plain version, no launch
    assert K5.launches == before


#: the bf16 kernel's keys per tile (``Tiles<HD>::BK`` in
#: ``csrc/flash_attn_tc.cu``, the same at every head dim)
TC_BLOCK_K = 64


def _tc_emulation(q, k, v, split=True, causal=True):
    """The bf16 tensor-core kernel's arithmetic in plain torch: q, k, v bf16
    [B, S, heads, hd]; exact float32 products of bf16 values; logits scaled
    inside exp2 by scale·log2(e); a running max and sum over key tiles of
    ``TC_BLOCK_K``; P multiplied as bf16(P) + bf16(P − bf16(P)) (as bf16(P)
    alone with ``split=False``, which the kernel does not do); the output
    acc / max(l, 1e-30) rounded to bf16. ``causal=False`` masks no key
    (the last tile of a ragged S holds only the keys below S here; the
    kernel's zero-filled keys past S are masked)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    bk = TC_BLOCK_K
    c = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32) * \
        torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf = q.float().transpose(1, 2)                      # [B, H, S, hd]
    kf = k.repeat_interleave(group, dim=2).float().transpose(1, 2)
    vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
    m = torch.full((B, H, S, 1), K5.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.matmul(qf, kt.transpose(-1, -2))
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            s = torch.where(cols <= rows, s, K5.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        acc = acc * alpha + torch.matmul(hi, vt)
        if split:
            acc = acc + torch.matmul((p - hi).bfloat16().float(), vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.bfloat16().transpose(1, 2)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("H,K", [(2, 2), (4, 1), (5, 1)],
                         ids=["group1", "group4", "group5"])
@pytest.mark.parametrize("S", [1, 2, 3, 129, 300])
def test_tensor_core_rounding_matches_plain_and_jax_ref(S, H, K, hd):
    """Rows with few keys are the case to watch: there one rounding of P
    weighs most. The kernel's hi + lo split keeps P to ~16 bits."""
    B = 2
    q, k, v = _qkv(B, S, H, K, hd, seed=31 * S + 7 * H + hd)
    qt, kt, vt = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = _tc_emulation(qt, kt, vt).float()
    plain = K5.flash_attention_plain(qt, kt, vt).float()
    torch.testing.assert_close(got, plain, **TOL["bfloat16"])

    def fold(t):
        return jnp.moveaxis(t, 2, 1).reshape(B * H, S, hd)

    want = fa_ref.attention(fold(jnp.asarray(q, jnp.bfloat16)),
                            fold(_jax_repeat(k, H, "bfloat16")),
                            fold(_jax_repeat(v, H, "bfloat16")),
                            scale=1.0 / math.sqrt(hd), causal=True)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)).reshape(
        B, H, S, hd), 1, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL["bfloat16"])


def test_a_single_bf16_p_would_not_fit_the_tolerance():
    """Why the kernel multiplies P twice: P rounded once to bf16 (2^-9
    relative) moves outputs near 0 past atol 1e-3 where the hi + lo split
    stays inside the tolerance."""
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in _qkv(2, 129, 4, 1, 128, seed=5))
    plain = K5.flash_attention_plain(q, k, v).float()
    torch.testing.assert_close(_tc_emulation(q, k, v).float(), plain,
                               **TOL["bfloat16"])
    assert not torch.allclose(_tc_emulation(q, k, v, split=False).float(),
                              plain, **TOL["bfloat16"])


def test_routes_and_their_counts():
    """One route per dtype, each naming a source that exists; the CPU path
    moves no count, and ``reset_launches`` sets the per-route and the
    per-mask counts to 0."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    assert set(K5.ROUTES) == {torch.bfloat16, torch.float32}
    assert {r for r, _, _ in K5.ROUTES.values()} == set(K5.route_launches)
    for route, fn, src in K5.ROUTES.values():
        assert fn in build.SIGNATURES and (build.CSRC / src).is_file()
    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16)
    before = dict(K5.route_launches)
    K5.flash_attention(q, q, q)
    assert K5.route_launches == before
    saved = dict(K5.route_launches), K5.launches, dict(K5.class_launches)
    try:
        K5.route_launches.update(tensor_core=3, cuda_core=2)
        K5.class_launches.update(causal=4, noncausal=1)
        kernels.reset_launches()
        assert K5.route_launches == {"tensor_core": 0, "cuda_core": 0}
        assert K5.class_launches == {"causal": 0, "noncausal": 0,
                                     "query_shard": 0}
    finally:
        K5.route_launches.update(saved[0])
        K5.launches = saved[1]
        K5.class_launches.update(saved[2])


def _sdpa_pair(q, k, v, **kw):
    """The reference's and the port's ``_sdpa`` on the same numpy inputs;
    ``kw`` holds numpy position/mask arrays and plain numbers."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                       **jkw)
    got = tattn._sdpa(torch.as_tensor(q), torch.as_tensor(k),
                      torch.as_tensor(v), scale, **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("S,window", [(64, None), (64, 16), (4096, None),
                                      (4096, 1000)])
def test_sdpa_matches_reference(S, window):
    """Prefill masks; S = 4096 takes the reference's chunked path (4 key
    chunks of 1024) in both packages."""
    assert (tattn._pick_chunk(S) == jattn._pick_chunk(S)) and \
        bool(tattn._pick_chunk(S)) == (S >= 4096)
    B, H, hd = 1, 2, 8
    q, k, v = _qkv(B, S, H, H, hd, seed=S + (window or 0))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got, want = _sdpa_pair(q, k, v, qpos=pos, kpos=pos, causal=True,
                           window=window)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_sdpa_decode_mask_matches_reference():
    """One query against a cache whose slots past ``valid_to`` are masked."""
    B, Sk, H, hd = 3, 40, 4, 16
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, H, hd)).astype(np.float32)
    got, want = _sdpa_pair(q, k, v, causal=False,
                           valid_to=np.array([0, 17, 39], np.int32))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_k5_plain_is_the_models_causal_attention():
    """K5's plain version computes what the model's ``_sdpa`` computes over
    positions arange(S) with K/V repeated to H heads (float32)."""
    B, S, H, K, hd = 2, 50, 4, 2, 16
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, S, H, K, hd, seed=3))
    pos = torch.arange(S).expand(B, S)
    want = tattn._sdpa(q, tattn._repeat_kv(k, H), tattn._repeat_kv(v, H),
                       1.0 / math.sqrt(hd), qpos=pos, kpos=pos)
    torch.testing.assert_close(K5.flash_attention_plain(q, k, v), want,
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------- causal=False
NONCAUSAL_SHAPES = [  # (B, S, H, K, hd): ragged and tile-multiple S
    (2, 65, 4, 2, 16), (1, 100, 4, 4, 64), (1, 128, 4, 1, 64),
    (1, 200, 2, 2, 128), (2, 256, 4, 2, 16)]


def _fold(t, B, H, S, hd):
    return jnp.moveaxis(t, 2, 1).reshape(B * H, S, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NONCAUSAL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_noncausal_plain_matches_jax_ref_and_sdpa(shape, dtype):
    """The plain version with ``causal=False`` against ``ref.py`` (K/V
    repeated to H) and against the reference's ``_sdpa(causal=False)``,
    which the whisper encoder runs."""
    B, S, H, K, hd = shape
    q, k, v = _qkv(*shape, seed=3 * S + hd)
    got = _port(q, k, v, dtype, causal=False)
    kr, vr = _jax_repeat(k, H, dtype), _jax_repeat(v, H, dtype)
    qj = jnp.asarray(q, JAX_DT[dtype])
    want = fa_ref.attention(_fold(qj, B, H, S, hd), _fold(kr, B, H, S, hd),
                            _fold(vr, B, H, S, hd),
                            scale=1.0 / math.sqrt(hd), causal=False)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)).reshape(
        B, H, S, hd), 1, 2)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    sdpa = jattn._sdpa(qj, kr, vr, 1.0 / math.sqrt(hd), causal=False)
    np.testing.assert_allclose(got, np.asarray(sdpa.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 128, 4, 2, 16), (1, 256, 2, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_noncausal_plain_matches_pallas_kernel_at_tile_multiples(shape,
                                                                  dtype):
    B, S, H, K, hd = shape
    q, k, v = _qkv(*shape, seed=11 * S + hd)
    got = _port(q, k, v, dtype, causal=False)
    want = fa_ops.flash_attention(jnp.asarray(q, JAX_DT[dtype]),
                                  _jax_repeat(k, H, dtype),
                                  _jax_repeat(v, H, dtype), causal=False)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_pallas_wrapper_pads_ragged_noncausal_keys():
    """A fault of the reference recorded: at a ragged S the Pallas wrapper
    pads S with zero rows, and without ``causal`` its kernel masks nothing,
    so the padded keys get logit 0 and take softmax mass. At B 1, H 2,
    hd 64, S 100 (float32) its output is ~0.1 away from ``ref.py``'s; the
    port's plain version (and both CUDA routes) mask keys at or past S and
    equal ``ref.py``."""
    B, S, H, hd = 1, 100, 2, 64
    q, k, v = _qkv(B, S, H, H, hd, seed=100)
    got = _port(q, k, v, "float32", causal=False)
    wrapper = np.asarray(fa_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    want = fa_ref.attention(_fold(jnp.asarray(q), B, H, S, hd),
                            _fold(jnp.asarray(k), B, H, S, hd),
                            _fold(jnp.asarray(v), B, H, S, hd),
                            scale=1.0 / math.sqrt(hd), causal=False)
    want = np.moveaxis(np.asarray(want).reshape(B, H, S, hd), 1, 2)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    assert np.abs(wrapper - want).max() > 0.05


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [1, 65, 100, 129])
def test_tensor_core_rounding_without_the_mask_matches_plain(S, hd):
    B, H, K = 2, 4, 2
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in _qkv(B, S, H, K, hd, seed=13 * S + hd))
    got = _tc_emulation(q, k, v, causal=False).float()
    plain = K5.flash_attention_plain(q, k, v, causal=False).float()
    torch.testing.assert_close(got, plain, **TOL["bfloat16"])


def test_wrapper_refuses_a_window_without_the_causal_mask():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="window needs the causal mask"):
        K5.flash_attention(q, q, q, window=4, causal=False)
    # causal=False is the same call as the plain version's on the CPU
    torch.testing.assert_close(K5.flash_attention(q, q, q, causal=False),
                               K5.flash_attention_plain(q, q, q,
                                                        causal=False))
