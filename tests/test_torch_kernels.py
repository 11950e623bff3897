"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_kernels.py does.  Shapes
and tolerances are those of tests/test_kernels.py.  Inputs come from numpy
with a fixed seed and go to both.  The ``gpu`` tests hold the CUDA kernels
against the plain versions and run only where a GPU is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ina_matmul import ina_matmul as jina
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro.models.layers import attn_full as jattn_full

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ina_matmul as ina_mod
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.flash_attention import (
    AttentionPlan, flash_attention, flash_attention_heads,
    flash_attention_heads_plain, flash_attention_plain, kernel_strides,
    plan_attention)
from repro_torch.kernels.ina_matmul import (BK, MatmulPlan, ina_matmul,
                                            ina_matmul_plain, k_slices,
                                            plan_for, plan_matmul)
from repro_torch.kernels.wkv6 import (Wkv6Plan, chunk_size, plan_wkv6, wkv6,
                                     wkv6_heads, wkv6_plain)
from repro_torch.launch.kernel_times import matmul_projections

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(arr, dtype):
    """The same values as a JAX array and a CPU torch tensor of ``dtype``."""
    return (jnp.asarray(arr, _JAX[dtype]),
            torch.from_numpy(arr).to(_TORCH[dtype]))


def _np(t):
    return np.asarray(t, np.float32) if not torch.is_tensor(t) \
        else t.float().numpy()


# --------------------------------------------------------------------------- #
# ina_matmul
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (128, 1024, 256), (384, 256, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ina_matmul_matches_pallas(m, k, n, dtype):
    jx, tx = _pair(_normal(1, m, k), dtype)
    jw, tw = _pair(_normal(2, k, n), dtype)
    want = jina(jx, jw, bm=128, bn=128, bk=128, interpret=True)
    got = ina_matmul(tx, tw)
    assert got.dtype == _TORCH[dtype] and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ina_matmul_tied_head_strided(dtype):
    """w = table.T is read in place (unit stride along K)."""
    jt, tt = _pair(_normal(3, 384, 128), dtype)
    jx, tx = _pair(_normal(4, 128, 128), dtype)
    want = jina(jx, jt.T, bm=128, bn=128, bk=128, interpret=True)
    assert tt.T.stride() == (1, 128)
    got = ina_matmul(tx, tt.T)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("m,k,n", [(3, 100, 200), (2, 1536, 40), (1, 7, 1)])
def test_ina_matmul_ragged_matches_ref(m, k, n):
    """Any M, N, K: the Pallas kernel asserts divisibility, the port masks
    the edges; both equal the plain product."""
    jx, tx = _pair(_normal(5, m, k), "float32")
    jw, tw = _pair(_normal(6, k, n), "float32")
    want = _np(jref.matmul_ref(jx, jw))
    np.testing.assert_allclose(_np(ina_matmul(tx, tw)), want,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(ref.matmul_ref(tx, tw)), want,
                               rtol=1e-5, atol=1e-4)


def test_ina_matmul_equals_eject_inject():
    """Both accumulation strategies are numerically identical (fp32), in
    the port and against the reference's eject/inject baseline."""
    jx, tx = _pair(_normal(7, 128, 512), "float32")
    jw, tw = _pair(_normal(8, 512, 128), "float32")
    a = ina_matmul(tx, tw)
    b = ref.matmul_eject_inject(tx, tw, bk=128)
    c = jref.matmul_eject_inject(jx, jw, bk=128)
    np.testing.assert_allclose(_np(a), _np(b), rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(_np(b), _np(c), rtol=2e-6, atol=1e-4)


# Every projection of the two served models, as (name, K, N): qwen2-1.5b
# (d 1536, kv 256, d_ff 8960, tied head over vocab 151936) and rwkv6-7b
# (d 4096, d_ff 14336, head over vocab 65536).  Both w layouts take one
# plan, so the tied head's k-major layout does not enter.
_PROJECTIONS = [(name, k, n) for _, name, k, n, _ in matmul_projections()]
# (regime, tile_m, tile_n, cluster) for M = 1 and 2 (decode), 64 (the
# prefill chunk) and 4096 (the rwkv forward), worked out by hand from the
# rule: the largest power of two c <= 8 with tiles x c <= 132 SMs that
# leaves every CTA at least two 64-deep K tiles.
_PLANS = {
    "wq/wo": {1: ("narrow", 8, 64, 4), 64: ("wide", 64, 128, 8),
              4096: ("wide", 128, 256, 1)},
    "wk/wv": {1: ("narrow", 8, 64, 8), 64: ("wide", 64, 128, 8),
              4096: ("wide", 128, 128, 2)},
    "w_up/w_gate": {1: ("narrow", 8, 64, 1), 64: ("wide", 64, 128, 1),
                    4096: ("wide", 128, 256, 1)},
    "w_down": {1: ("narrow", 8, 64, 4), 64: ("wide", 64, 128, 8),
               4096: ("wide", 128, 256, 1)},
    "tied head": {1: ("narrow", 8, 64, 1), 64: ("wide", 64, 128, 1),
                  4096: ("wide", 128, 256, 1)},
    "r/k/v/g/o": {1: ("narrow", 8, 64, 2), 64: ("wide", 64, 128, 4),
                  4096: ("wide", 128, 256, 1)},
    "cmix wk": {1: ("narrow", 8, 64, 1), 64: ("wide", 64, 128, 1),
                4096: ("wide", 128, 256, 1)},
    "cmix wv": {1: ("narrow", 8, 64, 2), 64: ("wide", 64, 128, 4),
                4096: ("wide", 128, 256, 1)},
    "head": {1: ("narrow", 8, 64, 1), 64: ("wide", 64, 128, 1),
             4096: ("wide", 128, 256, 1)},
}


@pytest.mark.parametrize("m", [1, 2, 64, 4096])
@pytest.mark.parametrize("name,k,n", _PROJECTIONS,
                         ids=[s[0] for s in _PROJECTIONS])
def test_plan_matmul_main_path_shapes(name, k, n, m):
    """The regime, tile and cluster of every main-path product; none of
    them may take the generic path, and every K slice is whole BK tiles
    (at least two of them when the K range is split)."""
    plan = plan_matmul(m, n, k, aligned=True)
    want = _PLANS[name][1 if m == 2 else m]
    assert (plan.regime, plan.tile_m, plan.tile_n, plan.cluster) == want
    assert plan.regime != "generic" and plan.bk == BK
    slices = k_slices(plan, k)
    assert len(slices) == plan.cluster
    assert slices[0][0] == 0 and slices[-1][1] == k
    for (lo, hi), (nxt, _) in zip(slices, slices[1:] + [(k, k)]):
        assert lo % BK == 0 and hi == nxt
        assert hi - lo >= (2 * BK if plan.cluster > 1 else 1)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [512, 1000, 1088])
def test_k_slices_are_whole_tiles(c, k):
    """Rank r takes tiles [r T / c, (r + 1) T / c): contiguous, in rank
    order, whole BK tiles except where the last one ends at K."""
    plan = MatmulPlan("wide", 64, 128, c, BK)
    slices = k_slices(plan, k)
    assert [lo for lo, _ in slices] == [r * (-(-k // BK)) // c * BK
                                        for r in range(c)]
    assert all(lo % BK == 0 and (hi % BK == 0 or hi == k) and lo < hi
               for lo, hi in slices)
    assert [hi for _, hi in slices[:-1]] == [lo for lo, _ in slices[1:]]


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_split_plain_matches_pallas(c, dtype):
    """The plain version blocked as a cluster of c CTAs (c K slices of
    whole tiles, summed in rank order) equals the Pallas kernel (interpret
    mode) and matmul_ref: f32 at 1e-5, bf16 at the tolerance above."""
    m, k, n = 128, 1024, 256
    jx, tx = _pair(_normal(80, m, k), dtype)
    jw, tw = _pair(_normal(81, k, n), dtype)
    plan = MatmulPlan("wide", 128, 128, c, BK)
    got = ina_matmul_plain(tx, tw, plan)
    assert got.dtype == _TORCH[dtype] and got.shape == (m, n)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (jina(jx, jw, bm=128, bn=128, bk=128, interpret=True),
                 jref.matmul_ref(jx, jw)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("kmajor", [False, True], ids=["row", "k-major"])
def test_cluster_split_plain_ragged_matches_ref(c, kmajor):
    """Ragged M, N and a K that is no multiple of c x BK, both w layouts,
    in float32 against matmul_ref at 1e-5 (w ~ N(0, 1/K), so |y| ~ 1 and
    the sum order's f32 noise stays near 1e-6)."""
    m, k, n = 3, 2 * c * BK + 40, 200
    jx, tx = _pair(_normal(82, m, k), "float32")
    w = (_normal(83, n, k).T if kmajor else _normal(83, k, n)) / np.sqrt(k)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    assert (tw.stride(0) == 1) == kmajor
    plan = MatmulPlan("narrow", 8, 64, c, BK)
    np.testing.assert_allclose(_np(ina_matmul_plain(tx, tw, plan)),
                               _np(jref.matmul_ref(jx, jw)),
                               rtol=1e-5, atol=1e-5)


def test_plan_for_takes_generic_only_where_tma_cannot():
    """TMA needs 16-byte aligned bases and row strides of a multiple of 8
    elements; the generic kernel takes the rest, such as K = 1001."""
    def regime(x, w):
        return plan_for(x, w).regime
    bf = torch.bfloat16
    x, w = torch.ones(2, 1024, dtype=bf), torch.ones(1024, 200, dtype=bf)
    assert regime(x, w) == "narrow"
    assert regime(torch.ones(64, 1024, dtype=bf), w) == "wide"
    # K = 1001 itself is no obstacle (TMA zero-fills the last K tile) ...
    assert regime(torch.ones(2, 1008, dtype=bf)[:, :1001],
                  torch.ones(1001, 200, dtype=bf)) == "narrow"
    # ... a stride of 1001 elements is
    assert regime(torch.ones(2, 1008, dtype=bf)[:, :1001],
                  torch.ones(200, 1001, dtype=bf).T) == "generic"
    assert regime(torch.ones(2, 1001, dtype=bf),
                  torch.ones(1001, 201, dtype=bf)) == "generic"
    assert regime(torch.ones(3, 1001, dtype=bf),
                  torch.ones(1001, 200, dtype=bf)) == "generic"
    # one row: its stride is never stepped
    assert regime(torch.ones(3, 1001, dtype=bf)[:1], w[:1001]) == "narrow"
    # a base off the 16-byte grid
    assert regime(torch.ones(2, 1032, dtype=bf)[:, 1:1025], w) == "generic"
    assert plan_for(x.float(), w.float()).regime == "f32"
    # both w layouts take one plan
    assert plan_for(x, torch.ones(200, 1024, dtype=bf).T) == plan_for(x, w)


def test_ina_matmul_dispatches_by_device(monkeypatch):
    """A CPU tensor runs the plain version and never reaches the build or
    the launch counters."""
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = (ina_mod.launches, dict(ina_mod.launches_by_regime))
    tx = torch.from_numpy(_normal(84, 2, 300)).to(torch.bfloat16)
    tw = torch.from_numpy(_normal(85, 300, 70)).to(torch.bfloat16)
    torch.testing.assert_close(ina_matmul(tx, tw), ina_matmul_plain(tx, tw),
                               rtol=0, atol=0)
    assert (ina_mod.launches, ina_mod.launches_by_regime) == before
    with pytest.raises(ValueError):
        ina_matmul(tx.float(), tw.float(), plan=plan_for(tx, tw))


@pytest.mark.parametrize("bad,err", [
    (lambda: ina_matmul(torch.ones(2, 3), torch.ones(4, 5)), ValueError),
    (lambda: ina_matmul(torch.ones(2, 3), torch.ones(3, 5,
                                                     dtype=torch.bfloat16)),
     TypeError),
    (lambda: ina_matmul(torch.ones(2, 3, dtype=torch.float64),
                        torch.ones(3, 5, dtype=torch.float64)), TypeError),
    (lambda: ina_matmul(torch.ones(3, 2).T, torch.ones(3, 5)), ValueError),
    (lambda: ina_matmul(torch.ones(2, 3), torch.ones(3, 10)[:, ::2]),
     ValueError),
    (lambda: ina_matmul(torch.ones(0, 3), torch.ones(3, 5)), ValueError),
    (lambda: flash_attention(torch.ones(2, 4, 8), torch.ones(2, 5, 8),
                             torch.ones(2, 6, 8)), ValueError),
    (lambda: flash_attention(torch.ones(2, 4, 256), torch.ones(2, 4, 256),
                             torch.ones(2, 4, 256)), ValueError),
    (lambda: flash_attention(torch.ones(2, 4, 8), torch.ones(2, 4, 8),
                             torch.ones(2, 4, 8), q_offset=-1), ValueError),
    (lambda: flash_attention(torch.ones(2, 4, 8),
                             torch.ones(2, 4, 8, dtype=torch.bfloat16),
                             torch.ones(2, 4, 8)), TypeError),
    (lambda: flash_attention(torch.ones(2, 8, 4).transpose(1, 2),
                             torch.ones(2, 4, 8), torch.ones(2, 4, 8)),
     ValueError),
    (lambda: flash_attention_heads(torch.ones(1, 4, 3, 16),
                                   torch.ones(1, 4, 2, 16),
                                   torch.ones(1, 4, 2, 16)), ValueError),
    (lambda: flash_attention_heads(torch.ones(1, 4, 4, 16),
                                   torch.ones(1, 4, 2, 32)[..., ::2],
                                   torch.ones(1, 4, 2, 16)), ValueError),
    (lambda: flash_attention_heads(torch.ones(4, 4, 16), torch.ones(4, 4, 16),
                                   torch.ones(4, 4, 16)), ValueError),
    (lambda: wkv6(*[torch.ones(2, 5, 16)] * 3,
                  torch.ones(2, 5, 16, dtype=torch.bfloat16),
                  torch.ones(2, 16)), TypeError),
    (lambda: wkv6(*[torch.ones(2, 5, 48)] * 4, torch.ones(2, 48)),
     ValueError),
    (lambda: wkv6(*[torch.ones(2, 5, 16)] * 4, torch.ones(3, 16)),
     ValueError),
    (lambda: wkv6(*[torch.ones(2, 5, 16)] * 3,
                  torch.ones(2, 16, 5).transpose(1, 2), torch.ones(2, 16)),
     ValueError),
    (lambda: wkv6_heads(*[torch.ones(2, 5, 4, 16)] * 4, torch.ones(2, 16)),
     ValueError),
], ids=["k-mismatch", "mixed-dtype", "float64", "strided-x", "strided-w",
        "empty", "kv-shape", "head-dim", "neg-offset", "attn-mixed-dtype",
        "strided-q", "heads-group", "heads-strided-d", "heads-rank",
        "wkv-bf16-logw", "wkv-head-dim", "wkv-u-shape",
        "wkv-strides", "wkv-heads-u-shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
def _qkv(seed, bh, sq, sk, d, dtype):
    return [_pair(_normal(seed + i, bh, s, d), dtype)
            for i, s in enumerate((sq, sk, sk))]


@pytest.mark.parametrize("s,d,causal", [(256, 64, True), (256, 64, False),
                                        (512, 128, True), (1024, 64, True)])
def test_flash_attention_matches_pallas(s, d, causal):
    """The JAX signature's front, which is the one-head case of the
    model-layout front bit for bit, against the Pallas kernel."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(10, 4, s, s, d, "float32")
    want = jflash(jq, jk, jv, bq=128, bkv=128, causal=causal, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    heads = flash_attention_heads(tq[:, :, None], tk[:, :, None],
                                  tv[:, :, None], causal=causal)
    torch.testing.assert_close(got, heads[:, :, 0], rtol=0, atol=0)


def test_flash_attention_bf16_matches_pallas():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(20, 2, 256, 256, 64, "bfloat16")
    want = jflash(jq, jk, jv, bq=128, bkv=128, interpret=True)
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("sq,sk", [(128, 256), (384, 128), (256, 512)])
def test_flash_attention_rectangular_matches_pallas(sq, sk):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(30, 2, sq, sk, 64, "float32")
    want = jflash(jq, jk, jv, bq=128, bkv=128, causal=False, interpret=True)
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_160_matches_pallas(dtype):
    """Head dim 160 (zamba2's shared attention: 2 x 2560 / 32 heads), causal,
    against the Pallas kernel: the same tolerances as the D <= 128 cases."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(40, 2, 256, 256, 160, dtype)
    want = jflash(jq, jk, jv, bq=128, bkv=128, interpret=True)
    got = flash_attention(tq, tk, tv)
    tol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,d", [(128, 1500, 64), (100, 1601, 128)],
                         ids=["whisper-1500", "vlm-1601"])
def test_flash_attention_non_causal_ragged_sk_matches_pallas(sq, sk, d):
    """Non-causal over a KV length the port's tiles do not divide (1500 and
    1601 % 64 != 0: whisper's frames, llama-3.2-vision's media rows),
    against the Pallas kernel on KV blocks that divide it."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(41, 2, sq, sk, d, "float32")
    want = jflash(jq, jk, jv, bq=sq, bkv=sk // {1500: 3, 1601: 1}[sk],
                  causal=False, interpret=True)
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def _to_bshd(x, b, h):
    """[B*H, S, D] -> [B, S, H, D] (numpy)."""
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("sq,sk,off,d", [(64, 192, 128, 64), (50, 77, 27, 16),
                                         (1, 40, 39, 16), (16, 16, 0, 64),
                                         (8, 40, 5, 16)])
def test_q_offset_matches_attn_full(sq, sk, off, d):
    """attention_ref(q_offset=) and the plain flash version against the
    reference's attn_full(q_offset=): query row i at position off + i."""
    b, h = 2, 3
    q, k, v = (_normal(40 + i, b * h, s, d) for i, s in enumerate((sq, sk, sk)))
    want = jattn_full(*(jnp.asarray(_to_bshd(t, b, h)) for t in (q, k, v)),
                      causal=True, q_offset=off)
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    np.testing.assert_allclose(
        ref.attention_ref(tq, tk, tv, q_offset=off).numpy(), want,
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        flash_attention(tq, tk, tv, q_offset=off).numpy(), want,
        rtol=2e-5, atol=2e-5)


def _cache_view(seed, b, sk, kvh, d, extra, dtype):
    """The same values as a JAX array [b, sk, kvh, d] and a CPU tensor that
    is the [:, :sk] slice of a [b, sk + extra, kvh, d] cache, so its batch
    stride is (sk + extra) kvh d, not contiguous over the batch."""
    full = _normal(seed, b, sk + extra, kvh, d)
    j, t = _pair(full, dtype)
    return j[:, :sk], t[:, :sk]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,off", [
    (1, 16, 40, 12, 2, 16, 24),     # GQA 6:1 (qwen2's), q_offset > 0
    (2, 8, 8, 8, 2, 64, 0),         # GQA 4:1 (llama3-8b's), q_offset 0
    (2, 19, 83, 6, 1, 16, 64),      # ragged Sq and Sk, one KV head
    (1, 33, 97, 4, 2, 64, 64),      # ragged, D 64, three KV tiles
    (2, 5, 50, 12, 2, 16, 37),      # a chunk that ends short of Sk
], ids=["gqa6-offset", "gqa4", "ragged-kvh1", "ragged-d64", "short-chunk"])
def test_flash_attention_heads_matches_attn_full(b, sq, sk, h, kvh, d, off):
    """The model-layout front (its plain version on the CPU) against the
    reference's grouped attn_full(q_offset=), k/v read from a slice of a
    longer cache, float32 at 2e-5."""
    jq, tq = _pair(_normal(90, b, sq, h, d), "float32")
    jk, tk = _cache_view(91, b, sk, kvh, d, 9, "float32")
    jv, tv = _cache_view(92, b, sk, kvh, d, 9, "float32")
    assert tk.stride(0) == (sk + 9) * kvh * d
    assert tk.is_contiguous() == (b == 1)
    want = jattn_full(jq, jk, jv, causal=True, q_offset=off)
    got = flash_attention_heads(tq, tk, tv, q_offset=off)
    assert got.shape == (b, sq, h, d) and got.is_contiguous()
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_heads_bf16_matches_attn_full():
    """bf16 GQA 6:1 from a cache view: the plain version rounds p to bf16
    before P V, the reference rounds scores and p where its einsums do;
    the same 5e-2 as the one-head bf16 test."""
    jq, tq = _pair(_normal(93, 1, 24, 12, 64), "bfloat16")
    jk, tk = _cache_view(94, 1, 88, 2, 64, 40, "bfloat16")
    jv, tv = _cache_view(95, 1, 88, 2, 64, 40, "bfloat16")
    want = jattn_full(jq, jk, jv, causal=True, q_offset=64)
    got = flash_attention_heads(tq, tk, tv, q_offset=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,sq,h,kvh,dtype,ctas", [
    (1, 64, 12, 2, "bfloat16", 24),      # qwen2 prefill chunk: 384 rows
    (1, 64, 32, 8, "bfloat16", 64),      # llama3-8b
    (12, 256, 1, 1, "bfloat16", 96),     # the JAX front's square case
    (2, 8, 1, 1, "bfloat16", 2),         # 8 rows a KV head: one CTA each
    (1, 2048, 32, 8, "bfloat16", 2048),  # more CTAs than SMs
    (1, 64, 12, 2, "float32", 48),
    (1, 3, 4, 2, "float32", 2),
])
def test_plan_attention(b, sq, h, kvh, dtype, ctas):
    """A CTA takes one (sequence, KV head, tile of packed rows); the row
    tile (32 rows in bf16, 16 in float32) and the KV tile (64, 32) are
    fixed per dtype."""
    dt = _TORCH[dtype]
    plan = plan_attention(b, sq, h, kvh, dt)
    bq, bkv = (32, 64) if dtype == "bfloat16" else (16, 32)
    assert plan == AttentionPlan(bq, bkv, ctas)
    assert plan_attention(b, sq, h, kvh, dt) is plan   # pure, cached


def test_kernel_strides_takes_cache_views_and_rejects_the_rest():
    """D a multiple of 16 (the mma depth; the kernels' instantiations),
    and for the 16-byte loads every stepped stride a multiple of 16 bytes
    and a 16-byte aligned base.  A dimension of size 1 is never stepped,
    so its stride is passed as 0."""
    bf = torch.bfloat16
    cache = torch.zeros(2, 192, 2, 128, dtype=bf)
    assert kernel_strides(cache[:, :64]) == (192 * 2 * 128, 2 * 128, 128)
    assert kernel_strides(torch.zeros(12, 64, 1, 128)) == (64 * 128, 128, 0)
    for bad in (torch.zeros(1, 4, 2, 24, dtype=bf),          # D % 16
                torch.zeros(1, 4, 2, 20),                    # f32 D % 16
                torch.zeros(1, 4, 3, 18)[..., :16],          # f32 stride 18
                torch.zeros(1, 4, 3, 20, dtype=bf)[..., :16],  # stride 20
                torch.zeros(1, 4, 2, 24, dtype=bf)[..., 1:17]):  # base + 2 B
        with pytest.raises(ValueError):
            kernel_strides(bad)


def test_flash_attention_dispatches_by_device(monkeypatch):
    """A CPU tensor runs the plain version and never reaches the build or
    the launch counter."""
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = fa_mod.launches
    q = torch.from_numpy(_normal(97, 1, 10, 6, 16))
    k, v = (torch.from_numpy(_normal(98 + i, 1, 30, 2, 16)) for i in range(2))
    torch.testing.assert_close(
        ops.attention_heads(q, k, v, q_offset=20),
        flash_attention_heads_plain(q, k, v, q_offset=20), rtol=0, atol=0)
    assert fa_mod.launches == before


# --------------------------------------------------------------------------- #
# wkv6
# --------------------------------------------------------------------------- #
def _wkv_inputs(seed, bh, s, hd):
    """tests/test_kernels.py's distributions: r, k ~ 0.5 N, v ~ N,
    logw = -exp(0.5 N - 1), u ~ 0.3 N (numpy, float32)."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, s, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((bh, s, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((bh, s, hd)).astype(np.float32)
    logw = -np.exp(rng.standard_normal((bh, s, hd)) * 0.5 - 1.0
                   ).astype(np.float32)
    u = rng.standard_normal((bh, hd)).astype(np.float32) * 0.3
    return r, k, v, logw, u


def _wkv_against_jax(arrays, chunk):
    """The port's plain version, its wrapper and its ``wkv6_ref`` against
    the Pallas kernel (interpret mode) and the reference's ``wkv6_ref``, at
    tests/test_kernels.py's tolerance (rtol = atol = 1e-4)."""
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    want_ref = _np(jref.wkv6_ref(*j))
    if chunk is not None:
        np.testing.assert_allclose(
            _np(jwkv6(*j, chunk=chunk, interpret=True)), want_ref,
            rtol=1e-4, atol=1e-4)
    for got in (wkv6_plain(*t), wkv6(*t), ref.wkv6_ref(*t)):
        assert got.dtype == torch.float32 and got.shape == arrays[0].shape
        np.testing.assert_allclose(_np(got), want_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,hd,chunk", [(128, 64, 32), (256, 64, 64),
                                        (256, 128, 128)])
def test_wkv6_matches_pallas(s, hd, chunk):
    _wkv_against_jax(_wkv_inputs(70, 3, s, hd), chunk)


@pytest.mark.parametrize("logw_val,chunk", [(-8.0, 8), (-1e-3, 32),
                                            (-0.5, 32)])
def test_wkv6_decay_extremes_match_pallas(logw_val, chunk):
    """tests/test_kernels.py's extremes, each inside the regime where the
    chunked Pallas form is exact (chunk * |logw| <= 80 nats); the port's
    chunked form, every decay anchored at or below zero, is exact at every
    decay (test_wkv6_exact_where_pallas_clamps)."""
    bh, s, hd = 1, 64, 64
    rng = np.random.default_rng(71)
    r = np.full((bh, s, hd), 0.1, np.float32)
    k = rng.standard_normal((bh, s, hd)).astype(np.float32) * 0.3
    v = rng.standard_normal((bh, s, hd)).astype(np.float32)
    logw = np.full((bh, s, hd), logw_val, np.float32)
    _wkv_against_jax((r, k, v, logw, np.zeros((bh, hd), np.float32)), chunk)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_wkv6_ragged_matches_ref(s):
    """Any S: the Pallas kernel asserts S % chunk == 0, the port does not;
    both hold to the reference's step-by-step wkv6_ref."""
    _wkv_against_jax(_wkv_inputs(72, 2, s, 16), None)


def _decay(name, bh, s, hd):
    if name == "mixed":    # a head whose channels mix -1e-3 and -8
        row = np.where(np.arange(hd) % 2 == 0, -1e-3, -8.0)
        return np.broadcast_to(row, (bh, s, hd)).astype(np.float32)
    return np.full((bh, s, hd), name, np.float32)


@pytest.mark.parametrize("decay", [-8.0, -20.0, -float(np.exp(2.0)), "mixed"],
                         ids=["-8", "-20", "clip-floor", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_exact_where_pallas_clamps(decay, dtype):
    """Decays where the Pallas form's 80-nat clamp is wrong over a chunk of
    64 (-8: 512 nats; -20; the model's floor -e^2: 473; channels mixing
    -1e-3 with -8): the chunked plain version and the wrapper hold to the
    reference's step-by-step wkv6_ref at tests/test_kernels.py's 1e-4,
    while the Pallas kernel does not.  bf16 keeps the f32 arithmetic: the
    tolerance holds on y before its rounding (plain and wrapper equal bit
    for bit)."""
    bh, s, hd = 2, 130, 64
    r, k, v, _, u = _wkv_inputs(79, bh, s, hd)
    logw = _decay(decay, bh, s, hd)
    j = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    want = _np(jref.wkv6_ref(*j))
    clamped = _np(jwkv6(*(x[:, :128] for x in j[:4]), j[4], chunk=64,
                        interpret=True))
    assert not np.allclose(clamped, want[:, :128], rtol=1e-4, atol=1e-4)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (r, k, v, logw, u)]
    t[:3] = [x.to(_TORCH[dtype]) for x in t[:3]]
    plain = wkv6_plain(*t)
    assert torch.equal(wkv6(*t), plain)
    if dtype == "float32":
        np.testing.assert_allclose(_np(plain), want, rtol=1e-4, atol=1e-4)
    else:
        exact = _np(ref.wkv6_ref(*(x.float() for x in t[:3]), t[3], t[4]))
        np.testing.assert_allclose(_np(wkv6_plain(*(x.float() for x in t[:3]),
                                                  t[3], t[4])),
                                   exact, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(plain, torch.from_numpy(exact).to(
            torch.bfloat16), rtol=2.0 ** -7, atol=2.0 ** -8)


@pytest.mark.parametrize("extra", [-1, 1, 3], ids=["C-1", "C+1", "2C+3"])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_wkv6_ragged_around_the_chunk(hd, extra):
    """S = C - 1, C + 1 and 2C + 3 for the chunk the kernel takes at this
    head dim (S = 1 is test_wkv6_ragged_matches_ref's): the last chunk is
    zero-padded and must add nothing."""
    c = chunk_size(hd)
    s = c + extra if extra != 3 else 2 * c + 3
    _wkv_against_jax(_wkv_inputs(80, 2, s, hd), None)


def test_plan_wkv6():
    """One CTA per (sequence, head); the chunk by head dim, as
    csrc/wkv6.cu compiles it; sub-blocks of 8; 16 warps."""
    assert plan_wkv6(2, 64, 64) == Wkv6Plan(64, 8, 16, 128)
    assert plan_wkv6(1, 64, 64) == Wkv6Plan(64, 8, 16, 64)
    assert plan_wkv6(3, 2, 128) == Wkv6Plan(16, 8, 16, 6)
    assert plan_wkv6(1, 1, 16).chunk == plan_wkv6(1, 1, 32).chunk == 64


def test_wkv6_tiles_match_the_kernel_source():
    """The tiles the wrapper passes are the ones csrc/wkv6.cu compiles (its
    C entry refuses any other): SUB, WARPS and chunk_for's table."""
    import re
    src = (_build.CSRC / "wkv6.cu").read_text()
    assert int(re.search(r"constexpr int SUB = (\d+);", src)[1]) \
        == wkv6_mod.SUB
    assert int(re.search(r"constexpr int WARPS = (\d+);", src)[1]) \
        == wkv6_mod.WARPS
    c128, c_else = map(int, re.search(
        r"int chunk_for\(int hd\) \{ return hd == 128 \? (\d+) : (\d+); \}",
        src).groups())
    for hd in wkv6_mod.HEAD_DIMS:
        assert chunk_size(hd) == (c128 if hd == 128 else c_else)


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
def test_wkv6_heads_reads_model_layout(layout):
    """wkv6_heads reads [B, S, H, hd] in place (the model's projections,
    or views into one interleaved buffer) with u [H, hd] shared by the
    batch; it equals the Pallas kernel on the [BH, S, hd] transpose."""
    b, s, h, hd = 2, 64, 3, 16
    r, k, v, logw = (a.reshape(b, h, s, hd).transpose(0, 2, 1, 3)
                     for a in _wkv_inputs(73, b * h, s, hd)[:4])
    u = np.random.default_rng(74).standard_normal((h, hd)).astype(np.float32)
    if layout == "contiguous":
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (r, k, v, logw)]
    else:
        buf = torch.from_numpy(np.ascontiguousarray(np.stack(
            [r, k, v, logw], axis=3)))                 # [B, S, H, 4, hd]
        t = [buf[:, :, :, i] for i in range(4)]
        assert t[0].stride() == (s * h * 4 * hd, h * 4 * hd, 4 * hd, 1)
    got = wkv6_heads(*t, torch.from_numpy(u))
    assert got.shape == (b, s, h, hd) and got.is_contiguous()
    assert torch.equal(got, ops.wkv(*t, torch.from_numpy(u)))

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, hd))
    want = jwkv6(bh(r), bh(k), bh(v), bh(logw), jnp.asarray(np.tile(u, (b, 1))),
                 chunk=32, interpret=True)
    want = np.asarray(want).reshape(b, h, s, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)


def test_wkv6_bf16_output_dtype():
    """bf16 r/k/v: f32 arithmetic, one rounding to bf16 at the end."""
    arrays = _wkv_inputs(75, 2, 40, 64)
    t = [torch.from_numpy(a) for a in arrays]
    low = [x.to(torch.bfloat16) for x in t[:3]]
    got = wkv6(*low, t[3], t[4])
    assert got.dtype == torch.bfloat16
    want = wkv6(*(x.float() for x in low), t[3], t[4])
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_wkv6_dispatches_by_device(monkeypatch):
    """A CPU tensor runs the plain version and never reaches the build or
    the launch counter."""
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    before = wkv6_mod.launches
    t = [torch.from_numpy(a) for a in _wkv_inputs(76, 2, 9, 16)]
    torch.testing.assert_close(wkv6(*t), wkv6_plain(*t), rtol=0, atol=0)
    assert wkv6_mod.launches == before


# --------------------------------------------------------------------------- #
# CUDA kernels against their plain versions (only where a GPU is present)
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dtype", [(64, 1536, 256, "bfloat16"),
                                         (2, 8960, 1536, "bfloat16"),
                                         (3, 100, 200, "bfloat16"),
                                         (5, 1001, 201, "bfloat16"),
                                         (70, 1536, 130, "float32")])
def test_ina_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    """In float32, w ~ N(0, 1/K), as chip_smoke.py draws it, so |y| ~ 1
    whatever K: then f32 sum-order noise stays near K eps max|x w| ~ 1e-6,
    inside atol 1e-4.  (With w ~ N(0, 1) at K = 1536, |y| ~ 39 and the
    order of the f32 sums alone moved one element by 1.2e-4.)  bf16 keeps
    w ~ N(0, 1): |y| ~ 10-95, where atol 0.2 is 0.2-2% of a typical value."""
    w = _normal(51, k, n)
    if dtype == "float32":
        w = w / np.sqrt(k)
    x = torch.from_numpy(_normal(50, m, k)).to(cuda, _TORCH[dtype])
    w = torch.from_numpy(w).to(cuda, _TORCH[dtype])
    got, want = ina_matmul(x, w), ina_matmul_plain(x, w)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 10)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("kmajor", [False, True], ids=["row", "k-major"])
@pytest.mark.parametrize("m", [1, 2, 4, 16, 64, 128])
def test_ina_matmul_regimes_on_card(cuda, m, kmajor, c):
    """Each TMA regime and w layout at cluster sizes 1-8, with a ragged N
    and a K that is no multiple of c x BK, against the plain version
    blocked the same way: one bf16 ulp (rtol 2^-7, atol 2^-8)."""
    k, n = 2 * c * BK + 40, 200
    x = torch.from_numpy(_normal(52, m, k)).to(cuda, torch.bfloat16)
    w = _normal(53, n, k).T if kmajor else _normal(53, k, n)
    w = torch.from_numpy(w / np.sqrt(k)).to(cuda, torch.bfloat16)
    plan = plan_for(x, w)._replace(cluster=c)
    assert plan.regime == ("narrow" if m <= 16 else "wide")
    before = ina_mod.launches_by_regime[plan.regime]
    got = ina_matmul(x, w, plan)
    torch.cuda.synchronize()
    assert ina_mod.launches_by_regime[plan.regime] == before + 1
    torch.testing.assert_close(got.float(),
                               ina_matmul_plain(x, w, plan).float(),
                               rtol=2.0 ** -7, atol=2.0 ** -8)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,off,d,dtype", [(256, 256, 0, 128, "bfloat16"),
                                               (64, 192, 128, 128, "bfloat16"),
                                               (50, 77, 27, 16, "float32")])
def test_flash_attention_kernel_matches_plain(cuda, sq, sk, off, d, dtype):
    q, k, v = (torch.from_numpy(_normal(60 + i, 12, s, d)).to(cuda, _TORCH[dtype])
               for i, s in enumerate((sq, sk, sk)))
    got = flash_attention(q, k, v, q_offset=off)
    want = flash_attention_plain(q, k, v, q_offset=off)
    tol = 2e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,dtype", [
    (1, 256, 256, 32, 32, 160, True, "bfloat16"),     # zamba2 shared block
    (1, 100, 100, 32, 32, 160, True, "float32"),
    (1, 300, 1500, 16, 16, 64, False, "bfloat16"),    # whisper cross
    (1, 128, 1601, 32, 8, 128, False, "bfloat16"),    # vlm cross, GQA
    (2, 50, 1500, 16, 16, 64, False, "float32"),
], ids=["d160-bf16", "d160-f32", "whisper-cross-bf16", "vlm-cross-bf16",
        "whisper-cross-f32"])
def test_flash_attention_new_shapes_kernel_matches_plain(cuda, b, sq, sk, h,
                                                         kvh, d, causal,
                                                         dtype):
    """The model-layout kernel at head dim 160 and non-causal over a ragged
    KV length against its plain version: one bf16 ulp in bf16, 1e-5 in
    float32."""
    dt = _TORCH[dtype]
    q = torch.from_numpy(_normal(64, b, sq, h, d)).to(cuda, dt)
    k, v = (torch.from_numpy(_normal(65 + i, b, sk, kvh, d)).to(cuda, dt)
            for i in range(2))
    got = flash_attention_heads(q, k, v, causal=causal)
    want = flash_attention_heads_plain(q, k, v, causal=causal)
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2.0 ** -8)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,cache,dtype", [
    (1, 64, 128, 12, 2, 128, 192, "bfloat16"),    # qwen2 prefill chunk 2
    (1, 64, 128, 32, 8, 128, 192, "bfloat16"),    # llama3-8b
    (2, 64, 192, 12, 2, 64, 256, "bfloat16"),
    (2, 50, 77, 12, 2, 16, 100, "float32"),       # ragged
    (1, 64, 128, 12, 2, 128, 192, "float32"),
], ids=["qwen2-bf16", "llama3-bf16", "d64-bf16", "ragged-f32", "qwen2-f32"])
def test_flash_attention_heads_kernel_matches_plain(cuda, b, sq, sk, h, kvh,
                                                    d, cache, dtype):
    """The model-layout kernel, k/v read from a [:, :Sk] view of a longer
    cache, against its plain version: one bf16 ulp in bf16 (both round an
    f32 sum of the same terms once), 1e-5 in float32 (sum order only)."""
    dt = _TORCH[dtype]
    q = torch.from_numpy(_normal(61, b, sq, h, d)).to(cuda, dt)
    ck, cv = (torch.from_numpy(_normal(62 + i, b, cache, kvh, d)).to(cuda, dt)
              for i in range(2))
    k, v, off = ck[:, :sk], cv[:, :sk], sk - sq
    before = fa_mod.launches
    got = flash_attention_heads(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (2.0 ** -7, 2.0 ** -8)
    want = flash_attention_heads_plain(q, k, v, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,dtype,decay", [
    pytest.param(2, 2048, 64, "bfloat16", None, id="2-2048-64-bfloat16"),
    pytest.param(1, 300, 64, "float32", None, id="1-300-64-float32"),
    pytest.param(2, 1000, 64, "bfloat16", None, id="2-1000-64-bfloat16"),
    pytest.param(1, 300, 64, "float32", -20.0, id="steep-float32"),
    pytest.param(2, 500, 64, "bfloat16", "mixed", id="mixed-bfloat16")])
def test_wkv6_kernel_matches_plain(cuda, b, s, h, dtype, decay):
    """The model's layout at the rwkv6-7b widths (hd 64); f32 at
    rtol = atol = 1e-4, bf16 one bf16 ulp on top.  At an extreme decay
    (where the TPU kernel's clamp is wrong) the kernel is also held to the
    step-by-step ``wkv6_ref``, so that a fault both chunked forms share
    cannot hide."""
    hd = 64
    arrays = list(_wkv_inputs(77, b * h, s, hd)[:4])
    if decay is not None:
        arrays[3] = _decay(decay, b * h, s, hd)
    r, k, v, logw = (torch.from_numpy(np.ascontiguousarray(
        a.reshape(b, h, s, hd))).to(cuda).transpose(1, 2).contiguous()
        for a in arrays)
    u = torch.from_numpy(_normal(78, h, hd) * 0.3).to(cuda)
    r, k, v = (x.to(_TORCH[dtype]) for x in (r, k, v))
    before = wkv6_mod.launches
    got = wkv6_heads(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert wkv6_mod.launches == before + 1
    bh = [x.transpose(1, 2).reshape(b * h, s, hd) for x in (r, k, v, logw)]
    extra = 0.0 if dtype == "float32" else 2.0 ** -7
    wants = [wkv6_plain] + ([ref.wkv6_ref] if decay is not None else [])
    for fn in wants:
        want = fn(*bh, u.repeat(b, 1)).reshape(b, h, s, hd).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1e-4 + extra, atol=1e-4 + extra / 2)


@pytest.mark.gpu
def test_wkv6_entry_refuses_other_tiles(cuda):
    """The C entry takes only the tiles it was compiled for: the wrapper's
    plan launches (cudaSuccess), any other chunk, sub-block or warp count
    returns cudaErrorInvalidValue and launches nothing."""
    b, s, h, hd = 1, 40, 2, 64
    x = torch.zeros(b, s, h, hd, device=cuda)
    u = torch.zeros(b, h, hd, device=cuda)
    y = torch.empty_like(x)
    lib = _build.load("wkv6", wkv6_mod._SIGNATURES)
    plan = plan_wkv6(b, h, hd)
    stream = torch.cuda.current_stream().cuda_stream

    def call(chunk, sub, warps):
        return lib.wkv6(x.data_ptr(), x.data_ptr(), x.data_ptr(),
                        x.data_ptr(), u.data_ptr(), y.data_ptr(), b, s, h,
                        hd, *kernel_strides(x),
                        u.stride(0), u.stride(1), 0, chunk, sub, warps,
                        stream)
    assert call(plan.chunk, plan.sub, plan.warps) == 0
    torch.cuda.synchronize()
    for bad in ((2 * plan.chunk, plan.sub, plan.warps),
                (plan.chunk, 2 * plan.sub, plan.warps),
                (plan.chunk, plan.sub, plan.warps // 2)):
        assert call(*bad) == 1   # cudaErrorInvalidValue
