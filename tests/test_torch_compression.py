"""The port's compressed psum (``repro_torch.runtime.compression``) against
the JAX package's codec, on the CPU.

* ``int8_encode``, ``int8_decode`` and ``topk_encode`` on the same numpy
  inputs as the reference's: payloads, masks and residuals bit-equal (the
  same float32 operations in the same order; ``torch.round`` and
  ``jnp.round`` both round half to even, and both keep every element at or
  above the k-th largest magnitude), including a half-way case and ties at
  the threshold.
* The reference's two error-feedback properties
  (``tests/test_substrate.py``), on seeded inputs.
* ``compressed_psum`` over gloo at 2, 4 and 8 ranks under ``none``,
  ``int8`` and ``topk``, two steps with the residuals carried: a float32
  leaf, a 0-d leaf and a bfloat16 leaf against a single-process evaluation
  of the reference's encode functions and reduction formula (float32
  within 1e-6; bfloat16 within one bfloat16 ulp, 2^-7 of the value, and,
  under ``none``, whose sum runs in bfloat16 in gloo's order, the bound
  two orders of n - 1 rounded additions can part by:
  :func:`bf16_sum_bound`), every residual bit-equal to the reference's,
  float32.  At 4 and 8 ranks the float32 leaf is within the
  reference test's tolerances of the exact mean (``none`` 1e-6, ``int8``
  2e-3, ``topk`` 0.02) on its input, ``normal(8, 64, 32) * 0.01``.  At 2
  ranks the reference's own formula is 2.21e-3 off the mean under
  ``int8`` (one-shot error grows with the spread of the two scales), so
  that bound is not held there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as J

from repro_torch.launch import mesh
from repro_torch.runtime import compression as T

import _torch_dist_workers as W

CODECS = ("none", "int8", "topk")
WORLDS = (2, 4, 8)
STEPS = 2
EXACT_TOL = {"none": 1e-6, "int8": 2e-3, "topk": 0.02}
BF16_ULP = 2.0 ** -7


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16(a) -> np.ndarray:
    """``a`` rounded to bfloat16, as float32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def encode_inputs() -> dict:
    """name -> (gradient, residual, dtype) on which both codecs run."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((64, 32)).astype(np.float32) * 0.01
    # scale exactly 1: g / scale lands on halves, rounded to even
    halves = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                      np.float32)
    # magnitudes repeat, so the k-th largest has ties
    ties = (rng.integers(-8, 9, 400) / 8).astype(np.float32)
    return {
        "normal": (g, np.zeros_like(g), "float32"),
        "normal+err": (g, rng.standard_normal(g.shape).astype(np.float32)
                       * 1e-3, "float32"),
        "halves": (halves, np.zeros_like(halves), "float32"),
        "ties": (ties, np.zeros_like(ties), "float32"),
        "bfloat16": (_bf16(g * 10), rng.standard_normal(g.shape).astype(
            np.float32) * 1e-3, "bfloat16"),
    }


def _pair(name):
    g, e, dtype = encode_inputs()[name]
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tg = _t(g, torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return (jg, jnp.asarray(e)), (tg, _t(e))


@pytest.mark.parametrize("name", list(encode_inputs()))
def test_int8_encode_decode_match_reference(name):
    (jg, je), (tg, te) = _pair(name)
    jq, js, jerr = J.int8_encode(jg, je)
    tq, ts, terr = T.int8_encode(tg, te)
    assert tq.dtype == torch.int8 and ts.dtype == terr.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(T.int8_decode(tq, ts).numpy(),
                                  np.asarray(J.int8_decode(jq, js)))
    if name == "halves":
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


@pytest.mark.parametrize("name", list(encode_inputs()))
@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5])
def test_topk_encode_matches_reference(name, frac):
    (jg, je), (tg, te) = _pair(name)
    jsparse, jerr = J.topk_encode(jg, je, frac)
    tsparse, terr = T.topk_encode(tg, te, frac)
    assert tsparse.dtype == terr.dtype == torch.float32
    np.testing.assert_array_equal(tsparse.numpy(), np.asarray(jsparse))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    kept = int((tsparse != 0).sum())
    k = max(1, int(tg.numel() * frac))
    assert kept >= k
    if name == "ties":
        assert kept > k            # every tie at the threshold is kept


# --------------------------------------------------------------------------- #
# error feedback (the reference's two properties)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(5))
def test_int8_error_feedback_unbiased(seed):
    """The decoded signal summed over 20 steps stays within two int8 steps
    of the true signal's sum."""
    g = torch.randn(256, generator=torch.Generator().manual_seed(seed)) * 0.1
    err = torch.zeros_like(g)
    acc_true, acc_dec = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        q, scale, err = T.int8_encode(g, err)
        acc_dec += T.int8_decode(q, scale)
        acc_true += g
    resid = float((acc_dec - acc_true).abs().max())
    assert resid <= float(g.abs().max()) * 2 / 127 + 1e-5


@pytest.mark.parametrize("seed", range(3))
def test_topk_error_feedback_recovers_everything(seed):
    """Over 40 steps even the smallest coordinates are sent."""
    g = torch.randn(128, generator=torch.Generator().manual_seed(seed))
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(40):
        sparse, err = T.topk_encode(g, err, frac=0.1)
        acc += sparse
    np.testing.assert_allclose((acc / 40).numpy(), g.numpy(), atol=0.3)


def test_compression_state_init():
    grads = {"a": torch.ones(3, dtype=torch.bfloat16),
             "b": {"c": torch.ones(())}}
    st = T.CompressionState.init(grads)
    assert st.err["a"].dtype == torch.float32 and st.err["a"].shape == (3,)
    assert st.err["b"]["c"].shape == () and float(st.err["b"]["c"]) == 0


def test_compressed_psum_one_rank_is_the_codec():
    """At one rank (no group) the mean is the decoded leaf itself."""
    g = {"w": torch.randn(8, 4, generator=torch.Generator().manual_seed(1))}
    st = T.CompressionState.init(g)
    red, st2 = T.compressed_psum(g, st, None, "int8")
    q, scale, err = T.int8_encode(g["w"], st.err["w"])
    np.testing.assert_array_equal(red["w"].numpy(),
                                  (q.float() * scale).numpy())
    np.testing.assert_array_equal(st2.err["w"].numpy(), err.numpy())
    with pytest.raises(ValueError, match="codec"):
        T.compressed_psum(g, st, None, "fp8")


# --------------------------------------------------------------------------- #
# over gloo ranks, against the reference's formula
# --------------------------------------------------------------------------- #
@functools.cache
def leaves() -> dict:
    """The ranks' leaves (8 of each): the reference test's ``normal(8, 64,
    32) * 0.01``, a 0-d leaf and a bfloat16 leaf; and their dtypes."""
    rng = np.random.default_rng(3)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 64, 32))
                   * 0.01, np.float32)
    return ({"w": w, "s": rng.standard_normal(8).astype(np.float32),
             "b": _bf16(rng.standard_normal((8, 16, 8)))},
            {"w": "float32", "s": "float32", "b": "bfloat16"})


@functools.cache
def port(world: int) -> list:
    arrays, dtypes = leaves()
    spec = {"leaves": {k: v[:world] for k, v in arrays.items()},
            "dtypes": dtypes, "codecs": CODECS, "steps": STEPS}
    return mesh.spawn(W.compression_rank, world, "cpu", args=(spec,))


@functools.cache
def reference(world: int, codec: str) -> list:
    """The reference's encode functions on each rank's leaf and its
    reduction formula, evaluated in one process: each step's reduced
    leaves and every rank's residuals (numpy)."""
    arrays, dtypes = leaves()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    gs = {k: [jnp.asarray(v[r], jdt[dtypes[k]]) for r in range(world)]
          for k, v in arrays.items()}
    errs = {k: [jnp.zeros(g[0].shape, jnp.float32)] * world
            for k, g in gs.items()}
    n, steps = world, []
    for _ in range(STEPS):
        red, new = {}, {}
        for k, g in gs.items():
            if codec == "none" or g[0].ndim == 0:
                red[k] = sum(g) / n
                new[k] = [jnp.zeros(g[0].shape, jnp.float32)] * n
            elif codec == "int8":
                enc = [J.int8_encode(g[r], errs[k][r]) for r in range(n)]
                total = sum(q.astype(jnp.int32) for q, _, _ in enc)
                scale_sum = sum(s for _, s, _ in enc)
                red[k] = (total.astype(jnp.float32) * (scale_sum / n) / n
                          ).astype(g[0].dtype)
                new[k] = [e for _, _, e in enc]
            else:
                enc = [J.topk_encode(g[r], errs[k][r]) for r in range(n)]
                red[k] = (sum(s for s, _ in enc) / n).astype(g[0].dtype)
                new[k] = [e for _, e in enc]
        errs = new
        steps.append({"reduced": {k: _np(v) for k, v in red.items()},
                      "err": {k: [np.asarray(e) for e in v]
                              for k, v in new.items()}})
    return steps


def bf16_sum_bound(world: int, codec: str) -> np.ndarray:
    """How far two bfloat16 sums of the ranks' leaf ``b`` in other orders
    may part, divided by the ranks: each of the n - 1 additions rounds a
    partial sum of at most n max|b| by half a bfloat16 ulp (2^-9 of it) on
    each side.  ``int8`` and ``topk`` sum in float32 and round once, to the
    result's ulp."""
    if codec != "none":
        return np.zeros(())
    b = np.abs(leaves()[0]["b"][:world]).max(axis=0)
    return 2 * (world - 1) * 2.0 ** -9 * b


CASES = [(w, c) for w in WORLDS for c in CODECS]
IDS = [f"p{w}-{c}" for w, c in CASES]


@pytest.mark.parametrize("world,codec", CASES, ids=IDS)
def test_compressed_psum_matches_reference_formula(world, codec):
    """Every rank's mean of every leaf, over two steps, against the
    reference's arithmetic; the dtypes kept (the leaf's, float32
    residuals); the residuals bit-equal to the reference's, rank by
    rank."""
    ranks, want = port(world), reference(world, codec)
    for rank, mine in enumerate(ranks):
        for got, ref in zip(mine[codec], want):
            assert got["dtypes"] == {"w": "torch.float32",
                                     "s": "torch.float32",
                                     "b": "torch.bfloat16"}
            assert set(got["err_dtypes"].values()) == {"torch.float32"}
            for k in ("w", "s"):
                np.testing.assert_allclose(got["reduced"][k],
                                           ref["reduced"][k], rtol=0,
                                           atol=1e-6, err_msg=k)
            diff = np.abs(got["reduced"]["b"] - ref["reduced"]["b"])
            assert np.all(diff <= BF16_ULP * np.abs(ref["reduced"]["b"])
                          + bf16_sum_bound(world, codec)), diff.max()
            for k in ("w", "s", "b"):
                np.testing.assert_array_equal(got["err"][k],
                                              ref["err"][k][rank],
                                              err_msg=k)


@pytest.mark.parametrize("world,codec", [(w, c) for w in (4, 8)
                                         for c in CODECS],
                         ids=[f"p{w}-{c}" for w in (4, 8) for c in CODECS])
def test_compressed_psum_within_reference_tolerance_of_mean(world, codec):
    """The first step's float32 leaf against the exact mean of the ranks'
    inputs, within the reference test's tolerance."""
    exact = leaves()[0]["w"][:world].mean(axis=0)
    for rank in port(world):
        err = np.abs(rank[codec][0]["reduced"]["w"] - exact).max()
        assert err < EXACT_TOL[codec], (codec, err)


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_zero_d_leaf_is_the_plain_mean(world):
    """A 0-d leaf takes the plain mean under every codec, with a zero
    residual."""
    s = leaves()[0]["s"][:world]
    for rank in port(world):
        for codec in CODECS:
            for step in rank[codec]:
                np.testing.assert_allclose(step["reduced"]["s"], s.mean(),
                                           rtol=1e-6)
                assert step["err"]["s"] == 0
