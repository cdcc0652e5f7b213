"""ops/distance kernels vs the NumPy oracle."""

import numpy as np
import pytest

from uvaia_tpu.core.encoding import encode
from uvaia_tpu.core import oracle
from uvaia_tpu.ops import distance as dist_ops

from test_scan import random_alignment


@pytest.mark.parametrize("acgt", [False, True])
def test_pair_mismatches(acgt):
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    refs = np.stack([encode(s) for s in random_alignment(rng, 12, 200, 0.1)])
    qs = np.stack([encode(s) for s in random_alignment(rng, 5, 200, 0.1)])
    w = dist_ops.mismatch_weights(qs, acgt)
    got = np.asarray(dist_ops.pair_mismatches(jnp.asarray(refs),
                                              jnp.asarray(w)))
    fn = oracle.pair_mismatch_acgt if acgt else oracle.pair_hamming_indelcheck
    for b in range(refs.shape[0]):
        for q in range(qs.shape[0]):
            assert got[b, q] == fn(qs[q], refs[b])


@pytest.mark.parametrize("acgt", [False, True])
def test_cons_mismatches(acgt):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    refs = np.stack([encode(s) for s in random_alignment(rng, 9, 300, 0.08)])
    cons = encode(random_alignment(rng, 1, 300, 0.08)[0])
    sites = np.arange(300, dtype=np.int32)
    got = np.asarray(dist_ops.cons_mismatches(
        jnp.asarray(refs), jnp.asarray(sites), jnp.asarray(cons), acgt))
    fn = oracle.pair_mismatch_acgt if acgt else oracle.pair_hamming_indelcheck
    for b in range(9):
        assert got[b] == fn(cons, refs[b])


def test_legacy_scores_vs_oracle():
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    refs = np.stack([encode(s) for s in random_alignment(rng, 7, 250, 0.1)])
    qs = np.stack([encode(s) for s in random_alignment(rng, 3, 250, 0.1)])
    qdata = dist_ops.build_legacy_query_data(qs, trim=0)
    got = np.asarray(dist_ops.legacy_scores(qdata, jnp.asarray(refs)))
    for b in range(7):
        for q in range(3):
            a, t, p, v = oracle.pair_counters(qs[q], refs[b])
            w = sum(oracle.partial_weight(int(c1), int(c2))
                    for c1, c2 in zip(qs[q], refs[b]))
            assert got[b, q, 0] == a
            assert got[b, q, 1] == t
            np.testing.assert_allclose(got[b, q, 2], w, atol=1e-3)
            assert got[b, q, 3] == v


def test_partial_weight_recoverable_entries():
    """Pin the weighted-partial entries that ARE recoverable from the
    reference snapshot (src/utils.c:73 comment + README.md:307-330):
    pure matches weigh 1, pure mismatches 0, T vs W = 0.5, N/gap sites
    contribute nothing.  Entries between two ambiguity codes (e.g.
    M vs R) are this implementation's |∩|/(|s1|·|s2|) choice —
    biomcmc-lib's exact table is not recoverable; those values are
    conjecture and asserted only as "documented behaviour"."""
    import jax.numpy as jnp
    from uvaia_tpu.core.encoding import ENCODE_LUT

    c = lambda ch: int(ENCODE_LUT[ord(ch)])
    # recoverable entries
    assert oracle.partial_weight(c("T"), c("T")) == 1.0
    assert oracle.partial_weight(c("A"), c("C")) == 0.0
    assert oracle.partial_weight(c("T"), c("W")) == 0.5   # utils.c:73
    assert oracle.partial_weight(c("W"), c("T")) == 0.5   # symmetric
    assert oracle.partial_weight(c("M"), c("A")) == 0.5   # M={A,C}
    assert oracle.partial_weight(c("K"), c("A")) == 0.0   # K={G,T}
    assert oracle.partial_weight(0, c("T")) == 0.0        # N/gap
    assert oracle.partial_weight(c("T"), 0) == 0.0
    # conjecture entries (documented implementation choice, not parity)
    assert oracle.partial_weight(c("M"), c("R")) == 0.25
    assert oracle.partial_weight(c("W"), c("W")) == 0.5

    # and the device kernel agrees site-by-site on a crafted pair
    qs = np.array([[c("T"), c("T"), c("T"), 0, c("A"), c("M")]],
                  dtype=np.uint8)
    rf = np.array([[c("T"), c("A"), c("W"), c("T"), 0, c("R")]],
                  dtype=np.uint8)
    qdata = dist_ops.build_legacy_query_data(qs, trim=0)
    got = np.asarray(dist_ops.legacy_scores(qdata, jnp.asarray(rf)))[0, 0]
    assert got[0] == 1                      # acgt: only T-T
    assert got[1] == 1                      # text: only T-T
    np.testing.assert_allclose(got[2], 1 + 0 + 0.5 + 0.25, atol=1e-4)
    assert got[3] == 4                      # valid pairs


def test_legacy_scores_trim():
    import jax.numpy as jnp
    rng = np.random.default_rng(6)
    refs = np.stack([encode(s) for s in random_alignment(rng, 4, 100, 0.1)])
    qs = np.stack([encode(s) for s in random_alignment(rng, 2, 100, 0.1)])
    t = 20
    qdata = dist_ops.build_legacy_query_data(qs, trim=t)
    got = np.asarray(dist_ops.legacy_scores(qdata, jnp.asarray(refs)))
    for b in range(4):
        for q in range(2):
            a, _, _, v = oracle.pair_counters(qs[q][t:-t], refs[b][t:-t])
            assert got[b, q, 0] == a
            assert got[b, q, 3] == v


@pytest.mark.parametrize("rule", ["product", "jaccard", "max"])
def test_legacy_scores_partial_rule_variants(rule):
    """Every selectable amb-vs-amb table (LegacyConfig.partial_rule)
    matches the per-pair spec oracle.partial_weight(rule); the other
    three counters are rule-independent."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    refs = np.stack([encode(s) for s in random_alignment(rng, 6, 300, 0.2)])
    qs = np.stack([encode(s) for s in random_alignment(rng, 4, 300, 0.2)])
    base = np.asarray(dist_ops.legacy_scores(
        dist_ops.build_legacy_query_data(qs, trim=0), jnp.asarray(refs)))
    qdata = dist_ops.build_legacy_query_data(qs, trim=0,
                                             partial_rule=rule)
    got = np.asarray(dist_ops.legacy_scores(qdata, jnp.asarray(refs)))
    np.testing.assert_array_equal(got[..., 0], base[..., 0])
    np.testing.assert_array_equal(got[..., 1], base[..., 1])
    np.testing.assert_array_equal(got[..., 3], base[..., 3])
    for b in range(refs.shape[0]):
        for q in range(qs.shape[0]):
            w = sum(oracle.partial_weight(int(c1), int(c2), rule)
                    for c1, c2 in zip(qs[q], refs[b]))
            np.testing.assert_allclose(got[b, q, 2], w, atol=1e-3)
    with pytest.raises(ValueError):
        dist_ops.build_legacy_query_data(qs, trim=0, partial_rule="bogus")
    with pytest.raises(ValueError):
        oracle.partial_weight(1, 8, rule="jacard")   # typo must not
        # silently fall through to the product rule (review r5)


def test_legacy_weighted_partial_float64_pin():
    """legacy_scores' weighted partial at the full genome width, against
    a float64 NumPy sum of the same |a ∩ b| / (|a|·|b|) site weights.

    rtol 2e-6 covers float32 accumulation of <= 29 903 terms at full
    float32 precision (the dot_general asks for Precision.HIGHEST).  A
    TF32 product (10-bit mantissa, the GPU's default for float32
    matmuls) rounds every 1/3 weight and misses by ~1e-4 relative."""
    import jax.numpy as jnp
    from uvaia_tpu.core.encoding import POPCOUNT4
    rng = np.random.default_rng(8)
    L = 29903
    alphabet = np.frombuffer(b"ACGTACGTACGTRYMKSWBDHVN-", np.uint8)
    refs = np.stack([encode(alphabet[rng.integers(0, len(alphabet), L)])
                     for _ in range(5)])
    qs = np.stack([encode(alphabet[rng.integers(0, len(alphabet), L)])
                   for _ in range(3)])
    qdata = dist_ops.build_legacy_query_data(qs, trim=0)
    got = np.asarray(dist_ops.legacy_scores(qdata, jnp.asarray(refs)))[..., 2]

    def frac(c):
        bits = ((c[..., None] >> np.arange(4)) & 1).astype(np.float64)
        return bits / np.maximum(POPCOUNT4[c], 1)[..., None]
    want = np.einsum("bls,qls->bq", frac(refs), frac(qs))
    assert want.min() > 1000
    np.testing.assert_allclose(got, want, rtol=2e-6)
