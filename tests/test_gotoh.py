"""Banded Gotoh kernel vs a dense O(nm) NumPy affine-gap oracle."""

import numpy as np
import pytest

from uvaia_tpu.ops import gotoh

X, O, E = gotoh.MISMATCH, gotoh.GAP_OPEN, gotoh.GAP_EXT
BIG = 10**9


def oracle_score(ref: bytes, q: bytes) -> int:
    """Optimal global affine-gap cost (match 0, mismatch 4, gap 6+2g)."""
    n, m = len(ref), len(q)
    M = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    Dx = np.full_like(M, BIG)   # gap consuming ref (deletion)
    Iy = np.full_like(M, BIG)   # gap consuming query (insertion)
    M[0, 0] = 0
    for j in range(1, m + 1):
        Iy[0, j] = O + E * j
    for i in range(1, n + 1):
        Dx[i, 0] = O + E * i
    H = lambda i, j: min(M[i, j], Dx[i, j], Iy[i, j])
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = 0 if ref[i - 1] == q[j - 1] else X
            M[i, j] = H(i - 1, j - 1) + sub
            Dx[i, j] = min(H(i - 1, j) + O + E, Dx[i - 1, j] + E)
            Iy[i, j] = min(H(i, j - 1) + O + E, Iy[i, j - 1] + E)
    return int(H(n, m))


def run(ref: bytes, qs: list[bytes], lo=-32, width=65):
    n = len(ref)
    m_pad = max(len(q) for q in qs)
    arr = np.zeros((len(qs), m_pad), dtype=np.uint8)
    lens = np.zeros(len(qs), dtype=np.int32)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, dtype=np.uint8)
        lens[b] = len(q)
    return gotoh.align_batch(np.frombuffer(ref, dtype=np.uint8), arr,
                             lens, lo, width)[:3]


def test_identity_and_snp():
    ref = b"ACGTACGTACGTACGTACGT"
    aligned, score, ok = run(ref, [ref, b"ACGTACGTACGTACGTACGA"])
    assert ok.all()
    assert score[0] == 0 and bytes(aligned[0]) == ref
    assert score[1] == X
    assert bytes(aligned[1]) == b"ACGTACGTACGTACGTACGA"


def test_deletion_and_insertion():
    ref = b"ACGTACGTACGTACGTACGT"
    # query missing 3 bases -> '-' run in output
    q_del = b"ACGTACGTACGTACGT"            # drop 4
    # query with 2 extra bases -> insertions dropped from projection
    q_ins = b"ACGTACGGGGTACGTACGTACGT"[:22]
    aligned, score, ok = run(ref, [q_del, q_ins])
    assert ok.all()
    assert score[0] == oracle_score(ref, q_del)
    assert score[1] == oracle_score(ref, q_ins)
    assert aligned[0].shape[0] == len(ref)
    assert bytes(aligned[0]).count(b"-") == 4
    # projected output is always exactly ref length
    assert aligned.shape[1] == len(ref)


def rand_dna(rng, n):
    return b"ACGT" * 0 + bytes(bytearray(
        b"ACGT"[int(i)] for i in rng.integers(0, 4, n)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 80
    ref = rand_dna(rng, n)
    qs = []
    for _ in range(8):
        q = bytearray(ref)
        # SNPs
        for _ in range(rng.integers(0, 6)):
            q[rng.integers(0, len(q))] = b"ACGT"[int(rng.integers(0, 4))]
        # one indel up to 5
        if rng.random() < 0.7:
            p = int(rng.integers(0, len(q) - 6))
            ln = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                del q[p:p + ln]
            else:
                q[p:p] = rand_dna(rng, ln)
        qs.append(bytes(q))
    aligned, score, ok = run(ref, qs)
    assert ok.all()
    for b, q in enumerate(qs):
        assert score[b] == oracle_score(ref, q), f"query {b}"


def test_band_escape_flagged():
    ref = b"ACGTACGTACGTACGTACGTACGTACGTACGT"
    # 20-base deletion needs |d|=20 > band 8 -> must be flagged not-ok
    q = ref[:6] + ref[26:]
    aligned, score, ok = run(ref, [q], lo=-8, width=17)
    assert not ok[0]
    # a band with certificate margin fixes it and matches the oracle
    aligned, score, ok = run(ref, [q], lo=-48, width=97)
    assert ok[0] and score[0] == oracle_score(ref, q)


def test_walk_cost_guards_output():
    """ok requires the walked path cost to equal the DP score."""
    ref = b"ACGTACGTACGTACGTACGT"
    _, score, ok = run(ref, [b"ACGTACGTACGTACGTACGT"])
    assert ok.all() and score[0] == 0



def test_certificate_edge_min():
    """Sound band certificate: a band excluding the optimum must not
    certify; a band containing it with any margin certifies, even when
    the margin is tiny (the edge-diagonal minimum is what matters, not
    band width)."""
    ref = b"ACGT" * 30
    q = ref[:40] + ref[52:]          # 12-base deletion, cost 6+24=30
    exp = oracle_score(ref, q)
    assert exp == 30
    # optimum at d=-12 sits inside lo=-14 with margin 2: certified
    _, score, ok = run(ref, [q], lo=-14, width=29)
    assert ok[0] and score[0] == exp
    # band that cannot reach d=-12: must not certify
    _, score, ok = run(ref, [q], lo=-8, width=17)
    assert not ok[0]


def test_align_rows_events_equal_dense_walk():
    """The events aligner (align_rows + host decode_events) and the
    dense-walk fallback (align_rows_dense) give the same score, the
    same certificate inputs and the same projected row, for SNPs,
    indels and an N run."""
    import jax.numpy as jnp
    rng = np.random.default_rng(17)
    n = 400
    ref = np.frombuffer(rand_dna(rng, n), np.uint8)
    qs = []
    for b in range(12):
        q = bytearray(ref.tobytes())
        for _ in range(int(rng.integers(0, 8))):
            q[int(rng.integers(0, len(q)))] = b"ACGT"[int(rng.integers(0, 4))]
        if b % 3 == 0:
            p = int(rng.integers(0, len(q) - 30))
            q[p:p + 25] = b"N" * 25
        p = int(rng.integers(0, len(q) - 12))
        ln = int(rng.integers(1, 11))
        if b % 2:
            del q[p:p + ln]
        else:
            q[p:p] = rand_dna(rng, ln)
        qs.append(bytes(q))
    B = 16
    arr = np.zeros((B, max(map(len, qs))), np.uint8)
    lens = np.zeros(B, np.int32)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
        lens[b] = len(q)
    idx = jnp.arange(B, dtype=jnp.int32)
    lo, width, E = -32, 65, 64
    args = (jnp.asarray(ref), jnp.asarray(arr), jnp.asarray(lens), idx)

    meta = np.asarray(gotoh.align_rows(*args, lo, width, gotoh.EV_CAP))
    score, edge_min, done, cnt, ovf, t_end, ev_i, ev_t = \
        gotoh.unpack_meta_events(meta, gotoh.EV_CAP)
    meta_d, aligned_d = gotoh.align_rows_dense(*args, lo, width, E)
    d_score, d_edge, d_done, d_cost = gotoh.unpack_meta(
        np.asarray(meta_d), E)[:4]
    aligned_d = np.asarray(aligned_d)

    np.testing.assert_array_equal(score, d_score)
    np.testing.assert_array_equal(edge_min, d_edge)
    np.testing.assert_array_equal(done, d_done)
    for b, q in enumerate(qs):
        assert done[b] and not ovf[b]
        row, cost = gotoh.decode_events(
            np.frombuffer(q, np.uint8), ref, int(t_end[b]), lo,
            ev_i[b], ev_t[b], int(cnt[b]))
        assert cost == d_cost[b] == score[b] == oracle_score(ref.tobytes(), q)
        assert row.tobytes() == aligned_d[b, :n].tobytes()
