"""JAX scan kernel vs the NumPy oracle on random alignments."""

import numpy as np
import pytest

from uvaia_tpu.core.encoding import DECODE_LUT, encode
from uvaia_tpu.core import oracle
from uvaia_tpu.engine.query import QueryPack
from uvaia_tpu.ops import scan

ALPHABET = np.array([ord(c) for c in "ACGTACGTACGTACGTN-RYMKSWBDHV"],
                    dtype=np.uint8)


def random_alignment(rng, n, L, mut=0.02):
    """Aligned sequences: shared backbone + sprinkled mutations/Ns/ambigs."""
    backbone = ALPHABET[rng.integers(0, 4, size=L)]
    seqs = np.tile(backbone, (n, 1))
    mask = rng.random((n, L)) < mut
    seqs[mask] = ALPHABET[rng.integers(0, len(ALPHABET), size=mask.sum())]
    return seqs


def make_pack(rng, n_query=7, L=600, acgt=False, trim=0):
    qseqs = random_alignment(rng, n_query, L)
    names = [f"q{i}" for i in range(n_query)]
    codes = np.stack([encode(s) for s in qseqs])
    pack = QueryPack(names=names, codes=codes, acgt=acgt, trim=trim)
    pack.create_indices()
    return pack


@pytest.mark.parametrize("acgt", [False, True])
@pytest.mark.parametrize("trim", [0, 13])
def test_scores_match_oracle(acgt, trim):
    rng = np.random.default_rng(7 + trim)
    L = 600
    pack = make_pack(rng, n_query=6, L=L, acgt=acgt, trim=trim)
    refs = random_alignment(rng, 23, L)
    ref_codes = np.stack([encode(r) for r in refs])
    ref_valid = (ref_codes != 0).sum(axis=1)

    ora_scores, _ = oracle.nearest_oracle(
        ref_codes, ref_valid, pack.codes, pack.consensus,
        pack.idx_c, pack.idx_m, pack.idx, k=5, acgt=acgt)

    qd = scan.build_device_data(pack, k=5)
    import jax.numpy as jnp
    jax_scores, _ = scan.score_batch(qd, jnp.asarray(ref_codes))
    np.testing.assert_array_equal(np.asarray(jax_scores), ora_scores)


@pytest.mark.parametrize("acgt", [False, True])
def test_streamed_topk_matches_oracle(acgt):
    """Multiple merge steps over batches == oracle global top-k."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    L = 400
    k = 6
    pack = make_pack(rng, n_query=5, L=L, acgt=acgt)
    refs = random_alignment(rng, 50, L)
    ref_codes = np.stack([encode(r) for r in refs])
    ref_valid = (ref_codes != 0).sum(axis=1)

    ora_scores, ora_topk = oracle.nearest_oracle(
        ref_codes, ref_valid, pack.codes, pack.consensus,
        pack.idx_c, pack.idx_m, pack.idx, k=k, acgt=acgt)

    qd = scan.build_device_data(pack, k=k)
    state = scan.init_state(pack.n_query, k)
    B = 16  # batches of 16, last one padded
    flags_all = []
    for start in range(0, 64, B):
        batch = np.zeros((B, L), dtype=np.uint8)
        n = max(0, min(B, 50 - start))
        ok = np.zeros(B, dtype=bool)
        if n:
            batch[:n] = ref_codes[start:start + n]
            ok[:n] = True
        state, flags = scan.scan_step(qd, state, jnp.asarray(batch),
                                      jnp.asarray(ok), np.int32(start))
        flags_all.append(np.asarray(flags)[:n])

    topk_idx = np.asarray(state[1])
    topk_scores = np.asarray(state[0])
    np.testing.assert_array_equal(topk_idx, ora_topk)
    for q in range(pack.n_query):
        np.testing.assert_array_equal(
            topk_scores[q], ora_scores[ora_topk[q], q, :])
    # every final top-k member must have been flagged for the dump
    flags_all = np.concatenate(flags_all)
    assert all(flags_all[i] for i in np.unique(topk_idx))


def test_decode_roundtrip():
    s = b"ACGTRYSWKMBDHVN-"
    out = DECODE_LUT[encode(s)].tobytes()
    assert out == b"ACGTRYSWKMBDHVNN"


def test_pack_unpack_roundtrip():
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    for L in (10, 11, 256, 29903):
        codes = rng.integers(0, 15, (3, L)).astype(np.uint8)
        packed = scan.pack_codes(codes)
        out = np.asarray(scan.unpack_codes(jnp.asarray(packed), L))
        np.testing.assert_array_equal(out, codes)


# ----------------------------------------------------------------------
# sparse-delta uploads

def _delta_numpy_decode(pos, val, base):
    """Straight-line decoder for delta_encode's output contract,
    independent of the jax reconstruct path: paint codes 0-15, then
    apply the zero-run markers (16 starts a zero run; 32+c ends it at
    a site whose true code is c; no end -> run to row end)."""
    B, E = pos.shape
    L = base.shape[0]
    out = np.tile(base, (B, 1))
    for r in range(B):
        run_from = None
        for e in range(E):
            p = int(pos[r, e])
            if p >= L:
                continue
            v = int(val[r, e])
            if v < 16:
                out[r, p] = v
            elif v < 32:
                run_from = p
            else:
                out[r, run_from:p] = 0
                out[r, p] = v - 32
                run_from = None
        if run_from is not None:
            out[r, run_from:] = 0
    return out


@pytest.mark.parametrize("use_native", [True, False])
def test_delta_encode_decodes_exactly(use_native, monkeypatch):
    """Encode -> independent numpy decode == original codes, with
    scattered diffs AND masked runs (leading, trailing, interior);
    native and python encoders must also agree byte for byte."""
    if not use_native:
        monkeypatch.setattr(scan, "_delta_lib", lambda: None)
    elif scan._delta_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    B, L = 37, 700
    base = rng.integers(0, 16, L).astype(np.uint8)
    codes = np.tile(base, (B, 1))
    mut = rng.random((B, L)) < 0.05
    codes[mut] = rng.integers(0, 16, mut.sum()).astype(np.uint8)
    for r in range(0, B, 3):        # masked runs, the real-data shape
        s = int(rng.integers(0, L - 80))
        codes[r, s:s + int(rng.integers(4, 80))] = 0
    codes[1, :43] = 0
    codes[2, L - 91:] = 0
    ok = np.ones(B, bool)
    ok[4] = False
    pos, val = scan.delta_encode(codes, ok, base)
    exp = codes.copy()
    exp[4] = base
    np.testing.assert_array_equal(_delta_numpy_decode(pos, val, base), exp)


def test_delta_encode_marker_entries_pinned():
    """The exact marker layout for a hand-built row: interior run ->
    (s, 16) + (e, 32+code), trailing run -> start only, short runs
    stay plain."""
    L = 64
    base = np.full(L, 1, np.uint8)
    row = base.copy()
    row[10:20] = 0                  # interior run, end code 1
    row[25] = 4                     # scattered SNP
    row[30:32] = 0                  # short run (2 plain zeros)
    row[58:] = 0                    # trailing run
    pos, val = scan.delta_encode(row[None, :], np.ones(1, bool), base)
    got = [(int(p), int(v)) for p, v in zip(pos[0], val[0]) if p < L]
    assert got == [(10, 16), (20, 32 + 1), (25, 4), (30, 0), (31, 0),
                   (58, 16)]


def test_delta_encode_overflow_returns_none():
    rng = np.random.default_rng(4)
    B, L = 4, 9000
    base = rng.integers(0, 16, L).astype(np.uint8)
    codes = rng.integers(0, 16, (B, L)).astype(np.uint8)  # ~94% diff
    assert scan.delta_encode(codes, np.ones(B, bool), base) is None


def test_scan_step_delta_equals_dense():
    """Delta upload path == dense scan_step, bit for bit (top-k state,
    indices, is_best flags), including masked and heavily-gapped rows."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    L, Q, B, k = 700, 5, 24, 4
    pack = make_pack(rng, n_query=Q, L=L)
    qd = scan.build_device_data(pack, k=k)
    base = np.asarray(qd.delta_base)

    refs = random_alignment(rng, B, L, mut=0.1)
    ref_codes = np.stack([encode(r) for r in refs])
    ok = np.ones(B, bool)
    ok[-2:] = False
    ref_codes[-2:] = 0

    enc = scan.delta_encode(ref_codes, ok, base)
    assert enc is not None
    st = scan.init_state(Q, k)
    s_dense, f_dense = scan.scan_step(qd, st, jnp.asarray(ref_codes),
                                      jnp.asarray(ok), np.int32(3))
    st = scan.init_state(Q, k)
    s_delta, f_delta = scan.scan_step_delta(
        qd, st, jnp.asarray(enc[0]), jnp.asarray(enc[1]),
        jnp.asarray(ok), np.int32(3))
    np.testing.assert_array_equal(np.asarray(s_dense[0]),
                                  np.asarray(s_delta[0]))
    np.testing.assert_array_equal(np.asarray(s_dense[1]),
                                  np.asarray(s_delta[1]))
    np.testing.assert_array_equal(np.asarray(f_dense), np.asarray(f_delta))


def test_prune_and_hold_delta_equals_packed():
    import jax.numpy as jnp
    rng = np.random.default_rng(6)
    L, Q, B, k = 500, 4, 16, 3
    pack = make_pack(rng, n_query=Q, L=L)
    qd = scan.build_device_data(pack, k=k)
    scan.build_prune_data(qd, pack)
    base = np.asarray(qd.delta_base)
    refs = random_alignment(rng, B, L, mut=0.08)
    ref_codes = np.stack([encode(r) for r in refs])
    ok = np.ones(B, bool)

    # seed a non-trivial threshold state first
    st = scan.init_state(Q, k)
    st, _ = scan.scan_step(qd, st, jnp.asarray(ref_codes),
                           jnp.asarray(ok), np.int32(0))

    enc = scan.delta_encode(ref_codes, ok, base)
    sv_d, codes_d = scan.prune_and_hold_delta(
        qd, st, jnp.asarray(enc[0]), jnp.asarray(enc[1]), jnp.asarray(ok))
    sv_p, codes_p = scan.prune_and_hold(
        qd, st, jnp.asarray(scan.pack_codes(ref_codes)), jnp.asarray(ok))
    np.testing.assert_array_equal(np.asarray(sv_d), np.asarray(sv_p))
    np.testing.assert_array_equal(np.asarray(codes_d), np.asarray(codes_p))


def test_scan_steps_repeat_equals_step_loop():
    """The single-dispatch bench loop == a Python loop of scan_step
    with the same carry-tied byte perturbation applied host-side."""
    import jax.numpy as jnp
    rng = np.random.default_rng(23)
    L, Q, B, k, n_steps = 300, 4, 16, 3, 4
    pack = make_pack(rng, n_query=Q, L=L)
    qd = scan.build_device_data(pack, k=k)
    W = int(qd.q_full.shape[1])
    refs = random_alignment(rng, B, L, mut=0.05)
    ref_codes = np.asarray(scan._to_width(
        jnp.asarray(np.stack([encode(r) for r in refs])), W))
    ok = jnp.ones(B, bool)

    st_fused = scan.scan_steps_repeat(
        qd, scan.init_state(Q, k), jnp.asarray(ref_codes), ok,
        np.int32(0), n_steps)

    st = scan.init_state(Q, k)
    for i in range(n_steps):
        idx0 = int(np.asarray(st[1])[0, 0])
        ref = ref_codes.copy()
        ref[0, 0] = (idx0 & 0x7) | 1
        st, _ = scan.scan_step(qd, st, jnp.asarray(ref), ok,
                               np.int32(i * B))
    np.testing.assert_array_equal(np.asarray(st_fused[0]),
                                  np.asarray(st[0]))
    np.testing.assert_array_equal(np.asarray(st_fused[1]),
                                  np.asarray(st[1]))


@pytest.mark.parametrize("acgt", [False, True])
def test_merge_topk_plane_and_stacked_forms_agree(acgt):
    """merge_topk accepts the six-(B, Q)-plane tuple (scan_step's form)
    or a stacked (B, Q, 6) array (sharded/mesh callers): same state,
    same is_best flags, for both the window and full merge branches."""
    import jax.numpy as jnp
    rng = np.random.default_rng(23)
    L, k, B = 300, 4, 17
    pack = make_pack(rng, n_query=5, L=L, acgt=acgt)
    qd = scan.build_device_data(pack, k=k)
    refs = random_alignment(rng, B, L, mut=0.08)
    ref_codes = jnp.asarray(np.stack([encode(r) for r in refs]))
    ok = jnp.asarray(np.r_[np.ones(B - 2, bool), False, True])

    planes, _ = scan.score_batch_planes(qd, ref_codes)
    stacked = jnp.stack(planes, axis=-1)
    np.testing.assert_array_equal(
        np.asarray(scan.score_batch(qd, ref_codes)[0]),
        np.asarray(stacked))

    for state in (scan.init_state(pack.n_query, k),       # full merge
                  scan.scan_step(qd, scan.init_state(pack.n_query, k),
                                 ref_codes, ok, np.int32(0))[0]):
        st_p, best_p = scan.merge_topk(qd, state, planes, ok,
                                       jnp.int32(100))
        st_s, best_s = scan.merge_topk(qd, state, stacked, ok,
                                       jnp.int32(100))
        np.testing.assert_array_equal(np.asarray(best_p),
                                      np.asarray(best_s))
        np.testing.assert_array_equal(np.asarray(st_p[0]),
                                      np.asarray(st_s[0]))
        np.testing.assert_array_equal(np.asarray(st_p[1]),
                                      np.asarray(st_s[1]))


# ----------------------------------------------------------------------
# the XLA scatter rebuild and packed scoring at the full genome width

L_FULL = 29903


@pytest.mark.parametrize("case", ["markers_padded_width", "masked_rows"])
def test_reconstruct_delta_inverts_encode_full_width(case):
    """reconstruct_delta (one XLA scatter + the run-marker pass) inverts
    delta_encode at L=29 903: leading, trailing and interior N/'-' runs
    (run markers), scattered SNPs, rows with ok=False, and a target
    width padded to the scoring width.  The padding slots the scatter
    relies on are unique and out of range (unique_indices=True)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(41)
    B = 48
    base = ALPHABET[rng.integers(0, 4, L_FULL)]
    base = np.asarray(encode(base.tobytes()))
    codes = np.tile(base, (B, 1))
    snp = rng.random((B, L_FULL)) < 0.002
    codes[snp] = rng.integers(1, 16, snp.sum()).astype(np.uint8)
    for r in range(0, B, 2):
        codes[r, :int(rng.integers(1, 300))] = 0          # leading run
        codes[r, L_FULL - int(rng.integers(1, 300)):] = 0  # trailing run
        s = int(rng.integers(0, L_FULL - 600))
        codes[r, s:s + int(rng.integers(4, 600))] = 0      # dropout
    ok = np.ones(B, bool)
    if case == "masked_rows":
        ok[[3, 17, B - 1]] = False
    width = 30720 if case == "markers_padded_width" else None

    pos, val = scan.delta_encode(codes, ok, base)
    assert (val >= 16).any()                      # run markers in use
    for r in range(B):
        real = pos[r] < L_FULL
        n = int(real.sum())
        assert real[:n].all()                     # entries first ...
        assert (np.diff(pos[r].astype(np.int64)) > 0).all()  # ... unique
        assert (pos[r, n:] >= L_FULL).all()       # pads out of range

    got = np.asarray(scan.reconstruct_delta(
        jnp.asarray(base), jnp.asarray(pos), jnp.asarray(val), width))
    exp = np.where(ok[:, None], codes, base[None, :])
    if width is not None:
        assert got.shape == (B, width)
        assert not got[:, L_FULL:].any()
        got = got[:, :L_FULL]
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("acgt", [False, True])
@pytest.mark.parametrize("n_query", [6, 100])
def test_packed_scoring_equals_unpacked_and_oracle(acgt, n_query):
    """score_batch_planes_packed (4-bit upload, unpacked on device) ==
    score_batch_planes on the codes == the oracle, at an odd width."""
    import jax.numpy as jnp
    rng = np.random.default_rng(50 + n_query)
    L = 601
    pack = make_pack(rng, n_query=n_query, L=L, acgt=acgt)
    refs = random_alignment(rng, 19, L, mut=0.05)
    ref_codes = np.stack([encode(r) for r in refs])
    qd = scan.build_device_data(pack, k=4)

    planes_p, valid_p = scan.score_batch_planes_packed(
        qd, jnp.asarray(scan.pack_codes(ref_codes)))
    planes_u, valid_u = scan.score_batch_planes(qd, jnp.asarray(ref_codes))
    for a, b in zip(planes_p, planes_u):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(valid_p), np.asarray(valid_u))

    ora, _ = oracle.nearest_oracle(
        ref_codes, (ref_codes != 0).sum(axis=1), pack.codes,
        pack.consensus, pack.idx_c, pack.idx_m, pack.idx, k=4, acgt=acgt)
    np.testing.assert_array_equal(
        np.stack([np.asarray(p) for p in planes_p], axis=-1), ora)


def test_ambiguity_correction_equals_weight_tables():
    """Full mode: the XLA one-hot correction adds, for each pair, the
    sum over the query-ambiguous sites of w_text / w_part looked up at
    the reference's code there — checked against a NumPy table lookup
    by scoring once with and once without the correction."""
    import dataclasses
    import jax.numpy as jnp
    rng = np.random.default_rng(61)
    L = 500
    pack = make_pack(rng, n_query=9, L=L)
    refs = random_alignment(rng, 21, L, mut=0.1)
    ref_codes = np.stack([encode(r) for r in refs])
    qd = scan.build_device_data(pack, k=3)
    assert qd.amb_sites is not None
    bare = dataclasses.replace(qd, amb_sites=None, w_text=None, w_part=None)

    with_c = scan.score_batch_planes(qd, jnp.asarray(ref_codes))[0]
    without = scan.score_batch_planes(bare, jnp.asarray(ref_codes))[0]
    sites = np.asarray(qd.amb_sites)
    real = sites < L
    ra = np.zeros((ref_codes.shape[0], len(sites)), np.int64)
    ra[:, real] = ref_codes[:, sites[real]]
    w_text = np.asarray(qd.w_text).astype(np.int64)     # (Q, A, 16)
    w_part = np.asarray(qd.w_part).astype(np.int64)
    a_idx = np.arange(len(sites))
    exp_t = w_text[:, a_idx[None, :], ra].sum(-1).T      # (B, Q)
    exp_p = w_part[:, a_idx[None, :], ra].sum(-1).T
    assert exp_t.any() and exp_p.any()
    np.testing.assert_array_equal(
        np.asarray(with_c[1]) - np.asarray(without[1]), exp_t)
    np.testing.assert_array_equal(
        np.asarray(with_c[2]) - np.asarray(without[2]), exp_p)
    for i in (0, 3, 4, 5):
        np.testing.assert_array_equal(np.asarray(with_c[i]),
                                      np.asarray(without[i]))
