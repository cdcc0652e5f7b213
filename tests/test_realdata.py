"""BASELINE config-1 behavioural gate on the bundled real data.

``uvaia nearest`` top-k=8 with --exclude_self over the 9 185-genome
SARS-CoV-2 database (/root/reference/data/03.unique_acgt.aln.xz,
data/README.md:1-8) with the manuscript's 1 000-name query subset
(04.sample_1_1k.names, data/README.md:17-20).  The ranked CSV must be
byte-identical — pinned by SHA256 — across the dense, pruned,
sharded-virtual-mesh and crash-resumed execution paths.

Each run takes ~5-10 min on one CPU core; the tests are opt-in:

    python -m pytest -m realdata tests/test_realdata.py
"""

import hashlib
import lzma
import os

import numpy as np
import pytest

from uvaia_tpu.engine.nearest import NearestConfig, run_nearest
from uvaia_tpu.io.fasta import read_fasta

DATA = "/root/reference/data"
DB = f"{DATA}/03.unique_acgt.aln.xz"
NAMES = f"{DATA}/04.sample_1_1k.names"

# SHA256 of the decompressed gate CSV (8 001 lines: header + 1000 x 8),
# produced by: nbest=8, exclude_self=True, full (non-acgt) mode, trim=0.
GOLDEN_CSV_SHA256 = \
    "99c10323024f1002a69b0f5c51f331b618a76b6ff2f67946a9e685fb657eeba1"

pytestmark = [
    pytest.mark.realdata,
    pytest.mark.skipif(not os.path.exists(DB),
                       reason="bundled reference data not present"),
]


@pytest.fixture(scope="session")
def q1k(tmp_path_factory):
    """The 1 000-sequence query subset extracted from the database."""
    names = set(open(NAMES).read().split())
    path = tmp_path_factory.mktemp("realdata") / "q1k.fa"
    n = 0
    with open(path, "w") as f:
        for rec in read_fasta(DB):
            if rec.name in names:
                f.write(f">{rec.name}\n{rec.seq.decode()}\n")
                n += 1
    assert n == 1000
    return str(path)


def _csv_sha(prefix: str) -> str:
    csv = lzma.open(prefix + ".csv.xz", "rb").read()
    assert csv.count(b"\n") == 8001
    return hashlib.sha256(csv).hexdigest()


def _cfg(out: str, **kw) -> NearestConfig:
    return NearestConfig(nbest=8, exclude_self=True, output=out, **kw)


def test_gate_pruned(q1k, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate"))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256


def test_gate_dense(q1k, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate", prune=False))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256


def test_gate_indexed_store(q1k, tmp_path, monkeypatch):
    """Ingest the real database into a persistent store (io/store.py)
    and scan THAT: the decode-free indexed path must reproduce the
    pinned config-1 CSV byte-for-byte."""
    from uvaia_tpu.io.store import ingest, verify

    monkeypatch.chdir(tmp_path)
    ingest([DB], "db.uvst")
    rep = verify("db.uvst")
    assert rep["ok"] and rep["unknown"] == 0, rep
    run_nearest(["db.uvst"], q1k, _cfg("gate"))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256


def test_gate_sharded_virtual_mesh(q1k, tmp_path, monkeypatch):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate", n_devices=8, site_shards=2))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256


def test_gate_resumed(q1k, tmp_path, monkeypatch):
    """Crash mid-scan at a checkpoint boundary, resume, same CSV."""
    monkeypatch.chdir(tmp_path)
    import uvaia_tpu.engine.nearest as nearest_mod

    class _Boom(RuntimeError):
        pass

    count = {"n": 0}
    orig = nearest_mod.scan.flush_survivors

    def crashing(*a, **kw):
        if count["n"] >= 1:
            raise _Boom("simulated crash")
        count["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(nearest_mod.scan, "flush_survivors", crashing)
    with pytest.raises(_Boom):
        run_nearest([DB], q1k, _cfg("gate", checkpoint="scan.ckpt",
                                    checkpoint_every=0.0))
    monkeypatch.setattr(nearest_mod.scan, "flush_survivors", orig)
    assert os.path.exists("scan.ckpt")
    run_nearest([DB], q1k, _cfg("gate", checkpoint="scan.ckpt",
                                checkpoint_every=1e9))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256


# SHA256 of the decompressed --acgt gate CSV (8 001 lines), same run
# configuration in acgt mode; every backend must reproduce it
# bit-for-bit.  Protects the s4/s5 dist-column
# split semantics (nearest.c:443-477 accumulation order).
GOLDEN_ACGT_CSV_SHA256 = \
    "37389a680a2871036878cde85b88a9f97a1326e5f53dd9b8cd48fecbef4f72d6"


def test_gate_oracle_corroboration(q1k, tmp_path, monkeypatch):
    """Independent derivation of the config-1 golden: compute the
    top-k=8 rows for a 64-query subsample against the FULL database
    using ONLY core/oracle.py + numpy — no ops/, no engine scoring —
    and assert they match the engine CSV byte-for-byte.  This closes
    the self-reference loop of the SHA256 pins: two implementations
    (int8 matmul kernels vs the per-pair spec functions) agree on real
    data.  Semantics: data/README.md:1-20, README.md:254-330."""
    from uvaia_tpu.core import oracle
    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.query import build_query_pack

    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate"))
    assert _csv_sha("gate") == GOLDEN_CSV_SHA256
    engine_lines = lzma.open("gate.csv.xz", "rt").read().splitlines()

    # the same query pack the engine used (preparation, not scoring):
    # absolute match counts depend on the 1000-query consensus/index
    # decomposition (README.md:295-299), so the oracle must share it
    pack = build_query_pack(q1k)
    sel = list(range(0, pack.n_query, pack.n_query // 64))[:64]
    sel_names = {pack.names[i] for i in sel}

    # stream the database with pure IO, replicating only the stream's
    # bookkeeping (exclude_self name skip + min-valid QC,
    # stream.py:209-216 == nearest.c:255-270)
    L = pack.n_sites
    min_valid = int(L * (1.0 - 0.5))
    qset = set(pack.names)
    ref_names, ref_rows, ref_valid = [], [], []
    for rec in read_fasta(DB):
        if rec.name in qset:
            continue
        codes = ENCODE_LUT[np.frombuffer(rec.seq, dtype=np.uint8)]
        v = int(np.count_nonzero(codes))
        if v < min_valid:
            continue
        ref_names.append(rec.name)
        ref_rows.append(codes)
        ref_valid.append(v)
    R = len(ref_names)

    # per-pair spec scoring (oracle.six_scores_full) for the subsample
    idx_c, idx_mq = pack.idx_c, pack.idx_mq
    cons = pack.consensus
    scores = np.zeros((R, len(sel), 6), dtype=np.int64)
    for r in range(R):
        ref = ref_rows[r]
        for j, qi in enumerate(sel):
            scores[r, j] = oracle.six_scores_full(
                ref, pack.codes[qi], cons, idx_c, idx_mq, ref_valid[r])

    # rank + emit rows exactly as nearest.py:81-100 does
    oracle_rows = []
    for j, qi in enumerate(sel):
        top = oracle.rank_refs(scores[:, j, :], 8)
        for rank, r in enumerate(top, 1):
            oracle_rows.append(
                f"{pack.names[qi]},{ref_names[r]},{rank}," +
                ",".join(str(int(s)) for s in scores[r, j]))

    engine_rows = [ln for ln in engine_lines[1:]
                   if ln.split(",", 1)[0] in sel_names]
    assert engine_rows == oracle_rows


def site_class_oracle(seqs: list[bytes], trim: int, acgt: bool):
    """From-scratch re-derivation of create_query_indices semantics
    (fastaseq.c:732-777) in CHARACTER space with a distinct-count
    formulation — deliberately a different algorithm from
    QueryPack.create_indices (code-space min/max over ENCODE_LUT), so
    a bug in engine/query.py cannot corrupt both sides identically.

    C semantics: a site is *valid* for a query when its char is outside
    ``is_indel`` = {N,n,X,x,-,?,O,o,.} (full mode, utils.c:258-264) or
    inside ACGT (--acgt mode); consensus takes the unique valid char,
    '#' when two valid chars conflict, 'N' when no query is valid;
    miss[] marks sites where some query was invalid.  Classes:
    '#' -> idx, else miss -> idx_m, else idx_c.

    Returns (cons_char (L,) uint8 with 'N'/'#' markers, idx_c, idx_m,
    idx) over the [trim, L-trim) window."""
    arr = np.stack([np.frombuffer(s, dtype=np.uint8) for s in seqs])
    Q, L = arr.shape
    if acgt:
        valid = np.isin(arr, np.frombuffer(b"AaCcGgTt", np.uint8))
    else:
        valid = ~np.isin(arr, np.frombuffer(b"NnXx-?Oo.", np.uint8))
    miss = (~valid).any(axis=0)

    # distinct VALID chars per column via per-observed-value presence
    # planes (no min/max over an encoding — the engine's trick)
    observed = np.unique(arr)
    present = np.zeros((len(observed), L), dtype=bool)
    for k, v in enumerate(observed):
        present[k] = ((arr == v) & valid).any(axis=0)
    n_distinct = present.sum(axis=0)

    window = np.zeros(L, dtype=bool)
    window[trim:L - trim if trim else L] = True
    any_valid = n_distinct >= 1
    poly = n_distinct >= 2

    cons = np.full(L, ord("N"), dtype=np.uint8)
    one = window & any_valid & ~poly
    # the unique valid char of single-value columns
    cons[one] = observed[np.argmax(present[:, one], axis=0)]
    cons[window & poly] = ord("#")

    cols = np.nonzero(window & any_valid)[0].astype(np.int32)
    is_poly = poly[cols]
    is_miss = miss[cols]
    return (cons, cols[~is_poly & ~is_miss], cols[~is_poly & is_miss],
            cols[is_poly])


def assert_site_classes_match(pack, seqs_by_name: dict):
    """Compare pack.create_indices output against site_class_oracle on
    the pack's own (QC-surviving) sequence set."""
    from uvaia_tpu.core.encoding import ENCODE_LUT

    seqs = [seqs_by_name[n] for n in pack.names]
    cons, idx_c, idx_m, idx = site_class_oracle(seqs, pack.trim,
                                                pack.acgt)
    np.testing.assert_array_equal(pack.idx_c, idx_c)
    np.testing.assert_array_equal(pack.idx_m, idx_m)
    np.testing.assert_array_equal(pack.idx, idx)
    # consensus: engine stores the CODE at informative non-poly sites,
    # 0 elsewhere; the oracle holds the unique valid character there
    informative = np.zeros(pack.n_sites, dtype=bool)
    informative[idx_c] = True
    informative[idx_m] = True
    np.testing.assert_array_equal(pack.consensus[informative],
                                  ENCODE_LUT[cons[informative]])
    assert (pack.consensus[~informative] == 0).all()
    poly_mask = np.zeros(pack.n_sites, dtype=bool)
    poly_mask[idx] = True
    np.testing.assert_array_equal(pack.poly, poly_mask)


def test_gate_site_class_rederivation(q1k):
    """VERDICT r4 #3: the oracle corroborations reuse build_query_pack
    for consensus/site classes, so a create_indices bug would corrupt
    engine and oracle identically.  This gate closes that hole: an
    independent char-space re-derivation of the 1 000-query site-class
    decomposition must agree exactly — full AND --acgt modes."""
    from uvaia_tpu.engine.query import build_query_pack

    seqs_by_name = {rec.name: rec.seq for rec in read_fasta(q1k)}
    pack = build_query_pack(q1k)
    assert len(pack.idx_c) + len(pack.idx_m) + len(pack.idx) > 0
    assert_site_classes_match(pack, seqs_by_name)

    pack_a = build_query_pack(q1k, acgt=True)
    assert_site_classes_match(pack_a, seqs_by_name)


def test_gate_acgt_pruned(q1k, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate", acgt=True, prune=True))
    assert _csv_sha("gate") == GOLDEN_ACGT_CSV_SHA256


def test_gate_acgt_dense(q1k, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_nearest([DB], q1k, _cfg("gate", acgt=True, prune=False))
    assert _csv_sha("gate") == GOLDEN_ACGT_CSV_SHA256


def test_gate_ball_oracle_corroboration(q1k, tmp_path, monkeypatch):
    """Second-tool corroboration on real data: `ball` membership over
    the FULL database (64-query subset, radius 5) must equal an
    independent numpy re-derivation of the staged keep rule
    (seq_ball_against_query_structure, fastaseq.c:660-696, including
    the skipped-stage-3 quirk) using ONLY core/oracle.py pair
    functions — no ops/, no engine scoring.  Self-contained
    two-implementation check: no golden pin to maintain."""
    from test_tools import staged_ball_oracle

    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.ball import BallConfig, run_ball
    from uvaia_tpu.engine.query import build_query_pack

    monkeypatch.chdir(tmp_path)
    # 64-query subset file: ball's stage-3 min is over the WHOLE query
    # set, so the oracle must share the exact query set (a subsample
    # of a bigger run would not reproduce the min)
    q_recs = list(read_fasta(q1k))
    sel = q_recs[:: max(1, len(q_recs) // 64)][:64]
    with open("q64.fa", "w") as f:
        for rec in sel:
            f.write(f">{rec.name}\n{rec.seq.decode()}\n")

    dist = 5
    res = run_ball([DB], "q64.fa", BallConfig(distance=dist, output="b"))
    kept = {r.name for r in read_fasta(str("b.aln.xz"))}
    assert res["kept"] == len(kept) > 0

    pack = build_query_pack("q64.fa", always_exclude_redundant=True)
    L = pack.n_sites
    min_valid = int(L * (1.0 - 0.5))
    ref_names, ref_codes = [], []
    for rec in read_fasta(DB):
        codes = ENCODE_LUT[np.frombuffer(rec.seq, dtype=np.uint8)]
        if int(np.count_nonzero(codes)) < min_valid:
            continue
        ref_names.append(rec.name)
        ref_codes.append(codes)
    expect = staged_ball_oracle(ref_codes, list(pack.codes),
                                pack.idx_c, pack.idx_m, pack.idx,
                                pack.consensus, dist, acgt=False)
    expect_names = {n for n, k in zip(ref_names, expect) if k}
    assert kept == expect_names


def test_gate_legacy_partial_weight_bound():
    """VERDICT r4 #5: biomcmc-lib's IUPAC-weighted partial-match table
    is unrecoverable (empty submodule); engine/legacy.py conjectures
    |a&b|/(|a|*|b|).  Every admissible table agrees on all recoverable
    pins (pure-pure 1/0, T-W=0.5 per utils.c:73, N contributes 0, and
    pure-vs-ambiguity = |a&b|/|amb| under product, Jaccard AND
    max-rule alike) — candidates can differ ONLY at ambiguity-vs-
    ambiguity site pairs.  This test measures, on the bundled config-1
    data, whether that freedom can change the legacy stage-3 selection
    (describe_scores, utils.c:120-137): scores all ref pairs for every
    query that shares >=1 amb-amb site with any reference, rebuilds
    the weighted-partial column under the three candidate tables, and
    re-runs the 3-stage selection with the C defaults (nbest=8,
    nmax=16, uvaia.c:49,122).

    COMMITTED BOUND (measured 2026-08-20): 119 487 of 9 180 000
    QC-surviving (query, ref) pairs share amb-amb sites (max 35 per
    pair, 499 of 1000 queries affected).  Switching product -> Jaccard
    or product -> max-rule changes the stage-3 selected id set for
    exactly 63 of the 1000 queries, never by more than 3 ids — the
    maximal rank impact of the conjecture on this data.  Stages 1-2,
    all ranks, and the printed ACGT/text/valid columns are table-
    independent; the 501 queries with no amb-amb coincidence are
    invariant by construction.  --partial-rule (LegacyConfig
    .partial_rule) lets a user match whichever table their C binary
    carries."""
    import contextlib
    import io as io_mod
    import sys
    from collections import defaultdict

    import jax.numpy as jnp

    from uvaia_tpu.core.encoding import (ENCODE_LUT, IS_AMBIG, IS_PURE,
                                         POPCOUNT4)
    from uvaia_tpu.engine.legacy import describe_scores
    from uvaia_tpu.ops import distance as dist_ops

    names, codes = [], []
    for rec in read_fasta(DB):
        names.append(rec.name)
        codes.append(ENCODE_LUT[np.frombuffer(rec.seq, np.uint8)])
    codes = np.stack(codes)
    R, L = codes.shape

    # mirror run_legacy's QC (utils.c:11-48 thresholds at 0.5)
    acgt_f = IS_PURE[codes].sum(axis=1) / L
    other_f = 1.0 - acgt_f - IS_AMBIG[codes].sum(axis=1) / L
    keep = (other_f <= 0.5) & (acgt_f >= 1.0 - 1.1 * 0.5)
    ref_ids = np.nonzero(keep)[0]
    qnames = set(open(NAMES).read().split())
    q_ids = np.array([i for i in ref_ids if names[i] in qnames])
    assert len(q_ids) == 1000

    # amb-amb coincidences via a per-site inverted index (sparse: the
    # DB holds 15 213 ambiguity chars over 275M sites)
    site_rows = defaultdict(list)
    for i in ref_ids:
        for s in np.nonzero(IS_AMBIG[codes[i]])[0]:
            site_rows[int(s)].append(i)
    qset = set(int(i) for i in q_ids)
    common: dict = defaultdict(list)        # (q, r) -> [site, ...]
    for s, rows in site_rows.items():
        qs = [r for r in rows if r in qset]
        for q in qs:
            for r in rows:
                if r != q:
                    common[(q, r)].append(s)
    n_pairs = len(common)
    max_k = max(len(v) for v in common.values())
    affected_q = sorted({q for q, _ in common})
    # committed scale numbers (pinned: the data is immutable; QC keeps
    # 9180 of 9185 rows)
    assert len(ref_ids) == 9180
    assert n_pairs == 119487 and max_k == 35
    assert len(affected_q) == 499

    # engine counters for the affected queries vs ALL kept refs
    q_codes = codes[affected_q]
    qdata = dist_ops.build_legacy_query_data(q_codes, trim=0)
    import jax
    score_fn = jax.jit(dist_ops.legacy_scores)
    Rk, Qa = len(ref_ids), len(affected_q)
    s0 = np.zeros((Rk, Qa), np.int64)
    s1 = np.zeros((Rk, Qa), np.int64)
    s2 = np.zeros((Rk, Qa), np.float64)
    s3 = np.zeros((Rk, Qa), np.int64)
    for st in range(0, Rk, 1024):
        chunk = codes[ref_ids[st:st + 1024]]
        s = np.asarray(score_fn(qdata, jnp.asarray(chunk)))
        s0[st:st + 1024] = s[..., 0]
        s1[st:st + 1024] = s[..., 1]
        s2[st:st + 1024] = s[..., 2]
        s3[st:st + 1024] = s[..., 3]

    # per-pair weighted-partial deltas at the amb-amb sites
    pos_of_ref = {int(r): k for k, r in enumerate(ref_ids)}
    pos_of_q = {q: j for j, q in enumerate(affected_q)}

    def table(c1, c2):
        inter = POPCOUNT4[c1 & c2]
        p1, p2 = POPCOUNT4[c1], POPCOUNT4[c2]
        union = POPCOUNT4[c1 | c2]
        prod = inter / (p1 * p2)
        jac = inter / union
        mx = inter / max(p1, p2)
        return prod, jac, mx

    d_jac: dict = defaultdict(lambda: defaultdict(float))  # j -> k -> d
    d_max: dict = defaultdict(lambda: defaultdict(float))
    for (q, r), sites in common.items():
        j, k = pos_of_q[q], pos_of_ref[r]
        for s in sites:
            prod, jac, mx = table(codes[q][s], codes[r][s])
            d_jac[j][k] += jac - prod
            d_max[j][k] += mx - prod

    # stage-3 selection under each candidate table
    rnames = [names[i] for i in ref_ids]
    sink = io_mod.StringIO()
    n_diff_j = n_diff_m = 0
    max_sym = 0
    for j, q in enumerate(affected_q):
        s2_j = s2[:, j].copy()
        s2_m = s2[:, j].copy()
        for k, dv in d_jac[j].items():
            s2_j[k] += dv
        for k, dv in d_max[j].items():
            s2_m[k] += dv
        with contextlib.redirect_stdout(sink):
            base = describe_scores("q", s0[:, j], s1[:, j], s2[:, j],
                                   s3[:, j], rnames, 8, 16)
            alt_j = describe_scores("q", s0[:, j], s1[:, j], s2_j,
                                    s3[:, j], rnames, 8, 16)
            alt_m = describe_scores("q", s0[:, j], s1[:, j], s2_m,
                                    s3[:, j], rnames, 8, 16)
        if set(base) != set(alt_j):
            n_diff_j += 1
            max_sym = max(max_sym, len(set(base) ^ set(alt_j)))
        if set(base) != set(alt_m):
            n_diff_m += 1
            max_sym = max(max_sym, len(set(base) ^ set(alt_m)))
    # THE COMMITTED BOUND (pinned): the admissible-table freedom CAN
    # move the legacy stage-3 extras on this data — for these many of
    # the 1000 config-1 queries the selected id set differs from the
    # product-rule default (the other ~94% are invariant; stages 1-2,
    # ranks, and the printed ACGT/text/valid columns never change).
    # Mitigation: LegacyConfig.partial_rule / --partial-rule lets a
    # user match whichever table their C binary uses.
    print(f"partial-weight impact: jaccard {n_diff_j}, max-rule "
          f"{n_diff_m} of {len(affected_q)} affected "
          f"(max symmetric diff {max_sym})", file=sys.stderr)
    assert (n_diff_j, n_diff_m, max_sym) == (63, 63, 3)


def test_gate_cluster_invariants(tmp_path, monkeypatch):
    """Third-tool real-data check: cluster the first 2 000 database
    genomes at distance 1 and verify the guarantees fastaseq.c:140-261
    makes (lifted from test_cluster_properties_randomized): exact
    partition, <=d-connectivity of every cluster's member graph, and
    maximal-resolution medoids — against core/oracle.py distances, no
    engine scoring."""
    from uvaia_tpu.core import oracle
    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.cluster import ClusterConfig, run_cluster

    monkeypatch.chdir(tmp_path)
    N, DIST = 2000, 1
    codes, names = {}, []
    with open("sub.fa", "w") as f:
        for rec in read_fasta(DB):
            f.write(f">{rec.name}\n{rec.seq.decode()}\n")
            codes[rec.name] = ENCODE_LUT[np.frombuffer(rec.seq,
                                                       np.uint8)]
            names.append(rec.name)
            if len(names) == N:
                break
    merged = run_cluster(["sub.fa"], ClusterConfig(distance=DIST,
                                                   output="cl"))

    all_names = [n for c in merged for n in [c.name] + c.neighbours]
    assert sorted(all_names) == sorted(names)

    n_multi = 0
    for c in merged:
        members = [c.name] + c.neighbours
        non_n = {n: int(np.count_nonzero(codes[n])) for n in members}
        assert non_n[c.name] == max(non_n.values())
        if len(members) == 1:
            continue
        n_multi += 1
        reach, frontier = {members[0]}, [members[0]]
        while frontier:
            a = frontier.pop()
            for b in members:
                if b not in reach and oracle.pair_hamming_indelcheck(
                        codes[a], codes[b]) <= DIST:
                    reach.add(b)
                    frontier.append(b)
        assert reach == set(members), \
            f"cluster {c.name} not <= {DIST}-connected"
    # the subset must actually exercise merging (unique genomes still
    # sit within 1 SNP of each other in surveillance data)
    assert n_multi > 0 and len(merged) < len(names)
