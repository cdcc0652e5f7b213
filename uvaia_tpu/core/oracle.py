"""NumPy oracle for the uvaia scoring contract.

This module is the *specification*: a slow, obviously-correct
implementation of the pairwise counters and of the six-score ranking
used by ``uvaia`` nearest-neighbour search.  The device kernels in
``uvaia_tpu.ops`` are tested against it.

Reference semantics recovered from:
* counters          — src/utils.c:266-295, README.md:254-330
* score assembly    — src/nearest.c:442-510 (full and --acgt modes)
* ranking           — src/min_heap.c:41-47 (lexicographic decreasing)
"""

from __future__ import annotations

import numpy as np

from .encoding import IS_PURE, POPCOUNT4


def pair_counters(q: np.ndarray, r: np.ndarray, idx: np.ndarray | None = None):
    """Four match counters between two code arrays, over optional index subset.

    Returns (acgt_matches, text_matches, partial_matches, valid_pairs),
    the contract of ``biomcmc_pairwise_score_matches_truncated_idx``
    without truncation (truncation never affects sequences that reach the
    output; see SURVEY.md §2.6).
    """
    if idx is not None:
        q = q[idx]
        r = r[idx]
    valid = (q != 0) & (r != 0)
    eq = (q == r) & valid
    acgt = eq & (IS_PURE[q] != 0)
    partial = (q & r) != 0
    return int(acgt.sum()), int(eq.sum()), int(partial.sum()), int(valid.sum())


def pair_counters_acgt(q: np.ndarray, r: np.ndarray, idx: np.ndarray | None = None):
    """(acgt_mismatches, acgt_valid_pairs) — contract of
    ``quick_pairwise_score_acgt_and_valid`` (fastaseq.c:586-596)."""
    if idx is not None:
        q = q[idx]
        r = r[idx]
    both = (IS_PURE[q] != 0) & (IS_PURE[r] != 0)
    mm = both & (q != r)
    return int(mm.sum()), int(both.sum())


def pair_hamming_indelcheck(q: np.ndarray, r: np.ndarray, idx: np.ndarray | None = None):
    """Text mismatches over valid pairs (``quick_pairwise_score_truncated_idx_indelcheck``,
    fastaseq.c:563-574): valid pairs that are not character-equal."""
    if idx is not None:
        q = q[idx]
        r = r[idx]
    valid = (q != 0) & (r != 0)
    return int((valid & (q != r)).sum())


def pair_mismatch_acgt(q, r, idx=None):
    """ACGT mismatches (``quick_pairwise_score_acgt``, fastaseq.c:577-583)."""
    return pair_counters_acgt(q, r, idx)[0]


def partial_weight(c1: int, c2: int, rule: str = "product") -> float:
    """IUPAC-weighted partial match used by the legacy tool.

    biomcmc-lib's exact table is not recoverable from the snapshot
    (empty submodule); every candidate consistent with the recoverable
    pins (pure matches 1, pure mismatches 0, T vs W = 0.5 per
    src/utils.c:73, N/gap 0) is offered, differing ONLY at
    ambiguity-vs-ambiguity pairs:

      product — |∩| / (|s1|·|s2|), the probability two uniformly-drawn
                bases agree (default; M vs R = 0.25, M vs M = 0.5)
      jaccard — |∩| / |s1 ∪ s2|            (M vs R = 1/3, M vs M = 1)
      max     — |∩| / max(|s1|, |s2|)      (M vs R = 0.5, M vs M = 1)

    Measured impact of the choice on the bundled config-1 data: 63 of
    1000 queries' stage-3 extras move, never ranks or stages 1-2
    (tests/test_realdata.py::test_gate_legacy_partial_weight_bound)."""
    if rule not in ("product", "jaccard", "max"):
        raise ValueError(f"unknown partial rule {rule!r}")
    if c1 == 0 or c2 == 0:
        return 0.0
    inter = POPCOUNT4[c1 & c2]
    if rule == "jaccard":
        return inter / POPCOUNT4[c1 | c2]
    if rule == "max":
        return inter / max(POPCOUNT4[c1], POPCOUNT4[c2])
    return inter / (POPCOUNT4[c1] * POPCOUNT4[c2])


def six_scores_full(ref: np.ndarray, query: np.ndarray, consensus: np.ndarray,
                    idx_c: np.ndarray, idx_mq: np.ndarray, ref_valid_sites: int):
    """Six-score tuple for --full (default) mode (nearest.c:480-510).

    idx_c  — constant, gap-free query sites: compare ref vs consensus.
    idx_mq — union of idx_m and idx: compare ref vs this query.
    """
    c = pair_counters(consensus, ref, idx_c)
    m = pair_counters(query, ref, idx_mq)
    return (
        c[0] + m[0],          # ACGT_matches
        c[1] + m[1],          # text_matches
        c[2] + m[2],          # partial_matches
        c[3] + m[3],          # valid_pair_comparisons
        m[0],                 # ACGT_matches_unique (non-consensus part)
        ref_valid_sites,      # valid_ref_sites (full untrimmed length)
    )


def six_scores_acgt(ref: np.ndarray, query: np.ndarray, consensus: np.ndarray,
                    idx_c: np.ndarray, idx_m: np.ndarray, idx_p: np.ndarray,
                    ref_valid_sites: int):
    """Six-score tuple for --acgt mode (nearest.c:443-477): score[4]
    (dist_consensus) is mismatches over idx_c + idx_m (the reference
    accumulates the idx_m stage into result[0] before reading it), and
    score[5] (dist_unique) is mismatches over the polymorphic idx only."""
    mm_c, va_c = pair_counters_acgt(consensus, ref, idx_c)
    mm_m, va_m = pair_counters_acgt(query, ref, idx_m)
    mm_p, va_p = pair_counters_acgt(query, ref, idx_p)
    matches = (va_c + va_m + va_p) - (mm_c + mm_m + mm_p)
    cons_matches = va_c - mm_c
    return (
        matches,              # ACGT_matches
        va_c + va_m + va_p,   # valid_ACGT_comparisons
        matches - cons_matches,  # ACGT_matches_unique
        ref_valid_sites,      # valid_ref_sites
        mm_c + mm_m,          # dist_consensus
        mm_p,                 # dist_unique
    )


def rank_refs(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best references by lexicographic-decreasing
    six-score order, ties broken by lowest database index (the C heap
    keeps the first-seen among fully tied items, min_heap.c:93-117)."""
    n = scores.shape[0]
    order = np.lexsort(
        tuple(-scores[:, j] for j in range(scores.shape[1] - 1, -1, -1)))
    # np.lexsort is stable, so equal six-tuples stay in index order.
    return order[: min(k, n)]


def nearest_oracle(ref_codes: np.ndarray, ref_valid: np.ndarray,
                   query_codes: np.ndarray, consensus: np.ndarray,
                   idx_c: np.ndarray, idx_m: np.ndarray, idx_p: np.ndarray,
                   k: int, acgt: bool = False):
    """Full nearest-neighbour oracle.

    ref_codes   — (B, L) database codes
    ref_valid   — (B,) untrimmed valid-site counts
    query_codes — (Q, L)
    Returns (scores, topk): scores (B, Q, 6) int32; topk (Q, <=k) ref indices.
    """
    B, Q = ref_codes.shape[0], query_codes.shape[0]
    idx_mq = np.sort(np.concatenate([idx_m, idx_p]))
    scores = np.zeros((B, Q, 6), dtype=np.int32)
    for b in range(B):
        for q in range(Q):
            if acgt:
                scores[b, q] = six_scores_acgt(
                    ref_codes[b], query_codes[q], consensus,
                    idx_c, idx_m, idx_p, int(ref_valid[b]))
            else:
                scores[b, q] = six_scores_full(
                    ref_codes[b], query_codes[q], consensus,
                    idx_c, idx_mq, int(ref_valid[b]))
    topk = [rank_refs(scores[:, q, :], k) for q in range(Q)]
    return scores, np.array(topk)
