"""Distance kernels for radius search (ball), clustering and the legacy
in-memory searcher.

* `cons_mismatches`      — per-reference mismatch count vs the query
  consensus over a site subset (ball stages 1+2, fastaseq.c:660-696).
* `pair_mismatches`      — exact (B, Q) mismatch matrix over a small
  polymorphic-site subset via 16-wide one-hot einsum (ball stage 3,
  query redundancy checks, cluster distances).
* `legacy_scores`        — the legacy searcher's per-pair counters
  (utils.c:50-79): ACGT matches, char matches among valid, IUPAC-
  weighted partial matches (T vs W = 0.5, utils.c:73), valid pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.encoding import IS_AMBIG, IS_PURE, POPCOUNT4
from .scan import _bits, _pure, _imm


def mismatch_weights(q_sub: np.ndarray, acgt: bool) -> np.ndarray:
    """(Q, P, 16) int8: weight[q, p, c] = 1 iff ref code c mismatches
    query q at subset position p (mode-dependent)."""
    codes16 = np.arange(16, dtype=np.uint8)
    cq = q_sub[..., None]                       # (Q, P, 1)
    if acgt:
        w = (IS_PURE[cq] != 0) & (IS_PURE[codes16] != 0) & (cq != codes16)
    else:
        w = (cq != 0) & (codes16 != 0) & (cq != codes16)
    return w.astype(np.int8)


def pair_mismatches(ref_sub: jnp.ndarray, weights: jnp.ndarray):
    """ref_sub (B, P) uint8 codes, weights (Q, P, 16) -> (B, Q) int32."""
    oh = (ref_sub[..., None] == jnp.arange(16, dtype=ref_sub.dtype)
          ).astype(jnp.int8)
    return _imm(oh, weights)


def cons_mismatches(ref_codes: jnp.ndarray, sites: jnp.ndarray,
                    cons: jnp.ndarray, acgt: bool):
    """(B,) int32 mismatches of each ref against consensus codes at
    `sites` (text-valid-pair or acgt-pair semantics)."""
    rc = jnp.take(ref_codes, sites, axis=1)
    c = cons[None, :]
    if acgt:
        both = (_pure(rc) & _pure(c)).astype(jnp.int32)
        return jnp.sum(both * (rc != c), axis=1)
    valid = (rc != 0) & (c != 0)
    return jnp.sum((valid & (rc != c)).astype(jnp.int32), axis=1)


# ----------------------------------------------------------------------
# legacy in-memory scoring

def build_legacy_query_data(q_codes: np.ndarray, trim: int,
                            partial_rule: str = "product"):
    """Precompute query-side features for legacy_scores.

    ``partial_rule`` selects the ambiguity-vs-ambiguity entries of the
    weighted-partial table (see core/oracle.py partial_weight —
    product is this implementation's documented default; jaccard / max
    are the other candidates consistent with the recoverable pins).
    Non-product rules add a sparse per-amb-column correction plane;
    every other counter is rule-independent."""
    if partial_rule not in ("product", "jaccard", "max"):
        raise ValueError(f"unknown partial rule {partial_rule!r}")
    Q, L = q_codes.shape
    window = np.zeros(L, dtype=bool)
    window[trim:L - trim if trim else L] = True
    q = np.where(window[None, :], q_codes, 0).astype(np.uint8)

    bits = np.stack([(q >> i) & 1 for i in range(4)], -1).astype(np.int8)
    pure = (POPCOUNT4[q] == 1)
    a_q = bits * pure[..., None].astype(np.int8)
    v_q = (q != 0).astype(np.int8)
    pop = np.maximum(POPCOUNT4[q].astype(np.float32), 1.0)
    mn_q = bits.astype(np.float32) / pop[..., None]

    amb_cols = np.nonzero((IS_AMBIG[q] != 0).any(axis=0))[0].astype(np.int32)
    codes16 = np.arange(16, dtype=np.uint8)
    cq = q[:, amb_cols, None]
    w_text = ((cq == codes16) & (IS_AMBIG[cq] != 0)).astype(np.int8)
    w_part = None
    if partial_rule != "product":
        # delta (rule - product) per (query code, ref code): nonzero
        # only when BOTH codes are ambiguity codes, so the correction
        # rides the same amb-column one-hot gather as w_text
        both = (IS_AMBIG[cq] != 0) & (IS_AMBIG[codes16] != 0)
        inter = POPCOUNT4[cq & codes16].astype(np.float32)
        p1 = POPCOUNT4[cq].astype(np.float32)
        p2 = POPCOUNT4[codes16].astype(np.float32)
        prod = inter / np.maximum(p1 * p2, 1.0)
        if partial_rule == "jaccard":
            alt = inter / np.maximum(
                POPCOUNT4[cq | codes16].astype(np.float32), 1.0)
        else:
            alt = inter / np.maximum(np.maximum(p1, p2), 1.0)
        w_part = ((alt - prod) * both).astype(np.float32)
    return dict(a_q=jnp.asarray(a_q), v_q=jnp.asarray(v_q),
                mn_q=jnp.asarray(mn_q), amb_cols=jnp.asarray(amb_cols),
                w_text=jnp.asarray(w_text),
                w_part=None if w_part is None else jnp.asarray(w_part),
                window=jnp.asarray(window))


def legacy_scores(qdata: dict, ref_codes: jnp.ndarray):
    """(B, Q, 4) float32: [acgt_matches, text_matches,
    weighted_partial_matches, valid_pairs] over the trim window."""
    r = jnp.where(qdata["window"][None, :], ref_codes, 0).astype(jnp.uint8)
    bits = _bits(r)
    pure = _pure(r)
    a_r = bits * pure[..., None]
    v_r = (r != 0).astype(jnp.int8)
    pop = jnp.maximum(
        (bits.astype(jnp.int32).sum(-1)).astype(jnp.float32), 1.0)
    mn_r = bits.astype(jnp.float32) / pop[..., None]

    s_aa = _imm(a_r, qdata["a_q"])
    s_vv = _imm(v_r, qdata["v_q"])
    # HIGHEST precision: the operands are 1/2, 1/3 and 1/4 weights, and
    # a GPU's default float32 matmul runs in TF32, whose 10-bit mantissa
    # rounds 1/3 and drifts the weighted partial sums far enough to move
    # stage-3 ranks away from the exact (CPU) result
    mw = jax.lax.dot_general(
        mn_r.reshape(r.shape[0], -1), qdata["mn_q"].reshape(
            qdata["mn_q"].shape[0], -1),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    corr_t = 0
    if qdata["amb_cols"].shape[0]:
        ra = jnp.take(r, qdata["amb_cols"], axis=1)
        oh = (ra[..., None] == jnp.arange(16, dtype=r.dtype)
              ).astype(jnp.int8)
        corr_t = _imm(oh, qdata["w_text"])
        if qdata.get("w_part") is not None:
            # non-product partial rule: float delta over the same
            # amb-column one-hot (see build_legacy_query_data)
            ohf = oh.astype(jnp.float32).reshape(oh.shape[0], -1)
            wp = qdata["w_part"].reshape(qdata["w_part"].shape[0], -1)
            mw = mw + jax.lax.dot_general(
                ohf, wp, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    text = s_aa + corr_t
    return jnp.stack([s_aa.astype(jnp.float32),
                      text.astype(jnp.float32), mw,
                      s_vv.astype(jnp.float32)], axis=-1)
