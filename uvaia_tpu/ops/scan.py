"""Scan kernels: dense match-count scoring + exact top-k merge.

The reference computes per-(ref,query) match counters with branchy
early-exit scalar loops (fastaseq.c:522-596, biomcmc-lib kernels) and a
per-query binary min-heap (min_heap.c).  Here the same *exact* scores
come out of dense int8 matmuls over per-site feature vectors, and the
top-k state is maintained with a multi-key `lax.sort` merge:

* per-site features (int8): pure-base one-hot ``a`` (4), base-mask bits
  ``m`` (4), valid ``v`` (1), pure ``p`` (1)
* ``acgt_matches  = a_q . a_r``                      (exact)
* ``valid_pairs   = v_q . v_r``                      (exact)
* ``text_matches  = a_q . a_r + corr_t``             (corr at rare
  both-ambiguous sites: equal ambiguity codes)
* ``partial       = m_q . m_r + corr_p``             (corr subtracts the
  overcount when two ambiguity codes share >=2 bases)

The consensus stage (constant gap-free sites, idx_c) is a single
elementwise pass per reference — exactly the reference's
``queue_distance_to_consensus`` factorisation (nearest.c:428-433).

The site-summable part (`site_partials`) is separated from score
assembly so a device mesh can shard the site/contraction axis and
`psum` the partial counters (see parallel/mesh.py) — the context/
sequence-parallel analogue for genomes larger than one device's memory.

Ranking keys: the six int scores are packed into three int32 keys
(s0<<15|s1, s2<<15|s3, s4<<15|s5) when the alignment length fits 15
bits, else six separate keys; `lax.sort` with the database index as the
final key reproduces the C heap's first-seen-wins tie behaviour
(min_heap.c:93-117).
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.encoding import IS_AMBIG, POPCOUNT4
from ..engine.query import QueryPack

INT32_MIN = np.int32(-2**31)
IDX_SENTINEL = np.int32(2**31 - 1)


def _pad_to(x: np.ndarray, mult: int, axis: int = 0, value=0) -> np.ndarray:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


@dataclass
class QueryDeviceData:
    """Device-resident per-run query data.

    Site-class restrictions are realised by ZEROING the query-side
    arrays outside each class (a zero code has no pure/mask/valid
    feature, so it contributes nothing to any counter) instead of
    gathering site subsets: full-length operands need no (B, S) gather
    per batch and shard cleanly over a 'site' mesh axis with no index
    plumbing.

    Registered as a jax pytree (arrays are jit *arguments*, the scalar
    config is static metadata) — embedding the query arrays as closure
    constants would inline them into the HLO, which breaks compilation
    for large query packs."""

    acgt: bool
    n_query: int
    n_sites: int
    k: int
    pack_keys: bool            # six scores fit 3 packed int32 keys
    cons_full: jnp.ndarray     # (W,) uint8 consensus, 0 outside idx_c
    q_full: jnp.ndarray        # (Q, W) uint8 query codes, 0 outside
                               # idx_mq (W = n_sites padded to the site
                               # tile: zero columns score zero)
    amb_sites: jnp.ndarray | None  # (A,) int32 global site indices
    w_part: jnp.ndarray | None     # (Q, A, 16) int8 partial-match corr
    w_text: jnp.ndarray | None     # (Q, A, 16) int8 text-match corr
    # --acgt mode only: the polymorphic subset separated out, because
    # score[5] (dist_unique) counts mismatches over idx alone while
    # score[4] (dist_consensus) covers idx_c + idx_m (nearest.c:443-477)
    q_poly: jnp.ndarray | None = None     # (Q, W) uint8, 0 outside idx
    # phase-1 prefilter data (built on demand, see build_prune_data):
    u_base: jnp.ndarray | None = None    # (L,) uint8 unanimous base code,
                                         # 0 at segregating/out-of-window
    q_pure_u: jnp.ndarray | None = None  # (Q, L) int8 query-pure mask on U
    idx_p: jnp.ndarray | None = None     # (P,) acgt-segregating sites
    pure_p_q: jnp.ndarray | None = None  # (Q,) pure count over P
    amb_tot_q: jnp.ndarray | None = None  # (Q,) ambiguity codes in window
    # sparse-delta uploads: per-site majority query code, the base the
    # host diffs database rows against (see delta_encode)
    delta_base: jnp.ndarray | None = None  # (L,) uint8


def build_device_data(pack: QueryPack, k: int,
                      site_shards: int = 1) -> QueryDeviceData:
    """Prepare static device arrays.  `site_shards` pads the site axis
    so it divides evenly over a 'site' mesh axis (a multiple of 1024
    per shard; zero columns score zero)."""
    mult = 1024 * site_shards
    L = pack.n_sites
    W = -(-L // mult) * mult

    idx_mq = pack.idx_mq.astype(np.int32)
    q_full = np.zeros((pack.n_query, W), dtype=np.uint8)
    q_full[:, idx_mq] = pack.codes[:, idx_mq]

    idx_c = pack.idx_c.astype(np.int32)
    cons_full = np.zeros(W, dtype=np.uint8)
    cons_full[idx_c] = pack.consensus[idx_c]

    amb_sites = w_part = w_text = None
    if not pack.acgt:
        q_sub = pack.codes[:, idx_mq]
        amb_cols = np.nonzero((IS_AMBIG[q_sub] != 0).any(axis=0))[0]
        if len(amb_cols):
            # pad with an out-of-range index: the pad slots get code-0
            # weight rows (all zero below), so whatever the gather reads
            # there contributes nothing
            sites = _pad_to(idx_mq[amb_cols], 8, value=1 << 30)
            cq = np.zeros((pack.n_query, len(sites)), dtype=np.uint8)
            cq[:, :len(amb_cols)] = q_sub[:, amb_cols]
            codes16 = np.arange(16, dtype=np.uint8)
            inter = cq[..., None] & codes16            # (Q, A, 16)
            cnt = POPCOUNT4[inter].astype(np.int8)
            w_part = ((cnt > 0).astype(np.int8) - cnt)  # <= 0
            eq_amb = ((cq[..., None] == codes16)
                      & (IS_AMBIG[cq][..., None] != 0))
            w_text = eq_amb.astype(np.int8)
            amb_sites = sites

    q_poly = None
    if pack.acgt:
        ip = pack.idx.astype(np.int32)
        q_poly = np.zeros((pack.n_query, W), dtype=np.uint8)
        q_poly[:, ip] = pack.codes[:, ip]

    qd = QueryDeviceData(
        acgt=pack.acgt,
        n_query=pack.n_query,
        n_sites=L,
        k=k,
        pack_keys=L < 2**15,
        cons_full=jnp.asarray(cons_full),
        q_full=jnp.asarray(q_full),
        amb_sites=None if amb_sites is None else jnp.asarray(amb_sites),
        w_part=None if w_part is None else jnp.asarray(w_part),
        w_text=None if w_text is None else jnp.asarray(w_text),
        q_poly=None if q_poly is None else jnp.asarray(q_poly),
        delta_base=jnp.asarray(majority_code(pack.codes)),
    )
    return qd


def _to_width(ref_codes: jnp.ndarray, w: int) -> jnp.ndarray:
    """Zero-pad (or slice) the site axis to width `w`; zero columns
    contribute nothing to any counter."""
    L = ref_codes.shape[1]
    if L == w:
        return ref_codes
    if L > w:
        return ref_codes[:, :w]
    return jnp.pad(ref_codes, ((0, 0), (0, w - L)))


def majority_code(codes: np.ndarray) -> np.ndarray:
    """(Q, L) -> (L,) most frequent code per site (the delta base).

    Database rows are expected to be close to the queries, so the
    per-site query majority minimises the expected diff count of
    delta_encode.  Any fixed vector is *correct* (reconstruction is
    exact); this one just keeps the uploads small."""
    counts = np.zeros((16, codes.shape[1]), dtype=np.int32)
    for c in range(16):
        counts[c] = (codes == c).sum(axis=0)
    return counts.argmax(axis=0).astype(np.uint8)


def build_prune_data(qd: QueryDeviceData, pack: QueryPack) -> None:
    """Attach phase-1 prefilter arrays to qd (see prune_step).

    U = window sites where every pure-base query agrees (on base b_i);
    P = window sites where pure queries disagree.  At U sites the ACGT
    match count is EXACTLY [q_i pure] * [r_i == b_i], which one int8
    matmul computes for all pairs; only the small P set is bounded.
    """
    from ..core.encoding import IS_PURE
    Q, L = pack.codes.shape
    W = int(qd.q_full.shape[1])     # prune refs arrive width-padded
    t = pack.trim
    window = np.zeros(L, dtype=bool)
    window[t:L - t if t else L] = True

    pure = (IS_PURE[pack.codes] != 0) & window[None, :]
    c = pack.codes.astype(np.int16)
    pmax = np.where(pure, c, -1).max(axis=0)
    pmin = np.where(pure, c, 99).min(axis=0)
    any_pure = pure.any(axis=0)
    seg = any_pure & (pmax != pmin)               # acgt-segregating
    u_base = np.where(any_pure & ~seg, pmax, 0).astype(np.uint8)

    q_pure_u = (pure & ~seg[None, :]).astype(np.int8)
    idx_p = np.nonzero(seg)[0].astype(np.int32)
    pure_p_q = pure[:, idx_p].sum(axis=1).astype(np.int32)
    amb = ((pack.codes != 0) & (IS_PURE[pack.codes] == 0)
           & window[None, :])
    qd.u_base = jnp.asarray(np.pad(u_base, (0, W - L)))
    qd.q_pure_u = jnp.asarray(np.pad(q_pure_u, ((0, 0), (0, W - L))))
    qd.idx_p = jnp.asarray(_pad_to(idx_p, 8))
    qd.pure_p_q = jnp.asarray(pure_p_q)
    qd.amb_tot_q = jnp.asarray(amb.sum(axis=1).astype(np.int32))


# ----------------------------------------------------------------------
# feature extraction (elementwise, from uint8 codes)

def _bits(codes: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) int8 base-mask bits."""
    c = codes.astype(jnp.int32)
    return jnp.stack([(c >> i) & 1 for i in range(4)], axis=-1).astype(jnp.int8)


def _pure(codes: jnp.ndarray) -> jnp.ndarray:
    c = codes.astype(jnp.int32)
    pop = ((c >> 0) & 1) + ((c >> 1) & 1) + ((c >> 2) & 1) + ((c >> 3) & 1)
    return (pop == 1).astype(jnp.int8)


def _imm(a, b):
    """int8 x int8 -> int32 contraction over the last axes flattened."""
    a2 = a.reshape(a.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1)
    return jax.lax.dot_general(
        a2, b2, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)


# ----------------------------------------------------------------------
# scoring, split into (a) site-summable partials and (b) assembly

def site_partials(acgt: bool, cons_full, q_full, ref_codes, q_poly=None):
    """Counter contributions that sum over sites — gather-free: the
    reference rows are used full-width against zero-masked query-side
    operands (see QueryDeviceData docstring).

    ``ref_codes`` must be padded to cons_full's width (scan._to_width).
    Returns (cons (B, 5) int32, mats (B, Q, 3|4) int32); --acgt mode
    uses cons[:, :2] and a 4-wide mats whose last two slots are the
    polymorphic-subset pair counts (needed for the reference's s4/s5
    split, nearest.c:443-477).  cons[:, 4] is the per-ref valid-site
    count.  Under a 'site' mesh axis these are the psum-reducible
    partials.
    """
    rc = ref_codes                                    # (B, W)
    cons = cons_full[None, :]

    if acgt:
        valid_sites = jnp.sum((rc != 0).astype(jnp.int32), axis=1)
        both = (_pure(rc) & _pure(cons)).astype(jnp.int32)
        mm_c = jnp.sum(both * (rc != cons), axis=1)
        va_c = jnp.sum(both, axis=1)
        cons5 = jnp.stack([mm_c, va_c, va_c * 0, va_c * 0, valid_sites],
                          axis=-1)

        p_r = _pure(rc)
        a_r = _bits(rc) * p_r[..., None]
        p_q = _pure(q_full)
        a_q = _bits(q_full) * p_q[..., None]
        s_pp = _imm(p_r, p_q)
        s_aa = _imm(a_r, a_q)
        pp_q = _pure(q_poly)
        ap_q = _bits(q_poly) * pp_q[..., None]
        s_pp_p = _imm(p_r, pp_q)
        s_aa_p = _imm(a_r, ap_q)
        mats = jnp.stack([s_pp, s_aa, s_pp_p, s_aa_p], axis=-1)
        return cons5, mats

    valid_sites = jnp.sum((rc != 0).astype(jnp.int32), axis=1)
    v_rc = (rc != 0) & (cons != 0)
    eq_c = (rc == cons) & v_rc
    pure_cons = _pure(cons) != 0
    acgt_c = jnp.sum((eq_c & pure_cons).astype(jnp.int32), axis=1)
    text_c = jnp.sum(eq_c.astype(jnp.int32), axis=1)
    part_c = jnp.sum(((rc & cons) != 0).astype(jnp.int32), axis=1)
    valid_c = jnp.sum(v_rc.astype(jnp.int32), axis=1)
    cons5 = jnp.stack([acgt_c, text_c, part_c, valid_c, valid_sites],
                      axis=-1)
    a_r = _bits(rc) * _pure(rc)[..., None]
    m_r = _bits(rc)
    v_r = (rc != 0).astype(jnp.int8)
    a_q = _bits(q_full) * _pure(q_full)[..., None]
    m_q = _bits(q_full)
    v_q = (q_full != 0).astype(jnp.int8)
    mats = jnp.stack([_imm(a_r, a_q), _imm(m_r, m_q), _imm(v_r, v_q)],
                     axis=-1)
    return cons5, mats


def assemble_score_planes(qd: QueryDeviceData, ref_codes, cons5, mats):
    """Combine partials + rare-ambiguity corrections into six (B, Q)
    int32 planes (s0..s5) — the pre-stack form of assemble_scores.

    Callers that feed merge_topk should prefer this form: keeping the
    six components as separate (B, Q) arrays keeps every elementwise op
    (key packing, threshold compare) on whole (B, Q) arrays, whereas a
    stacked (B, Q, 6) puts a size-6 axis innermost AND must be
    materialised whole as a lax.cond operand in merge_topk.

    ``ref_codes`` is only read at qd.amb_sites (full-mode ambiguity
    corrections); valid-site counts ride in cons5[:, 4] so a
    site-sharded caller can psum them with the other partials."""
    valid_sites = cons5[:, 4]

    if qd.acgt:
        mm_c, va_c = cons5[:, 0], cons5[:, 1]
        s_pp, s_aa = mats[..., 0], mats[..., 1]
        mm_poly = mats[..., 2] - mats[..., 3]   # mismatches over idx alone
        mm_m = (s_pp - s_aa) - mm_poly          # mismatches over idx_m
        s0 = (va_c - mm_c)[:, None] + s_aa
        s1 = va_c[:, None] + s_pp
        s2 = s_aa
        s3 = jnp.broadcast_to(valid_sites[:, None], s_aa.shape)
        s4 = mm_c[:, None] + mm_m       # dist_consensus (idx_c + idx_m)
        s5 = mm_poly                    # dist_unique (polymorphic idx)
    else:
        acgt_c, text_c, part_c, valid_c = (cons5[:, i] for i in range(4))
        s_aa, s_mm, s_vv = (mats[..., i] for i in range(3))
        corr_t = corr_p = 0
        if qd.amb_sites is not None:
            ra = jnp.take(ref_codes, qd.amb_sites, axis=1)      # (B, A)
            oh = (ra[..., None] == jnp.arange(16, dtype=ra.dtype)
                  ).astype(jnp.int8)
            corr_t = _imm(oh, qd.w_text)
            corr_p = _imm(oh, qd.w_part)
        s0 = acgt_c[:, None] + s_aa
        s1 = text_c[:, None] + s_aa + corr_t
        s2 = part_c[:, None] + s_mm + corr_p
        s3 = valid_c[:, None] + s_vv
        s4 = s_aa
        s5 = jnp.broadcast_to(valid_sites[:, None], s_aa.shape)

    return (s0, s1, s2, s3, s4, s5)


def assemble_scores(qd: QueryDeviceData, ref_codes, cons5, mats):
    """Stacked (B, Q, 6) form of assemble_score_planes (sharded /
    oracle-comparison callers that want one tensor)."""
    return jnp.stack(assemble_score_planes(qd, ref_codes, cons5, mats),
                     axis=-1)


def score_batch(qd: QueryDeviceData, ref_codes: jnp.ndarray):
    """(B, Q, 6) int32 six-score tensor + per-ref valid-site counts."""
    planes, valid = score_batch_planes(qd, ref_codes)
    return jnp.stack(planes, axis=-1), valid


def score_batch_planes(qd: QueryDeviceData, ref_codes: jnp.ndarray):
    """Six (B, Q) int32 score planes + per-ref valid-site counts — the
    merge_topk-preferred form (see assemble_score_planes)."""
    rc = _to_width(ref_codes, qd.q_full.shape[1])
    cons5, mats = site_partials(qd.acgt, qd.cons_full, qd.q_full, rc,
                                qd.q_poly)
    planes = assemble_score_planes(qd, rc, cons5, mats)
    valid = planes[5 if not qd.acgt else 3][:, 0]
    return planes, valid


def score_batch_planes_packed(qd: QueryDeviceData, packed: jnp.ndarray):
    """score_batch_planes fed by the 4-bit packed upload: unpack on
    device, then score."""
    return score_batch_planes(qd, unpack_codes(packed, qd.n_sites))


# ----------------------------------------------------------------------
# top-k state + merge

# Single source of truth for the ranking-key definition: six int scores
# packed two-per-int32 key with this shift (requires each score < 2**15,
# qd.pack_keys).  _pack3 (stacked), _key_planes (plane form) and
# prune_step's key-1 bound all derive from it — change the packing or
# tie semantics HERE and everything (flags, merge, prune) stays agreed.
KEY_SHIFT = 32768


def _pack3(scores: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) -> (..., 3) packed keys (KEY_SHIFT packing)."""
    s = scores.astype(jnp.int32)
    return jnp.stack([
        s[..., 0] * KEY_SHIFT + s[..., 1],
        s[..., 2] * KEY_SHIFT + s[..., 3],
        s[..., 4] * KEY_SHIFT + s[..., 5],
    ], axis=-1)


def _keys(qd: QueryDeviceData, scores: jnp.ndarray) -> jnp.ndarray:
    return _pack3(scores) if qd.pack_keys else scores.astype(jnp.int32)


def init_state(n_query: int, k: int):
    """(scores, idx): sentinel-filled running top-k state."""
    return (jnp.full((n_query, k, 6), -1, dtype=jnp.int32),
            jnp.full((n_query, k), IDX_SENTINEL, dtype=jnp.int32))


def _lex_gt_planes(a: list, b: list) -> jnp.ndarray:
    """Lexicographic a > b over parallel per-key plane lists (elements
    broadcast against each other) — the one comparator every key
    consumer shares (see KEY_SHIFT)."""
    nk = len(a)
    out = a[nk - 1] > b[nk - 1]
    for i in range(nk - 2, -1, -1):
        out = (a[i] > b[i]) | ((a[i] == b[i]) & out)
    return out


def _lex_gt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a > b over the trailing key axis (stacked form of
    _lex_gt_planes)."""
    nk = a.shape[-1]
    return _lex_gt_planes([a[..., i] for i in range(nk)],
                          [b[..., i] for i in range(nk)])


def select_topk(qd: QueryDeviceData, scores, idx, k):
    """Exact lexicographic top-k along axis 1.

    scores (Q, N, 6), idx (Q, N) -> (Q, k, 6), (Q, k); sentinel-idx rows
    sort last; ties broken by ascending database index.
    """
    neg_keys = -_keys(qd, scores)
    neg_keys = jnp.where(idx[..., None] == IDX_SENTINEL,
                         jnp.int32(2**31 - 1), neg_keys)
    nk = neg_keys.shape[-1]
    # carry only a row-position payload through the sort (scores are
    # gathered afterwards) — sort cost scales with operand count
    pos = jax.lax.broadcasted_iota(jnp.int32, idx.shape, 1)
    operands = tuple(neg_keys[..., i] for i in range(nk)) + (idx, pos)
    sorted_ops = jax.lax.sort(operands, dimension=1, num_keys=nk + 1)
    out_idx = sorted_ops[nk][:, :k]
    out_pos = sorted_ops[nk + 1][:, :k]
    out_scores = jnp.take_along_axis(scores, out_pos[..., None], axis=1)
    return out_scores, out_idx


def _score_planes(scores):
    """Normalise a scores argument to the six-(B, Q)-plane tuple form:
    either already a tuple/list of planes or a stacked (B, Q, 6)."""
    if isinstance(scores, (tuple, list)):
        return tuple(scores)
    return tuple(scores[..., i] for i in range(scores.shape[-1]))


def _key_planes(qd, planes):
    """Packed sort keys as a list of (B, Q) int32 planes (the plane
    form of _keys): no (.., 6)-minor layout."""
    p = [x.astype(jnp.int32) for x in planes]
    if qd.pack_keys:
        return [p[0] * KEY_SHIFT + p[1], p[2] * KEY_SHIFT + p[3],
                p[4] * KEY_SHIFT + p[5]]
    return p


def batch_flags_and_idx(qd, state, scores, ok, base_idx, ref_idx=None):
    """is_best flags (would this ref enter any query's current top-k?)
    and the per-row global database indices.  Pass `ref_idx` for a
    compacted batch with explicit (non-contiguous) indices.

    ``scores`` may be a stacked (B, Q, 6) array or the plane tuple from
    assemble_score_planes; the plane form keeps the key math on whole
    (B, Q) planes instead of a size-6 minor axis."""
    st_scores, _ = state
    planes = _score_planes(scores)
    cand = [jnp.where(ok[:, None], k, INT32_MIN)
            for k in _key_planes(qd, planes)]          # nk x (B, Q)
    thr = _keys(qd, st_scores[:, qd.k - 1, :])         # (Q, nk)
    gt = _lex_gt_planes(cand, [thr[None, :, i] for i in range(len(cand))])
    is_best = jnp.any(gt, axis=1) & ok
    if ref_idx is None:
        B = planes[0].shape[0]
        ref_idx = base_idx + jnp.arange(B, dtype=jnp.int32)
    batch_idx = jnp.where(ok, ref_idx, IDX_SENTINEL)
    return is_best, batch_idx


def merge_topk(qd: QueryDeviceData, state, scores, ok, base_idx,
               ref_idx=None):
    """Merge a scored batch into the running per-query top-k.

    state  — (scores (Q,k,6), idx (Q,k))
    scores — (B, Q, 6) int32 batch scores, or the six-(B, Q)-plane
             tuple from assemble_score_planes (preferred: keeps the
             flags math on whole planes and the cond operands unstacked)
    ok     — (B,) bool valid-row mask (padding/QC rejects False)
    base_idx — scalar int32 global index of batch row 0 (or pass
    ref_idx — explicit per-row indices for compacted batches)
    Returns (new_state, is_best (B,) bool).

    INVARIANT: rows must arrive in ascending global-index order across
    calls (every caller streams the DB forward).  The skip-if-no-best
    fast path rejects a candidate whose key TIES the k-th threshold;
    under ascending order that candidate would also lose select_topk's
    first-seen tie-break, so the skip is exact.  A caller presenting
    unordered ref_idx (re-scored/merged batches) would need equality in
    the is_best test to keep lower-index ties.
    """
    st_scores, st_idx = state
    planes = _score_planes(scores)
    B = planes[0].shape[0]
    is_best, batch_idx = batch_flags_and_idx(qd, state, planes, ok,
                                             base_idx, ref_idx)

    def merge_full(st_scores, st_idx):
        # the (Q, B, 6) stack is built INSIDE the branch: with plane
        # inputs the cond operands are six (B, Q) arrays and the
        # skip/steady-state path never materialises the stacked form
        all_scores = jnp.concatenate(
            [st_scores, jnp.stack([p.T for p in planes], axis=-1)],
            axis=1)
        all_idx = jnp.concatenate(
            [st_idx, jnp.broadcast_to(batch_idx[None, :],
                                      (qd.n_query, B))],
            axis=1)
        return select_topk(qd, all_scores, all_idx, qd.k)

    # candidate-window merge: only rows flagged is_best can enter any
    # top-k, and past warm-up those are FEW — compact them into a
    # C-row window so the lexicographic sort runs over (Q, k+C)
    # instead of (Q, k+B) (the multi-key sort dominates the merge at
    # large Q).  Compaction preserves ascending batch order, so
    # first-seen tie behaviour is unchanged.
    C = min(256, B)

    def merge_window(st_scores, st_idx):
        # compaction by gather: top_k picks the <=C flagged row
        # positions (value B-i keeps ascending batch order, so
        # first-seen tie behaviour is unchanged) and six (C, Q) gathers
        # pull just those rows
        rows = jnp.arange(B, dtype=jnp.int32)
        sel_val, sel_pos = jax.lax.top_k(
            jnp.where(is_best, B - rows, 0), C)
        sel_ok = sel_val > 0
        cand_idx = jnp.where(sel_ok, batch_idx[sel_pos], IDX_SENTINEL)
        cand_scores = jnp.stack(
            [jnp.where(sel_ok[:, None], p[sel_pos], -1) for p in planes],
            axis=-1)                                   # (C, Q, 6)
        all_scores = jnp.concatenate(
            [st_scores, jnp.transpose(cand_scores, (1, 0, 2))], axis=1)
        all_idx = jnp.concatenate(
            [st_idx, jnp.broadcast_to(cand_idx[None, :],
                                      (qd.n_query, C))], axis=1)
        return select_topk(qd, all_scores, all_idx, qd.k)

    def merge(st_scores, st_idx):
        if C == B:
            return merge_full(st_scores, st_idx)
        return jax.lax.cond(jnp.sum(is_best.astype(jnp.int32)) <= C,
                            merge_window, merge_full, st_scores, st_idx)

    # steady-state scans converge fast: once every query's top-k is
    # populated with close refs, most batches contribute nothing and
    # the sort is pure waste — skip it when no row can enter (the
    # dense-batch analogue of the C heap's O(1) reject,
    # min_heap.c:93-100)
    new_scores, new_idx = jax.lax.cond(
        jnp.any(is_best), merge, lambda a, b: (a, b), st_scores, st_idx)
    return (new_scores, new_idx), is_best


# ----------------------------------------------------------------------
# full jitted steps.  QueryDeviceData flows in as a pytree argument.

jax.tree_util.register_dataclass(
    QueryDeviceData,
    data_fields=["cons_full", "q_full", "amb_sites",
                 "w_part", "w_text", "q_poly",
                 "u_base", "q_pure_u", "idx_p",
                 "pure_p_q", "amb_tot_q", "delta_base"],
    meta_fields=["acgt", "n_query", "n_sites", "k", "pack_keys"],
)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host-side: pack two 4-bit codes per byte (halves H2D traffic).
    Pads an odd site count with code 0."""
    B, L = codes.shape
    if L % 2:
        codes = np.ascontiguousarray(
            np.pad(codes, ((0, 0), (0, 1))))
    pairs = codes.reshape(B, -1, 2)       # contiguous, vectorises cleanly
    return (pairs[:, :, 0] << 4 | pairs[:, :, 1]).astype(np.uint8)


def unpack_codes(packed: jnp.ndarray, n_sites: int) -> jnp.ndarray:
    """Device-side inverse of pack_codes."""
    hi = (packed >> 4) & 0xF
    lo = packed & 0xF
    both = jnp.stack([hi, lo], axis=-1).reshape(packed.shape[0], -1)
    return both[:, :n_sites]


# ----------------------------------------------------------------------
# sparse-delta uploads: most database genomes differ from the query
# majority at only ~10^2 of ~3*10^4 sites (SNPs + masked runs), so a
# (position, code) diff list at 3 bytes/site is ~10-50x smaller than the
# 4-bit packed row; the exact codes are rebuilt on device by one scatter.

DELTA_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _delta_lib():
    """Native encoder (fasta_io.cpp:ufa_delta_extract/repack), or None."""
    from ..io import native
    lib = native.get_lib()
    if lib is not None and not getattr(lib, "_delta_configured", False):
        import ctypes
        lib.ufa_delta_extract.restype = ctypes.c_long
        lib.ufa_delta_extract.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.ufa_delta_repack.restype = None
        lib.ufa_delta_repack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
        lib._delta_configured = True
    return lib


# per-thread scratch (B -> (pos, val, counts)): delta_encode may run
# from both the stream thread and the pipelined encode-ahead thread, so
# the buffers cannot be process-global; thread-local keeps each caller
# race-free without a lock (at ~12MB per thread per distinct B, and the
# thread count here is 2).
_delta_tls = threading.local()


def _rle_rewrite(row: np.ndarray, p: np.ndarray, v: np.ndarray):
    """Python mirror of the C encoder's in-place zero-run rewrite
    (fasta_io.cpp ufa_delta_extract): maximal runs of row zeros whose
    plain encoding takes >2 entries become (s, 16) + (e, 32 + row[e])
    markers (start only when the run reaches the row end).  Keeps the
    no-native path's output identical to the native one."""
    L = row.shape[0]
    op, ov = [], []
    i, c = 0, len(p)
    while i < c:
        if v[i] != 0:
            op.append(p[i]); ov.append(v[i]); i += 1
            continue
        s = e = int(p[i])
        while s > 0 and row[s - 1] == 0:
            s -= 1
        e += 1
        while e < L and row[e] == 0:
            e += 1
        j = i
        while j < c and p[j] < e:
            j += 1
        j2 = j + (1 if e < L and j < c and p[j] == e else 0)
        mcost = 2 if e < L else 1
        if j2 - i > mcost:
            op.append(s); ov.append(16)
            if e < L:
                op.append(e); ov.append(32 + int(row[e]))
            i = j2
        else:
            for k in range(i, j):
                op.append(p[k]); ov.append(0)
            i = j
    return op, ov


def delta_encode(codes: np.ndarray, ok: np.ndarray, base: np.ndarray):
    """Host-side: diff (B, L) uint8 rows against `base`.

    Returns (pos (B, E) uint16, val (B, E) uint8) with E the smallest
    bucket holding the fattest row, or None when a row exceeds the
    largest bucket (caller falls back to the 4-bit packed upload —
    beyond ~L/8 diffs the delta stops paying).  Long masked runs
    (N/'-' stretches encoding to 0 — the dominant diff source in real
    genomes, median ~3k sites/row on the bundled data) compress to
    start/end markers (val 16-47, see _rle_rewrite) instead of
    per-site entries, which is what keeps real data on the delta path
    at all.  Padding slots carry pos = L + slot so the device-side
    rebuild drops them (unique, ascending, out of range).  Rows with
    ok=False encode as empty (their scores are masked downstream).

    The diff scan runs in the native library when available (a numpy
    nonzero over (B, L) costs ~0.7s/batch — 25x the C++ XOR scan)."""
    B, L = codes.shape
    cap = DELTA_BUCKETS[-1]
    lib = _delta_lib()
    if lib is not None and L + cap < 2**16:
        import ctypes
        scratch = getattr(_delta_tls, "scratch", None)
        if scratch is None:
            scratch = _delta_tls.scratch = {}
        if B not in scratch:
            scratch[B] = (np.empty((B, cap), dtype=np.uint16),
                          np.empty((B, cap), dtype=np.uint8),
                          np.empty(B, dtype=np.int64))
        spos, sval, counts = scratch[B]
        codes = np.ascontiguousarray(codes)
        base_c = np.ascontiguousarray(base)
        okb = np.ascontiguousarray(ok.astype(np.uint8))
        top = lib.ufa_delta_extract(
            codes.ctypes.data_as(ctypes.c_void_p), B, L,
            base_c.ctypes.data_as(ctypes.c_void_p),
            okb.ctypes.data_as(ctypes.c_void_p), cap,
            spos.ctypes.data_as(ctypes.c_void_p),
            sval.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p))
        if top < 0:
            return None
        E = next(b for b in DELTA_BUCKETS if b >= top)
        pos = np.empty((B, E), dtype=np.uint16)
        val = np.empty((B, E), dtype=np.uint8)
        lib.ufa_delta_repack(
            spos.ctypes.data_as(ctypes.c_void_p),
            sval.ctypes.data_as(ctypes.c_void_p), B, cap,
            counts.ctypes.data_as(ctypes.c_void_p), E, L,
            pos.ctypes.data_as(ctypes.c_void_p),
            val.ctypes.data_as(ctypes.c_void_p))
        return pos, val
    diff = codes != base[None, :]
    if not ok.all():
        diff &= ok[:, None]
    rewritten = []
    top = 0
    for r in range(B):
        cols = np.nonzero(diff[r])[0]
        op, ov = _rle_rewrite(codes[r], cols, codes[r, cols])
        if len(op) > DELTA_BUCKETS[-1]:
            return None
        rewritten.append((op, ov))
        top = max(top, len(op))
    E = next((b for b in DELTA_BUCKETS if b >= top), None)
    if E is None:
        return None
    pdt = np.uint16 if L + E < 2**16 else np.uint32
    pos = np.broadcast_to(
        np.arange(L, L + E, dtype=pdt)[None, :], (B, E)).copy()
    val = np.zeros((B, E), dtype=np.uint8)
    for r, (op, ov) in enumerate(rewritten):
        pos[r, :len(op)] = op
        val[r, :len(ov)] = ov
    return pos, val


def _unmask_runs(img: jnp.ndarray) -> jnp.ndarray:
    """Decode zero-run markers painted into a reconstructed image:
    value 16 starts a run of zeros, 32+code ends it (carrying the true
    code of the first site after the run).  A cumsum along sites turns
    the start/end deltas into an inside-run mask; a run with no end
    marker extends to the row end (trailing masked tails)."""
    v = img.astype(jnp.int32)
    s_m = (v >= 16) & (v < 32)
    e_m = v >= 32
    inside = jnp.cumsum(s_m.astype(jnp.int32) - e_m.astype(jnp.int32),
                        axis=1) > 0
    out = jnp.where(e_m, v - 32, jnp.where(s_m, 0, v))
    return jnp.where(inside, 0, out).astype(jnp.uint8)


def reconstruct_delta(base: jnp.ndarray, pos: jnp.ndarray,
                      val: jnp.ndarray, width: int | None = None
                      ) -> jnp.ndarray:
    """Device-side inverse of delta_encode: (B, width) uint8 codes
    (width defaults to len(base); extra columns are zero).

    One scatter of the (B, E) diff entries into the broadcast base.
    delta_encode's contract makes its flags true: each row's positions
    are strictly ascending (unique, sorted row-major with the row
    iota), and padding slots sit at L + slot, out of range, where
    mode="drop" discards them.

    Zero-run markers (val 16-47, emitted for real genomes' masked
    N/'-' stretches) are decoded by a cumsum unmask pass, gated by a
    runtime cond so marker-free uploads (synthetic or clean data) pay
    nothing beyond the val inspection."""
    w = int(base.shape[0]) if width is None else width
    B, E = pos.shape
    codes = jnp.broadcast_to(base[None, :], (B, base.shape[0]))
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, E), 0)
    img = _to_width(
        codes.at[rows, pos.astype(jnp.int32)].set(
            val, mode="drop", unique_indices=True,
            indices_are_sorted=True), w)
    return jax.lax.cond(jnp.any(val >= 16), _unmask_runs,
                        lambda x: x, img)


def _scan_body(qd: QueryDeviceData, state, ref_codes, ok, base_idx):
    planes, _ = score_batch_planes(qd, ref_codes)
    return merge_topk(qd, state, planes, ok, base_idx)


@functools.partial(jax.jit, donate_argnums=1)
def scan_step(qd: QueryDeviceData, state, ref_codes, ok, base_idx):
    """One database batch: score + merge. Returns (state, is_best)."""
    return _scan_body(qd, state, ref_codes, ok, base_idx)


@functools.partial(jax.jit, static_argnums=5, donate_argnums=1)
def scan_steps_repeat(qd: QueryDeviceData, state, ref_codes, ok,
                      base_idx, n_steps: int):
    """``n_steps`` scan_step iterations over the same device-resident
    batch in ONE dispatch (bench utility).

    Measures the device-compute ceiling with no per-step host
    dispatch in the timing.  One byte of the batch is tied to the loop
    carry so XLA cannot hoist the otherwise loop-invariant scoring out
    of the fori_loop (which would turn the measurement into a
    single-step one).
    """
    B = ref_codes.shape[0]

    def body(i, st):
        ref = ref_codes.at[0, 0].set(
            (st[1][0, 0] & 0x7).astype(ref_codes.dtype) | 1)
        st, _ = _scan_body(qd, st, ref, ok, base_idx + i * B)
        return st

    return jax.lax.fori_loop(0, n_steps, body, state)


@functools.partial(jax.jit, donate_argnums=1)
def scan_step_packed(qd: QueryDeviceData, state, packed, ok, base_idx):
    """scan_step on 4-bit-packed codes (see pack_codes), unpacked on
    device."""
    planes, _ = score_batch_planes_packed(qd, packed)
    return merge_topk(qd, state, planes, ok, base_idx)


@functools.partial(jax.jit, static_argnums=5, donate_argnums=1)
def scan_steps_repeat_packed(qd: QueryDeviceData, state, packed, ok,
                             base_idx, n_steps: int):
    """scan_steps_repeat over a device-resident PACKED batch — the
    compute ceiling of the packed/streaming pipeline."""
    B = packed.shape[0]

    def body(i, st):
        # tie one byte to the carry so XLA cannot hoist the scoring
        # (see scan_steps_repeat)
        pk = packed.at[0, 0].set(
            (st[1][0, 0] & 0x7).astype(packed.dtype) | 16)
        planes, _ = score_batch_planes_packed(qd, pk)
        st, _ = merge_topk(qd, st, planes, ok, base_idx + i * B)
        return st

    return jax.lax.fori_loop(0, n_steps, body, state)


@functools.partial(jax.jit, donate_argnums=1)
def scan_step_delta(qd: QueryDeviceData, state, pos, val, ok, base_idx):
    """scan_step on a sparse-delta upload (see delta_encode)."""
    ref = reconstruct_delta(qd.delta_base, pos, val,
                            width=int(qd.q_full.shape[1]))
    planes, _ = score_batch_planes(qd, ref)
    return merge_topk(qd, state, planes, ok, base_idx)


@jax.jit
def prune_and_hold(qd: QueryDeviceData, state, packed, ok):
    """Phase 1 on packed codes; returns (survive mask, unpacked codes
    left on device so phase 2 never re-uploads)."""
    ref_codes = _to_width(unpack_codes(packed, qd.n_sites),
                          int(qd.q_full.shape[1]))
    return prune_step(qd, state, ref_codes, ok), ref_codes


@jax.jit
def prune_and_hold_delta(qd: QueryDeviceData, state, pos, val, ok):
    """prune_and_hold on a sparse-delta upload."""
    ref_codes = reconstruct_delta(qd.delta_base, pos, val,
                                  width=int(qd.q_full.shape[1]))
    return prune_step(qd, state, ref_codes, ok), ref_codes


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def accumulate_survivors(buf, buf_idx, buf_n, ref_codes, survive, base_idx):
    """Compact this batch's surviving rows into the device-resident
    survivor buffer (zero host round-trips).  Caller guarantees
    buf_n + B <= capacity by flushing first."""
    B = ref_codes.shape[0]
    s32 = survive.astype(jnp.int32)
    pos = buf_n + jnp.cumsum(s32) - s32
    cap = buf.shape[0]
    pos_w = jnp.where(survive, pos, cap)          # cap -> dropped
    buf = buf.at[pos_w].set(ref_codes, mode="drop")
    gidx = base_idx + jnp.arange(B, dtype=jnp.int32)
    buf_idx = buf_idx.at[pos_w].set(gidx, mode="drop")
    return buf, buf_idx, buf_n + jnp.sum(s32)


@functools.partial(jax.jit, donate_argnums=1)
def flush_survivors(qd: QueryDeviceData, state, buf, buf_idx, buf_n):
    """Phase 2 over the survivor buffer (slots >= buf_n masked).

    merge_topk's ascending-order invariant holds by construction:
    accumulate_survivors appends in stream order, so buf_idx[0:buf_n]
    is ascending and consecutive flushes cover disjoint increasing
    index ranges."""
    cap = buf.shape[0]
    ok = jnp.arange(cap, dtype=jnp.int32) < buf_n
    return scan_step_gather(qd, state, buf, ok, buf_idx)


# ----------------------------------------------------------------------
# two-phase pruned scan: a sound per-pair upper bound on the leading
# sort key lets most references skip the full per-query matmuls.  This
# is the dense-batch analogue of the reference's branch-and-bound
# (nearest.c:443-509) — but provably lossless: a reference is pruned
# only when its best-possible key is strictly below the query's current
# k-th threshold, so nothing that could enter the output is dropped.

@jax.jit
def prune_step(qd: QueryDeviceData, state, ref_codes, ok):
    """Phase 1: (B,) survivor mask.

    Leading-score bound (requires build_prune_data):

      s0(r, q) = sum_U [q_i pure][r_i == b_i]   (EXACT, one matmul)
               + s0_P                           (<= min pure counts on P)
      s1(r, q) <= s0_ub + min(amb_r, amb_q)     (full mode: text matches)
      s1(r, q) <= min(pure_r, pure_q) totals    (--acgt: valid acgt pairs)

    A reference survives for query q iff its packed key1 upper bound is
    >= q's current k-th threshold key; otherwise no candidate built
    from it can beat the threshold tuple (sound, lossless prune).
    """
    st_scores, _ = state
    ref_codes = _to_width(ref_codes, int(qd.u_base.shape[0]))
    pure_r_full = _pure(ref_codes)                               # (B, W)
    r_match = ((ref_codes == qd.u_base[None, :])
               & (qd.u_base != 0)[None, :]).astype(jnp.int8)
    s0_u = jax.lax.dot_general(
        r_match, qd.q_pure_u, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)                        # (B, Q)

    pure_p_r = jnp.sum(jnp.take(pure_r_full, qd.idx_p, axis=1)
                       .astype(jnp.int32), axis=1)               # (B,)
    s0_ub = s0_u + jnp.minimum(pure_p_r[:, None],
                               qd.pure_p_q[None, :])

    if qd.acgt:
        pure_tot_r = jnp.sum(pure_r_full.astype(jnp.int32), axis=1)
        pure_tot_q = qd.pure_p_q + jnp.sum(qd.q_pure_u.astype(jnp.int32),
                                           axis=1)
        s1_ub = jnp.minimum(pure_tot_r[:, None], pure_tot_q[None, :])
    else:
        amb_r = jnp.sum(((ref_codes != 0) & (pure_r_full == 0))
                        .astype(jnp.int32), axis=1)
        s1_ub = s0_ub + jnp.minimum(amb_r[:, None],
                                    qd.amb_tot_q[None, :])

    key1_ub = s0_ub * KEY_SHIFT + s1_ub if qd.pack_keys else s0_ub
    thr = _keys(qd, st_scores[:, qd.k - 1, :])[..., 0]           # (Q,)
    return ok & jnp.any(key1_ub >= thr[None, :], axis=1)


@functools.partial(jax.jit, donate_argnums=1)
def scan_step_gather(qd: QueryDeviceData, state, ref_codes, ok, ref_idx):
    """Phase 2: like scan_step but for a compacted survivor batch with
    explicit (non-contiguous) global database indices.

    CALLER CONTRACT: ref_idx must be ascending within the batch and
    across successive calls (merge_topk's skip-fast-path tie semantics
    rely on it); both callers — flush_survivors and the sharded flush
    (parallel/mesh.py) — satisfy it because survivor compaction
    preserves stream order."""
    planes, _ = score_batch_planes(qd, ref_codes)
    return merge_topk(qd, state, planes, ok, jnp.int32(0), ref_idx=ref_idx)


