"""Batched banded global alignment with affine gaps, on device.

Device replacement for the reference's WFA gap-affine wavefront
aligner (align.c:306-309 uses penalties {match=0, mismatch=4,
gap_open=6, gap_extend=2}, "bwa-mem values", with adaptive wavefront
reduction).  Instead of translating the wavefront algorithm's
data-dependent loops, this computes the *optimal* banded Gotoh DP —
a fixed-shape anti-diagonal-free formulation that vectorises over
(batch x band):

* rows i = 1..n scanned with `lax.scan`; the in-row horizontal
  dependency (query-gap runs) is closed in O(log W) with a prefix
  cummin instead of a sequential loop;
* a packed traceback byte per cell is emitted to device memory;
* the traceback walk runs on device as a second scan, emitting the
  reference-projected alignment directly (M/X -> query char, D -> '-',
  I dropped), matching update_query_aligned (align.c:366-390);
* outputs are exactly ref-length rows — only n bytes/query leave the
  device.

Unlike WFA-Adapt (a heuristic reduction), the banded DP is exact
whenever the optimal path stays inside the band; `band_ok` flags
escapes so callers can retry with a wider band.

Cost model (minimisation): match 0, mismatch 4, gap of length g costs
6 + 2g.  Characters are raw ASCII bytes — like the reference, 'N' vs
'A' is a plain mismatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.int32(1 << 28)
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 2
OE = GAP_OPEN + GAP_EXT
UNROLL = 8       # DP rows per lax.scan iteration; at L=30k the
                 # per-iteration loop overhead dominates a (B, W) row's
                 # work, so amortise it 8x


def _row_kernel(ref, qp, qlen, lo, W, n, h_prev, x_prev, edge_min, i):
    """One banded Gotoh row of the forward.  Rows with i > n are masked
    to a no-op so the scan can run over UNROLL-padded row counts."""
    B = qp.shape[0]
    e = jnp.int32(GAP_EXT)
    oe = jnp.int32(OE)
    slots = jnp.arange(W, dtype=jnp.int32)
    j = i + lo + slots                       # (W,) col per slot
    jv = (j >= 0) & (j[None, :] <= qlen[:, None])

    # query chars for this row's band window: q[j-1]
    start = i + lo - 1 + (W + 1)
    qwin = jax.lax.dynamic_slice(qp, (0, start), (B, W))
    refc = ref[jnp.clip(i - 1, 0, n - 1)]
    sub = jnp.where(qwin == refc, 0, MISMATCH).astype(jnp.int32)
    sub = jnp.where((j[None, :] >= 1) & (j[None, :] <= qlen[:, None]),
                    sub, INF)

    m_row = h_prev + sub                     # diagonal: same slot

    shift = lambda a: jnp.concatenate(
        [a[:, 1:], jnp.full((B, 1), INF)], axis=1)
    x_open = shift(h_prev) + oe
    x_ext = shift(x_prev) + e
    x_row = jnp.minimum(x_open, x_ext)
    x_from_ext = x_ext <= x_open             # prefer extend on ties

    g_row = jnp.minimum(m_row, x_row)
    # y (query-consuming gap) via prefix cummin within the row:
    #   Y[t] = oe + (t-1-s)*e + min_{s<t} G[s]  (shift-by-one cummin)
    a = g_row - slots[None, :] * e
    c = jax.lax.cummin(a, axis=1)
    y_row = jnp.concatenate(
        [jnp.full((B, 1), INF),
         oe + (slots[1:] - 1)[None, :] * e + c[:, :-1]], axis=1)
    y_row = jnp.minimum(y_row, INF)

    h_row = jnp.minimum(g_row, y_row)
    h_row = jnp.where(jv, h_row, INF)
    h_row = jnp.minimum(h_row, INF)
    x_row = jnp.where(jv, x_row, INF)
    x_row = jnp.minimum(x_row, INF)

    y_open_direct = jnp.concatenate(
        [jnp.full((B, 1), INF), g_row[:, :-1] + oe], axis=1)
    y_from_ext = y_row < y_open_direct       # prefer open on ties
    g_from_x = x_row < m_row                 # argmin within G (M vs X)
    src = jnp.where(y_row < g_row, 2,
                    g_from_x.astype(jnp.int32)).astype(jnp.uint8)
    tb_row = (src | (x_from_ext.astype(jnp.uint8) << 2)
              | (y_from_ext.astype(jnp.uint8) << 3)
              | (g_from_x.astype(jnp.uint8) << 4))

    # running minimum over the band-edge diagonals: any path that
    # ever leaves the band must cross one of them (sound optimality
    # certificate, see band edge check in align_batch)
    new_edge = jnp.minimum(edge_min,
                           jnp.minimum(h_row[:, 0], h_row[:, W - 1]))
    live = i <= n
    h_row = jnp.where(live, h_row, h_prev)
    x_row = jnp.where(live, x_row, x_prev)
    new_edge = jnp.where(live, new_edge, edge_min)
    return h_row, x_row, new_edge, tb_row


def _forward_setup(ref, q, qlen, lo, width):
    n = ref.shape[0]
    B, m_pad = q.shape
    W = width
    n_pad = -(-n // UNROLL) * UNROLL
    e = jnp.int32(GAP_EXT)
    # left-pad queries so the per-row W-window slice is always in-bounds
    qp = jnp.concatenate(
        [jnp.zeros((B, W + 1), jnp.uint8), q,
         jnp.zeros((B, W + n_pad + 1), jnp.uint8)], axis=1)
    slots = jnp.arange(W, dtype=jnp.int32)
    # row 0: j = slot + lo ; H = gap cost of j insertions
    j0 = slots + lo
    h0 = jnp.where(j0 == 0, 0, jnp.where(j0 > 0, GAP_OPEN + e * j0, INF))
    h0 = jnp.where(j0 > qlen[:, None], INF, h0[None, :] * jnp.ones(
        (B, 1), jnp.int32))
    x0 = jnp.full((B, W), INF)
    edge0 = jnp.minimum(h0[:, 0], h0[:, W - 1])
    rows = jnp.arange(1, n_pad + 1, dtype=jnp.int32).reshape(-1, UNROLL)
    return n, n_pad, qp, h0, x0, edge0, rows


def _final_score(h_fin, qlen, lo, n, W):
    B = qlen.shape[0]
    t_end = qlen - n - lo
    score = h_fin[jnp.arange(B), jnp.clip(t_end, 0, W - 1)]
    score = jnp.where((t_end >= 0) & (t_end < W), score, INF)
    return score, t_end


@functools.partial(jax.jit, static_argnums=(3, 4))
def gotoh_forward(ref: jnp.ndarray, q: jnp.ndarray, qlen: jnp.ndarray,
                  lo: int, width: int):
    """Forward DP with packed traceback emission.

    ref  — (n,) uint8 reference bytes
    q    — (B, m_pad) uint8 query bytes (left-aligned, zero padded)
    qlen — (B,) int32 true query lengths
    lo   — diagonal offset of band slot 0 (d = j - i in [lo, lo+width))
    Returns (tb (n, B, W) uint8, score (B,), t_end (B,), edge_min (B,)).
    """
    n, n_pad, qp, h0, x0, edge0, rows = _forward_setup(
        ref, q, qlen, lo, width)
    B = q.shape[0]
    W = width

    def chunk(carry, ivec):
        h, x, em = carry
        tbs = []
        for u in range(UNROLL):
            h, x, em, tb_row = _row_kernel(
                ref, qp, qlen, lo, W, n, h, x, em, ivec[u])
            tbs.append(tb_row)
        return (h, x, em), jnp.stack(tbs)

    (h_fin, _, edge_min), tb = jax.lax.scan(chunk, (h0, x0, edge0), rows)
    tb = tb.reshape(n_pad, B, W)[:n]
    score, t_end = _final_score(h_fin, qlen, lo, n, W)
    return tb, score, t_end, edge_min


@functools.partial(jax.jit, static_argnums=(4, 5))
def gotoh_traceback(tb: jnp.ndarray, ref: jnp.ndarray, q: jnp.ndarray,
                    t_end: jnp.ndarray, lo: int, n: int):
    """Walk the packed traceback, emitting the ref-projected alignment.

    Returns (aligned (B, n) uint8 ('-' for deletions), done (B,) bool,
    band_edge (B,) bool — True if the path touched the band border,
    walk_cost (B,) int32 — the walked path's cost, for validation
    against the forward score).
    """
    B, m_pad = q.shape
    W = tb.shape[2]
    bidx = jnp.arange(B, dtype=jnp.int32)
    GAP = jnp.uint8(ord("-"))

    def read_src(i, t):
        v = tb[jnp.clip(i - 1, 0, n - 1), bidx, jnp.clip(t, 0, W - 1)]
        return v

    i0 = jnp.full((B,), n, dtype=jnp.int32)
    cur0 = read_src(i0, t_end)
    mat0 = (cur0 & 3).astype(jnp.int32)                  # H -> source matrix

    def step(carry, enable):
        # `cur` (the tb byte at (i, t)) rides in the carry: it is
        # always the previous step's `tgt` gather, so carrying it
        # halves the walk's gather count.  `enable` masks rows handled
        # by the M-run fast path this iteration.
        i, t, mat, cur, out, edge, cost = carry
        j = i + t + lo
        active = ((i > 0) | (j > 0)) & enable
        edge = edge | (active & (i > 0) & ((t <= 0) | (t >= W - 1)))

        lead_y = active & (i == 0)                 # leading insertions
        col0_x = active & (i > 0) & (j == 0)       # leading deletions
        is_m = active & ~lead_y & ~col0_x & (mat == 0)
        is_x = (active & ~lead_y & ~col0_x & (mat == 1)) | col0_x
        is_y = (active & ~lead_y & (mat == 2)) | lead_y
        x_ext = ((cur >> 2) & 1).astype(jnp.bool_)
        y_ext = ((cur >> 3) & 1).astype(jnp.bool_)

        qc = q[bidx, jnp.clip(j - 1, 0, m_pad - 1)]
        out_char = jnp.where(is_m, qc, GAP)
        write = is_m | is_x
        pos = jnp.where(write, i - 1, n)           # n -> dropped
        out = out.at[bidx, pos].set(out_char, mode="drop")

        ni = jnp.where(is_m | is_x, i - 1, i)
        nt = jnp.where(is_x, t + 1, jnp.where(is_y, t - 1, t))

        # next matrix state; a Y-gap *open* came from G = min(M, X),
        # whose argmin is bit 4 (H's bits 0-1 would wrongly allow Y)
        tgt = read_src(ni, nt)
        nxt = (tgt & 3).astype(jnp.int32)
        nxt_g = ((tgt >> 4) & 1).astype(jnp.int32)
        n_mat = jnp.where(
            is_m, nxt,
            jnp.where(is_x, jnp.where(x_ext, 1, nxt),
                      jnp.where(is_y, jnp.where(y_ext, 2, nxt_g), mat)))
        n_mat = jnp.where(active, n_mat, mat).astype(jnp.int32)
        n_cur = jnp.where(active, tgt, cur)
        ni = jnp.where(active, ni, i)
        nt = jnp.where(active, nt, t)

        # path-cost accounting (validation): sub at M, e per gap char,
        # + open when the run starts; leading insertions lumped when
        # the walk first lands on row 0 with columns left.
        refc = ref[jnp.clip(i - 1, 0, n - 1)]
        e32 = jnp.int32(GAP_EXT)
        inc = jnp.where(is_m, jnp.where(qc == refc, 0, MISMATCH), 0)
        inc += jnp.where(is_x, e32 + jnp.where(x_ext, 0, GAP_OPEN), 0)
        inc += jnp.where(is_y & ~lead_y,
                         e32 + jnp.where(y_ext, 0, GAP_OPEN), 0)
        nj = ni + nt + lo
        inc += jnp.where((i > 0) & (ni == 0) & (nj > 0),
                         GAP_OPEN + e32 * nj, 0)
        cost = cost + jnp.where(active, inc, 0)
        return (ni, nt, n_mat, n_cur, out, edge, cost), None

    out0 = jnp.full((B, n + 1), GAP, dtype=jnp.uint8)
    edge0 = jnp.zeros((B,), dtype=bool)
    cost0 = jnp.zeros((B,), dtype=jnp.int32)

    # the walk is a serial dependency chain of gathers, so trip count
    # matters.  M-RUN BATCHING cuts it: a diagonal
    # (match/mismatch) step keeps the band slot t FIXED and decrements
    # only the row, so a run of r consecutive M cells lies along
    # tb[i-1 .. i-r, b, t] — fetch R bytes of that line per iteration
    # and retire the whole leading M-run (up to R-1 cells) at once;
    # rows whose current move is a gap/boundary take one classic step.
    # Real 30kb genomes are ~99% match run, so iterations drop from
    # ~n to ~n/(R-1) + (#gap runs + #mismatch runs).
    R = 32
    karr = jnp.arange(R, dtype=jnp.int32)
    tb_flat = tb.reshape(-1)
    e32 = jnp.int32(GAP_EXT)

    def mega(carry):
        i, t, mat, cur, out, edge, cost = carry
        j = i + t + lo
        active = (i > 0) | (j > 0)
        # current move is a plain M-step (not leading-row/column case)
        can_run = active & (mat == 0) & (i > 0) & (j > 0)

        # classic single step for every other row
        (i1, t1, mat1, cur1, out, edge, cost), _ = step(
            (i, t, mat, cur, out, edge, cost), ~can_run)

        # M-run fast path: v[k] = tb byte at row i-1-k, slot t
        rowidx = i[:, None] - 1 - karr[None, :]             # (B, R)
        flat = (jnp.clip(rowidx, 0, n - 1) * (B * W)
                + (bidx * W + jnp.clip(t, 0, W - 1))[:, None])
        v = tb_flat[flat]                                   # (B, R)
        # step k stays in M iff the NEXT cell's H-source bits are M
        # (k=0 uses the carried mat, already in can_run)
        ok_next = jnp.concatenate(
            [can_run[:, None], (v[:, 1:] & 3) == 0], axis=1)
        okk = (ok_next & can_run[:, None] & (rowidx >= 0)
               & ((j[:, None] - 1 - karr[None, :]) >= 0))
        runlen = jnp.minimum(
            jnp.cumprod(okk.astype(jnp.int32), axis=1).sum(axis=1),
            R - 1)                                          # need v[runlen]

        kmask = karr[None, :] < runlen[:, None]
        qch = q[bidx[:, None],
                jnp.clip(j[:, None] - 1 - karr[None, :], 0, m_pad - 1)]
        refch = ref[jnp.clip(rowidx, 0, n - 1)]
        outpos = jnp.where(kmask, rowidx, n)                # n -> drop
        out = out.at[bidx[:, None], outpos].set(qch, mode="drop")
        run_cost = jnp.sum(
            jnp.where(kmask & (qch != refch), MISMATCH, 0), axis=1)
        i2 = i - runlen
        j2 = j - runlen
        # run ending on row 0 with columns left: lump the leading-
        # insertion cost here (the classic step does this at its own
        # row-0 transition)
        run_cost += jnp.where(can_run & (i2 == 0) & (j2 > 0),
                              GAP_OPEN + e32 * j2, 0)
        cur2 = jnp.take_along_axis(v, runlen[:, None], axis=1)[:, 0]
        edge = edge | (can_run & ((t <= 0) | (t >= W - 1)))

        ni = jnp.where(can_run, i2, i1)
        nt = jnp.where(can_run, t, t1)
        nmat = jnp.where(can_run, (cur2 & 3).astype(jnp.int32), mat1)
        ncur = jnp.where(can_run, cur2, cur1)
        ncost = cost + jnp.where(can_run, run_cost, 0)
        return ni, nt, nmat, ncur, out, edge, ncost

    # every iteration retires >= 1 path step per active row, so the
    # cap only guards against a corrupt traceback (done=False rows)
    max_iters = n + m_pad + 2

    def cond(carry):
        k, (i, t, *_rest) = carry
        return (k < max_iters) & jnp.any((i > 0) | ((i + t + lo) > 0))

    def chunk(carry):
        k, inner = carry
        return k + 1, mega(inner)

    _, (i_f, t_f, _, _, out, edge, cost) = jax.lax.while_loop(
        cond, chunk, (jnp.int32(0), (i0, t_end, mat0, cur0, out0,
                                     edge0, cost0)))
    done = (i_f == 0) & ((i_f + t_f + lo) == 0)
    return out[:, :n], done, edge, cost


EV_CAP = 192     # default event-checkpoint capacity per row


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def gotoh_traceback_events(tb: jnp.ndarray, t_end: jnp.ndarray, lo: int,
                           n: int, K: int):
    """Event-list traceback: O(#gap runs) instead of O(path length).

    The dense walk (gotoh_traceback) scatters every output character
    and gathers query/ref bytes for cost accounting — ~30k scattered+
    gathered elements per row regardless of how many rows an
    iteration retires.  This walk removes all of that: it records only
    the (i, t) checkpoints where the move kind (M / X / Y) CHANGES — mismatches are M-kind, so checkpoints
    occur only at gap-run boundaries, a handful per genome — and the
    host rebuilds the row from the query bytes it already holds
    (decode_events), validating the path cost there.

    Pure-diagonal stretches are skipped hierarchically: one fused pass
    over tb precomputes per-256-row and per-4096-row "all cells are
    M-source at this slot" flags, so an iteration can retire a whole
    block (the path cannot leave slot t inside an all-M block); a
    32-byte line probe handles partial blocks.  A SNP-only 30kb genome
    walks in ~15 iterations instead of ~30 000 single steps.

    Returns (ev_i (B,K) int32, ev_t (B,K) int32, cnt (B,) int32,
    done (B,) bool, edge (B,) bool, overflow (B,) bool).  Rows with
    overflow=True exceeded K checkpoints and must be re-walked densely.
    """
    _, B, W = tb.shape
    bidx = jnp.arange(B, dtype=jnp.int32)

    # hierarchical all-M(-source) flags; partial tail blocks reduced
    # separately so no padded intermediate materialises
    BL1 = 256
    BL2 = BL1 * 16
    full1 = n // BL1
    parts = []
    if full1:
        parts.append(((tb[:full1 * BL1] & 3) == 0)
                     .reshape(full1, BL1, B, W).all(axis=1))
    if full1 * BL1 < n:
        parts.append(((tb[full1 * BL1:] & 3) == 0).all(axis=0)[None])
    allM1 = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    n1 = allM1.shape[0]
    full2 = n1 // 16
    parts = []
    if full2:
        parts.append(allM1[:full2 * 16].reshape(full2, 16, B, W)
                     .all(axis=1))
    if full2 * 16 < n1:
        parts.append(allM1[full2 * 16:].all(axis=0)[None])
    allM2 = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    n2 = allM2.shape[0]

    tb_flat = tb.reshape(-1)
    R = 32
    karr = jnp.arange(R, dtype=jnp.int32)

    i0 = jnp.full((B,), n, dtype=jnp.int32)
    cur0 = tb[jnp.clip(i0 - 1, 0, n - 1), bidx,
              jnp.clip(t_end, 0, W - 1)]
    mat0 = (cur0 & 3).astype(jnp.int32)

    def body(carry):
        k, i, t, mat, cur, kprev, cnt, ev_i, ev_t, edge, ovf = carry
        j = i + t + lo
        active = (i > 0) | (j > 0)
        lead_y = active & (i == 0)
        col0_x = active & (i > 0) & (j == 0)
        is_m = active & ~lead_y & ~col0_x & (mat == 0)
        is_x = (active & ~lead_y & ~col0_x & (mat == 1)) | col0_x
        is_y = (active & ~lead_y & (mat == 2)) | lead_y
        kind = jnp.where(is_m, 0, jnp.where(is_x, 1, 2))

        rec = active & (kprev >= 0) & (kind != kprev)
        pos = jnp.where(rec & (cnt < K), cnt, K)       # K -> dropped
        ev_i = ev_i.at[bidx, pos].set(i, mode="drop")
        ev_t = ev_t.at[bidx, pos].set(t, mode="drop")
        ovf = ovf | (rec & (cnt >= K))
        cnt = cnt + rec.astype(jnp.int32)
        kprev = jnp.where(active, kind, kprev)
        edge = edge | (active & (i > 0) & ((t <= 0) | (t >= W - 1)))

        # ---- M-skip path: retire the longest provable diagonal run
        tcl = jnp.clip(t, 0, W - 1)
        r_top = i - 1                          # topmost tb row consumed
        blk1 = jnp.clip(r_top // BL1, 0, n1 - 1)
        blk2 = jnp.clip(r_top // BL2, 0, n2 - 1)
        cand1 = jnp.where(allM1[blk1, bidx, tcl], blk1 * BL1, i)
        cand2 = jnp.where(allM2[blk2, bidx, tcl], blk2 * BL2, i)
        rowidx = r_top[:, None] - karr[None, :]
        flat = (jnp.clip(rowidx, 0, n - 1) * (B * W)
                + (bidx * W + tcl)[:, None])
        v = tb_flat[flat]
        okk = (rowidx >= 0) & ((v & 3) == 0)
        runlen = jnp.cumprod(okk.astype(jnp.int32), axis=1).sum(axis=1)
        candR = i - runlen
        i2 = jnp.minimum(jnp.minimum(cand1, cand2), candR)
        i2 = jnp.maximum(i2, jnp.maximum(0, -t - lo))  # keep j2 >= 0
        cur2 = tb_flat[jnp.clip(i2 - 1, 0, n - 1) * (B * W)
                       + bidx * W + tcl]
        mat2 = (cur2 & 3).astype(jnp.int32)

        # ---- classic single step for gap / boundary rows
        x_ext = ((cur >> 2) & 1).astype(jnp.bool_)
        y_ext = ((cur >> 3) & 1).astype(jnp.bool_)
        ni_c = jnp.where(is_x, i - 1, i)
        nt_c = jnp.where(is_x, t + 1, jnp.where(is_y, t - 1, t))
        tgt = tb[jnp.clip(ni_c - 1, 0, n - 1), bidx,
                 jnp.clip(nt_c, 0, W - 1)]
        nxt = (tgt & 3).astype(jnp.int32)
        nxt_g = ((tgt >> 4) & 1).astype(jnp.int32)
        mat_c = jnp.where(is_x, jnp.where(x_ext, 1, nxt),
                          jnp.where(is_y, jnp.where(y_ext, 2, nxt_g),
                                    mat))

        ni = jnp.where(is_m, i2, jnp.where(active, ni_c, i))
        nt = jnp.where(is_m, t, jnp.where(active, nt_c, t))
        n_mat = jnp.where(is_m, mat2, jnp.where(active, mat_c, mat))
        n_cur = jnp.where(is_m, cur2, jnp.where(active, tgt, cur))
        return (k + 1, ni, nt, n_mat, n_cur, kprev, cnt, ev_i, ev_t,
                edge, ovf)

    max_iters = 2 * n + 2 * W + 8    # all-single-step worst case

    def cond(carry):
        k, i, t = carry[0], carry[1], carry[2]
        return (k < max_iters) & jnp.any((i > 0) | ((i + t + lo) > 0))

    init = (jnp.int32(0), i0, t_end.astype(jnp.int32), mat0, cur0,
            jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, K), jnp.int32), jnp.zeros((B, K), jnp.int32),
            jnp.zeros((B,), bool), jnp.zeros((B,), bool))
    (_, i_f, t_f, _, _, _, cnt, ev_i, ev_t, edge, ovf) = \
        jax.lax.while_loop(cond, body, init)
    done = (i_f == 0) & ((i_f + t_f + lo) == 0)
    return ev_i, ev_t, cnt, done, edge, ovf


def decode_events(q: np.ndarray, ref: np.ndarray, t_end: int, lo: int,
                  ev_i: np.ndarray, ev_t: np.ndarray, cnt: int):
    """Host-side inverse of gotoh_traceback_events: rebuild the
    ref-projected row and the walked path's cost from the checkpoint
    chain.  The segment kind between consecutive checkpoints is
    implied by the deltas (M: di>0, dt=0; X: dt=di>0; Y: di=0, dt<0).

    Recomputing the cost here (mismatch count over M segments + affine
    gap terms) and checking it against the DP score replaces the dense
    walk's device-side cost accumulator — it validates the DECODED
    OUTPUT end-to-end, so a corrupt traceback or decode cannot pass.

    Returns (row (n,) uint8, cost int) or (None, -1) if malformed.
    """
    n = ref.shape[0]
    out = np.empty(n, dtype=np.uint8)
    i, t = n, int(t_end)
    cost = 0
    chain = [(int(ev_i[k]), int(ev_t[k])) for k in range(cnt)]
    chain.append((0, -lo))
    for i2, t2 in chain:
        di = i - i2
        dt = t2 - t
        if di > 0 and dt == 0:        # M segment: rows (i2, i]
            s = t + lo
            if i2 + s < 0:
                return None, -1
            seg = q[i2 + s: i + s]
            if seg.shape[0] != di:
                return None, -1
            out[i2:i] = seg
            cost += MISMATCH * int(np.count_nonzero(seg != ref[i2:i]))
        elif di > 0 and dt == di:     # X (deletion) run
            out[i2:i] = ord("-")
            cost += GAP_OPEN + GAP_EXT * di
        elif di == 0 and dt < 0:      # Y (insertion) run
            cost += GAP_OPEN + GAP_EXT * (-dt)
        else:
            return None, -1
        i, t = i2, t2
    return out, cost


def unpack_meta_events(meta: np.ndarray, K: int):
    """Host-side split of the events align_rows meta buffer:
    (score, edge_min, done, cnt, overflow, t_end, ev_i (B,K),
    ev_t (B,K))."""
    return (meta[:, 0], meta[:, 1], meta[:, 2].astype(bool),
            meta[:, 3], meta[:, 4].astype(bool), meta[:, 5],
            meta[:, 6:6 + K], meta[:, 6 + K:6 + 2 * K])


def certify(score, edge_min, done, walk_cost, qlens, n, lo, width):
    """Host-side optimality certificates for a banded result.

    Certificate 1 (edge): any path that ever leaves the band crosses an
    edge diagonal (diagonals change by 1 per gap char) and then needs
    >= one gap char out and one back, costing 2*GAP_EXT beyond the edge
    cell's DP value.  If the banded score beats that, no out-of-band
    path can win.  ("The in-band optimum does not touch the edge" is
    NOT sound — a cheaper path may lie entirely outside the band.)

    Certificate 2 (wander): a path of cost c wanders at most c/(2e)
    diagonals beyond the [0, d_end] hull (out + back costs >= 2e per
    diagonal), so a band covering that hull +/- c/(2e) provably
    contains the global optimum.

    Returns (ok, consistent, wander) as numpy arrays.
    """
    score = np.asarray(score)
    gamma = np.asarray(edge_min).astype(np.int64) + 2 * GAP_EXT
    d_end = np.asarray(qlens).astype(np.int64) - n
    wander = score.astype(np.int64) // (2 * GAP_EXT) + 1
    covered = ((np.minimum(0, d_end) - wander >= lo)
               & (np.maximum(0, d_end) + wander <= lo + width - 1))
    consistent = (np.asarray(done) & (score < (1 << 27))
                  & (np.asarray(walk_cost) == score))
    ok = consistent & ((score < gamma) | covered)
    return ok, consistent, wander


@functools.partial(jax.jit, static_argnums=2)
def diff_encode(aligned: jnp.ndarray, ref: jnp.ndarray, E: int):
    """Sparse device->host encoding of ref-projected rows.

    A projected row differs from the reference at SNP/N/deletion sites
    only — typically a few hundred of 30k positions — so shipping
    (position, char) pairs beats shipping the row: (B, E)*5 bytes vs
    (B, n).  Returns (count (B,), pos (B, E) int32 ascending with n as
    filler, chars (B, E) uint8).  Rows with count > E must be fetched
    densely by the caller.
    """
    n = ref.shape[0]
    diff = aligned != ref[None, :]
    pos = jnp.where(diff,
                    jax.lax.broadcasted_iota(jnp.int32, aligned.shape, 1),
                    jnp.int32(n))
    pos = jax.lax.sort(pos, dimension=1)[:, :E]
    if pos.shape[1] < E:                     # short references: pad
        pad = jnp.full((pos.shape[0], E - pos.shape[1]), n, jnp.int32)
        pos = jnp.concatenate([pos, pad], axis=1)
    chars = jnp.take_along_axis(aligned, jnp.clip(pos, 0, n - 1), axis=1)
    return diff.sum(axis=1).astype(jnp.int32), pos, chars


@functools.partial(jax.jit, static_argnums=6)
def pack_outputs(aligned, ref, score, edge_min, done, walk_cost, E: int):
    """Fuse every host-bound per-row output of a group into ONE int32
    buffer (B, 5+E+E/4) so a group costs a single device->host
    transfer.

    Columns: [score, edge_min, done, walk_cost, diff_count,
    pos_0..pos_{E-1}, chars packed 4-per-int32] (pos/chars as in
    diff_encode)."""
    count, pos, chars = diff_encode(aligned, ref, E)
    c = chars.astype(jnp.int32).reshape(chars.shape[0], E // 4, 4)
    chars_packed = (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
                    | (c[..., 3] << 24))
    return jnp.concatenate(
        [score[:, None].astype(jnp.int32),
         edge_min[:, None].astype(jnp.int32),
         done[:, None].astype(jnp.int32),
         walk_cost[:, None].astype(jnp.int32),
         count[:, None], pos, chars_packed], axis=1)


def unpack_meta(meta: np.ndarray, E: int):
    """Host-side inverse of pack_outputs: (score, edge_min, done,
    walk_cost, count, pos (B,E), chars (B,E))."""
    chars = meta[:, 5 + E:].astype(np.uint32)
    chars = np.stack([(chars >> s) & 0xFF for s in (0, 8, 16, 24)],
                     axis=-1).reshape(meta.shape[0], E).astype(np.uint8)
    return (meta[:, 0], meta[:, 1], meta[:, 2].astype(bool), meta[:, 3],
            meta[:, 4], meta[:, 5:5 + E], chars)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def align_rows(ref, arr_all, lens_all, idx, lo: int, width: int, K: int):
    """One-dispatch group aligner (events form): device-side row gather
    + forward + event-list traceback, fused into a single int32 meta
    buffer (B, 6+2K): [score, edge_min, done, cnt, overflow, t_end,
    ev_i (K), ev_t (K)].  One jit call and ONE small device->host
    transfer per group; the host rebuilds rows from the query bytes it
    already holds (decode_events).  Rows with overflow=True need the
    dense fallback (align_rows_dense)."""
    arr = jnp.take(arr_all, idx, axis=0)
    lens = jnp.take(lens_all, idx, axis=0)
    tb, score, t_end, edge_min = gotoh_forward(ref, arr, lens, lo, width)
    ev_i, ev_t, cnt, done, edge, ovf = gotoh_traceback_events(
        tb, t_end, lo, ref.shape[0], K)
    i32 = lambda a: a.astype(jnp.int32)[:, None]
    meta = jnp.concatenate(
        [i32(score), i32(edge_min), i32(done), i32(cnt), i32(ovf),
         i32(t_end), ev_i, ev_t], axis=1)
    return meta


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def align_rows_dense(ref, arr_all, lens_all, idx, lo: int, width: int,
                     E: int):
    """Dense-walk group aligner: forward + per-character traceback +
    fused output packing.  Slower than align_rows (element-throughput-
    bound walk) — kept as the fallback for event-capacity overflow
    rows.  Returns (meta, aligned): fetch meta; `aligned` stays on
    device for dense-fetch rows (diff count > E)."""
    arr = jnp.take(arr_all, idx, axis=0)
    lens = jnp.take(lens_all, idx, axis=0)
    tb, score, t_end, edge_min = gotoh_forward(ref, arr, lens, lo, width)
    aligned, done, edge, walk_cost = gotoh_traceback(
        tb, ref, arr, t_end, lo, ref.shape[0])
    meta = pack_outputs(aligned, ref, score, edge_min, done,
                        walk_cost, E)
    return meta, aligned


def align_batch(ref: np.ndarray, queries: np.ndarray, qlens: np.ndarray,
                lo: int, width: int):
    """Host wrapper: forward + event traceback + host decode.  Returns
    (aligned (B, n) uint8, score (B,), ok (B,) — provably-optimal-and-
    consistent flag, consistent (B,), wander (B,))."""
    n = ref.shape[0]
    tb, score, t_end, edge_min = gotoh_forward(
        jnp.asarray(ref), jnp.asarray(queries),
        jnp.asarray(qlens, dtype=jnp.int32), lo, width)
    ev_i, ev_t, cnt, done, edge, ovf = gotoh_traceback_events(
        tb, t_end, lo, n, EV_CAP)
    ev_i, ev_t, cnt = np.asarray(ev_i), np.asarray(ev_t), np.asarray(cnt)
    done, ovf = np.asarray(done), np.asarray(ovf)
    t_end = np.asarray(t_end)
    B = queries.shape[0]
    aligned = np.zeros((B, n), dtype=np.uint8)
    walk_cost = np.full(B, -1, dtype=np.int64)
    decoded = np.zeros(B, dtype=bool)
    for b in range(B):
        if ovf[b] or not done[b]:
            continue
        row, cost = decode_events(queries[b], ref, t_end[b], lo,
                                  ev_i[b], ev_t[b], int(cnt[b]))
        if row is not None:
            aligned[b] = row
            walk_cost[b] = cost
            decoded[b] = True
    fallback = np.asarray(done) & ~decoded
    if fallback.any():
        # event-capacity overflow / decode failure: dense per-character
        # walk for those rows (same fallback _collect_group uses)
        al_d, done_d, _edge, wc_d = gotoh_traceback(
            tb, jnp.asarray(ref), jnp.asarray(queries), t_end, lo, n)
        al_d, done_d, wc_d = (np.asarray(al_d), np.asarray(done_d),
                              np.asarray(wc_d))
        for b in np.nonzero(fallback & done_d)[0]:
            aligned[b] = al_d[b, :n]
            walk_cost[b] = wc_d[b]
            decoded[b] = True
    ok, consistent, wander = certify(score, edge_min, done & decoded,
                                     walk_cost, qlens, n, lo, width)
    return aligned, np.asarray(score), ok, consistent, wander
