"""Multi-device sharded database scan.

The reference's only parallelism is single-host OpenMP (SURVEY.md §2.5).
This design shards two axes of the scan over a device mesh:

* ``db``   — data parallelism over database rows: each device scores its
  slice of the batch, selects a local per-query top-k, and the per-query
  global state is rebuilt from an ``all_gather`` of the tiny
  (k × queries) candidate sets over the device interconnect.  Exactness: every global top-k
  member is necessarily in its own shard's local top-k.
* ``site`` — contraction/sequence parallelism over alignment columns
  (the context-parallel analogue, SURVEY.md §5): the site-summable
  counter partials from ops/scan.site_partials are ``psum``-reduced.

Replicated: the top-k state, the query feature arrays on the db axis,
and reference rows on the site axis (counters are reductions over
sites, so the activation is replicated while the reduction is sharded —
the standard "shard the contraction" layout).

Feature parity with the single-device path: reference batches arrive
4-bit *packed* (halving H2D traffic; unpacked on device inside the
shard_map body) and carry explicit per-row global indices, so the same
step also scans compacted survivor batches from the lossless prune
prefilter (``make_sharded_prune_step``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import scan


def make_mesh(n_db: int, n_site: int = 1, devices=None) -> Mesh:
    # local_devices, not devices: under jax.distributed each host runs
    # its own single-controller scan over its OWN devices (multihost.py
    # merges per-host top-k afterwards) — the global device list would
    # hand every host process 0's devices
    devices = devices if devices is not None else jax.local_devices()
    n = n_db * n_site
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.array(devices[:n]).reshape(n_db, n_site)
    return Mesh(dev, ("db", "site"))


def _scan_body(qd: scan.QueryDeviceData, n_db: int):
    """Shared shard_map body: score full-width local rows, merge into
    the replicated top-k state via a tiny 'db' all_gather.  Used by the
    plain sharded step and the survivor-buffer flush."""
    k = qd.k
    has_amb = qd.amb_sites is not None

    def body(st_scores, st_idx, cons_full, q_full, amb, poly,
             ref_codes, ok, ref_idx):
        b_loc = ref_codes.shape[0]
        # reference rows are replicated over 'site'; each shard
        # contracts only its own site-column block
        w_loc = q_full.shape[1]
        rc_loc = jax.lax.dynamic_slice_in_dim(
            ref_codes, jax.lax.axis_index("site") * w_loc, w_loc, axis=1)
        cons5, mats = scan.site_partials(
            qd.acgt, cons_full, q_full, rc_loc,
            poly if qd.acgt else None)
        cons5, mats = jax.lax.psum((cons5, mats), "site")
        # rebuild a local view so the big query arrays stay jit
        # arguments (not HLO constants; see QueryDeviceData docstring)
        qd_loc = scan.QueryDeviceData(
            acgt=qd.acgt, n_query=qd.n_query, n_sites=qd.n_sites,
            k=k, pack_keys=qd.pack_keys,
            cons_full=cons_full, q_full=q_full,
            amb_sites=amb[0] if has_amb else None,
            w_part=amb[1] if has_amb else None,
            w_text=amb[2] if has_amb else None)
        scores = scan.assemble_scores(qd_loc, ref_codes, cons5, mats)

        state = (st_scores, st_idx)
        is_best, batch_idx = scan.batch_flags_and_idx(
            qd_loc, state, scores, ok, jnp.int32(0), ref_idx=ref_idx)

        # local per-query top-k candidates (exact superset of the global)
        k_loc = min(k, b_loc)
        cand_scores, cand_idx = scan.select_topk(
            qd_loc, jnp.transpose(scores, (1, 0, 2)),
            jnp.broadcast_to(batch_idx[None, :], (qd.n_query, b_loc)),
            k_loc)

        # tiny all_gather across devices, then rebuild the replicated state
        g_scores = jax.lax.all_gather(cand_scores, "db", axis=0)
        g_idx = jax.lax.all_gather(cand_idx, "db", axis=0)
        g_scores = jnp.transpose(g_scores, (1, 0, 2, 3)).reshape(
            qd.n_query, n_db * k_loc, 6)
        g_idx = jnp.transpose(g_idx, (1, 0, 2)).reshape(
            qd.n_query, n_db * k_loc)
        all_scores = jnp.concatenate([st_scores, g_scores], axis=1)
        all_idx = jnp.concatenate([st_idx, g_idx], axis=1)
        new_scores, new_idx = scan.select_topk(qd_loc, all_scores,
                                               all_idx, k)
        return new_scores, new_idx, is_best

    return body


def make_sharded_scan_step(qd: scan.QueryDeviceData, mesh: Mesh,
                           delta: bool = False):
    """Jitted (state, payload, ok, ref_idx) -> (state, is_best) over a
    ('db','site') mesh.

    ``payload`` — the reference batch upload, sharded over 'db':
                  default a (B, ceil(L/2)) uint8 4-bit-packed matrix
                  (scan.pack_codes); with ``delta=True`` a (pos, val)
                  sparse-diff pair from scan.delta_encode, rebuilt on
                  each device against the replicated qd.delta_base.
                  B divisible by mesh.shape['db'].
    ``ref_idx`` — (B,) int32 global database index per row (contiguous
                  batches pass base + arange; compacted pruned batches
                  pass their gathered indices).
    QueryDeviceData must be built with site_shards=mesh.shape['site'].
    """
    n_db = mesh.shape["db"]
    has_amb = qd.amb_sites is not None
    W = int(qd.q_full.shape[1])
    body = _scan_body(qd, n_db)

    def local_step(st_scores, st_idx, cons_full, q_full,
                   amb, poly, payload, ok, ref_idx):
        if delta:
            pos, val, dbase = payload
            ref_codes = scan.reconstruct_delta(dbase, pos, val, width=W)
        else:
            ref_codes = scan._to_width(
                scan.unpack_codes(payload, qd.n_sites), W)
        return body(st_scores, st_idx, cons_full, q_full, amb, poly,
                    ref_codes, ok, ref_idx)

    amb_spec = (P(), P(), P()) if has_amb else P()
    poly_spec = P(None, "site") if qd.acgt else P()
    payload_spec = ((P("db", None), P("db", None), P()) if delta
                    else P("db", None))
    mapped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(),                     # state (replicated)
                  P("site"), P(None, "site"),   # cons_full, q_full
                  amb_spec,                     # amb correction tables
                  poly_spec,                    # acgt polymorphic subset
                  payload_spec,                 # ref batch over db
                  P("db"), P("db")),            # ok, ref_idx
        out_specs=(P(), P(), P("db")),
        check_vma=False,
    )

    amb = (qd.amb_sites, qd.w_part, qd.w_text) if has_amb else ()
    poly = qd.q_poly if qd.acgt else ()

    if delta:
        @functools.partial(jax.jit, donate_argnums=0)
        def step(state, pos, val, ok, ref_idx):
            new_scores, new_idx, is_best = mapped(
                state[0], state[1], qd.cons_full, qd.q_full,
                amb, poly, (pos, val, qd.delta_base), ok, ref_idx)
            return (new_scores, new_idx), is_best
    else:
        @functools.partial(jax.jit, donate_argnums=0)
        def step(state, packed, ok, ref_idx):
            new_scores, new_idx, is_best = mapped(
                state[0], state[1], qd.cons_full, qd.q_full,
                amb, poly, packed, ok, ref_idx)
            return (new_scores, new_idx), is_best

    return step


def make_sharded_prune_step(qd: scan.QueryDeviceData, mesh: Mesh,
                            delta: bool = False):
    """Jitted (state, payload, ok) -> survive (B,) bool — the lossless
    phase-1 prefilter (scan.prune_step) data-parallel over the 'db'
    axis.  The prefilter arrays (scan.build_prune_data) are replicated:
    they are O(Q*L) int8, small next to the scoring matmuls, and the
    bound is a whole-row computation that does not shard by sites.
    Must be called after scan.build_prune_data(qd, pack).  With
    ``delta=True`` the payload is a (pos, val) sparse-diff pair."""

    W = int(qd.q_full.shape[1])

    def local(st_scores, st_idx, u_base, q_pure_u, idx_p, pure_p_q,
              amb_tot_q, payload, ok):
        if delta:
            pos, val, dbase = payload
            ref_codes = scan.reconstruct_delta(dbase, pos, val, width=W)
        else:
            ref_codes = scan._to_width(
                scan.unpack_codes(payload, qd.n_sites), W)
        qd_loc = scan.QueryDeviceData(
            acgt=qd.acgt, n_query=qd.n_query, n_sites=qd.n_sites,
            k=qd.k, pack_keys=qd.pack_keys,
            cons_full=None, q_full=None,
            amb_sites=None, w_part=None, w_text=None,
            u_base=u_base, q_pure_u=q_pure_u, idx_p=idx_p,
            pure_p_q=pure_p_q, amb_tot_q=amb_tot_q)
        return scan.prune_step(qd_loc, (st_scores, st_idx), ref_codes, ok)

    payload_spec = ((P("db", None), P("db", None), P()) if delta
                    else P("db", None))
    mapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(),                     # state (replicated)
                  P(), P(), P(), P(), P(),      # prefilter arrays
                  payload_spec, P("db")),       # ref batch, ok
        out_specs=P("db"),
        check_vma=False,
    )

    if delta:
        @jax.jit
        def step(state, pos, val, ok):
            return mapped(state[0], state[1], qd.u_base, qd.q_pure_u,
                          qd.idx_p, qd.pure_p_q, qd.amb_tot_q,
                          (pos, val, qd.delta_base), ok)
    else:
        @jax.jit
        def step(state, packed, ok):
            return mapped(state[0], state[1], qd.u_base, qd.q_pure_u,
                          qd.idx_p, qd.pure_p_q, qd.amb_tot_q, packed, ok)

    return step


def make_sharded_survivor_ops(qd: scan.QueryDeviceData, mesh: Mesh,
                              cap_per_shard: int):
    """Device-resident survivor buffers for the sharded pruned scan —
    the multi-chip analogue of prune_and_hold / accumulate_survivors /
    flush_survivors (scan.py:689-727): surviving rows never leave the
    device, eliminating the host-compact-and-re-upload of the previous
    sharded path exactly where H2D is scarcest.

    Buffer layout (host-visible jax arrays, sharded over 'db'):
      buf     (n_db*cap, W) uint8   P('db', None)
      buf_idx (n_db*cap,)   int32   P('db')      global db index per row
      buf_n   (n_db,)       int32   P('db')      local fill count

    Returns (init, prune_acc, prune_acc_delta, flush):
      init()                                   -> (buf, buf_idx, buf_n)
      prune_acc(state, bufs, packed, ok, ridx) -> (survive, bufs)
      prune_acc_delta(state, bufs, pos, val, ok, ridx) -> same
      flush(state, bufs)                       -> (state, flags, bufs)
        flags (n_db*cap,) bool — aligned with buf_idx; slots past each
        shard's fill count are False.  The caller drains names via
        np.asarray(buf_idx)[flags] and MUST flush whenever
        max(buf_n) + B/n_db > cap (rows past cap are dropped by the
        scatter, as in the single-device path).

    Requires scan.build_prune_data(qd, pack) and site_shards-matched qd.
    """
    n_db = mesh.shape["db"]
    has_amb = qd.amb_sites is not None
    W = int(qd.q_full.shape[1])
    body = _scan_body(qd, n_db)
    dev_spec = jax.sharding.NamedSharding(mesh, P("db", None))
    idx_spec = jax.sharding.NamedSharding(mesh, P("db"))

    def init():
        buf = jax.device_put(
            np.zeros((n_db * cap_per_shard, W), np.uint8), dev_spec)
        buf_idx = jax.device_put(
            np.full(n_db * cap_per_shard, int(scan.IDX_SENTINEL),
                    np.int32), idx_spec)
        buf_n = jax.device_put(np.zeros(n_db, np.int32), idx_spec)
        return buf, buf_idx, buf_n

    def local_acc(st_scores, st_idx, u_base, q_pure_u, idx_p, pure_p_q,
                  amb_tot_q, buf, buf_idx, buf_n, payload, ok, ref_idx):
        if isinstance(payload, tuple):
            pos, val, dbase = payload
            ref_codes = scan.reconstruct_delta(dbase, pos, val, width=W)
        else:
            ref_codes = scan._to_width(
                scan.unpack_codes(payload, qd.n_sites), W)
        qd_loc = scan.QueryDeviceData(
            acgt=qd.acgt, n_query=qd.n_query, n_sites=qd.n_sites,
            k=qd.k, pack_keys=qd.pack_keys,
            cons_full=None, q_full=None,
            amb_sites=None, w_part=None, w_text=None,
            u_base=u_base, q_pure_u=q_pure_u, idx_p=idx_p,
            pure_p_q=pure_p_q, amb_tot_q=amb_tot_q)
        survive = scan.prune_step(qd_loc, (st_scores, st_idx),
                                  ref_codes, ok)
        # local compaction into this shard's buffer slice
        n0 = buf_n[0]
        s32 = survive.astype(jnp.int32)
        slot = n0 + jnp.cumsum(s32) - s32
        slot_w = jnp.where(survive, slot, cap_per_shard)   # cap -> drop
        buf = buf.at[slot_w].set(ref_codes, mode="drop")
        buf_idx = buf_idx.at[slot_w].set(ref_idx, mode="drop")
        return survive, buf, buf_idx, buf_n + jnp.sum(s32)

    def acc_specs(payload_spec):
        return ((P(), P(),                      # state (replicated)
                 P(), P(), P(), P(), P(),       # prefilter arrays
                 P("db", None), P("db"), P("db"),   # buffers
                 payload_spec, P("db"), P("db")),   # payload, ok, ref_idx
                (P("db"), P("db", None), P("db"), P("db")))

    in_p, out_p = acc_specs(P("db", None))
    acc_packed = jax.shard_map(local_acc, mesh=mesh, in_specs=in_p,
                               out_specs=out_p, check_vma=False)
    in_d, out_d = acc_specs((P("db", None), P("db", None), P()))
    acc_delta = jax.shard_map(local_acc, mesh=mesh, in_specs=in_d,
                              out_specs=out_d, check_vma=False)

    @functools.partial(jax.jit, donate_argnums=1)
    def prune_acc(state, bufs, packed, ok, ref_idx):
        survive, buf, buf_idx, buf_n = acc_packed(
            state[0], state[1], qd.u_base, qd.q_pure_u, qd.idx_p,
            qd.pure_p_q, qd.amb_tot_q, bufs[0], bufs[1], bufs[2],
            packed, ok, ref_idx)
        return survive, (buf, buf_idx, buf_n)

    @functools.partial(jax.jit, donate_argnums=1)
    def prune_acc_delta(state, bufs, pos, val, ok, ref_idx):
        survive, buf, buf_idx, buf_n = acc_delta(
            state[0], state[1], qd.u_base, qd.q_pure_u, qd.idx_p,
            qd.pure_p_q, qd.amb_tot_q, bufs[0], bufs[1], bufs[2],
            (pos, val, qd.delta_base), ok, ref_idx)
        return survive, (buf, buf_idx, buf_n)

    def local_flush(st_scores, st_idx, cons_full, q_full, amb, poly,
                    buf, buf_idx, buf_n):
        ok = jnp.arange(cap_per_shard, dtype=jnp.int32) < buf_n[0]
        # slots past the fill count hold STALE rows from earlier
        # flushes (buffers are reused, not cleared): zero their codes
        # and sentinel their indices so they can never re-enter the
        # top-k as duplicates (all-zero scores lose every comparison
        # against a real row, and sentinel ties lose on index)
        buf = jnp.where(ok[:, None], buf, 0)
        buf_idx = jnp.where(ok, buf_idx, scan.IDX_SENTINEL)
        new_scores, new_idx, is_best = body(
            st_scores, st_idx, cons_full, q_full, amb, poly,
            buf, ok, buf_idx)
        return new_scores, new_idx, is_best, jnp.zeros_like(buf_n)

    amb_spec = (P(), P(), P()) if has_amb else P()
    poly_spec = P(None, "site") if qd.acgt else P()
    flush_mapped = jax.shard_map(
        local_flush, mesh=mesh,
        in_specs=(P(), P(), P("site"), P(None, "site"), amb_spec,
                  poly_spec, P("db", None), P("db"), P("db")),
        out_specs=(P(), P(), P("db"), P("db")),
        check_vma=False)

    amb = (qd.amb_sites, qd.w_part, qd.w_text) if has_amb else ()
    poly = qd.q_poly if qd.acgt else ()

    @functools.partial(jax.jit, donate_argnums=0)
    def flush(state, bufs):
        new_scores, new_idx, flags, buf_n = flush_mapped(
            state[0], state[1], qd.cons_full, qd.q_full, amb, poly,
            bufs[0], bufs[1], bufs[2])
        return (new_scores, new_idx), flags, (bufs[0], bufs[1], buf_n)

    return init, prune_acc, prune_acc_delta, flush
