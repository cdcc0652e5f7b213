"""Streaming exact nearest-neighbour search (the `uvaia` flagship).

Orchestration mirrors src/nearest.c:159-353 (read queries → QC → site
indices → stream DB in batches → per-query top-k → append-dump close
refs → ranked CSV), with the compute redesigned for an accelerator: every
batch is scored densely by int8 matmuls and merged into a device-resident
top-k state (ops/scan.py); host IO overlaps device compute via a prefetch
thread.

Outputs (identical conventions to nearest.c:198-200, 343, 513-547):
  <prefix>.aln.xz — every reference that at some point entered a
                    best set (superset of the final neighbours)
  <prefix>.csv.xz — ranked table: query,reference,rank + six scores
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


from ..io.compress import open_write
from ..ops import scan
from .query import QueryPack, build_query_pack, log
from .stream import RefStreamer, dump_entry, write_dump

CSV_HEADER_FULL = ("query,reference,rank,ACGT_matches,text_matches,"
                   "partial_matches,valid_pair_comparisons,"
                   "ACGT_matches_unique,valid_ref_sites\n")
CSV_HEADER_ACGT = ("query,reference,rank,ACGT_matches,"
                   "valid_ACGT_comparisons,ACGT_matches_unique,"
                   "valid_ref_sites,dist_consensus,dist_unique\n")


@dataclass
class NearestConfig:
    nbest: int = 100
    trim: int = 0
    acgt: bool = False
    keep_resolved: bool = False
    exclude_self: bool = False
    query_ambiguity: float = 0.5
    ref_ambiguity: float = 0.5
    pool: int = 4096                 # refs per device batch
    output: str | None = None
    print_interval: int = 10000
    n_devices: int | None = None     # shard the scan over a 'db' mesh axis
    site_shards: int = 1             # additionally shard the site axis
    checkpoint: str | None = None    # snapshot path (resume if it exists)
    checkpoint_every: float = 60.0   # seconds between snapshots
    codec: str = "xz"                # output compression: xz (default,
                                     # as the reference prefers),
                                     # bz2 / gz / raw (the rest of
                                     # biomcmc_open_compress's ladder,
                                     # nearest.c:234-236)
    prune: bool = True               # two-phase upper-bound prefilter
                                     # (exact; single-device AND
                                     # sharded paths)
    skip_records: int = 0            # raw-record window [skip, limit):
    limit_records: int = 0           # the multihost row splitter's way
                                     # of sharing ONE store across
                                     # hosts (limit requires store
                                     # inputs; 0 = unbounded)

    def clamp(self) -> "NearestConfig":
        self.query_ambiguity = min(max(self.query_ambiguity, 0.001), 1.0)
        self.ref_ambiguity = min(max(self.ref_ambiguity, 0.001), 1.0)
        self.nbest = max(self.nbest, 1)
        self.pool = max(self.pool, 8)
        return self

    @property
    def prefix(self) -> str:
        if self.output:
            return self.output
        return "nn_uvaia_acgt" if self.acgt else "nn_uvaia"


@dataclass
class NearestResult:
    pack: QueryPack
    scores: np.ndarray            # (Q, k, 6)
    indices: np.ndarray           # (Q, k) global db index or sentinel
    names: dict[int, str]         # db index -> reference name
    n_scanned: int = 0
    n_saved: int = 0
    n_invalid: int = 0
    same_name: int = 0
    n_delta_batches: int = 0      # batches uploaded as sparse deltas
    n_packed_batches: int = 0     # batches uploaded as 4-bit packed rows

    def rows(self):
        """Yield CSV rows (query, ref, rank, s0..s5)."""
        for qi, qname in enumerate(self.pack.names):
            rank = 0
            for slot in range(self.indices.shape[1]):
                ri = int(self.indices[qi, slot])
                if ri == int(scan.IDX_SENTINEL):
                    break
                rank += 1
                yield (qname, self.names.get(ri, f"db_{ri}"), rank,
                       *map(int, self.scores[qi, slot]))

    def write_csv(self, path: str) -> None:
        with open_write(path) as fh:
            fh.write((CSV_HEADER_ACGT if self.pack.acgt
                      else CSV_HEADER_FULL).encode())
            for row in self.rows():
                q, r, rank, *s = row
                fh.write((f"{q},{r},{rank}," +
                          ",".join(map(str, s)) + "\n").encode())


def run_nearest(ref_paths: list[str], query_path: str,
                cfg: NearestConfig) -> NearestResult:
    from ..utils.jaxcache import enable as _cache
    _cache()
    from ..utils.observe import maybe_profile
    with maybe_profile():
        return _run_nearest(ref_paths, query_path, cfg)


def _run_nearest(ref_paths: list[str], query_path: str,
                 cfg: NearestConfig) -> NearestResult:
    from ..utils.observe import Chronometer
    cfg.clamp()
    chrono = Chronometer()
    t0 = time.time()
    pack = build_query_pack(query_path, trim=cfg.trim, acgt=cfg.acgt,
                            ambiguity=cfg.query_ambiguity,
                            keep_resolved=cfg.keep_resolved)
    log(f"Prepared {pack.n_query} query sequences in "
        f"{time.time()-t0:.2f}s; scanning with top-k={cfg.nbest}, "
        f"batch={cfg.pool}")
    if cfg.acgt:
        log("Considering ACGT differences only "
            "(excluding all other characters).")
    else:
        log("Considering text match and partially ambiguous "
            "(excluding only gaps and Ns).")

    # persistent-store inputs (io/store.py): batches stream straight
    # from mmap with zero decode/encode; the store's delta base replaces
    # the query-majority base so uploads reuse the stored diff lists
    from ..io import store as store_mod
    n_store = sum(store_mod.is_store(p) for p in ref_paths)
    if n_store and n_store != len(ref_paths):
        raise SystemExit(
            "reference inputs mix ingested stores and FASTA files; "
            "scan them in separate runs (or ingest the FASTA too)")
    store_mode = n_store > 0
    store_base = store_mod.peek_store_base(ref_paths[0]) if store_mode \
        else None

    sharded = bool(cfg.n_devices and cfg.n_devices > 1)
    if sharded:
        from ..parallel.mesh import make_mesh, make_sharded_scan_step
        if cfg.site_shards < 1 or cfg.n_devices % cfg.site_shards:
            raise SystemExit(
                f"--site-shards {cfg.site_shards} must divide "
                f"--devices {cfg.n_devices} (mesh is db x site)")
        n_db = cfg.n_devices // cfg.site_shards
        cfg.pool = -(-cfg.pool // n_db) * n_db   # round up to divide evenly
        qd = scan.build_device_data(pack, k=cfg.nbest,
                                    site_shards=cfg.site_shards)
        mesh = make_mesh(n_db, cfg.site_shards)

        def make_step_fn():
            # dense sharded steps — only the non-prune loop uses these
            # (the sharded prune path builds its own survivor ops)
            sh_step = make_sharded_scan_step(qd, mesh)
            sh_step_delta = make_sharded_scan_step(qd, mesh, delta=True)

            def step_fn(st, batch, payload):
                ridx = batch.base_idx + np.arange(payload[1].shape[0],
                                                  dtype=np.int32)
                if payload[0] == "delta":   # sparse-delta (see ops/scan)
                    return sh_step_delta(st, jnp.asarray(payload[1]),
                                         jnp.asarray(payload[2]),
                                         jnp.asarray(batch.ok),
                                         jnp.asarray(ridx))
                return sh_step(st, jnp.asarray(payload[1]),
                               jnp.asarray(batch.ok), jnp.asarray(ridx))
            return step_fn
        log(f"Sharded scan over mesh (db={n_db}, site={cfg.site_shards})")
    else:
        qd = scan.build_device_data(pack, k=cfg.nbest)

        def make_step_fn():
            def step_fn(st, batch, payload):
                # sparse-delta upload when the batch is close to the
                # query majority (the realistic case: ~10-50x fewer H2D
                # bytes); 4-bit packed upload otherwise — bit-identical
                # either way.  The payload was encoded on the
                # EncodedStream thread while the previous batch's
                # upload/step was in flight.
                if payload[0] == "delta":
                    return scan.scan_step_delta(
                        qd, st, jnp.asarray(payload[1]),
                        jnp.asarray(payload[2]),
                        jnp.asarray(batch.ok), np.int32(batch.base_idx))
                return scan.scan_step_packed(
                    qd, st, jnp.asarray(payload[1]),
                    jnp.asarray(batch.ok), np.int32(batch.base_idx))
            return step_fn
    if store_base is not None:
        # before any step compiles: qd.delta_base rides into every
        # jitted step (pytree field / shard_map closure)
        qd.delta_base = jnp.asarray(store_base)
    delta_base = np.asarray(qd.delta_base)
    state = scan.init_state(pack.n_query, cfg.nbest)

    # ---- checkpoint / resume -----------------------------------------
    from ..utils import checkpoint as ckpt_mod
    ckpt_key = ckpt_mod.config_key(
        refs=list(ref_paths), query=query_path, nbest=cfg.nbest,
        trim=cfg.trim, acgt=cfg.acgt, keep_resolved=cfg.keep_resolved,
        exclude_self=cfg.exclude_self, qa=cfg.query_ambiguity,
        ra=cfg.ref_ambiguity, n_query=pack.n_query,
        skip=cfg.skip_records, limit=cfg.limit_records,
        # the dump file the checkpoint truncates/appends is codec-named
        # (prefix.aln.<codec>); resuming under a different --codec must
        # fail the config check, not corrupt a stale other-codec dump
        codec=cfg.codec)
    ckpt = ckpt_mod.load(cfg.checkpoint) if cfg.checkpoint else None
    if ckpt is not None and ckpt.config_key != ckpt_key:
        raise SystemExit(f"checkpoint {cfg.checkpoint} was written by a "
                         "different run configuration; remove it or use "
                         "a different path")
    names: dict[int, str] = {}
    skip, base0, resumed_written = cfg.skip_records, 0, 0
    if ckpt is not None:
        state = (jnp.asarray(ckpt.state_scores), jnp.asarray(ckpt.state_idx))
        names = dict(ckpt.names)
        skip, base0 = ckpt.records_read, ckpt.base_idx
        resumed_written = ckpt.n_written
        log(f"Resuming from checkpoint: {skip} records already scanned, "
            f"{resumed_written} sequences already dumped")

    exclude = set(pack.names) if cfg.exclude_self else None
    streamer_cls = store_mod.StoreStreamer if store_mode else RefStreamer
    extra_kw = {}
    if cfg.limit_records:
        if not store_mode:
            raise SystemExit(
                "record-window scanning (limit_records) requires "
                "ingested store inputs")
        extra_kw["limit_records"] = cfg.limit_records
    streamer = streamer_cls(ref_paths, pack.n_sites, cfg.pool,
                            ref_ambiguity=cfg.ref_ambiguity,
                            exclude_names=exclude,
                            skip_records=skip, initial_base=base0,
                            **extra_kw)
    if ckpt is not None:
        streamer.stats.count = ckpt.records_read
        streamer.stats.n_invalid = ckpt.n_invalid
        streamer.stats.same_name = ckpt.same_name

    import os as _os
    from ..io.fasta import WRITE_CODEC_SUFFIX, make_fasta_writer
    dump_base = cfg.prefix + ".aln"
    dump_path = dump_base + WRITE_CODEC_SUFFIX[cfg.codec]
    if ckpt is not None:
        # drop any truncated xz stream a crash left after the snapshot
        if _os.path.exists(dump_path) and \
                _os.path.getsize(dump_path) >= ckpt.dump_bytes:
            _os.truncate(dump_path, ckpt.dump_bytes)
        else:
            raise SystemExit(
                f"{dump_path} is smaller than the checkpoint recorded; "
                "the dump and checkpoint no longer match")
    # multi-stream xz on a thread pool: the superset dump can be
    # thousands of full genomes (every prune survivor / candidate),
    # and a single background lzma stream measured 9.4s of a 12.4s
    # real-data run — the drain thread could not keep up
    writer = make_fasta_writer(dump_base, cfg.codec,
                               append=ckpt is not None)
    t1 = time.time()
    last_print = 0
    last_ckpt = time.time()
    pending = None  # (flags_device, batch) for one-batch pipelining

    def _save_ckpt(prev_batch, state_host):
        """Snapshot through `prev_batch` (drained; state_host is the
        merged state at exactly that point).  The dump writer is closed
        first so the file ends on a complete xz stream whose size the
        checkpoint records."""
        nonlocal writer, resumed_written
        resumed_written += writer.n_written
        writer.close()
        ckpt_mod.save(cfg.checkpoint, ckpt_mod.ScanCheckpoint(
            version=ckpt_mod._VERSION, records_read=prev_batch.records_read,
            base_idx=prev_batch.base_idx + prev_batch.n,
            n_invalid=prev_batch.n_invalid,
            same_name=prev_batch.same_name,
            n_written=resumed_written,
            state_scores=state_host[0], state_idx=state_host[1],
            names=names, config_key=ckpt_key,
            dump_bytes=_os.path.getsize(dump_path)))
        writer = make_fasta_writer(dump_base, cfg.codec, append=True)

    def _drain(pending):
        flags, batch = pending
        flags = np.asarray(flags)[: batch.n]
        for i in np.nonzero(flags)[0]:
            names[batch.base_idx + int(i)] = batch.names[i]
            write_dump(writer, dump_entry(batch, int(i)))

    use_prune = cfg.prune
    if store_mode:
        encoded = streamer        # yields (batch, payload) from mmaps
    else:
        from .stream import EncodedStream
        encoded = EncodedStream(streamer, delta_base)
    uploads = {"delta": 0, "packed": 0}

    def _counted():
        for batch, payload in encoded:
            uploads[payload[0]] += 1
            yield batch, payload
    pairs = _counted()

    def _progress(total):
        nonlocal last_print
        if total - last_print >= cfg.print_interval:
            last_print = total
            # rate over THIS run's work: total includes the resumed
            # offset but t1 is this process's start
            rate = (total - base0) / max(time.time() - t1, 1e-9)
            log(f"Total: {streamer.stats.count} sequences analysed, "
                f"{resumed_written + writer.n_written} saved, "
                f"{streamer.stats.n_invalid} "
                f"poorly resolved. {rate:,.0f} genomes/sec. "
                f"{time.time()-t1:.1f}s elapsed.")

    if use_prune and sharded:
        # ---- sharded two-phase with DEVICE-RESIDENT survivor buffers:
        # prune data-parallel over 'db'; each shard compacts its own
        # surviving rows into a per-shard device buffer (zero survivor
        # re-uploads — the single-device prune_and_hold design, made
        # multi-chip); flush scores every shard's buffer and merges via
        # the 'db' all_gather.
        scan.build_prune_data(qd, pack)
        from ..parallel.mesh import make_sharded_survivor_ops
        B_loc = cfg.pool // n_db
        cap_loc = 2 * B_loc
        sv_init, prune_acc, prune_acc_delta, sv_flush = \
            make_sharded_survivor_ops(qd, mesh, cap_loc)
        bufs = sv_init()
        retained: dict[int, tuple[str, bytes]] = {}
        n_surv = 0

        def flush_p2_sharded():
            nonlocal state, bufs, retained
            if not retained:
                return
            idxs = np.asarray(bufs[1])
            state, flags, bufs = sv_flush(state, bufs)
            for slot in np.nonzero(np.asarray(flags))[0]:
                g = int(idxs[slot])
                entry = retained[g]
                names[g] = entry[0]
                write_dump(writer, entry)
            retained = {}

        for batch, payload in pairs:
            ridx = jnp.asarray(batch.base_idx +
                               np.arange(payload[1].shape[0],
                                         dtype=np.int32))
            if payload[0] == "delta":  # sparse-delta upload (see ops/scan)
                survive, bufs = prune_acc_delta(
                    state, bufs, jnp.asarray(payload[1]),
                    jnp.asarray(payload[2]), jnp.asarray(batch.ok), ridx)
            else:
                survive, bufs = prune_acc(
                    state, bufs, jnp.asarray(payload[1]),
                    jnp.asarray(batch.ok), ridx)
            sv = np.nonzero(np.asarray(survive)[: batch.n])[0]
            for i in sv:
                g = batch.base_idx + int(i)
                retained[g] = dump_entry(batch, int(i))
            n_surv += len(sv)
            # rows past a shard's buffer end would be dropped by the
            # scatter: flush whenever the fullest shard could overflow
            # on the next batch
            if int(np.asarray(bufs[2]).max()) + B_loc > cap_loc:
                flush_p2_sharded()
            if cfg.checkpoint is not None and \
                    time.time() - last_ckpt >= cfg.checkpoint_every:
                flush_p2_sharded()
                last_ckpt = time.time()
                _save_ckpt(batch, (np.asarray(state[0]),
                                   np.asarray(state[1])))
            _progress(batch.base_idx + batch.n)
        flush_p2_sharded()
        total = streamer.stats.count - streamer.stats.n_invalid - \
            streamer.stats.same_name
        log(f"Prefilter skipped the exact scan for {total - n_surv} of "
            f"{total} references (losslessly)")
    elif use_prune:
        scan.build_prune_data(qd, pack)
        # ---- two-phase: packed upload, device-side survivor buffer.
        # Phase 1 prunes on-device; surviving rows are compacted into a
        # device buffer (no re-upload) and phase 2 flushes it when full.
        W = int(qd.q_full.shape[1])     # device-side padded site width
        # survivor-buffer capacity: BIGGER cap means rarer flushes AND
        # rarer synchronisation — each flush scores the whole cap-row
        # buffer, so per-batch flush overhead ~ cap*s/(cap - 2*pool)
        # (s = survival rate) falls with cap.  ~1GB device-memory
        # ceiling.
        cap = max(2 * cfg.pool, min(8 * cfg.pool, (1 << 30) // max(W, 1)))
        buf = jnp.zeros((cap, W), dtype=jnp.uint8)
        buf_idx = jnp.full((cap,), scan.IDX_SENTINEL, dtype=jnp.int32)
        buf_n = jnp.int32(0)
        # host copies of only the SURVIVOR rows (name + dump payload),
        # keyed by global index — retaining whole batches until flush
        # would grow without bound when the prefilter prunes well
        retained: dict[int, tuple] = {}
        n_surv = 0
        warmed_up = False
        n_buf_host = 0    # lagged host mirror of buf_n (see drain)
        pending = None    # (survive_dev, batch) — drained ONE BEHIND:
                          # the survive transfer of batch i-1 overlaps
                          # batch i's prune/accumulate dispatches, so
                          # the per-batch device->host sync leaves the
                          # critical path

        def drain_pending():
            nonlocal pending, n_surv, n_buf_host
            if pending is None:
                return
            survive_d, pbatch = pending
            pending = None
            sv = np.nonzero(np.asarray(survive_d)[: pbatch.n])[0]
            for i in sv:
                retained[pbatch.base_idx + int(i)] = \
                    dump_entry(pbatch, int(i))
            n_surv += len(sv)
            n_buf_host += len(sv)

        def flush_p2():
            nonlocal state, buf_n, retained, n_buf_host
            drain_pending()
            if n_buf_host == 0:
                retained = {}
                return
            state, flags = scan.flush_survivors(qd, state, buf, buf_idx,
                                                buf_n)
            flags = np.asarray(flags)
            idxs = np.asarray(buf_idx)
            for slot in np.nonzero(flags)[0]:
                g = int(idxs[slot])
                entry = retained[g]
                names[g] = entry[0]
                write_dump(writer, entry)
            retained = {}
            buf_n = jnp.int32(0)
            n_buf_host = 0

        for batch, payload in pairs:
            if payload[0] == "delta":
                survive, codes_d = scan.prune_and_hold_delta(
                    qd, state, jnp.asarray(payload[1]),
                    jnp.asarray(payload[2]), jnp.asarray(batch.ok))
            else:
                survive, codes_d = scan.prune_and_hold(
                    qd, state, jnp.asarray(payload[1]),
                    jnp.asarray(batch.ok))
            buf, buf_idx, buf_n = scan.accumulate_survivors(
                buf, buf_idx, buf_n, codes_d, survive,
                np.int32(batch.base_idx))
            drain_pending()               # sync batch i-1, not i
            pending = (survive, batch)
            # safety without reading buf_n: after the drain,
            # n_buf_host covers through batch i-1 and the buffer
            # through batch i; if n_buf_host + 2*pool <= cap then even
            # a fully-surviving in-flight batch plus the NEXT batch
            # fit, so the scatter can never drop rows.  The warm-up
            # flush fires on the FIRST batch (synchronously — one
            # batch, once): prune thresholds only tighten at flushes
            # and an empty state prunes nothing, so without it a DB
            # smaller than cap would scan (and dump-flag) every row
            if not warmed_up or n_buf_host + 2 * cfg.pool > cap:
                flush_p2()
                warmed_up = True
            if cfg.checkpoint is not None and \
                    time.time() - last_ckpt >= cfg.checkpoint_every:
                flush_p2()
                last_ckpt = time.time()
                _save_ckpt(batch, (np.asarray(state[0]),
                                   np.asarray(state[1])))
            _progress(batch.base_idx + batch.n)
        flush_p2()
        total = streamer.stats.count - streamer.stats.n_invalid - \
            streamer.stats.same_name
        log(f"Prefilter skipped the exact scan for {total - n_surv} of "
            f"{total} references (losslessly)")
    else:
        step_fn = make_step_fn()
        # `pairs` handles both input kinds: StoreStreamer yields
        # (batch, payload) straight from mmaps; FASTA paths go through
        # the EncodedStream encode-ahead thread built above
        for batch, payload in pairs:
            # a due checkpoint snapshots the state BEFORE this step (its
            # buffers are donated into the step), consistent with the
            # dump/stream position after draining the previous batch
            ckpt_due = (cfg.checkpoint is not None and pending is not None
                        and time.time() - last_ckpt >= cfg.checkpoint_every)
            if ckpt_due:
                state_host = (np.asarray(state[0]), np.asarray(state[1]))
            state, flags_d = step_fn(state, batch, payload)
            if pending is not None:
                prev = pending[1]
                _drain(pending)
                if ckpt_due:
                    last_ckpt = time.time()
                    _save_ckpt(prev, state_host)
            pending = (flags_d, batch)
            _progress(batch.base_idx + batch.n)
        if pending is not None:
            _drain(pending)
    writer.close()

    result = NearestResult(
        pack=pack,
        scores=np.asarray(state[0]),
        indices=np.asarray(state[1]),
        names=names,
        n_scanned=streamer.stats.count,
        n_saved=resumed_written + writer.n_written,
        n_invalid=streamer.stats.n_invalid,
        same_name=streamer.stats.same_name,
        n_delta_batches=uploads["delta"],
        n_packed_batches=uploads["packed"],
    )
    log(f"Uploads: {result.n_delta_batches} sparse-delta batches, "
        f"{result.n_packed_batches} packed batches.")
    log(f"Total of {result.n_scanned} sequences read; {result.n_saved} "
        f"saved (close or intermediate), {result.n_invalid} too ambiguous "
        f"(excluded). {time.time()-t1:.2f}s scan time.")
    if cfg.exclude_self:
        log(f" {result.same_name} reference sequences already present in "
            "query alignment (based on name only).")
    csv_path = cfg.prefix + ".csv" + WRITE_CODEC_SUFFIX[cfg.codec]
    result.write_csv(csv_path)
    log(f"Saved distance table to {csv_path} ; "
        f"{chrono.total():.2f}s total.")
    return result
