"""One-pass canopy clustering / dedup (the `uvaiaclust` equivalent).

Capability match for src/cluster.c + the cluster primitives in
fastaseq.c:95-293: stream alignments, group sequences whose pairwise
text-mismatch distance is <= `distance`, keep one medoid per cluster
(the most resolved member, add_seq_to_cluster fastaseq.c:182), record
every member name, and write the medoid alignment + membership table.

Accelerator-first reformulation (documented deviations from the C design,
which is itself order-dependent and approximate):

* the C pool of per-thread queues + log2 merge reduction
  (cluster.c:219-230) becomes ONE global cluster set scanned densely:
  each batch computes exact mismatch distances to ALL current medoids
  as int8 matmuls (15 int8 features/site: valid + pure-base one-hot +
  ambiguity-code one-hot close the text-match count exactly), then a
  final all-pairs medoid merge pass replaces the queue merges;
* the C distance-to-reference "ring" prefilter (fastaseq.c:154) is an
  approximation under gap-skipping distances and is not needed here —
  distances are computed exactly for all pairs;
* within a batch, sequences join clusters by batch-start medoids (the
  C pool queues are blind to each other until merge, so this is
  strictly more connected).

Reference sequence: first sequence of -r, or a consensus built from
the first <=1024 database sequences with N fill-in and final N->A
(read_reference_sequence cluster.c:260-277, fastaseq.c:488-520).
Medoid distance-to-reference is reported like quick_pairwise_score_
reference (valid-pair char mismatches over the trim window).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core.encoding import IS_PURE, encode
from ..io.compress import open_write
from ..io.fasta import read_fasta
from .query import log


@dataclass
class ClusterConfig:
    distance: int = 1
    trim: int = 0
    pool: int = 1024              # sequences per device batch
    snps: int = 1                 # SNP positions tracked (sort tiebreak)
    reference: str | None = None
    output: str | None = None
    medoid_capacity: int = 1 << 17
    print_interval: int = 5000
    save_interval: float = 30.0   # secs between partial table saves
                                  # (cluster.c:197-200 resilience)
    codec: str = "xz"             # output compression: xz/bz2/gz/raw

    @property
    def prefix(self) -> str:
        return self.output if self.output else "cluster_uvaia"


@dataclass
class Cluster:
    name: str
    seq: bytes
    non_n: int
    dist_ref: int
    snp_pos: tuple      # positions of the first -s SNPs vs the reference
                        # (sort tiebreak, quick_pairwise_score_reference
                        # fastaseq.c:522-537)
    neighbours: list[str] = field(default_factory=list)


def _ref_seqs(path: str):
    """Sequence bytes from a FASTA file or an ingested store (stores
    decode rows exactly — io/store.py seq_row)."""
    from ..io import store as store_mod
    if store_mod.is_store(path):
        st = store_mod.Store(path)
        for r in range(st.n_rows):
            yield st.seq_row(r)
    else:
        for rec in read_fasta(path):
            yield rec.seq


def build_reference(path: str, max_seqs: int) -> tuple[bytes, int]:
    """Consensus reference from up to max_seqs sequences: start with the
    first (non-ACGT -> N), fill Ns from later ACGT, then N -> A."""
    ref = None
    count = 0
    L = 0
    for seq in _ref_seqs(path):
        codes = encode(seq)
        acgt = IS_PURE[codes] != 0
        arr = np.frombuffer(seq, dtype=np.uint8).copy()
        arr[~acgt] = ord("N")
        if ref is None:
            ref = arr
            L = len(arr)
        else:
            if len(arr) != L:
                raise SystemExit("cluster: sequences are not aligned")
            fill = (ref == ord("N")) & acgt
            ref[fill] = arr[fill]
        count += 1
        if count >= max_seqs:
            break
    if ref is None:
        raise SystemExit(f"No sequences found in {path}")
    ref[ref == ord("N")] = ord("A")
    return ref.tobytes(), L


class MedoidIndex:
    """Device-resident medoid code matrix + exact mismatch distances."""

    STORE_TILE = 4096       # medoid rows per distance tile (bounds the
                            # (tile, L, 10) int8 feature planes in device memory)

    def __init__(self, L: int, capacity: int, trim: int,
                 initial_tier: int = 1024,
                 delta_base: np.ndarray | None = None,
                 stats_ref: np.ndarray | None = None, n_snps: int = 1):
        import jax.numpy as jnp
        self.jnp = jnp
        self.L = L
        self.trim = trim
        self.capacity = capacity
        self.n = 0
        self._assign = None
        self._delta_base = delta_base          # host copy for encoding
        self._delta_base_d = (None if delta_base is None
                              else jnp.asarray(delta_base))
        # comparison reference for per-row stats (non_n / dist_ref /
        # first-n_snps SNP positions): when given, assign() folds the
        # stats into the fused device step — the batch codes are
        # already rebuilt on device there, while the host numpy pass
        # (_seq_stats) is a full extra pass over every row
        self._stats_ref_d = (None if stats_ref is None
                             else jnp.asarray(stats_ref))
        self._n_snps = max(0, int(n_snps))
        # store sized in x4 tiers: distance kernels only ever see the
        # current tier, and each grow step costs one recompile (so
        # fewer/larger tiers win over tighter memory)
        self.tier = initial_tier
        self._codes = jnp.zeros((self.tier, L), dtype=jnp.uint8)

        window = np.zeros(L, dtype=bool)
        window[trim:L - trim if trim else L] = True
        self._window = jnp.asarray(window)

        def dists(batch_codes, med_codes):
            cb = jnp.where(self._window[None, :], batch_codes, 0)
            cm = jnp.where(self._window[None, :], med_codes, 0)
            import jax.lax as lax

            def f(codes):
                c = codes.astype(jnp.int32)
                bits = jnp.stack([(c >> i) & 1 for i in range(4)], -1)
                pop = bits.sum(-1)
                a = (bits * (pop == 1)[..., None]).astype(jnp.int8)
                v = (c != 0).astype(jnp.int8)
                amb_codes = jnp.asarray(
                    [3, 5, 6, 7, 9, 10, 11, 12, 13, 14], dtype=jnp.int32)
                e = (c[..., None] == amb_codes).astype(jnp.int8) \
                    * ((c != 0) & (pop != 1)).astype(jnp.int8)[..., None]
                return v, jnp.concatenate([a, e], axis=-1)

            vb, mb = f(cb)
            vm, mm = f(cm)
            dot = lambda x, y: lax.dot_general(
                x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1),
                (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
            return dot(vb, vm) - dot(mb, mm)        # valid - text_matches

        import jax as _jax
        self._dist_expr = dists
        self._dists = _jax.jit(dists)
        self._append = _jax.jit(
            lambda store, rows, at: _jax.lax.dynamic_update_slice(
                store, rows, (at, 0)), donate_argnums=0)
        # one-dispatch store update from the step's device codes:
        # rows codes_d[src[i]] -> store row dst[i] for i < k, the
        # padded tail scatters out of bounds and is DROPPED.  src/dst
        # are TRACED (padded to _UPD_BUCKETS), so per-batch medoid
        # bookkeeping never bakes index values into the HLO — indexing
        # codes_d[b] / codes_d[rows] at the python level recompiled a
        # fresh gather for every distinct row set, which is what made
        # the first store-input cluster run on the real 9185-genome DB
        # compile once per batch
        self._update = _jax.jit(
            lambda store, codes_d, src, dst, k: store.at[
                jnp.where(jnp.arange(src.shape[0]) < k,
                          dst, store.shape[0])].set(
                codes_d[src], mode="drop"),
            donate_argnums=0)

    _UPD_BUCKETS = (8, 64, 512, 4096)

    def apply_updates(self, codes_d, replacements: dict[int, int],
                      new_rows: list[int]) -> None:
        """Medoid store maintenance for one batch, in ONE scatter:
        ``replacements`` maps store row -> batch row (last writer per
        store row, matching the sequential semantics), ``new_rows``
        appends batch rows as fresh medoids in order.  ``codes_d`` is
        the (B, L) device codes returned by assign."""
        k_new = len(new_rows)
        if not replacements and not k_new:
            return
        if self.n + k_new > self.capacity:
            raise SystemExit("cluster: medoid capacity exceeded; raise "
                             "--medoid-capacity")
        while self.n + k_new > self.tier:
            pad = self.jnp.zeros((3 * self.tier, self.L),
                                 dtype=self.jnp.uint8)
            self.tier *= 4
            self._codes = self.jnp.concatenate([self._codes, pad],
                                               axis=0)
        dst = list(replacements.keys()) + [self.n + i
                                           for i in range(k_new)]
        src = list(replacements.values()) + list(new_rows)
        k = len(dst)
        P = next((p for p in self._UPD_BUCKETS if p >= k),
                 -(-k // 4096) * 4096)    # pool > 4096: static per pool
        src += [0] * (P - k)
        dst += [0] * (P - k)
        self._codes = self._update(
            self._codes, codes_d,
            self.jnp.asarray(np.asarray(src, np.int32)),
            self.jnp.asarray(np.asarray(dst, np.int32)), np.int32(k))
        self.n += k_new

    def assign(self, codes: np.ndarray, ok: np.ndarray, distance: int,
               payload=None, base_d=None):
        """Fused batch step: one (delta-encoded) upload, and only O(B)
        + O(B^2) bool leaves the device — never the (B, M) distance
        matrix (57MB per batch at M=14k medoids measured; the D2H
        download was the wall of the v1 design).

        `payload` (store input): a StoreStreamer payload — ("delta",
        pos, val) PRE-encoded against `base_d` (the streamer's base,
        on device) or ("packed", pk) — uploaded as-is, skipping the
        host nibble-unpack AND host re-encode; `codes`/`ok` are
        ignored then and may be None.

        Returns (first_hit (B,) int32 — lowest medoid index within
        `distance`, -1 if none; self_mask (B, B) bool — within-batch
        pairs within `distance`); when the index was built with
        `stats_ref`, also (non_n (B,) int32, dist_ref (B,) int32,
        snp (B, n_snps) int32 — first SNP positions vs stats_ref, -1
        padded), matching _seq_stats exactly (tested); and last the
        (B, L) uint8 batch codes AS A DEVICE ARRAY (for device-side
        medoid append/replace)."""
        import jax
        jnp = self.jnp
        if self._assign is None:
            def assign_fn(dist, pos, val, packed, use_delta, store, n_med,
                          base):
                # `base` is the base the (pos, val) payload was encoded
                # against — self._delta_base_d for host-encoded batches,
                # the STORE's own base for store payloads; the caller
                # pairs them (see assign's payload contract)
                from ..ops import scan as scan_ops
                if use_delta:
                    codes_d = scan_ops.reconstruct_delta(base, pos, val)
                else:
                    codes_d = scan_ops.unpack_codes(packed, self.L)
                # scan the store in tiles: the one-hot feature planes
                # are (tile, L, 10) int8 — materialising them for the
                # whole store runs out of device memory past ~32k
                # medoids
                tile = min(store.shape[0], self.STORE_TILE)
                n_tiles = store.shape[0] // tile
                store_t = store.reshape(n_tiles, tile, self.L)
                big = jnp.int32(2**31 - 1)

                def body(first, inp):
                    t_idx, tile_codes = inp
                    d = self._dist_expr(codes_d, tile_codes)  # (B, tile)
                    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
                    gcol = col + t_idx * tile
                    hit = (d <= dist) & (gcol < n_med)
                    tf = jnp.where(hit.any(axis=1),
                                   jnp.argmax(hit, axis=1)
                                   + t_idx * tile, big)
                    return jnp.minimum(first, tf), None

                first, _ = jax.lax.scan(
                    body, jnp.full(codes_d.shape[0], big, jnp.int32),
                    (jnp.arange(n_tiles, dtype=jnp.int32), store_t))
                first = jnp.where(first < big, first, -1)
                d_self = self._dist_expr(codes_d, codes_d)
                if self._stats_ref_d is None:
                    return (first.astype(jnp.int32), d_self <= dist,
                            codes_d)
                # per-row stats vs the comparison reference
                # (quick_pairwise_score_reference fastaseq.c:522-537
                # semantics, == the host _seq_stats definition): non_n
                # is unwindowed; mismatches are valid-pair, windowed
                v = codes_d != 0
                non_n = v.sum(axis=1, dtype=jnp.int32)
                rvalid = (self._stats_ref_d != 0) & self._window
                mism = (v & rvalid[None, :]
                        & (codes_d != self._stats_ref_d[None, :]))
                dist_ref = mism.sum(axis=1, dtype=jnp.int32)
                m = mism
                cols = jax.lax.broadcasted_iota(jnp.int32, m.shape, 1)
                snps = []
                for _ in range(self._n_snps):   # static, small
                    p = jnp.where(m.any(axis=1),
                                  jnp.argmax(m, axis=1), -1)
                    snps.append(p.astype(jnp.int32))
                    m = m & (cols > p[:, None])
                snp = (jnp.stack(snps, axis=1) if snps else
                       jnp.zeros((v.shape[0], 0), jnp.int32))
                return (first.astype(jnp.int32), d_self <= dist,
                        non_n, dist_ref, snp, codes_d)
            self._assign = jax.jit(assign_fn,
                                   static_argnames=("use_delta",))
        from ..ops import scan as scan_ops
        dummy = jnp.zeros((1, 1), jnp.uint8)
        base_arg = base_d if base_d is not None else self._delta_base_d
        if base_arg is None:                 # packed-only path ignores it
            base_arg = jnp.zeros(self.L, jnp.uint8)
        if payload is not None:
            # store path: the payload is PRE-encoded against base_d
            # (the streamer's first-store base) — no host unpack, no
            # host re-encode; the payload/base pairing happens at the
            # one streamer call site, keeping the silently-wrong-
            # reconstruction hazard out of this API
            kind = payload[0]
            if kind == "delta":
                out = self._assign(
                    np.int32(distance), jnp.asarray(payload[1]),
                    jnp.asarray(payload[2]), dummy, True,
                    self._codes, np.int32(self.n), base_arg)
            else:
                out = self._assign(
                    np.int32(distance), dummy, dummy,
                    jnp.asarray(payload[1]), False,
                    self._codes, np.int32(self.n), base_arg)
        else:
            # host path: encode against the SAME base the device
            # rebuild uses (self._delta_base) — paired here, never
            # caller-supplied
            enc = scan_ops.delta_encode(codes, ok, self._delta_base)
            if enc is not None:
                out = self._assign(
                    np.int32(distance), jnp.asarray(enc[0]),
                    jnp.asarray(enc[1]), dummy, True,
                    self._codes, np.int32(self.n), base_arg)
            else:
                out = self._assign(
                    np.int32(distance), dummy, dummy,
                    jnp.asarray(scan_ops.pack_codes(codes)), False,
                    self._codes, np.int32(self.n), base_arg)
        # codes_d (last) stays ON DEVICE — append/replace gather
        # medoid rows from it without a host round-trip
        return tuple(np.asarray(o) for o in out[:-1]) + (out[-1],)

    def close_vs(self, rows: np.ndarray, codes, distance: int) -> np.ndarray:
        """(len(rows), n) bool: exact mismatch distance within
        `distance` (used by the blocked final merge; only the boolean
        mask leaves the device — 4x less D2H than the int32 matrix).
        `codes` must be a device matrix with rows padded to STORE_TILE
        (the column axis is scanned in tiles, as in assign)."""
        import jax
        jnp = self.jnp
        if not hasattr(self, "_close"):
            def close_fn(r, c, d):
                tile = min(c.shape[0], self.STORE_TILE)
                n_tiles = c.shape[0] // tile
                ct = c.reshape(n_tiles, tile, self.L)
                _, masks = jax.lax.scan(
                    lambda _, tc: (0, self._dist_expr(r, tc) <= d),
                    0, ct)
                # (n_tiles, B, tile) -> (B, n_tiles*tile)
                return jnp.transpose(masks, (1, 0, 2)).reshape(
                    r.shape[0], -1)
            self._close = jax.jit(close_fn)
        m = self._close(self.jnp.asarray(rows), codes, np.int32(distance))
        return np.asarray(m)

    def append(self, rows: np.ndarray) -> None:
        if self.n + rows.shape[0] > self.capacity:
            raise SystemExit("cluster: medoid capacity exceeded; raise "
                             "--medoid-capacity")
        while self.n + rows.shape[0] > self.tier:
            pad = self.jnp.zeros((3 * self.tier, self.L),
                                 dtype=self.jnp.uint8)
            self.tier *= 4
            self._codes = self.jnp.concatenate([self._codes, pad], axis=0)
        self._codes = self._append(self._codes, self.jnp.asarray(rows),
                                   self.n)
        self.n += rows.shape[0]

    def replace(self, index: int, row: np.ndarray) -> None:
        self._codes = self._append(self._codes,
                                   self.jnp.asarray(row[None, :]), index)


def _seq_stats(codes: np.ndarray, ref_codes: np.ndarray, window: np.ndarray,
               n_snps: int):
    """(non_n, dist_ref, first-n_snps SNP positions) per row, as in
    quick_pairwise_score_reference (fastaseq.c:522-537).

    Host numpy SPEC of the stats MedoidIndex.assign computes on device
    (kept as the oracle the equivalence test pins against; the engine
    itself uses the device fold)."""
    valid = codes != 0
    non_n = valid.sum(axis=1).astype(np.int64)
    vpair = valid & (ref_codes != 0)[None, :] & window[None, :]
    mism = vpair & (codes != ref_codes[None, :])
    dist_ref = mism.sum(axis=1).astype(np.int64)
    snp_pos = []
    for row in mism:
        pos = np.flatnonzero(row)[:max(n_snps, 0)]
        snp_pos.append(tuple(int(p) for p in pos)
                       + (-1,) * (n_snps - len(pos)))
    return non_n, dist_ref, snp_pos


def run_cluster(fasta_paths: list[str], cfg: ClusterConfig):
    from ..utils.jaxcache import enable as _cache
    from ..io.fasta import WRITE_CODEC_SUFFIX
    _cache()
    csv_suffix = WRITE_CODEC_SUFFIX[cfg.codec]
    csv_path = cfg.prefix + ".csv" + csv_suffix
    t0 = time.time()
    if cfg.reference:
        ref_seq, L = build_reference(cfg.reference, 1)
    else:
        ref_seq, L = build_reference(fasta_paths[0], 1024)
    ref_codes = encode(ref_seq)
    window = np.zeros(L, dtype=bool)
    trim = max(0, min(cfg.trim, int(L / 2.1)))
    window[trim:L - trim if trim else L] = True
    log(f"Clustering with distance {cfg.distance}, reference of {L} sites")

    index = MedoidIndex(L, cfg.medoid_capacity, trim,
                        delta_base=ref_codes,
                        stats_ref=ref_codes, n_snps=cfg.snps)
    clusters: list[Cluster] = []
    last_print = 0

    def process(batch, payload=None, base_d=None):
        n = batch.n
        # fused device step: first-hit medoid + within-batch proximity
        # mask + per-row reference stats (one delta upload, O(B)
        # + O(B^2 bool) download — never the (B, M) distance matrix;
        # the stats ride along because the codes are on device anyway,
        # replacing a ~0.54 ms/genome host numpy pass).  Store input
        # hands the streamer's pre-encoded payload straight through —
        # batch.codes (a host nibble-unpack) is never materialised and
        # nothing is re-encoded; medoid rows are gathered from the
        # returned DEVICE codes.
        d_first, d_self, non_n, dist_ref, snp, codes_d = index.assign(
            None if payload is not None else batch.codes,
            batch.ok, cfg.distance, payload=payload, base_d=base_d)
        first = [tuple(int(p) for p in row) for row in snp[:n]]
        new_rows: list[int] = []                     # batch rows that
        new_cl: list[int] = []                       # ...opened clusters
        repl: dict[int, int] = {}                    # store row -> batch
                                                     # row (last wins)
        for b in range(n):
            target = int(d_first[b])
            if target < 0:
                for nb, ci in zip(new_rows, new_cl):  # chain within batch
                    if d_self[b, nb]:
                        target = ci
                        break
            if target < 0:
                clusters.append(Cluster(batch.names[b], batch.seq(b),
                                        int(non_n[b]),
                                        int(dist_ref[b]), first[b]))
                new_rows.append(b)
                new_cl.append(len(clusters) - 1)
            else:
                cl = clusters[target]
                if non_n[b] > cl.non_n:              # new, more-resolved medoid
                    cl.neighbours.append(cl.name)
                    cl.name, cl.seq = batch.names[b], batch.seq(b)
                    cl.non_n = int(non_n[b])
                    cl.dist_ref = int(dist_ref[b])
                    cl.snp_pos = first[b]
                    if target < index.n:             # in-store medoid
                        repl[target] = b
                    else:                            # opened this batch
                        new_rows[new_cl.index(target)] = b
                else:
                    cl.neighbours.append(batch.names[b])
        # ONE device scatter per batch covers every replacement and
        # append, gathered from the step's device codes (traced
        # indices — no per-row-set recompiles, no host round-trip)
        index.apply_updates(codes_d, repl, new_rows)

    def save_partial(n_seen: int) -> None:
        """Crash-resilient partial membership table, written atomically
        to the final csv path (save_neighbours_to_xz_file semantics,
        cluster.c:197-200: a killed run keeps a usable table)."""
        # keep the real .csv.<codec> suffix INSIDE the temp name:
        # open_write picks the codec by suffix, so '…csv.xz.part'
        # would be written uncompressed and renamed to an unreadable
        # .csv.xz
        tmp = cfg.prefix + ".part.csv" + csv_suffix
        with open_write(tmp) as fh:
            for c in clusters:
                fh.write((",".join([c.name] + c.neighbours) + "\n")
                         .encode())
        import os as _os
        _os.replace(tmp, csv_path)
        log(f"Saving partial clustering info from {n_seen} sequences "
            f"to file {csv_path}")

    from ..io import store as store_mod
    from .stream import RefStreamer
    n_store = sum(store_mod.is_store(p) for p in fasta_paths)
    if n_store and n_store != len(fasta_paths):
        raise SystemExit(
            "cluster: inputs mix ingested stores and FASTA files; "
            "ingest all inputs or none")
    if n_store:
        # decode-free input: the streamer's payloads (delta vs ITS
        # base, or packed rows) go straight to the device — no host
        # nibble-unpack, no host re-encode (the former batch.codes
        # path cost the cluster-over-store rate its advantage at 250k:
        # 463/s indexed vs 548/s from gz before this); medoid seqs
        # decode on demand (seq_row)
        streamer = store_mod.StoreStreamer(fasta_paths, L, cfg.pool,
                                           ref_ambiguity=1.0)
        sbase_d = (None if streamer.base is None
                   else index.jnp.asarray(streamer.base))
        pairs = ((b, pl, sbase_d) for b, pl in streamer)
    else:
        streamer = RefStreamer(fasta_paths, L, cfg.pool,
                               ref_ambiguity=1.0)
        pairs = ((b, None, None) for b in streamer)
    last_save = time.time()
    for batch, payload, base_d in pairs:
        process(batch, payload, base_d)
        count = batch.base_idx + batch.n
        if count - last_print >= cfg.print_interval:
            last_print = count
            log(f"{count} sequences analysed in total; "
                f"{len(clusters)} clusters; "
                f"{time.time()-t0:.3f} secs elapsed")
        if time.time() - last_save >= cfg.save_interval:
            save_partial(count)
            last_save = time.time()
    count = streamer.stats.count

    # final all-pairs medoid merge (replaces cluster.c:219-230 reduction)
    merged = _merge_clusters(index, clusters, cfg.distance)
    log(f"{count} sequences -> {len(merged)} clusters after merge "
        f"({time.time()-t0:.3f}s)")

    # compare_fastaseq order (fastaseq.c:23-40): member count, then
    # dist-to-ref, then the tracked SNP positions, then resolution
    merged.sort(key=lambda c: (-len(c.neighbours), -c.dist_ref,
                               tuple(-p for p in c.snp_pos), -c.non_n))
    with open_write(csv_path) as fh:
        for c in merged:
            fh.write((",".join([c.name] + c.neighbours) + "\n").encode())
    # medoid sets scale with the cluster count (10^4-10^5 full genomes
    # on surveillance data): multi-stream xz on a thread pool instead
    # of one serial preset-6 stream
    from ..io.fasta import make_fasta_writer

    with make_fasta_writer(cfg.prefix + ".aln", cfg.codec) as w:
        for c in merged:
            w.write(c.name, c.seq)
    log(f"Saved {len(merged)} medoids to {cfg.prefix}.aln{csv_suffix} "
        f"and membership to {csv_path}")
    return merged


def _merge_clusters(index: MedoidIndex, clusters: list[Cluster],
                    distance: int, block: int = 2048) -> list[Cluster]:
    """Union-find over all medoid pairs within `distance`, computed in
    (block x M) distance tiles so quarter-million-cluster runs never
    materialise the full pairwise matrix."""
    if len(clusters) < 2:
        return clusters
    M = len(clusters)
    assert M == index.n, "medoid store out of sync with cluster list"
    # the medoid store ALREADY holds these rows on device (append /
    # replace keep it in sync: store row i == clusters[i]) — re-encoding
    # 250k genomes on the host cost ~7.5GB RAM and a full re-upload
    tile = MedoidIndex.STORE_TILE
    M_pad = M if M <= tile else -(-M // tile) * tile
    cap = index._codes.shape[0]
    if cap >= M_pad:
        codes_d = index._codes[:M_pad]
    else:   # store tier smaller than the padded tile count
        codes_d = index.jnp.pad(index._codes,
                                ((0, M_pad - cap), (0, 0)))
    parent = list(range(M))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for start in range(0, M, block):
        rows = codes_d[start:start + block]   # device slice, no upload
        close = index.close_vs(rows, codes_d, distance)[:, :M]
        ii, jj = np.nonzero(close)
        for i, j in zip(ii.tolist(), jj.tolist()):
            gi = start + i
            if j <= gi:
                continue
            ri, rj = find(gi), find(j)
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    groups: dict[int, list[int]] = {}
    for i in range(len(clusters)):
        groups.setdefault(find(i), []).append(i)
    out = []
    for members in groups.values():
        best = max(members, key=lambda i: clusters[i].non_n)
        cl = clusters[best]
        for i in members:
            if i == best:
                continue
            o = clusters[i]
            cl.neighbours.extend([o.name] + o.neighbours)
        out.append(cl)
    return out
