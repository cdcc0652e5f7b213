"""Reference-based batch alignment (the `uvaialign` equivalent).

Orchestration mirrors src/align.c:115-271: read the reference, stream
query FASTA files, QC-reject sequences too different in length
(outside [2/3, 3/2] x ref, align.c:190-193) or too ambiguous
(align.c:194-202), align each against the reference with affine-gap
penalties {0,4,6,2}, project onto reference coordinates (insertions
dropped, deletions '-'), and write an xz alignment or stdout.

The compute is the batched banded Gotoh kernel (ops/gotoh.py) instead
of per-thread WFA objects; bands are chosen per batch from the length
offsets and widened automatically when a path escapes (the exactness
guarantee WFA-Adapt does not give).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.encoding import encode, composition
from ..io.fasta import FastaRecord, read_fasta
from ..ops import gotoh
from ..utils.prefetch import Prefetcher
from .query import log


@dataclass
class AlignConfig:
    ambiguity: float = 0.5
    pool: int = 1024              # queries aligned per device batch
    band: int = 1024              # max band width before giving up
    slack: int = 64               # band slack beyond the length offset
    exact_fallback: bool = True   # rows the --band cap cannot certify
                                  # re-align once at the certificate-2
                                  # band (beyond --band, chunked to the
                                  # tb budget) so every emitted row is
                                  # provably optimal; False restores
                                  # WFA-Adapt-parity acceptance
    to_stdout: bool = False
    output: str | None = None
    print_interval: int = 5000
    codec: str = "xz"             # output compression: xz/bz2/gz/raw

    @property
    def prefix(self) -> str:
        return self.output if self.output else "uvaia_tpu_align"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _choose_band(n: int, lens: list[int], slack: int) -> tuple[int, int]:
    """(lo, width) covering all length offsets plus slack, quantised to
    limit recompilation."""
    d_min = min(min(l - n for l in lens), 0) - slack
    d_max = max(max(l - n for l in lens), 0) + slack
    lo = -_round_up(-d_min, 32)
    width = _round_up(d_max - lo + 1, 64) + 1
    return lo, width


@dataclass
class AlignStats:
    count: int = 0
    n_output: int = 0
    rejected_length: int = 0
    rejected_ambiguity: int = 0
    failed_band: int = 0
    uncertified: int = 0     # emitted but optimality not provable
                             # within the band cap (WFA-Adapt parity)
    uncertified_names: list = None   # their names, for the audit sidecar
    exact_certified: int = 0  # rows certified by the beyond-cap
                              # certificate-2 fallback band

    def mark_uncertified(self, name: str) -> None:
        self.uncertified += 1
        if self.uncertified_names is None:
            self.uncertified_names = []
        self.uncertified_names.append(name)


def _qc(rec: FastaRecord, n: int, ambiguity: float, stats: AlignStats) -> bool:
    m = len(rec.seq)
    if 3 * m < 2 * n or 2 * m > 3 * n:
        log(f"Sequence {rec.name} has size too different from reference "
            f"({m} vs {n})")
        stats.rejected_length += 1
        return False
    from ..core.encoding import strict_chars_check
    strict_chars_check(rec.name, rec.seq)
    acgt, _amb, other = composition(encode(rec.seq))
    if other > ambiguity:
        log(f"Sequence {rec.name} has proportion of N etc. (={other:f}) "
            f"above threshold of {ambiguity:f}")
        stats.rejected_ambiguity += 1
        return False
    if acgt < 1.0 - 1.1 * ambiguity:
        log(f"Sequence {rec.name} has proportion of ACGT (={acgt:f}) below "
            f"threshold of {1.0 - 1.1 * ambiguity:f}")
        stats.rejected_ambiguity += 1
        return False
    return True


# traceback buffer cap (bytes): B * n * W.  The effective cap is
# min(TB_BUDGET, 2^31 - 1): the traceback kernel computes flat int32
# offsets into the buffer, so a single dispatch chunk must keep
# B * n_p * w_p below 2^31 (pool=1024 at 30kb genomes overflowed to a
# Python-int error before this clamp; pool=512 sat at 1.6e9, just
# under).
TB_BUDGET = 6 << 30
TB_IDX_CAP = (1 << 31) - 1
E_DIFF = 1024           # sparse D2H: max (pos, char) diffs per row


def _pack_rows(recs, b_mult: int = 64):
    """(arr (B_pad, m_pad) uint8, lens (B_pad,) int32) with the batch
    axis padded to a multiple of b_mult (duplicating row 0) and m_pad
    quantised — so repeated calls hit a handful of compiled shapes."""
    B = len(recs)
    B_pad = _round_up(B, b_mult)
    m_pad = _round_up(max(len(r.seq) for r in recs), 256)
    arr = np.zeros((B_pad, m_pad), dtype=np.uint8)
    lens = np.zeros(B_pad, dtype=np.int32)
    for b, r in enumerate(recs):
        arr[b, :len(r.seq)] = np.frombuffer(r.seq, dtype=np.uint8)
        lens[b] = len(r.seq)
    arr[B:] = arr[0]
    lens[B:] = lens[0]
    return arr, lens


@dataclass
class _DeviceBatch:
    """One flush's query rows, uploaded to the device exactly once;
    groups and pass-2 buckets take device-side row gathers instead of
    re-uploading."""
    ref_arr: np.ndarray        # (n,) host reference bytes
    ref_d: object              # device copy
    lens: np.ndarray           # (B_all,) host query lengths
    arr_d: object              # (B_all, m_pad) device query bytes
    lens_d: object


@jax.jit
def _unpack4(packed, lut):
    """Device-side inverse of the 4-bit host pack: (B, m/2) nibble
    pairs + a 16-entry byte LUT -> (B, m) raw query bytes."""
    hi = jnp.take(lut, (packed >> 4).astype(jnp.int32))
    lo = jnp.take(lut, (packed & 15).astype(jnp.int32))
    B, m2 = packed.shape
    return jnp.stack([hi, lo], axis=2).reshape(B, m2 * 2)


def _make_device_batch(ref_arr, recs) -> _DeviceBatch:
    arr, lens = _pack_rows(recs)
    # when the batch uses <= 16 distinct byte values
    # (ACGT + IUPAC ambiguity — the universal case for QC-passed
    # genomes), ship 4-bit indices + a LUT and unpack on device,
    # halving the upload
    present = np.zeros(256, dtype=bool)
    present[arr.reshape(-1)] = True
    # byte 0 appears only as row padding (FASTA bytes are ASCII
    # letters) and the DP masks past each row's length, so it need
    # not burn one of the 16 LUT slots: it aliases to vals[0]
    present[0] = False
    vals = np.nonzero(present)[0].astype(np.uint8)
    if 0 < len(vals) <= 16:
        table = np.zeros(256, dtype=np.uint8)
        table[vals] = np.arange(len(vals), dtype=np.uint8)
        idx = table[arr]
        packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
        lut = np.zeros(16, dtype=np.uint8)
        lut[:len(vals)] = vals
        arr_d = _unpack4(jnp.asarray(packed), jnp.asarray(lut))
    else:
        arr_d = jnp.asarray(arr)
    return _DeviceBatch(ref_arr=ref_arr, ref_d=jnp.asarray(ref_arr),
                        lens=lens, arr_d=arr_d,
                        lens_d=jnp.asarray(lens))


def _pad_idx(db: _DeviceBatch, idxs: list[int], b_mult: int = 64):
    """Row-index vector padded to a b_mult-multiple (+ its host lens)."""
    B_pad = _round_up(len(idxs), b_mult)
    idx = np.full(B_pad, idxs[0], dtype=np.int32)
    idx[:len(idxs)] = idxs
    return jnp.asarray(idx), db.lens[idx]


def _chunk_plan(n: int, width: int) -> tuple[int, int]:
    """(max_rows, b_mult) for one dispatch chunk at this (n, width).

    The traceback kernels compute flat int32 offsets into the packed
    tb temp, and _pad_idx pads the dispatched batch up to b_mult rows,
    so the budget must hold for the PADDED batch: B_pad * n_p * w_p
    < 2^31, with n and width rounded up to 128 for margin.  A plan that
    ignored the padding would overflow exactly at cap-band widths —
    the 2/3..3/2 length gate (align.c:190-193) admits length offsets
    up to ~n/2, where max_rows lands below 64 but the old fixed
    64-row padding pushed the kernel batch back over the cap.
    b_mult == 0 means even one padded row overflows: the row cannot
    be tracebacked at this (n, width) and must be skipped."""
    n_p = -(-n // 128) * 128
    w_p = -(-width // 128) * 128
    cap = min(TB_BUDGET, TB_IDX_CAP) // max(n_p * w_p, 1)
    b_mult = max((b for b in (64, 32, 16, 8, 1) if b <= cap), default=0)
    if b_mult == 0:
        return 0, 0
    return cap - cap % b_mult, b_mult


def _dispatch_group(db: _DeviceBatch, items, lo, width, stats):
    """Queue one group's aligner program (async).  Splits so the
    packed traceback temp (B*n*W bytes of device memory) stays under
    budget.
    Returns a list of pending (items, lens, meta_dev, aligned_dev, lo,
    width) tuples."""
    n = db.ref_arr.shape[0]
    max_rows, b_mult = _chunk_plan(n, width)
    if max_rows == 0:
        for r, _ in items:
            log(f"Sequence {r.name}: band {width} at reference length "
                f"{n} exceeds the traceback index budget; skipped")
            stats.failed_band += 1
        return []
    pending = []
    for start in range(0, len(items), max_rows):
        part = items[start:start + max_rows]
        idx_d, lens = _pad_idx(db, [i for _, i in part], b_mult)
        meta_d = gotoh.align_rows(
            db.ref_d, db.arr_d, db.lens_d, idx_d, lo, width, gotoh.EV_CAP)
        pending.append((part, lens, meta_d, lo, width))
    return pending


def _collect_group(db: _DeviceBatch, handle, out, stats, cfg,
                   exact: bool = False):
    """Fetch one pending group's fused output buffer and emit rows;
    escalate band (synchronously — rare) for rows that escape.
    ``exact`` marks a certificate-2 fallback pass (see _exact_fallback):
    its band provably covers the optimum, so rows certify here and no
    further fallback recursion happens."""
    items, lens, meta_d, lo, width = handle
    ref_arr = db.ref_arr
    n = ref_arr.shape[0]
    recs = [r for r, _ in items]
    (score, edge_min, done, cnt, ovf, t_end, ev_i,
     ev_t) = gotoh.unpack_meta_events(np.asarray(meta_d), gotoh.EV_CAP)
    walk_cost = np.full(score.shape[0], -1, dtype=np.int64)
    row_cache: dict[int, bytes] = {}
    dense = []
    for i in range(len(recs)):
        if not done[i]:
            continue                   # fails certify -> band escalation
        if ovf[i]:
            dense.append(i)
            continue
        q = np.frombuffer(recs[i].seq, dtype=np.uint8)
        row, cost = gotoh.decode_events(q, ref_arr, int(t_end[i]), lo,
                                        ev_i[i], ev_t[i], int(cnt[i]))
        if row is None:
            dense.append(i)
        else:
            row_cache[i] = row.tobytes()
            walk_cost[i] = cost
    if dense:
        # event-capacity overflow (> EV_CAP kind changes, i.e. > 96 gap
        # runs — pathological rows): dense per-character walk fallback.
        # Same padded-batch index budget as the dispatch (b_mult > 0:
        # this group was dispatched, so the plan is dispatchable).
        _, b_mult = _chunk_plan(n, width)
        idx_d, _ = _pad_idx(db, [items[i][1] for i in dense], b_mult)
        meta2, aligned2 = gotoh.align_rows_dense(
            db.ref_d, db.arr_d, db.lens_d, idx_d, lo, width, E_DIFF)
        (_s2, _e2, _d2, wc2, count2, pos2,
         chars2) = gotoh.unpack_meta(np.asarray(meta2), E_DIFF)
        for k, i in enumerate(dense):
            walk_cost[i] = wc2[k]
            if count2[k] <= E_DIFF:
                row = ref_arr.copy()
                row[pos2[k, :count2[k]]] = chars2[k, :count2[k]]
                row_cache[i] = row.tobytes()
            else:
                row_cache[i] = np.asarray(aligned2[k]).tobytes()
    ok, consistent, wander = gotoh.certify(
        score, edge_min, done, walk_cost, lens, n, lo, width)

    def row_bytes(i):
        return row_cache[i]

    retry, exact_items = [], []

    def accept_or_exact(i):
        """A consistent row the --band cap cannot certify: re-align at
        the certificate-2 band (default) or accept uncertified
        (WFA-Adapt parity / already in the exact pass)."""
        if exact or not cfg.exact_fallback:
            stats.mark_uncertified(recs[i].name)
            out[id(recs[i])] = row_bytes(i)
        else:
            exact_items.append((items[i], row_bytes(i), int(wander[i])))

    for i in range(len(recs)):
        if ok[i]:
            if exact:
                stats.exact_certified += 1
            out[id(recs[i])] = row_bytes(i)
        elif consistent[i] and 2 * wander[i] + abs(len(recs[i].seq) - n) \
                > cfg.band:
            accept_or_exact(i)
        else:
            retry.append(i)
    if retry:
        # escalate up to (never beyond) the configured cap
        new_width = min(width * 4, cfg.band)
        if new_width <= width:
            for i in retry:
                if consistent[i]:
                    accept_or_exact(i)
                else:
                    log(f"Sequence {recs[i].name}: no alignment within "
                        f"band {width}; skipped")
                    stats.failed_band += 1
        else:
            new_lo = lo - (new_width - width) // 2
            _align_group(db, [items[i] for i in retry],
                         new_lo, new_width, out, stats, cfg)
    if exact_items:
        _exact_fallback(db, exact_items, out, stats, cfg)


def _exact_fallback(db: _DeviceBatch, ex_items, out, stats, cfg):
    """Re-align rows the --band cap could not certify at their
    certificate-2 band — the hull of end diagonals widened by the
    wander bound (gotoh.certify), which PROVABLY contains the global
    optimum — even when that band exceeds --band.  Chunking to the
    int32 traceback budget is _dispatch_group's normal plan (b_mult
    shrinks to 1 row per chunk at extreme widths); a row whose
    certified band cannot fit even one chunk keeps the consistent
    banded alignment and stays in the uncertified sidecar.  Beats the
    reference's WFA-Adapt (align.c:309), which silently accepts the
    reduced-wavefront result for this whole class."""
    n = db.ref_arr.shape[0]
    groups: dict[tuple[int, int], list] = {}
    for (rec, bi), row, wd in ex_items:
        d_end = len(rec.seq) - n
        lo_i = min(0, d_end) - wd - 16
        hi_i = max(0, d_end) + wd + 16
        # quantise so repeated fallbacks share compiled kernel shapes
        lo_q = -_round_up(-lo_i, 256)
        w_q = _round_up(hi_i - lo_q + 1, 1024) + 1
        if _chunk_plan(n, w_q)[1] == 0:
            stats.mark_uncertified(rec.name)
            out[id(rec)] = row
        else:
            groups.setdefault((lo_q, w_q), []).append((rec, bi))
    for (lo_q, w_q), gitems in groups.items():
        _align_group(db, gitems, lo_q, w_q, out, stats, cfg, exact=True)


def _align_group(db: _DeviceBatch, items, lo, width, out, stats, cfg,
                 exact: bool = False):
    """Synchronous dispatch + collect (escalations, small groups)."""
    for handle in _dispatch_group(db, items, lo, width, stats):
        _collect_group(db, handle, out, stats, cfg, exact=exact)


def _band_levels(band: int) -> list[int]:
    """Canonical zero-centred band half-widths: 64, 128, ... capped by
    the --band budget.  A handful of fixed shapes keeps the number of
    compiled pass-2 kernels (and per-flush dispatches) tiny."""
    levels = []
    h = 64
    while h * 2 + 1 <= max(band, 129):
        levels.append(h)
        h *= 2
    return levels or [64]


ROUTE_MARGIN = 16   # extra half-band beyond |len offset| when routing


def run_align(ref_path: str, fasta_paths: list[str], cfg: AlignConfig):
    from ..utils.jaxcache import enable as _cache
    _cache()
    t0 = time.time()
    try:
        ref = next(iter(read_fasta(ref_path)))
    except StopIteration:
        raise SystemExit(f"Error reading reference sequence {ref_path}")
    n = len(ref.seq)
    ref_arr = np.frombuffer(ref.seq, dtype=np.uint8)
    log(f"Reference {ref.name}: {n} sites")

    writer = None
    if not cfg.to_stdout:
        from ..io.fasta import make_fasta_writer
        writer = make_fasta_writer(cfg.prefix + ".aln", cfg.codec)
        log(f"Sequences will be compressed and saved into file "
            f"{writer.path}.")

    stats = AlignStats()

    def dispatch_pool(batch):
        """Upload one pool and queue its aligner programs (async).
        Route each row to a canonical zero-centred band bucket from
        its length offset ALONE — no device score pass.  certify in
        _collect_group is the soundness gate: a row whose optimum
        wanders beyond its routed band fails its certificate and
        escalates (x4 width), so routing is purely a performance
        guess.  The previous score-based router paid a second full
        DP forward every flush to avoid escalations that, on real
        genomes (small indels, SNPs), almost never happen — the
        extra pass cost more than it saved (measured: 0.21s of a
        0.58s 256-row flush)."""
        db = _make_device_batch(ref_arr, batch)   # single H2D upload
        levels = _band_levels(cfg.band)
        buckets: dict[int, list] = {}
        cap_rows: list = []
        for bi, r in enumerate(batch):
            d = abs(len(r.seq) - n)
            for h in levels:
                if d + ROUTE_MARGIN <= h:
                    buckets.setdefault(h, []).append((r, bi))
                    break
            else:
                cap_rows.append((r, bi))
        # dispatch ALL buckets (async) — device compute overlaps the
        # per-group transfer latency AND the next pool's read/QC
        pending = []
        for h, bitems in sorted(buckets.items()):
            pending += _dispatch_group(db, bitems, -h, 2 * h + 1, stats)
        # rows whose length offset exceeds every canonical band get a
        # structural band covering their end diagonals (grouped by
        # offset so mixed groups don't inflate W); certify's
        # accept-uncertified/skip handling applies at the cap
        cap_groups: dict[int, list] = {}
        for r, bi in cap_rows:
            cap_groups.setdefault((len(r.seq) - n) // 256,
                                  []).append((r, bi))
        for items in cap_groups.values():
            lo, width = _choose_band(n, [len(r.seq) for r, _ in items],
                                     cfg.slack)
            pending += _dispatch_group(db, items, lo, width, stats)
        return db, pending, batch

    def collect_pool(handle):
        db, pending, batch = handle
        out: dict[int, bytes] = {}
        for h in pending:
            _collect_group(db, h, out, stats, cfg)
        for r in batch:
            seq = out.get(id(r))
            if seq is None:
                continue
            stats.n_output += 1
            if cfg.to_stdout:
                sys.stdout.write(f">{r.name}\n{seq.decode('ascii')}\n")
            else:
                writer.write(r.name, seq)

    # Reader thread (shared utils.prefetch.Prefetcher): read + QC the
    # next pool while the device aligns the current one; the main loop
    # additionally keeps ONE pool dispatched ahead, so result
    # collection of pool i overlaps pool i+1's device compute.
    def _pools():
        batch: list[FastaRecord] = []
        last_print = 0
        for path in fasta_paths:
            log(f"Started  reading file {path}")
            for rec in read_fasta(path):
                if reader.aborted():
                    return
                stats.count += 1
                if not _qc(rec, n, cfg.ambiguity, stats):
                    continue
                batch.append(rec)
                if len(batch) >= cfg.pool:
                    yield batch
                    batch = []
                if stats.count - last_print >= cfg.print_interval:
                    last_print = stats.count
                    log(f"{stats.count}\t sequences read, "
                        f"{stats.n_output} \taligned. "
                        f"{time.time()-t0:.3f} secs elapsed.")
            log(f"Finished reading file {path}.")
        if batch:
            yield batch

    reader = Prefetcher(_pools, maxsize=2)
    prev = None
    for batch in reader:
        cur = dispatch_pool(batch)
        if prev is not None:
            collect_pool(prev)
        prev = cur
    if prev is not None:
        collect_pool(prev)

    if writer is not None:
        writer.close()
        log(f"Saved {stats.n_output} sequences to file {writer.path}")
    if stats.uncertified_names:
        # audit sidecar: rows accepted without an optimality certificate
        # (the reference's WFA-Adapt accepts the same class silently)
        side = cfg.prefix + ".uncertified.txt"
        with open(side, "w") as fh:
            fh.write("\n".join(stats.uncertified_names) + "\n")
        log(f"Wrote {stats.uncertified} uncertified sequence names to "
            f"{side} (alignments emitted, optimality not provable "
            f"within --band)")
    log(f"Total: {stats.count} read, {stats.n_output} aligned, "
        f"{stats.rejected_length} wrong length, "
        f"{stats.rejected_ambiguity} too ambiguous, "
        f"{stats.exact_certified} certified beyond --band, "
        f"{stats.uncertified} uncertified (band cap), "
        f"{stats.failed_band} failed. "
        f"{time.time()-t0:.3f} secs total.")
    return stats
