"""Host-side streaming batcher for database scans.

Replaces the reference's single-threaded read/compute/write phase
alternation (nearest.c:249-330) with a background reader thread feeding
fixed-shape encoded batches through a bounded queue, so xz decompression
overlaps device compute (the device analogue of its OpenMP pipeline).

Fast path: the native C++ reader's batched API (native/fasta_io.cpp)
fills a (chunk, L) char matrix directly — encoding and the valid-site
QC reduction are then single vectorised numpy ops.  Falls back to the
per-record Python reader (bz2, or native lib unavailable).
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field

import numpy as np

from ..core.encoding import ENCODE_LUT
from ..io.fasta import read_fasta
from ..utils.prefetch import Prefetcher


@dataclass
class RefBatch:
    codes: np.ndarray          # (B, L) uint8, zero-padded rows
    ok: np.ndarray             # (B,) bool
    names: list[str]           # len n (valid rows only)
    base_idx: int              # global index of row 0
    n: int                     # number of valid rows
    raw: np.ndarray | None = None      # (n, L) raw chars (native path)
    seqs: list[bytes] | None = None    # python path
    # exact stream position after this batch's last record — lets a
    # checkpoint resume precisely here
    records_read: int = 0
    n_invalid: int = 0
    same_name: int = 0

    def seq(self, i: int) -> bytes:
        if self.seqs is not None:
            return self.seqs[i]
        return self.raw[i].tobytes()

    def frame(self, i: int):
        """No pre-compressed dump frame on the FASTA path (store
        batches override this — see io/store.StoreBatch.frame)."""
        return None


def dump_entry(batch, i: int):
    """(name, seq-or-None, frame-or-None) for dump-writer retention:
    store batches carry pre-compressed frames, FASTA batches raw
    bytes."""
    frame = batch.frame(i)
    if frame is not None:
        return (batch.names[i], None, frame)
    return (batch.names[i], batch.seq(i), None)


def write_dump(writer, entry) -> None:
    """Write a dump_entry through a FASTA dump writer (both writer
    classes implement write_compressed: the xz writer splices the
    pre-compressed frame verbatim, a --codec writer re-encodes it)."""
    name, seq, frame = entry
    if frame is not None:
        writer.write_compressed(frame)
    else:
        writer.write(name, seq)


@dataclass
class StreamStats:
    count: int = 0             # sequences read (incl. rejected-by-quality)
    n_invalid: int = 0         # rejected: too ambiguous
    same_name: int = 0         # rejected: name present in query set
    files: list[str] = field(default_factory=list)


class RefStreamer:
    """Reads aligned reference files into encoded batches.

    QC mirrors nearest.c:250-286: skip same-name refs (--exclude_self),
    skip refs with fewer than (1-ref_ambiguity)*L valid sites, error on
    length mismatch.
    """

    def __init__(self, paths: list[str], n_sites: int, batch: int,
                 ref_ambiguity: float = 0.5,
                 exclude_names: set[str] | None = None,
                 prefetch: int = 4,
                 skip_records: int = 0, initial_base: int = 0):
        self.paths = paths
        self.n_sites = n_sites
        self.batch = batch
        self.min_valid = int(n_sites * (1.0 - ref_ambiguity))
        self.exclude_names = exclude_names or set()
        self.skip_records = skip_records   # resume: raw records to skip
        self.initial_base = initial_base   # resume: accepted-count offset
        self.stats = StreamStats()
        self._pf = Prefetcher(self._batches, maxsize=prefetch)

    def __iter__(self):
        return iter(self._pf)

    # ------------------------------------------------------------------

    def _records(self):
        """Yield (names, raw_chars (k, L), codes-or-None,
        valid-counts-or-None) chunks."""
        from ..io import native
        lib = native.get_lib()
        for path in self.paths:
            self.stats.files.append(path)
            if native.reads_natively(path):
                yield from self._native_chunks(lib, path)
            else:
                yield from self._python_chunks(path)

    def _native_chunks(self, lib, path):
        L, chunk = self.n_sites, self.batch
        handle = lib.ufa_open(str(path).encode())
        if not handle:
            raise SystemExit(f"cannot open reference file {path}")
        if not hasattr(lib, "ufa_next_batch_configured"):
            lib.ufa_next_batch.restype = ctypes.c_long
            lib.ufa_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long)]
            lib.ufa_next_batch_configured = True
        namecap = 1024 * chunk
        namebuf = ctypes.create_string_buffer(namecap)
        ends = (ctypes.c_long * chunk)()
        lens = (ctypes.c_long * chunk)()
        valid = (ctypes.c_long * chunk)()
        lut = ENCODE_LUT.tobytes()
        try:
            while True:
                # np.empty, not zeros: the reader overwrites rows
                # [0, k) completely (aligned input, len == stride) and
                # the [k:] tail is sliced off before leaving here —
                # memset of 2 x 122MB/batch dominated the streamer on
                # low-bandwidth hosts
                raw = np.empty((chunk, L), dtype=np.uint8)
                codes = np.empty((chunk, L), dtype=np.uint8)
                k = lib.ufa_next_batch(
                    handle, raw.ctypes.data_as(ctypes.c_void_p),
                    codes.ctypes.data_as(ctypes.c_void_p), lut, L, chunk,
                    namebuf, namecap, ends, lens, valid)
                if k < 0:
                    raise SystemExit(f"error reading {path}")
                if k == 0:
                    return
                blob = namebuf.raw
                names, start = [], 0
                for i in range(k):
                    names.append(blob[start:ends[i]].decode(
                        "utf-8", errors="replace"))
                    start = ends[i]
                for i in range(k):
                    if lens[i] != L:
                        raise SystemExit(
                            f"Reference sequence '{names[i]}' has "
                            f"{lens[i]} sites but query sequences have "
                            f"{L} sites: all sequences must be aligned")
                yield (names, raw[:k], codes[:k],
                       np.asarray(valid[:k], dtype=np.int64))
        finally:
            lib.ufa_close(handle)

    def _python_chunks(self, path):
        L = self.n_sites
        names, rows = [], []
        for rec in read_fasta(path):
            if len(rec.seq) != L:
                raise SystemExit(
                    f"Reference sequence '{rec.name}' has {len(rec.seq)} "
                    f"sites but query sequences have {L} sites: all "
                    "sequences must be aligned")
            names.append(rec.name)
            rows.append(np.frombuffer(rec.seq, dtype=np.uint8))
            if len(names) >= self.batch:
                yield names, np.stack(rows), None, None
                names, rows = [], []
        if names:
            yield names, np.stack(rows), None, None

    # ------------------------------------------------------------------

    def _batches(self):
        """Generator run on the Prefetcher's thread."""
        base = self.initial_base
        skip = self.skip_records
        acc_names: list[str] = []
        acc_codes = np.zeros((self.batch, self.n_sites), dtype=np.uint8)
        acc_raw = np.zeros((self.batch, self.n_sites), dtype=np.uint8)
        n = 0

        def mk(codes, ok, names, count, raw):
            nonlocal base
            b = RefBatch(codes, ok, names, base, count, raw=raw,
                         records_read=self.stats.count,
                         n_invalid=self.stats.n_invalid,
                         same_name=self.stats.same_name)
            base += count
            return b

        for names, raw, codes, valid in self._records():
            if skip:                     # resume: fast-skip records
                if skip >= len(names):
                    skip -= len(names)
                    continue
                names = names[skip:]
                raw = raw[skip:]
                codes = None if codes is None else codes[skip:]
                valid = None if valid is None else valid[skip:]
                skip = 0
            if codes is None:
                codes = ENCODE_LUT[raw]
            if valid is None:
                valid = (codes != 0).sum(axis=1)
            if os.environ.get("UVAIA_TPU_STRICT_CHARS"):
                # dirty-input guard on the reference side too: one
                # vectorised LUT reduction per chunk (off by default so
                # the hot path pays nothing; per-row work only for the
                # offending rows — review r5 finding)
                from ..core.encoding import RECOGNISED, strict_chars_check
                bad = (~RECOGNISED[raw]).any(axis=1)
                for i in np.nonzero(bad)[0]:
                    strict_chars_check(names[int(i)], raw[int(i)])
            keep = valid >= self.min_valid
            excl = None
            if self.exclude_names:
                # name exclusion precedes the quality check, as in
                # nearest.c:255-270
                excl = np.array([nm in self.exclude_names
                                 for nm in names])
                keep &= ~excl
            if n == 0 and len(names) == self.batch and keep.all():
                # common fast path: full clean chunk, no copies
                self.stats.count += self.batch
                yield mk(codes, np.ones(self.batch, dtype=bool), names,
                         self.batch, raw)
                continue
            for i in range(len(names)):
                self.stats.count += 1
                if not keep[i]:
                    if excl is not None and excl[i]:
                        self.stats.same_name += 1
                    else:
                        self.stats.n_invalid += 1
                    continue
                acc_codes[n] = codes[i]
                acc_raw[n] = raw[i]
                acc_names.append(names[i])
                n += 1
                if n == self.batch:
                    yield mk(acc_codes, np.ones(self.batch, dtype=bool),
                             acc_names, n, acc_raw)
                    acc_names, n = [], 0
                    acc_codes = np.zeros_like(acc_codes)
                    acc_raw = np.zeros_like(acc_raw)
        if n:
            ok = np.zeros(self.batch, dtype=bool)
            ok[:n] = True
            yield mk(acc_codes, ok, acc_names, n, acc_raw)


class EncodedStream:
    """Second pipeline stage: host-encode batches on a worker pool.

    Yields (batch, payload) IN ORDER, where payload is
    ("delta", pos, val) when the sparse-diff fits the buckets, else
    ("packed", packed).  The C++ XOR delta scan / 4-bit pack of
    batches i+1..i+workers runs while batch i's upload + device step
    are in flight on the consumer thread — the double-buffering the
    single-threaded series (encode -> upload -> dispatch) was leaving
    on the table.  delta_encode's scratch is thread-local and its
    outputs are fresh arrays, so concurrent workers are race-free by
    construction.

    ``workers`` (UVAIA_TPU_ENCODE_THREADS) sizes the pool: on a
    one-core host >1 worker only adds oversubscription, so the default
    scales with the host — min(2, cpu_count-1), floor 1 — and a
    multicore host can raise it until the encode stage keeps up with
    the device (the encode is the streamed path's host bound: ~120MB
    of XOR scan per 4096x30k batch).
    """

    def __init__(self, streamer: RefStreamer, delta_base: np.ndarray,
                 prefetch: int = 2, workers: int | None = None):
        import os
        from ..ops import scan
        self._scan = scan
        self.streamer = streamer
        self.delta_base = delta_base
        if workers is None:
            workers = int(os.environ.get(
                "UVAIA_TPU_ENCODE_THREADS",
                max(1, min(2, (os.cpu_count() or 1) - 1))))
        self._workers = max(1, workers)
        self._pf = Prefetcher(self._batches,
                              maxsize=max(prefetch, self._workers))

    def _encode(self, batch):
        enc = self._scan.delta_encode(batch.codes, batch.ok,
                                      self.delta_base)
        if enc is not None:
            return batch, ("delta", enc[0], enc[1])
        return batch, ("packed", self._scan.pack_codes(batch.codes))

    def _batches(self):
        """Generator run on the Prefetcher's thread: keeps up to
        `workers` encodes in flight, yielding results in input order
        (utils.prefetch.ordered_pool_map — shared with bench.py)."""
        from ..utils.prefetch import ordered_pool_map
        yield from ordered_pool_map(self._encode, self.streamer,
                                    self._workers)

    def __iter__(self):
        return iter(self._pf)
