"""Multi-host / multi-slice database scan (BASELINE config 5).

The reference is strictly single-host OpenMP (SURVEY.md §2.5); this is
new capability.  Design: the database file list is split into
*contiguous* per-host ranges (preserving the command-line order, which
is the tie-break order of the C min-heap's first-seen-wins semantics,
min_heap.c:93-117) — or, when every input is an ingested store, into
contiguous per-host ROW ranges of the concatenated stores (one big
index shares across hosts with no per-host re-ingest, io/store.py
limit_records); each host streams and scans its range with the
local engine (one device or a sharded mesh via cfg.n_devices);
at end-of-scan the tiny per-query top-k states — (Q, k, 6) scores plus
names — are all-gathered across hosts and re-top-k'd, and
process 0 writes the final ranked CSV.  The all_gather payload is
O(hosts * Q * k) regardless of database size, so network bandwidth is
irrelevant; per-host .aln.xz dumps remain valid append-only supersets.

Coordination uses `jax.distributed.initialize` +
`multihost_utils.process_allgather`; when JAX distributed is not
initialised (single-process use), the function degrades to a plain
local scan plus merge.
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np

from ..engine.nearest import (CSV_HEADER_ACGT, CSV_HEADER_FULL,
                              NearestConfig, run_nearest)
from ..engine.query import log
from ..io.compress import open_write
from ..ops.scan import IDX_SENTINEL

NAME_W = 256          # minimum name-slot width for the cross-host gather
                      # (widened to the global max name length, so long
                      # FASTA headers are never truncated)


def assign_files(paths: list[str], n_processes: int,
                 process_id: int) -> list[str]:
    """Contiguous per-host file ranges, balanced by compressed size.

    Contiguity in the given order keeps (host, local_index) ordering
    identical to the single-process global record order, preserving
    tie-break parity.
    """
    sizes = [max(os.path.getsize(p), 1) for p in paths]
    total = sum(sizes)
    bounds = [0]
    acc = 0
    nxt = 1
    for i, s in enumerate(sizes):
        acc += s
        while nxt < n_processes and acc * n_processes >= nxt * total:
            bounds.append(i + 1)
            nxt += 1
    while len(bounds) < n_processes:
        bounds.append(len(paths))
    bounds.append(len(paths))
    return paths[bounds[process_id]:bounds[process_id + 1]]


def _gather_parts(scores: np.ndarray, idx: np.ndarray,
                  names: np.ndarray):
    """All-gather the fixed-shape per-host top-k state over the
    distributed backend.  Returns (P, ...) stacked arrays."""
    from jax.experimental import multihost_utils
    g_scores = multihost_utils.process_allgather(scores)
    g_idx = multihost_utils.process_allgather(idx)
    g_names = multihost_utils.process_allgather(names)
    return np.asarray(g_scores), np.asarray(g_idx), np.asarray(g_names)


def run_nearest_multihost(ref_paths: list[str], query_path: str,
                          cfg: NearestConfig, num_processes: int,
                          process_id: int,
                          coordinator: str | None = None):
    """Entry point for a multi-host scan.  Every process runs this with
    the same arguments except process_id."""
    if coordinator is not None:
        import jax
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    from ..io import store as store_mod
    range_kw = {}
    if num_processes > 1 and ref_paths and \
            all(store_mod.is_store(p) for p in ref_paths):
        # all-store inputs split by ROW ranges, not files: one big
        # ingested store (the config-5 shape) shares across hosts
        # without re-ingesting per-host shards.  Ranges are contiguous
        # in concatenated row order, so (host, local_index) still
        # equals the single-process global order and the merge's
        # first-seen tie-break is preserved.
        total = sum(store_mod.peek_store_rows(p) for p in ref_paths)
        lo = total * process_id // num_processes
        hi = total * (process_id + 1) // num_processes
        my_files = list(ref_paths)
        range_kw = dict(skip_records=lo, limit_records=hi)
        log(f"[host {process_id}/{num_processes}] scanning store rows "
            f"[{lo}, {hi}) of {total}")
    else:
        my_files = assign_files(ref_paths, num_processes, process_id)
        log(f"[host {process_id}/{num_processes}] scanning "
            f"{len(my_files)} of {len(ref_paths)} database files")
    # per-host output AND checkpoint paths: on a shared filesystem a
    # single checkpoint path would be overwritten by every host, and
    # resume would fail the config-key check on all but the last writer
    part_cfg = replace(
        cfg, output=f"{cfg.prefix}.h{process_id}",
        checkpoint=(f"{cfg.checkpoint}.h{process_id}"
                    if cfg.checkpoint else None), **range_kw)
    res = run_nearest(my_files, query_path, part_cfg)

    k = res.indices.shape[1]
    used = [res.names.get(int(ri), f"db_{int(ri)}").encode()
            for row in res.indices for ri in row
            if int(ri) != int(IDX_SENTINEL)]
    local_w = max([len(b) for b in used] or [1])
    if num_processes > 1:
        # agree on one slot width across hosts before the fixed-shape
        # gather (names must never truncate — the merged CSV joins
        # against the per-host outputs by name)
        from jax.experimental import multihost_utils
        widths = np.asarray(multihost_utils.process_allgather(
            np.int32(local_w)))
        name_w = max(NAME_W, int(widths.max()))
    else:
        name_w = max(NAME_W, local_w)
    names = np.zeros((res.indices.shape[0], k, name_w), dtype=np.uint8)
    for qi in range(res.indices.shape[0]):
        for slot in range(k):
            ri = int(res.indices[qi, slot])
            if ri == int(IDX_SENTINEL):
                continue
            b = res.names.get(ri, f"db_{ri}").encode()
            names[qi, slot, :len(b)] = np.frombuffer(b, dtype=np.uint8)

    if num_processes > 1:
        g_scores, g_idx, g_names = _gather_parts(
            res.scores.astype(np.int32), res.indices.astype(np.int32),
            names)
    else:
        g_scores, g_idx, g_names = (res.scores.astype(np.int32)[None],
                                    res.indices.astype(np.int32)[None],
                                    names[None])
    if process_id == 0:
        from ..io.fasta import WRITE_CODEC_SUFFIX
        out = cfg.prefix + ".csv" + WRITE_CODEC_SUFFIX[cfg.codec]
        n = merge_and_write(res.pack, g_scores, g_idx, g_names, out)
        log(f"[host 0] merged {g_scores.shape[0]} hosts -> {out} "
            f"({n} rows)")
    return res


def merge_and_write(pack, g_scores, g_idx, g_names, path: str) -> int:
    """Exact cross-host top-k merge + ranked CSV.

    Sort: lexicographically decreasing over the six scores, ties by
    ascending (host, local_index) == single-process first-seen order
    (host file ranges are contiguous).
    """
    P, Q, k, name_w = g_names.shape
    n_rows = 0
    with open_write(path) as fh:
        fh.write((CSV_HEADER_ACGT if pack.acgt
                  else CSV_HEADER_FULL).encode())
        for qi in range(Q):
            s = g_scores[:, qi].reshape(P * k, 6)
            li = g_idx[:, qi].reshape(P * k)
            host = np.repeat(np.arange(P), k).astype(np.int64)
            nm = g_names[:, qi].reshape(P * k, name_w)
            valid = li != int(IDX_SENTINEL)
            s, li, host, nm = s[valid], li[valid], host[valid], nm[valid]
            order = np.lexsort((li, host, -s[:, 5], -s[:, 4], -s[:, 3],
                                -s[:, 2], -s[:, 1], -s[:, 0]))
            for rank, ci in enumerate(order[:k], start=1):
                name = bytes(nm[ci][nm[ci] != 0]).decode(
                    "utf-8", errors="replace")
                row = ",".join([pack.names[qi], name, str(rank)]
                               + [str(int(x)) for x in s[ci]])
                fh.write((row + "\n").encode())
                n_rows += 1
    return n_rows
