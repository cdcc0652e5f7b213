#!/usr/bin/env python3
"""On-card check that the main path runs on an NVIDIA GPU.

Everything runs in this one process, through the CLI entry point
``uvaia_tpu.cli.main.main``, on data made from ``--seed``:

* nearest — a lineage-structured archive of ``--n-db`` genomes at the
  full SARS-CoV-2 width (29 903 sites) is ingested into a store, then
  searched three ways (store, FASTA, store --no-prune) in full and
  --acgt modes, top-k 50, Q=64.  The CSVs of each mode must be
  byte-identical, every reported score must equal core/oracle.py
  recomputed on the host, and on a 4 096-row slice x 16 queries the
  whole top-k must equal ``oracle.nearest_oracle``.
* align — 1 024 raw genomes derived from the backbone (SNPs, indels,
  long deletions, amplicon-dropout N runs) are aligned; no row may be
  left uncertified, and 8 rows aligned on the card must equal the same
  ``gotoh.align_rows`` call on the CPU, bit for bit.
* kernels — the XLA scan step at Q=64 and Q=1000 in both modes and the
  sparse-delta rebuild, timed at B=4 096 and checked against the oracle
  and the batch (the Gotoh forward is timed in align).

  python chip_smoke.py [--seed 0] [--n-db 100000]
  python chip_smoke.py --four-cards   # only: nearest on 1 vs 4 cards

The script exits non-zero, and prints no result line, when JAX finds no
GPU or when any check fails.  Its last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import lzma
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
L_FULL = 29903
N_QUERY = 64


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ----------------------------------------------------------------------
# process-level plumbing

class CompileMeter:
    """Backend compile seconds and persistent-cache hits/misses, from
    JAX's monitoring events (cache retrieval counts as compile time)."""

    def __init__(self):
        self.seconds = 0.0
        self.hits = 0
        self.misses = 0

    def install(self) -> "CompileMeter":
        from jax import monitoring
        monitoring.register_event_duration_secs_listener(self._duration)
        monitoring.register_event_listener(self._event)
        return self

    def _duration(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


METER = CompileMeter()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def cli(args: list) -> tuple:
    """Run one CLI command in-process; returns (wall seconds, compile
    seconds, its stderr log).  A non-zero return code fails the run."""
    from uvaia_tpu.cli.main import main
    buf = io.StringIO()
    c0 = METER.seconds
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(buf, sys.stderr)):
        rc = main([str(a) for a in args])
    wall = time.perf_counter() - t0
    check(rc == 0, f"`{' '.join(map(str, args))}` returned {rc}")
    return wall, METER.seconds - c0, buf.getvalue()


@contextlib.contextmanager
def uncached():
    """Compile without the persistent cache inside: a CPU executable
    cached on another machine may use instructions this host's CPU
    lacks, so CPU code is never written to or read from the cache."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        cc.reset_cache()


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi reports them."""
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(p.returncode == 0, f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()


# ----------------------------------------------------------------------
# data

def fasta_offsets(n: int, L: int, prefix: str = "g") -> np.ndarray:
    """Byte offsets of records 0..n (n+1 entries) in a file of
    fixed-width one-line records named <prefix>0..<prefix>{n-1}."""
    digits = np.array([len(str(i)) for i in range(n)], dtype=np.int64)
    sizes = 1 + len(prefix) + digits + 1 + L + 1
    return np.concatenate([[0], np.cumsum(sizes)])


def fasta_rows(path: Path, idx, L: int, offsets: np.ndarray,
               prefix: str = "g") -> np.ndarray:
    """(len(idx), L) raw bytes of the given records, read by offset."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = np.empty((len(idx), L), dtype=np.uint8)
    for r, i in enumerate(idx):
        head = f">{prefix}{int(i)}\n".encode()
        o = int(offsets[i])
        check(bytes(mm[o:o + len(head)]) == head,
              f"record {i} not at its offset in {path}")
        out[r] = mm[o + len(head):o + len(head) + L]
    return out


def write_fasta(path: Path, names, rows) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(b">%s\n%s\n" % (nm.encode(), bytes(r))
                         for nm, r in zip(names, rows)))


def make_archive(work: Path, seed: int, n_db: int, L: int, n_query: int):
    """db.aln (uncompressed, names g<i>) and q.aln (names q<i>) from one
    Lineages draw: leading/trailing N and '-' runs on 30% of rows, the
    last 0.5% of rows highly divergent, IUPAC codes on every other
    query.  Returns (Lineages, db path, query path)."""
    from uvaia_tpu.utils.synth import gen
    t0 = time.perf_counter()
    db = work / "db.aln"
    lin = gen(n_db, str(db), seed=seed, L=L, ends=0.3, divergent=0.005,
              compress=False)
    q = lin.rows(n_query, ends=0.3)
    lin.add_iupac(q[::2], 20)
    qp = work / "q.aln"
    write_fasta(qp, [f"q{i}" for i in range(n_query)], q)
    say(f"data: {n_db} x {L} archive + {n_query} queries in "
        f"{time.perf_counter() - t0:.1f}s")
    return lin, db, qp


# ----------------------------------------------------------------------
# nearest

def read_csv(prefix: Path) -> bytes:
    with lzma.open(f"{prefix}.csv.xz", "rb") as f:
        return f.read()


def parse_csv(text: bytes) -> dict:
    """query -> [(reference, six scores)] in rank order."""
    out: dict = {}
    for ln in text.decode().strip().split("\n")[1:]:
        q, r, rank, *s = ln.split(",")
        rows = out.setdefault(q, [])
        check(int(rank) == len(rows) + 1, f"rank gap for {q}")
        rows.append((r, tuple(int(x) for x in s)))
    return out


def uploads(log: str) -> tuple:
    m = re.findall(r"Uploads: (\d+) sparse-delta batches, (\d+) packed",
                   log)
    check(m, "nearest printed no upload counts")
    return int(m[-1][0]), int(m[-1][1])


def _oracle_scores(pack, acgt: bool, ref_codes: np.ndarray, qi: int):
    from uvaia_tpu.core import oracle
    q = pack.codes[qi]
    valid = (ref_codes != 0).sum(axis=1)
    if acgt:
        return np.array([oracle.six_scores_acgt(
            r, q, pack.consensus, pack.idx_c, pack.idx_m, pack.idx,
            int(v)) for r, v in zip(ref_codes, valid)], dtype=np.int64)
    idx_mq = np.sort(np.concatenate([pack.idx_m, pack.idx]))
    return np.array([oracle.six_scores_full(
        r, q, pack.consensus, pack.idx_c, idx_mq, int(v))
        for r, v in zip(ref_codes, valid)], dtype=np.int64)


def check_reported(table: dict, pack, acgt: bool, db: Path, L: int,
                   offsets: np.ndarray, k: int) -> int:
    """(b): every reported pair's six scores equal the oracle's, and
    each query's order equals rank_refs over its reported set.  Returns
    the number of pairs checked."""
    from uvaia_tpu.core import oracle
    from uvaia_tpu.core.encoding import ENCODE_LUT
    qindex = {nm: i for i, nm in enumerate(pack.names)}
    check(set(table) == set(pack.names),
          f"CSV covers {len(table)} of {pack.n_query} queries")
    n = 0
    for qname, rows in table.items():
        check(len(rows) == k, f"{qname}: {len(rows)} neighbours, not {k}")
        gidx = np.array([int(r[1:]) for r, _ in rows])
        order = np.argsort(gidx)                 # database order
        codes = ENCODE_LUT[fasta_rows(db, gidx[order], L, offsets)]
        want = _oracle_scores(pack, acgt, codes, qindex[qname])
        got = np.array([s for _, s in rows], dtype=np.int64)[order]
        check(np.array_equal(got, want),
              f"{qname}: reported scores differ from the oracle")
        ranked = gidx[order][oracle.rank_refs(want, k)]
        check(np.array_equal(ranked, gidx),
              f"{qname}: rank order differs from rank_refs")
        n += len(rows)
    return n


def check_slice(work: Path, db: Path, qp: Path, acgt: bool, L: int,
                offsets: np.ndarray, n_rows: int, n_q: int, k: int,
                pool: int):
    """(c): on the first n_rows x n_q queries the whole top-k equals
    oracle.nearest_oracle."""
    from uvaia_tpu.core import oracle
    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.query import build_query_pack
    sl = work / "slice.aln"
    qs = work / "q_slice.aln"
    if not sl.exists():
        with open(db, "rb") as f:
            sl.write_bytes(f.read(int(offsets[n_rows])))
        with open(qp, "rb") as f:
            qs.write_bytes(b"".join(f.readline() for _ in range(2 * n_q)))
    mode = "acgt" if acgt else "full"
    prefix = work / f"slice_{mode}"
    cli(["nearest", "-r", sl, qs, "-n", k, "-p", pool, "-o", prefix]
        + (["--acgt"] if acgt else []))
    table = parse_csv(read_csv(prefix))
    pack = build_query_pack(str(qs), acgt=acgt)
    codes = ENCODE_LUT[fasta_rows(db, range(n_rows), L, offsets)]
    t0 = time.perf_counter()
    scores, topk = oracle.nearest_oracle(
        codes, (codes != 0).sum(axis=1), pack.codes, pack.consensus,
        pack.idx_c, pack.idx_m, pack.idx, k=k, acgt=acgt)
    for qi, qname in enumerate(pack.names):
        rows = table[qname]
        got = np.array([int(r[1:]) for r, _ in rows])
        check(np.array_equal(got, topk[qi]),
              f"slice {mode} {qname}: top-k differs from nearest_oracle")
        check(np.array_equal(np.array([s for _, s in rows]),
                             scores[topk[qi], qi, :]),
              f"slice {mode} {qname}: scores differ from nearest_oracle")
    say(f"nearest {mode}: slice {n_rows} x {len(pack.names)} top-{k} "
        f"equals nearest_oracle (oracle {time.perf_counter() - t0:.1f}s)")


def phase_nearest(work: Path, db: Path, qp: Path, n_db: int, L: int,
                  k: int = 50, slice_rows: int = 4096,
                  slice_queries: int = 16, pool: int = 4096) -> dict:
    """ingest, then nearest store / FASTA / store --no-prune in both
    modes, with checks (a), (b) and (c)."""
    from uvaia_tpu.engine.query import build_query_pack
    from uvaia_tpu.io.store import info
    store = work / "db.uvst"
    wall, comp, _ = cli(["ingest", "-o", store, "--block", pool, db])
    st = info(str(store))
    say(f"ingest: {n_db} genomes in {wall:.2f}s ({n_db / wall:,.0f} "
        f"genomes/s); {st['n_delta_blocks']} delta + "
        f"{st['n_packed_only_blocks']} packed-only blocks")
    check(st["n_rows"] == n_db, f"store holds {st['n_rows']} rows")
    offsets = fasta_offsets(n_db, L)
    out = {"ingest_s": wall}
    for acgt in (False, True):
        mode = "acgt" if acgt else "full"
        flag = ["--acgt"] if acgt else []
        csvs = {}
        for name, extra in (("store", ["-r", store]),
                            ("fasta", ["-r", db]),
                            ("store --no-prune", ["-r", store,
                                                  "--no-prune"])):
            prefix = work / f"{mode}_{name.replace(' --', '_')}"
            wall, comp, log = cli(["nearest", *extra, qp, "-n", k,
                                   "-p", pool, "-o", prefix, *flag])
            n_delta, n_packed = uploads(log)
            say(f"nearest {mode} {name}: {wall:.2f}s, {n_db / wall:,.0f} "
                f"genomes/s (compile {comp:.1f}s); uploads {n_delta} "
                f"delta + {n_packed} packed batches")
            check(n_delta > 0 and n_packed > 0,
                  f"{mode} {name}: both upload formats must run "
                  f"({n_delta} delta, {n_packed} packed)")
            csvs[name] = read_csv(prefix)
            out[f"{mode} {name}"] = wall
        first = csvs["store"]
        check(all(c == first for c in csvs.values()),
              f"nearest {mode}: the three CSVs differ")
        pack = build_query_pack(str(qp), acgt=acgt)
        t0 = time.perf_counter()
        n = check_reported(parse_csv(first), pack, acgt, db, L, offsets, k)
        say(f"nearest {mode}: 3 CSVs byte-identical; {n} reported pairs "
            f"equal the oracle and rank_refs "
            f"({time.perf_counter() - t0:.1f}s)")
        check_slice(work, db, qp, acgt, L, offsets,
                    min(slice_rows, n_db), slice_queries, k, pool)
    return out


# ----------------------------------------------------------------------
# align

def phase_align(work: Path, backbone: np.ndarray, seed: int,
                n_raw: int = 1024, n_cmp: int = 8) -> dict:
    """align raw genomes derived from the backbone; 0 uncertified rows;
    n_cmp rows on the card equal the CPU bit for bit."""
    import jax
    import jax.numpy as jnp
    from uvaia_tpu.engine import align as al
    from uvaia_tpu.io.fasta import FastaRecord, read_fasta_all
    from uvaia_tpu.ops import gotoh
    from uvaia_tpu.utils.synth import unaligned

    rng = np.random.default_rng(seed + 1)
    raws = unaligned(rng, backbone, n_raw)
    ref_fa, raw_fa = work / "ref.fa", work / "raw.fa"
    write_fasta(ref_fa, ["ref"], [backbone])
    write_fasta(raw_fa, [f"a{i}" for i in range(n_raw)], raws)
    prefix = work / "aligned"
    wall, comp, log = cli(["align", "-r", ref_fa, raw_fa, "-o", prefix])
    m = re.search(r"Total: (\d+) read, (\d+) aligned, \d+ wrong length, "
                  r"\d+ too ambiguous, (\d+) certified beyond --band, "
                  r"(\d+) uncertified \(band cap\), (\d+) failed", log)
    check(m, "align printed no totals")
    read, aligned, beyond, uncert, failed = map(int, m.groups())
    say(f"align: {n_raw} raw genomes in {wall:.2f}s, {n_raw / wall:,.1f} "
        f"seqs/s (compile {comp:.1f}s); {aligned} aligned, {beyond} "
        f"certified beyond --band, {uncert} uncertified, {failed} failed")
    check(read == n_raw and aligned == n_raw and failed == 0,
          f"align: {aligned} of {read} aligned, {failed} failed")
    check(uncert == 0, f"align: {uncert} uncertified rows")
    emitted = {r.name: r.seq for r in read_fasta_all(f"{prefix}.aln.xz")}

    # n_cmp rows inside the narrowest band, on the card and on the CPU
    n = backbone.shape[0]
    h = 64
    pick = [i for i, s in enumerate(raws)
            if abs(len(s) - n) + al.ROUTE_MARGIN <= h][:n_cmp]
    check(len(pick) == n_cmp, "too few narrow-band rows to compare")
    recs = [FastaRecord(f"a{i}", raws[i]) for i in pick]
    arr, lens = al._pack_rows(recs, b_mult=n_cmp)
    idx = np.arange(n_cmp, dtype=np.int32)

    def rows_on(dev):
        args = [jax.device_put(x, dev) for x in (backbone, arr, lens, idx)]
        return np.asarray(gotoh.align_rows(*args, -h, 2 * h + 1,
                                           gotoh.EV_CAP))
    meta = rows_on(jax.devices()[0])
    with uncached():
        meta_cpu = rows_on(jax.devices("cpu")[0])
    check(np.array_equal(meta, meta_cpu),
          f"align: the card's {n_cmp} rows differ from the CPU's")
    (score, edge_min, done, cnt, _ovf, t_end, ev_i,
     ev_t) = gotoh.unpack_meta_events(meta, gotoh.EV_CAP)
    for b, rec in enumerate(recs):
        row, cost = gotoh.decode_events(
            np.frombuffer(rec.seq, np.uint8), backbone, int(t_end[b]), -h,
            ev_i[b], ev_t[b], int(cnt[b]))
        check(row is not None and cost == score[b],
              f"align: {rec.name} decodes inconsistently")
        ok, _, _ = gotoh.certify(score[b:b + 1], edge_min[b:b + 1],
                                 done[b:b + 1], np.array([cost]),
                                 lens[b:b + 1], n, -h, 2 * h + 1)
        if ok[0]:
            check(emitted[rec.name] == row.tobytes(),
                  f"align: {rec.name} differs from the CLI's row")
    say(f"align: {n_cmp} rows on the card equal jax.devices('cpu') "
        f"bit for bit (scores {score[:n_cmp].tolist()})")

    # the forward's time per group: one pool of rows, narrowest band
    recs = [FastaRecord(f"a{i}", s) for i, s in enumerate(raws)]
    arr, lens = al._pack_rows(recs)
    ref_d, arr_d, lens_d = map(jnp.asarray, (backbone, arr, lens))
    fwd = lambda: gotoh.gotoh_forward(ref_d, arr_d, lens_d, -h, 2 * h + 1)
    jax.block_until_ready(fwd())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fwd())
        times.append(time.perf_counter() - t0)
    ms = 1e3 * min(times)
    say(f"align: gotoh_forward {ms:.1f} ms per group (B={arr.shape[0]}, "
        f"n={n}, W={2 * h + 1}; best of 3: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms)")
    return {"align_s": wall, "forward_ms": ms}


# ----------------------------------------------------------------------
# kernels

def gemm_summary(compiled_text: str) -> str:
    """Which library or generated kernel each matrix product became,
    with the element types on its line of the compiled HLO."""
    found: dict = {}
    for line in compiled_text.splitlines():
        m = re.search(r'custom_call_target="([^"]+)"', line)
        if m is None and "__triton_gemm" not in line:
            continue
        name = m.group(1) if m else "__triton_gemm fusion"
        types = "/".join(sorted(set(re.findall(r"\b(s8|s32|f32|bf16|f16)\[",
                                               line))))
        key = f"{name} ({types})" if types else name
        found[key] = found.get(key, 0) + 1
    return ("; ".join(f"{k} x{c}" for k, c in sorted(found.items()))
            or "no custom calls (XLA's own kernels)")


def time_rebuild(qd, refs: np.ndarray, steps: int) -> float:
    """Time the sparse-delta rebuild (one XLA scatter + the run-marker
    pass) on a real batch, check that it returns the batch exactly, and
    that the padding slots are unique and out of range, as the
    scatter's unique_indices=True requires.  Returns ms per batch."""
    import jax
    import jax.numpy as jnp
    from uvaia_tpu.ops import scan
    B, L = refs.shape
    base = np.asarray(qd.delta_base)
    enc = scan.delta_encode(refs, np.ones(B, dtype=bool), base)
    check(enc is not None, "rebuild: the batch does not fit the buckets")
    pos, val = enc
    n = (pos < L).sum(axis=1)
    check((np.diff(pos.astype(np.int64), axis=1) > 0).all(),
          "rebuild: positions are not strictly ascending")
    check(((pos >= L) == (np.arange(pos.shape[1]) >= n[:, None])).all(),
          "rebuild: padding slots are not after the entries, out of range")
    W = int(qd.q_full.shape[1])
    fn = jax.jit(scan.reconstruct_delta, static_argnums=3)
    args = (jnp.asarray(base), jnp.asarray(pos), jnp.asarray(val), W)
    img = np.asarray(fn(*args))
    check(np.array_equal(img[:, :L], refs) and not img[:, L:].any(),
          "rebuild: the scatter did not return the batch")
    t0 = time.perf_counter()
    for _ in range(steps):
        img = fn(*args)
    jax.block_until_ready(img)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    say(f"kernels: delta rebuild B={B} E={pos.shape[1]} W={W}: "
        f"{ms:.3f} ms/batch, equals the batch; {int((val >= 16).sum())} "
        f"run markers")
    return ms


def phase_kernels(lin, seed: int, B: int = 4096, k: int = 50,
                  queries=(64, 1000), steps: int = 10) -> dict:
    """Time scan_step at the given query counts in both modes, report
    the GEMM route, check sampled scores against the oracle, and time
    the delta rebuild."""
    import jax
    import jax.numpy as jnp
    from uvaia_tpu.core import oracle
    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.query import QueryPack
    from uvaia_tpu.ops import scan

    L = lin.L
    rng = np.random.default_rng(seed + 2)
    refs = ENCODE_LUT[lin.rows(B, ends=0.3)]
    ref_d = jnp.asarray(refs)
    ok = jnp.ones(B, dtype=bool)
    out = {}
    for Q in queries:
        q = lin.rows(Q, ends=0.3)
        lin.add_iupac(q[::2], 20)
        for acgt in (False, True):
            mode = "acgt" if acgt else "full"
            pack = QueryPack(names=[f"q{i}" for i in range(Q)],
                             codes=ENCODE_LUT[q], acgt=acgt, trim=0)
            pack.create_indices()
            qd = scan.build_device_data(pack, k=k)
            state = scan.init_state(pack.n_query, k)
            comp = scan.scan_step.lower(qd, state, ref_d, ok,
                                        np.int32(0)).compile()
            state, _ = comp(qd, state, ref_d, ok, np.int32(0))
            jax.block_until_ready(state)
            t0 = time.perf_counter()
            for i in range(steps):
                state, flags = comp(qd, state, ref_d, ok,
                                    np.int32((i + 1) * B))
            jax.block_until_ready((state, flags))
            ms = 1e3 * (time.perf_counter() - t0) / steps
            mem = comp.memory_analysis()
            temp = getattr(mem, "temp_size_in_bytes", None)
            say(f"kernels: scan_step Q={pack.n_query} {mode} B={B} "
                f"L={L}: {ms:.2f} ms/step, {B / ms * 1e3:,.0f} genomes/s; "
                f"temp {temp} bytes; GEMM: {gemm_summary(comp.as_text())}")
            out[f"scan_step_q{Q}_{mode}_ms"] = ms
            # sampled pairs against the oracle at this width
            s6, _ = jax.jit(scan.score_batch)(qd, ref_d)
            s6 = np.asarray(s6)
            idx_mq = np.sort(np.concatenate([pack.idx_m, pack.idx]))
            valid = (refs != 0).sum(axis=1)
            for b, qi in zip(rng.integers(0, B, 16),
                             rng.integers(0, pack.n_query, 16)):
                if acgt:
                    want = oracle.six_scores_acgt(
                        refs[b], pack.codes[qi], pack.consensus,
                        pack.idx_c, pack.idx_m, pack.idx, int(valid[b]))
                else:
                    want = oracle.six_scores_full(
                        refs[b], pack.codes[qi], pack.consensus,
                        pack.idx_c, idx_mq, int(valid[b]))
                check(tuple(s6[b, qi]) == tuple(want),
                      f"kernels: Q={Q} {mode} pair ({b}, {qi}) differs "
                      "from the oracle")
            if Q == queries[0] and not acgt:
                out["rebuild_ms"] = time_rebuild(qd, refs, steps)
    return out


# ----------------------------------------------------------------------
# four cards

def phase_four_cards(work: Path, db: Path, qp: Path, n_db: int,
                     k: int = 50) -> dict:
    """nearest on one device vs --devices 4 vs --devices 4
    --site-shards 2, both modes, byte-identical CSVs."""
    store = work / "db.uvst"
    wall, _, _ = cli(["ingest", "-o", store, db])
    say(f"ingest: {n_db} genomes in {wall:.2f}s")
    out = {}
    for acgt in (False, True):
        mode = "acgt" if acgt else "full"
        csvs = {}
        for name, extra in (("1 device", []),
                            ("--devices 4", ["--devices", 4]),
                            ("--devices 4 --site-shards 2",
                             ["--devices", 4, "--site-shards", 2])):
            prefix = work / f"{mode}_{len(csvs)}"
            wall, comp, _ = cli(["nearest", "-r", store, qp, "-n", k,
                                 "-o", prefix, *extra]
                                + (["--acgt"] if acgt else []))
            say(f"four-cards {mode} {name}: {wall:.2f}s, "
                f"{n_db / wall:,.0f} genomes/s (compile {comp:.1f}s)")
            csvs[name] = read_csv(prefix)
            out[f"{mode} {name}"] = wall
        first = next(iter(csvs.values()))
        check(all(c == first for c in csvs.values()),
              f"four-cards {mode}: CSVs differ between meshes")
        say(f"four-cards {mode}: 3 CSVs byte-identical "
            f"({len(first.splitlines()) - 1} rows)")
    return out


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-db", type=int, default=100_000)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only nearest on 1 vs 4 cards")
    ap.add_argument("--workdir", default=str(HERE / ".chip_smoke"),
                    help="scratch directory (removed at the end)")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); nothing was run",
              file=sys.stderr)
        return 2
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import uvaia_tpu
    check(Path(uvaia_tpu.__file__).resolve().parent.parent == HERE,
          "the uvaia_tpu package beside this script was not found")

    METER.install()
    for line in card_lines():
        say(f"card: {line}")
    env = {k: os.environ.get(k, "")
           for k in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    say(f"jax {jax.__version__}; devices {len(devices)} x "
        f"{devices[0].device_kind}; "
        + "; ".join(f"{k}={v!r}" for k, v in env.items()))
    work = Path(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    lin, db, qp = make_archive(work, args.seed, args.n_db, L_FULL,
                               N_QUERY)
    if args.four_cards:
        phase_four_cards(work, db, qp, args.n_db)
    else:
        phase_nearest(work, db, qp, args.n_db, L_FULL)
        phase_align(work, lin.backbone, args.seed)
        phase_kernels(lin, args.seed)
    shutil.rmtree(work, ignore_errors=True)
    say(f"total {time.perf_counter() - t0:.1f}s; compile "
        f"{METER.seconds:.1f}s; persistent cache {METER.hits} hits, "
        f"{METER.misses} misses")
    # count: the cards the phases used, not every card JAX can see
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": 4 if args.four_cards else 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
