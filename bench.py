"""Benchmark: database scan throughput (genomes/sec/chip) at top-k=50.

The HEADLINE metric is the per-chip scan rate (device-resident batch,
BASELINE.json config 3 shape: L=29903, IUPAC-realistic composition);
vs_baseline is against the driver's north-star of 100_000
genomes/sec/chip — a chip-compute target.

Crash containment: every section runs in its OWN subprocess with up to BENCH_RETRIES fresh-process
retries, and emits its measurements progressively as `@@BENCH {json}`
stderr lines — a fault mid-section keeps everything measured before
it.  The orchestrator never imports jax; it assembles whatever the
sections produced and ALWAYS prints the final JSON line.

Every timed measurement is the best of N full repeats (scan 5, align
3, realdata/scale 2).  Each repeat is a complete real run; the scan
section reports all samples alongside the best.

Sections and their keys:
  acgt      — kernel rate in --acgt mode (unambiguous-SNP scoring),
      same Q=64 shape as scan
  scan      — headline kernel rate (+ streamed/packed/h2d): every timed
      streamed step sparse-delta-encodes a DISTINCT host batch against
      the query majority (scan.delta_encode, native C++ scan) and
      uploads the (pos, val) diff lists (~3KB/row vs 15KB packed); the
      codes are rebuilt on device by one scatter.  The packed variant
      is reported beside it.
  q1000     — kernel rate at Q=1000 full mode (BASELINE config-3 shape)
  align     — two-pass banded-Gotoh aligner end-to-end on 30kb queries,
      xz output included (skip with BENCH_ALIGN=0)
  realdata  — end-to-end nearest on the bundled 9185-genome DB, plus
      the persistent-store path: one-time ingest then decode-free
      indexed scans (keys ingest_genomes_per_sec /
      indexed_scan_genomes_per_sec, store_verify_genomes_per_sec for
      the CRC integrity pass, and the frames-store variants
      ingest_frames_genomes_per_sec /
      indexed_frames_scan_genomes_per_sec where the survivor dump
      copies pre-compressed xz frames; skip all with BENCH_REALDATA=0)
  scale     — BASELINE configs 4/5 evidence, TIME-BOXED: 10k probe of
      every stage, then the largest N in {50k, 100k, 150k, 250k}
      whose projected wall fits BENCH_SCALE_TIMEOUT (default 2700s —
      sized so the whole bench stays under ~75 min), escalating to
      the next rung while the measured rate of the completed run says
      it fits — keys carry the actual N (ball/near/near_indexed/
      ingest/cluster/cluster_indexed_<N>k_genomes_per_sec, plus
      scale_probe_seconds / scale_chosen_n / scale_escalated_n).
      BENCH_SCALE_N forces a specific N; BENCH_SCALE=0 skips

The orchestrator holds the whole run to a GLOBAL wall budget
(BENCH_WALL, default 3000s): sections run headline-first, each clamped
to the remaining budget and skipped when it is exhausted, so the final
JSON line always prints before any plausible driver patience runs out.

EVIDENCE IS UN-LOSABLE (round-4 lesson: the driver's rc=124 kill of a
bench that only printed at the very end erased every already-measured
number): the orchestrator streams each section's ``@@BENCH`` stderr
fragments LIVE and, after every fragment, prints a complete
results-so-far JSON line to STDOUT (the driver parses the last stdout
line) — a SIGKILL at any moment keeps everything measured up to it.
The last line printed is the final record.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", ...};
the LAST line is the round's record (earlier lines are identical
progressive snapshots).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import queue as queue_mod
import signal
import subprocess
import sys
import threading
import time

import numpy as np

EMIT_TAG = "@@BENCH "


def emit(**kv):
    """Progressive result fragment: parsed by the orchestrator even if
    this section process dies on the next statement."""
    print(EMIT_TAG + json.dumps(kv), file=sys.stderr, flush=True)


def make_data(rng, n, L, n_frac=0.02, amb_frac=0.0005, mut=0.002,
              backbone=None):
    """IUPAC-realistic genomes: one shared backbone + ~0.2% SNPs, ~2% N,
    rare ambiguity codes per row — the composition of a real intra-
    species alignment (queries and database are the same population, as
    in BASELINE configs 1/3).  Pass `backbone` to draw more genomes
    from the same population.

    Mutation sites are SPARSE binomial scatters (draw the count, then
    uniform flat positions) instead of dense Bernoulli masks: a
    4096x30k float32 mask costs ~490MB of host RNG x3 per batch on a
    VM where memcpy IS the setup wall (~60s of the r04 339s
    pre-first-key setup); the scatter is a few MB for the same
    composition (replacement collisions at these densities are <1%)."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    if backbone is None:
        backbone = alphabet[rng.integers(0, 4, size=L)]
    seqs = np.tile(backbone, (n, 1))
    flat = seqs.reshape(-1)

    def scatter(frac, values):
        k = rng.binomial(n * L, frac)
        flat[rng.integers(0, n * L, k)] = values(k)

    scatter(mut, lambda k: alphabet[rng.integers(0, 4, k)])
    scatter(n_frac, lambda k: ord("N"))
    amb = np.frombuffer(b"RYMKSW", dtype=np.uint8)
    scatter(amb_frac, lambda k: amb[rng.integers(0, len(amb), k)])
    return seqs


# ----------------------------------------------------------------------
# sections (each runs in its own subprocess)

def section_scan(L, Q, B, K, STEPS, kernel_only=False, key_prefix="",
                 acgt=False):
    import jax
    import jax.numpy as jnp
    from uvaia_tpu.core.encoding import ENCODE_LUT
    from uvaia_tpu.engine.query import QueryPack
    from uvaia_tpu.ops import scan

    t_setup = time.time()
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = alphabet[rng.integers(0, 4, size=L)]
    queries = make_data(rng, Q, L, backbone=backbone)
    pack = QueryPack(names=[f"q{i}" for i in range(Q)],
                     codes=ENCODE_LUT[queries], acgt=acgt, trim=0)
    pack.create_indices()
    qd = scan.build_device_data(pack, k=K)

    # ONE host batch before the first key (round-4 lesson: 8 distinct
    # 4096x30k batches of host RNG + three extra kernel compiles cost
    # minutes before the first measurement — the
    # streamed paths build their extra batches AFTER the kernel keys
    # are already emitted and safe).
    host_codes = [ENCODE_LUT[make_data(rng, B, L, backbone=backbone)]]
    ok = jnp.ones(B, dtype=bool)
    state = scan.init_state(Q, K)

    # device-resident kernel rate (the compute ceiling): all STEPS
    # iterations run inside ONE dispatch (an on-device fori_loop), so
    # no per-step host dispatch enters the timing.  Best of 5 timed
    # repeats.
    #
    # Both modes scan the 4-bit PACKED batch (scan_steps_repeat_packed:
    # packed is the form real uploads arrive in).  The unpacked
    # continuity keys below keep the r03 headline definition visible.
    pk_res = jnp.asarray(scan.pack_codes(host_codes[0]))

    def krepeat(st, base):
        return scan.scan_steps_repeat_packed(qd, st, pk_res, ok,
                                             np.int32(base), STEPS)

    state = krepeat(state, 0)                            # compile+warm
    _ = np.asarray(state[0])
    emit(**{key_prefix + "setup_compile_seconds":
            round(time.time() - t_setup, 1)})
    print(f"# setup+compile {time.time()-t_setup:.1f}s "
          f"(L={L} Q={Q} B={B} K={K}, W={int(qd.q_full.shape[1])}, "
          f"device={jax.devices()[0]})", file=sys.stderr)
    rates = []
    for r in range(5):
        t0 = time.time()
        state = krepeat(state, (r + 1) * STEPS * B)
        _ = np.asarray(state[0])
        rates.append(round(STEPS * B / (time.time() - t0), 1))
        emit(**{key_prefix + "kernel_genomes_per_sec": max(rates),
                key_prefix + "kernel_rates_all": rates})

    # unpacked-step continuity key (the r03 headline definition); the
    # repeat kernel compiles on its warm call here, after the headline
    # keys are already out
    ref_codes0 = scan._to_width(jnp.asarray(host_codes[0]),
                                int(qd.q_full.shape[1]))
    state = scan.scan_steps_repeat(qd, state, ref_codes0, ok,
                                   np.int32(0), STEPS)
    _ = np.asarray(state[0])
    u = []
    for r in range(2):
        t0 = time.time()
        state = scan.scan_steps_repeat(
            qd, state, ref_codes0, ok,
            np.int32((r + 7) * STEPS * B), STEPS)
        _ = np.asarray(state[0])
        u.append(round(STEPS * B / (time.time() - t0), 1))
    emit(**{key_prefix + "kernel_unpacked_genomes_per_sec": max(u)})
    if kernel_only:
        return

    # distinct host batches for the streamed/H2D paths (generated only
    # now — the kernel keys above are already emitted and safe)
    NB = 4
    host_codes += [ENCODE_LUT[make_data(rng, B, L, backbone=backbone)]
                   for _ in range(NB - 1)]

    # H2D bandwidth probe (distinct pre-packed buffers)
    pre_packed = [scan.pack_codes(c) for c in host_codes]
    nbytes = pre_packed[0].nbytes
    t0 = time.time()
    devs = [jax.device_put(pre_packed[i % NB]) for i in range(4)]
    _ = [np.asarray(d[0, :8]) for d in devs]
    h2d = 4 * nbytes / (time.time() - t0) / 1e6
    emit(h2d_mb_per_sec=round(h2d, 1))

    # STREAMED rate, 4-bit packed uploads: pack + upload a distinct
    # batch every step (the fallback upload path)
    state = scan.init_state(Q, K)
    state, flags = scan.scan_step_packed(qd, state, pk_res, ok,
                                         np.int32(0))    # compile+warm
    _ = np.asarray(state[0])
    state = scan.init_state(Q, K)
    t0 = time.time()
    for i in range(STEPS):
        packed = scan.pack_codes(host_codes[i % NB])
        state, flags = scan.scan_step_packed(qd, state,
                                             jnp.asarray(packed), ok,
                                             np.int32((i + 1) * B))
    _ = np.asarray(state[0])
    _ = np.asarray(flags)
    packed_rate = STEPS * B / (time.time() - t0)
    emit(streamed_packed_genomes_per_sec=round(packed_rate, 1))

    # STREAMED rate, sparse-delta uploads (the default path): encode
    # each distinct batch against the query majority + upload the
    # (pos, val) diff lists + rebuild on device (scan.reconstruct_delta).
    # Host diffing runs ENCODE-AHEAD on a worker pool (the engine's
    # EncodedStream shape): batch i+1/i+2 encode while batch i's
    # upload + dispatch are in flight, so the measured rate is the
    # pipeline the real nearest scan runs, not a serial
    # encode->upload->dispatch chain.
    from uvaia_tpu.utils.prefetch import ordered_pool_map
    ok_h = np.ones(B, dtype=bool)
    base_h = np.asarray(qd.delta_base)
    enc0 = scan.delta_encode(host_codes[0], ok_h, base_h)
    state = scan.init_state(Q, K)
    if enc0 is not None:
        state, flags = scan.scan_step_delta(
            qd, state, jnp.asarray(enc0[0]), jnp.asarray(enc0[1]), ok,
            np.int32(0))                             # compile+warm
        _ = np.asarray(state[0])
        delta_bytes = enc0[0].nbytes + enc0[1].nbytes
        AHEAD = 2
        state = scan.init_state(Q, K)
        enc_iter = ordered_pool_map(
            lambda i: scan.delta_encode(host_codes[i % NB], ok_h,
                                        base_h),
            range(STEPS), AHEAD)
        t0 = time.time()
        for i, (pos, val) in enumerate(enc_iter):
            state, flags = scan.scan_step_delta(
                qd, state, jnp.asarray(pos), jnp.asarray(val), ok,
                np.int32((i + 1) * B))
        _ = np.asarray(state[0])
        _ = np.asarray(flags)
        streamed_rate = STEPS * B / (time.time() - t0)
        emit(streamed_genomes_per_sec=round(streamed_rate, 1))
        # transport-bound accounting: what the measured H2D bandwidth
        # alone would allow at this delta payload, and what fraction
        # of the time the chip is actually computing — together these
        # say whether the streamed gap is transport or host-bound
        emit(delta_bytes_per_genome=round(delta_bytes / B, 1),
             transport_bound_genomes_per_sec=round(
                 h2d * 1e6 / max(delta_bytes / B, 1e-9), 1),
             chip_busy_fraction=round(
                 streamed_rate / max(rates), 4))
    else:
        emit(streamed_genomes_per_sec=round(packed_rate, 1))


def _write_align_queries(f, ref, nq, rng):
    """nq mutated copies of ref: 5-60 SNPs + one indel (1-11 bp) each —
    the real-shape uvaialign input."""
    for b in range(nq):
        q = bytearray(ref)
        for _ in range(int(rng.integers(5, 60))):
            q[rng.integers(0, len(q))] = b"ACGT"[rng.integers(0, 4)]
        p = int(rng.integers(0, len(q) - 20))
        ln = int(rng.integers(1, 12))
        if rng.random() < 0.5:
            del q[p:p + ln]
        else:
            q[p:p] = bytes(bytearray(
                b"ACGT"[i] for i in rng.integers(0, 4, ln)))
        f.write(f">q{b}\n{bytes(q).decode()}\n")


def section_align(L):
    """Two-pass aligner rate on 30kb queries (warm, end-to-end through
    run_align incl. xz output), plus the BASELINE config-2 shape
    (5 000 unaligned queries in one run, key align_5k_seqs_per_sec;
    skip with BENCH_ALIGN_5K=0)."""
    import tempfile
    from uvaia_tpu.engine.align import AlignConfig, run_align

    rng = np.random.default_rng(1)
    n = L
    ref = bytes(bytearray(b"ACGT"[i] for i in rng.integers(0, 4, n)))
    NQ = int(os.environ.get("BENCH_ALIGN_NQ", 256))
    with tempfile.TemporaryDirectory() as d:
        with open(f"{d}/ref.fa", "w") as f:
            f.write(">ref\n" + ref.decode() + "\n")
        with open(f"{d}/q.fa", "w") as f:
            _write_align_queries(f, ref, NQ, rng)
        run_align(f"{d}/ref.fa", [f"{d}/q.fa"],
                  AlignConfig(output=f"{d}/warm"))      # compile+warm
        dt = None                       # best of 3
        for _ in range(3):
            t0 = time.time()
            stats = run_align(f"{d}/ref.fa", [f"{d}/q.fa"],
                              AlignConfig(output=f"{d}/out"))
            dt = min(dt or 1e9, time.time() - t0)
            assert stats.n_output == NQ
            emit(align_seqs_per_sec=round(NQ / dt, 1))

        if os.environ.get("BENCH_ALIGN_5K", "1") != "0":
            NQ5 = int(os.environ.get("BENCH_ALIGN_5K_N", 5000))
            with open(f"{d}/q5k.fa", "w") as f:
                _write_align_queries(f, ref, NQ5, rng)
            dt5 = None      # best of 2
            for _ in range(2):
                t0 = time.time()
                stats = run_align(f"{d}/ref.fa", [f"{d}/q5k.fa"],
                                  AlignConfig(output=f"{d}/out5k"))
                dt5 = min(dt5 or 1e9, time.time() - t0)
                assert stats.n_output == NQ5
                emit(align_5k_seqs_per_sec=round(NQ5 / dt5, 1),
                     align_5k_wall_s=round(dt5, 2),
                     align_5k_uncertified=stats.uncertified)
            # certification gate (emitted first so a regression still
            # lands its count in the round evidence): every row of the
            # realistic 5k workload must carry an optimality
            # certificate — the exact-fallback pass exists so this is
            # 0, and a silent regression here would otherwise hide
            # behind an unchanged seqs/sec number
            assert stats.uncertified == 0, \
                f"{stats.uncertified} uncertified align rows"


def section_realdata():
    """End-to-end nearest scan on the bundled real data (xz decode ->
    delta upload -> ranked CSV), BASELINE config-1 shape with 64
    queries: the honest whole-pipeline number on actual genomes."""
    import tempfile
    from uvaia_tpu.engine.nearest import NearestConfig, run_nearest
    from uvaia_tpu.io.fasta import read_fasta

    db = "/root/reference/data/03.unique_acgt.aln.xz"
    if not os.path.exists(db):
        return
    with tempfile.TemporaryDirectory() as d:
        qp = f"{d}/q.fa"
        with open(qp, "w") as f:
            for i, rec in enumerate(read_fasta(db)):
                if i >= 64:
                    break
                f.write(f">{rec.name}\n{rec.seq.decode()}\n")
        cfg = NearestConfig(nbest=8, exclude_self=True,
                            output=f"{d}/warm")
        r = run_nearest([db], qp, cfg)          # compile+warm
        dt = None       # best of 3
        for _ in range(3):
            t0 = time.time()
            r = run_nearest([db], qp,
                            NearestConfig(nbest=8, exclude_self=True,
                                          output=f"{d}/out"))
            dt = min(dt or 1e9, time.time() - t0)
            emit(realdata_e2e_genomes_per_sec=round(r.n_scanned / dt, 1))

        # the index half (SURVEY §7): one-time ingest to the persistent
        # store, then decode-free scans from its mmaps — repeat scans
        # are what surveillance users actually run.  Ingest is best of
        # 2 (xz decode + digest are host CPU work)
        import shutil
        from uvaia_tpu.io.store import ingest
        best = None
        for _ in range(2):
            shutil.rmtree(f"{d}/db.uvst", ignore_errors=True)
            st = ingest([db], f"{d}/db.uvst")
            best = max(best or 0.0, st.n_rows / st.seconds)
            emit(ingest_genomes_per_sec=round(best, 1))
        # integrity pass cost (info --verify): per-block CRC32 over the
        # whole committed store — operability evidence that corruption
        # checking is affordable on a production index
        from uvaia_tpu.io.store import verify
        t0 = time.time()
        rep = verify(f"{d}/db.uvst")
        assert rep["ok"], rep
        emit(store_verify_genomes_per_sec=round(
            st.n_rows / (time.time() - t0), 1))
        run_nearest([f"{d}/db.uvst"], qp,
                    NearestConfig(nbest=8, exclude_self=True,
                                  output=f"{d}/warm_ix"))   # warm shapes
        dt = None
        for _ in range(3):
            t0 = time.time()
            r = run_nearest([f"{d}/db.uvst"], qp,
                            NearestConfig(nbest=8, exclude_self=True,
                                          output=f"{d}/out_ix"))
            dt = min(dt or 1e9, time.time() - t0)
            emit(indexed_scan_genomes_per_sec=round(r.n_scanned / dt, 1))

        # frames store (ingest --frames): the survivor dump writes
        # pre-compressed xz frames instead of re-compressing — on this
        # host the dump's lzma work is ~40% of the indexed-scan wall
        # (1.4s of 3.3s measured), so this key shows the many-scans
        # steady state a surveillance deployment actually runs at
        shutil.rmtree(f"{d}/db.uvst", ignore_errors=True)
        st = ingest([db], f"{d}/dbf.uvst", frames=True)
        emit(ingest_frames_genomes_per_sec=round(st.n_rows / st.seconds, 1))
        dt = None
        for _ in range(3):
            t0 = time.time()
            r = run_nearest([f"{d}/dbf.uvst"], qp,
                            NearestConfig(nbest=8, exclude_self=True,
                                          output=f"{d}/out_ixf"))
            dt = min(dt or 1e9, time.time() - t0)
            emit(indexed_frames_scan_genomes_per_sec=round(
                r.n_scanned / dt, 1))

        # threaded multi-stream xz decode (fasta_io.cpp MtXzSource) on
        # a repo-written dump (one xz stream per record).  The ratio
        # compares serial decode against the DEFAULT thread config
        # (hardware_concurrency-1): on this ONE-core bench VM the
        # default is serial too, so the ratio is ~1.0 by construction —
        # the span pipeline pays only on multicore hosts.  A forced
        # 4-thread pass still exercises the span machinery for
        # correctness (record count must match; timing it on 1 core
        # only measures oversubscription).
        from uvaia_tpu.io.native import read_fasta_native
        dump = f"{d}/out_ix.aln.xz"
        if os.path.exists(dump):
            def reread(threads):
                if threads is None:
                    os.environ.pop("UVAIA_TPU_XZ_THREADS", None)
                else:
                    os.environ["UVAIA_TPU_XZ_THREADS"] = threads
                t0 = time.time()
                n = sum(1 for _ in read_fasta_native(dump))
                return n, time.time() - t0
            n1, t1s = reread("1")
            nf, _ = reread("4")            # span-path correctness
            nd, tds = reread(None)
            assert n1 == nf == nd
            emit(multistream_xz_reread_genomes_per_sec=round(nd / tds, 1),
                 multistream_xz_rescan_ratio=round(t1s / tds, 3))


def _fits(n, base_n, base_s, left):
    """True when an n-genome run projected linearly from a measured
    (base_n, base_s) run fits the remaining wall `left` with the
    section's single 0.92 margin."""
    return base_s * n / base_n <= 0.92 * left


def _ktag(n):
    """Key tag for an N-genome run: '100k' style when round, else the
    bare number (tiny test rungs via BENCH_SCALE_RUNGS)."""
    return f"{n//1000}k" if n >= 1000 and n % 1000 == 0 else str(n)


def _scale_rungs():
    rungs = os.environ.get("BENCH_SCALE_RUNGS",
                           "250000,150000,100000,50000")
    return tuple(sorted((int(x) for x in rungs.split(",")),
                        reverse=True))


def section_scale(n_forced):
    """BASELINE configs 4/5 evidence, driver-captured and TIME-BOXED:
    a 10k probe measures this host's per-genome cost of every stage
    (gen, ball, nearest, cluster, ingest, indexed nearest/ball/
    cluster), then the
    LARGEST N in {250k, 150k, 100k, 50k} whose projected wall fits the
    section budget runs for real, then the ladder climbs one rung at a
    time while the measured rate of the run just completed says the
    next rung fits the remaining wall.  Keys carry the actual N so a
    reduced run is never mistaken for the full config-4 one; the probe
    emits the 10k keys either way (round-over-round continuity).
    BENCH_SCALE_N forces a specific N and skips projection+ladder."""
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "scripts"))
    import scale_bench

    from uvaia_tpu.engine.ball import BallConfig, run_ball
    from uvaia_tpu.engine.cluster import ClusterConfig, run_cluster
    from uvaia_tpu.engine.nearest import NearestConfig, run_nearest
    from uvaia_tpu.io.store import ingest

    budget = float(os.environ.get("BENCH_SCALE_TIMEOUT", 1800)) * 0.95
    t_start = time.time()

    with tempfile.TemporaryDirectory() as d:
        wdb = f"{d}/warm.fa.gz"
        scale_bench.gen(512, wdb)
        wq = f"{d}/wq.fa"
        scale_bench._queries_from(wdb, 64, wq)
        # absorb every jit compile / cache load on the warm-up DB so
        # the timed runs measure throughput, not the compiler
        run_ball([wdb], wq, BallConfig(distance=5, output=f"{d}/wb"))
        run_nearest([wdb], wq, NearestConfig(nbest=50, output=f"{d}/wn"))
        run_cluster([wdb], ClusterConfig(distance=3, output=f"{d}/wc"))

        def run_at(n, tag, stages=None):
            """Generate an n-genome DB and time each stage once
            (``stages`` restricts the set — the nearest-only extension
            rung).  Returns (total seconds, per-stage seconds dict
            incl. 'gen')."""
            rates = {}

            def timed(key, fn):
                if stages is not None and key not in stages:
                    return 0.0
                t0 = time.time()
                fn()
                dt = time.time() - t0
                rates[key] = dt
                emit(**{f"{key}_{tag}_genomes_per_sec": round(n / dt, 1)})
                return dt

            db = f"{d}/db_{tag}.fa.gz"
            t0 = time.time()
            scale_bench.gen(n, db)
            rates["gen"] = time.time() - t0
            qp = f"{d}/q_{tag}.fa"
            scale_bench._queries_from(db, 64, qp)
            # stage order: the BASELINE config-4 trio (ball, nearest,
            # cluster) emits FIRST — keys emit progressively, so if the
            # big run overruns the section timeout only the tail
            # (indexed) keys are lost, never the headline scale trio
            timed("ball", lambda: run_ball(
                [db], qp, BallConfig(distance=5, output=f"{d}/b_{tag}")))
            timed("near", lambda: run_nearest(
                [db], qp, NearestConfig(nbest=50, output=f"{d}/n_{tag}")))
            timed("cluster", lambda: run_cluster(
                [db], ClusterConfig(distance=3, output=f"{d}/c_{tag}")))
            store = f"{d}/db_{tag}.uvst"
            timed("ingest", lambda: ingest([db], store))
            timed("near_indexed", lambda: run_nearest(
                [store], qp,
                NearestConfig(nbest=50, output=f"{d}/ni_{tag}")))
            timed("ball_indexed", lambda: run_ball(
                [store], qp,
                BallConfig(distance=5, output=f"{d}/bi_{tag}")))
            timed("cluster_indexed", lambda: run_cluster(
                [store], ClusterConfig(distance=3,
                                       output=f"{d}/ci_{tag}")))
            os.unlink(db)
            import shutil
            shutil.rmtree(store, ignore_errors=True)
            return sum(rates.values()), rates

        # probe size is env-overridable so the contract test can drive
        # this whole section live on CPU in seconds (test_bench_contract)
        probe_n = int(os.environ.get("BENCH_SCALE_PROBE", 10_000))
        tag = _ktag(probe_n)
        probe_s, stage_s = run_at(probe_n, tag)
        last_n = probe_n

        rungs = _scale_rungs()
        if n_forced:
            big = int(n_forced)
        else:
            # modest single margin (was 0.9 x 0.8 double): stage keys
            # emit progressively and the config-4 trio runs first, so
            # an overrun at the chosen N only costs the tail keys —
            # under-choosing N costs the whole point of the section
            left = budget - (time.time() - t_start)
            big = next((n for n in rungs
                        if _fits(n, probe_n, probe_s, left)), None)
            emit(scale_probe_seconds=round(probe_s, 1),
                 scale_chosen_n=big or 0)
        if big and big > probe_n:
            big_s, stage_s = run_at(big, _ktag(big))
            last_n = big
            # ESCALATION: the 10k probe OVERESTIMATES large-N cost —
            # per-run fixed work (query prep, compiles at fresh shapes,
            # output open) and partial-batch padding amortise away with
            # N.  The r04 validation measured 8.8 ms/genome at the 10k
            # probe but ~5 ms/genome in the actual 100k run, so a
            # linear probe projection under-chooses N by a full rung.
            # After the chosen run completes, climb to the largest rung
            # the MEASURED rate of the run just finished says still
            # fits the remaining wall.  Keys carry each run's actual N
            # (a reduced run is never mistaken for config 4), and the
            # biggest completed rung is emitted as scale_escalated_n.
            while not n_forced:
                left = budget - (time.time() - t_start)
                nxt = next((n for n in rungs if n > big
                            and _fits(n, big, big_s, left)), None)
                if not nxt:
                    break
                big_s, stage_s = run_at(nxt, _ktag(nxt))
                big = last_n = nxt
                emit(scale_escalated_n=big)

        # NEAREST-ONLY extension (BASELINE config-5 direction): when
        # the trio ladder is done and wall remains, climb further with
        # gen+nearest alone — the flagship scan scales past where the
        # full trio fits (cluster dominates the trio wall).  Projected
        # from the measured gen+near seconds of the last completed run.
        ext = tuple(sorted((int(x) for x in os.environ.get(
            "BENCH_SCALE_EXT_RUNGS", "1000000,500000").split(",")),
            reverse=True))
        while not n_forced and {"gen", "near"} <= stage_s.keys():
            left = budget - (time.time() - t_start)
            base_s = stage_s["gen"] + stage_s["near"]
            nxt = next((n for n in ext if n > last_n
                        and _fits(n, last_n, base_s, left)), None)
            if not nxt:
                break
            _, stage_s = run_at(nxt, _ktag(nxt),
                                stages={"near"})
            last_n = nxt
            emit(scale_near_only_n=nxt)


def run_section(name, L, Q, B, K, STEPS):
    if name == "sleepy":
        # contract-test section (BENCH_SECTIONS=sleepy): emit one key
        # then hang — lets tests SIGKILL the orchestrator mid-section
        # and assert the stdout snapshot already carried the key
        emit(sleepy_key=1.5)
        time.sleep(float(os.environ.get("BENCH_SLEEPY_S", 120)))
        return
    if name == "chatty":
        # contract-test section: emit keys forever — exercises the
        # leash kill on the line branch of _stream_section (a section
        # chatty enough that q.get never times out)
        i = 0
        while True:
            emit(chatty_key=i)
            i += 1
            time.sleep(0.2)
    from uvaia_tpu.utils.jaxcache import enable as _cache
    _cache()
    if name == "scan":
        section_scan(L, Q, B, K, STEPS)
    elif name == "acgt":
        section_scan(L, Q, B, K, STEPS, kernel_only=True,
                     key_prefix="acgt_", acgt=True)
    elif name == "q1000":
        section_scan(L, 1000, B, K, max(10, STEPS // 2),
                     kernel_only=True, key_prefix="q1000_")
    elif name == "align":
        section_align(L)
    elif name == "realdata":
        section_realdata()
    elif name == "scale":
        section_scale(int(os.environ.get("BENCH_SCALE_N", 0)))
    else:
        raise SystemExit(f"unknown section {name}")


# ----------------------------------------------------------------------
# orchestrator (no jax import here: the device is owned by one section
# subprocess at a time)

def collect(tail: str) -> dict:
    out = {}
    for ln in tail.splitlines():
        ln = ln.strip()
        if ln.startswith(EMIT_TAG):
            try:
                out.update(json.loads(ln[len(EMIT_TAG):]))
            except json.JSONDecodeError:
                pass
    return out


def final_record(results: dict, L, Q, K) -> dict:
    """The driver-facing record (also printed as progressive snapshots
    after every measurement — the last stdout line is the round's
    evidence even if the driver kills the orchestrator mid-run).

    The headline value is the device-resident loop rate, else the
    streamed rate, else 0.0."""
    extras = {k: v for k, v in results.items()
              if k != "kernel_genomes_per_sec"}
    value = results.get("kernel_genomes_per_sec",
                        results.get("streamed_genomes_per_sec", 0.0))
    return {
        "metric": f"nearest_scan_genomes_per_sec_per_chip_L{L}_Q{Q}_k{K}",
        "value": value,
        "unit": "genomes/sec/chip",
        "vs_baseline": round((value or 0.0) / 100_000.0, 4),
        **extras,
    }


def _stream_section(sec: str, env: dict, timeout: float, on_fragment):
    """Run one section subprocess, parsing its ``@@BENCH`` stderr lines
    LIVE (on_fragment(dict) per line) instead of after exit — the
    round-4 failure mode was a timeout kill erasing a finished
    section's output because nothing was consumed until completion.

    Returns (rc, n_keys, stderr_tail, timed_out); rc is None when the
    deadline killed the process.  The child dies with the orchestrator
    (PDEATHSIG), so a driver SIGKILL cannot leak a device-holding orphan
    into the next driver step.  The prctl is set by an exec shim in
    the CHILD interpreter rather than preexec_fn — CPython documents
    preexec_fn as unsafe in threaded parents (the stderr pump threads
    here), and PR_SET_PDEATHSIG survives execve."""
    shim = ("import ctypes, os, sys\n"
            "try:\n"
            "    ctypes.CDLL('libc.so.6', use_errno=True).prctl(1, "
            f"{int(signal.SIGKILL)})\n"
            "except Exception:\n"
            "    pass\n"
            "os.execv(sys.executable, [sys.executable] + sys.argv[1:])\n")
    p = subprocess.Popen(
        [sys.executable, "-c", shim, os.path.abspath(__file__),
         "--section", sec],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env)
    tail: collections.deque = collections.deque(maxlen=40)
    q: queue_mod.Queue = queue_mod.Queue()

    def pump():
        for ln in p.stderr:
            q.put(ln)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.time() + timeout
    keys = [0]
    timed_out = False
    eof = False

    def absorb_line(ln) -> None:
        tail.append(ln.rstrip())
        frag = collect(ln)
        if frag:
            keys[0] += len(frag)
            on_fragment(frag)

    def kill_and_drain() -> None:
        """Kill at the leash, then drain what the pipe already holds —
        fragments written before the kill are valid measurements
        (both deadline branches use this; review r5 finding)."""
        p.kill()
        t_drain = time.time() + 10
        while time.time() < t_drain:
            try:
                ln = q.get(timeout=0.5)
            except queue_mod.Empty:
                break
            if ln is None:
                break
            absorb_line(ln)

    while not eof:
        try:
            ln = q.get(timeout=max(0.1, min(5.0, deadline - time.time())))
        except queue_mod.Empty:
            if time.time() >= deadline:
                timed_out = True
                kill_and_drain()
                break
            continue
        if ln is None:
            eof = True
            break
        absorb_line(ln)
        if time.time() >= deadline:
            # a section chatty enough to never leave q.get empty must
            # still die at its leash — the deadline is checked on BOTH
            # branches
            timed_out = True
            kill_and_drain()
            break
    n_keys = keys[0]
    try:
        rc = p.wait(timeout=15)
    except subprocess.TimeoutExpired:
        p.kill()
        rc = None
    if timed_out:
        rc = None
    return rc, n_keys, "\n".join(tail), timed_out


def _sections_from_env() -> list:
    forced = os.environ.get("BENCH_SECTIONS")
    if forced:
        return [s.strip() for s in forced.split(",") if s.strip()]
    sections = ["scan", "acgt", "q1000"]
    if os.environ.get("BENCH_ALIGN", "1") != "0":
        sections.append("align")
    if os.environ.get("BENCH_REALDATA", "1") != "0":
        sections.append("realdata")
    if os.environ.get("BENCH_SCALE", "1") != "0":
        sections.append("scale")
    return sections


def orchestrate(snapshot=None):
    """Run all sections; call snapshot(results) after every fragment
    (the progressive stdout print lives in main)."""
    retries = int(os.environ.get("BENCH_RETRIES", 3))
    sections = _sections_from_env()
    # the scale section is TIME-BOXED: it probes at 10k, runs the
    # largest N in {50k, 100k, 150k, 250k} whose projected wall fits
    # this timeout, then ESCALATES rung-by-rung while the measured
    # rate of the completed run says the next rung still fits (see
    # section_scale).  A forced BENCH_SCALE_N scales the timeout
    # linearly instead.  Scale runs last, so the orchestrator clamps
    # it to the remaining global wall either way and the chooser
    # self-corrects downward on a slow window.
    scale_n = int(os.environ.get("BENCH_SCALE_N", 0))
    scale_to = int(os.environ.get("BENCH_SCALE_TIMEOUT",
                                  max(2400, int(scale_n * 0.03))))
    timeouts = {"scan": 1500, "acgt": 1200, "q1000": 1200, "align": 1500,
                "realdata": 1500, "scale": scale_to}
    # the scale section gets ONE attempt: it emits its 10k probe keys
    # progressively, and re-running a ~25-min section on a timeout
    # would push the whole bench past any plausible driver wall
    max_attempts = {"scale": 1}
    # GLOBAL wall budget: the worst-case sum of per-section timeouts x
    # retries is hours.  Sections run headline-first, each clamped to the
    # remaining budget and skipped entirely when too little is left.
    # 3000s default (was 4200): r04's driver kill arrived before 4200s
    # elapsed — the progressive stdout snapshots make a kill lossless
    # now, but finishing inside the driver's patience is still better.
    wall_budget = float(os.environ.get("BENCH_WALL", 3000))
    t_bench = time.time()

    results: dict = {}

    def absorb(frag: dict):
        results.update(frag)
        if snapshot is not None:
            snapshot(results)

    for sec in sections:
        sec_keys = 0
        stall_retried = False
        next_leash_cap = None
        attempts_allowed = max_attempts.get(sec, retries)
        for attempt in range(1, attempts_allowed + 1):
            left = wall_budget - (time.time() - t_bench)
            if left < 120:
                print(f"# section {sec} attempt {attempt}: skipped, "
                      f"wall budget exhausted ({left:.0f}s left)",
                      file=sys.stderr)
                break
            env = os.environ.copy()
            if sec == "scale":
                # the chooser inside must plan within the CLAMPED wall,
                # not the nominal timeout
                env["BENCH_SCALE_TIMEOUT"] = str(
                    int(min(scale_to, left)))
            leash = min(timeouts.get(sec, 1200), left)
            if next_leash_cap is not None:
                # the 600s cap applies to the single stall-retry
                # attempt only — later crash retries get the nominal
                # leash back (a crash is not a stall)
                leash = min(leash, next_leash_cap)
                next_leash_cap = None
            rc, n_keys, tail, timed_out = _stream_section(
                sec, env, leash, absorb)
            sec_keys += n_keys
            if timed_out:
                if sec_keys or stall_retried \
                        or attempt >= attempts_allowed:
                    # a timeout WITH keys means the section is too slow
                    # for its budget — an
                    # identical retry would eat the same wall again and
                    # starve the later sections.  Keys were absorbed
                    # live, so everything measured is already kept.
                    print(f"# section {sec} attempt {attempt}: timeout",
                          file=sys.stderr)
                    break
                # ZERO keys: the section never reached even its first
                # measurement: a stalled device grab (~0 CPU for the
                # entire timeout), not a slow section.  Retry ONCE on a
                # short leash: 600s is enough for any section's first
                # key, and caps what a repeat stall can take from the
                # sections after this one.
                stall_retried = True
                next_leash_cap = 600
                print(f"# section {sec} attempt {attempt}: timeout with "
                      f"no keys (device-grab stall?) — one 600s retry",
                      file=sys.stderr)
                continue
            if rc == 0:
                break
            print(f"# section {sec} attempt {attempt} rc={rc}:\n{tail}",
                  file=sys.stderr)
        if not sec_keys:
            print(f"# section {sec}: no results",
                  file=sys.stderr)
    return results


def main():
    L = int(os.environ.get("BENCH_L", 29903))
    Q = int(os.environ.get("BENCH_Q", 64))
    B = int(os.environ.get("BENCH_B", 4096))
    K = int(os.environ.get("BENCH_K", 50))
    STEPS = int(os.environ.get("BENCH_STEPS", 20))

    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default=None)
    args = ap.parse_args()
    if args.section:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        run_section(args.section, L, Q, B, K, STEPS)
        return

    def snapshot(results):
        # progressive evidence: one complete driver-format line per
        # measurement — the driver parses the LAST stdout line, so a
        # kill at any moment still leaves everything measured so far
        print(json.dumps(final_record(results, L, Q, K)), flush=True)

    results = orchestrate(snapshot=snapshot)
    print(json.dumps(final_record(results, L, Q, K)), flush=True)


if __name__ == "__main__":
    main()
