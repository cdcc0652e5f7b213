"""Driver-contract guards for bench.py and scripts/scale_bench.py.

The round driver runs ``python bench.py`` ONCE and records rc + the
final stdout line as the round's ONLY performance evidence, so the
orchestrator must never crash or hang past its wall budget — even when
every section fails or is skipped.  These tests exercise that contract
cheaply (no accelerator, no real sections) by exhausting the global
wall budget so all sections take the skip path.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_always_prints_final_json_line():
    env = dict(os.environ, BENCH_WALL="1", JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = [ln for ln in p.stdout.strip().splitlines() if ln.strip()]
    assert lines, "no stdout at all"
    rec = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec, rec
    # all sections were skipped, so the headline value must be the
    # honest 0.0, never a stale or invented number
    assert rec["value"] == 0.0


def test_scale_gen_output_shape_and_alphabet(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import scale_bench

    out = str(tmp_path / "g.fa.gz")
    scale_bench.gen(300, out, seed=7)

    import gzip
    names, seqs = [], []
    with gzip.open(out, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                names.append(line[1:])
            elif line:
                seqs.append(line)
    assert len(names) == 300 and len(seqs) == 300
    assert names[0] == b"g0" and names[-1] == b"g299"
    L = scale_bench.L
    assert {len(s) for s in seqs} == {L}
    allowed = set(b"ACGTN")
    assert set(b"".join(seqs[:20])) <= allowed
    # rows of one lineage share their centre SNPs: with 300/40=7
    # lineages the pairwise Hamming distribution must be bimodal
    # (near-zero within lineage vs ~8+ across), and N-runs exist
    a = np.frombuffer(seqs[0], dtype=np.uint8)
    assert any(s.count(b"N") > 0 for s in seqs[:50])
    dists = [np.count_nonzero(a != np.frombuffer(s, dtype=np.uint8))
             for s in seqs[1:40]]
    assert min(dists) >= 0 and max(dists) > 4


def test_bench_scale_section_live():
    """Drive the WHOLE scale section live (tiny genomes via
    UVAIA_SCALE_L + BENCH_SCALE_PROBE): all seven stage keys must emit,
    config-4 trio (ball/near/cluster) strictly before the indexed tail
    — the ordering that bounds what an overrun can lose — and the
    chooser must decline the big run inside a tiny budget."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", UVAIA_SCALE_L="2000",
               BENCH_SCALE_PROBE="256", BENCH_SCALE_TIMEOUT="1")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--section", "scale"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    tag = "@@BENCH "
    keys = []
    for ln in p.stderr.splitlines():
        if ln.startswith(tag):
            keys.extend(json.loads(ln[len(tag):]).keys())
    stages = ["ball", "near", "cluster", "ingest", "near_indexed",
              "ball_indexed", "cluster_indexed"]
    expect = [f"{s}_256_genomes_per_sec" for s in stages]
    assert [k for k in keys if k in expect] == expect, keys
    rec = dict.fromkeys(keys)
    assert "scale_probe_seconds" in rec
    # budget 1s: the probe alone exceeds it, so no big N is chosen and
    # no misleading larger-N key may appear
    assert "scale_chosen_n" in rec
    assert not any(k.endswith("_genomes_per_sec") and "_256_" not in k
                   for k in keys), keys


def test_scale_ladder_chooser_and_escalation():
    """The scale ladder's projection math (bench._fits): the 10k probe
    overestimates large-N cost (r04 validation: 8.8 ms/genome probed
    vs ~5 ms/genome measured at 100k), so after the chosen run the
    ladder must climb on the MEASURED rate.  Replays that validation
    window: probe admits only 100k, the measured 100k run then admits
    150k, a slower window admits nothing further."""
    sys.path.insert(0, REPO)
    import bench

    rungs = bench._scale_rungs()
    assert rungs == (250_000, 150_000, 100_000, 50_000)

    # r04 validation numbers: probe 88s at 10k, ~1400s left => the
    # linear probe projection admits 100k but not 150k/250k
    left = 1400.0
    big = next((n for n in rungs if bench._fits(n, 10_000, 88.0, left)),
               None)
    assert big == 100_000

    # the 100k run actually measured ~500s; with 1000s left the ladder
    # escalates to 150k (250k projected 1250s does not fit 920s)
    nxt = next((n for n in rungs if n > big
                and bench._fits(n, big, 500.0, 1000.0)), None)
    assert nxt == 150_000
    # a 2700s budget window: 250k fits straight from the measured run
    nxt = next((n for n in rungs if n > big
                and bench._fits(n, big, 500.0, 1865.0)), None)
    assert nxt == 250_000
    # slow window: nothing further fits — ladder stops, no overrun
    assert next((n for n in rungs if n > big
                 and bench._fits(n, big, 500.0, 400.0)), None) is None

    # BENCH_SCALE_RUNGS override (the live-ladder sanity lever) parses
    # and sorts descending; _ktag keys tiny rungs honestly
    os.environ["BENCH_SCALE_RUNGS"] = "512,2048,1024"
    try:
        assert bench._scale_rungs() == (2048, 1024, 512)
    finally:
        del os.environ["BENCH_SCALE_RUNGS"]
    assert bench._ktag(250_000) == "250k"
    assert bench._ktag(512) == "512"
    assert bench._ktag(10_000) == "10k"


def test_timeout_policy_stall_retry_vs_partial_keep(monkeypatch):
    """Timeout policy: a section that times out with ZERO emitted keys
    (a stalled device grab — ~0 CPU for the whole timeout) gets
    exactly ONE
    retry on a 600s leash; a section that timed out after emitting
    keys keeps its partials and is NOT re-run (an identical retry
    would eat the same wall again)."""
    sys.path.insert(0, REPO)
    import bench

    for var in ("BENCH_ALIGN", "BENCH_REALDATA", "BENCH_SCALE"):
        monkeypatch.setenv(var, "0")  # sections = scan, acgt, q1000
    monkeypatch.delenv("BENCH_SECTIONS", raising=False)
    monkeypatch.setenv("BENCH_RETRIES", "3")   # hermetic vs ambient env
    monkeypatch.setenv("BENCH_WALL", "100000")

    # scenario 1: every attempt stalls before its first key
    calls = []

    def stall(sec, env, timeout, on_fragment):
        calls.append((sec, timeout))
        return None, 0, "", True

    monkeypatch.setattr(bench, "_stream_section", stall)
    assert bench.orchestrate() == {}
    per_sec = {}
    for sec, to in calls:
        per_sec.setdefault(sec, []).append(to)
    assert set(per_sec) == {"scan", "acgt", "q1000"}
    for sec, tos in per_sec.items():
        assert len(tos) == 2, (sec, tos)   # one stall retry, no more
        assert tos[1] == 600, (sec, tos)   # short leash

    # scenario 2: timeout AFTER a key emitted -> keep partial, no retry
    calls.clear()

    def partial(sec, env, timeout, on_fragment):
        calls.append((sec, timeout))
        on_fragment({"part_key": 1.5})
        return None, 1, "", True

    monkeypatch.setattr(bench, "_stream_section", partial)
    out = bench.orchestrate()
    assert out.get("part_key") == 1.5
    assert [c[0] for c in calls] == ["scan", "acgt", "q1000"]  # 1x each

    # scenario 3 (ADVICE r4): a zero-key stall on the section's LAST
    # allowed attempt must NOT claim (or attempt) a retry
    calls.clear()
    monkeypatch.setenv("BENCH_RETRIES", "1")
    monkeypatch.setattr(bench, "_stream_section", stall)
    assert bench.orchestrate() == {}
    assert [c[0] for c in calls] == ["scan", "acgt", "q1000"]  # 1x each

    # scenario 4 (ADVICE r4): after the one 600s stall retry, a
    # CRASHING attempt (rc != 0, not a timeout) gets the section's
    # nominal leash back, not the 600s stall cap
    calls.clear()
    monkeypatch.setenv("BENCH_RETRIES", "4")
    state = {"n": 0}

    def stall_then_crash(sec, env, timeout, on_fragment):
        calls.append((sec, timeout))
        state["n"] += 1
        if state["n"] == 1:
            return None, 0, "", True      # stall, no keys
        return 1, 0, "boom", False        # fast crash

    monkeypatch.setattr(bench, "_stream_section", stall_then_crash)
    monkeypatch.setenv("BENCH_SECTIONS", "scan")
    bench.orchestrate()
    assert [to for _, to in calls] == [1500, 600, 1500, 1500]


def test_sigkill_mid_section_keeps_stdout_snapshot():
    """The exact r04 failure mode: the driver SIGKILLs bench.py while a
    section is still running.  The progressive stdout snapshots must
    already carry every measured key in driver-parseable form (the
    driver takes the LAST stdout line)."""
    import signal

    env = dict(os.environ, BENCH_SECTIONS="sleepy", BENCH_WALL="100000",
               BENCH_SLEEPY_S="45")
    p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bench.py")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=REPO)
    try:
        import threading
        box = {}

        def read_one():
            box["line"] = p.stdout.readline()

        t = threading.Thread(target=read_one, daemon=True)
        t.start()
        t.join(timeout=60)
        assert box.get("line"), "no stdout snapshot before the kill"
    finally:
        try:
            os.kill(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait(timeout=30)
    rec = json.loads(box["line"])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in rec, rec
    assert rec["sleepy_key"] == 1.5


def test_stream_section_kills_chatty_section_at_leash():
    """Review r5: a section that emits stderr lines faster than the
    q.get timeout must still die at its leash, and the fragments it
    emitted before the kill must all be kept (same drain as the
    queue-empty branch)."""
    import time as time_mod

    sys.path.insert(0, REPO)
    import bench

    frags = []
    t0 = time_mod.time()
    rc, n_keys, tail, timed_out = bench._stream_section(
        "chatty", dict(os.environ), 4, frags.append)
    wall = time_mod.time() - t0
    assert timed_out and rc is None
    assert n_keys >= 3, (n_keys, tail)
    assert any("chatty_key" in f for f in frags)
    assert wall < 30, wall          # killed at the leash, not later
