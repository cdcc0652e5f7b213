"""Two local processes + cross-host merge == single-process scan."""

import lzma
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from uvaia_tpu.engine.nearest import NearestConfig, run_nearest
from uvaia_tpu.parallel.multihost import assign_files, merge_and_write

from test_nearest import random_seqs, write_fasta

REPO = str(Path(__file__).resolve().parent.parent)


def test_assign_files_contiguous(tmp_path):
    paths = []
    for i, size in enumerate([100, 5, 5, 100, 40]):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    parts = [assign_files(paths, 3, pid) for pid in range(3)]
    assert sum(parts, []) == paths            # contiguous + complete
    assert all(parts)                          # nobody idle here


def test_two_process_merge_equals_single(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(55)
    L, nq, k = 300, 4, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    db_files = []
    base = 0
    for f in range(3):
        nr = [40, 25, 35][f]
        write_fasta(f"db{f}.fa", [f"r{base + i}" for i in range(nr)],
                    random_seqs(rng, nr, L))
        db_files.append(f"db{f}.fa")
        base += nr

    # ground truth: single-process scan over the full file list
    run_nearest(db_files, "q.fa",
                NearestConfig(nbest=k, pool=16, output="single"))
    single = lzma.open("single.csv.xz", "rb").read()

    # two coordinated processes, contiguous file ranges, merged top-k
    port = socket.socket().getsockname()[1] or 0
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from uvaia_tpu.engine.nearest import NearestConfig
        from uvaia_tpu.parallel.multihost import run_nearest_multihost
        pid = int(sys.argv[1])
        cfg = NearestConfig(nbest={k}, pool=16, output="mh")
        run_nearest_multihost({db_files!r}, "q.fa", cfg, 2, pid,
                              coordinator="localhost:{port}")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]

    merged = lzma.open("mh.csv.xz", "rb").read()
    assert merged == single

    # per-host dumps jointly cover every reference named in the CSV
    from uvaia_tpu.io.fasta import read_fasta_all
    dumped = {r.name for h in range(2)
              for r in read_fasta_all(f"mh.h{h}.aln.xz")}
    csv_refs = {l.split(",")[1]
                for l in merged.decode().strip().split("\n")[1:]}
    assert csv_refs <= dumped


def test_two_process_store_row_split_equals_single(tmp_path, monkeypatch):
    """ONE ingested store shared by two hosts via contiguous row ranges
    (skip/limit windows) merges to the same CSV as a single-process
    scan of the source FASTA."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(91)
    L, nq, nr, k = 300, 4, 90, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))
    from uvaia_tpu.io.store import ingest, peek_store_rows
    ingest(["db.fa"], "db.uvst", block=16)
    assert peek_store_rows("db.uvst") == nr

    run_nearest(["db.fa"], "q.fa",
                NearestConfig(nbest=k, pool=16, output="single"))
    single = lzma.open("single.csv.xz", "rb").read()

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from uvaia_tpu.engine.nearest import NearestConfig
        from uvaia_tpu.parallel.multihost import run_nearest_multihost
        pid = int(sys.argv[1])
        cfg = NearestConfig(nbest={k}, pool=16, output="mhs")
        run_nearest_multihost(["db.uvst"], "q.fa", cfg, 2, pid,
                              coordinator="localhost:{port}")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]
        assert b"scanning store rows" in o
    merged = lzma.open("mhs.csv.xz", "rb").read()
    assert merged == single


def test_store_row_window(tmp_path, monkeypatch):
    """StoreStreamer [skip, limit) windows tile the store exactly: the
    concatenation of 3 windows' rows == the full stream, including a
    window boundary inside a store block."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(92)
    L, nr = 200, 53
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))
    from uvaia_tpu.io.store import StoreStreamer, ingest
    ingest(["db.fa"], "db.uvst", block=16)

    def names_of(skip, limit):
        ss = StoreStreamer(["db.uvst"], L, 8, ref_ambiguity=1.0,
                           skip_records=skip, limit_records=limit)
        return [nm for b, _ in ss for nm in b.names]

    full = names_of(0, 0)
    assert full == [f"r{i}" for i in range(nr)]
    cuts = [0, 19, 37, nr]          # 19 and 37 fall mid-block
    tiled = sum((names_of(cuts[i], cuts[i + 1]) for i in range(3)), [])
    assert tiled == full


def test_merge_and_write_single_host_roundtrip(tmp_path, monkeypatch):
    """merge_and_write over one host's state reproduces write_csv."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(66)
    L, nq, nr, k = 250, 3, 30, 4
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))
    res = run_nearest(["db.fa"], "q.fa",
                      NearestConfig(nbest=k, pool=16, output="direct"))
    from uvaia_tpu.parallel import multihost as mh
    names = np.zeros((nq, k, mh.NAME_W), dtype=np.uint8)
    for qi in range(nq):
        for slot in range(k):
            ri = int(res.indices[qi, slot])
            if ri == 2**31 - 1:
                continue
            b = res.names[ri].encode()[:mh.NAME_W]
            names[qi, slot, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    merge_and_write(res.pack, res.scores.astype(np.int32)[None],
                    res.indices.astype(np.int32)[None], names[None],
                    "merged.csv.xz")
    assert (lzma.open("merged.csv.xz", "rb").read()
            == lzma.open("direct.csv.xz", "rb").read())


def test_two_process_crash_resume_equals_single(tmp_path, monkeypatch):
    """One host of a 2-process run crashes mid-scan at a checkpoint
    boundary; the rerun resumes that host from its per-host checkpoint
    (multihost.py:91-94) and the merged CSV still matches the
    single-process scan.  Lifts the single-host crash pattern of
    test_realdata.py::test_gate_resumed to the multihost layer."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(77)
    L, nq, k = 300, 4, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    db_files = []
    base = 0
    for f in range(3):
        nr = [40, 25, 60][f]
        write_fasta(f"db{f}.fa", [f"r{base + i}" for i in range(nr)],
                    random_seqs(rng, nr, L))
        db_files.append(f"db{f}.fa")
        base += nr

    run_nearest(db_files, "q.fa",
                NearestConfig(nbest=k, pool=16, output="single"))
    single = lzma.open("single.csv.xz", "rb").read()

    # phase A: host 1's shard run crashes after the first survivor
    # flush, leaving a valid per-host checkpoint + dump prefix (this is
    # exactly the state a killed host leaves on a shared filesystem)
    from dataclasses import replace
    import uvaia_tpu.engine.nearest as nearest_mod

    h1_files = assign_files(db_files, 2, 1)
    h1_cfg = NearestConfig(nbest=k, pool=16, output="mh.h1",
                           checkpoint="scan.ckpt.h1",
                           checkpoint_every=0.0)

    class _Boom(RuntimeError):
        pass

    count = {"n": 0}
    orig = nearest_mod.scan.flush_survivors

    def crashing(*a, **kw):
        if count["n"] >= 1:
            raise _Boom("simulated host crash")
        count["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(nearest_mod.scan, "flush_survivors", crashing)
    import pytest
    with pytest.raises(_Boom):
        run_nearest(h1_files, "q.fa", h1_cfg)
    monkeypatch.setattr(nearest_mod.scan, "flush_survivors", orig)
    assert Path("scan.ckpt.h1").exists()

    # phase B: full 2-process coordinated rerun with the shared
    # checkpoint prefix — host 1 must RESUME, not restart
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from uvaia_tpu.engine.nearest import NearestConfig
        from uvaia_tpu.parallel.multihost import run_nearest_multihost
        pid = int(sys.argv[1])
        cfg = NearestConfig(nbest={k}, pool=16, output="mh",
                            checkpoint="scan.ckpt",
                            checkpoint_every=1e9)
        run_nearest_multihost({db_files!r}, "q.fa", cfg, 2, pid,
                              coordinator="localhost:{port}")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]
    assert b"Resuming from checkpoint" in outs[1], \
        outs[1].decode()[-2000:]

    merged = lzma.open("mh.csv.xz", "rb").read()
    assert merged == single
