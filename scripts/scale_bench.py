#!/usr/bin/env python
"""Scale benchmarks for BASELINE configs 4/5 (250k ball/cluster, 1M scan).

Generates a synthetic SARS-CoV-2-scale database (one backbone + sparse
SNPs + N runs per genome — the composition the delta upload path sees
on real data) and times the tools end-to-end (gz decode -> device ->
output), reporting wall clock, genomes/sec, and peak RSS.

Usage:
  python scripts/scale_bench.py gen   --n 250000 --out /tmp/db250k.fa.gz
  python scripts/scale_bench.py near  --db /tmp/db250k.fa.gz --queries 64
  python scripts/scale_bench.py ball  --db /tmp/db250k.fa.gz -d 5
  python scripts/scale_bench.py clust --db /tmp/db250k.fa.gz -d 3
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# genome length: SARS-CoV-2-scale by default; env-overridable so the
# bench contract test can drive the full scale section cheaply on CPU
L = int(os.environ.get("UVAIA_SCALE_L", 29903))


def rss_mb() -> int:
    with open(f"/proc/{os.getpid()}/status") as f:
        for ln in f:
            if ln.startswith("VmRSS"):
                return int(ln.split()[1]) // 1024
    return 0


class PeakRss(threading.Thread):
    def __init__(self):
        super().__init__(daemon=True)
        self.peak = 0

    def run(self):
        while True:
            self.peak = max(self.peak, rss_mb())
            time.sleep(0.5)


def gen(n: int, out: str, seed: int = 0, **kw) -> None:
    """Synthetic lineage-structured alignment at length L (gzip)."""
    from uvaia_tpu.utils.synth import gen as _gen
    _gen(n, out, seed=seed, L=L, **kw)


def _queries_from(db: str, n: int, path: str) -> None:
    from uvaia_tpu.io.fasta import read_fasta
    with open(path, "w") as f:
        for i, rec in enumerate(read_fasta(db)):
            if i >= n:
                break
            f.write(f">{rec.name}\n{rec.seq.decode()}\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["gen", "near", "ball", "clust"])
    ap.add_argument("--n", type=int, default=250_000)
    ap.add_argument("--out", default="/tmp/db.fa.gz")
    ap.add_argument("--db", default="/tmp/db.fa.gz")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("-d", "--distance", type=int, default=5)
    ap.add_argument("-k", "--nbest", type=int, default=50)
    args = ap.parse_args()

    if args.mode == "gen":
        gen(args.n, args.out)
        return

    watcher = PeakRss()
    watcher.start()
    qpath = "/tmp/scale_queries.fa"
    _queries_from(args.db, args.queries, qpath)
    t0 = time.time()
    if args.mode == "near":
        from uvaia_tpu.engine.nearest import NearestConfig, run_nearest
        r = run_nearest([args.db], qpath,
                        NearestConfig(nbest=args.nbest,
                                      output="/tmp/scale_near"))
        n = r.n_scanned
    elif args.mode == "ball":
        from uvaia_tpu.engine.ball import BallConfig, run_ball
        r = run_ball([args.db], qpath,
                     BallConfig(distance=args.distance,
                                output="/tmp/scale_ball"))
        n = r["count"]
    else:
        from uvaia_tpu.engine.cluster import ClusterConfig, run_cluster
        out = run_cluster([args.db],
                          ClusterConfig(distance=args.distance,
                                        output="/tmp/scale_clust"))
        n = sum(1 + len(c.neighbours) for c in out)
    dt = time.time() - t0
    print(f"RESULT mode={args.mode} n={n} wall_s={dt:.1f} "
          f"rate={n/dt:.0f}/s peak_rss_mb={watcher.peak}")


if __name__ == "__main__":
    main()
