"""Synthetic SARS-CoV-2-scale alignments, made from a seed.

Genomes are drawn around lineage centres: centre = backbone + ~8 SNPs;
member = centre + 0-3 private SNPs + one masked N run — the redundancy
profile clustering/dedup exists for (a purely random per-genome
mutation model makes every genome a singleton, which no real
surveillance dataset resembles).  Options add what real archives also
carry: leading and trailing N/'-' runs, IUPAC ambiguity codes, and a
few highly divergent rows; `unaligned` derives raw (unaligned) genomes
from the backbone for the aligner.
"""

from __future__ import annotations

import gzip
import sys
import time

import numpy as np

L_SARS2 = 29903
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
IUPAC = np.frombuffer(b"RYMKSWBDHV", dtype=np.uint8)
MASKS = np.frombuffer(b"N-", dtype=np.uint8)


class Lineages:
    """One backbone and `n_lineages` centres; `rows` draws members."""

    def __init__(self, seed: int, L: int, n_lineages: int):
        self.rng = np.random.default_rng(seed)
        self.L = L
        self.n_lineages = n_lineages
        self.backbone = ALPHA[self.rng.integers(0, 4, size=L)]
        self.centre_pos = self.rng.integers(0, L, (n_lineages, 8))
        self.centre_val = self.rng.integers(0, 4, (n_lineages, 8))

    def rows(self, m: int, ends: float = 0.0) -> np.ndarray:
        """(m, L) uint8 member rows.  A fraction `ends` of them get a
        leading and a trailing masked run (N or '-', 1-299 sites)."""
        rng, L = self.rng, self.L
        rows = np.tile(self.backbone, (m, 1))
        lin = rng.integers(0, self.n_lineages, m)
        # lineage-centre SNPs: one flat scatter for the whole chunk
        rr = np.repeat(np.arange(m), 8)
        rows[rr, self.centre_pos[lin].ravel()] = ALPHA[
            self.centre_val[lin].ravel()]
        # 0-3 private SNPs per row
        k = rng.integers(0, 4, m)
        rr = np.repeat(np.arange(m), k)
        rows[rr, rng.integers(0, L, rr.size)] = ALPHA[
            rng.integers(0, 4, rr.size)]
        # one masked N run per row (length 0-599, clamped for short
        # test genomes)
        run = rng.integers(0, min(600, max(2, L // 5)), m)
        start = rng.integers(0, L - run)
        cols = np.arange(L)
        rows[(cols >= start[:, None]) & (cols < (start + run)[:, None])] = \
            ord("N")
        if ends:
            cap = min(300, max(2, L // 10))
            has = rng.random(m) < ends
            lead = np.where(has, rng.integers(1, cap, m), 0)
            trail = np.where(has, rng.integers(1, cap, m), 0)
            lead_c = MASKS[rng.integers(0, 2, m)]
            trail_c = MASKS[rng.integers(0, 2, m)]
            head = cols < lead[:, None]
            tail = cols >= (L - trail)[:, None]
            rows[head] = np.broadcast_to(lead_c[:, None], rows.shape)[head]
            rows[tail] = np.broadcast_to(trail_c[:, None], rows.shape)[tail]
        return rows

    def add_iupac(self, rows: np.ndarray, max_codes: int) -> None:
        """Put 1..max_codes IUPAC ambiguity codes on every row, in place."""
        m, L = rows.shape
        k = self.rng.integers(1, max_codes + 1, m)
        rr = np.repeat(np.arange(m), k)
        rows[rr, self.rng.integers(0, L, rr.size)] = IUPAC[
            self.rng.integers(0, len(IUPAC), rr.size)]

    def diverge(self, rows: np.ndarray, frac: float = 0.25) -> None:
        """Replace a fraction `frac` of each row's sites with random
        bases, in place: ~frac*3/4*L diffs, beyond the delta buckets."""
        m, L = rows.shape
        k = int(frac * L)
        rr = np.repeat(np.arange(m), k)
        rows[rr, self.rng.integers(0, L, rr.size)] = ALPHA[
            self.rng.integers(0, 4, rr.size)]


def gen(n: int, out: str, seed: int = 0, chunk: int = 512,
        lineages: int = 0, L: int = L_SARS2, ends: float = 0.0,
        divergent: float = 0.0, compress: bool = True) -> Lineages:
    """Write n genomes named g0..g{n-1} to `out` (gzip level 1, or raw
    FASTA with compress=False) and return the Lineages they came from.
    `lineages` defaults to n//40.  A fraction `divergent` of the rows,
    the last ones of the file, are highly divergent (Lineages.diverge):
    kept together, so they land in the last scan batch, which takes the
    packed upload while the rest stay on deltas."""
    lin = Lineages(seed, L, lineages or max(1, n // 40))
    div_lo = n - int(round(divergent * n))
    t0 = time.time()
    opener = (gzip.open(out, "wb", compresslevel=1) if compress
              else open(out, "wb"))
    with opener as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            rows = lin.rows(m, ends=ends)
            if div_lo < done + m:
                lin.diverge(rows[max(div_lo - done, 0):])
            f.write(b"".join(
                b">g%d\n%s\n" % (done + r, rows[r].tobytes())
                for r in range(m)))
            done += m
            if done % 51200 == 0:
                print(f"gen: {done}/{n} ({time.time()-t0:.0f}s)",
                      file=sys.stderr)
    print(f"gen: wrote {n} genomes ({lin.n_lineages} lineages) to {out} "
          f"in {time.time()-t0:.0f}s", file=sys.stderr)
    return lin


def unaligned(rng: np.random.Generator, ref: np.ndarray, n: int,
              long_del: float = 0.02, dropout: float = 0.2) -> list:
    """n raw genomes derived from `ref` (uint8): 5-60 SNPs and 0-3
    indels of 1-30 bp each; a fraction `long_del` also lose 200-400 bp
    in one deletion, and a fraction `dropout` carry one or two
    amplicon-dropout N runs of 200-300 sites.  Returns bytes rows."""
    out = []
    for _ in range(n):
        q = bytearray(ref.tobytes())
        for _ in range(int(rng.integers(5, 61))):
            q[int(rng.integers(0, len(q)))] = int(ALPHA[rng.integers(0, 4)])
        if rng.random() < dropout:
            for _ in range(int(rng.integers(1, 3))):
                ln = int(rng.integers(200, 301))
                p = int(rng.integers(0, len(q) - ln))
                q[p:p + ln] = b"N" * ln
        for _ in range(int(rng.integers(0, 4))):
            ln = int(rng.integers(1, 31))
            p = int(rng.integers(0, len(q) - ln))
            if rng.random() < 0.5:
                del q[p:p + ln]
            else:
                q[p:p] = ALPHA[rng.integers(0, 4, ln)].tobytes()
        if rng.random() < long_del:
            ln = int(rng.integers(200, 401))
            p = int(rng.integers(0, len(q) - ln))
            del q[p:p + ln]
        out.append(bytes(q))
    return out
