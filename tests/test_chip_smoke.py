"""chip_smoke.py off the card: its device gate, the data generator it
uses, and its phases at tiny sizes on the CPU."""

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from uvaia_tpu.utils import synth

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_gate_refuses_cpu(tmp_path):
    """On the CPU, and as a lone file without the package, the script
    exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd in (REPO, alone):
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode != 0
        assert '"ok"' not in p.stdout
        assert "no GPU" in p.stderr


def test_generator_deterministic_width_alphabet(tmp_path):
    """Same seed, same bytes; every row is L wide; members hold only
    ACGT and the N/'-' masks; add_iupac adds ambiguity codes; the
    divergent rows are the last ones."""
    L, n = 3000, 400
    files = []
    for name in ("a.aln", "b.aln"):
        synth.gen(n, str(tmp_path / name), seed=3, L=L, ends=0.3,
                  divergent=0.02, compress=False)
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1]
    lines = files[0].split(b"\n")
    assert lines[0] == b">g0" and lines[2 * (n - 1)] == b">g%d" % (n - 1)
    rows = np.stack([np.frombuffer(s, np.uint8) for s in lines[1::2]
                     if s])
    assert rows.shape == (n, L)
    assert set(np.unique(rows).tobytes()) <= set(b"ACGTN-")
    backbone = synth.Lineages(3, L, max(1, n // 40)).backbone
    snps = ((rows != backbone[None, :])
            & np.isin(rows, synth.ALPHA)).sum(axis=1)
    assert snps[:-8].max() <= 11              # 8 lineage + 0-3 private
    assert snps[-8:].min() > 0.1 * L          # ~3/16 of the sites
    ends = (rows[:, 0] == ord("N")) | (rows[:, 0] == ord("-"))
    assert 0.15 < ends.mean() < 0.45

    lin = synth.Lineages(5, L, 4)
    q = lin.rows(6)
    assert np.array_equal(q, synth.Lineages(5, L, 4).rows(6))
    lin.add_iupac(q, 5)
    assert np.isin(q, synth.IUPAC).any(axis=1).all()


def test_phase_nearest_tiny(tmp_path):
    """ingest + nearest store / FASTA / --no-prune, both modes, checks
    (a)-(c), at full width (the packed fallback needs > 4 096 diffs in
    a row) but 192 rows, top-3."""
    cs = _chip_smoke()
    _, db, qp = cs.make_archive(tmp_path, 0, 192, cs.L_FULL, 4)
    out = cs.phase_nearest(tmp_path, db, qp, 192, cs.L_FULL, k=3,
                           slice_rows=64, slice_queries=2, pool=64)
    assert {"ingest_s", "full store", "acgt store --no-prune"} <= set(out)


def test_phase_align_tiny(tmp_path):
    """align of raw genomes derived from a short backbone: 0
    uncertified rows, and the default device's rows equal the CPU's."""
    cs = _chip_smoke()
    backbone = synth.Lineages(0, 2000, 4).backbone
    out = cs.phase_align(tmp_path, backbone, 0, n_raw=16, n_cmp=3)
    assert out["forward_ms"] > 0
