"""Native C++ FASTA reader == Python reader, on all codecs."""

import bz2
import gzip
import lzma

import pytest

from uvaia_tpu.io import native
from uvaia_tpu.io.fasta import _read_fasta_py, read_fasta

CONTENT = (">seq one extra words\n"
           "acgt ACGT\nnn--rymk\n"
           "\n"
           ">seq2\n"
           "TTTT\n")


@pytest.fixture(scope="module")
def have_native():
    if native.get_lib() is None:
        pytest.skip("native IO unavailable")


@pytest.mark.parametrize("codec", ["raw", "gz", "xz", "bz2"])
def test_native_matches_python(tmp_path, codec, have_native):
    path = tmp_path / f"t.fa.{codec}"
    opener = {"raw": open, "gz": gzip.open, "xz": lzma.open,
              "bz2": bz2.open}[codec]
    with opener(path, "wt") as f:
        f.write(CONTENT)
    got = [(r.name, r.seq) for r in read_fasta(path)]
    exp = [(r.name, r.seq) for r in _read_fasta_py(path)]
    assert got == exp
    assert got[0] == ("seq one extra words", b"ACGTACGTNN--RYMK")
    assert got[1] == ("seq2", b"TTTT")


def test_native_large_multiline(tmp_path, have_native):
    seqs = [("s%d" % i, "acgtACGT" * 500) for i in range(50)]
    path = tmp_path / "big.fa.xz"
    with lzma.open(path, "wt") as f:
        for n, s in seqs:
            f.write(f">{n}\n")
            for j in range(0, len(s), 61):
                f.write(s[j:j + 61] + "\n")
    recs = list(read_fasta(path))
    assert len(recs) == 50
    assert all(r.seq == b"ACGTACGT" * 500 for r in recs)


def test_native_open_failure(have_native):
    with pytest.raises(RuntimeError):
        list(native.read_fasta_native("/nonexistent/file.fa"))


def _truncated(data: bytes) -> bytes:
    """Drop the tail so the compressed stream ends mid-frame."""
    return data[: int(len(data) * 0.6)]


@pytest.mark.parametrize("codec", ["gz", "xz"])
def test_native_truncated_file_is_an_error(tmp_path, codec, have_native):
    """A corrupt/truncated compressed DB must raise, not silently drop
    the tail genomes (matches the Python reader, which raises too)."""
    comp = {"gz": gzip.compress, "xz": lzma.compress}[codec]
    big = "".join(f">s{i}\n" + "ACGT" * 256 + "\n" for i in range(200))
    path = tmp_path / f"trunc.fa.{codec}"
    path.write_bytes(_truncated(comp(big.encode())))
    with pytest.raises(RuntimeError):
        list(native.read_fasta_native(path))


@pytest.mark.parametrize("codec", ["gz", "xz"])
def test_native_clean_eof_still_clean(tmp_path, codec, have_native):
    """The truncation detection must not flag well-formed files."""
    opener = {"gz": gzip.open, "xz": lzma.open}[codec]
    path = tmp_path / f"ok.fa.{codec}"
    with opener(path, "wt") as f:
        f.write(CONTENT)
    assert len(list(native.read_fasta_native(path))) == 2


def test_streamer_qc_native_equals_python(tmp_path, have_native,
                                          monkeypatch):
    """The native reader's in-loop QC valid counts reject exactly the
    rows the Python path rejects (fasta_io.cpp valid[] vs numpy)."""
    import gzip
    import numpy as np
    from uvaia_tpu.engine.stream import RefStreamer

    L = 96
    good = "ACGT" * (L // 4)
    lowq = "N" * (L - 10) + "ACGTACGTAC"        # 10 valid sites
    # min_valid = int(96 * 0.6) = 57: 'deep' (48 valid) is rejected,
    # 'edge' (57 valid) sits exactly on the >= threshold and is kept
    deep = "N" * (L // 2) + "A" * (L - L // 2)
    edge = "N" * (L - 57) + "A" * 57
    body = (f">g1\n{good}\n>bad\n{lowq}\n>deep\n{deep}\n"
            f">edge\n{edge}\n>g2\n{good}\n")
    path = tmp_path / "db.fa.gz"
    with gzip.open(path, "wt") as f:
        f.write(body)

    def run():
        st = RefStreamer([str(path)], L, 8, ref_ambiguity=0.4)
        rows = []
        for b in st:
            rows += [(b.names[i], b.seq(i)) for i in range(b.n)]
        return rows, st.stats.n_invalid

    rows_native, inv_native = run()
    monkeypatch.setenv("UVAIA_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    rows_py, inv_py = run()
    monkeypatch.setattr(native, "_failed", False)

    assert rows_native == rows_py
    assert inv_native == inv_py == 2          # 'bad' and 'deep'
    assert [n for n, _ in rows_native] == ["g1", "edge", "g2"]


def test_multistream_xz_parallel_decode(tmp_path, monkeypatch):
    """Multi-stream xz files (what every engine writer emits) decode
    through the threaded span pipeline (fasta_io.cpp MtXzSource):
    forced 4 threads must reproduce the serial read exactly, including
    files with inter-stream padding (which python's lzma.open silently
    truncates at)."""
    import lzma

    import numpy as np

    from uvaia_tpu.io.native import read_fasta_native

    rng = np.random.default_rng(5)
    recs = [(f"s{i}", bytes(bytearray(
        b"ACGT"[j] for j in rng.integers(0, 4, 1500)))) for i in range(90)]

    multi = tmp_path / "multi.fa.xz"
    with open(multi, "wb") as f:
        for i in range(0, len(recs), 7):      # 13 independent streams
            blob = b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                            for n, s in recs[i:i + 7])
            f.write(lzma.compress(blob, preset=1))

    padded = tmp_path / "padded.fa.xz"
    with open(padded, "wb") as f:
        for i in range(0, len(recs), 30):
            blob = b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                            for n, s in recs[i:i + 30])
            f.write(lzma.compress(blob, preset=1))
            f.write(b"\x00" * 8)              # xz stream padding

    want = [(n, s) for n, s in recs]
    for path in (multi, padded):
        monkeypatch.setenv("UVAIA_TPU_XZ_THREADS", "4")
        got_mt = [(n, bytes(s)) for n, s in read_fasta_native(path)]
        monkeypatch.setenv("UVAIA_TPU_XZ_THREADS", "1")
        got_1 = [(n, bytes(s)) for n, s in read_fasta_native(path)]
        assert got_mt == want, f"threaded decode mismatch for {path}"
        assert got_1 == want, f"serial decode mismatch for {path}"


def test_native_build_without_codecs(tmp_path, monkeypatch, have_native):
    """Where the liblzma/zlib headers are missing, the library is built
    without xz/gzip decode: raw FASTA stays native, xz and gzip files go
    to the Python reader, and every file reads the same."""
    real_run = native.subprocess.run

    def no_codec_headers(cmd, **kw):
        if "-llzma" in cmd:
            return native.subprocess.CompletedProcess(
                cmd, 1, "", "fatal error: lzma.h: No such file or directory")
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", no_codec_headers)
    monkeypatch.setattr(native, "_SO", tmp_path / "libuvaia_io.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    lib = native.get_lib()
    assert lib is not None and lib.ufa_has_codecs() == 0
    for codec in ("raw", "gz", "xz"):
        path = tmp_path / f"t.fa.{codec}"
        opener = {"raw": open, "gz": gzip.open, "xz": lzma.open}[codec]
        with opener(path, "wt") as f:
            f.write(CONTENT)
        assert native.reads_natively(path) == (codec == "raw")
        if codec != "raw":
            with pytest.raises(RuntimeError):
                list(native.read_fasta_native(path))
        got = [(r.name, r.seq) for r in read_fasta(path)]
        assert got == [(r.name, r.seq) for r in _read_fasta_py(path)]
