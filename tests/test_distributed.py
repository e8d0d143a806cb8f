"""jax.distributed multi-process layer (parallel/distributed.py).

The reference has no distributed backend (users shard inputs by hand and
merge with freq-merge — SURVEY §2.7); here the framework owns it.  The
e2e test launches TWO real CPU processes with a jax.distributed
coordinator and asserts the merged call-methylation output is
byte-identical to a single-process run.
"""

import os
import socket
import subprocess
import sys

import pytest

ECOLI = "/root/reference/test/ecoli_2kb_region"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")


def test_merge_marked_parts(tmp_path):
    """K-way marker merge restores global read order exactly."""
    from f5c_tpu.parallel.distributed import merge_marked_parts

    p0 = tmp_path / "out.part0"
    p1 = tmp_path / "out.part1"
    p0.write_text("colA\tcolB\n"
                  "#f5c-dist\t0\nr0 line1\nr0 line2\n"
                  "#f5c-dist\t2\nr2 line1\n")
    p1.write_text("colA\tcolB\n"
                  "#f5c-dist\t1\nr1 line1\n"
                  "#f5c-dist\t3\nr3 line1\nr3 line2\n")
    out = tmp_path / "out.tsv"
    n = merge_marked_parts([str(p0), str(p1)], str(out))
    assert n == 4
    assert out.read_text() == ("colA\tcolB\n"
                               "r0 line1\nr0 line2\n"
                               "r1 line1\n"
                               "r2 line1\n"
                               "r3 line1\nr3 line2\n")


def test_merge_empty_shard(tmp_path):
    """A shard that matched no reads still has a header-only part."""
    from f5c_tpu.parallel.distributed import merge_marked_parts

    p0 = tmp_path / "o.part0"
    p1 = tmp_path / "o.part1"
    p0.write_text("hdr\n#f5c-dist\t0\nrow\n")
    p1.write_text("hdr\n")
    out = tmp_path / "o.tsv"
    assert merge_marked_parts([str(p0), str(p1)], str(out)) == 1
    assert out.read_text() == "hdr\nrow\n"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.readdb import ReadDB

    tmp = str(tmp_path_factory.mktemp("dist"))
    fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
    names = fa.names()[:6]
    genome = os.path.join(tmp, "genome.fa")
    reads = os.path.join(tmp, "reads.fasta")
    with open(genome, "w") as g, open(reads, "w") as r:
        for n in names:
            seq = fa.fetch(n)
            g.write(f">{n}\n{seq}\n")
            r.write(f">{n}\n{seq}\n")

    class Rec:
        pass

    recs = []
    for i, n in enumerate(names):
        rec = Rec()
        rec.qname = n
        rec.flag = 0
        rec.tid = i
        rec.pos = 0
        rec.mapq = 60
        rec.cigar = [(0, fa.entries[n].length)]
        rec.seq = fa.fetch(n)
        recs.append(rec)
    bam = os.path.join(tmp, "self.bam")
    write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
    ReadDB(reads).build(fast5_dirs=[os.path.join(ECOLI, "fast5_files")])
    return tmp, bam, genome, reads


def _cpu_env():
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO,
    })
    env.pop("XLA_FLAGS", None)   # no virtual mesh; plain 1-device CPU
    return env


def _cli(extra, env):
    return subprocess.Popen(
        [sys.executable, "-m", "f5c_tpu.cli", "call-methylation",
         "--min-mapq", "0", "--device", "cpu"] + extra,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)


def test_two_process_dist_matches_single(dataset):
    tmp, bam, genome, reads = dataset
    common = ["-b", bam, "-g", genome, "-r", reads,
              "--meth-out-version", "1"]
    env = _cpu_env()

    single = os.path.join(tmp, "single.tsv")
    p = _cli(common + ["-o", single], env)
    _, err = p.communicate(timeout=900)
    assert p.returncode == 0, err[-3000:]

    merged = os.path.join(tmp, "dist.tsv")
    # bind-then-release picks a free port, but another process can grab
    # it in the window before the coordinator rebinds — retry once on a
    # fresh port rather than flake
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist = ["--dist", "--dist-coordinator", f"127.0.0.1:{port}",
                "--dist-nprocs", "2", "-o", merged]
        procs = [_cli(common + dist + ["--dist-rank", str(r)], env)
                 for r in range(2)]
        errs = [p.communicate(timeout=900)[1] for p in procs]
        if all(p.returncode == 0 for p in procs):
            break
        if attempt == 1:
            for p, err in zip(procs, errs):
                assert p.returncode == 0, err[-3000:]

    with open(single) as a, open(merged) as b:
        assert a.read() == b.read()
    # parts were cleaned up after the merge
    assert not os.path.exists(merged + ".part0")
    assert not os.path.exists(merged + ".part1")
