"""Batch-size invariance (the reference's test_extensive.sh K/B matrix):
output must be byte-identical whether reads arrive in one batch or
many — batch boundaries cross the wave scheduler, the HMM device pool,
the AsyncWriter, and per-batch model caches."""

import os
import subprocess
import sys

import pytest

ECOLI = "/root/reference/test/ecoli_2kb_region"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")

_SCRIPT = r"""
import sys, os, tempfile, filecmp
sys.path.insert(0, %(repo)r); os.chdir(%(repo)r)
from f5c_tpu.io.bam import write_bam
from f5c_tpu.io.fasta import FastaIndex
from f5c_tpu.io.readdb import ReadDB
from f5c_tpu.pipeline.runner import Options, Pipeline
from f5c_tpu.pipeline.eventalign import run_eventalign

ECOLI = %(ecoli)r
tmp = tempfile.mkdtemp(prefix="bi_")
fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
names = fa.names()[:8]
genome = os.path.join(tmp, "genome.fa"); reads = os.path.join(tmp, "reads.fasta")
with open(genome, "w") as g, open(reads, "w") as r:
    for n in names:
        seq = fa.fetch(n); g.write(f">{n}\n{seq}\n"); r.write(f">{n}\n{seq}\n")
class Rec: pass
recs = []
for i, n in enumerate(names):
    rec = Rec(); rec.qname = n; rec.flag = 0; rec.tid = i; rec.pos = 0
    rec.mapq = 60; rec.cigar = [(0, fa.entries[n].length)]; rec.seq = fa.fetch(n)
    recs.append(rec)
bam = os.path.join(tmp, "self.bam")
write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
ReadDB(reads).build(fast5_dirs=[os.path.join(ECOLI, "fast5_files")])

meth_outs, ea_outs = [], []
for K in (3, 512):
    pipe = Pipeline(bam, genome, reads,
                    Options(min_mapq=0, meth_out_version=1, batch_reads=K))
    p = os.path.join(tmp, f"m_{K}.tsv")
    with open(p, "w") as out:
        pipe.call_methylation(out=out)
    meth_outs.append(p)
    pipe = Pipeline(bam, genome, reads,
                    Options(min_mapq=0, batch_reads=K))
    class A: pass
    q = os.path.join(tmp, f"ea_{K}.tsv")
    with open(q, "w") as out:
        run_eventalign(pipe, A(), out=out)
    ea_outs.append(q)
assert os.path.getsize(meth_outs[0]) > 0 and os.path.getsize(ea_outs[0]) > 0
assert filecmp.cmp(*meth_outs, shallow=False), "meth: K=3 != K=512"
assert filecmp.cmp(*ea_outs, shallow=False), "eventalign: K=3 != K=512"
print("BATCH_INVARIANT_OK")
"""


def test_output_invariant_to_batch_size():
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "F5C_TPU_MESH": "0"})
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT % dict(repo=REPO, ecoli=ECOLI)],
        env=env, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BATCH_INVARIANT_OK" in out.stdout
