"""Events-engine wiring: the batched on-device detector must drive the
FULL production pipeline to byte-identical output vs the host C++
engine (the device detector is wired into
align_batch_waved, selected by --events-engine / the measured
dispatch-latency probe).

Runs on the CPU backend, where the device detector executes eagerly (IEEE div/sqrt — bit-exact vs the oracle,
tests/test_events_device.py), so the two engines' meth TSVs must match
byte-for-byte.
"""

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

ECOLI = %(ecoli)r
tmp = tempfile.mkdtemp(prefix="ee_")
fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
names = fa.names()[:6]
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
outs = []
for eng in ("device", "host"):
    pipe = Pipeline(bam, genome, reads,
                    Options(min_mapq=0, meth_out_version=1,
                            events_engine=eng))
    assert pipe._events_engine() == eng
    p = os.path.join(tmp, f"m_{eng}.tsv")
    with open(p, "w") as out:
        pipe.call_methylation(out=out)
    outs.append(p)
assert os.path.getsize(outs[0]) > 0
assert filecmp.cmp(outs[0], outs[1], shallow=False), "device != host engine"
print("EVENTS_ENGINE_OK")
"""


def test_device_engine_matches_host_e2e():
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu", "F5C_TPU_MESH": "0"})
    env.pop("XLA_FLAGS", None)
    env.pop("F5C_TPU_EVENTS_ENGINE", None)
    out = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT % dict(repo=REPO, ecoli=ECOLI)],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EVENTS_ENGINE_OK" in out.stdout


def test_plain_loader_device_engine_matches_host():
    """The non-wave loader (_load_batch) also honours
    --events-engine device; loaded events must bit-match the host
    engine (eager device op on the CPU backend)."""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    env.pop("F5C_TPU_EVENTS_ENGINE", None)
    code = r"""
import sys, os, glob
import numpy as np
sys.path.insert(0, %(repo)r)
from f5c_tpu.pipeline.runner import (Options, Pipeline, ReadRecord,
                                     _worker_init)
from f5c_tpu.models import builtin_model
from f5c_tpu.io.fasta import FastaIndex
ECOLI = %(ecoli)r
fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
names = fa.names()[:5]
import json
readdb = {}
paths = sorted(glob.glob(os.path.join(ECOLI, "fast5_files", "*.fast5")))
from f5c_tpu.io.fast5 import Fast5File
for p in paths:
    for rid in Fast5File(p).read_ids():
        readdb[rid] = p
def mk():
    return [ReadRecord(qname=n, read_idx=i, tid=i, pos=0,
                       cigar=[(0, fa.entries[n].length)],
                       is_reverse=False, seq=fa.fetch(n),
                       signal_path=readdb[n])
            for i, n in enumerate(names)]
outs = []
for eng in ("device", "host"):
    pipe = Pipeline.bare(Options(events_engine=eng),
                         builtin_model("dna_r9_nucleotide"))
    _worker_init("dna_r9_nucleotide", None, False)
    batch = pipe._load_batch(None, mk(), keep_raw=False)
    outs.append(batch)
for a, b in zip(*outs):
    np.testing.assert_array_equal(a.event_means, b.event_means)
    np.testing.assert_array_equal(a.event_starts, b.event_starts)
    assert a.scaling.shift == b.scaling.shift
    assert a.scaling.scale == b.scaling.scale
print("PLAIN_LOADER_OK")
""" % dict(repo=REPO, ecoli=ECOLI)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PLAIN_LOADER_OK" in out.stdout


def test_auto_resolves_host_on_cpu_backend():
    """auto must pick the host engine when the native library is
    built (event means return to the host for MoM either way)."""
    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    env.pop("F5C_TPU_EVENTS_ENGINE", None)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from f5c_tpu.pipeline.runner import Options, Pipeline\n"
        "from f5c_tpu.models import builtin_model\n"
        "p = Pipeline.bare(Options(), builtin_model('dna_r9_nucleotide'))\n"
        "assert p._events_engine() == 'host', p._events_engine()\n"
        "print('AUTO_OK')\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "AUTO_OK" in out.stdout
