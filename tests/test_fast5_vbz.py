"""vbz-compressed FAST5: decode without the ONT HDF5 plugin.

A multi-read FAST5 is synthesized with vbz-filtered Signal chunks
written via write_direct_chunk (zstd over StreamVByte zigzag-delta,
matching the ONT vbz v1 layout); the reader must decode it chunk by
chunk.  (The reference errors on such files unless the plugin is
installed, fast5lite.h:296-298.)
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

VBZ = 32020


def _vbz_compress(samples: np.ndarray) -> bytes:
    from f5c_tpu.io.slow5 import _svb_zd_encode
    from f5c_tpu.io.zstd import compress

    blob = _svb_zd_encode(samples)   # u32 count + svb stream
    return compress(blob[4:], level=1)


def _make_vbz_fast5(path, read_id, samples, chunk=1000):
    from h5py import h5d, h5p, h5s, h5t, h5z

    with h5py.File(path, "w") as f:
        grp = f.create_group(f"read_{read_id}")
        raw = grp.create_group("Raw")
        # dataset with the vbz filter set as optional (we bypass the
        # pipeline by writing pre-compressed chunks directly)
        space = h5s.create_simple((samples.shape[0],))
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((chunk,))
        dcpl.set_filter(VBZ, h5z.FLAG_OPTIONAL, (0, 2, 1, 1))
        dset = h5d.create(raw.id, b"Signal", h5t.STD_I16LE, space, dcpl)
        for start in range(0, samples.shape[0], chunk):
            part = samples[start : start + chunk]
            dset.write_direct_chunk((start,), _vbz_compress(part),
                                    filter_mask=0)
        ch = grp.create_group("channel_id")
        ch.attrs["digitisation"] = 8192.0
        ch.attrs["offset"] = 3.0
        ch.attrs["range"] = 1467.6
        ch.attrs["sampling_rate"] = 4000.0


def test_vbz_fast5_roundtrip(tmp_path):
    from f5c_tpu.io.fast5 import read_fast5_signal

    rng = np.random.default_rng(21)
    samples = rng.integers(-500, 3000, 12345).astype(np.int16)
    path = str(tmp_path / "vbz.fast5")
    _make_vbz_fast5(path, "abcd-1234", samples)
    sig = read_fast5_signal(path, read_id="abcd-1234")
    np.testing.assert_array_equal(sig.raw, samples)
    assert sig.sample_rate == 4000.0
