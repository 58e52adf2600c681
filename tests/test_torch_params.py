"""The port's Params.new against the reference's at k = 3, on the CPU:
uncached, cached (written, then read back) and with the native library's
SRS generation absent, every Params writes the reference's bytes."""
import numpy as np
import pytest

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.poly import Params as RParams

from halo2_tpu_torch.curves import native
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.poly import commitment
from halo2_tpu_torch.poly.commitment import Params

K = 3


@pytest.fixture(scope="module")
def ref_bytes():
    return RParams.new(R_PALLAS, K, use_cache=False).write()


def test_params_new_cached_and_uncached_match_reference(ref_bytes,
                                                        tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(commitment, "_SRS_CACHE", str(tmp_path))
    assert Params.new(PALLAS, K, device="cpu",
                      use_cache=False).write() == ref_bytes
    assert not list(tmp_path.iterdir())
    written = Params.new(PALLAS, K, device="cpu")
    cache = tmp_path / f"pallas_{K}.params"
    assert cache.read_bytes() == ref_bytes
    assert [p.name for p in tmp_path.iterdir()] == [cache.name]
    read = Params.new(PALLAS, K, device="cpu")
    assert written.write() == read.write() == ref_bytes
    assert np.array_equal(read.g_lagrange_dev.numpy(),
                          written.g_lagrange_dev.numpy())


def test_params_new_without_native_srs_matches_native(ref_bytes,
                                                      tmp_path,
                                                      monkeypatch):
    """Without the native library, Python hash_to_curve and the host group
    iNTT give the native library's g and g_lagrange, and a cached file is
    written and read back by Python decompression."""
    want = native.native_srs_g(PALLAS, "Halo2-Parameters", 1 << K)
    monkeypatch.setattr(commitment, "_SRS_CACHE", str(tmp_path))
    monkeypatch.setattr(native, "native_srs_g", lambda *a: False)
    monkeypatch.setattr(native, "native_group_ntt", lambda *a: False)
    monkeypatch.setattr(native, "native_decompress_many", lambda *a: False)
    params = Params.new(PALLAS, K, device="cpu", use_cache=False)
    assert params.g == want
    assert params.write() == ref_bytes
    written = Params.new(PALLAS, K, device="cpu")
    read = Params.new(PALLAS, K, device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [f"pallas_{K}.params"]
    assert read.g == want
    assert written.write() == read.write() == ref_bytes
    data = (tmp_path / f"pallas_{K}.params").read_bytes()
    assert Params.read(PALLAS, data, device="cpu").write() == ref_bytes
