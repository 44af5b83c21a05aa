"""Device checksum kernels (SURVEY.md §2.4: CRC-32/Adler-32 built from
scratch as bit-matrix products) — differential against zlib, plus the
batched member-CRC path of the device encoder
(`encode_jax._assemble_members` with TPU_DEFLATE_DEVICE_CRC=1).
"""

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tpu_deflate.kernels.checksum_jax import crc32_device, crc32_members  # noqa: E402


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 1000, 70000])
def test_crc32_device_matches_zlib(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert crc32_device(data) == zlib.crc32(data)


def test_crc32_device_with_init_value():
    data = b"hello, deflate world" * 17
    mid = len(data) // 2
    part = zlib.crc32(data[:mid])
    assert crc32_device(data[mid:], part) == zlib.crc32(data)


def test_crc32_members_ragged():
    rng = np.random.default_rng(7)
    lengths = np.array([1, 64, 100, 1024, 5000, 65536], np.int64)
    S = int(lengths.max())
    members = np.zeros((len(lengths), S), np.uint8)
    for i, ln in enumerate(lengths):
        members[i, :ln] = rng.integers(0, 256, ln, dtype=np.uint8)
    got = crc32_members(members, lengths)
    for i, ln in enumerate(lengths):
        assert int(got[i]) == zlib.crc32(members[i, :ln].tobytes()), i


def test_device_encoder_member_crcs(monkeypatch):
    """The device encoder's assemble stage with batched device CRCs enabled
    must emit byte-identical gzip (CRC fields included) to the host-CRC
    path, and round-trip through an independent decoder."""
    import gzip as sysgzip
    import io

    from tpu_deflate.codec.encode_jax import compress_members_tpu

    rng = np.random.default_rng(11)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = np.concatenate([words[i] for i in rng.integers(0, 50, 40000)]).tobytes()

    monkeypatch.setenv("TPU_DEFLATE_DEVICE_CRC", "1")
    gz_dev = compress_members_tpu(data)
    monkeypatch.setenv("TPU_DEFLATE_DEVICE_CRC", "0")
    gz_host = compress_members_tpu(data)
    assert gz_dev == gz_host
    assert sysgzip.GzipFile(fileobj=io.BytesIO(gz_dev)).read() == data


def test_device_encoder_crc_failure_propagates(monkeypatch):
    """A device CRC that was asked for and fails raises; it is never
    quietly recomputed on the host."""
    from tpu_deflate.codec.encode_jax import compress_members_tpu
    from tpu_deflate.kernels import checksum_jax

    def broken(*_a, **_k):
        raise RuntimeError("device CRC failed")

    monkeypatch.setattr(checksum_jax, "crc32_members", broken)
    monkeypatch.setenv("TPU_DEFLATE_DEVICE_CRC", "1")
    with pytest.raises(RuntimeError, match="device CRC failed"):
        compress_members_tpu(b"abc" * 1000)
