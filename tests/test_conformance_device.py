"""Reference conformance vectors through the v2 *device* decoder.

The 42 transcribed vectors (tests/vectors.py, from the reference's
InflaterInputStreamTest) previously ran only against the host/C decoders;
this runs them through the gather-free device pipeline
(decode_jax_v2.inflate_raw_v2) — good vectors must produce identical
bytes under all byte-padding modes, bad vectors must raise the exact
reference Reason (taxonomy parity, ``DataFormatException.java:61-83``,
precedence ``decomp/Open.java:516-593``).
"""

import pytest

from tpu_deflate.codec.decode_jax_v2 import inflate_raw_v2
from tpu_deflate.format.errors import DataFormatError

from vectors import BAD_VECTORS, GOOD_VECTORS, bits_to_bytes


@pytest.mark.parametrize("pad", ["0", "1", "random"])
@pytest.mark.parametrize("name,bits,hexout", GOOD_VECTORS, ids=[v[0] for v in GOOD_VECTORS])
def test_good_vector_device(name, bits, hexout, pad):
    data = bits_to_bytes(bits, pad)
    assert inflate_raw_v2(data) == bytes.fromhex(hexout)


@pytest.mark.parametrize("name,bits,reason", BAD_VECTORS, ids=[v[0] for v in BAD_VECTORS])
def test_bad_vector_device(name, bits, reason):
    data = bits_to_bytes(bits, "0")
    with pytest.raises(DataFormatError) as ei:
        inflate_raw_v2(data)
    assert ei.value.reason == reason


def test_batched_error_isolation():
    """One bad lane must not poison its batch: decode all bad vectors and
    all good vectors as one lane batch; each lane lands on its own verdict."""
    from tpu_deflate.codec.decode_jax_v2 import _resolve_lane, decode_deflate_streams_v2

    payloads = [bits_to_bytes(b, "0") for _, b, _ in GOOD_VECTORS]
    payloads += [bits_to_bytes(b, "0") for _, b, _ in BAD_VECTORS]
    states = decode_deflate_streams_v2(payloads)
    for (name, _, hexout), st in zip(GOOD_VECTORS, states):
        assert _resolve_lane(st) == bytes.fromhex(hexout), name
    for (name, _, reason), st in zip(BAD_VECTORS, states[len(GOOD_VECTORS) :]):
        with pytest.raises(DataFormatError) as ei:
            _resolve_lane(st)
        assert ei.value.reason == reason, name


def test_batched_vectors_pallas_interpret(monkeypatch):
    """All 42 vectors through the wave runner with the single-level
    compaction fallback (the path a compaction overflow reruns on): good
    vectors bit-exact, bad vectors carrying the exact Reason — the same
    taxonomy net the two-level compaction passes."""
    from tpu_deflate.codec import decode_jax_v2 as v2

    run = v2._run_wave
    monkeypatch.setattr(v2, "_run_wave", lambda w, full_compact=False: run(w, full_compact=True))
    payloads = [bits_to_bytes(b, "1") for _, b, _ in GOOD_VECTORS]
    payloads += [bits_to_bytes(b, "0") for _, b, _ in BAD_VECTORS]
    states = v2.decode_deflate_streams_v2(payloads)
    for (name, _, hexout), st in zip(GOOD_VECTORS, states):
        assert v2._resolve_lane(st) == bytes.fromhex(hexout), name
    for (name, _, reason), st in zip(BAD_VECTORS, states[len(GOOD_VECTORS) :]):
        with pytest.raises(DataFormatError) as ei:
            v2._resolve_lane(st)
        assert ei.value.reason == reason, name


def test_good_vectors_full_device_resolve():
    """Conformance vectors through the FULL device path: wave decode ->
    device tile-split resolve (resolve_big_streams) — the engine's
    forced-device-resolve route for arbitrary foreign streams."""
    import numpy as np

    from tpu_deflate.codec import resolve_jax as rp
    from tpu_deflate.codec.decode_jax_v2 import decode_deflate_streams_v2

    payloads, expected = [], []
    for name, bits, hexout in GOOD_VECTORS:
        if not hexout:
            continue
        payloads.append(bits_to_bytes(bits))
        expected.append(bytes.fromhex(hexout))
    states = decode_deflate_streams_v2(payloads)
    toks = [np.concatenate(st.tokens).astype(np.int32) for st in states]
    outs, resid = rp.resolve_big_streams(toks)
    for name_exp, o, r, st in zip(expected, outs, resid, states):
        assert r == 0 and not st.err
        assert o.tobytes() == name_exp


def test_big_member_device_resolve_roundtrip():
    """A member larger than one 64 KiB resolve tile decodes through the
    forced device-resolve engine path (tile chaining with 32 KiB tails)."""
    import numpy as np

    from tpu_deflate.codec.decode_jax_v2 import (
        LAST_DECODE_STATS,
        gzip_decompress_tpu_v2,
    )
    from tpu_deflate.codec import resolve_jax as rp

    rng = np.random.default_rng(11)
    words = [
        bytes(rng.integers(97, 122, rng.integers(3, 9)).astype(np.uint8))
        for _ in range(80)
    ]
    n = 3 * rp.N_POS // 2  # > one tile
    data = b" ".join(words[int(i)] for i in rng.integers(0, 80, n // 4))[:n]
    from tpu_deflate import native

    if not native.available():
        pytest.skip("needs the native encoder for a TD-indexed big member")

    gz = native.compress_continuous_native(data)  # one big TD-indexed member
    out = gzip_decompress_tpu_v2(gz, device_resolve="on")
    assert out == data
    assert LAST_DECODE_STATS.get("device_resolved", 0) >= 1
