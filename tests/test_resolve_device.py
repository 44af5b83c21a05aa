"""Device LZ77 resolve (resolve_jax) vs the serial reference.

≙ the reference's dictionary copy loop ``decomp/Open.java:589-617``:
overlapping copies, RLE wraparound, copy-before-start detection. The
resolve is plain jax.numpy, so these run it on XLA's CPU backend; the
GPU run is tests/test_gpu_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from tpu_deflate.codec import resolve_jax as rp
from tpu_deflate.kernels import checksum_jax as cj


def _gen_tokens(rng, style: str, n_target: int) -> list[int]:
    toks: list[int] = []
    out = 0
    while out < n_target - 300:
        if style == "text":
            if rng.random() < 0.6 or out < 4:
                toks.append(int(rng.integers(0, 256)))
                out += 1
            else:
                run = int(rng.integers(3, 60))
                dist = int(rng.integers(1, min(out, 5000)))
                toks.append(rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1))
                out += run
        elif style == "records":
            if rng.random() < 0.25 or out < 70:
                toks.append(int(rng.integers(0, 256)))
                out += 1
            else:
                run = int(rng.integers(3, 40))
                toks.append(rp.TOKEN_MATCH_BIT | run << 16 | 63)
                out += run
        else:  # rle: overlapping copies, dist 1..4
            if rng.random() < 0.1 or out < 4:
                toks.append(int(rng.integers(0, 4)))
                out += 1
            else:
                run = int(rng.integers(100, 258))
                dist = int(rng.integers(1, 5))
                toks.append(rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1))
                out += run
    return toks


def test_resolve_matches_reference_all_styles():
    rng = np.random.default_rng(11)
    styles = ["text", "records", "rle"]
    tokarr = np.full((len(styles), rp.N_POS), -1, np.int32)
    refs = []
    for i, sty in enumerate(styles):
        t = _gen_tokens(rng, sty, 30000)
        tokarr[i, : len(t)] = t
        refs.append(rp.resolve_reference(np.array(t, np.int64)))
    y, summ, rounds, unres = rp.resolve_tokens_device(jnp.asarray(tokarr))
    y = np.asarray(y)
    summ = np.asarray(summ)
    assert int(unres) == 0
    for i, ref in enumerate(refs):
        total = int(summ[i, 1])
        assert total == len(ref)
        assert y[i, :total].astype(np.uint8).tobytes() == ref
        assert int(summ[i, 0]) == rp.N_POS  # no error
        assert (y[i, total:] == 0).all()  # zero tail for the CRC path


def test_resolve_copy_before_start_error_position():
    tokarr = np.full((2, rp.N_POS), -1, np.int32)
    tokarr[0, 0] = 65
    tokarr[0, 1] = rp.TOKEN_MATCH_BIT | (5 << 16) | 3  # dist 4 > 1 byte out
    tokarr[1, 0] = 66
    y, summ, rounds, unres = rp.resolve_tokens_device(jnp.asarray(tokarr))
    summ = np.asarray(summ)
    assert int(summ[0, 0]) == 1  # first bad position, stream order
    assert int(summ[1, 0]) == rp.N_POS
    assert int(unres) == 0  # an errored lane must not stall the wave


def test_resolve_tiled_long_member():
    """Members larger than N_POS resolve through chained 64 KiB tiles
    (matches crossing tile boundaries source the previous tile's tail)."""
    rng = np.random.default_rng(7)
    toks: list[int] = []
    out = 0
    target = 3 * rp.N_POS // 2 + 12345  # ~96 KiB -> 2 tiles, ragged tail
    while out < target:
        roll = rng.random()
        if roll < 0.35 or out < 8:
            toks.append(int(rng.integers(0, 256)))
            out += 1
        elif roll < 0.55:  # long-distance match (may cross a tile seam)
            run = int(rng.integers(3, 259))
            dist = int(rng.integers(1, min(out, 32768) + 1))
            toks.append(rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1))
            out += run
        else:  # RLE-ish overlapping copy
            run = int(rng.integers(3, 259))
            dist = int(rng.integers(1, 5))
            toks.append(rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1))
            out += run
    ref = rp.resolve_reference(np.array(toks, np.int64))
    tiles = rp.split_tokens_tiles(np.array(toks, np.int32))
    assert tiles.shape[0] == -(-len(ref) // rp.N_POS)
    y, summs, unres = rp.resolve_tokens_tiled(tiles[None])
    y = np.asarray(y)[0]
    summs = np.asarray(summs)[0]
    assert int(unres) == 0
    got = b"".join(
        y[t, : int(summs[t, 1])].astype(np.uint8).tobytes()
        for t in range(tiles.shape[0])
    )
    assert got == ref
    assert all(int(summs[t, 0]) == rp.N_POS for t in range(tiles.shape[0]))


def test_resolve_oversized_distance_flagged():
    """dist-1 >= 0x8000 (impossible in spec-valid DEFLATE) must fail
    loudly into the error summary, not silently truncate the copy."""
    toks = [int(b) for b in np.random.default_rng(5).integers(0, 256, 40000)]
    toks.append(rp.TOKEN_MATCH_BIT | (5 << 16) | 0x8000)  # dist 32769
    tokarr = np.full((1, rp.N_POS), -1, np.int32)
    tokarr[0, : len(toks)] = toks
    y, summ, rounds, unres = rp.resolve_tokens_device(jnp.asarray(tokarr))
    assert int(np.asarray(summ)[0, 0]) == 40000  # error at the match start
    assert int(unres) == 0


def test_engine_device_resolve_roundtrip(monkeypatch):
    """decompress(engine="tpu") runs the device resolve end-to-end when
    it is forced on: it must live in the product decode path, not only
    in the bench."""
    monkeypatch.setenv("TD_DEVICE_RESOLVE", "1")
    from tpu_deflate.engine import decompress
    from tpu_deflate.codec import decode_jax_v2 as v2
    from tpu_deflate.codec.profile import profile_compress_host
    from tpu_deflate.format.errors import DataFormatError

    rng = np.random.default_rng(3)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = (
        np.concatenate([words[i] for i in rng.integers(0, 50, 40000)]).tobytes()
        + bytes(np.repeat(rng.integers(0, 4, 500, dtype=np.uint8), rng.integers(1, 400, 500)))
        + rng.integers(0, 256, 120000, dtype=np.uint8).tobytes()
    )
    try:
        from tpu_deflate import native

        gz = native.compress_members_native(data)
    except Exception:
        gz = profile_compress_host(data)
    # the fast path must actually engage for this profile stream
    calls = []
    orig = v2._decode_single_block_device

    def spy(payloads, members, verify_crc, fallback):
        calls.append(len(payloads))
        return orig(payloads, members, verify_crc, fallback)

    monkeypatch.setattr(v2, "_decode_single_block_device", spy)
    out = decompress(gz, engine="tpu")
    assert out == data
    assert calls and sum(calls) > 0
    bad = bytearray(gz)
    bad[60] ^= 0x40
    with pytest.raises(DataFormatError):
        decompress(bytes(bad), engine="tpu")


def test_crc8_leftaligned_matches_zlib():
    import zlib

    rng = np.random.default_rng(3)
    L, width = 4, rp.N_POS
    rows = np.zeros((L, width), np.uint8)
    lens = [0, width, 1, 12345]
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    K8, lvl8 = cj.crc_matrices8(width // cj.CHUNK_BYTES)
    raw = np.asarray(cj.crc32_lanes_raw8(jnp.asarray(rows.astype(np.int32)), K8, lvl8))
    crcs = cj.crc32_finish_leftaligned(raw, np.array(lens), width)
    for i, n in enumerate(lens):
        assert int(crcs[i]) == (zlib.crc32(rows[i, :n].tobytes()) & 0xFFFFFFFF)


def _adversarial(case: str):
    """(tokens, history, expected error position or None)."""
    M = rp.TOKEN_MATCH_BIT
    rng = np.random.default_rng(17)
    if case == "dist1_rle":
        return [97] + [M | 258 << 16 | 0] * 250, b"", None
    if case == "period3":
        return [97, 98, 99] + [M | 200 << 16 | 2] * 300, b"", None
    if case == "far_258":
        lits = [int(b) for b in rng.integers(0, 256, 32768)]
        return lits + [M | 258 << 16 | 32767] * 120, b"", None
    if case == "copy_before_start":
        return [1, 2, 3, 4, M | 10 << 16 | 3, M | 9 << 16 | 99], b"", 14
    # tail chaining: every match reaches into the 32 KiB resolved history
    hist = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    toks = []
    for _ in range(400):
        run = int(rng.integers(3, 259))
        toks.append(M | run << 16 | int(rng.integers(0, 32768)))
        toks.append(int(rng.integers(0, 256)))
    return toks, hist, None


@pytest.mark.parametrize(
    "case", ["dist1_rle", "period3", "far_258", "copy_before_start", "tail_chain"]
)
def test_resolve_adversarial_chains(case):
    """Deep copy chains: dist-1 RLE and period-3 runs collapse through
    the capped region-mod sources, 258-byte copies from the far edge of
    the window, a copy before the stream start is flagged at its first
    byte, and a chained tile reads its 32 KiB resolved tail."""
    toks, hist, err = _adversarial(case)
    tokarr = np.full((1, rp.N_POS), -1, np.int32)
    tokarr[0, : len(toks)] = toks
    tail = None
    if hist:
        tail = jnp.asarray(np.frombuffer(hist, np.uint8)[None, :].astype(np.int32))
    y, summ, rounds, unres = rp.resolve_tokens_device(jnp.asarray(tokarr), tail=tail)
    y, summ = np.asarray(y), np.asarray(summ)
    assert int(unres) == 0 and int(rounds) <= rp.MAX_ROUNDS
    if err is not None:
        assert int(summ[0, 0]) == err
        return
    ref = rp.resolve_reference(np.array(toks, np.int64), history=hist)
    total = int(summ[0, 1])
    assert int(summ[0, 0]) == rp.N_POS
    assert total == len(ref)
    assert y[0, :total].astype(np.uint8).tobytes() == ref


@pytest.mark.parametrize("device_resolve", ["on", "off"])
def test_engine_corrupt_member_reason_matches_host(device_resolve):
    """A corrupted payload byte raises the Reason the host engine raises
    (trailer CRC checked before the size, on both resolve paths)."""
    import tpu_deflate as td
    from tpu_deflate.codec import decode_jax as dj
    from tpu_deflate.codec.decode_jax_v2 import gzip_decompress_tpu_v2
    from tpu_deflate.codec.profile import profile_compress_host
    from tpu_deflate.format.errors import DataFormatError

    rng = np.random.default_rng(21)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = np.concatenate([words[i] for i in rng.integers(0, 50, 30000)]).tobytes()[:150000]
    gz = profile_compress_host(data)
    buf = np.frombuffer(gz, np.uint8)
    m = dj.split_members(buf)[1]
    bad = bytearray(gz)
    bad[(m.payload_start + m.end - 8) // 2] ^= 0x55
    reasons = []
    for fn in (td.gzip_decompress, lambda s: gzip_decompress_tpu_v2(s, device_resolve=device_resolve)):
        with pytest.raises(DataFormatError) as ei:
            fn(bytes(bad))
        reasons.append(ei.value.reason)
    assert reasons[0] == reasons[1]
