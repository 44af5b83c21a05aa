"""Device (JAX) codec paths, exercised on the CPU backend: TD-profile
encode/decode round trips, differential tests vs the host state machine,
checksum kernels, batched header parsing and LUT construction."""

import gzip as pygzip
import os
import random
import zlib

import numpy as np
import pytest

import tpu_deflate as td
from tpu_deflate.codec.decode_jax import (
    build_luts_batch,
    parse_headers_batch,
    split_members,
)
from tpu_deflate.codec.decode_jax_v2 import gzip_decompress_tpu_v2 as gzip_decompress_tpu
from tpu_deflate.codec.encode_jax import compress_members_tpu, _run_to_symbol, _dist_to_symbol
from tpu_deflate.codec.profile import profile_compress_host
from tpu_deflate.format.tables import (
    DIST_TO_EXTRA_BITS,
    DIST_TO_EXTRA_VAL,
    DIST_TO_SYMBOL,
    LENGTH_TO_EXTRA_BITS,
    LENGTH_TO_EXTRA_VAL,
    LENGTH_TO_SYMBOL,
)
from tpu_deflate.kernels.huffman import build_decode_lut


def _structured(seed, n):
    rng = random.Random(seed)
    words = [bytes(rng.getrandbits(8) for _ in range(rng.randint(2, 9))) for _ in range(40)]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words)
    return bytes(out[:n])


def test_closed_form_symbol_mappers():
    import jax.numpy as jnp

    runs = np.arange(3, 259)
    sym, eb, ev = _run_to_symbol(jnp.asarray(runs))
    assert (np.asarray(sym) == LENGTH_TO_SYMBOL[runs]).all()
    assert (np.asarray(eb) == LENGTH_TO_EXTRA_BITS[runs]).all()
    assert (np.asarray(ev) == LENGTH_TO_EXTRA_VAL[runs]).all()

    dists = np.arange(1, 32769)
    dsym, deb, dev = _dist_to_symbol(jnp.asarray(dists))
    assert (np.asarray(dsym) == DIST_TO_SYMBOL[dists]).all()
    assert (np.asarray(deb) == DIST_TO_EXTRA_BITS[dists]).all()
    assert (np.asarray(dev) == DIST_TO_EXTRA_VAL[dists]).all()


def test_batched_lut_matches_reference_lut():
    rng = random.Random(5)
    from tpu_deflate.kernels.huffman import huffman_lengths_batch

    freqs = np.zeros((4, 288), dtype=np.int64)
    for l in range(4):
        for i in rng.sample(range(288), rng.randint(2, 200)):
            freqs[l, i] = rng.randint(1, 5000)
    lengths = huffman_lengths_batch(freqs, 12)
    luts = build_luts_batch(lengths)
    for l in range(4):
        ref = build_decode_lut(lengths[l])
        got_sym = luts[l] & 511
        got_len = luts[l] >> 9
        # the reference LUT is 15-bit; compare on the 12-bit domain
        for probe in rng.sample(range(4096), 200):
            want_sym = ref.symbol[probe]
            want_len = ref.length[probe]
            if want_len <= 12:
                assert got_sym[probe] == want_sym
                assert got_len[probe] == want_len


@pytest.mark.parametrize("n", [0, 1000, 30000])
def test_profile_host_encode_device_decode(n):
    data = _structured(n, n)
    gz = profile_compress_host(data)
    assert pygzip.decompress(gz) == data
    assert gzip_decompress_tpu(gz) == data


def test_tpu_encode_interop_and_roundtrip():
    data = _structured(7, 80000) + os.urandom(20000) + bytes(30000)
    gz = compress_members_tpu(data)
    # standard tools accept it
    assert pygzip.decompress(gz) == data
    # host reader accepts it
    assert td.gzip_decompress(gz) == data
    # device decoder round-trips it
    assert gzip_decompress_tpu(gz) == data
    # member index present and consistent
    members = split_members(np.frombuffer(gz, np.uint8))
    assert members is not None
    assert sum(m.isize for m in members) == len(data)


def test_device_decode_detects_corruption():
    data = _structured(9, 60000)
    gz = bytearray(compress_members_tpu(data))
    # corrupt one payload byte in the middle of the first member
    members = split_members(np.frombuffer(bytes(gz), np.uint8))
    mid = (members[0].payload_start + members[0].end - 8) // 2
    gz[mid] ^= 0xFF
    with pytest.raises(td.DataFormatError):
        gzip_decompress_tpu(bytes(gz))


def test_device_decode_foreign_stream_fallback():
    data = _structured(11, 20000)
    foreign = pygzip.compress(data)
    assert gzip_decompress_tpu(foreign) == data


def test_header_parse_batch_matches_host():
    """Batched header parse agrees with the serial host decoder's tables."""
    datas = [_structured(s, 30000) for s in range(4)]
    gzs = [profile_compress_host(d) for d in datas]
    for gz, d in zip(gzs, datas):
        members = split_members(np.frombuffer(gz, np.uint8))
        assert members is not None and len(members) == 1
        m = members[0]
        payload = np.frombuffer(gz, np.uint8)[m.payload_start : m.end - 8]
        arr = np.zeros((1, payload.size), np.uint8)
        arr[0] = payload
        hp = parse_headers_batch(arr, np.array([payload.size * 8]))
        assert hp.bfinal.all()
        # decode with the parsed tables through the host LUT machinery
        assert td.inflate(payload.tobytes()) == d


def test_on_device_strategy_routing():
    """EP analog (≙ comp/MultiStrategy.java:31-56): the device argmin must
    route a compressible lane to dynamic, an incompressible lane to
    stored, and a short high-entropy-alphabet lane to fixed codes — read
    back from the emitted streams' block headers — and the whole stream
    must round-trip."""
    import numpy as np

    from tpu_deflate.codec import decode_jax as dj
    from tpu_deflate.codec.encode_jax import compress_members_tpu
    from tpu_deflate.engine import decompress

    rng = np.random.default_rng(9)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(80)]
    text = np.concatenate([words[i] for i in rng.integers(0, 80, 30000)])[: 64 * 1024]
    rand = rng.integers(0, 256, 64 * 1024, dtype=np.uint8)
    # short, near-uniform printable bytes: dynamic's header outweighs its
    # per-symbol gain, fixed's preset code wins
    short = rng.integers(33, 127, 60, dtype=np.uint8)

    data = np.concatenate([text, rand]).tobytes() + short.tobytes()
    gz = compress_members_tpu(data)
    assert decompress(gz, engine="host") == data

    buf = np.frombuffer(gz, dtype=np.uint8)
    members = dj.split_members(buf)
    assert len(members) == 3
    btypes = [(int(buf[m.payload_start]) >> 1) & 3 for m in members]
    assert btypes[0] == 2, "text lane should route dynamic"
    assert btypes[1] == 0, "random lane should route stored"
    assert btypes[2] == 1, "short printable lane should route fixed"


def test_emit_device_matches_host_bitwriter():
    """The XLA emit (scatter-add word packer) must lay down exactly the
    bits a serial host BitWriter writes for the same header slots and
    token stream, and the block must inflate back to the input."""
    import jax.numpy as jnp

    from tpu_deflate.codec import encode_jax as ej
    from tpu_deflate.kernels.bitio import BitWriter

    rng = np.random.RandomState(3)
    words = [rng.randint(97, 123, rng.randint(2, 9)).astype(np.uint8) for _ in range(60)]
    data = np.concatenate([words[i] for i in rng.randint(0, 60, 20000)])[:65536]
    padded = data[None, :]
    lengths = np.full(1, data.size, np.int32)
    a = ej.analyze_device(jnp.asarray(padded), jnp.asarray(lengths), True, 0)
    ll_c, d_c, hv, hb, ev, eb, choice = ej._plan_codes(a, lengths.astype(np.int64), 1)
    assert int(np.asarray(choice)[0]) != ej.ROUTE_STORED
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words_d, tb = ej.emit_device(
        a["litlen_sym"], flags, a["len_eb"], a["len_ev"],
        a["dist_sym"], a["dist_eb"], a["dist_ev"],
        ll_c, d_c, hv, hb, ev, eb,
    )

    h = {k: np.asarray(v)[0] for k, v in a.items() if k not in ("litlen_hist", "dist_hist")}
    llc, dc = np.asarray(ll_c)[0], np.asarray(d_c)[0]
    w = BitWriter()
    for v, b in zip(np.asarray(hv)[0], np.asarray(hb)[0]):
        if b:
            w.write_bits(int(v), int(b))
    for p in np.nonzero(h["is_token"])[0]:
        c = int(llc[h["litlen_sym"][p]])
        w.write_bits(c & 0xFFFF, c >> 16)
        if h["is_match"][p]:
            w.write_bits(int(h["len_ev"][p]), int(h["len_eb"][p]))
            c = int(dc[h["dist_sym"][p]])
            w.write_bits(c & 0xFFFF, c >> 16)
            w.write_bits(int(h["dist_ev"][p]), int(h["dist_eb"][p]))
    w.write_bits(int(np.asarray(ev)[0]), int(np.asarray(eb)[0]))

    nbits = int(np.asarray(tb)[0])
    assert nbits == w.bit_position
    got = np.asarray(words_d)[0].view(np.uint8)[: (nbits + 7) // 8].tobytes()
    assert got == w.getvalue()
    assert zlib.decompress(got, -15) == data.tobytes()
