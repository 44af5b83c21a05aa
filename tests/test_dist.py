"""Distributed components on the virtual 8-device CPU mesh: halo exchange,
psum stats, ordered ragged gather, sharded codec steps, and the
single-chip-vs-sharded bit-exactness property (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_deflate.dist.mesh import lane_sharding, make_codec_mesh, pad_lanes
from tpu_deflate.dist.sharded import (
    halo_exchange,
    ordered_ragged_gather,
    psum_stats,
)
from tpu_deflate.format.tables import WINDOW_SIZE


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_codec_mesh(8)


def test_halo_exchange_ring(mesh):
    rng = np.random.default_rng(0)
    shards = rng.integers(0, 256, (8, WINDOW_SIZE + 100), dtype=np.uint8)
    out = np.asarray(halo_exchange(jnp.asarray(shards), mesh))
    assert out.shape == (8, 2 * WINDOW_SIZE + 100)
    # shard 0's halo is zeros; shard d's halo is shard d-1's tail.
    assert (out[0, :WINDOW_SIZE] == 0).all()
    for d in range(1, 8):
        np.testing.assert_array_equal(out[d, :WINDOW_SIZE], shards[d - 1, -WINDOW_SIZE:])
        np.testing.assert_array_equal(out[d, WINDOW_SIZE:], shards[d])


def test_psum_stats(mesh):
    vals = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    out = np.asarray(psum_stats(jnp.asarray(vals), mesh))
    np.testing.assert_array_equal(out.reshape(4), vals.sum(axis=0))


def test_ordered_ragged_gather(mesh):
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (8, 64), dtype=np.uint8)
    lengths = rng.integers(1, 64, 8).astype(np.int32)
    gp, gl = ordered_ragged_gather(jnp.asarray(payload), jnp.asarray(lengths), mesh)
    np.testing.assert_array_equal(gl, lengths)
    # order-deterministic concat equals lane-order concat
    got = b"".join(gp[i, : gl[i]].tobytes() for i in range(8))
    want = b"".join(payload[i, : lengths[i]].tobytes() for i in range(8))
    assert got == want


def test_sharded_encode_matches_single_chip(mesh):
    """Distributed correctness = bit-exact equality of sharded output vs
    the unsharded batched kernel (SURVEY.md §4 multi-node strategy)."""
    from tpu_deflate.codec import encode_jax as ej
    from tpu_deflate.dist.sharded import sharded_analyze_emit
    from tpu_deflate.kernels.huffman import huffman_lengths_batch

    rng = np.random.default_rng(2)
    L, S = 8, 4096
    data = np.repeat(rng.integers(0, 16, (L, S // 4), dtype=np.uint8), 4, axis=1)
    lengths = np.full(L, S, dtype=np.int32)

    hist = np.ones((L, 288), dtype=np.int64)
    ll_lengths = huffman_lengths_batch(hist, 12)
    d_hist = np.zeros((L, 30), dtype=np.int64)
    d_hist[:, :8] = 1
    d_lengths = huffman_lengths_batch(d_hist, 12)
    ll_codes = ej._pack_codes(ll_lengths, 12)
    d_codes = ej._pack_codes(d_lengths, 12)
    header_vals, header_bits = ej._build_headers(ll_lengths, d_lengths)
    eob_val = (ll_codes[:, 256] & 0xFFFF).astype(np.uint32)
    eob_bits = (ll_codes[:, 256] >> 16).astype(np.int32)

    args = (
        jnp.asarray(data),
        jnp.asarray(lengths),
        jnp.asarray(ll_codes),
        jnp.asarray(d_codes),
        jnp.asarray(header_vals),
        jnp.asarray(header_bits),
        jnp.asarray(eob_val),
        jnp.asarray(eob_bits),
    )
    step = sharded_analyze_emit(mesh)
    words_sharded, bits_sharded = step(*args)

    a = ej.analyze_device(args[0], args[1], True)
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words_single, bits_single = ej.emit_device(
        a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"],
        a["dist_eb"], a["dist_ev"], *args[2:],
    )
    np.testing.assert_array_equal(np.asarray(bits_sharded), np.asarray(bits_single))
    np.testing.assert_array_equal(np.asarray(words_sharded), np.asarray(words_single))


def test_graft_entry_single_and_multi():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    delta, token = out
    from tpu_deflate.codec.decode_jax_v2 import SENT_EOB

    # bit 3 of each lane starts the EOB code of the fixed block
    assert (np.asarray(delta)[:, 3] == SENT_EOB).all()
    mod.dryrun_multichip(8)


def test_pod_mesh_and_halo_on_2d():
    """2-D (host, data) mesh: the multi-host topology helper."""
    from tpu_deflate.dist.mesh import make_pod_mesh

    mesh = make_pod_mesh(2, 4)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("host", "data")
    vals = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    out = np.asarray(psum_stats(jnp.asarray(vals), make_codec_mesh(4)))
    np.testing.assert_array_equal(out.reshape(6), vals.sum(axis=0))


def test_sharded_decode_bit_exact(mesh):
    """Mesh-sharded v2 decode == single-device decode == original bytes,
    including a corrupt-lane case (error isolation must survive sharding)."""
    import random

    from tpu_deflate.codec.decode_jax_v2 import gzip_decompress_tpu_v2
    from tpu_deflate.codec.profile import profile_compress_host
    from tpu_deflate.engine import decompress
    from tpu_deflate import native, DataFormatError

    rng = random.Random(0)
    words = [bytes(rng.getrandbits(8) for _ in range(rng.randint(2, 9))) for _ in range(50)]
    data = bytearray()
    while len(data) < 400_000:
        data += rng.choice(words)
    data = bytes(data[:400_000])
    gz = native.compress_members_native(data) if native.available() else profile_compress_host(data)

    single = gzip_decompress_tpu_v2(gz)
    sharded = decompress(gz, mesh=mesh)
    assert single == sharded == data

    bad = bytearray(gz)
    bad[len(bad) // 3] ^= 0x11
    with pytest.raises(DataFormatError):
        decompress(bytes(bad), mesh=mesh)


def test_init_distributed_gated():
    """Without a coordinator address (arg or env) the multi-host bring-up
    is a no-op returning False — single-host runs never hang on it."""
    import os

    from tpu_deflate.dist.mesh import init_distributed

    for var in ("TD_COORDINATOR", "JAX_COORDINATOR_ADDRESS"):
        assert os.environ.get(var) is None
    assert init_distributed() is False


def test_preset_dict_broadcast_and_halo(mesh):
    """zlib FDICT seam: the replicated preset dictionary primes shard 0's
    halo window; other shards get their ring predecessor's tail."""
    from tpu_deflate.dist.sharded import broadcast_preset_dict, halo_exchange

    rng = np.random.default_rng(7)
    d = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    pd = broadcast_preset_dict(d, mesh)
    shards = rng.integers(0, 256, (8, WINDOW_SIZE + 64), dtype=np.uint8)
    out = np.asarray(halo_exchange(jnp.asarray(shards), mesh, preset_dict=pd))
    assert (out[0, : WINDOW_SIZE - 1000] == 0).all()
    np.testing.assert_array_equal(
        out[0, WINDOW_SIZE - 1000 : WINDOW_SIZE], np.frombuffer(d, np.uint8)
    )
    for i in range(1, 8):
        np.testing.assert_array_equal(out[i, :WINDOW_SIZE], shards[i - 1, -WINDOW_SIZE:])


def test_pod_2d_encode_matches_single_chip():
    """Lanes sharded over the (host, data) product of a 2-D pod mesh emit
    bit-identical streams to the unsharded kernel (multi-host DP seam)."""
    from tpu_deflate.codec import encode_jax as ej
    from tpu_deflate.dist.mesh import make_pod_mesh
    from tpu_deflate.dist.sharded import sharded_analyze_emit
    from tpu_deflate.kernels.huffman import huffman_lengths_batch

    mesh2 = make_pod_mesh(2, 4)
    rng = np.random.default_rng(3)
    L, S = 8, 4096
    data = np.repeat(rng.integers(0, 16, (L, S // 4), dtype=np.uint8), 4, axis=1)
    lengths = np.full(L, S, dtype=np.int32)
    hist = np.ones((L, 288), dtype=np.int64)
    ll_lengths = huffman_lengths_batch(hist, 12)
    d_hist = np.zeros((L, 30), dtype=np.int64)
    d_hist[:, :8] = 1
    d_lengths = huffman_lengths_batch(d_hist, 12)
    ll_codes = ej._pack_codes(ll_lengths, 12)
    d_codes = ej._pack_codes(d_lengths, 12)
    header_vals, header_bits = ej._build_headers(ll_lengths, d_lengths)
    eob_val = (ll_codes[:, 256] & 0xFFFF).astype(np.uint32)
    eob_bits = (ll_codes[:, 256] >> 16).astype(np.int32)
    args = (
        jnp.asarray(data), jnp.asarray(lengths), jnp.asarray(ll_codes),
        jnp.asarray(d_codes), jnp.asarray(header_vals), jnp.asarray(header_bits),
        jnp.asarray(eob_val), jnp.asarray(eob_bits),
    )
    words_2d, bits_2d = sharded_analyze_emit(mesh2, ("host", "data"))(*args)
    a = ej.analyze_device(args[0], args[1], True)
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words_1, bits_1 = ej.emit_device(
        a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"],
        a["dist_eb"], a["dist_ev"], *args[2:],
    )
    np.testing.assert_array_equal(np.asarray(bits_2d), np.asarray(bits_1))
    np.testing.assert_array_equal(np.asarray(words_2d), np.asarray(words_1))


def test_sharded_continuous_compress():
    """SP/CP seam: halo-exchanged shards encode in parallel into ONE
    continuous-history member whose ratio matches the serial continuous
    encoder within 0.1pp (bit-splice of alignment-independent Huffman
    bodies), and whose stream round-trips through independent decoders."""
    native = pytest.importorskip("tpu_deflate.native")
    if not native.available():
        pytest.skip("native core unavailable")
    import gzip as sysgzip
    import io

    from tpu_deflate.dist.mesh import make_codec_mesh
    from tpu_deflate.dist.sharded import sharded_continuous_compress

    rng = np.random.default_rng(21)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(150)]
    data = np.concatenate(
        [words[i] for i in rng.integers(0, 150, 200000)]
    )[: 1 << 20].tobytes()

    mesh = make_codec_mesh(8)
    gz = sharded_continuous_compress(data, mesh, block_data=32 * 1024, max_chain=128)
    assert sysgzip.GzipFile(fileobj=io.BytesIO(gz)).read() == data
    from tpu_deflate.engine import decompress

    assert decompress(gz, engine="native") == data
    serial = native.compress_continuous_native(
        data, block_data=32 * 1024, max_chain=128
    )
    assert sysgzip.GzipFile(fileobj=io.BytesIO(serial)).read() == data
    ratio_sharded = len(gz) / len(data)
    ratio_serial = len(serial) / len(data)
    assert ratio_sharded <= ratio_serial + 0.001, (ratio_sharded, ratio_serial)


def test_sharded_continuous_tiny_and_ragged():
    """Degenerate shapes: input smaller than one shard, and a ragged tail
    lane — empty lanes must contribute nothing."""
    native = pytest.importorskip("tpu_deflate.native")
    if not native.available():
        pytest.skip("native core unavailable")
    import gzip as sysgzip
    import io

    from tpu_deflate.dist.mesh import make_codec_mesh
    from tpu_deflate.dist.sharded import sharded_continuous_compress

    mesh = make_codec_mesh(8)
    for n in [1, 100, 70000, 300001]:
        data = (b"abcdefgh" * ((n + 7) // 8))[:n]
        gz = sharded_continuous_compress(data, mesh, block_data=16 * 1024)
        assert sysgzip.GzipFile(fileobj=io.BytesIO(gz)).read() == data, n


def test_sharded_resolve_bit_exact(mesh):
    """The resolve stage (device LZ77 resolve) sharded over the mesh must
    be bit-exact with the single-device resolve."""
    from tpu_deflate.codec import resolve_jax as rp
    from tpu_deflate.dist.sharded import sharded_resolve

    rng = np.random.default_rng(9)
    L = 8
    tokarr = np.full((L, rp.N_POS), -1, np.int32)
    for i in range(L):
        out, k = 0, 0
        while out < 3000:
            if rng.random() < 0.5 or out < 4:
                tokarr[i, k] = int(rng.integers(0, 256))
                out += 1
            else:
                run = int(rng.integers(3, 259))
                dist = int(rng.integers(1, min(out, 2000) + 1))
                tokarr[i, k] = rp.TOKEN_MATCH_BIT | run << 16 | (dist - 1)
                out += run
            k += 1
    ys, summs = sharded_resolve(mesh)(jnp.asarray(tokarr))
    y1, summ1, _r, unres1 = rp.resolve_tokens_device(jnp.asarray(tokarr))
    np.testing.assert_array_equal(np.asarray(ys), np.asarray(y1))
    np.testing.assert_array_equal(np.asarray(summs), np.asarray(summ1))
    assert int(unres1) == 0
