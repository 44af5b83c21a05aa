"""Device stages compiled for the GPU, against their references (exact).

Every test here is marked ``gpu``: it skips on any other platform and
``python chip_smoke.py`` runs them on the card. Their CPU counterparts
are in test_pallas.py, test_resolve_device.py and test_checksum_device.py.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_pallas import (  # noqa: E402
    W,
    _check_wave,
    _profile_payloads,
    _random_delta,
    _ref_replay,
    _ref_transfers,
    _tiles,
)
from tpu_deflate.codec import decode_jax_v2 as v2  # noqa: E402
from tpu_deflate.codec import resolve_jax as rp  # noqa: E402
from tpu_deflate.kernels import checksum_jax as cj  # noqa: E402

pytestmark = pytest.mark.gpu


def test_stage_b_compiled_matches_reference():
    delta = _random_delta(np.random.default_rng(7), 3, W * 64)
    got = np.asarray(v2.stage_b_transfers(_tiles(delta)))
    np.testing.assert_array_equal(got, _ref_transfers(delta, W))


def test_stage_d_compiled_matches_reference():
    rng = np.random.default_rng(11)
    L, B = 2, W * 64
    delta = _random_delta(rng, L, B)
    entries = rng.integers(0, v2.ENTRY_WIN, (L, B // W)).astype(np.uint8)
    entries[:, 1::5] = 127
    got = np.asarray(v2.stage_d_reached(_tiles(delta), jnp.asarray(entries))).reshape(L, B)
    np.testing.assert_array_equal(got, _ref_replay(delta, entries, W))


@pytest.mark.parametrize("garbage", [False, True])
def test_wave_on_gpu_matches_host_inflate(garbage):
    payloads = _profile_payloads(13 if garbage else 3, 150000, garbage)
    assert _check_wave(payloads) == int(garbage)


def test_resolve_on_gpu_matches_reference():
    from test_resolve_device import _gen_tokens

    rng = np.random.default_rng(11)
    styles = ["text", "records", "rle"]
    tokarr = np.full((len(styles), rp.N_POS), -1, np.int32)
    refs = []
    for i, sty in enumerate(styles):
        t = _gen_tokens(rng, sty, 60000)
        tokarr[i, : len(t)] = t
        refs.append(rp.resolve_reference(np.array(t, np.int64)))
    y, summ, _rounds, unres = rp.resolve_tokens_device(jnp.asarray(tokarr))
    y, summ = np.asarray(y), np.asarray(summ)
    assert int(unres) == 0
    for i, ref in enumerate(refs):
        assert int(summ[i, 1]) == len(ref)
        assert y[i, : len(ref)].astype(np.uint8).tobytes() == ref


@pytest.mark.parametrize("n", [0, 1, 4095, 65536, 300001])
def test_crc_paths_on_gpu_match_zlib(n):
    """f32 (HIGHEST precision) and int8 bit-matrix CRCs, exact."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = zlib.crc32(data.tobytes())
    assert cj.crc32_device(data.tobytes()) == want
    if n:
        assert int(cj.crc32_members(data[None, :], np.array([n]))[0]) == want
    # crc32_lanes_raw8 takes a power-of-two chunk count (zero tails are
    # stripped when the register is finished)
    width = (1 << max(-(-n // cj.CHUNK_BYTES) - 1, 0).bit_length()) * cj.CHUNK_BYTES
    row = np.zeros((1, width), np.uint8)
    row[0, :n] = data
    K8, lvl8 = cj.crc_matrices8(width // cj.CHUNK_BYTES)
    raw = np.asarray(cj.crc32_lanes_raw8(jnp.asarray(row.astype(np.int32)), K8, lvl8))
    assert int(cj.crc32_finish_leftaligned(raw, np.array([n]), width)[0]) == want


def test_apply_lit_map_int8_dot_exact_on_gpu():
    rng = np.random.default_rng(5)
    L, K = 4, 4096
    lit_map = rng.integers(0, 256, (L, 256), dtype=np.uint8)
    grid = lit_map.reshape(L, 4, 64).transpose(0, 2, 1)
    lit_map8 = np.concatenate([(grid & 127).astype(np.int8), (grid >> 7).astype(np.int8)], axis=2)
    tok = rng.integers(0, 256, (L, K)).astype(np.int32)
    tok[rng.random((L, K)) < 0.3] = v2.TOKEN_MATCH_BIT | (7 << 16) | 5
    got = np.asarray(v2.apply_lit_map_chunked(jnp.asarray(tok), jnp.asarray(lit_map8)))
    want = np.where(tok < 256, np.take_along_axis(lit_map.astype(np.int32), np.clip(tok, 0, 255), 1), tok)
    np.testing.assert_array_equal(got, want)


def test_engine_decode_resolves_on_gpu():
    from tpu_deflate.codec.decode_jax_v2 import LAST_DECODE_STATS
    from tpu_deflate.codec.profile import profile_compress_host
    from tpu_deflate.engine import decompress

    data = np.random.default_rng(1).integers(97, 100, 300000, dtype=np.uint8).tobytes()
    assert decompress(profile_compress_host(data), engine="tpu") == data
    assert LAST_DECODE_STATS["device_resolved"] > 0
    assert LAST_DECODE_STATS["residue_fallback"] == 0
