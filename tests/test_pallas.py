"""Decode cursor stages and the whole wave against plain references.

Differential tests: stage B's tile transfer maps, stage C's composed
entries and stage D/E's replay (the ``lax.scan`` walks in
``decode_jax_v2``) against direct NumPy walks of the same semantics, and
the whole wave pipeline against the host inflater on real profile
streams. The same stages compiled for the card are checked by
tests/test_gpu_kernels.py and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_deflate.codec import decode_jax_v2 as v2  # noqa: E402

W = v2.W_TILE
E_WIN = v2.ENTRY_WIN


def _random_delta(rng, L, B):
    """Random position-advance array with sprinkled EOB/ERR sentinels."""
    delta = rng.integers(1, 49, (L, B)).astype(np.uint8)
    eob = rng.random((L, B)) < 0.002
    err = rng.random((L, B)) < 0.001
    delta[eob] = 127
    delta[err] = 255
    return delta


def _ref_transfers(delta, W):
    """NumPy reference: per-tile transfer maps (exit offset/127/255)."""
    L, B = delta.shape
    NT = B // W
    out = np.zeros((L, NT, E_WIN), np.uint8)
    for lane in range(L):
        for t in range(NT):
            base = t * W
            for e in range(E_WIN):
                p = e
                while p < W:
                    d = delta[lane, base + p]
                    if d == 127:
                        out[lane, t, e] = 127
                        break
                    if d == 255:
                        out[lane, t, e] = 255
                        break
                    p += int(d)
                else:
                    out[lane, t, e] = p - W
    return out


def _ref_replay(delta, entries, W):
    """NumPy reference: reached bitmap from per-tile entries."""
    L, B = delta.shape
    NT = B // W
    reached = np.zeros((L, B), bool)
    for lane in range(L):
        for t in range(NT):
            e = int(entries[lane, t])
            if e >= E_WIN:
                continue
            p = e
            while p < W:
                reached[lane, t * W + p] = True
                d = delta[lane, t * W + p]
                if d >= 127:
                    break
                p += int(d)
    return reached


def _ref_entries(transfers, entry0):
    """NumPy reference: serial composition of the transfer maps."""
    L, NT, _ = transfers.shape
    entries = np.zeros((L, NT), np.uint8)
    final = np.zeros(L, np.uint8)
    for lane in range(L):
        e = int(entry0[lane])
        for t in range(NT):
            entries[lane, t] = e
            if e < v2.SENT_EOB:
                e = int(transfers[lane, t, e])
        final[lane] = e
    return entries, final


@pytest.fixture(scope="module")
def small_wave():
    rng = np.random.default_rng(7)
    L, B = 2, W * 16
    delta = _random_delta(rng, L, B)
    token = rng.integers(0, 256, (L, B)).astype(np.int32)
    # matches at ~1/3 of positions
    m = rng.random((L, B)) < 0.33
    runs = rng.integers(3, 259, (L, B))
    dists = rng.integers(0, 1024, (L, B))
    token = np.where(m, v2.TOKEN_MATCH_BIT | (runs << 16) | dists, token).astype(np.int32)
    token[delta == 127] = -(1 + 7)
    token[delta == 255] = -(100 + 13)
    return delta, token


def _tiles(a):
    L, B = a.shape
    return jnp.asarray(a).reshape(L, B // W, W)


def test_stage_b_pallas_matches_reference(small_wave):
    delta, _token = small_wave
    got = np.asarray(v2.stage_b_transfers(_tiles(delta)))
    np.testing.assert_array_equal(got, _ref_transfers(delta, W))


def test_stage_c_entries_match_serial_chain(small_wave):
    delta, _token = small_wave
    transfers = _ref_transfers(delta, W)
    entry0 = np.array([0, 5], np.uint8)
    entries, final = v2.stage_c_entries(jnp.asarray(transfers), jnp.asarray(entry0))
    want_entries, want_final = _ref_entries(transfers, entry0)
    np.testing.assert_array_equal(np.asarray(entries), want_entries)
    np.testing.assert_array_equal(np.asarray(final), want_final)


def test_stage_dc_pallas_matches_reference(small_wave):
    """Stage D's replay from given entries, and stage E's terminal facts
    as masked sums over the reached positions."""
    delta, token = small_wave
    L, B = delta.shape
    NT = B // W
    rng = np.random.default_rng(11)
    entries = rng.integers(0, E_WIN, (L, NT)).astype(np.uint8)
    entries[:, 1::5] = 127  # some dead tiles
    reached = np.asarray(v2.stage_d_reached(_tiles(delta), jnp.asarray(entries))).reshape(L, B)
    want = _ref_replay(delta, entries, W)
    np.testing.assert_array_equal(reached, want)

    has_eob, eob_exit, err_code, out_total = (
        np.asarray(x)
        for x in v2.stage_e_summary(jnp.asarray(delta), jnp.asarray(token), jnp.asarray(want))
    )
    pos = np.arange(B)
    for lane in range(L):
        eob = want[lane] & (delta[lane] == 127)
        err = want[lane] & (delta[lane] == 255)
        valid = want[lane] & (delta[lane] < 127)
        tok = token[lane]
        assert bool(has_eob[lane]) == bool(eob.any())
        assert eob_exit[lane] == int((pos[eob] - tok[eob] - 1).sum())
        assert err_code[lane] == int((-tok[err] - 100).sum())
        sizes = np.where(tok[valid] < 256, 1, (tok[valid] >> 16) & 0x3FF)
        assert out_total[lane] == int(sizes.sum())


def _profile_payloads(seed: int, n: int, garbage: bool):
    from tpu_deflate.codec import decode_jax as dj
    from tpu_deflate.codec.profile import profile_compress_host

    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8) for _ in range(50)]
    data = np.concatenate([words[i] for i in rng.integers(0, 50, 40000)]).tobytes()[:n]
    buf = np.frombuffer(profile_compress_host(data), dtype=np.uint8)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in dj.split_members(buf)]
    if garbage:
        # random bytes behind a valid header: invalid codes and every
        # error-classification branch at most positions
        payloads.append(payloads[0][:64] + rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())
    return payloads


def _check_wave(payloads):
    """Every lane of one wave against the host inflater: clean lanes
    resolve to its bytes with the exact size, failing lanes carry the
    Reason it raises. A copy from before the stream start is found at
    resolve, after the wave, so there the wave reports the first decode
    error of the lane instead."""
    from tpu_deflate.codec import resolve_jax as rp
    from tpu_deflate.codec.inflate_host import inflate
    from tpu_deflate.format.errors import DataFormatError, Reason, reason_to_code

    w = v2._prep_wave(payloads, 4)
    tokens, counts, has_eob, _exit, err_code, out_total, overflow = (
        np.asarray(x) for x in v2._run_wave(w)
    )
    assert not overflow
    errors = 0
    for lane, p in enumerate(payloads):
        try:
            want = inflate(p)
        except DataFormatError as e:
            if e.reason == Reason.COPY_FROM_BEFORE_DICTIONARY_START:
                assert err_code[lane] != 0, lane
            else:
                assert err_code[lane] == reason_to_code(e.reason), lane
            errors += 1
            continue
        assert err_code[lane] == 0 and has_eob[lane], lane
        assert out_total[lane] == len(want), lane
        assert rp.resolve_reference(tokens[lane, : int(counts[lane])]) == want, lane
    return errors


def test_pallas_wave_matches_xla_wave():
    """Full wave on real profile streams."""
    assert _check_wave(_profile_payloads(3, 150000, False)) == 0


def test_pallas_wave_matches_xla_wave_garbage_lane():
    """The same with a garbage lane: invalid codes and every stage-A
    error class reach the cursor walks."""
    assert _check_wave(_profile_payloads(13, 100000, True)) == 1


def test_parse_pallas_matches_serial():
    """The analyze kernel's pointer-doubling parse against a direct
    serial walk of next[i] = i + step[i] over the same match steps."""
    from tpu_deflate.codec import encode_jax as ej

    rng = np.random.default_rng(5)
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(60)]
    data = np.concatenate([words[i] for i in rng.integers(0, 60, 30000)])[: 2 * 65536]
    padded = jnp.asarray(np.frombuffer(data.tobytes(), np.uint8).reshape(2, 65536))
    lengths = jnp.asarray(np.array([65536, 50000], np.int32))

    a = ej.analyze_device(padded, lengths, True)
    _use, _dist, step, valid = ej._match_find(padded, lengths, True)
    step, valid = np.asarray(step), np.asarray(valid)
    want = np.zeros(step.shape, bool)
    for lane in range(step.shape[0]):
        p = 0
        while p < step.shape[1]:
            want[lane, p] = True
            p += int(step[lane, p])
    np.testing.assert_array_equal(np.asarray(a["is_token"]), want & valid)
    assert int(step.max()) <= ej.PARSE_MAX_STEP
