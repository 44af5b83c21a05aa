#!/usr/bin/env python3
"""Smoke run of the codec's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: every default phase
    python chip_smoke.py --four-cards   # four cards: the mesh path only

Default phases, each timed (first call = compile + run, then warm runs):

1. kernels: the decode stages on a 256-lane wave cut from the corpus,
   resolved and compared with zlib's decode of each member, the jax.numpy
   LZ77 resolve against the native resolver and the Python reference (a
   chained 32 KiB tail included), the CRC paths against zlib — all exact
   — and the encoder's analyze and emit.
2. encode: ``engine.compress(engine="tpu")`` of a 64 MiB seeded corpus at
   effort 2 and of a 16 MiB slice at effort 4, each read back by gzip.
3. decode: ``engine.decompress(engine="tpu")`` of the native-encoded and
   the device-encoded streams (device resolve, no fallbacks), then
   members larger than 64 KiB under ``device_resolve="on"``.
4. errors: a corrupted payload byte and a truncated stream raise the
   Reason the host engine raises.
5. the tests marked ``gpu`` (pytest, in this same process).

``--four-cards`` runs ``decompress(mesh=...)``, ``compress(effort=4,
mesh=...)`` and ``sharded_resolve`` on a 1-D mesh of four cards against
the single-card results, and checks that each wave really shards.

It refuses to run anywhere but a GPU. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

# gpu-marked tests run in this process; keep tests/conftest.py off the CPU.
os.environ["TD_TESTS_ON_GPU"] = "1"
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

SEED_MB = 64
EFFORT4_MB = 16
WAVE_LANES = 256


def log(*args) -> None:
    print(*args, flush=True)


def timed(fn, reps: int = 3):
    """(result, first-call seconds, best warm seconds) with the device
    work finished before each clock stops."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


class Phases:
    def __init__(self):
        self.seconds: dict[str, float] = {}

    def run(self, name: str, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = round(time.perf_counter() - t0, 3)
        log(f"== phase {name} done in {self.seconds[name]} s")
        return out


def _huffman_payloads(gz: bytes, n: int):
    """n Huffman-block member payloads spread evenly over the stream."""
    from tpu_deflate.codec import decode_jax as dj

    buf = np.frombuffer(gz, np.uint8)
    huff = [m for m in dj.split_members(buf) if (int(buf[m.payload_start]) >> 1) & 3]
    pick = [huff[i * len(huff) // n] for i in range(n)]
    return [buf[m.payload_start : m.end - 8].tobytes() for m in pick]


def phase_kernels(data: bytes, times: dict) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_deflate import native
    from tpu_deflate.codec import decode_jax_v2 as v2
    from tpu_deflate.codec import encode_jax as ej
    from tpu_deflate.codec import resolve_jax as rp
    from tpu_deflate.kernels import checksum_jax as cj

    # --- decode stages on a full wave --------------------------------
    payloads = _huffman_payloads(native.compress_members_native(data), WAVE_LANES)
    w = {k: jax.device_put(v) for k, v in v2._prep_wave(payloads, WAVE_LANES).items()}
    L, _, NTp1 = w["grid"].shape
    log(f"wave: {L} lanes, payload bucket {(NTp1 - 1) * 64} B, {(NTp1 - 1) * 512} bit positions/lane")

    (dlt, tok_t), c, t = timed(lambda: v2._stage_a_wave(w))
    times["stage_a"] = (c, t)
    token = tok_t.transpose(0, 2, 1).reshape(L, -1)
    cursor = jax.jit(v2._stages_b_to_e)
    (valid, *_), c, t = timed(lambda: cursor(dlt, token, w["rem"]))
    times["stages_b_to_e"] = (c, t)
    comp = jax.jit(lambda tk, v, m: v2.apply_lit_map_chunked(v2.compact_tokens(tk, v)[0], m))
    _, c, t = timed(lambda: comp(token, valid, w["lit_map8"]))
    times["compaction"] = (c, t)

    wave, c, t = timed(lambda: v2._run_wave(w))
    times["wave"] = (c, t)
    wave = [np.asarray(a) for a in wave]
    counts, has_eob = wave[1], wave[2]
    assert not wave[6] and not wave[4].any(), "wave reported overflow or errors"
    assert has_eob[: len(payloads)].all(), "a lane ended without its EOB"
    log(f"wave: {L} lanes, {int(counts.sum())} tokens")

    # --- LZ77 resolve at 256 x 65,536 positions ------------------------
    N = rp.N_POS
    toks = np.full((L, N), -1, np.int32)
    for lane in range(L):
        k = int(counts[lane])
        toks[lane, :k] = wave[0][lane, :k]
    (y, summ, rounds, unres), c, t = timed(lambda: rp.resolve_tokens_device(jnp.asarray(toks)))
    times["resolve_jnp"] = (c, t)
    y, summ = np.asarray(y), np.asarray(summ)
    assert int(unres) == 0 and (summ[:, 0] == N).all()
    for lane in range(L):
        total = int(summ[lane, 1])
        want = native.resolve_tokens(toks[lane, : int(counts[lane])], N)
        assert y[lane, :total].astype(np.uint8).tobytes() == want, lane
        if lane < 8:
            assert rp.resolve_reference(toks[lane]) == want, lane
        # the wave decodes each member's first block: all of it when final
        whole = zlib.decompress(payloads[lane], -15)
        assert whole[:total] == want and (total == len(whole) or not payloads[lane][0] & 1), lane
    log(
        f"wave + resolve == zlib on {L} lanes, resolve == native on {L}, "
        f"== reference on 8 ({int(rounds)} rounds)"
    )

    # Chained tile: every match reaches into the previous tile's last
    # 32 KiB; checked against the native resolver run over both tiles.
    full = [lane for lane in range(L) if int(summ[lane, 1]) == N][:L]
    rng = np.random.default_rng(29)
    tile2 = np.full((len(full), N), -1, np.int32)
    for j in range(len(full)):
        k = 0
        out = 0
        while out < N - 300:
            if rng.random() < 0.3:
                tile2[j, k] = int(rng.integers(0, 256))
                out += 1
            else:
                run = int(rng.integers(3, 259))
                tile2[j, k] = rp.TOKEN_MATCH_BIT | run << 16 | int(rng.integers(0, 32768))
                out += run
            k += 1
    tail = jnp.asarray(y[full, N - rp.TAIL :])
    (y2, summ2, _r, unres2), c, t = timed(
        lambda: rp.resolve_tokens_device(jnp.asarray(tile2), tail=tail)
    )
    times["resolve_jnp_chained"] = (c, t)
    y2, summ2 = np.asarray(y2), np.asarray(summ2)
    assert int(unres2) == 0 and (summ2[:, 0] == N).all()
    for j, lane in enumerate(full):
        both = np.concatenate([toks[lane, : int(counts[lane])], tile2[j][tile2[j] >= 0]])
        want = native.resolve_tokens(both, 2 * N)[N:]
        assert y2[j, : int(summ2[j, 1])].astype(np.uint8).tobytes() == want, lane
    log(f"chained-tail resolve == native on {len(full)} lanes")

    # --- CRC paths against zlib ----------------------------------------
    K8, lvl8 = cj.crc_matrices8(N // cj.CHUNK_BYTES)
    raw, c, t = timed(lambda: cj.crc32_lanes_raw8(jnp.asarray(y), K8, lvl8))
    times["crc_int8_lanes"] = (c, t)
    crcs = cj.crc32_finish_leftaligned(np.asarray(raw), summ[:, 1], N)
    for lane in range(L):
        total = int(summ[lane, 1])
        assert int(crcs[lane]) == zlib.crc32(y[lane, :total].astype(np.uint8).tobytes())
    rows = np.frombuffer(data[: 64 * 65536], np.uint8).reshape(64, 65536)
    lens = np.full(64, 65536) - np.arange(64)
    got_m = cj.crc32_members(rows, lens)
    for i in range(64):
        assert int(got_m[i]) == zlib.crc32(rows[i, : lens[i]].tobytes())
    assert cj.crc32_device(data[: 1 << 20]) == zlib.crc32(data[: 1 << 20])
    log("CRC (int8 lanes, f32 members, f32 single) == zlib")

    # --- encoder stages that replaced the removed kernels ---------------
    batch = np.frombuffer(data[: ej.ENC_LANE_BATCH * 65536], np.uint8).reshape(-1, 65536)
    bd = jax.device_put(batch)
    bl = jnp.full((batch.shape[0],), 65536, jnp.int32)
    a, c, t = timed(lambda: ej.analyze_device(bd, bl, True, 0))
    times["encode_analyze_xla"] = (c, t)
    ll_c, d_c, hv, hb, ev, eb, _choice = ej._plan_codes(a, np.asarray(bl), batch.shape[0])
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    args = (a["litlen_sym"], flags, a["len_eb"], a["len_ev"], a["dist_sym"],
            a["dist_eb"], a["dist_ev"], ll_c, d_c, hv, hb, ev, eb)
    _, c, t = timed(lambda: ej.emit_device(*args))
    times["encode_emit_xla"] = (c, t)


def phase_encode(data: bytes, out: dict) -> None:
    from tpu_deflate.engine import compress

    for name, chunk, effort in (
        ("effort2", data, 2),
        ("effort4", data[: EFFORT4_MB << 20], 4),
    ):
        t0 = time.perf_counter()
        gz = compress(chunk, engine="tpu", effort=effort)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        gz2 = compress(chunk, engine="tpu", effort=effort)
        warm = time.perf_counter() - t0
        assert gz2 == gz, f"{name}: encode not deterministic"
        assert gzip.decompress(gz) == chunk, f"{name}: gzip read-back mismatch"
        out[name] = gz
        log(
            f"encode {name}: {len(chunk) >> 20} MiB -> {len(gz)} B "
            f"(ratio {len(gz) / len(chunk):.4f}), first {cold:.2f} s, "
            f"warm {warm:.2f} s ({len(chunk) / warm / 1e6:.1f} MB/s), gzip read-back ok"
        )


def _decode(gz: bytes, data: bytes, label: str, **kw) -> dict:
    from tpu_deflate.codec.decode_jax_v2 import LAST_DECODE_STATS
    from tpu_deflate.engine import decompress

    t0 = time.perf_counter()
    out = decompress(gz, engine="tpu", **kw)
    cold = time.perf_counter() - t0
    assert out == data, f"{label}: decode mismatch"
    t0 = time.perf_counter()
    out = decompress(gz, engine="tpu", **kw)
    warm = time.perf_counter() - t0
    assert out == data, f"{label}: decode mismatch (warm)"
    stats = dict(LAST_DECODE_STATS)
    log(
        f"decode {label}: {len(data) >> 20} MiB, first {cold:.2f} s, warm {warm:.2f} s "
        f"({len(data) / warm / 1e6:.1f} MB/s), LAST_DECODE_STATS {stats}"
    )
    assert stats["gzip_reader"] == 0, f"{label}: stream went to GzipReader"
    assert stats["residue_fallback"] == 0, f"{label}: residue fallback"
    assert stats["device_resolved"] > 0, f"{label}: nothing resolved on the device"
    return stats


def phase_decode(data: bytes, encoded: dict) -> None:
    from tpu_deflate import native
    from tpu_deflate.codec.profile import build_member

    _decode(native.compress_members_native(data), data, "native-encoded")
    _decode(encoded["effort2"], data, "device-encoded")

    # Members of 192 KiB, one dynamic block each (the host encoder with a
    # 192 KiB lookahead): tile-chained device resolve.
    size = 192 << 10
    chunks = [data[i * size : (i + 1) * size] for i in range(8)]
    big = b"".join(build_member(_one_block(c), size, zlib.crc32(c)) for c in chunks)
    stats = _decode(big, b"".join(chunks), "192 KiB members (device_resolve=on)", config=_on())
    assert stats["device_resolved"] == len(chunks), stats


def _one_block(chunk: bytes) -> bytes:
    import io

    import tpu_deflate as td
    from tpu_deflate.streams.deflater import Deflater

    sink = io.BytesIO()
    d = Deflater(sink, lookahead=len(chunk), strategy=td.strategy_for_effort(1))
    d.write(chunk)
    d.finish()
    return sink.getvalue()


def _on():
    from tpu_deflate.config import DecoderConfig

    return DecoderConfig(device_resolve="on")


def phase_errors(data: bytes) -> None:
    import tpu_deflate as td
    from tpu_deflate import native
    from tpu_deflate.codec import decode_jax as dj
    from tpu_deflate.engine import decompress
    from tpu_deflate.format.errors import DataFormatError

    gz = native.compress_members_native(data[: 256 << 10])
    buf = np.frombuffer(gz, np.uint8)
    m = next(m for m in dj.split_members(buf) if (int(buf[m.payload_start]) >> 1) & 3)
    bad = bytearray(gz)
    bad[(m.payload_start + m.end - 8) // 2] ^= 0x55
    probes = {"corrupt payload byte": bytes(bad), "truncated stream": gz[: len(gz) // 2]}
    for label, stream in probes.items():
        reasons = []
        for fn in (td.gzip_decompress, lambda s: decompress(s, engine="tpu")):
            try:
                fn(stream)
                reasons.append(None)
            except DataFormatError as e:
                reasons.append(e.reason)
        log(f"error probe {label}: host {reasons[0]}, device {reasons[1]}")
        assert reasons[0] is not None and reasons[0] == reasons[1], (label, reasons)


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(REPO, "tests", "test_gpu_kernels.py")]
    )
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


def four_cards(devices) -> None:
    import jax
    import jax.numpy as jnp

    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import make_corpus
    from tpu_deflate import native
    from tpu_deflate.codec import decode_jax_v2 as v2
    from tpu_deflate.codec import resolve_jax as rp
    from tpu_deflate.dist.mesh import make_codec_mesh
    from tpu_deflate.dist.sharded import sharded_decode, sharded_resolve
    from tpu_deflate.engine import compress, decompress

    assert len(devices) >= 4, f"--four-cards needs 4 GPUs, found {len(devices)}"
    mesh = make_codec_mesh(4)
    data = make_corpus(EFFORT4_MB)
    gz = native.compress_members_native(data)
    phases = Phases()

    def peaks(after: str) -> None:
        """Peak bytes per card so far; the step from one phase to the
        next says which phase put more on one card than on the others."""
        log(f"peak bytes per card after {after}: "
            f"{[d.memory_stats()['peak_bytes_in_use'] for d in devices[:4]]}")

    def sharded_wave():
        payloads = _huffman_payloads(gz, 64)
        outs = sharded_decode(mesh)(v2._prep_wave(payloads, 64))
        for x in outs[:-1]:
            assert len(x.sharding.device_set) == 4, x.sharding
            assert {s.data.shape[0] for s in x.addressable_shards} == {x.shape[0] // 4}
        log("sharded wave: every output split 4 ways over the lane axis")

    phases.run("sharded_wave", sharded_wave)
    peaks("sharded_wave")
    multi = phases.run("decode_mesh", lambda: decompress(gz, mesh=mesh))
    peaks("decode_mesh")
    enc_multi = phases.run(
        "encode_effort4_mesh", lambda: compress(data, engine="tpu", effort=4, mesh=mesh)
    )
    peaks("encode_effort4_mesh")
    toks = np.full((256, rp.N_POS), -1, np.int32)
    rng = np.random.default_rng(3)
    for lane in range(256):
        toks[lane, :4000] = rng.integers(0, 256, 4000)
        toks[lane, 4000:4100] = rp.TOKEN_MATCH_BIT | 200 << 16 | rng.integers(0, 4000, 100)
    toks_sharded = jax.device_put(toks, NamedSharding(mesh, P("data", None)))
    resolve = sharded_resolve(mesh)
    (ys, summs), c, t = timed(lambda: resolve(toks_sharded))
    log(f"sharded_resolve: first {c:.3f} s, warm {t:.4f} s")
    peaks("sharded_resolve")

    single = phases.run("decode_single", lambda: decompress(gz, engine="tpu"))
    assert multi == single == data, "mesh decode differs from single-card decode"
    enc_single = phases.run(
        "encode_effort4_single", lambda: compress(data, engine="tpu", effort=4)
    )
    assert enc_multi == enc_single, "mesh effort-4 encode differs from single-card"
    assert gzip.decompress(enc_multi) == data
    y1, summ1, _r, unres1 = rp.resolve_tokens_device(jnp.asarray(toks))
    np.testing.assert_array_equal(np.asarray(ys), np.asarray(y1))
    np.testing.assert_array_equal(np.asarray(summs), np.asarray(summ1))
    assert int(unres1) == 0
    log(f"four-card phases (s): {phases.seconds}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true", help="run the 4-card mesh path only")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"no GPU: JAX's default platform is {devices[0].platform!r}")
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}, devices {devices}, kind {devices[0].device_kind!r}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    from tpu_deflate import native

    assert native.available(), "the native C core did not build"

    if args.four_cards:
        four_cards(devices)
        count = 4
    else:
        from bench import make_corpus

        phases = Phases()
        data = phases.run("corpus", make_corpus, SEED_MB)
        times: dict = {}
        phases.run("kernels", phase_kernels, data, times)
        log("kernel times, seconds (first call incl. compile, best warm of 3):")
        for name, (first, best) in times.items():
            log(f"  {name:24s} first {first:9.4f}  warm {best:9.5f}")
        encoded: dict = {}
        phases.run("encode", phase_encode, data, encoded)
        phases.run("decode", phase_decode, data, encoded)
        phases.run("errors", phase_errors, data)
        phases.run("gpu_tests", phase_gpu_tests)
        log(f"phase seconds: {phases.seconds}")
        count = len(devices)

    log(smi)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": devices[0].platform, "kind": devices[0].device_kind, "count": count},
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
