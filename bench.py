"""Headline benchmark: gzip decode throughput, reported PER ENGINE.

    python bench.py     # on a GPU host; the device rows refuse other platforms

Prints ONE JSON line: {"metric", "value", "unit", "engines"}.

The headline value is the best end-to-end decode throughput across
engines, and the metric label names the engine that produced it. The
"engines" sub-object holds every engine's own numbers so no engine hides
behind another:

- "native": C host runtime, member-parallel over host cores.
- "tpu": the JAX device pipeline (decode_jax_v2), end to end; the
  "tpu_kernel" rows time the device kernels alone (inputs staged,
  outputs left on device, forced materialization via an on-device
  reduction). Every device row names the platform, device kind, device
  count and the card's power limit.
- "host": pure Python/NumPy reference engine, measured on a slice.

Sections run in descending importance under per-section deadlines,
results accumulate into a global dict, and the final JSON is emitted
exactly once — from normal completion, from SIGTERM/SIGALRM, or from
atexit. A section that fails, or a run ended by a signal, makes the exit
code non-zero. An internal alarm (BENCH_BUDGET_S, default 1050 s)
finalizes before typical external budgets.

Corpus: a deterministic silesia-like 48 MiB mix (text-ish with word
repeats, binary records, runs, random) — silesia itself is not fetched.
What is measured is otherwise unchanged until the benchmark is rebuilt
(ROADMAP S1).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import numpy as np

CORPUS_MB = 48
HOST_SLICE_MB = 1  # pure-Python engine is measured on a slice
DEVICE_SLICE_MB = 16  # device end-to-end decode slice
DEVICE_ENC_SLICE_MB = 4  # device-encoder throughput sample
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1050"))
_T0 = time.monotonic()

# Global result state: sections fill this in as they complete, and the
# finalizer prints whatever exists when the run ends (however it ends).
ENGINES: dict[str, dict] = {}
NOTES: list[str] = []
FAILED: list[str] = []
_final_done = False


def _remaining() -> float:
    return BUDGET_S - (time.monotonic() - _T0)


def finalize(*_args) -> None:
    """Print the one JSON line from whatever has completed. Idempotent."""
    global _final_done
    if _final_done:
        return
    _final_done = True
    cands = [e for e in ENGINES if ENGINES[e].get("decode_gbps") and e != "tpu_kernel"]
    if cands:
        best_name = max(cands, key=lambda e: ENGINES[e]["decode_gbps"])
        gbps = ENGINES[best_name]["decode_gbps"]
    else:
        best_name, gbps = "none", 0.0
    out = {
        "metric": f"synthetic-silesia gzip decode throughput ({best_name} engine)",
        "value": gbps,
        "unit": "GB/s",
        "engines": ENGINES,
    }
    if NOTES:
        out["notes"] = NOTES
    print(json.dumps(out), flush=True)


def _on_signal(signum, _frame):
    NOTES.append(f"finalized by signal {signum} at t={time.monotonic()-_T0:.0f}s")
    finalize()
    os._exit(128 + signum)


def _device_row() -> dict:
    """Platform, device kind, count and power limit of the measured
    device; any platform but a GPU is refused."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"device rows need a GPU, found {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
        "power_limit": smi.split(",")[-1].strip(),
    }


def make_corpus(total_mb: int = CORPUS_MB) -> bytes:
    rng = np.random.default_rng(20260817)
    parts = []
    # text-like: words sampled with Zipf-ish reuse
    words = [rng.integers(97, 123, rng.integers(2, 10), dtype=np.uint8) for _ in range(200)]
    for _ in range(total_mb // 4):
        idx = rng.zipf(1.3, 1 << 17) % len(words)
        parts.append(np.concatenate([words[i] for i in idx])[: 1 << 20])
    # binary records with repeated structure
    rec = rng.integers(0, 256, 64, dtype=np.uint8)
    for _ in range(total_mb // 4):
        block = np.tile(rec, (1 << 20) // 64)
        noise = rng.integers(0, 256, block.size, dtype=np.uint8)
        mask = rng.random(block.size) < 0.1
        block = np.where(mask, noise, block).astype(np.uint8)
        parts.append(block)
    # runs
    for _ in range(total_mb // 8):
        vals = rng.integers(0, 4, 1 << 12, dtype=np.uint8)
        reps = rng.integers(1, 512, 1 << 12)
        parts.append(np.repeat(vals, reps)[: 1 << 20])
    # random (incompressible)
    for _ in range(total_mb // 8):
        parts.append(rng.integers(0, 256, 1 << 20, dtype=np.uint8))
    blob = np.concatenate(parts)
    target = total_mb << 20
    if blob.size < target:
        blob = np.concatenate([blob, rng.integers(0, 256, target - blob.size, dtype=np.uint8)])
    return blob[:target].tobytes()


def _time_best(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.monotonic()
        out = fn()
        best = min(best, time.monotonic() - t0)
    return out, best


def bench_engine(name: str, data: bytes, *, reps=3) -> dict:
    """End-to-end encode + decode numbers for one engine."""
    from tpu_deflate.engine import compress, decompress

    n = len(data)
    res: dict = {"corpus_mb": round(n / 2**20, 1)}
    t0 = time.monotonic()
    gz = compress(data, engine=name)
    res["encode_cold_mbps"] = round(n / (time.monotonic() - t0) / 1e6, 1)
    t0 = time.monotonic()
    gz = compress(data, engine=name)
    res["encode_warm_mbps"] = round(n / (time.monotonic() - t0) / 1e6, 1)
    res["ratio"] = round(len(gz) / n, 4)

    out = decompress(gz, engine=name)  # warm-up + verify
    assert out == data, f"{name}: decode mismatch"
    out, best = _time_best(lambda: decompress(gz, engine=name), reps)
    assert out == data
    res["decode_gbps"] = round(n / best / 1e9, 4)
    return res


def section_native(data: bytes) -> None:
    from tpu_deflate.engine import _resolve

    if _resolve("auto") == "native":
        ENGINES["native"] = bench_engine("native", data)
        print(f"native: {ENGINES['native']}", file=sys.stderr)


def section_tpu_kernel(data: bytes) -> None:
    """Device-kernel-only decode throughput (host transfers excluded)."""
    from tpu_deflate.codec import decode_jax_v2 as v2

    ENGINES["tpu_kernel"] = {"status": "running"}
    dev = _device_row()
    k = v2.kernel_only_bench(data)
    if k:
        ENGINES["tpu_kernel"] = {**dev, **k}
        print(f"tpu kernel-only: {k}", file=sys.stderr)


def section_tpu_kernel_full(data: bytes) -> None:
    """Full-member device decode: bits -> bytes -> CRC on chip."""
    from tpu_deflate.codec import decode_jax_v2 as v2

    ENGINES["tpu_kernel_full"] = {"status": "running"}
    dev = _device_row()
    k = v2.kernel_only_bench_full(data)
    if k:
        ENGINES["tpu_kernel_full"] = {**dev, **k}
        print(f"tpu kernel-full: {k}", file=sys.stderr)
    # Members larger than one 64 KiB resolve tile: device tile split +
    # chained resolve (capability row; few lanes, so fixed dispatch
    # overhead dominates the figure).
    kb = v2.kernel_only_bench_big(data, member_kb=192, n_members=16)
    ENGINES["tpu_kernel_full"]["big_members"] = kb
    print(f"tpu kernel-big: {kb}", file=sys.stderr)


def section_tpu_e2e(data: bytes) -> None:
    from tpu_deflate.engine import compress, decompress

    # Merge into the shared tpu row (the encode section may have run
    # first and already filled its fields).
    res = ENGINES.setdefault("tpu", {})
    res.update(_device_row())
    # Decode end-to-end (native-encoded member profile; both engines
    # emit the same stream profile).
    tpu_data = data[: DEVICE_SLICE_MB << 20]
    gz = compress(tpu_data, engine="native")
    out = decompress(gz, engine="tpu")
    assert out == tpu_data, "tpu: decode mismatch"
    out, best = _time_best(lambda: decompress(gz, engine="tpu"), reps=2)
    assert out == tpu_data
    res["corpus_mb"] = round(len(tpu_data) / 2**20, 1)
    res["decode_gbps"] = round(len(tpu_data) / best / 1e9, 4)
    # Which path the engine decode actually took (device resolve vs
    # packed-token host resolve), per member class.
    from tpu_deflate.codec.decode_jax_v2 import LAST_DECODE_STATS

    res["decode_path"] = dict(LAST_DECODE_STATS)
    print(f"tpu (end-to-end): {res}", file=sys.stderr)


def section_tpu_encode(data: bytes) -> None:
    """Device-encoder rows on a slice. Its own section, ordered before
    the e2e decode row, so budget pressure cannot take the encoder's
    numbers with it."""
    from tpu_deflate.engine import compress

    res = ENGINES.setdefault("tpu", {})
    res.update(_device_row())
    enc_slice = data[: DEVICE_ENC_SLICE_MB << 20]
    gz_s = compress(enc_slice, engine="tpu")
    t0 = time.monotonic()
    gz_s = compress(enc_slice, engine="tpu")
    res["encode_warm_mbps"] = round(len(enc_slice) / (time.monotonic() - t0) / 1e6, 2)
    res["encode_slice_mb"] = DEVICE_ENC_SLICE_MB
    res["ratio"] = round(len(gz_s) / len(enc_slice), 4)
    print(f"tpu encode: {res.get('encode_warm_mbps')} MB/s warm", file=sys.stderr)
    # Upload-excluded companion figure.
    if _remaining() > 90:
        from tpu_deflate.codec.encode_jax import encode_kernel_bench

        res["encode_kernel"] = encode_kernel_bench(enc_slice)
        print(f"tpu encode-kernel: {res['encode_kernel']}", file=sys.stderr)


def section_host(data: bytes) -> None:
    ENGINES["host"] = bench_engine("host", data[: HOST_SLICE_MB << 20], reps=1)
    print(f"host: {ENGINES['host']}", file=sys.stderr)


def main() -> int:
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    if hasattr(signal, "SIGALRM"):
        signal.signal(signal.SIGALRM, _on_signal)
        signal.alarm(max(int(BUDGET_S), 30))
    import atexit

    atexit.register(finalize)

    data = make_corpus()
    # Descending importance; a section that dies or runs out of budget
    # cannot take the later ones (or the final JSON) with it.
    sections = [
        ("native", section_native, 300),
        ("tpu_kernel_full", section_tpu_kernel_full, 120),
        ("tpu_kernel", section_tpu_kernel, 60),
        ("tpu_encode", section_tpu_encode, 150),
        ("tpu", section_tpu_e2e, 90),
        ("host", section_host, 40),
    ]
    for name, fn, min_budget in sections:
        if _remaining() < min_budget:
            NOTES.append(f"{name} skipped: {_remaining():.0f}s left < {min_budget}s floor")
            continue
        try:
            fn(data)
        except Exception as e:  # later sections still run; the exit code says it failed
            FAILED.append(name)
            NOTES.append(f"{name} failed: {e!r:.200}")
            print(f"{name} bench failed: {e}", file=sys.stderr)
    finalize()
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
