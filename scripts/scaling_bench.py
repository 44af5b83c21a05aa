"""Mesh-scaling rehearsal on the virtual N-device CPU mesh.

Measures the sharding machinery's overhead and work distribution on
XLA's CPU backend — sharded vs single-device wall time for the same
total work, plus the host-side components (native encode thread pool)
that scale with real cores. These are CPU numbers, never device
numbers; the four-GPU path is `python chip_smoke.py --four-cards`.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/scaling_bench.py [mb]
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from bench import make_corpus  # noqa: E402


def best_of(fn, n=3):
    """(first_call_s, best_warm_s): the first call carries compilation
    of every wave/mesh shape; the best-of-n that follows is the
    steady-state number. Reporting both separates one-time shard_map
    compile cost from per-call partition overhead."""
    t0 = time.monotonic()
    fn()
    first = time.monotonic() - t0
    best = float("inf")
    for _ in range(n):
        t0 = time.monotonic()
        fn()
        best = min(best, time.monotonic() - t0)
    return first, best


def main() -> None:
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    data = make_corpus(mb)
    from tpu_deflate.dist.mesh import make_codec_mesh
    from tpu_deflate.dist.sharded import sharded_continuous_compress
    from tpu_deflate.engine import compress, decompress

    print(f"devices: {len(jax.devices())} ({jax.devices()[0].platform})")

    # Sharded continuous encode: D-way halo + shard-parallel native blocks.
    base = None
    for d in (1, 2, 4, 8):
        mesh = make_codec_mesh(d)
        tc, t = best_of(lambda: sharded_continuous_compress(data, mesh, max_chain=128))
        rate = mb / t
        if base is None:
            base = rate
        eff = rate / (base * d) * 100
        print(
            f"continuous encode D={d}: {t*1e3:7.1f} ms  {rate:6.1f} MB/s  "
            f"eff {eff:5.1f}%  (first call {tc*1e3:.0f} ms incl. compile)"
        )

    # Sharded device decode (v2 stages lane-sharded over the mesh).
    gz = compress(data, engine="native")
    tc1, t1 = best_of(lambda: decompress(gz, engine="tpu"))
    print(
        f"device decode single: {t1*1e3:7.1f} ms  {mb/t1:6.1f} MB/s  "
        f"(first call {tc1*1e3:.0f} ms incl. compile)"
    )
    for d in (2, 4, 8):
        mesh = make_codec_mesh(d)
        tc, t = best_of(lambda: decompress(gz, mesh=mesh))
        over = (t / t1 - 1) * 100
        print(
            f"device decode D={d}: {t*1e3:7.1f} ms  {mb/t:6.1f} MB/s  "
            f"overhead vs single {over:+5.1f}%  (first call {tc*1e3:.0f} ms incl. compile)"
        )


if __name__ == "__main__":
    main()
