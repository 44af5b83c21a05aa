"""Mesh-sharded codec pipelines (SURVEY.md §2.1/§2.2 build components).

Data-parallel seam: gzip members are independent, so the batched codec
kernels shard their lane axis across the mesh with **zero** communication
in the hot path. Collectives appear exactly where the format needs them:

- ``ppermute`` ring halo exchange of each shard's last 32 KiB so match
  search can reach into the previous shard's history (the SP/CP seam —
  the format's bounded 32 KiB receptive field);
- ``psum`` aggregation of per-shard stats (ratio, block-type and symbol
  histograms — the §5.5 observability component);
- ordered variable-length gather of compressed shards: every lane's byte
  length travels with the payload (ragged sizes -> pad + length vector),
  host 0 concatenates in lane order.

All functions take an explicit Mesh so tests can run them on the virtual
8-device CPU mesh while production uses the cards of a host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..format.tables import WINDOW_SIZE


def broadcast_preset_dict(dictionary: bytes, mesh: Mesh) -> jnp.ndarray:
    """Replicate a zlib preset dictionary (FDICT, ``ZlibMetadata.java:66-75``)
    across every device of the mesh.

    Returns the last 32 KiB (the only part LZ77 can reach), left-padded
    with zeros, as a replicated (WINDOW_SIZE,) uint8 array — the SPMD
    broadcast of SURVEY.md §2.2d.
    """
    arr = np.zeros(WINDOW_SIZE, np.uint8)
    tail = np.frombuffer(dictionary[-WINDOW_SIZE:], dtype=np.uint8)
    if tail.size:
        arr[-tail.size :] = tail
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P()))


def halo_exchange(
    shards: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    preset_dict: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Prepend each shard with the previous shard's last 32 KiB.

    shards: (D, S) uint8, lane d on device d. Returns (D, 32768 + S).
    Row 0's halo is the replicated preset dictionary when given (the
    zlib FDICT seam: the dictionary primes the stream head's window),
    zeros otherwise. Ring ``ppermute`` (SURVEY.md §2.2c).
    """
    if preset_dict is None:
        preset_dict = jnp.zeros(WINDOW_SIZE, jnp.uint8)

    H = min(WINDOW_SIZE, shards.shape[1])  # short shards carry all they have

    def body(x, d0):
        d = jax.lax.axis_index(axis)
        n = jax.lax.axis_size(axis)
        tail = x[:, -H:]
        perm = [(i, (i + 1) % n) for i in range(n)]
        halo = jax.lax.ppermute(tail, axis, perm)
        halo = jnp.where(d == 0, jnp.broadcast_to(d0[-H:], halo.shape), halo)
        return jnp.concatenate([halo, x], axis=1)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(None)),
        out_specs=P(axis, None),
    )(shards, preset_dict)


def psum_stats(values: jnp.ndarray, mesh: Mesh, axis: str = "data") -> jnp.ndarray:
    """Sum per-shard stat vectors across the mesh (replicated result)."""

    def body(v):
        return jax.lax.psum(v, axis)

    return jax.shard_map(
        body, mesh=mesh, in_specs=P(axis, None), out_specs=P(None)
    )(values)


def ordered_ragged_gather(
    payload: jnp.ndarray, lengths: jnp.ndarray, mesh: Mesh, axis: str = "data"
) -> tuple[np.ndarray, np.ndarray]:
    """All-gather ragged per-lane payloads in deterministic lane order.

    payload: (L, W) fixed-width rows sharded on L; lengths: (L,) valid
    bytes per row. Device side is an all-gather (deterministic order by
    construction of the sharded lane axis); host 0 slices and concatenates.
    Returns (host arrays) — the distributed analog of the reference's
    in-order stream append (``GzipOutputStream`` member concatenation).
    """

    def body(p, l):
        return (
            jax.lax.all_gather(p, axis, axis=0, tiled=True),
            jax.lax.all_gather(l, axis, axis=0, tiled=True),
        )

    gathered_p, gathered_l = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(None, None), P(None)),
        check_vma=False,  # all_gather output is replicated by construction
    )(payload, lengths)
    return np.asarray(gathered_p), np.asarray(gathered_l)


# ---------------------------------------------------------------------------
# Sharded continuous-history encode (SP/CP seam: halo-fed max-ratio mode)
# ---------------------------------------------------------------------------


def _bit_splice(streams: list[tuple[bytes, int]]) -> tuple[bytes, int]:
    """Concatenate raw DEFLATE bit-streams at bit granularity.

    Each stream is (bytes, nbits) with the final partial byte
    zero-padded above nbits. Huffman block bodies are alignment-
    independent, so shifting shard streams to their running bit offset
    reproduces the serial encoder's single contiguous stream.
    """
    out = bytearray()
    bitpos = 0
    for sb, nbits in streams:
        if nbits == 0:
            continue
        r = bitpos & 7
        arr = np.frombuffer(sb, np.uint8)
        if r == 0:
            out += sb
        else:
            lo = ((arr.astype(np.uint16) << r) & 0xFF).astype(np.uint8)
            hi = (arr >> (8 - r)).astype(np.uint8)
            out[-1] |= int(lo[0])
            out += (lo[1:] | hi[:-1]).tobytes()
            out.append(int(hi[-1]))
        bitpos += nbits
        del out[(bitpos + 7) // 8 :]  # drop bytes past the valid bits
    return bytes(out), bitpos


def _deflate_shard(
    buf_with_halo: bytes,
    halo: int,
    ln: int,
    final: bool,
    *,
    block_data: int,
    max_code_len: int,
    max_chain: int,
) -> tuple[bytes, int]:
    """Encode one shard's blocks bit-contiguously, first block's history
    coming from the halo prefix (the previous shard's last 32 KiB)."""
    import ctypes

    from .. import native

    lib = native._load()
    out = bytearray()
    partial = 0
    bitpos = 0
    pos = 0
    while pos < ln:
        blk = min(block_data, ln - pos)
        h = min(32 * 1024, halo + pos)
        start = halo + pos - h
        fin = final and (pos + blk >= ln)
        buf = buf_with_halo[start : halo + pos + blk]
        cap = blk + blk // 4 + 2048
        obuf = ctypes.create_string_buffer(cap)
        bits = lib.td_deflate_block(
            buf, h, blk, obuf, cap, 1 if fin else 0, bitpos, partial,
            max_code_len, max_chain,
        )
        if bits == 0:
            raise RuntimeError("native deflate_block failed")
        whole, rem = divmod(int(bits), 8)
        raw = obuf.raw
        out += raw[:whole]
        partial = raw[whole] if rem else 0
        bitpos = rem
        pos += blk
    total_bits = len(out) * 8 + bitpos
    if bitpos:
        out.append(partial)
    return bytes(out), total_bits


def sharded_continuous_compress(
    data: bytes,
    mesh: Mesh,
    *,
    axis: str = "data",
    block_data: int = 64 * 1024,
    max_code_len: int = 15,
    max_chain: int = 512,
    preset_dict: bytes | None = None,
) -> bytes:
    """Max-ratio (continuous 32 KiB history) gzip, sharded over a mesh.

    The SP/CP build component (SURVEY.md §2.1): the format's bounded
    32 KiB receptive field (``decomp/Open.java:201``,
    ``DeflaterOutputStream.java:38-45``) means adjacent shards share only
    a 32 KiB halo. The input lane-shards over the mesh, ``halo_exchange``
    rings each shard's tail to its successor (ppermute; shard 0 takes
    the broadcast preset dictionary when given), every shard's blocks are
    then encoded *in parallel* against their halo history, and the
    bit-streams splice into ONE member on host — Huffman bodies are
    alignment-independent, so the result matches the serial continuous
    encoder's stream except where a shard's stored-block fallback padding
    differs (ratio within noise; round-trip exact).

    ``preset_dict`` caveat: the output is framed as a plain gzip member
    even when a dictionary is supplied, so the DEFLATE body may
    back-reference dictionary bytes that a standard gzip consumer does
    not have (it would fail with copy-before-start). Dictionary output
    is only decodable by a dict-primed raw-DEFLATE decoder (e.g.
    ``InflaterStream`` seeded with the dictionary, or zlib FDICT framing
    applied by the caller); the engine path never passes one.
    """
    from .. import native
    from ..codec.profile import _empty_member, build_member

    if not data:
        return _empty_member()
    n = len(data)
    D = int(mesh.devices.size)
    blocks = -(-n // block_data)
    S = max(1, -(-blocks // D)) * block_data
    padded = np.zeros((D, S), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for d in range(D):
        seg = flat[d * S : (d + 1) * S]
        padded[d, : seg.size] = seg
    pd = broadcast_preset_dict(preset_dict, mesh) if preset_dict else None
    haloed = np.asarray(halo_exchange(jnp.asarray(padded), mesh, axis, preset_dict=pd))

    H = haloed.shape[1] - S  # halo width actually carried (= min(32K, S))
    lens = [min(S, max(0, n - d * S)) for d in range(D)]
    dict_halo = min(H, len(preset_dict)) if preset_dict else 0
    last = max(i for i in range(D) if lens[i] > 0)

    def enc_final(d: int) -> tuple[bytes, int]:
        if lens[d] == 0:
            return b"", 0
        halo = min(H, d * S) if d > 0 else dict_halo
        row = haloed[d]
        buf = row[H - halo : H + lens[d]].tobytes()
        return _deflate_shard(
            buf, halo, lens[d], d == last,
            block_data=block_data, max_code_len=max_code_len, max_chain=max_chain,
        )

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(D, 8)) as ex:
        streams = list(ex.map(enc_final, range(D)))
    payload, _bits = _bit_splice(streams)
    return build_member(payload, n, native.crc32(data))


# ---------------------------------------------------------------------------
# Sharded encode / decode steps (the dryrun_multichip / scaling path)
# ---------------------------------------------------------------------------


def sharded_analyze_emit(mesh: Mesh, axis: str | tuple = "data"):
    """Build a pjit'd encode step with the lane axis sharded over the mesh.

    Returns fn(data (L,S) uint8, lengths (L,)) -> (words, total_bits),
    where L must divide by the mesh size. Lanes are independent, so XLA
    partitions the whole analyze+emit graph without communication.

    ``axis`` may be a tuple (e.g. ``("host", "data")`` on a pod mesh) to
    shard lanes over the product of both mesh axes — members then split
    across hosts and across each host's devices.
    """
    from ..codec import encode_jax as ej

    lane = NamedSharding(mesh, P(axis))

    @functools.partial(jax.jit, out_shardings=(lane, lane))
    def step(data, lengths, ll_codes, d_codes, header_vals, header_bits, eob_val, eob_bits):
        a = ej.analyze_device(data, lengths, True)
        flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
        return ej.emit_device(
            a["litlen_sym"],
            flags,
            a["len_eb"],
            a["len_ev"],
            a["dist_sym"],
            a["dist_eb"],
            a["dist_ev"],
            ll_codes,
            d_codes,
            header_vals,
            header_bits,
            eob_val,
            eob_bits,
        )

    return step


def sharded_resolve(mesh: Mesh, axis: str = "data"):
    """Mesh-sharded device LZ77 resolve (the decode pipeline's final
    stage, ≙ ``decomp/Open.java:589-617``).

    Returns fn(tokens (L, N_POS) int32) -> (y, summary) with the lane
    axis data-parallel over ``mesh[axis]``: each device resolves its own
    lane shard with ``resolve_jax`` — lanes are independent members, so
    the stage needs no communication and is bit-exact with the
    single-device path. Stream-start lanes only (a chained tile's tail is
    produced by the same lane's previous call, which shards identically).
    """
    from ..codec import resolve_jax as rp

    def body(tokens):
        y, summ, _rounds, _unres = rp.resolve_tokens_device(tokens)
        return y, summ

    lane = P(axis, None)
    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=lane,
            out_specs=(lane, lane),
            check_vma=False,  # the pointer-jumping loop ends per shard
        )
    )


_SHARDED_DECODE_CACHE: dict = {}


def sharded_decode(mesh: Mesh, axis: str = "data"):
    """Mesh-sharded v2 decode runner (lane axis data-parallel).

    Returns a callable mapping the v2 wave input dict (host arrays) to the
    7-tuple ``decode_jax_v2._run_wave_device`` returns. Each host array
    goes straight to its lane shard, and every device runs the wave's
    stages on its own shard under ``shard_map``, so no array is staged on
    one device first; lanes are independent members,
    so there is no communication until the host pulls the results. The
    host driver (``decode_deflate_streams_v2``) pads the lane count to a
    multiple of the mesh size via the runner's ``lane_multiple``
    attribute. Cached per (mesh, axis) so jit re-use survives across
    calls.
    """
    key = (mesh, axis)
    cached = _SHARDED_DECODE_CACHE.get(key)
    if cached is not None:
        return cached

    from ..codec import decode_jax_v2 as v2

    keys = v2.WAVE_KEYS
    lane_spec = P(axis)
    lane = NamedSharding(mesh, lane_spec)

    def build(full_compact: bool):
        def body(*args):
            *rest, overflow = v2._run_wave_device(dict(zip(keys, args)), full_compact)
            return (*rest, overflow[None])  # one overflow flag per shard

        return jax.jit(
            jax.shard_map(
                body, mesh=mesh, in_specs=lane_spec, out_specs=lane_spec, check_vma=False
            )
        )

    run, run_safe = build(False), build(True)

    def call(fn, w: dict):
        *rest, overflow = fn(*(jax.device_put(w[k], lane) for k in keys))
        return (*rest, jnp.any(overflow))

    def runner(w: dict):
        return call(run, w)

    runner.lane_multiple = int(mesh.devices.size)
    runner.safe = lambda w: call(run_safe, w)
    _SHARDED_DECODE_CACHE[key] = runner
    return runner
