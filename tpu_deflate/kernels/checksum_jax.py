"""Device-side checksums: CRC-32 as GF(2) matrix algebra (matrix products).

CRC-32 of a message is linear over GF(2) in the message bits:
``raw_register(D) = XOR_j M_pos(j) @ bits_j`` where the per-position
matrices depend only on distance-from-end. We exploit this to compute CRC
as *matmuls*:

1. Split the (front-zero-padded) buffer into C-byte chunks; the raw CRC of
   chunk i is ``K @ bits_i`` with a single fixed 32x(8C) matrix K —
   batched over chunks this is one (num_chunks, 8C) @ (8C, 32) f32 matmul
   (0/1 entries; exact in f32 for C <= 2^21 at HIGHEST precision — a
   TF32 product would round its operands).
2. Combine chunk CRCs in a log-depth binary tree: at level l adjacent
   pairs merge as ``shift(left) XOR right`` where shift is the fixed 32x32
   matrix L^{8*C*2^l} — again matmuls.

The combine algebra (matrices, conditioning) is shared with the host
implementation in ``checksum.py``. The reference treats CRC32/Adler32 as
JDK black boxes (SURVEY.md §2.4); here they are first-class device kernels.

Adler-32 is two masked reductions (sum and position-weighted sum) — pure
VPU work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kernels import jax_setup  # noqa: F401  (compilation cache)
import numpy as np

from .checksum import (
    ADLER_MOD,
    _crc_table,
    _op_shift_pow2,
    op_apply,
    op_compose,
    op_shift_n_bits,
    op_unshift_n_bits,
)

CHUNK_BYTES = 512  # per-chunk matrix K is 32 x 4096
# f32 products stay exact only without TF32 operand rounding (the sums
# are < 2^24, the operands 0/1 or powers of two <= 2^15).
_EXACT = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _chunk_matrix(chunk_bytes: int) -> np.ndarray:
    """K: (8*chunk_bytes, 32) 0/1 matrix; raw CRC register of a chunk =
    bits @ K (mod 2), bits listed byte 0 first, LSB-first within bytes."""
    table = _crc_table()
    nbits = 8 * chunk_bytes
    K = np.zeros((nbits, 32), dtype=np.float32)
    # Contribution of bit j of byte p = L8^(chunk_bytes-1-p) (T[1<<j]).
    # Build iteratively from the last byte backwards.
    contrib = np.array([table[1 << j] for j in range(8)], dtype=np.uint32)  # (8,)
    for p in range(chunk_bytes - 1, -1, -1):
        bits = (contrib[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        K[p * 8 : p * 8 + 8, :] = bits
        if p > 0:
            contrib = op_apply(_op_shift_pow2(3), contrib)  # advance 8 zero bits
    return K


@functools.lru_cache(maxsize=None)
def _level_matrices(chunk_bytes: int, levels: int) -> np.ndarray:
    """Stack of (levels, 32, 32) combine matrices: level l holds
    L^{8*chunk_bytes*2^l} as a bit matrix for right-multiplication."""
    out = np.zeros((levels, 32, 32), dtype=np.float32)
    op = op_shift_n_bits(8 * chunk_bytes)
    for l in range(levels):
        bits = (op[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        # op[j] = operator applied to basis j => (bits_in) @ M where
        # M[j, k] = bit k of op[j].
        out[l] = bits.astype(np.float32)
        op = op_compose(op, op)
    return out


def _bits_from_bytes(chunks: jnp.ndarray) -> jnp.ndarray:
    """(N, C) uint8 -> (N, 8C) f32 bit matrix, LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (chunks[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(chunks.shape[0], -1).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("levels",))
def _crc32_raw_device(chunks: jnp.ndarray, K: jnp.ndarray, lvl: jnp.ndarray, levels: int) -> jnp.ndarray:
    """chunks: (2^levels, C) uint8 -> scalar uint32 raw register."""
    bits = _bits_from_bytes(chunks)
    # Per-chunk raw CRCs as one matmul, mod 2.
    crc_bits = jnp.dot(bits, K, precision=_EXACT, preferred_element_type=jnp.float32)
    crc_bits = jnp.mod(crc_bits, 2.0)
    # Tree combine, all in bit-vector space.
    for l in range(levels):
        left = crc_bits[0::2]
        right = crc_bits[1::2]
        shifted = jnp.mod(
            jnp.dot(left, lvl[l], precision=_EXACT, preferred_element_type=jnp.float32), 2.0
        )
        crc_bits = jnp.mod(shifted + right, 2.0)  # XOR of 0/1 values
    weights = jnp.asarray((1 << np.arange(32)).astype(np.int64).view(np.uint64).astype(np.float64), dtype=jnp.float32)
    # Reconstruct uint32 from bits (exact: values < 2^32 via two halves).
    lo = jnp.dot(crc_bits[0, :16], weights[:16], precision=_EXACT, preferred_element_type=jnp.float32)
    hi = jnp.dot(crc_bits[0, 16:], weights[:16], precision=_EXACT, preferred_element_type=jnp.float32)
    return lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << jnp.uint32(16))


def crc32_device(data, value: int = 0) -> int:
    """zlib-compatible CRC-32 computed on the accelerator."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = buf.size
    if n == 0:
        return value & 0xFFFFFFFF
    num_chunks = max(1, -(-n // CHUNK_BYTES))
    levels = int(np.ceil(np.log2(num_chunks))) if num_chunks > 1 else 0
    num_chunks = 1 << levels
    pad = num_chunks * CHUNK_BYTES - n
    padded = np.concatenate([np.zeros(pad, dtype=np.uint8), buf]).reshape(
        num_chunks, CHUNK_BYTES
    )
    K = jnp.asarray(_chunk_matrix(CHUNK_BYTES))
    lvl = jnp.asarray(_level_matrices(CHUNK_BYTES, max(levels, 1)))
    raw = int(_crc32_raw_device(jnp.asarray(padded), K, lvl, levels))
    init_reg = np.uint32((value ^ 0xFFFFFFFF) & 0xFFFFFFFF)
    shifted = op_apply(op_shift_n_bits(8 * n), init_reg)
    return int(np.uint32(raw) ^ shifted ^ np.uint32(0xFFFFFFFF))


# ---------------------------------------------------------------------------
# Batched per-lane CRC (the encode/decode pipelines checksum every member
# on device in one call).
# ---------------------------------------------------------------------------


@jax.jit
def crc32_lanes_raw(chunks: jnp.ndarray, K: jnp.ndarray, lvl: jnp.ndarray) -> jnp.ndarray:
    """(lanes, n_chunks, C) uint8 -> (lanes,) uint32 raw registers.

    n_chunks must be a power of two; front-pad lanes with zeros (ragged
    lanes: zero-pad at the FRONT so the pad is a no-op on the register).
    """
    lanes, n_chunks, c = chunks.shape
    bits = (chunks[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    bits = bits.reshape(lanes, n_chunks, 8 * c).astype(jnp.float32)
    crc_bits = jnp.mod(
        jnp.einsum(
            "lnb,bk->lnk", bits, K, precision=_EXACT, preferred_element_type=jnp.float32
        ),
        2.0,
    )
    level = 0
    while crc_bits.shape[1] > 1:
        left = crc_bits[:, 0::2]
        right = crc_bits[:, 1::2]
        shifted = jnp.mod(
            jnp.einsum(
                "lnk,km->lnm", left, lvl[level], precision=_EXACT,
                preferred_element_type=jnp.float32,
            ),
            2.0,
        )
        crc_bits = jnp.mod(shifted + right, 2.0)
        level += 1
    bits32 = crc_bits[:, 0, :]
    w16 = jnp.asarray((1 << np.arange(16)).astype(np.float32))
    lo = jnp.dot(bits32[:, :16], w16, precision=_EXACT, preferred_element_type=jnp.float32)
    hi = jnp.dot(bits32[:, 16:], w16, precision=_EXACT, preferred_element_type=jnp.float32)
    return lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << jnp.uint32(16))


def crc32_members(members: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Final (conditioned) CRC-32 of each ragged member row on device.

    members: (L, S) uint8, right-aligned is NOT required — rows hold the
    member's first ``lengths[i]`` bytes; we shift to front-padded form.
    """
    L, S = members.shape
    c = CHUNK_BYTES
    n_chunks = 1 << int(np.ceil(np.log2(max(1, -(-S // c)))))
    width = n_chunks * c
    front = np.zeros((L, width), dtype=np.uint8)
    for i in range(L):
        ln = int(lengths[i])
        front[i, width - ln :] = members[i, :ln]
    K = jnp.asarray(_chunk_matrix(c))
    lvl = jnp.asarray(_level_matrices(c, max(1, int(np.log2(n_chunks)))))
    raw = np.asarray(crc32_lanes_raw(jnp.asarray(front.reshape(L, n_chunks, c)), K, lvl))
    # Condition each lane: crc = raw ^ L^{8n}(0xFFFFFFFF) ^ 0xFFFFFFFF.
    out = np.zeros(L, dtype=np.uint32)
    for i in range(L):
        shifted = op_apply(op_shift_n_bits(8 * int(lengths[i])), np.uint32(0xFFFFFFFF))
        out[i] = np.uint32(raw[i]) ^ shifted ^ np.uint32(0xFFFFFFFF)
    return out


@jax.jit
def crc32_lanes_raw8(bytes_rows: jnp.ndarray, K8: jnp.ndarray, lvl8: jnp.ndarray) -> jnp.ndarray:
    """Left-aligned int8 lane CRC: (L, n_chunks*C) uint8/int32 rows with
    zero TAILS -> (L,) uint32 raw registers of row || (implicit zeros).

    The int8 path moves 4x less than the f32 twin (bit matrix stays
    int8; parity via & 1 of int32 matmul sums — XOR of 0/1 = sum mod 2).
    The caller conditions each lane with ``op_unshift_n_bits`` to strip
    the zero tail (L^-8k), so rows need no per-lane front alignment —
    the device consumes the decode pipeline's natural left-aligned
    layout with no host repacking.
    """
    L, width = bytes_rows.shape
    c = CHUNK_BYTES
    n_chunks = width // c
    b = bytes_rows.astype(jnp.int32).reshape(L, n_chunks, c)
    bits = ((b[..., None] >> jnp.arange(8, dtype=jnp.int32)) & 1).astype(jnp.int8)
    bits = bits.reshape(L * n_chunks, 8 * c)
    crc_bits = (
        jax.lax.dot_general(
            bits, K8, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
        )
        & 1
    ).astype(jnp.int8)
    crc_bits = crc_bits.reshape(L, n_chunks, 32)
    level = 0
    while crc_bits.shape[1] > 1:
        left = crc_bits[:, 0::2]
        right = crc_bits[:, 1::2]
        n = left.shape[1]
        shifted = (
            jax.lax.dot_general(
                left.reshape(L * n, 32),
                lvl8[level],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            & 1
        ).astype(jnp.int8)
        crc_bits = (shifted.reshape(L, n, 32) + right) & 1
        level += 1
    bits32 = crc_bits[:, 0, :].astype(jnp.int32)
    w16 = 1 << jnp.arange(16, dtype=jnp.int32)
    lo = jnp.sum(bits32[:, :16] * w16, axis=1)
    hi = jnp.sum(bits32[:, 16:] * w16, axis=1)
    return lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << jnp.uint32(16))


def crc_matrices8(n_chunks: int):
    """(K8, lvl8) int8 device matrices for :func:`crc32_lanes_raw8`."""
    K8 = jnp.asarray(_chunk_matrix(CHUNK_BYTES).astype(np.int8))
    lvl8 = jnp.asarray(
        _level_matrices(CHUNK_BYTES, max(1, int(np.ceil(np.log2(max(n_chunks, 2)))))).astype(np.int8)
    )
    return K8, lvl8


def crc32_finish_leftaligned(raw: np.ndarray, lengths: np.ndarray, width: int) -> np.ndarray:
    """Condition left-aligned raw lane registers into final CRC-32s.

    raw[i] is the raw register of (member_i || 0^(width-len_i)); undo the
    zero tail with L^-8k, then apply the standard init/final XORs.
    """
    out = np.zeros(raw.shape[0], dtype=np.uint32)
    for i in range(raw.shape[0]):
        n = int(lengths[i])
        k = width - n
        r = op_apply(op_unshift_n_bits(8 * k), np.uint32(raw[i]))
        shifted = op_apply(op_shift_n_bits(8 * n), np.uint32(0xFFFFFFFF))
        out[i] = np.uint32(r) ^ shifted ^ np.uint32(0xFFFFFFFF)
    return out


# ---------------------------------------------------------------------------
# Adler-32 on device
# ---------------------------------------------------------------------------


def _mod_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Exact sum mod ADLER_MOD of an int32 vector of values < 2^25.

    Hierarchical: sum groups of 64 (safe: 64 * 2^25 < 2^31), reduce mod,
    repeat. Stays entirely in int32.
    """
    while x.shape[0] > 1:
        n = x.shape[0]
        pad = (-n) % 64
        x = jnp.pad(x, (0, pad))
        x = jnp.sum(x.reshape(-1, 64), axis=1) % ADLER_MOD
    return x[0]


@jax.jit
def _adler_sums(data: jnp.ndarray, length: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(sum mod M, position-weighted sum mod M) of data[:length]."""
    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    mask = idx < length
    d = jnp.where(mask, data.astype(jnp.int32), 0)
    # weights (length - idx) mod M: products <= 255 * 65520 < 2^24.
    w = jnp.where(mask, (length - idx) % ADLER_MOD, 0)
    s = _mod_sum(d)
    ws = _mod_sum((d * w) % ADLER_MOD)
    return s, ws


def adler32_device(data, value: int = 1) -> int:
    """zlib-compatible Adler-32 with the reductions on the accelerator."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    n = buf.size
    if n == 0:
        return value & 0xFFFFFFFF
    s, ws = _adler_sums(jnp.asarray(buf), jnp.int32(n))
    b = (b + n * a + int(ws)) % ADLER_MOD
    a = (a + int(s)) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF
