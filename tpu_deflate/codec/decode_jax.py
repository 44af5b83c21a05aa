"""Member indexing + batched host-side header parsing for the device
decoder (shared front end of ``decode_jax_v2``).

The reference decoder is a single bit-cursor state machine
(``decomp/Open.java:83-110``) — inherently serial. The member seam this
module exploits (SURVEY.md §2.1): multi-member gzip streams whose
members carry a bgzf-style FEXTRA subfield ('T','D': compressed member
size) split in O(members) without decoding; each member is an
independent decode lane. Foreign streams fall back transparently.

Pieces here:
- ``split_members``: walk the TD index -> MemberIndex offsets.
- ``parse_headers_batch``: lock-step batched parse of every lane's
  fixed/dynamic block header (NumPy state machine, one code-length
  symbol per lane per step; ≙ ``decomp/Open.java:322-431``) with the
  full reference error taxonomy.
- ``build_luts_batch``: batched canonical decode LUTs (used by the
  encoder's header planner and tests; the v2 decoder derives bounds
  ladders from the same canonical tables instead).
- ``_decode_stored_member``: host memcpy of stored-block members.

The round-1 bit-parallel device decode path that used to live here
(speculative per-bit LUT decode) was superseded by ``decode_jax_v2``
(stages A-E) and ``resolve_jax`` (LZ77 resolve) and has been removed.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..format.errors import DataFormatError, Reason, reason_to_code
from ..format.tables import (
    CLEN_ORDER,
    FIXED_DIST_LENGTHS,
    FIXED_LITLEN_LENGTHS,
)
from ..kernels import checksum as ck
from ..kernels.huffman import validate_code_lengths

DEV_LUT_BITS = 12  # device profile: all litlen/dist code lengths <= 12
MEMBER_DATA = 64 * 1024  # uncompressed bytes per member in the TD profile
LANE_BATCH = 64  # lanes per dispatch (bit-parallel arrays are ~8x payload)

TD_SUBFIELD = b"TD"

_ERR_END = reason_to_code(Reason.UNEXPECTED_END_OF_STREAM)
_ERR_RESERVED_LEN = reason_to_code(Reason.RESERVED_LENGTH_SYMBOL)
_ERR_RESERVED_DIST = reason_to_code(Reason.RESERVED_DISTANCE_SYMBOL)
_ERR_BEFORE_START = reason_to_code(Reason.COPY_FROM_BEFORE_DICTIONARY_START)


# ---------------------------------------------------------------------------
# Member splitting (host)
# ---------------------------------------------------------------------------


@dataclass
class MemberIndex:
    """Offsets of one gzip member within a stream."""

    start: int  # offset of the gzip header
    payload_start: int  # offset of the DEFLATE payload
    end: int  # offset one past the trailer
    isize: int  # uncompressed size (trailer, mod 2^32)
    crc32: int  # expected CRC (trailer)


def split_members(gz: np.ndarray) -> list[MemberIndex] | None:
    """Walk a multi-member stream via the TD FEXTRA subfields.

    Returns None if any member lacks the subfield (caller falls back to the
    host decoder). Headers here are the fixed 10 bytes + FEXTRA only (the
    profile our encoder writes).
    """
    members = []
    pos = 0
    n = gz.size
    buf = gz
    while pos < n:
        if pos + 10 > n or buf[pos] != 0x1F or buf[pos + 1] != 0x8B:
            return None
        flags = int(buf[pos + 3])
        if not flags & 0x04:  # no FEXTRA
            return None
        p = pos + 10
        if p + 2 > n:
            return None
        xlen = int(buf[p]) | int(buf[p + 1]) << 8
        extra = buf[p + 2 : p + 2 + xlen]
        p += 2 + xlen
        # scan subfields for 'TD'
        member_len = None
        q = 0
        while q + 4 <= xlen:
            sid = bytes(extra[q : q + 2])
            slen = int(extra[q + 2]) | int(extra[q + 3]) << 8
            if sid == TD_SUBFIELD and slen == 4:
                member_len = int.from_bytes(bytes(extra[q + 4 : q + 8]), "little")
            q += 4 + slen
        if member_len is None:
            return None
        # skip optional name/comment/hcrc fields per flags
        if flags & 0x08:  # FNAME
            while p < n and buf[p] != 0:
                p += 1
            p += 1
        if flags & 0x10:  # FCOMMENT
            while p < n and buf[p] != 0:
                p += 1
            p += 1
        if flags & 0x02:  # FHCRC
            p += 2
        end = pos + member_len
        if end > n or end - 8 < p:
            return None
        isize = int.from_bytes(bytes(buf[end - 4 : end]), "little")
        crc = int.from_bytes(bytes(buf[end - 8 : end - 4]), "little")
        members.append(MemberIndex(pos, p, end, isize, crc))
        pos = end
    return members


# ---------------------------------------------------------------------------
# Phase H: batched header parse (host, NumPy lock-step)
# ---------------------------------------------------------------------------


def _u32_view(payload: np.ndarray) -> np.ndarray:
    """(L, P) uint8 -> (L, P) uint32 little-endian 4-byte windows."""
    L, P = payload.shape
    ext = np.concatenate([payload, np.zeros((L, 4), dtype=np.uint8)], axis=1).astype(
        np.uint32
    )
    return ext[:, :P] | (ext[:, 1 : P + 1] << 8) | (ext[:, 2 : P + 2] << 16) | (
        ext[:, 3 : P + 3] << 24
    )


def _peek(u32v: np.ndarray, bitpos: np.ndarray) -> np.ndarray:
    """>=25 valid bits at each lane's bit position."""
    lanes = np.arange(u32v.shape[0])
    byte = np.minimum(bitpos >> 3, u32v.shape[1] - 1)
    return u32v[lanes, byte] >> (bitpos & 7).astype(np.uint32)


@dataclass
class HeaderParse:
    litlen_lengths: np.ndarray  # (L, 288)
    dist_lengths: np.ndarray  # (L, 32) padded, with reference dist semantics
    dist_empty: np.ndarray  # (L,) bool: empty distance code
    body_bitpos: np.ndarray  # (L,) first bit of block body
    btype: np.ndarray  # (L,) 1=fixed, 2=dynamic (0=stored handled earlier)
    bfinal: np.ndarray  # (L,) bool


def parse_headers_batch(
    payload: np.ndarray, payload_bits: np.ndarray, start_bits: np.ndarray | None = None
) -> HeaderParse:
    """Parse one fixed/dynamic block header per lane, fully vectorized.

    ``start_bits`` (per-lane, in [0, 8)) locates the 3-bit block header
    inside byte 0 — the v2 block-chain driver byte-shifts each lane so a
    mid-stream block header lands there. Raises DataFormatError (first
    failing lane wins, in lane order) with the reference's taxonomy.
    """
    L = payload.shape[0]
    u32v = _u32_view(payload)
    if start_bits is None:
        bitpos = np.zeros(L, dtype=np.int64)
    else:
        bitpos = np.asarray(start_bits, dtype=np.int64).copy()
    errs = np.zeros(L, dtype=np.int32)

    w = _peek(u32v, bitpos)
    bfinal = (w & 1).astype(bool)
    btype = ((w >> 1) & 3).astype(np.int32)
    bitpos += 3
    if (btype == 3).any():
        lane = int(np.nonzero(btype == 3)[0][0])
        raise DataFormatError(Reason.RESERVED_BLOCK_TYPE, f"Reserved block type (member {lane})")
    dyn = btype == 2

    litlen = np.tile(FIXED_LITLEN_LENGTHS, (L, 1)).astype(np.int32)
    dist = np.tile(FIXED_DIST_LENGTHS, (L, 1)).astype(np.int32)
    dist_empty = np.zeros(L, dtype=bool)

    if dyn.any():
        d_idx = np.nonzero(dyn)[0]
        dl = _parse_dynamic_headers(u32v[d_idx], bitpos[d_idx], payload_bits[d_idx])
        litlen[d_idx] = dl["litlen"]
        dist[d_idx] = dl["dist"]
        dist_empty[d_idx] = dl["dist_empty"]
        bitpos[d_idx] = dl["bitpos"]
    return HeaderParse(litlen, dist, dist_empty, bitpos, btype, bfinal)


def _parse_dynamic_headers(u32v, bitpos, payload_bits):
    """Vectorized dynamic header parse for the selected lanes."""
    L = u32v.shape[0]
    w = _peek(u32v, bitpos)
    hlit = (w & 31).astype(np.int64) + 257
    hdist = ((w >> 5) & 31).astype(np.int64) + 1
    hclen = ((w >> 10) & 15).astype(np.int64) + 4
    bitpos = bitpos + 14

    # Code-length-code lengths: up to 19 3-bit fields, transmitted in
    # CLEN_ORDER. Read all 19 positions lock-step with masking.
    clen_lengths = np.zeros((L, 19), dtype=np.int64)
    for i in range(19):
        active = i < hclen
        w = _peek(u32v, bitpos)
        val = (w & 7).astype(np.int64)
        clen_lengths[active, CLEN_ORDER[i]] = val[active]
        bitpos = bitpos + np.where(active, 3, 0)

    # Validate clen codes per lane, then build all 7-bit LUTs batched.
    for l in range(L):
        validate_code_lengths(clen_lengths[l])
    clen_lut = build_luts_batch(clen_lengths, lut_bits=7)
    clen_lut_sym = (clen_lut & 511).astype(np.int64)
    clen_lut_len = (clen_lut >> 9).astype(np.int64)

    # Lock-step decode of the code-length symbol stream. Each step decodes
    # one clen symbol per active lane and records (value, count); the run
    # expansion happens afterwards with one vectorized np.repeat.
    total = hlit + hdist
    max_steps = int(total.max()) if L else 0
    vals = np.zeros((L, max_steps), dtype=np.int64)
    counts = np.zeros((L, max_steps), dtype=np.int64)
    produced = np.zeros(L, dtype=np.int64)
    prev_val = np.full(L, -1, dtype=np.int64)
    lanes = np.arange(L)
    step = 0
    while True:
        active = produced < total
        if not active.any():
            break
        if step >= max_steps:
            break
        w = _peek(u32v, bitpos)
        sym = clen_lut_sym[lanes, w & 127]
        ln = clen_lut_len[lanes, w & 127]
        consumed = ln.copy()
        # EOF check: needing bits past the payload
        over = active & (bitpos + consumed > payload_bits)
        if over.any():
            raise DataFormatError.unexpected_end()
        is_lit = sym < 16
        is_16, is_17, is_18 = sym == 16, sym == 17, sym == 18
        w2 = w >> ln
        run = np.where(is_16, 3 + (w2 & 3), 0)
        run = np.where(is_17, 3 + (w2 & 7), run)
        run = np.where(is_18, 11 + (w2 & 127), run)
        consumed = consumed + np.where(is_16, 2, 0) + np.where(is_17, 3, 0) + np.where(is_18, 7, 0)
        # Reference order: symbol 16 checks for a previous length *before*
        # reading its 2 extra bits (decomp/Open.java:360), so NO_PREVIOUS
        # precedes the extra-bits EOF check.
        no_prev = active & is_16 & (prev_val < 0)
        if no_prev.any():
            raise DataFormatError(
                Reason.NO_PREVIOUS_CODE_LENGTH_TO_COPY, "No code length value to copy"
            )
        over = active & (bitpos + consumed > payload_bits)
        if over.any():
            raise DataFormatError.unexpected_end()
        val = np.where(is_lit, sym, np.where(is_16, prev_val, 0))
        cnt = np.where(is_lit, 1, run)
        overflow = active & (produced + cnt > total)
        if overflow.any():
            raise DataFormatError(
                Reason.CODE_LENGTH_CODE_OVER_FULL, "Run exceeds number of codes"
            )
        vals[active, step] = val[active]
        counts[active, step] = cnt[active]
        produced = produced + np.where(active, cnt, 0)
        prev_val = np.where(active & (is_lit | is_17 | is_18), np.where(is_lit, sym, 0), prev_val)
        prev_val = np.where(active & is_16, prev_val, prev_val)
        bitpos = bitpos + np.where(active, consumed, 0)
        step += 1

    # Expand runs: lane-major repeat, then slice per lane.
    flat_vals = vals.ravel()
    flat_counts = counts.ravel()
    expanded = np.repeat(flat_vals, flat_counts)
    lane_totals = counts.sum(axis=1)
    assert (lane_totals == total).all()
    starts = np.concatenate([[0], np.cumsum(lane_totals)[:-1]])

    litlen = np.zeros((L, 288), dtype=np.int32)
    dist = np.zeros((L, 32), dtype=np.int32)
    dist_empty = np.zeros(L, dtype=bool)
    for l in range(L):
        code_lens = expanded[starts[l] : starts[l] + lane_totals[l]]
        ll = code_lens[: hlit[l]]
        dd = code_lens[hlit[l] :]
        if ll[256] == 0:
            raise DataFormatError(
                Reason.END_OF_BLOCK_CODE_ZERO_LENGTH,
                "End-of-block symbol has zero code length",
            )
        full_ll = np.zeros(288, dtype=np.int64)
        full_ll[: ll.size] = ll
        validate_code_lengths(full_ll)
        litlen[l] = full_ll
        if dd.size == 1 and dd[0] == 0:
            dist_empty[l] = True
            continue
        one = int((dd == 1).sum())
        other = int((dd > 1).sum())
        full_dd = np.zeros(32, dtype=np.int64)
        full_dd[: dd.size] = dd
        if one == 1 and other == 0:
            full_dd[31] = 1  # reference's dummy completion (Open.java:421-425)
        validate_code_lengths(full_dd)
        dist[l] = full_dd
    return {
        "litlen": litlen,
        "dist": dist,
        "dist_empty": dist_empty,
        "bitpos": bitpos,
    }


# ---------------------------------------------------------------------------
# Batched LUT build (host, vectorized across lanes)
# ---------------------------------------------------------------------------


def build_luts_batch(lengths: np.ndarray, lut_bits: int = DEV_LUT_BITS) -> np.ndarray:
    """(L, N) code lengths -> (L, 2^lut_bits) int32 packed (len<<9 | sym).

    All lanes must have max length <= lut_bits (the device profile). Fill
    is vectorized by code length: for each l, every (lane, symbol) pair of
    that length broadcasts its 2^(lut_bits-l) table entries at once.
    """
    L, N = lengths.shape
    assert lengths.max(initial=0) <= lut_bits
    # Batched canonical code assignment.
    counts = np.zeros((L, lut_bits + 2), dtype=np.int64)
    for l in range(1, lut_bits + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    next_code = np.zeros((L, lut_bits + 2), dtype=np.int64)
    code = np.zeros(L, dtype=np.int64)
    for l in range(1, lut_bits + 1):
        code = (code + counts[:, l - 1]) << 1
        next_code[:, l] = code
    # rank within (lane, length) class by symbol order
    order = np.argsort(lengths + 1000 * np.arange(L)[:, None] * 0, axis=1, kind="stable")
    # simpler: per lane stable argsort by length
    ranks = np.zeros((L, N), dtype=np.int64)
    sorted_lens = np.take_along_axis(lengths, order, axis=1)
    group_first = np.zeros((L, lut_bits + 2), dtype=np.int64)
    for l in range(lut_bits + 2):
        group_first[:, l] = np.argmax(sorted_lens >= l, axis=1)
    pos_in_sorted = np.empty((L, N), dtype=np.int64)
    np.put_along_axis(pos_in_sorted, order, np.arange(N)[None, :].repeat(L, 0), axis=1)
    ranks = pos_in_sorted - np.take_along_axis(
        group_first, lengths.astype(np.int64), axis=1
    )
    codes = np.take_along_axis(next_code, lengths.astype(np.int64), axis=1) + ranks
    # bit-reverse codes within their length
    rev = np.zeros((L, N), dtype=np.int64)
    c = codes.copy()
    for _ in range(lut_bits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    rev = rev >> (lut_bits - np.maximum(lengths, 1))

    lut = np.zeros((L, 1 << lut_bits), dtype=np.int32)
    lane_idx, sym_idx = np.nonzero(lengths > 0)
    lens_nz = lengths[lane_idx, sym_idx]
    revs_nz = rev[lane_idx, sym_idx]
    for l in range(1, lut_bits + 1):
        sel = lens_nz == l
        if not sel.any():
            continue
        reps = 1 << (lut_bits - l)
        entry = (l << 9) | sym_idx[sel]
        idx = revs_nz[sel][:, None] + (np.arange(reps)[None, :] << l)
        lut[lane_idx[sel][:, None], idx] = entry[:, None].astype(np.int32)
    return lut



# ---------------------------------------------------------------------------
# Stored-member fast path (host memcpy; shared with the v2 driver)
# ---------------------------------------------------------------------------


def _decode_stored_member(buf: np.ndarray, m: MemberIndex, *, verify_crc: bool) -> np.ndarray:
    """Direct copy-out of a member whose blocks are all stored."""
    pos = m.payload_start
    out = []
    while True:
        hdr = int(buf[pos])
        bfinal, btype = hdr & 1, (hdr >> 1) & 3
        if btype != 0:
            # mixed block types: rare, use the host state machine
            return _host_fallback(buf, [m])[0]
        pos += 1  # stored block header consumes 3 bits; align skips the rest
        ln = int(buf[pos]) | int(buf[pos + 1]) << 8
        nlen = int(buf[pos + 2]) | int(buf[pos + 3]) << 8
        if ln != (nlen ^ 0xFFFF):
            raise DataFormatError(
                Reason.UNCOMPRESSED_BLOCK_LENGTH_MISMATCH,
                "len/nlen mismatch in uncompressed block",
            )
        pos += 4
        out.append(buf[pos : pos + ln])
        pos += ln
        if bfinal:
            break
    result = np.concatenate(out) if out else np.zeros(0, np.uint8)
    # trailer checks in the host engine's order: CRC, then size
    if verify_crc and _fast_crc32(result) != m.crc32:
        raise DataFormatError(
            Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
        )
    if result.size != m.isize:
        raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "Decompressed size mismatch")
    return result


def _fast_crc32(data: np.ndarray) -> int:
    """Native C CRC when available (stored members are pure host work;
    the NumPy table CRC was a visible slice of e2e decode time)."""
    try:
        from .. import native

        if native.available():
            return native.crc32(data.tobytes())
    except Exception:
        pass
    return ck.crc32(data)




def _host_fallback(buf, batch):
    from ..streams.gzip_stream import GzipReader

    results = []
    for m in batch:
        raw = buf[m.start : m.end].tobytes()
        r = GzipReader(io.BytesIO(raw), multi_member=False)
        results.append(np.frombuffer(r.read(), dtype=np.uint8))
    return results
