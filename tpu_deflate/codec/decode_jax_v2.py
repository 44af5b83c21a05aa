"""Bit-parallel device decoder (v2): stage A is elementwise XLA, the two
serial cursor walks are ``lax.scan`` loops over tiles, and the rest is
plain XLA.

- **Stage A** (tile-native layout): speculative decode of a complete
  symbol group at every bit position, built from a (64, NT) tile-major
  byte grid so the outputs land directly in a (bit, tile) layout.
  Payload bytes are bit-reversed so windows are MSB-first, and each
  Huffman decode is a *bounds ladder* (:func:`_ladder_decode`): one
  saturated uint32 compare plus one packed accumulate per candidate
  length yields the code length and canonical index (≙ the reference's
  ``codeLengthsToCodeTree`` walk, ``decomp/Open.java:705-756``, restated
  as closed-form range checks over the canonical code space). The only
  table lookup left is a packed *descriptor* by canonical index (class |
  extra-bit count | literal-byte-or-run-base, precomputed on host),
  closed-form bit planes for match and distance symbols. Full 15-bit
  code-length range of RFC 1951, no 2^15 LUT.
- **Stage B**: per-tile transfer functions. Chains enter a tile only in
  its first 48 bits (the max bits of one symbol group); 48 cursors per
  tile advance in lock step over the tile's bit positions and end as an
  exit offset into the next tile or at the EOB/error sentinels; a
  ``lax.scan`` walks 64-bit tiles.
- **Stage C** (associative scan over tiles): transfer functions compose
  by a 48-wide gather — the true entry offset of every tile, and the
  stream's terminal state (clean EOB / error / ran-off-end).
- **Stage D**: one cursor per tile replays the true chain, giving the
  reached positions; token info (computed in stage A for every
  position) is masked to reached positions and compacted by log-shift
  displacement moves.
- **Stage E**: reductions that surface the terminal facts — EOB exit bit
  (for multi-block chaining), the first-reached error's Reason code
  (stream-order precedence is baked into stage A's per-position code),
  and the exact output size.
- **Resolve**: compacted tokens resolve to bytes on the device
  (``resolve_jax``) or go to the native C runtime's
  ``td_resolve_tokens``, or a NumPy fallback. Window continuity across
  blocks is automatic because a member's blocks resolve as one token
  stream.

Block chaining: the host driver walks block headers (stored blocks are a
host memcpy emitted as literal tokens), dispatching each wave of Huffman
block bodies across lanes as one batched device call — so multi-block /
continuous-history members (the encoder's effort>=4 output) decode on
device with no host fallback (≙ the reference's block loop,
``decomp/Open.java:83-110``).

Error taxonomy parity: stage A orders each position's failure exactly as
the reference's serial reads would hit them (truncated-litlen-code,
reserved length symbol, truncated run bits, empty distance code,
truncated distance code, reserved distance symbol, truncated distance
bits — trigger sites ``decomp/Open.java:516-593``); the replayed chain
reaches at most one error position, whose code is the raised Reason.
Differentially tested against the host state machine and the transcribed
reference conformance vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import backend, jax_setup  # noqa: F401
from ..format.errors import DataFormatError, Reason, reason_to_code

W_TILE_P = 512  # stage A layout unit: bits per tile column
W_TILE = 64  # bits per tile in the stage B/D scans (minimizes scan overhead)
ENTRY_WIN = 48  # max bits one symbol group consumes (15+5+15+13)
MAX_CODE_LEN = 15  # full RFC 1951 range
# In-band uint8 delta sentinels: normal advances are 1..48; cursor ranges
# stay disjoint through stage B's int16 arithmetic (normal exits land in
# [64, 111], EOB in [127, 190], ERR in [255, 318]).
SENT_EOB = 127
SENT_ERR = 255
SCAN_UNROLL = 8

# Two-level token compaction: tiles of T1 positions keep their first K1
# tokens (level 1, int16 displacements), then one global pass runs on the
# K1/T1-condensed array. A tile with more than K1 chain tokens (avg
# symbol < T1/K1 bits — degenerate short-code streams only) sets the
# overflow flag and the driver reruns the wave with the single-level
# fallback.
COMPACT_T1 = 512
COMPACT_K1 = 160

V2_LANE_BATCH = 256  # per-batch overhead (host parse, uploads) amortizes
V2_L_BUCKETS = (4, 16, 64, V2_LANE_BATCH)
_P_BUCKETS = (8320, 33280, 39936, 66560, 266240)
PAYLOAD_PAD = _P_BUCKETS[-1]
# Cap on padded lanes x payload bytes per device dispatch: stage A holds a
# handful of (L, P*8) int32 intermediates, so 16 MiB of payload keeps the
# live set well under HBM even with the compaction arrays resident.
WAVE_BYTES_CAP = 16 << 20

_ERR_END = reason_to_code(Reason.UNEXPECTED_END_OF_STREAM)
_ERR_RESERVED_LEN = reason_to_code(Reason.RESERVED_LENGTH_SYMBOL)
_ERR_RESERVED_DIST = reason_to_code(Reason.RESERVED_DISTANCE_SYMBOL)
_ERR_EMPTY_DIST = reason_to_code(Reason.LENGTH_ENCOUNTERED_WITH_EMPTY_DISTANCE_CODE)

TOKEN_MATCH_BIT = 1 << 26

# Minimal valid payload for padding lanes: a final fixed-Huffman block that
# is immediately end-of-block (bits: bfinal=1, btype=01, EOB 0000000).
_PAD_PAYLOAD = bytes([0x03, 0x00])

def _bucket(value: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


# ---------------------------------------------------------------------------
# Host: canonical decode tables (first_code / base_index / sorted symbols)
# ---------------------------------------------------------------------------


def canonical_tables(lengths: np.ndarray, max_len: int = MAX_CODE_LEN) -> dict:
    """(L, N) code lengths -> canonical range-decode tables per lane.

    first[l] = canonical first code of length l; base[l] = canonical index
    of the first length-l symbol; count[l] = #symbols of length l;
    syms[i] = symbol with canonical index i (sorted by (length, symbol),
    zero-length symbols pushed past the end). ≙ the canonical assignment
    of ``comp/Lz77Huffman.java:372-391`` viewed from the decode side.
    """
    L, N = lengths.shape
    counts = np.zeros((L, max_len + 1), np.int64)
    for l in range(1, max_len + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    first = np.zeros((L, max_len + 1), np.int64)
    base = np.zeros((L, max_len + 1), np.int64)
    code = np.zeros(L, np.int64)
    cum = np.zeros(L, np.int64)
    for l in range(1, max_len + 1):
        code = (code + counts[:, l - 1]) << 1
        first[:, l] = code
        base[:, l] = cum
        cum = cum + counts[:, l]
    key = np.where(lengths > 0, lengths, max_len + 1) * (N + 1) + np.arange(N)[None, :]
    order = np.argsort(key, axis=1, kind="stable")
    return {
        "first": first.astype(np.int32),
        "base": base.astype(np.int32),
        "count": counts.astype(np.int32),
        "syms": order.astype(np.int32),
    }


def ladder_tables(tables: dict) -> dict:
    """Canonical tables -> the bounds-ladder form the device decoder uses.

    The device decodes a code from a 32-bit *reversed* window v (stream
    bit p at bit 31, i.e. codes MSB-first) in one comparison ladder:

        len(v) = 1 + #{l in 1..14 : v >= bound[l]}
        idx(v) = (v >> (32 - len)) + base[len] - first[len]

    where bound[l] = (first[l] + count[l]) << (32 - l) is the exclusive
    upper bound of length-l codes left-aligned in 32-bit space (monotone
    by the canonical recurrence first[l+1] = (first[l]+count[l]) << 1, ≙
    the tree walk of ``decomp/Open.java:705-756`` as closed-form range
    checks). Returned arrays:

    - ``sat``  (L, 16) uint32: bound[l] saturated to 2**32-1;
    - ``pack`` (L, 16) int32: per-ladder-step accumulator summand
      ``(off[l+1]-off[l] + 2**16) + 2**20`` with off[l] = base[l]-first[l]
      — the low 20 bits accumulate the canonical-index offset (biased;
      off deltas are -(first[l]+count[l]) in [-2**15, 0]), bits 20+ count
      the steps taken (= len-1). Where bound[l] == 2**32 (code space
      complete at l) pack is 0, so the saturated compare can spuriously
      fire at v == 2**32-1 and still contribute nothing — no per-step
      "full" masking needed;
    - ``nlive`` (L,) int32: total live codes; a decoded idx >= nlive is
      exactly an over-range prefix (invalid code in an incomplete tree).
    """
    first = tables["first"].astype(np.int64)
    count = tables["count"].astype(np.int64)
    base = tables["base"].astype(np.int64)
    L, C = first.shape
    sat = np.zeros((L, 16), np.uint32)
    pack = np.zeros((L, 16), np.int32)
    off = base - first  # off[l] valid for l >= 1
    for l in range(1, 15):
        bound = (first[:, l] + count[:, l]) << (32 - l)
        full = bound >= (1 << 32)
        sat[:, l] = np.minimum(bound, (1 << 32) - 1).astype(np.uint32)
        doff = off[:, l + 1] - off[:, l]
        pack[:, l] = np.where(full, 0, (doff + (1 << 16)) + (1 << 20)).astype(np.int32)
    nlive = (base[:, 15] + count[:, 15]).astype(np.int32)
    return {"sat": sat, "pack": pack, "nlive": nlive}


ACC_BIAS = 1 << 12  # per-step bias keeping both 16-bit acc halves positive


def class_ladder_tables(lengths: np.ndarray, tables: dict) -> dict:
    """Litlen class/rank tables for the threshold-ladder decode.

    The old design looked up a 13-bit descriptor per canonical index
    (class | extra-bit count | literal-byte-or-run-base) — a 10-word
    select chain per bit plane, the dominant VPU cost of stage A. This
    build exploits the canonical order instead: within one code-length
    group, symbols sort ascending, so literals (0..255), the EOB (256),
    matches (257..285) and reserved symbols (286/287) occupy contiguous
    runs whose boundaries are per-length *thresholds* on the canonical
    index. Two extra packed accumulators ride the existing bounds ladder
    (sharing its compare), yielding per position:

    - ``acc2``: lit_end (hi16) | res_start (lo16) — class thresholds;
    - ``acc3``: lit_off (hi16) | mrank_off (lo16) — rank rebases, where
      lit_rank = idx + lit_off is the symbol's rank among all literals in
      canonical order, and mrank = idx + mrank_off its rank among match
      symbols (< 29, so match descriptors live in single 32-bit plane
      words). Each half is stored biased by ACC_BIAS per ladder step so
      it stays positive; the kernel subtracts ``len << 12`` to decode.

    Literal tokens then carry lit_rank; :func:`apply_lit_map` maps rank
    to byte after compaction (~20% of positions) via one int8 one-hot
    dot, so the emitted token stream is unchanged.
    ≙ the symbol classification of ``decomp/Open.java:479-563`` restated
    as canonical-order range checks.
    """
    from ..format.tables import LENGTH_BASE, LENGTH_EXTRA

    L, N = lengths.shape
    first = tables["first"].astype(np.int64)
    count = tables["count"].astype(np.int64)
    base = tables["base"].astype(np.int64)
    nlive = (base[:, 15] + count[:, 15]).astype(np.int64)
    syms = tables["syms"]

    sym_ids = np.arange(N)[None, :]
    nlit = np.zeros((L, 16), np.int64)
    neob = np.zeros((L, 16), np.int64)
    nm = np.zeros((L, 16), np.int64)
    for l in range(1, 16):
        at = lengths == l
        nlit[:, l] = (at & (sym_ids < 256)).sum(axis=1)
        neob[:, l] = (at & (sym_ids == 256)).sum(axis=1)
        nm[:, l] = (at & (sym_ids >= 257) & (sym_ids <= 285)).sum(axis=1)
    cum_lit = np.cumsum(nlit, axis=1) - nlit  # literals with shorter length
    cum_m = np.cumsum(nm, axis=1) - nm

    lit_end = base + nlit
    res_start = base + nlit + neob + nm
    lit_off = cum_lit - base
    mrank_off = cum_m - (base + nlit + neob)

    l256 = lengths[:, 256].astype(np.int64) if N > 256 else np.zeros(L, np.int64)
    rows = np.arange(L)
    eob_cidx = np.where(
        l256 > 0, base[rows, l256] + nlit[rows, l256], np.int64(-(1 << 20))
    ).astype(np.int32)

    def pack_pair(hi: np.ndarray, lo: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-length (hi, lo) value pair -> (pack (L,16) int32, init (L,))."""
        pack = np.zeros((L, 16), np.int32)
        for l in range(1, 15):
            bound = (first[:, l] + count[:, l]) << (32 - l)
            full = bound >= (1 << 32)
            dhi = hi[:, l + 1] - hi[:, l] + ACC_BIAS
            dlo = lo[:, l + 1] - lo[:, l] + ACC_BIAS
            pack[:, l] = np.where(full, 0, (dhi << 16) + dlo).astype(np.int32)
        init = ((hi[:, 1] + ACC_BIAS) << 16) + (lo[:, 1] + ACC_BIAS)
        return pack, init.astype(np.int32)

    pack2, init2 = pack_pair(lit_end, res_start)
    pack3, init3 = pack_pair(lit_off, mrank_off)

    # Canonical ranks over the sorted symbol array.
    pos_valid = np.arange(N)[None, :] < nlive[:, None]
    is_m = (syms >= 257) & (syms <= 285) & pos_valid
    is_l = (syms < 256) & pos_valid
    mrank_arr = np.cumsum(is_m, axis=1) - 1
    lrank_arr = np.cumsum(is_l, axis=1) - 1

    # Match descriptors by match rank: run_bits(3b) | (run_base-3)(8b)<<3,
    # bit-sliced into 11 single plane words (<= 29 match symbols).
    mi = np.clip(syms - 257, 0, 28)
    mdesc = (LENGTH_EXTRA[mi] | ((LENGTH_BASE[mi] - 3) << 3)).astype(np.int64)
    mwords = np.zeros((L, 11), np.int64)
    for b in range(11):
        bit = ((mdesc >> b) & 1) & is_m
        mwords[:, b] = (bit.astype(np.int64) << np.clip(mrank_arr, 0, 31)).sum(axis=1)
    # Literal rank -> byte map, (L, 256) in the (L, 64, 8) int8 dot form.
    lit_map = np.zeros((L, 256), np.uint8)
    li, lj = np.nonzero(is_l)
    lit_map[li, lrank_arr[li, lj]] = syms[li, lj]
    grid = lit_map.reshape(L, 4, 64).transpose(0, 2, 1)  # (L, 64, 4)
    lit_map8 = np.concatenate(
        [(grid & 127).astype(np.int8), (grid >> 7).astype(np.int8)], axis=2
    )
    return {
        "pack2": pack2,
        "init2": init2,
        "pack3": pack3,
        "init3": init3,
        "eob_cidx": eob_cidx,
        "mwords": mwords.astype(np.int32),
        "lit_map8": lit_map8,
    }


def dist_perm_words(syms32: np.ndarray) -> np.ndarray:
    """(L, 32) sorted distance symbols -> (L, 5) int32 bit-plane words.

    Plane b, bit j = bit b of (symbol at canonical index j, clipped to
    31). The kernel recovers the 5-bit symbol s and derives everything
    in closed form: dist_bits = max(0, (s>>1)-1); dist_base-1 = s for
    s < 4 else (2+(s&1)) << dist_bits; reserved = s >= 30 — the
    ``decomp/Open.java:843-886`` distance tables as arithmetic.
    """
    s = np.clip(syms32, 0, 31).astype(np.int64)
    words = np.zeros((s.shape[0], 5), np.int64)
    j = np.arange(32)[None, :]
    for b in range(5):
        words[:, b] = (((s >> b) & 1) << j).sum(axis=1)
    return words.astype(np.int32)


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------


def _lane_bc(v: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """(L,) per-lane scalar -> broadcastable against an (L, ...) array."""
    return v.reshape(v.shape[:1] + (1,) * (ndim - 1))


def _ladder_decode(v, sat, pack, nlive):
    """Canonical bounds-ladder decode at every position.

    v (L, ...) uint32 *reversed* windows (stream bit at MSB); sat/pack
    (L, 16) and nlive (L,) from :func:`ladder_tables`. Returns
    (code_len, canonical_index, found), all shaped like v — three
    elementwise ops per candidate length, no gathers.
    """
    nd = v.ndim
    acc = jnp.zeros(v.shape, jnp.int32)
    for l in range(1, MAX_CODE_LEN):
        ge = v >= _lane_bc(sat[:, l], nd)
        acc = jnp.where(ge, acc + _lane_bc(pack[:, l], nd), acc)
    cnt = acc >> 20
    ln = 1 + cnt
    off = (acc & 0xFFFFF) - (cnt << 16)
    c = (v >> (31 - cnt).astype(jnp.uint32)).astype(jnp.int32)
    idx = c + off
    found = idx < _lane_bc(nlive, nd)
    return ln, idx, found


def _ladder_decode3(v, sat, pack, pack2, init2, pack3, init3, nlive):
    """Bounds-ladder decode with two extra class/rank accumulators.

    Same compare schedule as :func:`_ladder_decode`; acc2/acc3 (from
    :func:`class_ladder_tables`) ride the shared ``ge`` for +2 ops per
    step each. Returns (code_len, canonical_index, found, lit_end,
    res_start, lit_off, mrank_off) shaped like v.
    """
    nd = v.ndim
    acc = jnp.zeros(v.shape, jnp.int32)
    acc2 = jnp.broadcast_to(_lane_bc(init2, nd), v.shape)
    acc3 = jnp.broadcast_to(_lane_bc(init3, nd), v.shape)
    for l in range(1, MAX_CODE_LEN):
        ge = v >= _lane_bc(sat[:, l], nd)
        acc = jnp.where(ge, acc + _lane_bc(pack[:, l], nd), acc)
        acc2 = jnp.where(ge, acc2 + _lane_bc(pack2[:, l], nd), acc2)
        acc3 = jnp.where(ge, acc3 + _lane_bc(pack3[:, l], nd), acc3)
    cnt = acc >> 20
    ln = 1 + cnt
    off = (acc & 0xFFFFF) - (cnt << 16)
    c = (v >> (31 - cnt).astype(jnp.uint32)).astype(jnp.int32)
    idx = c + off
    found = idx < _lane_bc(nlive, nd)
    lnb = ln << 12  # ACC_BIAS * ln
    lit_end = ((acc2 >> 16) & 0xFFFF) - lnb
    res_start = (acc2 & 0xFFFF) - lnb
    lit_off = ((acc3 >> 16) & 0xFFFF) - lnb
    mrank_off = (acc3 & 0xFFFF) - lnb
    return ln, idx, found, lit_end, res_start, lit_off, mrank_off


def _rev_bits16(x, k):
    """Reverse the low ``k`` bits of x (int32, x < 2**16, k <= 16)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> (16 - k)


def apply_lit_map(tokens: jnp.ndarray, lit_map8: jnp.ndarray) -> jnp.ndarray:
    """Map literal-rank tokens to literal bytes (post-compaction).

    tokens (L, K) int32 with literal entries = canonical literal rank in
    [0, 256); lit_map8 (L, 64, 8) int8 split table (cols 0-3 = byte&127
    for the 4 rank/64 groups, 4-7 = byte>>7). One int8 one-hot dot
    at compacted volume (~20% of bit positions) restores the byte, so
    the emitted token stream matches the old full-descriptor design
    bit-for-bit. Match (bit 26), EOB and error tokens pass through.
    """
    L, K = tokens.shape
    is_l = (tokens >= 0) & (tokens < 256)
    idx = jnp.where(is_l, tokens, 0)
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, (L, K, 64), 2) == (idx & 63)[..., None]
    ).astype(jnp.int8)
    rows = jax.lax.dot_general(
        oh, lit_map8, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.int32
    )  # (L, K, 8)
    hi2 = idx >> 6
    lo7 = jnp.zeros_like(idx)
    hi1 = jnp.zeros_like(idx)
    for g in range(4):
        lo7 = jnp.where(hi2 == g, rows[..., g], lo7)
        hi1 = jnp.where(hi2 == g, rows[..., 4 + g], hi1)
    return jnp.where(is_l, lo7 | (hi1 << 7), tokens)


def apply_lit_map_chunked(tokens: jnp.ndarray, lit_map8: jnp.ndarray) -> jnp.ndarray:
    """:func:`apply_lit_map` with the K axis processed in 2048-column
    chunks under a scan so the one-hot never materializes more than
    (L, 2048, 64) int8 at once."""
    L, K = tokens.shape
    C = 2048
    if K <= C or K % C:
        return apply_lit_map(tokens, lit_map8)
    xs = jnp.moveaxis(tokens.reshape(L, K // C, C), 1, 0)

    def chunk(_, t):
        return None, apply_lit_map(t, lit_map8)

    _, ys = jax.lax.scan(chunk, None, xs)
    return jnp.moveaxis(ys, 0, 1).reshape(L, K)


@jax.jit
def stage_a(
    grid: jnp.ndarray,  # (L, 64, NT+1) uint8 tile-major byte grid
    payload_bits: jnp.ndarray,  # (L,) int32 valid bits per lane
    ll_sat: jnp.ndarray,  # (L, 16) uint32 litlen ladder bounds
    ll_pack: jnp.ndarray,  # (L, 16) int32 litlen ladder summands
    ll_pack2: jnp.ndarray,  # (L, 16) int32 class-threshold summands
    ll_init2: jnp.ndarray,  # (L,) int32
    ll_pack3: jnp.ndarray,  # (L, 16) int32 rank-offset summands
    ll_init3: jnp.ndarray,  # (L,) int32
    ll_eob: jnp.ndarray,  # (L,) int32 canonical index of symbol 256
    ll_nlive: jnp.ndarray,  # (L,) int32 live litlen codes
    ll_mwords: jnp.ndarray,  # (L, 11) int32 match-descriptor plane words
    d_sat: jnp.ndarray,  # (L, 16) uint32 distance ladder bounds
    d_pack: jnp.ndarray,  # (L, 16) int32 distance ladder summands
    d_nlive: jnp.ndarray,  # (L,) int32 live distance codes
    d_perm: jnp.ndarray,  # (L, 5) int32 distance-symbol plane words
    dist_empty: jnp.ndarray,  # (L,) bool
):
    """Per-bit-position speculative decode, tile-native layout.

    ``grid[l, b, t]`` is byte ``t*64 + b`` of lane l's payload (the block
    body starts inside byte 0); column NT is the zero tile past the end.
    Bit position p = t*512 + s lives at [:, s, t] of every produced
    array.

    The payload bytes are bit-reversed on device (3 shift/mask stages on
    the small byte grid) so every window is MSB-first and both Huffman
    decodes run as bounds ladders; symbol classification and match/
    literal ranks ride the same ladder as packed accumulators
    (:func:`class_ladder_tables`), match run parameters come from 11
    single-word bit planes over the match rank, and distance parameters
    from a 5-plane symbol permutation plus RFC 1951 closed forms — no
    multi-word descriptor selects anywhere.

    Returns (delta, token), both (L, 512, NT) int32:
    - delta: bits consumed by the symbol group at each position (1..48),
      or SENT_EOB (127) / SENT_ERR (255);
    - token: literal *rank* in [0,256) (:func:`apply_lit_map` restores
      the byte after compaction); TOKEN_MATCH_BIT|run<<16|(dist-1)
      for matches; -(1+eob_code_len) at EOB positions (stage E recovers
      the exit bit for block chaining); -(100+reason_code) at error
      positions, precedence-ordered exactly as the reference's serial
      reads would trip (``decomp/Open.java:516-593``).
    """
    L, WB, NTp = grid.shape
    assert WB == 64
    NT = NTp - 1
    g = grid
    g = ((g & 0x55) << 1) | ((g >> 1) & 0x55)
    g = ((g & 0x33) << 2) | ((g >> 2) & 0x33)
    g32 = (g.astype(jnp.uint32) & 0x0F) << 4 | (g.astype(jnp.uint32) >> 4)

    def brow(k: int) -> jnp.ndarray:
        """(L, 64, NT) uint32: reversed byte (s//8 + k) of tile t, row-level."""
        a = g32[:, k:, :NT]
        if k:
            a = jnp.concatenate([a, g32[:, :k, 1 : NT + 1]], axis=1)
        return a

    # Assemble the byte-aligned 32-bit words at row granularity (1/8 the
    # elements), then repeat — the per-bit arrays stay few and fused.
    b = [brow(k) for k in range(9)]
    u32a = jnp.repeat((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3], 8, axis=1)
    u32b = jnp.repeat((b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7], 8, axis=1)
    b4 = jnp.repeat(b[4], 8, axis=1)
    b8 = jnp.repeat(b[8], 8, axis=1)
    r = jax.lax.broadcasted_iota(jnp.uint32, (1, W_TILE_P, 1), 1) & 7
    # Reversed windows: stream bit p at bit 31 of vR, p+32 at bit 31 of vR2.
    vR = (u32a << r) | (b4 >> (8 - r))
    vR2 = (u32b << r) | (b8 >> (8 - r))

    ln, lidx, lfound, lit_end, res_start, lit_off, mrank_off = _ladder_decode3(
        vR, ll_sat, ll_pack, ll_pack2, ll_init2, ll_pack3, ll_init3, ll_nlive
    )
    nd = lidx.ndim
    is_lit = lfound & (lidx < lit_end)
    is_eob = lfound & (lidx == _lane_bc(ll_eob, nd))
    reserved_len = lfound & (lidx >= res_start)
    is_match = lfound & ~is_lit & ~is_eob & ~reserved_len

    lit_rank = lidx + lit_off
    mrank = ((lidx + mrank_off) & 31).astype(jnp.uint32)
    mdesc = jnp.zeros(lidx.shape, jnp.int32)
    for bbit in range(11):
        mdesc = mdesc | (
            ((_lane_bc(ll_mwords[:, bbit], nd).astype(jnp.uint32) >> mrank) & 1) << bbit
        ).astype(jnp.int32)
    run_bits = jnp.where(is_match, mdesc & 7, 0)
    pay = mdesc >> 3  # run_base - 3

    rev = (vR >> (32 - ln - run_bits).astype(jnp.uint32)).astype(jnp.int32)
    run = (pay + 3) + _rev_bits16(rev & ((1 << run_bits) - 1), run_bits)
    d1 = ln + run_bits  # bits before the dist code

    # Follow window: pure elementwise splice of the two reversed windows
    # (1 <= d1 <= 20, so >= 44 valid bits remain after the splice).
    d1u = d1.astype(jnp.uint32)
    vD = (vR << d1u) | (vR2 >> (32 - d1u))

    dln, didx, dfound = _ladder_decode(vD, d_sat, d_pack, d_nlive)
    d5 = (jnp.maximum(didx, 0) & 31).astype(jnp.uint32)
    ds = jnp.zeros(didx.shape, jnp.int32)
    for bbit in range(5):
        ds = ds | (
            ((_lane_bc(d_perm[:, bbit], nd).astype(jnp.uint32) >> d5) & 1) << bbit
        ).astype(jnp.int32)
    dist_bits = jnp.maximum((ds >> 1) - 1, 0)
    reserved_dist = ds >= 30
    dbase_m1 = jnp.where(ds < 4, ds, (2 + (ds & 1)) << dist_bits)
    drev = (vD >> (32 - dln - dist_bits).astype(jnp.uint32)).astype(jnp.int32)
    dist = dbase_m1 + 1 + _rev_bits16(drev & ((1 << dist_bits) - 1), dist_bits)

    pos = jax.lax.broadcasted_iota(jnp.int32, (1, W_TILE_P, 1), 1) + W_TILE_P * (
        jax.lax.broadcasted_iota(jnp.int32, (1, 1, NT), 2)
    )
    bits = _lane_bc(payload_bits, 3)
    end_len = pos + ln
    end_run = end_len + run_bits  # run_bits is 0 outside match positions
    end_dcode = end_run + dln
    end_all = end_dcode + dist_bits

    # Reference-ordered per-position error classification.
    errc = jnp.zeros((L, W_TILE_P, NT), jnp.int32)

    def _set(errc, cond, code):
        return jnp.where((errc == 0) & cond, code, errc)

    errc = _set(errc, ~lfound, _ERR_END)  # safety: incomplete code (validated away)
    errc = _set(errc, end_len > bits, _ERR_END)
    errc = _set(errc, reserved_len, _ERR_RESERVED_LEN)
    errc = _set(errc, is_match & (end_run > bits), _ERR_END)
    errc = _set(errc, is_match & _lane_bc(dist_empty, 3), _ERR_EMPTY_DIST)
    errc = _set(errc, is_match & ~dfound, _ERR_END)
    errc = _set(errc, is_match & (end_dcode > bits), _ERR_END)
    errc = _set(errc, is_match & reserved_dist, _ERR_RESERVED_DIST)
    errc = _set(errc, is_match & (end_all > bits), _ERR_END)

    adv = jnp.where(is_match, end_all, end_len) - pos
    delta = jnp.where(errc != 0, SENT_ERR, jnp.where(is_eob, SENT_EOB, adv))

    token = jnp.where(
        is_lit,
        lit_rank,
        TOKEN_MATCH_BIT | (jnp.clip(run, 3, 258) << 16) | jnp.clip(dist - 1, 0, 65535),
    )
    token = jnp.where(is_eob, -(1 + ln), token)
    token = jnp.where(errc != 0, -(100 + errc), token)
    return delta, token


@jax.jit
def stage_b_transfers(delta_tiles: jnp.ndarray):
    """delta_tiles (L, NT, W) uint8 -> transfers (L, NT, ENTRY_WIN) uint8.

    transfer[e] = exit offset into the next tile in [0, ENTRY_WIN), or
    SENT_EOB / SENT_ERR. ENTRY_WIN cursors advance in lock-step over the
    W tile bit positions in int16 (cursor ranges stay disjoint: normal
    exits [W, W+47], EOB [127, 190], ERR [255, 318]); a cursor that
    jumps past W-1 freezes (steps only fire for s < W).
    """
    L, NT, W = delta_tiles.shape
    xs = jnp.moveaxis(delta_tiles, 2, 0)  # (W, L, NT) uint8

    init = jnp.broadcast_to(
        jnp.arange(ENTRY_WIN, dtype=jnp.int16)[None, None, :], (L, NT, ENTRY_WIN)
    ).astype(jnp.int16)

    def step(cur, d_s):
        d, s = d_s
        at = cur == s
        adv = jnp.where(at, d.astype(jnp.int16)[:, :, None], jnp.int16(0))
        return cur + adv, None

    svals = jnp.arange(W, dtype=jnp.int16)
    cur, _ = jax.lax.scan(step, init, (xs, svals), unroll=SCAN_UNROLL)
    out = jnp.where(
        cur >= 255, jnp.int16(SENT_ERR), jnp.where(cur >= 127, jnp.int16(SENT_EOB), cur - W)
    )
    return out.astype(jnp.uint8)


@jax.jit
def stage_c_entries(transfers: jnp.ndarray, entry0: jnp.ndarray):
    """Compose transfers over tiles; entry offset of every tile + final state.

    transfers (L, NT, ENTRY_WIN) uint8; entry0 (L,) in [0, ENTRY_WIN).
    Returns entries (L, NT) uint8 (value in [0, ENTRY_WIN) or sentinel)
    and the final state (L,): SENT_EOB (clean), SENT_ERR (decode error),
    or a small offset (ran off the payload without EOB).

    Composing two transfer maps is one 48-wide gather per tile
    (``c[e] = a[e]`` if terminal else ``b[a[e]]``), under an associative
    scan over the tile axis.
    """
    E = transfers.shape[2]

    def compose(a, b):
        idx = jnp.minimum(a, E - 1).astype(jnp.int32)
        return jnp.where(a >= SENT_EOB, a, jnp.take_along_axis(b, idx, axis=-1))

    prefix = jax.lax.associative_scan(compose, transfers, axis=1)
    e0 = entry0.astype(jnp.int32)[:, None, None]
    applied = jnp.take_along_axis(prefix, jnp.broadcast_to(e0, prefix.shape[:2] + (1,)), axis=2)[..., 0]
    entries = jnp.concatenate([entry0.astype(jnp.uint8)[:, None], applied[:, :-1]], axis=1)
    return entries, applied[:, -1]


@jax.jit
def stage_d_reached(delta_tiles: jnp.ndarray, entries: jnp.ndarray):
    """Replay the true chain: one cursor per tile -> reached bitmap."""
    L, NT, W = delta_tiles.shape
    xs = jnp.moveaxis(delta_tiles, 2, 0)
    svals = jnp.arange(W, dtype=jnp.int16)
    cur0 = jnp.where(entries < ENTRY_WIN, entries, jnp.uint8(254)).astype(jnp.int16)

    def step(cur, d_s):
        d, s = d_s
        at = cur == s
        cur = cur + jnp.where(at, d.astype(jnp.int16), jnp.int16(0))
        return cur, at

    _, reached = jax.lax.scan(step, cur0, (xs, svals), unroll=SCAN_UNROLL)
    return jnp.moveaxis(reached, 0, 2)


@jax.jit
def stage_e_summary(
    delta: jnp.ndarray,  # (L, B) uint8
    token: jnp.ndarray,  # (L, B) int32
    reached: jnp.ndarray,  # (L, B) bool
):
    """Terminal facts of the replayed chain (all small reductions).

    Returns (has_eob, eob_exit_bit, err_code, out_total): the chain
    reaches at most one terminal position, so masked sums are exact.
    EOB code length and error Reason come out of the token encoding
    (-(1+len) / -(100+code)).
    """
    B = delta.shape[1]
    pos = jnp.arange(B, dtype=jnp.int32)[None, :]
    eob_hit = reached & (delta == SENT_EOB)
    has_eob = eob_hit.any(axis=1)
    eob_exit = jnp.sum(jnp.where(eob_hit, pos + (-token - 1), 0), axis=1)
    err_hit = reached & (delta == SENT_ERR)
    err_code = jnp.sum(jnp.where(err_hit, -token - 100, 0), axis=1)
    valid = reached & (delta < SENT_EOB)
    is_lit = valid & (token < 256)
    sizes = jnp.where(is_lit, 1, (token >> 16) & 0x3FF)
    out_total = jnp.sum(jnp.where(valid, sizes, 0), axis=1)
    return has_eob, eob_exit, err_code, out_total


def _shift_left_ax(arr: jnp.ndarray, d: int, fill, axis: int) -> jnp.ndarray:
    """arr[..., p] -> arr[..., p+d] with fill on the right along axis."""
    pad_shape = list(arr.shape)
    pad_shape[axis] = d
    pad = jnp.full(pad_shape, fill, dtype=arr.dtype)
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(d, None)
    return jnp.concatenate([arr[tuple(idx)], pad], axis=axis)


def _compact_rounds(tok, disp, nbits: int, axis: int):
    """Log-shift displacement moves (collision-free: D[p] = p - rank(p)
    is non-decreasing over valid items).

    Callers encode invalid slots as the disp dtype's minimum: its AND
    with any round's bit is 0, so the take/self tests need no separate
    validity compare, and stale tokens are left in place until the final
    disp == 0 fix-up (a slot holds a real token iff its disp reached 0).
    """
    inv = disp.dtype.type(np.iinfo(disp.dtype).min)
    for k in range(nbits):
        s = 1 << k
        d_right = _shift_left_ax(disp, s, inv, axis)
        t_right = _shift_left_ax(tok, s, -1, axis)
        take = (d_right & s) != 0
        self_moves = (disp & s) != 0
        disp = jnp.where(take, d_right - s, jnp.where(self_moves, inv, disp))
        tok = jnp.where(take, t_right, tok)
    return jnp.where(disp == 0, tok, -1), disp


@jax.jit
def compact_tokens(token: jnp.ndarray, valid: jnp.ndarray):
    """Two-level gather/scatter-free compaction of valid tokens.

    token (L, B) int32; valid (L, B) bool (caller excludes EOB/error
    positions). Level 1 compacts within COMPACT_T1-position tiles (int16
    displacements) and keeps COMPACT_K1 slots per tile; level 2 runs the
    same moves globally on the condensed array. Returns (tokens
    (L, B*K1/T1), counts (L,), overflow) — overflow set iff some tile
    had more than K1 chain tokens (rerun with compact_tokens_full).
    """
    L, B = token.shape
    T1, K1 = COMPACT_T1, COMPACT_K1
    NT1 = B // T1
    v = valid.reshape(L, NT1, T1)
    tok = jnp.where(valid, token, -1).reshape(L, NT1, T1)
    rank = jnp.cumsum(v.astype(jnp.int16), axis=2) - 1
    pos = jnp.arange(T1, dtype=jnp.int16)[None, None, :]
    disp = jnp.where(v, pos - rank, jnp.int16(np.iinfo(np.int16).min))
    tile_counts = rank[:, :, -1] + 1
    overflow = (tile_counts > K1).any()
    tok, _ = _compact_rounds(tok, disp, int(np.ceil(np.log2(T1))), axis=2)
    tok1 = tok[:, :, :K1].reshape(L, NT1 * K1)

    valid2 = tok1 >= 0
    rank2 = jnp.cumsum(valid2.astype(jnp.int32), axis=1) - 1
    pos2 = jnp.arange(NT1 * K1, dtype=jnp.int32)[None, :]
    disp2 = jnp.where(valid2, pos2 - rank2, np.iinfo(np.int32).min)
    tok2, _ = _compact_rounds(tok1, disp2, int(np.ceil(np.log2(NT1 * K1))), axis=1)
    counts = jnp.sum(valid, axis=1)
    return tok2, counts, overflow


@jax.jit
def compact_tokens_full(token: jnp.ndarray, valid: jnp.ndarray):
    """Single-level fallback compaction (any token density). Returns
    (tokens (L, B), counts (L,), overflow=False)."""
    L, B = token.shape
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    pos = jnp.arange(B, dtype=jnp.int32)[None, :]
    disp = jnp.where(valid, pos - rank, np.iinfo(np.int32).min)
    tok = jnp.where(valid, token, -1)
    tok, _ = _compact_rounds(tok, disp, int(np.ceil(np.log2(B))), axis=1)
    counts = jnp.sum(valid, axis=1)
    return tok, counts, jnp.asarray(False)


# ---------------------------------------------------------------------------
# Host driver: block-chained device decode of raw DEFLATE streams
# ---------------------------------------------------------------------------


W_CAP_INIT = 66560  # initial per-block device window (covers any 64 KiB block)


@dataclass
class LaneState:
    """Decode progress of one raw DEFLATE stream."""

    payload: bytes
    bitpos: int = 0
    done: bool = False
    err: int = 0  # Reason code (reason_to_code), 0 = ok
    tokens: list = field(default_factory=list)  # np.int32 arrays per block
    out_total: int = 0
    window: int = W_CAP_INIT  # device window bytes per block (grows on demand)

    @property
    def bits(self) -> int:
        return len(self.payload) * 8


def _read_bits_host(payload: bytes, bitpos: int, n: int) -> int:
    """Little-endian LSB-first bit read (host, tiny header peeks only)."""
    byte = bitpos >> 3
    chunk = int.from_bytes(payload[byte : byte + 8], "little")
    return (chunk >> (bitpos & 7)) & ((1 << n) - 1)


def _host_stored_block(st: LaneState, bfinal: bool) -> None:
    """Consume one stored block on the host (≙ Open.java:227-306)."""
    bp = (st.bitpos + 3 + 7) & ~7  # header + align to byte
    if bp + 32 > st.bits:
        st.err = _ERR_END
        return
    byte = bp >> 3
    ln = int.from_bytes(st.payload[byte : byte + 2], "little")
    nlen = int.from_bytes(st.payload[byte + 2 : byte + 4], "little")
    if ln != (nlen ^ 0xFFFF):
        st.err = reason_to_code(Reason.UNCOMPRESSED_BLOCK_LENGTH_MISMATCH)
        return
    if bp + 32 + 8 * ln > st.bits:
        # partial data still counts as output before the END error
        avail = (st.bits - bp - 32) // 8
        if avail > 0:
            data = np.frombuffer(st.payload, np.uint8, avail, byte + 4).astype(np.int32)
            st.tokens.append(data)
            st.out_total += avail
        st.err = _ERR_END
        return
    if ln:
        data = np.frombuffer(st.payload, np.uint8, ln, byte + 4).astype(np.int32)
        st.tokens.append(data)
        st.out_total += ln
    st.bitpos = bp + 32 + 8 * ln
    if bfinal:
        st.done = True


def _advance_host(st: LaneState):
    """Walk stored blocks / headers until a Huffman block (returns its
    (bfinal, btype)) or the lane is done/errored (returns None)."""
    while not (st.done or st.err):
        if st.bits - st.bitpos < 3:
            st.err = _ERR_END
            return None
        hdr = _read_bits_host(st.payload, st.bitpos, 3)
        bfinal, btype = hdr & 1, hdr >> 1
        if btype == 3:
            st.err = reason_to_code(Reason.RESERVED_BLOCK_TYPE)
            return None
        if btype == 0:
            st.bitpos += 0  # _host_stored_block accounts for the 3 bits
            _host_stored_block(st, bool(bfinal))
            continue
        return bfinal, btype
    return None


def decode_deflate_streams_v2(payloads: list[bytes], runner=None) -> list[LaneState]:
    """Decode raw DEFLATE streams (arbitrary block chains) on the device.

    Returns per-lane LaneStates with the token stream (stored-block bytes
    inlined as literal tokens, so LZ77 window continuity across blocks is
    preserved at resolve time), the exact output size, and the
    reference-taxonomy error code of the first failure (0 = clean).

    ``runner`` optionally replaces the single-device stage pipeline with a
    mesh-sharded one (``dist.sharded.sharded_decode``); it maps the wave
    input dict to the 7-tuple ``_run_wave_device`` returns.
    """
    assert len(payloads) <= V2_LANE_BATCH, "batch the lanes (V2_LANE_BATCH)"
    lanes = [LaneState(p) for p in payloads]
    while True:
        wave = []  # (lane, bfinal) whose next block is Huffman
        for st in lanes:
            nxt = _advance_host(st)
            if nxt is not None:
                wave.append((st, bool(nxt[0] & 1)))
        if not wave:
            break
        _decode_huffman_wave([st for st, _ in wave], runner)
        for st, bfinal in wave:
            if not st.err and bfinal and st.bitpos_advanced:
                st.done = True
    return lanes


def _lane_cap(P: int, lane_multiple: int) -> int:
    """Largest lane-bucket whose padded wave stays under WAVE_BYTES_CAP."""
    cap = max(WAVE_BYTES_CAP // max(P, 1), lane_multiple, V2_L_BUCKETS[0])
    pick = V2_L_BUCKETS[0]
    for b in V2_L_BUCKETS:
        if b <= cap:
            pick = b
    return pick


def _decode_huffman_wave(wave: list[LaneState], runner=None) -> None:
    """Batched device decode of each lane's current Huffman block.

    Lanes are grouped by padded-payload bucket before dispatch, so one
    oversized member does not inflate the padding (and stage-A memory) of
    every other lane in the wave; each group is further split to keep
    L x P under WAVE_BYTES_CAP.
    """
    if not wave:
        return
    for st in wave:
        st.bitpos_advanced = False
    lane_multiple = getattr(runner, "lane_multiple", 1)
    groups: dict[int, list[LaneState]] = {}
    for st in wave:
        avail = len(st.payload) - st.bitpos // 8
        groups.setdefault(_bucket(max(min(avail, st.window), 1), _P_BUCKETS), []).append(st)
    # Two phases: dispatch every subwave's device program first (uploads
    # and kernels of different subwaves overlap — the device queue stays
    # full), then pull and apply results.
    pending = []
    for P, grp in sorted(groups.items()):
        lmax = _lane_cap(P, lane_multiple)
        for base in range(0, len(grp), lmax):
            pend = _decode_huffman_subwave(grp[base : base + lmax], P, runner)
            if pend is not None:
                pending.append(pend)
    # Pipeline the device->host copies: start all small-vector copies,
    # then (reading each small) request every payload slice, then
    # consume — transfers stream back to back.
    for pend in pending:
        _async_to_host(pend[5])
    mids = [_apply_small(*pend) for pend in pending]
    for mid in mids:
        for arr in mid[3][1:]:
            _async_to_host(arr)
    for mid in mids:
        _apply_tokens(*mid)


def _decode_huffman_subwave(wave: list[LaneState], P: int, runner=None):
    """Dispatch one batched device decode over lanes sharing payload
    bucket P; returns the pending (un-pulled) result tuple."""
    from . import decode_jax as dj

    L_real = len(wave)
    L = _bucket(L_real, V2_L_BUCKETS)
    lane_multiple = getattr(runner, "lane_multiple", 1)
    if lane_multiple > 1:
        L = -(-L // lane_multiple) * lane_multiple
    shifts = [st.bitpos // 8 for st in wave]
    rems = [st.bitpos % 8 for st in wave]
    avail = [len(st.payload) - sh for st, sh in zip(wave, shifts)]
    remain = [min(a, st.window, P) for a, st in zip(avail, wave)]
    rows = np.zeros((L, P), np.uint8)
    row_bits = np.zeros(L, np.int64)
    start_bits = np.zeros(L, np.int64)
    for i, st in enumerate(wave):
        rows[i, : remain[i]] = np.frombuffer(st.payload, np.uint8, remain[i], shifts[i])
        row_bits[i] = remain[i] * 8
        start_bits[i] = rems[i]
    for i in range(L_real, L):
        rows[i, : len(_PAD_PAYLOAD)] = np.frombuffer(_PAD_PAYLOAD, np.uint8)
        row_bits[i] = len(_PAD_PAYLOAD) * 8
    truncated = [remain[i] < avail[i] for i in range(L_real)]

    # Batched header parse; on failure in a multi-lane batch, re-parse
    # lane-by-lane so the error lands on the right stream only.
    try:
        hp = dj.parse_headers_batch(rows, row_bits, start_bits=start_bits)
    except DataFormatError:
        for i, st in enumerate(wave):
            r = _reparse_single(rows[i : i + 1], row_bits[i : i + 1], start_bits[i : i + 1])
            if r is not None:
                st.err = reason_to_code(r)
        rest = [st for st in wave if not st.err]
        if len(rest) < len(wave):
            _decode_huffman_wave(rest, runner)
        return None

    return _dispatch_block_stages(wave, rows, row_bits, hp, truncated, runner)


def _reparse_single(rows, row_bits, start_bits):
    from . import decode_jax as dj

    try:
        dj.parse_headers_batch(rows, row_bits, start_bits=start_bits)
        return None
    except DataFormatError as e:
        return e.reason


def _byte_grid(shifted: np.ndarray) -> np.ndarray:
    """(L, P) payload rows -> (L, 64, NT+1) tile-major byte grid (host
    transpose of small uint8 data; the +1 column is the zero tile past
    the end so stage A's 9-byte lookahead never wraps)."""
    L, P = shifted.shape
    assert P % 64 == 0
    NT = P // 64
    grid = np.zeros((L, 64, NT + 1), np.uint8)
    grid[:, :, :NT] = shifted.reshape(L, NT, 64).transpose(0, 2, 1)
    return grid


def _wave_arrays(rows: np.ndarray, row_bits: np.ndarray, hp) -> tuple[dict, np.ndarray]:
    """Host prep shared by all drivers: byte-shift rows so the block body
    starts inside byte 0, build the tile-major byte grid, and build the
    canonical decode tables. Returns the wave input dict (numpy) and the
    per-lane byte shift."""
    L, P = rows.shape
    shift2 = (hp.body_bitpos // 8).astype(np.int64)
    rem2 = (hp.body_bitpos % 8).astype(np.int32)
    shifted = np.zeros_like(rows)
    for i in range(L):
        s = int(shift2[i])
        shifted[i, : P - s] = rows[i, s:]
    body_bits = (row_bits - shift2 * 8).astype(np.int32)
    llt = canonical_tables(hp.litlen_lengths)
    dt = canonical_tables(hp.dist_lengths)
    lad = ladder_tables(llt)
    dlad = ladder_tables(dt)
    cls = class_ladder_tables(hp.litlen_lengths, llt)
    w = {
        "grid": _byte_grid(shifted),
        "payload_bits": body_bits,
        "ll_sat": lad["sat"],
        "ll_pack": lad["pack"],
        "ll_pack2": cls["pack2"],
        "ll_init2": cls["init2"],
        "ll_pack3": cls["pack3"],
        "ll_init3": cls["init3"],
        "ll_eob": cls["eob_cidx"],
        "ll_nlive": lad["nlive"],
        "ll_mwords": cls["mwords"],
        "lit_map8": cls["lit_map8"],
        "d_sat": dlad["sat"],
        "d_pack": dlad["pack"],
        "d_nlive": dlad["nlive"],
        "d_perm": dist_perm_words(dt["syms"][:, :32]),
        "dist_empty": hp.dist_empty,
        "rem": rem2,
    }
    return w, shift2


#: Wave-dict array keys in canonical order (the sharded runner's schema).
WAVE_KEYS = (
    "grid", "payload_bits", "ll_sat", "ll_pack", "ll_pack2", "ll_init2",
    "ll_pack3", "ll_init3", "ll_eob", "ll_nlive", "ll_mwords", "lit_map8",
    "d_sat", "d_pack", "d_nlive", "d_perm", "dist_empty", "rem",
)


def _stage_a_wave(w: dict):
    """Run tiled stage A on a wave dict -> (delta_t, token_t) (L, 512, NT)."""
    return stage_a(
        w["grid"], w["payload_bits"],
        w["ll_sat"], w["ll_pack"], w["ll_pack2"], w["ll_init2"],
        w["ll_pack3"], w["ll_init3"], w["ll_eob"], w["ll_nlive"], w["ll_mwords"],
        w["d_sat"], w["d_pack"], w["d_nlive"], w["d_perm"], w["dist_empty"],
    )


def _stages_b_to_e(delta_t, token, rem):
    """Stages B-E: ``lax.scan`` cursor walks over 64-bit tiles.

    Returns (valid (L, B) bool, has_eob, eob_exit, err_code, out_total).
    """
    L, W, NT = delta_t.shape
    B = W * NT
    delta8 = delta_t.transpose(0, 2, 1).reshape(L, B).astype(jnp.uint8)
    delta_tiles = delta8.reshape(L, B // W_TILE, W_TILE)
    transfers = stage_b_transfers(delta_tiles)
    entries, _final = stage_c_entries(transfers, rem.astype(jnp.uint8))
    reached = stage_d_reached(delta_tiles, entries).reshape(L, B)
    has_eob, eob_exit, err_code, out_total = stage_e_summary(delta8, token, reached)
    return reached & (delta8 < SENT_EOB), has_eob, eob_exit, err_code, out_total


def _run_wave_device(w: dict, full_compact: bool = False):
    """Device stages A-E + compaction for one staged wave; returns device
    arrays (tokens, counts, has_eob, eob_exit, err_code, out_total,
    overflow)."""
    delta_t, token_t = _stage_a_wave(w)
    L, W, NT = delta_t.shape
    token = token_t.transpose(0, 2, 1).reshape(L, W * NT)
    valid, *summary = _stages_b_to_e(delta_t, token, w["rem"])
    if full_compact:
        tokens, counts, overflow = compact_tokens_full(token, valid)
    else:
        tokens, counts, overflow = compact_tokens(token, valid)
    tokens = apply_lit_map_chunked(tokens, w["lit_map8"])
    return (tokens, counts, *summary, overflow)


#: One wave as one jitted program.
_run_wave = jax.jit(_run_wave_device, static_argnames=("full_compact",))


def _run_wave_safe(w: dict):
    return _run_wave(w, full_compact=True)


@jax.jit
def _pack_small(counts, has_eob, eob_exit, err_code, out_total, overflow, nlit=None):
    """Stack a wave's scalar-per-lane results into one (7, L) array, so
    the apply phase fetches one array instead of seven."""
    L = counts.shape[0]
    if nlit is None:
        nlit = jnp.zeros((L,), jnp.int32)
    return jnp.stack(
        [
            counts.astype(jnp.int32),
            has_eob.astype(jnp.int32),
            eob_exit.astype(jnp.int32),
            err_code.astype(jnp.int32),
            out_total.astype(jnp.int32),
            jnp.broadcast_to(overflow.astype(jnp.int32), (L,)),
            nlit.astype(jnp.int32),
        ]
    )


@jax.jit
def _pack_tokens_jit(tokens: jnp.ndarray):
    """Split a wave's compacted token array for the pull to the host.

    The raw pull moves 4 bytes per token. Splitting literals (1 byte)
    from matches (4 bytes) plus a 1-bit order bitmap cuts the moved
    volume ~2-2.5x on literal-heavy streams.

    tokens (L, M) int32 front-compacted, -1 padding. Returns
    (bitmap (L, M/32) uint32 [bit k of word w = token 32w+k is literal],
    lit (L, M) uint8 compacted literal bytes, match (L, M) int32
    compacted match tokens, nlit (L,) int32).
    """
    L, M = tokens.shape
    is_lit = (tokens >= 0) & (tokens < 256)
    is_match = tokens >= 256
    lit_c, _, _ = compact_tokens_full(jnp.where(is_lit, tokens, -1), is_lit)
    match_c, _, _ = compact_tokens_full(jnp.where(is_match, tokens, -1), is_match)
    Mw = -(-M // 32)
    bits = jnp.pad(is_lit.astype(jnp.uint32), ((0, 0), (0, Mw * 32 - M)))
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bitmap = jnp.sum(bits.reshape(L, Mw, 32) << shifts, axis=2, dtype=jnp.uint32)
    nlit = jnp.sum(is_lit, axis=1)
    return bitmap, lit_c.astype(jnp.uint8), match_c, nlit


def _dispatch_block_stages(wave, rows, row_bits, hp, truncated, runner=None):
    """Issue one subwave's device program; no host synchronization."""
    w, shift2 = _wave_arrays(rows, row_bits, hp)
    tokens, *rest = (runner or _run_wave)(w)
    bitmap, lit8, match32, nlit = _pack_tokens_jit(tokens)
    small = _pack_small(*rest, nlit=nlit)
    return wave, shift2, truncated, w, (bitmap, lit8, match32), small, runner


def _async_to_host(arr) -> None:
    arr.copy_to_host_async()


def _round_cols(k: int, width: int, bucket: int) -> int:
    """Round a column request up to the pull bucket (0 stays 0)."""
    return min(width, -(-k // bucket) * bucket)


def _apply_small(wave, shift2, truncated, w, packed, small, runner=None):
    small_h = np.asarray(small)  # one pull for all per-lane vectors
    if small_h[5, 0]:
        # some tile exceeded the two-level compaction budget (degenerate
        # short-code stream): redo the wave with single-level compaction,
        # pulling the raw token array (rare path; volume is secondary).
        run_safe = getattr(runner, "safe", None) or _run_wave_safe
        tokens, counts, has_eob, eob_exit, err_code, out_total, _ovf = run_safe(w)
        small_h = np.asarray(
            _pack_small(counts, has_eob, eob_exit, err_code, out_total, _ovf)
        )
        kmax = int(small_h[0, : len(wave)].max()) if wave else 0
        k = _round_cols(max(kmax, 1), tokens.shape[1], 4096)
        return wave, shift2, truncated, ("raw", tokens[:, :k]), small_h
    # Request only the columns in use. Literals pull as 1 byte, matches
    # as 4, token order as a 1-bit bitmap.
    bitmap, lit8, match32 = packed
    n = len(wave)
    counts = small_h[0, :n]
    nlit = small_h[6, :n]
    kmax = int(counts.max()) if n else 0
    lk = _round_cols(int(nlit.max()) if n else 0, lit8.shape[1], 2048)
    mk = _round_cols(int((counts - nlit).max()) if n else 0, match32.shape[1], 2048)
    bk = _round_cols(-(-max(kmax, 1) // 32), bitmap.shape[1], 512)
    return (
        wave,
        shift2,
        truncated,
        ("packed", bitmap[:, :bk], lit8[:, :lk], match32[:, :mk]),
        small_h,
    )


def _apply_block_stages(wave, shift2, truncated, w, packed, small, runner=None) -> None:
    _apply_tokens(*_apply_small(wave, shift2, truncated, w, packed, small, runner))


def _lane_tokens(payload, small_h, i: int, count: int) -> np.ndarray:
    """Reconstruct lane i's int32 token stream from the pulled payload."""
    if payload[0] == "raw":
        return np.asarray(payload[1])[i, :count]
    bm, lit8, match32 = (np.asarray(a) for a in payload[1:])
    nl = int(small_h[6, i])
    words = bm[i, : -(-count // 32)].astype(np.uint32)
    bits = (
        ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
        .astype(bool)
        .ravel()[:count]
    )
    tok = np.empty(count, np.int32)
    tok[bits] = lit8[i, :nl].astype(np.int32)
    tok[~bits] = match32[i, : count - nl]
    return tok


def _apply_tokens(wave, shift2, truncated, payload, small_h) -> None:
    counts_h, has_eob_h, eob_exit_h, err_h, total_h = small_h[:5]

    for i, st in enumerate(wave):
        # A window-truncated row can only produce spurious
        # UNEXPECTED_END (overrun against the window edge) or a missing
        # EOB — grow the window and redo the block. Any other error, or
        # an EOB, is genuine regardless of truncation.
        if truncated[i] and not has_eob_h[i] and err_h[i] in (0, _ERR_END):
            st.window *= 4
            continue
        if counts_h[i]:
            st.tokens.append(_lane_tokens(payload, small_h, i, int(counts_h[i])))
            st.out_total += int(total_h[i])
        if err_h[i]:
            st.err = int(err_h[i])
        elif has_eob_h[i]:
            # global bit position just past this block's EOB symbol
            st.bitpos = (st.bitpos // 8 + int(shift2[i])) * 8 + int(eob_exit_h[i])
            st.bitpos_advanced = True
        else:
            # ran off the payload without reaching EOB
            st.err = _ERR_END


# ---------------------------------------------------------------------------
# Resolve + container integration
# ---------------------------------------------------------------------------


def _resolve_tokens_numpy(tokens: np.ndarray, count: int) -> bytes:
    """Fallback token expansion (native C is the fast path)."""
    out = bytearray()
    for k in range(count):
        t = int(tokens[k])
        if not t & TOKEN_MATCH_BIT:
            out.append(t & 0xFF)
            continue
        run = (t >> 16) & 0x3FF
        dist = (t & 0xFFFF) + 1
        if dist > len(out):
            raise _df(Reason.COPY_FROM_BEFORE_DICTIONARY_START)
        for _ in range(run):
            out.append(out[-dist])
    return bytes(out)


def _df(reason):
    return DataFormatError(reason, reason.name)


def _resolve_lane(st: LaneState):
    """Expand a lane's token stream; honors reference error ordering.

    A bad back-reference (COPY_FROM_BEFORE_DICTIONARY_START) occurs
    earlier in the stream than any pending stage error, so resolve runs
    first; the stage error is raised only if resolution succeeds. The
    whole stream resolves (the device counted its exact size), so the
    caller checks the trailer CRC before the size, as the host does.
    """
    tokens = (
        np.concatenate(st.tokens) if st.tokens else np.zeros(0, np.int32)
    ).astype(np.int32)
    want = st.out_total + 1
    try:
        from .. import native as _native

        have_native = _native.available()
    except Exception:
        have_native = False
    if have_native:
        from .. import native as _native
        from ..format.errors import OutputCapacityError

        try:
            out = _native.resolve_tokens(tokens, max(want, 1))
        except OutputCapacityError:
            raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH)
    else:
        out = _resolve_tokens_numpy(tokens, tokens.size)
    if st.err:
        from ..format.errors import check_device_error

        check_device_error(st.err)
    return out


def inflate_raw_v2(payload: bytes) -> bytes:
    """Decode one complete raw DEFLATE stream through the device pipeline.

    Raises DataFormatError with the reference taxonomy; used by the
    conformance suite to run the transcribed reference vectors against
    the device decoder.
    """
    st = decode_deflate_streams_v2([payload])[0]
    return _resolve_lane(st)


def _marginal_time(run_n, reps: int) -> tuple[float, float, str]:
    """Guarded marginal-pass timing: ((T(3) - T(1)) / 2) cancels the fixed
    per-call cost (dispatch, the final pull) that is not kernel work.
    Noise can invert the measurement (best t3 below 1.5*t1); when three
    attempts cannot produce a sane separation the SINGLE-PASS figure
    becomes the headline and the guard status says so — a floored
    marginal number is never published unmarked.

    Returns (headline_seconds, single_pass_seconds, "ok"|"floored").
    """
    t1 = t3 = 0.0
    for _attempt in range(3):
        t1 = min(run_n(1) for _ in range(reps))
        t3 = min(run_n(3) for _ in range(reps))
        if t3 > t1 * 1.5:
            return (t3 - t1) / 2, t1, "ok"
    return t1, t1, "floored"


def _prep_wave(payloads: list[bytes], lanes: int):
    """Host-side prep of one lane wave (header parse + canonical tables +
    byte-shifted rows) for single-block-per-member profile streams."""
    from . import decode_jax as dj

    L = _bucket(len(payloads), V2_L_BUCKETS) if lanes is None else lanes
    P = _bucket(max(len(p) for p in payloads), _P_BUCKETS)
    rows = np.zeros((L, P), np.uint8)
    row_bits = np.zeros(L, np.int64)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
        row_bits[i] = len(p) * 8
    for i in range(len(payloads), L):
        rows[i, : len(_PAD_PAYLOAD)] = np.frombuffer(_PAD_PAYLOAD, np.uint8)
        row_bits[i] = len(_PAD_PAYLOAD) * 8
    hp = dj.parse_headers_batch(rows, row_bits)
    w, _shift2 = _wave_arrays(rows, row_bits, hp)
    return w


def _wave_chunks(payloads: list[bytes], lanes: int = V2_LANE_BATCH):
    """Group single-block payloads into waves the way the engine driver
    does: by padded-payload bucket, each wave capped by lanes and by
    WAVE_BYTES_CAP. Returns [(payloads, padded lane count)], in an order
    callers rely on to map lanes back."""
    bygroup: dict[int, list] = {}
    for p in payloads:
        bygroup.setdefault(_bucket(len(p), _P_BUCKETS), []).append(p)
    out = []
    for P, grp in sorted(bygroup.items()):
        lmax = min(lanes, _lane_cap(P, 1))
        for base in range(0, len(grp), lmax):
            chunk = grp[base : base + lmax]
            out.append((chunk, _bucket(len(chunk), V2_L_BUCKETS)))
    return out


def kernel_only_bench(data: bytes, *, lanes: int = V2_LANE_BATCH, reps: int = 4) -> dict:
    """Device-kernel-only decode throughput (host transfers excluded).

    Compresses ``data`` to the member-profile stream, stages every wave's
    inputs in device memory (host prep and upload untimed), then times
    the device stages A-E + token compaction through the same runner the
    engine uses; a summed scalar pull at the end forces materialization.
    Reports throughput against both the
    uncompressed bytes represented by the decoded token streams and the
    compressed payload bytes scanned. Stored-block members (the encoder's
    fallback for incompressible lanes) are host memcpy work in every
    engine and are excluded from both totals, as are LZ77 token
    resolution (host memcpy) and the host<->device copies — this isolates
    how fast the chip runs the serial-bottleneck Huffman/token decode.
    """
    import time

    from . import decode_jax as dj

    try:
        from .. import native as _native

        gz = _native.compress_members_native(data)
    except Exception:
        from .profile import profile_compress_host

        gz = profile_compress_host(data)
    buf = np.frombuffer(gz, dtype=np.uint8)
    members = dj.split_members(buf)
    huff = [
        m
        for m in members
        if m.payload_start < buf.size and ((int(buf[m.payload_start]) >> 1) & 3) != 0
    ]
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in huff]
    isize_total = int(sum(m.isize for m in huff))
    payload_total = sum(len(p) for p in payloads)
    stored = len(members) - len(huff)

    run = _run_wave
    waves = [
        {k: jax.device_put(jnp.asarray(v)) for k, v in _prep_wave(chunk, n).items()}
        for chunk, n in _wave_chunks(payloads, lanes)
    ]
    # Force staging before the clock starts.
    force = sum(jnp.sum(w["grid"].astype(jnp.int32)) for w in waves)
    np.asarray(force)

    def run_pass():
        acc = jnp.zeros((), jnp.int32)
        for w in waves:
            tokens, counts, has_eob, eob_exit, err_code, out_total, ovf = run(w)
            acc = acc + jnp.sum(out_total)
            acc = acc + jnp.sum(tokens[:, :: max(1, tokens.shape[1] // 64)])
            acc = acc + jnp.sum(counts) + jnp.sum(err_code) + ovf.astype(jnp.int32)
        return acc

    def run_n(n: int) -> float:
        t0 = time.monotonic()
        acc = jnp.zeros((), jnp.int32)
        for _ in range(n):
            acc = acc + run_pass()
        np.asarray(acc)  # single pull forces every dispatched pass
        return time.monotonic() - t0

    run_n(1)  # compile + warm
    best, t1, guard = _marginal_time(run_n, reps)

    return {
        "decode_gbps_single_pass": round(isize_total / t1 / 1e9, 4),
        "lanes": lanes,
        "members": len(huff),
        "stored_members_excluded": stored,
        "waves": len(waves),
        "payload_mb": round(payload_total / 2**20, 1),
        "uncompressed_mb": round(isize_total / 2**20, 1),
        "decode_gbps": round(isize_total / best / 1e9, 4),
        "payload_gbps": round(payload_total / best / 1e9, 4),
        "marginal_guard": guard,
        "note": "device Huffman/token stages only; LZ77 resolve + host copies excluded",
    }


def kernel_only_bench_full(data: bytes, *, lanes: int = V2_LANE_BATCH, reps: int = 4) -> dict:
    """Full-member device decode throughput: compressed bits -> FINAL
    BYTES -> CRC, all on chip (stored members included as CRC lanes).

    Extends :func:`kernel_only_bench` with the pieces after the token
    stream: every member's tokens resolve to output bytes on device
    (``resolve_jax``: capped region-mod sources + pointer jumping, ≙ the
    reference's dictionary copy loop ``decomp/Open.java:589-617``) and
    each lane's CRC-32 is an int8 bit-matrix product (≙ the trailer
    verify, ``GzipInputStream.java:75-87``). Stored members, excluded
    from the Huffman-only figure, are counted here: their decode is an
    on-device CRC over the staged payload bytes. Only the uploads and
    the final byte pull stay outside the clock. Per-class sub-rows
    (``decode_gbps_huff`` / ``decode_gbps_stored``) time each member
    class against its own byte total so the untimed stored staging
    cannot flatter the blended headline, and every row carries its
    ``marginal_guard`` status (see :func:`_marginal_time`).

    An untimed verification pass pulls every resolved lane (stored
    lanes included) and checks bytes + conditioned CRCs against the
    member trailers.
    """
    import time

    from . import decode_jax as dj
    from . import resolve_jax as rp
    from ..kernels import checksum_jax as cj

    try:
        from .. import native as _native

        gz = _native.compress_members_native(data)
    except Exception:
        from .profile import profile_compress_host

        gz = profile_compress_host(data)
    buf = np.frombuffer(gz, dtype=np.uint8)
    members = dj.split_members(buf)
    huff, stored = [], []
    for m in members:
        btype = (int(buf[m.payload_start]) >> 1) & 3 if m.payload_start < buf.size else 0
        (stored if btype == 0 else huff).append(m)
    payloads = [buf[m.payload_start : m.end - 8].tobytes() for m in huff]
    isize_total = int(sum(m.isize for m in members))
    N = rp.N_POS
    assert all(m.isize <= N for m in members), "profile members exceed resolve space"

    run = _run_wave
    chunks = _wave_chunks(payloads, lanes)
    waves = [
        {k: jax.device_put(jnp.asarray(v)) for k, v in _prep_wave(chunk, n).items()}
        for chunk, n in chunks
    ]
    # Stored members: stage the raw payload bytes (their whole decode is
    # a bounds-checked copy + CRC; the copy is the staging we exclude,
    # the CRC is on the clock).
    stored_rows = np.zeros((max(len(stored), 1), N), np.uint8)
    stored_lens = np.zeros(max(len(stored), 1), np.int64)
    for i, m in enumerate(stored):
        out = dj._decode_stored_member(buf, m, verify_crc=False)
        stored_rows[i, : out.size] = out
        stored_lens[i] = out.size
    stored_d = jax.device_put(jnp.asarray(stored_rows.astype(np.int32)))
    K8, lvl8 = cj.crc_matrices8(N // cj.CHUNK_BYTES)

    force = sum(jnp.sum(w["grid"].astype(jnp.int32)) for w in waves) + jnp.sum(stored_d)
    np.asarray(force)

    RB = 256  # resolve/CRC lane batch

    def pad_to_n(tokens):
        L, M = tokens.shape
        if M >= N:
            return tokens[:, :N]
        return jnp.pad(tokens, ((0, 0), (0, N - M)), constant_values=-1)

    def run_huff_pass(collect: bool = False):
        acc = jnp.zeros((), jnp.uint32)
        # Only real lanes enter the resolve batches: wave padding lanes
        # would otherwise multiply the expand/jump volume ~2.5x.
        toks = [pad_to_n(run(w)[0])[: len(c)] for w, (c, _n) in zip(waves, chunks)]
        T = jnp.concatenate(toks, axis=0) if toks else jnp.zeros((0, N), jnp.int32)
        out = []
        for base in range(0, T.shape[0], RB):
            chunk = T[base : base + RB]
            if chunk.shape[0] < RB:
                chunk = jnp.pad(chunk, ((0, RB - chunk.shape[0]), (0, 0)), constant_values=-1)
            y, summ, rounds, unres = rp.resolve_tokens_device(chunk)
            raw = cj.crc32_lanes_raw8(y, K8, lvl8)
            acc = acc + jnp.sum(raw) + jnp.sum(summ).astype(jnp.uint32)
            acc = acc + rounds.astype(jnp.uint32) + unres.astype(jnp.uint32)
            if collect:
                out.append((y, summ, raw))
        return (acc, out) if collect else acc

    def run_stored_pass(collect: bool = False):
        acc = jnp.zeros((), jnp.uint32)
        out = []
        for base in range(0, stored_d.shape[0], RB):
            raw_s = cj.crc32_lanes_raw8(stored_d[base : base + RB], K8, lvl8)
            acc = acc + jnp.sum(raw_s)
            if collect:
                out.append((None, None, raw_s))
        return (acc, out) if collect else acc

    def run_pass(collect: bool = False):
        if collect:
            a1, o1 = run_huff_pass(True)
            a2, o2 = run_stored_pass(True)
            return a1 + a2, o1 + o2
        return run_huff_pass() + run_stored_pass()

    def timer(pass_fn):
        def run_n(n: int) -> float:
            t0 = time.monotonic()
            acc = jnp.zeros((), jnp.uint32)
            for _ in range(n):
                acc = acc + pass_fn()
            np.asarray(acc)
            return time.monotonic() - t0

        return run_n

    run_all_n = timer(run_pass)
    run_all_n(1)  # compile + warm
    best, t1, guard = _marginal_time(run_all_n, reps)
    # Per-member-class sub-rows: the stored members' untimed staging
    # must not be able to flatter the blended headline — report each
    # class against its own byte total.
    huff_isize = int(sum(m.isize for m in huff))
    stored_isize = int(sum(m.isize for m in stored))
    best_h, _t1h, guard_h = _marginal_time(timer(run_huff_pass), reps)
    best_s, _t1s, guard_s = _marginal_time(timer(run_stored_pass), reps)

    # Untimed verification: resolved bytes + CRCs vs member trailers.
    _acc, collected = run_pass(collect=True)
    pay_to_member = {}
    for m in huff:
        pay_to_member.setdefault(buf[m.payload_start : m.end - 8].tobytes(), []).append(m)
    verified = 0
    mism = 0
    lane_ptr = 0
    ys = [c for c in collected if c[0] is not None]
    for chunk, _n in chunks:
        for i, pbytes in enumerate(chunk):
            gi = lane_ptr + i
            y, summ, raw = ys[gi // RB]
            li = gi % RB
            m = pay_to_member[pbytes][0]
            total = int(np.asarray(summ[li, 1]))
            crc = cj.crc32_finish_leftaligned(
                np.asarray(raw[li : li + 1]), np.array([total]), N
            )[0]
            if total != m.isize or int(crc) != m.crc32:
                mism += 1
            else:
                verified += 1
        lane_ptr += len(chunk)
    # Stored lanes verify too.
    raws_s = np.concatenate(
        [np.asarray(c[2]) for c in collected if c[0] is None]
    ) if stored else np.zeros(0, np.uint32)
    for i, m in enumerate(stored):
        crc = cj.crc32_finish_leftaligned(
            raws_s[i : i + 1], stored_lens[i : i + 1], N
        )[0]
        if int(stored_lens[i]) != m.isize or int(crc) != m.crc32:
            mism += 1
        else:
            verified += 1
    payload_total = sum(len(p) for p in payloads)
    return {
        "decode_gbps": round(isize_total / best / 1e9, 4),
        "decode_gbps_single_pass": round(isize_total / t1 / 1e9, 4),
        "decode_gbps_huff": round(huff_isize / best_h / 1e9, 4),
        "decode_gbps_stored": round(stored_isize / best_s / 1e9, 4) if stored else None,
        "uncompressed_mb": round(isize_total / 2**20, 1),
        "huff_mb": round(huff_isize / 2**20, 1),
        "stored_mb": round(stored_isize / 2**20, 1),
        "members": len(members),
        "huff_members": len(huff),
        "stored_members": len(stored),
        "waves": len(waves),
        "payload_mb": round(payload_total / 2**20, 1),
        "verified_members": verified,
        "crc_or_size_mismatches": mism,
        "marginal_guard": guard,
        "marginal_guard_huff": guard_h,
        "marginal_guard_stored": guard_s,
        "note": "bits->bytes->CRC on device (A-E + compaction + LZ77 resolve + CRC); uploads and final byte pull excluded",
    }


def _device_resolve_enabled(mode: str | None) -> bool:
    """Device-resolve engine policy: "on" | "off" | "auto"/None.

    Auto resolves LZ77 and checks CRCs on the device where the backend
    table says so (``kernels.backend``: yes on the GPU, no on the CPU).
    ``TD_DEVICE_RESOLVE=0/1`` overrides.
    """
    import os

    env = os.environ.get("TD_DEVICE_RESOLVE")
    if env is not None:
        return env not in ("0", "off", "false")
    if mode == "on":
        return True
    if mode == "off":
        return False
    return backend.current().device_resolve


def _single_block_eligible(buf: np.ndarray, m) -> bool:
    """Member decodable by the single-wave full-device path: one final
    Huffman block, output fits a resolve tile, payload fits a bucket."""
    from . import resolve_jax as rp

    if m.isize > rp.N_POS:
        return False
    plen = m.end - 8 - m.payload_start
    if plen <= 0 or plen > max(_P_BUCKETS):
        return False
    hdr = int(buf[m.payload_start])
    return (hdr & 1) == 1 and ((hdr >> 1) & 3) in (1, 2)


def _decode_single_block_device(
    payloads: list[bytes], members: list, verify_crc: bool, fallback: dict
) -> list[bytes | None]:
    """Decode single-block bfinal Huffman members entirely on device.

    Stages A-E + compaction produce the token streams, which resolve to
    final bytes on the device (``resolve_jax``, ≙ the copy loop inside
    ``InflaterInputStream.read`` — ``InflaterInputStream.java:147-164`` /
    ``decomp/Open.java:589-617``) with the trailer CRC computed by the
    int8 bit-matrix product (≙ ``GzipInputStream.java:75-87``); only the
    final bytes are pulled. Returns one ``bytes`` per member, or ``None``
    where the lane must re-run through the host-resolve path, counting
    why in ``fallback`` ("residue": unresolved device residue;
    "overflow": a tile over the two-level compaction budget). Raises
    ``DataFormatError`` with the reference taxonomy (resolve errors
    ordered before stage errors, matching ``_resolve_lane``).
    """
    from ..format.errors import check_device_error
    from . import resolve_jax as rp
    from ..kernels import checksum_jax as cj

    N = rp.N_POS
    order = sorted(range(len(payloads)), key=lambda i: _bucket(len(payloads[i]), _P_BUCKETS))
    chunks = _wave_chunks([payloads[i] for i in order])
    wave_meta = []  # (payload indices, small (7, L) device, tokens device)
    base = 0
    for chunk, n in chunks:
        idxs = order[base : base + len(chunk)]
        base += len(chunk)
        w = {k: jax.device_put(jnp.asarray(v)) for k, v in _prep_wave(chunk, n).items()}
        tokens, *rest = _run_wave(w)
        small = _pack_small(*rest)
        toks = tokens[: len(chunk)]
        if toks.shape[1] >= N:
            toks = toks[:, :N]
        else:
            toks = jnp.pad(toks, ((0, 0), (0, N - toks.shape[1])), constant_values=-1)
        wave_meta.append((idxs, small, toks))

    RB = 256  # fixed resolve batch shape (one compiled program)
    K8, lvl8 = cj.crc_matrices8(N // cj.CHUNK_BYTES)
    T = (
        jnp.concatenate([t for _, _, t in wave_meta], axis=0)
        if wave_meta
        else jnp.zeros((0, N), jnp.int32)
    )
    batches = []  # (y uint8 device, summ device, raw device)
    for b0 in range(0, T.shape[0], RB):
        c = T[b0 : b0 + RB]
        real = c.shape[0]
        if real < RB:
            c = jnp.pad(c, ((0, RB - real), (0, 0)), constant_values=-1)
        y, summ, _rounds, _unres = rp.resolve_tokens_device(c)
        raw = cj.crc32_lanes_raw8(y, K8, lvl8)
        batches.append((y.astype(jnp.uint8)[:real], summ[:real], raw[:real]))

    # Pipeline the pulls: small vectors + summaries first, bytes after.
    for _, small, _ in wave_meta:
        _async_to_host(small)
    for _yu8, summ, raw in batches:
        _async_to_host(summ)
        _async_to_host(raw)
    for yu8, _summ, _raw in batches:
        _async_to_host(yu8)
    summs = [np.asarray(b[1]) for b in batches]
    raws = [np.asarray(b[2]) for b in batches]
    ys = [np.asarray(b[0]) for b in batches]

    outs: list[bytes | None] = [None] * len(payloads)
    li = 0
    for idxs, small, _ in wave_meta:
        sm = np.asarray(small)
        for j, pi in enumerate(idxs):
            b, r = divmod(li, RB)
            li += 1
            _counts, has_eob, _eob_exit, err, _total_s, ovf, _nlit = (
                int(v) for v in sm[:, j]
            )
            if ovf:
                fallback["overflow"] += 1
                continue
            summ = summs[b][r]
            if int(summ[0]) < N:
                # a bad back-reference precedes any pending stage error
                # in the stream (same ordering as _resolve_lane)
                raise _df(Reason.COPY_FROM_BEFORE_DICTIONARY_START)
            if err:
                check_device_error(err)
            if not has_eob:
                check_device_error(_ERR_END)
            if int(summ[3]) > 0:
                fallback["residue"] += 1
                continue
            total = int(summ[1])
            m = members[pi]
            # Trailer checks in the host engine's order: CRC, then size.
            # A lane longer than the tile lost bytes, so its CRC cannot
            # match the trailer's.
            if verify_crc and (
                total > N
                or int(cj.crc32_finish_leftaligned(raws[b][r : r + 1], np.array([total]), N)[0])
                != m.crc32
            ):
                raise _df(Reason.DECOMPRESSED_CHECKSUM_MISMATCH)
            if total != m.isize:
                raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH)
            outs[pi] = ys[b][r, :total].tobytes()
    return outs


# Which path each member of the last engine decode took, so "device
# resolve ran" is a recorded fact: members resolved on the device or on
# the host, members the device path handed to the host (unresolved
# residue, compaction overflow), and whether the whole stream went to the
# pure-Python GzipReader (no TD-indexed members).
LAST_DECODE_STATS: dict = {}


def gzip_decompress_tpu_v2(
    data: bytes,
    *,
    verify_crc: bool = True,
    mesh=None,
    lane_batch: int | None = None,
    device_resolve: str | None = None,
) -> bytes:
    """Member-parallel decode through the device pipeline.

    With ``mesh``, the lane axis of every device stage is sharded over the
    mesh's ``data`` axis (dist.sharded.sharded_decode) — members decode
    data-parallel across devices, bit-exact with the single-device path.
    ``lane_batch`` (DecoderConfig.lane_batch) caps members per device
    batch; the compiled wave shapes top out at V2_LANE_BATCH.

    ``device_resolve`` ("auto"/None | "on" | "off", DecoderConfig knob,
    ``TD_DEVICE_RESOLVE`` env override): where enabled, single-block
    members resolve to final CRC-checked bytes entirely on the device
    (:func:`_decode_single_block_device`) and only the output bytes are
    pulled; multi-block/oversized members — and any lane the device
    reports an unresolved residue for — take the packed-token pull + host
    resolve path ("on" also resolves those on the device).
    """
    import io

    from . import decode_jax as dj

    stats = LAST_DECODE_STATS
    stats.clear()
    stats.update(
        members=0,
        stored=0,
        device_resolved=0,
        host_resolved=0,
        residue_fallback=0,
        overflow_fallback=0,
        gzip_reader=0,
    )
    runner = None
    if mesh is not None:
        from ..dist.sharded import sharded_decode

        runner = sharded_decode(mesh)

    buf = np.frombuffer(data, dtype=np.uint8)
    members = dj.split_members(buf)
    if not members:
        from ..streams.gzip_stream import GzipReader

        stats["gzip_reader"] = 1
        return GzipReader(io.BytesIO(data), multi_member=True).read()

    out_parts: list[bytes | None] = [None] * len(members)
    huff: list[tuple[int, dj.MemberIndex]] = []
    for i, m in enumerate(members):
        btype = (int(buf[m.payload_start]) >> 1) & 3 if m.payload_start < buf.size else 0
        if btype == 0:
            out_parts[i] = dj._decode_stored_member(buf, m, verify_crc=verify_crc).tobytes()
        else:
            huff.append((i, m))

    stats.update(members=len(members), stored=len(members) - len(huff))
    if mesh is None and huff and _device_resolve_enabled(device_resolve):
        elig = [(i, m) for i, m in huff if _single_block_eligible(buf, m)]
        if elig:
            payloads_e = [buf[m.payload_start : m.end - 8].tobytes() for _, m in elig]
            fallback = {"residue": 0, "overflow": 0}
            outs_e = _decode_single_block_device(
                payloads_e, [m for _, m in elig], verify_crc, fallback
            )
            stats["residue_fallback"] += fallback["residue"]
            stats["overflow_fallback"] += fallback["overflow"]
            done = set()
            for (i, m), o in zip(elig, outs_e):
                if o is not None:
                    out_parts[i] = o
                    done.add(i)
            huff = [(i, m) for i, m in huff if i not in done]
            stats["device_resolved"] = len(done)
    stats["host_resolved"] = len(huff)

    # Forced device resolve also routes the REMAINING members — multi-
    # block, foreign, and > 64 KiB — through the device: the wave driver
    # produces each lane's token stream, which tile-splits and resolves
    # with chained 32 KiB tails (resolve_jax.resolve_big_streams,
    # ≙ unbounded streaming over the bounded ring dictionary,
    # decomp/Open.java:64-66). "auto" keeps these on host resolve
    # (ROADMAP R4 decides by measurement).
    big_device = device_resolve == "on" and _device_resolve_enabled(device_resolve)
    batch_n = min(lane_batch or V2_LANE_BATCH, V2_LANE_BATCH)
    for base in range(0, len(huff), batch_n):
        batch = huff[base : base + batch_n]
        payloads = [buf[m.payload_start : m.end - 8].tobytes() for _, m in batch]
        states = decode_deflate_streams_v2(payloads, runner)
        douts: list = [None] * len(batch)
        if big_device:
            from . import resolve_jax as rp

            clean = [
                (j, st) for j, st in enumerate(states) if not st.err and st.tokens
            ]
            if clean:
                toks = [
                    np.concatenate(st.tokens).astype(np.int32) for _, st in clean
                ]
                outs_b, resid = rp.resolve_big_streams(toks)
                for (j, _st), o, r in zip(clean, outs_b, resid):
                    if r == 0:
                        douts[j] = o.tobytes()
                        stats["device_resolved"] += 1
                        stats["host_resolved"] -= 1
                    else:
                        stats["residue_fallback"] += 1
        for j, ((i, m), st) in enumerate(zip(batch, states)):
            out = douts[j] if douts[j] is not None else _resolve_lane(st)
            # trailer checks in the host engine's order: CRC, then size
            if verify_crc and dj._fast_crc32(np.frombuffer(out, np.uint8)) != m.crc32:
                raise _df(Reason.DECOMPRESSED_CHECKSUM_MISMATCH)
            if len(out) != m.isize:
                raise _df(Reason.DECOMPRESSED_SIZE_MISMATCH)
            out_parts[i] = out
    return b"".join(p for p in out_parts if p is not None)


def kernel_only_bench_big(
    data: bytes, *, member_kb: int = 192, n_members: int = 8, reps: int = 4
) -> dict:
    """Full-device decode of members LARGER than one 64 KiB resolve tile.

    Prep (untimed): ``n_members`` single-block members of ``member_kb``
    KiB each (host strategy encoder with a widened lookahead produces
    one dynamic block per member). On the clock: wave stages A-E +
    compaction, the DEVICE tile split (``resolve_jax.
    split_tiles_device``), and T chained resolve+CRC steps whose 32 KiB
    tails stay on device — compressed bits to final CRC-checked bytes
    for outputs beyond the tile bound (≙ unbounded streaming over the
    bounded ring dictionary, ``decomp/Open.java:64-66``). An untimed
    pass verifies every member's bytes against the input.
    """
    import time

    import tpu_deflate as td
    from ..kernels.bitio import BitWriter  # noqa: F401  (host encoder dep)
    from ..streams.deflater import Deflater

    strategy_for_effort = td.strategy_for_effort
    from .profile import build_member
    from ..kernels.checksum import crc32 as crc32_host
    from . import resolve_jax as rp
    from ..kernels import checksum_jax as cj
    import io

    N = rp.N_POS
    msize = member_kb << 10
    T = -(-msize // N)
    chunks = [
        data[i * msize : (i + 1) * msize]
        for i in range(n_members)
        if len(data[i * msize : (i + 1) * msize]) == msize
    ]
    payloads, crcs = [], []
    for c in chunks:
        sink = io.BytesIO()
        # Effort 1 (RLE_DYNAMIC): the cheapest single-block host encode —
        # prep cost only; the row measures DECODE of >64 KiB members.
        d = Deflater(sink, lookahead=msize, strategy=strategy_for_effort(1))
        d.write(c)
        d.finish()
        payloads.append(sink.getvalue())
        crcs.append(crc32_host(c))

    run = _run_wave
    assert max(len(p) for p in payloads) <= max(_P_BUCKETS), "payload exceeds wave buckets"
    w = _prep_wave(payloads, _bucket(len(payloads), V2_L_BUCKETS))
    w = {k: jax.device_put(jnp.asarray(v)) for k, v in w.items()}
    K8, lvl8 = cj.crc_matrices8(N // cj.CHUNK_BYTES)
    np.asarray(jnp.sum(w["grid"].astype(jnp.int32)))  # force staging

    L = len(payloads)

    def run_pass(collect: bool = False):
        tokens = run(w)[0][:L]
        tiles = rp.split_tiles_device(tokens, T)
        acc = jnp.zeros((), jnp.uint32)
        tail = None
        ys, raws = [], []
        for t in range(T):
            y, summ, _r, unres = rp.resolve_tokens_device(tiles[:, t], tail=tail)
            raw = cj.crc32_lanes_raw8(y, K8, lvl8)
            acc = acc + jnp.sum(raw) + jnp.sum(summ).astype(jnp.uint32)
            acc = acc + unres.astype(jnp.uint32)
            tail = y[:, N - rp.TAIL :]
            if collect:
                ys.append(y)
                raws.append(raw)
        return (acc, ys, raws) if collect else acc

    def run_n(n: int) -> float:
        t0 = time.monotonic()
        acc = jnp.zeros((), jnp.uint32)
        for _ in range(n):
            acc = acc + run_pass()
        np.asarray(acc)
        return time.monotonic() - t0

    run_n(1)  # compile + warm
    best, t1, guard = _marginal_time(run_n, reps)

    # Untimed verification: pulled bytes must equal the input chunks.
    _acc, ys, _raws = run_pass(collect=True)
    ybytes = np.concatenate([np.asarray(y, np.uint8)[:, None, :] for y in ys], axis=1)
    verified = mism = 0
    for i, c in enumerate(chunks):
        got = ybytes[i].reshape(-1)[:msize].tobytes()
        if got == c:
            verified += 1
        else:
            mism += 1
    total = msize * len(chunks)
    return {
        "decode_gbps": round(total / best / 1e9, 4),
        "decode_gbps_single_pass": round(total / t1 / 1e9, 4),
        "member_kb": member_kb,
        "members": len(chunks),
        "tiles_per_member": T,
        "uncompressed_mb": round(total / 2**20, 1),
        "verified_members": verified,
        "byte_mismatches": mism,
        "marginal_guard": guard,
        "note": "members > one resolve tile: A-E + device tile split + chained resolve/CRC on device",
    }
