"""Device member-parallel gzip encoder (emits the TD member profile).

The reference encoder is a sequential per-chunk scan
(``comp/Lz77Huffman.java:68-131``); this path recasts the whole encode as
batched device kernels over independent 64 KiB members (lanes):

- **analyze** (one jit): multiplicative 4/3-byte hashing; one stable
  sort per hash family groups equal hashes, after which the K nearest
  previous occurrences are STATIC shifts of the sorted arrays and the
  exact match-length compare (to 4*MATCH_WORDS bytes, from pre-sorted
  window words) needs no gather; arithmetic RLE lanes give exact
  dist<=4 runs; the greedy/lazy parse walks the token chain by pointer
  doubling; per-lane scatter-add histograms.
- **host planning**: lock-step two-queue Huffman (``huffman_lengths_batch``)
  for all lanes at once, full 15-bit RFC 1951 code range (the ladder
  decoder has no LUT-width cap), canonical code assignment batched,
  per-lane dynamic header layout.
- **on-device routing** (``route_strategies``): exact stored/fixed/
  dynamic bit costs per lane from the device-resident histograms,
  argmin-routed before the single emit (≙ comp/MultiStrategy.java:31-56).
- **emit kernel** (jit): every (position, slot) pair becomes a
  (value, nbits) token; bit offsets are one cumulative sum; bits land via
  carry-free scatter-add into uint32 words (slot bit ranges are disjoint
  by construction, so add == or).
- member assembly on host: TD-indexed gzip headers, CRC-32 trailers
  (host C kernel, or batched on the device with
  ``TPU_DEFLATE_DEVICE_CRC=1``, ``checksum_jax``), stored framing for
  stored-routed lanes.

Capability note: this path targets throughput on the profile; the host
strategy system (``deflate_encode.py``) remains the fully general encoder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..kernels import jax_setup  # noqa: F401  (compilation cache)
import numpy as np

from ..kernels.bitio import BitWriter
from ..kernels.checksum import crc32
from ..kernels.huffman import huffman_lengths_batch
from .deflate_encode import _CLEN_EXTRA_BITS, _clen_rle
from .profile import MEMBER_DATA, build_member


def _device_crc_wanted() -> bool:
    """Batched device member-CRC, opt-in via TPU_DEFLATE_DEVICE_CRC=1.

    The member bytes are already on the host when the trailer is built,
    so the device CRC costs a re-upload of every member; whether that
    beats the host slice-by-8 C kernel is not measured yet, so the host
    kernel is the default."""
    import os

    return os.environ.get("TPU_DEFLATE_DEVICE_CRC", "") not in ("", "0")

HASH_BITS = 16
K_CANDIDATES = 16  # sorted-space candidates are static shifts: K is cheap now
MATCH_WORDS = 9  # sorted window words: exact prefix compare to 36 bytes
MAX_CODE_BITS = 15  # full RFC 1951 range (package-merge cap)
ENC_LANE_BATCH = 64  # members per device dispatch
_ENC_L_BUCKETS = (4, 16, ENC_LANE_BATCH)
# Longest match run the parse takes (ROADMAP D6: the cap fragments
# 258-byte runs; it stays until a PR changes the emitted bytes on purpose).
PARSE_MAX_STEP = 250

def _run_to_symbol(run):
    """Closed-form run -> (length symbol, extra bits, extra value).

    Equivalent to the reference's log-based mapping
    (``comp/Lz77Huffman.java:92-111``) as branch-free arithmetic, no
    table lookup. Valid for run in [3, 258].
    """
    r3 = jnp.maximum(run - 3, 0)
    e = (
        (r3 >= 8).astype(jnp.int32)
        + (r3 >= 16).astype(jnp.int32)
        + (r3 >= 32).astype(jnp.int32)
        + (r3 >= 64).astype(jnp.int32)
        + (r3 >= 128).astype(jnp.int32)
    )
    sym_hi = 257 + 4 * e + (r3 >> e)
    sym = jnp.where(run <= 10, 254 + run, sym_hi)
    sym = jnp.where(run >= 258, 285, sym)
    base = jnp.where(
        sym <= 264, sym - 254, ((((sym - 257) & 3) + 4) << jnp.maximum(e, 0)) + 3
    )
    base = jnp.where(sym == 285, 258, base)
    eb = jnp.where((sym >= 265) & (sym <= 284), e, 0)
    ev = run - base
    return sym.astype(jnp.int32), eb.astype(jnp.int32), ev.astype(jnp.int32)


def _dist_to_symbol(dist):
    """Closed-form distance -> (symbol, extra bits, extra value)
    (≙ ``comp/Lz77Huffman.java:112-127``). Valid for dist in [1, 32768]."""
    d1 = jnp.maximum(dist - 1, 0)
    e = jnp.zeros_like(d1)
    for k in range(1, 14):
        e = e + (d1 >= (1 << (k + 1))).astype(jnp.int32)
    sym_hi = 2 * e + (d1 >> e)
    sym = jnp.where(dist <= 4, d1, sym_hi)
    base = jnp.where(sym <= 3, sym + 1, (((sym & 1) + 2) << jnp.maximum(e, 0)) + 1)
    eb = jnp.where(sym >= 4, e, 0)
    ev = dist - base
    return sym.astype(jnp.int32), eb.astype(jnp.int32), ev.astype(jnp.int32)


def _u32_windows(data: jnp.ndarray) -> jnp.ndarray:
    """(L, S) uint8 -> (L, S) uint32 LE 4-byte windows (zero padded)."""
    L, S = data.shape
    ext = jnp.concatenate([data, jnp.zeros((L, 4), jnp.uint8)], axis=1).astype(jnp.uint32)
    return (
        ext[:, :S]
        | (ext[:, 1 : S + 1] << 8)
        | (ext[:, 2 : S + 2] << 16)
        | (ext[:, 3 : S + 3] << 24)
    )


# Effort ladder for the device matcher (≙ the host preset mapping of the
# reference ladder, comp/Lz77Huffman.java:298-305): quality selects the
# candidate count K and the exact-compare word caps per hash family.
# Wider settings cost more sorted-space word pre-gathers per batch.
# The 6-byte family (quality >= 1) targets the text loss vs the
# reference's exhaustive scan: long matches hide hundreds of entries
# deep in overcrowded 4-byte buckets (" the", "ing "), but agree on six
# leading bytes — the nearest h6 candidates find them in K6 shifts.
_QUALITY = {
    0: dict(K4=16, W4=9, K3=2, W3=2),  # default (effort 2)
    1: dict(K4=32, W4=16, K3=4, W3=2, K6=16, W6=16),  # effort 3/4
    2: dict(K4=48, W4=16, K3=8, W3=2, K6=24, W6=16),  # effort 5: deep K
    # Each sort carries 2 + W operands; K (shift-compare rounds) is the
    # cheap axis.
}


def _match_find(
    data: jnp.ndarray,
    lengths: jnp.ndarray,
    lazy: bool,
    quality: int = 0,
    hist: jnp.ndarray | None = None,
    hstart: jnp.ndarray | None = None,
):
    """Shared match-find front half: data -> (use, dist, step, valid).

    ``hist`` (L,) marks each lane's payload start column: positions
    before it are 32 KiB continuous-history context (the previous
    shard's tail from ``halo_exchange``) — they participate as match
    CANDIDATES (matches may start in history, ≙ the reference's search
    window including the history prefix, ``comp/Lz77Huffman.java:71``)
    but are never tokenized themselves. ``hstart`` (L,) is the first
    REAL history column (columns before it are row padding, e.g. the
    stream head's empty window) and is excluded from candidacy. None =
    the member-parallel path (whole row is payload).
    """
    q = _QUALITY[quality]
    L, S = data.shape
    pos = jnp.arange(S, dtype=jnp.int32)[None, :]
    valid = pos < lengths[:, None]
    if hstart is not None:
        valid = valid & (pos >= hstart[:, None])
    w32 = _u32_windows(data)
    lanes = jnp.arange(L, dtype=jnp.int32)[:, None]
    idx = jnp.broadcast_to(pos, (L, S))

    # --- hash-bucket candidates, evaluated in SORTED space -------------
    # One stable argsort groups equal hashes with in-bucket positions
    # ascending; the k-th previous same-hash occurrence is then a STATIC
    # shift of the sorted arrays. Carrying a fixed set of window words
    # through the sort makes the whole K-candidate evaluation —
    # including the match-length compare up to 4*MATCH_WORDS bytes —
    # free of gathers (ROADMAP D4 weighs this against plain gathers).
    # Results return to position order with one more sort per family.
    # ≙ the reference's exhaustive distance scan (comp/Lz77Huffman.java:
    # 71-84) restricted to the K nearest same-hash candidates.
    def shr(a, k, fill=0):
        return jnp.concatenate(
            [jnp.full((L, k), fill, a.dtype), a[:, : S - k]], axis=1
        )

    def bucket_best(h, K, nwords):
        """Best (match-len, candidate-pos) per position, via sorted
        space; returns it in position order.

        One multi-operand ``lax.sort`` (key = hash, payload = original
        index + the ``nwords`` window words) stands in for an argsort
        plus one ``take_along_axis`` per word. The exact prefix compare is
        bounded at 4*nwords bytes; longer matches fragment into chained
        tokens, and exact long runs at dist <= 4 come from the
        arithmetic RLE lanes. A second 2-operand sort (key = original
        index) replaces the scatter back to position order.
        """
        cap = 4 * nwords
        si = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (L, S))
        words = [
            jnp.concatenate([w32[:, 4 * j :], jnp.zeros((L, 4 * j), jnp.uint32)], axis=1)
            if j
            else w32
            for j in range(nwords)
        ]
        srt = jax.lax.sort(
            (h, si) + tuple(words), dimension=1, is_stable=True, num_keys=1
        )
        sorted_h, order = srt[0], srt[1]
        sw = list(srt[2:])
        changed = jnp.concatenate(
            [jnp.ones((L, 1), bool), sorted_h[:, 1:] != sorted_h[:, :-1]], axis=1
        )
        group_first = jax.lax.associative_scan(
            jnp.maximum, jnp.where(changed, si, -1), axis=1
        )
        rank = si - group_first
        live = sorted_h != -1

        def word_eqlen(x):
            """0..4 equal leading bytes of a xored LE word."""
            return (
                ((x & 0xFF) == 0).astype(jnp.int32)
                + ((x & 0xFFFF) == 0).astype(jnp.int32)
                + ((x & 0xFFFFFF) == 0).astype(jnp.int32)
                + (x == 0).astype(jnp.int32)
            )

        def lcpv(k):
            total = word_eqlen(sw[0] ^ shr(sw[0], k))
            full = total == 4
            for j in range(1, nwords):
                lj = word_eqlen(sw[j] ^ shr(sw[j], k))
                total = total + jnp.where(full, lj, 0)
                full = full & (lj == 4)
            return total

        blen = jnp.zeros((L, S), jnp.int32)
        bcand = jnp.full((L, S), -1, jnp.int32)
        for k in range(1, K + 1):
            cand = shr(order, k, -1)
            dist = order - cand
            ok = live & (rank >= k) & (dist >= 1) & (dist <= 32 * 1024)
            lc = jnp.where(ok, lcpv(k), 0)
            # ties keep the earlier (nearer, since in-bucket order is by
            # position) candidate — the reference's smallest-distance
            # tie-break (comp/Lz77Huffman.java:80)
            better = lc > blen
            blen = jnp.where(better, lc, blen)
            bcand = jnp.where(better, cand, bcand)
        # Pack (len 6b | cand+1 17b) and sort back to position order
        # (key = original index; cheaper than a (L, S) scatter here).
        p1 = ((bcand + 1) | (jnp.minimum(blen, cap) << 18)).astype(jnp.int32)
        _, o1 = jax.lax.sort((order, p1), dimension=1, is_stable=False, num_keys=1)
        return o1

    h4 = ((w32 * jnp.uint32(2654435761)) >> jnp.uint32(32 - HASH_BITS)).astype(jnp.int32)
    h4 = jnp.where(valid, h4, -1)
    # 3-byte hash: reaches run-3 matches and positions whose 4-byte
    # window is broken by non-repeating bytes (the exhaustive reference
    # scan has no such blind spot, comp/Lz77Huffman.java:71-84).
    h3 = (((w32 & 0xFFFFFF) * jnp.uint32(2654435761)) >> jnp.uint32(32 - HASH_BITS)).astype(
        jnp.int32
    )
    h3 = jnp.where(valid, h3, -1)
    q1 = bucket_best(h4, q["K4"], q["W4"])
    q3 = bucket_best(h3, q["K3"], q["W3"])

    limit = jnp.minimum(258, lengths[:, None] - idx)

    c1 = (q1 & 0x3FFFF) - 1
    l1 = q1 >> 18
    c3 = (q3 & 0x3FFFF) - 1
    l3 = q3 >> 18
    d1 = jnp.where(c1 >= 0, idx - c1, 0)
    d3 = jnp.where(c3 >= 0, idx - c3, 0)
    take3 = (l3 > l1) | ((l3 == l1) & (l3 > 0) & (d3 < d1))
    run = jnp.minimum(jnp.where(take3, l3, l1), limit)
    dist = jnp.where(take3, d3, d1)

    if "K6" in q:
        # 6-byte-hash family: bytes 4..5 mixed into the 4-byte window
        # hash. False groups from the zero tail are harmless (the exact
        # word compares reject them).
        ext6 = jnp.concatenate([data, jnp.zeros((L, 6), jnp.uint8)], axis=1).astype(
            jnp.uint32
        )
        b45 = ext6[:, 4 : S + 4] | (ext6[:, 5 : S + 5] << 8)
        h6 = (
            ((w32 ^ (b45 * jnp.uint32(0x9E3779B1))) * jnp.uint32(2654435761))
            >> jnp.uint32(32 - HASH_BITS)
        ).astype(jnp.int32)
        h6 = jnp.where(valid, h6, -1)
        q6 = bucket_best(h6, q["K6"], q["W6"])
        c6 = (q6 & 0x3FFFF) - 1
        l6 = jnp.minimum(q6 >> 18, limit)
        d6 = jnp.where(c6 >= 0, idx - c6, 0)
        take6 = (l6 > run) | ((l6 == run) & (l6 > 0) & (d6 < dist))
        run = jnp.where(take6, l6, run)
        dist = jnp.where(take6, d6, dist)

    # Arithmetic RLE lanes: exact match lengths at dist 1..4 via the
    # suffix run-length of data[i] == data[i-d] (log2(258) static-shift
    # doubling rounds, elementwise) — these recover the long periodic
    # matches the capped prefix compare fragments, at full 258 length.
    # Ascending d with strict > keeps the smallest distance on ties
    # (the reference's tie-break, comp/Lz77Huffman.java:80).
    def suffix_runlen(eq):
        r = eq.astype(jnp.int32)
        span = 1
        while span < 258:
            nxt = jnp.concatenate(
                [r[:, span:], jnp.zeros((L, span), jnp.int32)], axis=1
            )
            r = jnp.where(r == span, r + nxt, r)
            span *= 2
        return jnp.minimum(r, 258)

    rle_run = jnp.zeros((L, S), jnp.int32)
    rle_dist = jnp.zeros((L, S), jnp.int32)
    for d in range(1, 5):
        prev = jnp.concatenate(
            [jnp.full((L, d), -1, jnp.int32), data[:, : S - d].astype(jnp.int32)], axis=1
        )
        eq = data.astype(jnp.int32) == prev
        rl = jnp.minimum(suffix_runlen(eq), limit)
        better = rl > rle_run
        rle_run = jnp.where(better, rl, rle_run)
        rle_dist = jnp.where(better, d, rle_dist)
    take_rle = (rle_run >= 3) & (
        (rle_run > run) | ((rle_run == run) & (rle_dist < dist))
    )
    run = jnp.where(take_rle, rle_run, run)
    dist = jnp.where(take_rle, rle_dist, dist)
    # Cap runs at PARSE_MAX_STEP (costs long runs <= 8/258 of one
    # token's efficiency; lifting it changes the emitted bytes).
    run = jnp.minimum(run, PARSE_MAX_STEP)

    # worthwhile-match heuristics (zlib-style): short far matches lose.
    good = (run >= 4) | ((run == 3) & (dist <= 4096))
    run = jnp.where(good, run, 0)
    dist = jnp.where(good, dist, 0)

    # --- lazy deferral --------------------------------------------------
    use = run
    if lazy:
        nxt_run = jnp.concatenate([use[:, 1:], jnp.zeros((L, 1), jnp.int32)], axis=1)
        defer = (use > 0) & (nxt_run > use)
        use = jnp.where(defer, 0, use)
    if hist is not None:
        # History positions are never tokens; their 1-byte steps walk
        # the parse chain from the row start exactly onto the payload
        # start, so the chain machinery needs no separate entry point.
        in_payload = pos >= hist[:, None]
        use = jnp.where(in_payload, use, 0)
        dist = jnp.where(in_payload, dist, 0)
    step = jnp.where(use > 0, use, 1)
    return use, dist, step, valid


def _finish_analysis(data, use, dist, is_token):
    """Shared back half: token selection -> symbols + histograms."""
    L, S = data.shape
    lanes = jnp.arange(L, dtype=jnp.int32)[:, None]
    is_match = is_token & (use > 0)

    run_idx = jnp.clip(jnp.where(is_match, use, 3), 3, 258)
    lit = data.astype(jnp.int32)
    rsym, reb, rev_ = _run_to_symbol(run_idx)
    litlen_sym = jnp.where(is_match, rsym, lit)
    len_eb = jnp.where(is_match, reb, 0)
    len_ev = jnp.where(is_match, rev_, 0)
    dist_idx2 = jnp.clip(jnp.where(is_match, dist, 1), 1, 32768)
    dsym, deb, dev_ = _dist_to_symbol(dist_idx2)
    dist_sym = jnp.where(is_match, dsym, 0)
    dist_eb = jnp.where(is_match, deb, 0)
    dist_ev = jnp.where(is_match, dev_, 0)

    # --- histograms: per-lane scatter-add; non-token positions land in
    # a trash bin past the symbol range ---------------------------------
    def _hist(keys, nbins):
        h = jnp.zeros((L, nbins + 1), jnp.int32).at[lanes, keys].add(1)
        return h[:, :nbins]

    litlen_hist = _hist(jnp.where(is_token, litlen_sym, 288), 288)
    dist_hist = _hist(jnp.where(is_match, dist_sym, 30), 30)

    return {
        "is_token": is_token,
        "is_match": is_match,
        "litlen_sym": litlen_sym,
        "len_eb": len_eb,
        "len_ev": len_ev,
        "dist_sym": dist_sym,
        "dist_eb": dist_eb,
        "dist_ev": dist_ev,
        "litlen_hist": litlen_hist,
        "dist_hist": dist_hist,
    }


@functools.partial(jax.jit, static_argnames=("lazy", "quality"))
def analyze_device(
    data: jnp.ndarray,
    lengths: jnp.ndarray,
    lazy: bool = True,
    quality: int = 0,
    hist: jnp.ndarray | None = None,
    hstart: jnp.ndarray | None = None,
):
    """Match-find + parse + histogram for a batch of members (one jit).

    data: (L, S) uint8 (zero-padded rows), lengths: (L,) int32.
    ``hist``/``hstart`` enable continuous-history rows (see
    ``_match_find``): candidates reach into the 32 KiB halo prefix, but
    tokens/histograms cover only the payload columns.
    Returns dict of per-position token info and per-lane histograms.
    The greedy parse walks next[i] = i + step[i] from position 0 by
    pointer doubling (log2(S) + 1 gather+scatter rounds).
    """
    L, S = data.shape
    use, dist, step, valid = _match_find(data, lengths, lazy, quality, hist, hstart)
    idx = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (L, S))
    lanes = jnp.arange(L, dtype=jnp.int32)[:, None]
    nxt = jnp.minimum(idx + step, S)
    reached = jnp.zeros((L, S + 1), bool).at[:, 0].set(True)
    jump = jnp.concatenate([nxt, jnp.full((L, 1), S, jnp.int32)], axis=1)
    rounds = int(np.ceil(np.log2(S))) + 1
    for _ in range(rounds):
        hit = jnp.zeros((L, S + 1), bool).at[
            lanes, jnp.where(reached, jump, S)
        ].set(True, mode="drop")
        reached = reached | hit
        jump = jnp.take_along_axis(jump, jnp.clip(jump, 0, S), axis=1)
    is_token = reached[:, :S] & valid
    if hist is not None:
        is_token = is_token & (idx >= hist[:, None])
    return _finish_analysis(data, use, dist, is_token)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

MAX_HEADER_SLOTS = 384  # bfinal/btype + counts + 19 clens + <=320 RLE syms/extras
WORDS_PER_LANE = (MEMBER_DATA * 10 + 8192) // 32  # worst-case dynamic bits


@jax.jit
def emit_device(
    analysis_sym: jnp.ndarray,  # (L, S) litlen symbol per position
    analysis_flags: jnp.ndarray,  # (L, S) int32: 1=token, 2=match
    len_eb: jnp.ndarray,
    len_ev: jnp.ndarray,
    dist_sym: jnp.ndarray,
    dist_eb: jnp.ndarray,
    dist_ev: jnp.ndarray,
    ll_codes: jnp.ndarray,  # (L, 288) packed len<<16 | revcode
    d_codes: jnp.ndarray,  # (L, 30)
    header_vals: jnp.ndarray,  # (L, H) uint32
    header_bits: jnp.ndarray,  # (L, H) int32
    eob_val: jnp.ndarray,  # (L,) uint32
    eob_bits: jnp.ndarray,  # (L,) int32
):
    """Scatter all header+body+EOB bit slots into per-lane uint32 words."""
    L, S = analysis_sym.shape
    H = header_vals.shape[1]
    is_token = (analysis_flags & 1) != 0
    is_match = (analysis_flags & 2) != 0

    ll = jnp.take_along_axis(ll_codes, jnp.clip(analysis_sym, 0, 287), axis=1)
    dd = jnp.take_along_axis(d_codes, jnp.clip(dist_sym, 0, 29), axis=1)

    v0 = jnp.where(is_token, ll & 0xFFFF, 0).astype(jnp.uint32)
    b0 = jnp.where(is_token, ll >> 16, 0).astype(jnp.int32)
    v1 = jnp.where(is_match, len_ev, 0).astype(jnp.uint32)
    b1 = jnp.where(is_match, len_eb, 0).astype(jnp.int32)
    v2 = jnp.where(is_match, dd & 0xFFFF, 0).astype(jnp.uint32)
    b2 = jnp.where(is_match, dd >> 16, 0).astype(jnp.int32)
    v3 = jnp.where(is_match, dist_ev, 0).astype(jnp.uint32)
    b3 = jnp.where(is_match, dist_eb, 0).astype(jnp.int32)

    # Fuse each position's 4 bit slots into 2 before the expensive
    # cumsum + scatter: litlen code + length extra (<= 15+5 bits) and
    # dist code + dist extra (<= 15+13 bits) both fit uint32 slots —
    # halves the slot stream the word packer must move.
    va = v0 | (v1 << b0.astype(jnp.uint32))
    ba = b0 + b1
    vb = v2 | (v3 << b2.astype(jnp.uint32))
    bb = b2 + b3

    body_vals = jnp.stack([va, vb], axis=2).reshape(L, 2 * S)
    body_bits = jnp.stack([ba, bb], axis=2).reshape(L, 2 * S)

    vals = jnp.concatenate([header_vals, body_vals, eob_val[:, None]], axis=1)
    bits = jnp.concatenate([header_bits, body_bits, eob_bits[:, None]], axis=1)

    ends = jnp.cumsum(bits, axis=1)
    offs = ends - bits
    total_bits = ends[:, -1]

    w = offs >> 5
    sh = (offs & 31).astype(jnp.uint32)
    lo = (vals << sh).astype(jnp.uint32)
    hi = jnp.where(sh > 0, vals >> (jnp.uint32(32) - sh), 0).astype(jnp.uint32)
    lanes = jnp.arange(L, dtype=jnp.int32)[:, None]
    words = jnp.zeros((L, WORDS_PER_LANE), jnp.uint32)
    wclip = jnp.where(bits > 0, w, WORDS_PER_LANE)
    words = words.at[lanes, wclip].add(lo, mode="drop")
    words = words.at[lanes, jnp.where(bits > 0, w + 1, WORDS_PER_LANE)].add(
        hi, mode="drop"
    )
    return words, total_bits


# ---------------------------------------------------------------------------
# On-device strategy routing (EP analog, ≙ comp/MultiStrategy.java:31-56)
# ---------------------------------------------------------------------------

ROUTE_DYNAMIC, ROUTE_FIXED, ROUTE_STORED = 0, 1, 2


@jax.jit
def route_strategies(
    ll_hist: jnp.ndarray,  # (L, 288) raw token histogram (no EOB, no bumps)
    d_hist: jnp.ndarray,  # (L, 30)
    ll_len: jnp.ndarray,  # (L, 288) planned dynamic code lengths
    d_len: jnp.ndarray,  # (L, 30)
    hdr_bits: jnp.ndarray,  # (L,) dynamic header bits
    lengths: jnp.ndarray,  # (L,) member data bytes
):
    """Per-lane argmin over the three block strategies, on device.

    Exact bit costs from the histograms the analyze kernel already
    produced: dynamic = header + sum(hist * len) + extra bits + EOB;
    fixed = 3 + sum(hist * fixed_len) + extras + 7; stored =
    8 * (len + 5 * ceil(len / 65535) + 1). Returns (choice (L,) int32,
    dyn_bits, fixed_bits, stored_bits) — the reference's MultiStrategy
    cheapest-plan pick (``comp/MultiStrategy.java:31-56``) computed as a
    batched reduction instead of N sequential trial encodes.
    """
    sym = jnp.arange(288, dtype=jnp.int32)[None, :]
    len_extra = jnp.where((sym >= 265) & (sym <= 284), (sym - 261) >> 2, 0)
    dsym = jnp.arange(30, dtype=jnp.int32)[None, :]
    dist_extra = jnp.maximum((dsym >> 1) - 1, 0)
    extras = jnp.sum(ll_hist * len_extra, axis=1) + jnp.sum(d_hist * dist_extra, axis=1)
    fix_ll = jnp.where(
        sym < 144, 8, jnp.where(sym < 256, 9, jnp.where(sym < 280, 7, 8))
    )
    dyn = (
        hdr_bits
        + jnp.sum(ll_hist * ll_len, axis=1)
        + jnp.sum(d_hist * d_len, axis=1)
        + extras
        + ll_len[:, 256]
    )
    fixed = 3 + jnp.sum(ll_hist * fix_ll, axis=1) + jnp.sum(d_hist * 5, axis=1) + extras + 7
    stored = 8 * (lengths + 5 * (-(-lengths // 65535)) + 1)
    choice = jnp.where(
        stored < jnp.minimum(dyn, fixed),
        ROUTE_STORED,
        jnp.where(fixed < dyn, ROUTE_FIXED, ROUTE_DYNAMIC),
    ).astype(jnp.int32)
    return choice, dyn, fixed, stored


@functools.partial(jax.jit, static_argnames=())
def _apply_route(
    choice: jnp.ndarray,
    ll_codes: jnp.ndarray,
    d_codes: jnp.ndarray,
    header_vals: jnp.ndarray,
    header_bits: jnp.ndarray,
    eob_val: jnp.ndarray,
    eob_bits: jnp.ndarray,
    fix_ll_codes: jnp.ndarray,  # (1, 288)
    fix_d_codes: jnp.ndarray,  # (1, 30)
    final: jnp.ndarray | None = None,  # (L,) 0/1 bfinal per lane
):
    """Swap fixed-Huffman codes/header/EOB into lanes routed FIXED, on
    device — fixed-code blocks then emit from the device like any other."""
    f = (choice == ROUTE_FIXED)[:, None]
    fin = jnp.ones_like(choice) if final is None else final
    ll = jnp.where(f, fix_ll_codes, ll_codes)
    dd = jnp.where(f, fix_d_codes, d_codes)
    hv = jnp.where(f, 0, header_vals).at[:, 0].set(
        # bfinal, then btype=01 LSB-first
        jnp.where(f[:, 0], (fin | 2).astype(jnp.uint32), header_vals[:, 0])
    )
    hb = jnp.where(f, 0, header_bits).at[:, 0].set(
        jnp.where(f[:, 0], 3, header_bits[:, 0])
    )
    ev = jnp.where(f[:, 0], 0, eob_val)
    eb = jnp.where(f[:, 0], 7, eob_bits)
    return ll, dd, hv, hb, ev, eb


@functools.lru_cache(maxsize=1)
def _fixed_code_tables():
    from ..format.tables import FIXED_DIST_LENGTHS, FIXED_LITLEN_LENGTHS

    fl = _pack_codes(FIXED_LITLEN_LENGTHS[None, :].astype(np.int64), MAX_CODE_BITS)
    fd = _pack_codes(FIXED_DIST_LENGTHS[None, :30].astype(np.int64), MAX_CODE_BITS)
    return jnp.asarray(fl), jnp.asarray(fd)


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _pack_codes(lengths: np.ndarray, nbits: int) -> np.ndarray:
    """Batched canonical codes packed as len<<16 | bit-reversed code."""
    from .decode_jax import build_luts_batch  # reuse batched canonical pieces

    L, N = lengths.shape
    # canonical assignment (same math as build_luts_batch, but we need the
    # codes, not the LUT) — compute inline.
    counts = np.zeros((L, nbits + 2), dtype=np.int64)
    for l in range(1, nbits + 1):
        counts[:, l] = (lengths == l).sum(axis=1)
    next_code = np.zeros((L, nbits + 2), dtype=np.int64)
    code = np.zeros(L, dtype=np.int64)
    for l in range(1, nbits + 1):
        code = (code + counts[:, l - 1]) << 1
        next_code[:, l] = code
    order = np.argsort(lengths, axis=1, kind="stable")
    sorted_lens = np.take_along_axis(lengths, order, axis=1)
    group_first = np.zeros((L, nbits + 2), dtype=np.int64)
    for l in range(nbits + 2):
        group_first[:, l] = np.argmax(sorted_lens >= l, axis=1)
    pos_in_sorted = np.empty((L, N), dtype=np.int64)
    np.put_along_axis(pos_in_sorted, order, np.arange(N)[None, :].repeat(L, 0), axis=1)
    ranks = pos_in_sorted - np.take_along_axis(group_first, lengths.astype(np.int64), axis=1)
    codes = np.take_along_axis(next_code, lengths.astype(np.int64), axis=1) + ranks
    rev = np.zeros((L, N), dtype=np.int64)
    c = codes.copy()
    for _ in range(nbits):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    rev = rev >> (nbits - np.maximum(lengths, 1))
    rev = np.where(lengths > 0, rev, 0)
    return ((lengths.astype(np.int64) << 16) | rev).astype(np.int32)


def _build_headers(
    litlen_lengths: np.ndarray,
    dist_lengths: np.ndarray,
    final: np.ndarray | None = None,
):
    """Per-lane dynamic block header slots (host; small).

    Returns (header_vals (L,H) uint32, header_bits (L,H) int32). The
    header is: bfinal(1) btype=10(2) hlit(5) hdist(5) hclen(4),
    hclen*3-bit clen lengths, then the RLE-coded code-length stream.
    ``final`` (L,) 0/1 sets each lane's bfinal bit (default all-final —
    the member-parallel profile); continuous mode finalizes only the
    stream's last block (≙ ``DeflaterOutputStream.java:102-108``).
    """
    from ..format.tables import CLEN_ORDER

    L = litlen_lengths.shape[0]
    if final is None:
        final = np.ones(L, np.int32)
    H = MAX_HEADER_SLOTS
    vals = np.zeros((L, H), dtype=np.uint32)
    bits = np.zeros((L, H), dtype=np.int32)
    # Phase 1: per-lane RLE + clen histograms; the clen Huffman + code
    # assignment then run ONCE batched over lanes (the per-lane calls
    # were ~2/3 of this function's time).
    lane_rle = []
    hists = np.zeros((L, 19), dtype=np.int64)
    for l in range(L):
        ll = litlen_lengths[l]
        dd = dist_lengths[l]
        hi = 288
        while hi > 257 and ll[hi - 1] == 0:
            hi -= 1
        hi_d = 30
        while hi_d > 1 and dd[hi_d - 1] == 0:
            hi_d -= 1
        code_lens = np.concatenate([ll[:hi], dd[:hi_d]])
        syms, extras = _clen_rle(code_lens)
        clen_hist = np.bincount(np.asarray(syms, dtype=np.int64), minlength=19)
        if int((clen_hist > 0).sum()) < 2:
            i = int(np.nonzero(clen_hist)[0][0]) if clen_hist.any() else 0
            clen_hist[(i + 1) % 19] += 1
        hists[l] = clen_hist
        lane_rle.append((hi, hi_d, syms, extras))
    clen_lengths_all = huffman_lengths_batch(hists, 7)
    clen_codes_all = _pack_codes(clen_lengths_all, 7)
    for l in range(L):
        hi, hi_d, syms, extras = lane_rle[l]
        clen_lengths = clen_lengths_all[l]
        clen_codes = clen_codes_all[l]
        reordered = clen_lengths[CLEN_ORDER]
        num_clen = 19
        while num_clen > 4 and reordered[num_clen - 1] == 0:
            num_clen -= 1
        slots = [
            (int(final[l]), 1),  # bfinal
            (2, 2),  # btype dynamic
            (hi - 257, 5),
            (hi_d - 1, 5),
            (num_clen - 4, 4),
        ]
        for i in range(num_clen):
            slots.append((int(reordered[i]), 3))
        ei = iter(extras)
        for s in syms:
            slots.append((int(clen_codes[s]) & 0xFFFF, int(clen_lengths[s])))
            if s >= 16:
                slots.append((next(ei), _CLEN_EXTRA_BITS[s]))
        assert len(slots) <= H, len(slots)
        for j, (v, b) in enumerate(slots):
            vals[l, j] = v
            bits[l, j] = b
    return vals, bits


def compress_members_tpu(data: bytes, *, lazy: bool | None = None, effort: int = 2) -> bytes:
    """Encode ``data`` as a TD-profile multi-member gzip stream.

    ``effort`` maps to device-matcher knobs, mirroring the host preset
    ladder (≙ ``comp/Lz77Huffman.java:298-305``): <=1 greedy parse
    (no lazy deferral), 2 lazy parse with the default candidate set,
    >=3 lazy parse with the widened candidate set (K=24, 64-byte exact
    compares). Explicit ``lazy`` overrides the mapping.

    The three encode stages run as a software pipeline over lane
    batches (the PP analog of SURVEY.md §2.1 row 2, ≙ the reference's
    per-block tokenize -> build codes -> emit structure,
    ``comp/Lz77Huffman.java:68-285``): while batch k's histograms are
    pulled and its Huffman codes planned on the host, batch k+1's
    analyze kernel is already running on the device, and batch k-1's
    emitted words stream back. Token info never leaves the device
    between analyze and emit — only the (L, 288)/(L, 30) histograms and
    the planned code tables move between host and device.
    """
    n = len(data)
    if n == 0:
        from .profile import _empty_member

        return _empty_member()
    if lazy is None:
        lazy = effort >= 2
    quality = 2 if effort >= 5 else (1 if effort >= 3 else 0)
    buf = np.frombuffer(data, dtype=np.uint8)
    step = ENC_LANE_BATCH * MEMBER_DATA
    chunks = [buf[base : base + step] for base in range(0, n, step)]
    out = bytearray()
    pend = _dispatch_analyze(chunks[0], lazy, quality)
    ready = None
    for i in range(len(chunks)):
        cur = pend
        pend = (
            _dispatch_analyze(chunks[i + 1], lazy, quality)
            if i + 1 < len(chunks)
            else None
        )
        em = _plan_and_emit(cur)
        if ready is not None:
            out += _assemble_members(ready)
        ready = em
    out += _assemble_members(ready)
    return bytes(out)


def encode_kernel_bench(data: bytes, *, reps: int = 3) -> dict:
    """Device-encode throughput with the input upload excluded.

    Stages one ENC_LANE_BATCH batch's input in device memory (upload
    untimed), then times the full device+host encode pipeline — analyze
    (match find, parse, histograms), host Huffman planning, routing,
    emit, the sliced word pull and member assembly (companion to the
    decode kernel rows).
    """
    import time

    n = min(len(data), ENC_LANE_BATCH * MEMBER_DATA)
    chunk = np.frombuffer(data, np.uint8)[:n]
    # Warm every shape (and populate the input on device via the normal
    # path once), then time full batches.
    compress_members_tpu(data[:n])

    import jax

    L = ENC_LANE_BATCH
    padded = np.zeros((L, MEMBER_DATA), dtype=np.uint8)
    padded.reshape(-1)[:n] = chunk
    staged = jax.device_put(jnp.asarray(padded))
    np.asarray(jnp.sum(staged.astype(jnp.int32)))

    def one() -> float:
        t0 = time.monotonic()
        em = _plan_and_emit(_dispatch_analyze(chunk, True, 0, staged=staged))
        _assemble_members(em)
        return time.monotonic() - t0

    one()
    best = min(one() for _ in range(reps))
    return {
        "batch_mb": round(n / 2**20, 2),
        "encode_kernel_mbps": round(n / best / 1e6, 2),
        "note": "analyze+plan+emit+assembly, input upload untimed",
    }


def _host_crc32(data: np.ndarray) -> int:
    """Member trailer CRC on host: native C when built (the NumPy table
    kernel was a visible slice of encode wall time)."""
    try:
        from .. import native

        if native.available():
            return native.crc32(data.tobytes())
    except Exception:
        pass
    return crc32(data)


def _dispatch_analyze(chunk: np.ndarray, lazy: bool, quality: int = 0, staged=None):
    """Stage 1: pad one lane batch and issue the analyze kernel.

    ``staged`` (a device array of the padded batch) skips the upload —
    the kernel-only bench uses it to keep the upload off the clock.
    """
    n = chunk.size
    L_real = -(-n // MEMBER_DATA)
    L = ENC_LANE_BATCH
    for b in _ENC_L_BUCKETS:
        if L_real <= b:
            L = b
            break
    lengths = np.zeros(L, dtype=np.int32)
    lengths[:L_real] = MEMBER_DATA
    lengths[L_real - 1] = n - (L_real - 1) * MEMBER_DATA
    padded = np.zeros((L, MEMBER_DATA), dtype=np.uint8)
    padded.reshape(-1)[:n] = chunk
    dd = staged if staged is not None else jnp.asarray(padded)
    a = analyze_device(dd, jnp.asarray(lengths), lazy, quality)
    return a, padded, lengths, L, L_real


def _plan_codes(a, lengths: np.ndarray, L: int, final: np.ndarray | None = None):
    """Host Huffman planning + device routing shared by the
    member-parallel and continuous paths.

    Pulls the device histograms, runs the batched package-merge +
    canonical assignment + header build on host, then routes each lane
    (stored/fixed/dynamic argmin) on device. ``final`` (L,) sets per-
    lane bfinal bits (continuous mode finalizes only the last block).
    Returns device arrays for ``emit_device`` plus the route choice.
    """
    litlen_hist = np.asarray(a["litlen_hist"]).astype(np.int64)
    dist_hist = np.asarray(a["dist_hist"]).astype(np.int64)
    # EOB occurs once per lane.
    litlen_hist[:, 256] += 1
    # degenerate fixes (reference semantics): empty chunk impossible here
    # (lengths >= 1); single used distance -> bump neighbor.
    for l in range(L):
        used = np.nonzero(dist_hist[l])[0]
        if used.size == 1:
            i = int(used[0])
            if i + 1 < 30:
                dist_hist[l, i + 1] = 1
            else:
                dist_hist[l, i - 1] = 1
        if litlen_hist[l].sum() == litlen_hist[l, 256]:
            litlen_hist[l, 0] += 1

    ll_lengths = huffman_lengths_batch(litlen_hist, MAX_CODE_BITS)
    d_lengths = huffman_lengths_batch(dist_hist, MAX_CODE_BITS)
    # single-distance lanes got >=2 symbols via the bump; all-literal lanes
    # have all-zero dist lengths -> hdist=1 with zero length (empty code).
    ll_codes = _pack_codes(ll_lengths, MAX_CODE_BITS)
    d_codes = _pack_codes(d_lengths, MAX_CODE_BITS)

    header_vals, header_bits = _build_headers(ll_lengths, d_lengths, final)
    eob_val = (ll_codes[:, 256] & 0xFFFF).astype(np.uint32)
    eob_bits = (ll_codes[:, 256] >> 16).astype(np.int32)

    # On-device strategy routing (EP analog): exact stored/fixed/dynamic
    # bit costs from the device-resident histograms, argmin per lane,
    # fixed-code lanes swap in the static tables before the single emit.
    # int32 throughout: max dynamic cost ~560k bits per 64 KiB lane fits
    # comfortably, and x64 is disabled (int64 would truncate + warn).
    choice, _dyn, _fx, _st = route_strategies(
        a["litlen_hist"].astype(jnp.int32),
        a["dist_hist"].astype(jnp.int32),
        jnp.asarray(ll_lengths.astype(np.int32)),
        jnp.asarray(d_lengths.astype(np.int32)),
        jnp.asarray(header_bits.sum(axis=1).astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)),
    )
    fl, fd = _fixed_code_tables()
    ll_c, d_c, hv, hb, ev, eb = _apply_route(
        choice,
        jnp.asarray(ll_codes),
        jnp.asarray(d_codes),
        jnp.asarray(header_vals),
        jnp.asarray(header_bits),
        jnp.asarray(eob_val),
        jnp.asarray(eob_bits),
        fl,
        fd,
        None if final is None else jnp.asarray(final.astype(np.int32)),
    )
    return ll_c, d_c, hv, hb, ev, eb, choice


def _plan_and_emit(pend):
    """Stage 2: pull the histograms, plan codes on host, issue emit."""
    a, padded, lengths, L, L_real = pend
    ll_c, d_c, hv, hb, ev, eb, choice = _plan_codes(a, lengths, L)

    # Token info stays on device between analyze and emit.
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words, total_bits = emit_device(
        a["litlen_sym"],
        flags,
        a["len_eb"],
        a["len_ev"],
        a["dist_sym"],
        a["dist_eb"],
        a["dist_ev"],
        ll_c,
        d_c,
        hv,
        hb,
        ev,
        eb,
    )
    # words is pulled SLICED in _assemble_members (the fixed worst-case
    # width is ~4x the real compressed bits).
    total_bits.copy_to_host_async()
    choice.copy_to_host_async()
    return words, total_bits, choice, padded, lengths, L_real


def _assemble_members(em) -> bytes:
    """Stage 3: pull emitted words, frame members on host."""
    words, total_bits, choice, padded, lengths, L_real = em
    total_bits = np.asarray(total_bits)
    mw = min(words.shape[1], -(-int(total_bits[:L_real].max()) // 32 // 512) * 512 or 512)
    words = np.asarray(words[:, :mw])
    choice = np.asarray(choice)
    L = words.shape[0]

    # Member CRCs: one batched device call when asked for
    # (_device_crc_wanted); a failure there propagates.
    crcs = None
    if _device_crc_wanted():
        from ..kernels.checksum_jax import crc32_members

        crcs = crc32_members(padded[:L_real], lengths[:L_real])
    out = bytearray()
    payload_bytes = words.view(np.uint8).reshape(L, -1)
    if not np.little_endian:  # pragma: no cover
        payload_bytes = words.byteswap().view(np.uint8).reshape(L, -1)
    for l in range(L_real):
        ln = int(lengths[l])
        member_data = padded[l, :ln]
        crc = int(crcs[l]) if crcs is not None else _host_crc32(member_data)
        nbytes = (int(total_bits[l]) + 7) // 8
        stored_cost = ln + 5 * (-(-ln // 65535)) + 1
        # Device-routed choice (route_strategies); the emitted-size check
        # stays as a backstop so a cost-model defect can never grow the
        # output past the stored bound.
        if choice[l] == ROUTE_STORED or nbytes >= stored_cost:
            w = BitWriter()
            from .deflate_encode import StoredPlan

            StoredPlan(member_data).emit(w, True)
            w.align_to_byte()
            payload = w.getvalue()
        else:
            payload = payload_bytes[l, :nbytes].tobytes()
        out += build_member(payload, ln, crc)
    return bytes(out)


def gzip_compress_tpu(data: bytes, *, effort: int = 2, metadata=None) -> bytes:
    """Drop-in device compressor (metadata applies to a leading empty
    member when provided, keeping the stream splittable)."""
    out = compress_members_tpu(data)
    if metadata is not None:
        import io as _io

        from ..streams.gzip_stream import GzipWriter

        sink = _io.BytesIO()
        wr = GzipWriter(sink, metadata)
        wr.finish()
        return sink.getvalue() + out
    return out


# ---------------------------------------------------------------------------
# Continuous-history device encode (max-ratio mode: one member, 32 KiB
# sliding history across blocks — the device analog of the host/C
# continuous encoders; ≙ DeflaterOutputStream's sliding [history][data]
# buffer, DeflaterOutputStream.java:38-45,119-137)
# ---------------------------------------------------------------------------

HALO_COLS = 32 * 1024  # fixed halo prefix width of a continuous lane row


def _continuous_encode_lanes(
    rows: np.ndarray,  # (L, HALO_COLS + B) uint8 [halo | payload]
    hstart: np.ndarray,  # (L,) first real history column
    pay_lens: np.ndarray,  # (L,) payload bytes per lane
    final: np.ndarray,  # (L,) 0/1 bfinal
    lazy: bool,
    quality: int,
    mesh=None,
    axis: str = "data",
):
    """Batched device encode of continuous-history lanes.

    Every lane is one DEFLATE block whose match search reaches into its
    32 KiB halo prefix (tokens cover only the payload columns). Returns
    (words (L, W) uint32 host, total_bits (L,), choice (L,)) — block
    bit-streams for the host splicer. ``mesh`` runs analyze and emit on
    every device over its own lane shard (L divides by the mesh size).
    """
    L, S = rows.shape
    lengths = (HALO_COLS + pay_lens).astype(np.int32)
    hist = np.full((L,), HALO_COLS, np.int32)
    def analyze(data, lens, hist, hstart):
        return analyze_device(data, lens, lazy, quality, hist, hstart)

    emit = emit_device
    put = jax.device_put
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        lane = P(axis)
        analyze = jax.shard_map(analyze, mesh=mesh, in_specs=lane, out_specs=lane)
        emit = jax.shard_map(emit, mesh=mesh, in_specs=lane, out_specs=lane)

        def put(x):  # host array straight onto its lane shards
            return jax.device_put(x, NamedSharding(mesh, lane))

    a = analyze(put(rows), put(lengths), put(hist), put(hstart.astype(np.int32)))
    ll_c, d_c, hv, hb, ev, eb, choice = _plan_codes(
        a, pay_lens.astype(np.int64), L, final.astype(np.int32)
    )
    flags = a["is_token"].astype(jnp.int32) | (a["is_match"].astype(jnp.int32) << 1)
    words, total_bits = emit(
        a["litlen_sym"], flags, a["len_eb"], a["len_ev"],
        a["dist_sym"], a["dist_eb"], a["dist_ev"],
        ll_c, d_c, hv, hb, ev, eb,
    )
    total_bits = np.asarray(total_bits)
    mx = int(total_bits.max()) if L else 0
    mw = min(words.shape[1], max(-(-mx // 32), 1))
    return np.asarray(words[:, :mw]), total_bits, np.asarray(choice)


class _BitSplicer:
    """Incremental bit-level stream appender (host).

    The continuous member is ONE bit stream: each lane's block lands at
    the running bit offset (Huffman bodies are alignment-independent);
    stored-routed lanes are emitted here instead of on device because
    their byte-alignment padding depends on this exact offset
    (≙ comp/Uncompressed.java:23-26's alignment-dependent cost).
    """

    def __init__(self):
        self.out = bytearray()
        self.bitpos = 0

    def append(self, sb: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        r = self.bitpos & 7
        arr = np.frombuffer(sb, np.uint8)
        if r == 0:
            self.out += sb
        else:
            lo = ((arr.astype(np.uint16) << r) & 0xFF).astype(np.uint8)
            hi = (arr >> (8 - r)).astype(np.uint8)
            self.out[-1] |= int(lo[0])
            self.out += (lo[1:] | hi[:-1]).tobytes()
            self.out.append(int(hi[-1]))
        self.bitpos += nbits
        del self.out[(self.bitpos + 7) // 8 :]

    def append_stored(self, member_data: np.ndarray, final: bool) -> None:
        from .deflate_encode import StoredPlan

        r = self.bitpos & 7
        w = BitWriter()
        if r:
            w.write_bits(0, r)  # alignment shim: emit at the true offset
        StoredPlan(member_data).emit(w, final)
        sb = w.getvalue()
        nb = w.bit_position
        if r:
            self.out[-1] |= sb[0]
            self.out += sb[1:]
            self.bitpos += nb - r
        else:
            self.out += sb
            self.bitpos += nb
        del self.out[(self.bitpos + 7) // 8 :]

    def payload(self) -> bytes:
        return bytes(self.out)


def compress_continuous_tpu(
    data: bytes,
    *,
    effort: int = 4,
    block_data: int = MEMBER_DATA,
    lane_batch: int = ENC_LANE_BATCH,
    mesh=None,
    axis: str = "data",
) -> bytes:
    """Single-member max-ratio gzip: device encode with 32 KiB
    continuous history across blocks.

    The device effort ladder's top tier (efforts >= 4, mirroring the
    host ladder where continuous history is what beats zlib-9): the
    input splits into ``block_data`` blocks, each lane row carries the
    previous 32 KiB as a halo prefix, the batched analyze/emit kernels
    run with history masking, and the host splices the block bit-streams
    into ONE gzip member (no per-member history resets).

    ``mesh`` lane-shards the analyze+emit graph over a device mesh
    (lanes are independent given their halos — the SP/CP seam).
    """
    from .profile import _empty_member

    n = len(data)
    if n == 0:
        return _empty_member()
    lazy = effort >= 2
    quality = 2 if effort >= 5 else (1 if effort >= 3 else 0)
    flat = np.frombuffer(data, np.uint8)
    nlanes = -(-n // block_data)
    sp = _BitSplicer()
    for base in range(0, nlanes, lane_batch):
        Lb = min(lane_batch, nlanes - base)
        L = Lb
        if mesh is not None:
            D = int(mesh.devices.size)
            L = -(-Lb // D) * D  # pad lanes to the mesh size
        rows = np.zeros((L, HALO_COLS + block_data), np.uint8)
        hstart = np.full(L, HALO_COLS, np.int32)
        pay_lens = np.zeros(L, np.int32)
        final = np.zeros(L, np.int32)
        for i in range(Lb):
            l = base + i
            p0 = l * block_data
            pay = flat[p0 : p0 + block_data]
            h = min(HALO_COLS, p0)
            rows[i, HALO_COLS - h : HALO_COLS] = flat[p0 - h : p0]
            rows[i, HALO_COLS : HALO_COLS + pay.size] = pay
            hstart[i] = HALO_COLS - h
            pay_lens[i] = pay.size
            final[i] = 1 if p0 + pay.size >= n else 0
        pay_lens[Lb:] = 1  # padding lanes: 1 dummy byte, never final
        words, total_bits, choice = _continuous_encode_lanes(
            rows, hstart, pay_lens, final, lazy, quality, mesh, axis
        )
        wbytes = words.view(np.uint8).reshape(words.shape[0], -1)
        for i in range(Lb):
            ln = int(pay_lens[i])
            stored_cost_bits = 8 * (ln + 5 * (-(-ln // 65535)) + 1)
            nb = int(total_bits[i])
            if choice[i] == ROUTE_STORED or nb >= stored_cost_bits:
                sp.append_stored(
                    rows[i, HALO_COLS : HALO_COLS + ln], bool(final[i])
                )
            else:
                sp.append(wbytes[i, : (nb + 7) // 8].tobytes(), nb)
    return build_member(sp.payload(), n, _host_crc32(flat))
