"""Canonical Huffman machinery: construction, validation, decode tables.

Encoder side:
- :func:`package_merge_lengths` — optimal length-limited code lengths
  (same algorithm family as ``comp/Lz77Huffman.java:309-335``).
- :func:`canonical_codes` — canonical code assignment, returned bit-reversed
  for LSB-first emission (``comp/Lz77Huffman.java:372-391``).

Decoder side:
- :func:`validate_code_lengths` — replicates the reference tree builder's
  exact error selection and precedence (``decomp/Open.java:705-756``):
  fewer than 2 codes -> UNDER_FULL; per-level over-subscription -> OVER_FULL;
  running out of internal-node capacity while descending -> UNDER_FULL;
  leftover open slots at the end -> UNDER_FULL.
- :func:`build_decode_lut` — flat 2^15-entry (symbol, length) lookup table
  keyed by the next 15 stream bits, the host/device shared decode structure
  (generalizes the reference's 9-bit table + tree walk,
  ``decomp/Open.java:765-789``, to a single full-depth LUT).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..format.errors import DataFormatError, Reason
from ..format.tables import MAX_CODE_LEN

LUT_BITS = MAX_CODE_LEN  # 15: one lookup always resolves a symbol


def validate_code_lengths(lengths: np.ndarray) -> None:
    """Validate that code lengths form a complete canonical code.

    Raises DataFormatError(HUFFMAN_CODE_UNDER_FULL / OVER_FULL) with the same
    precedence as the reference's incremental tree construction.
    """
    lengths = np.asarray(lengths)
    used = lengths[lengths > 0]
    n = used.size
    if n < 2:
        raise DataFormatError(
            Reason.HUFFMAN_CODE_UNDER_FULL,
            "This canonical code produces an under-full Huffman code tree",
        )
    counts = np.bincount(used, minlength=MAX_CODE_LEN + 1)
    max_present = int(used.max())
    open_slots = 2  # the root's two children
    internals = 1  # the root
    remaining = n
    for level in range(1, max_present + 1):
        c = int(counts[level])
        if c > open_slots:
            raise DataFormatError(
                Reason.HUFFMAN_CODE_OVER_FULL,
                "This canonical code produces an over-full Huffman code tree",
            )
        open_slots -= c
        remaining -= c
        if remaining == 0:
            break
        # Descend one level: every open slot becomes an internal node.
        internals += open_slots
        if internals > n - 1:
            raise DataFormatError(
                Reason.HUFFMAN_CODE_UNDER_FULL,
                "This canonical code produces an under-full Huffman code tree",
            )
        open_slots *= 2
    if open_slots > 0:
        raise DataFormatError(
            Reason.HUFFMAN_CODE_UNDER_FULL,
            "This canonical code produces an under-full Huffman code tree",
        )


def _bit_reverse(values: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Reverse the low nbits of each value (vectorized)."""
    v = np.asarray(values, dtype=np.uint32)
    # Classic byte-wise reversal of a 16-bit field, then shift down.
    r = v & np.uint32(0)
    x = v.copy()
    r = np.zeros_like(v)
    for _ in range(16):
        r = (r << np.uint32(1)) | (x & np.uint32(1))
        x >>= np.uint32(1)
    return (r >> (np.uint32(16) - nbits.astype(np.uint32))).astype(np.uint32)


def canonical_codes(lengths: np.ndarray, *, validate: bool = True) -> np.ndarray:
    """Canonical codes (RFC 1951 §3.2.2), returned bit-reversed for LSB-first
    emission. Entries with length 0 get code 0.

    Codes are assigned in (length, symbol) order: within each length,
    ascending symbol index.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    if validate:
        validate_code_lengths(lengths)
    counts = np.bincount(lengths[lengths > 0], minlength=MAX_CODE_LEN + 1).astype(np.int64)
    next_code = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
    code = 0
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code
    # Rank of each symbol within its length class (by symbol order).
    order = np.argsort(lengths, kind="stable")  # groups by length, stable by symbol
    codes = np.zeros_like(lengths)
    sorted_lens = lengths[order]
    # positions within each length group
    group_start = np.searchsorted(sorted_lens, np.arange(MAX_CODE_LEN + 2))
    ranks = np.arange(lengths.size) - group_start[sorted_lens]
    codes[order] = next_code[sorted_lens] + ranks
    codes[lengths == 0] = 0
    rev = _bit_reverse(codes, np.maximum(lengths, 1))
    rev[lengths == 0] = 0
    return rev.astype(np.uint32)


@dataclass
class DecodeTable:
    """Flat full-depth decode LUT: index with the next 15 stream bits."""

    symbol: np.ndarray  # int32[2^15]
    length: np.ndarray  # int32[2^15]
    max_len: int


def build_decode_lut(lengths: np.ndarray) -> DecodeTable:
    """Build a 2^15 LUT from validated code lengths.

    Caller is responsible for having run :func:`validate_code_lengths` (or
    for passing deliberately padded lengths, e.g. the single-distance-code
    dummy). All 2^15 entries resolve because the code is complete.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    rev_codes = canonical_codes(lengths, validate=False)
    sym_lut = np.zeros(1 << LUT_BITS, dtype=np.int32)
    len_lut = np.zeros(1 << LUT_BITS, dtype=np.int32)
    for sym in np.nonzero(lengths > 0)[0]:
        l = int(lengths[sym])
        base = int(rev_codes[sym])
        idx = base + (np.arange(1 << (LUT_BITS - l)) << l)
        sym_lut[idx] = sym
        len_lut[idx] = l
    return DecodeTable(symbol=sym_lut, length=len_lut, max_len=int(lengths.max(initial=0)))


# ---------------------------------------------------------------------------
# Package-merge: optimal length-limited Huffman code lengths
# ---------------------------------------------------------------------------


def huffman_lengths_batch(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal-or-near-optimal code lengths for many histograms at once.

    Lock-step vectorization across lanes: the two-queue Huffman algorithm
    (leaves presorted; merged nodes emerge in nondecreasing cost order) runs
    one merge per step for every lane simultaneously; depths then propagate
    root-to-leaf; finally lengths exceeding ``max_len`` are repaired with
    the zlib-style bl_count adjustment. Output code lengths are therefore
    zlib-quality (optimal when the unbounded tree fits in max_len).

    freqs: (L, N) int64. Lanes with 0 used symbols get all-zero lengths;
    lanes with 1 used symbol get that symbol at length 1. Returns (L, N)
    int32 lengths forming complete codes (for >= 2 used symbols).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    L, N = freqs.shape
    INF = np.int64(1) << 60
    lanes = np.arange(L)

    f = np.where(freqs > 0, freqs, INF)
    order = np.argsort(f, axis=1, kind="stable")
    sf = np.take_along_axis(f, order, axis=1)
    n_used = (freqs > 0).sum(axis=1)
    merges = np.maximum(n_used - 1, 0)

    q2cost = np.full((L, N), INF, dtype=np.int64)
    parent = np.full((L, 2 * N), -1, dtype=np.int32)
    h1 = np.zeros(L, dtype=np.int64)
    h2 = np.zeros(L, dtype=np.int64)
    t2 = np.zeros(L, dtype=np.int64)

    def _heads():
        c1 = np.where(h1 < N, sf[lanes, np.minimum(h1, N - 1)], INF)
        c2 = np.where(h2 < t2, q2cost[lanes, np.minimum(h2, N - 1)], INF)
        return c1, c2

    steps = int(merges.max()) if L else 0
    for s in range(steps):
        active = s < merges
        c1, c2 = _heads()
        take1 = c1 <= c2
        cost_a = np.where(take1, c1, c2)
        id_a = np.where(take1, h1, N + h2).astype(np.int64)
        h1 = h1 + (active & take1)
        h2 = h2 + (active & ~take1)
        c1, c2 = _heads()
        take1 = c1 <= c2
        cost_b = np.where(take1, c1, c2)
        id_b = np.where(take1, h1, N + h2).astype(np.int64)
        h1 = h1 + (active & take1)
        h2 = h2 + (active & ~take1)
        new_id = N + t2
        a_idx = np.nonzero(active)[0]
        q2cost[a_idx, t2[a_idx]] = (cost_a + cost_b)[a_idx]
        parent[a_idx, id_a[a_idx]] = new_id[a_idx]
        parent[a_idx, id_b[a_idx]] = new_id[a_idx]
        t2 = t2 + active

    # Depths of merged nodes, processed in decreasing id (parents first).
    depth = np.zeros((L, 2 * N), dtype=np.int32)
    for j in range(steps - 1, -1, -1):
        nid = N + j
        p = parent[lanes, nid]
        valid = (j < t2) & (p >= 0)
        v_idx = np.nonzero(valid)[0]
        depth[v_idx, nid] = depth[v_idx, p[v_idx]] + 1
    leaf_parent = parent[:, :N]
    leaf_depth = np.where(
        leaf_parent >= 0,
        np.take_along_axis(depth, np.maximum(leaf_parent, 0).astype(np.int64), axis=1) + 1,
        0,
    ).astype(np.int64)

    # bl_count with clamping at max_len, then exact Kraft repair: each move
    # (one leaf from depth b to b+1, pairing it with a relocated max-depth
    # leaf) frees exactly one depth-max_len slot; iterate until the code is
    # exactly complete (integer slot accounting, so no over/undershoot).
    clamped = np.minimum(leaf_depth, max_len)
    clamped = np.where(leaf_parent >= 0, clamped, 0)
    bl_count = np.zeros((L, max_len + 1), dtype=np.int64)
    for l in range(1, max_len + 1):
        bl_count[:, l] = (clamped == l).sum(axis=1)
    slot_w = np.int64(1) << (max_len - np.arange(max_len + 1))
    slot_w[0] = 0
    full = np.int64(1) << max_len
    needed = (bl_count * slot_w[None, :]).sum(axis=1)
    needed = np.where(merges > 0, needed, full)  # degenerate lanes: skip
    while (needed > full).any():
        act = needed > full
        # highest bits < max_len with bl_count > 0
        bits = np.zeros(L, dtype=np.int64)
        found = np.zeros(L, dtype=bool)
        for b in range(max_len - 1, 0, -1):
            sel = act & ~found & (bl_count[:, b] > 0)
            bits[sel] = b
            found |= sel
        a_idx = np.nonzero(act & found)[0]
        bl_count[a_idx, bits[a_idx]] -= 1
        bl_count[a_idx, bits[a_idx] + 1] += 2
        bl_count[a_idx, max_len] -= 1
        needed = needed - np.where(act & found, 1, 0)

    # Reassign lengths: ascending-frequency used symbols get descending
    # lengths according to bl_count (lane-major repeat trick).
    lens_desc = np.arange(max_len, 0, -1)
    rep_counts = bl_count[:, ::-1][:, :max_len]  # counts for max_len..1
    flat_lens = np.repeat(np.tile(lens_desc, L), rep_counts.ravel())
    lane_totals = rep_counts.sum(axis=1)
    starts = np.concatenate([[0], np.cumsum(lane_totals)[:-1]])

    lengths = np.zeros((L, N), dtype=np.int32)
    for l_i in range(L):
        if int(n_used[l_i]) == 1:
            lengths[l_i, order[l_i, 0]] = 1
            continue
        cnt = int(lane_totals[l_i])
        if cnt == 0:
            continue
        assigned = flat_lens[starts[l_i] : starts[l_i] + cnt]
        lengths[l_i, order[l_i, :cnt]] = assigned
    return lengths


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Compute optimal code lengths bounded by ``max_len``.

    Requires at least 2 nonzero frequencies (callers enforce the reference's
    degenerate-histogram fixes first: ``comp/Lz77Huffman.java:146-179``).
    Returns an int32 array of code lengths (0 for unused symbols) forming a
    complete canonical code.

    Implementation: iterative package-merge over (cost, leaf-count-vector)
    items, vectorized with NumPy; alphabet sizes here are <= 320 so the
    count matrices stay tiny.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    syms = np.nonzero(freqs > 0)[0]
    n = syms.size
    if n < 2:
        raise ValueError("package_merge_lengths requires >= 2 used symbols")
    if n > (1 << max_len):
        raise ValueError("alphabet cannot fit in max_len bits")

    leaf_costs = freqs[syms]
    # Sort leaves once by frequency (stable: ties keep symbol order).
    order = np.argsort(leaf_costs, kind="stable")
    leaf_costs = leaf_costs[order]
    leaf_syms = syms[order]

    # items: costs[k], counts[k, n] = how many times each leaf appears.
    costs = leaf_costs.copy()
    counts = np.eye(n, dtype=np.int32)
    for _ in range(max_len - 1):
        # Package adjacent pairs.
        m = costs.size // 2 * 2
        pkg_costs = costs[0:m:2] + costs[1:m:2]
        pkg_counts = counts[0:m:2] + counts[1:m:2]
        # Merge with the leaf list (both sorted; stable: leaves first on tie,
        # matching a stable sort of leaves-then-packages concatenation).
        all_costs = np.concatenate([leaf_costs, pkg_costs])
        all_counts = np.concatenate([np.eye(n, dtype=np.int32), pkg_counts])
        o = np.argsort(all_costs, kind="stable")
        costs = all_costs[o]
        counts = all_counts[o]
    # Code length of each leaf = occurrences among the first 2n-2 items.
    total = counts[: 2 * n - 2].sum(axis=0)
    lengths = np.zeros(freqs.size, dtype=np.int32)
    lengths[leaf_syms] = total
    return lengths
