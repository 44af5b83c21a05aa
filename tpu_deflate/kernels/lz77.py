"""LZ77 match finding and parallel parse (host/NumPy data-parallel form).

The reference's matcher is a sequential exhaustive scan per position with
greedy commit (``comp/Lz77Huffman.java:68-130``). That formulation is
unusable on a vector machine, so this framework recasts LZ77 as three
data-parallel stages — the same shape the device kernels use:

1. **Candidate generation**: hash the 4-byte window at every position;
   bucket-sort (stable) by (hash, position); each position's candidates are
   its K predecessors in the bucket.
2. **Match scoring**: vectorized prefix-compare of each (position,
   candidate) pair in 16-byte chunks; keep the best (longest, then nearest)
   match per position. This computes the best match at EVERY position
   independently — no serial dependency.
3. **Parse**: greedy (or lazy) token selection becomes a pointer-jumping
   problem: ``next[p] = p + run[p]`` (or ``p+1`` for a literal); the token
   sequence is the orbit of position 0, computed with O(log n) rounds of
   pointer doubling instead of a serial walk.

Matching semantics preserved from the reference: window search includes the
history prefix of previous chunks; ties broken toward the smallest
distance; overlapping matches (dist < run) allowed; runs capped at 258 and
emitted only when >= min_run.
"""

from __future__ import annotations

import numpy as np

from ..format.tables import MAX_RUN

HASH_MUL = np.uint32(2654435761)


def _hash4(data: np.ndarray, hash_bits: int) -> np.ndarray:
    """32-bit multiplicative hash of the 4 bytes starting at each position.

    Positions n-3..n-1 (fewer than 4 bytes left) get arbitrary hashes; the
    verifier stage rejects false candidates anyway.
    """
    n = data.size
    x = np.zeros(n, dtype=np.uint32)
    if n >= 4:
        d = data.astype(np.uint32)
        x[: n - 3] = d[: n - 3] | (d[1 : n - 2] << np.uint32(8)) | (
            d[2 : n - 1] << np.uint32(16)
        ) | (d[3:n] << np.uint32(24))
    return (x * HASH_MUL) >> np.uint32(32 - hash_bits)


def _hash3(data: np.ndarray, hash_bits: int) -> np.ndarray:
    """Hash of the 3 bytes at each position — the minimum-match-length
    level, so length-3 matches are discoverable (a 4-byte key loses every
    len-3 match)."""
    n = data.size
    x = np.zeros(n, dtype=np.uint32)
    if n >= 3:
        d = data.astype(np.uint32)
        x[: n - 2] = d[: n - 2] | (d[1 : n - 1] << np.uint32(8)) | (
            d[2:n] << np.uint32(16)
        )
    return (x * HASH_MUL) >> np.uint32(32 - hash_bits)


def _hash8(data: np.ndarray, hash_bits: int) -> np.ndarray:
    """Hash of the 8 bytes at each position (the long-match level).

    A second candidate level keyed on 8-byte windows surfaces long matches
    whose nearest 4-byte-prefix twins crowd them out of the short buckets
    (periodic/structured data with point noise).
    """
    n = data.size
    x = np.zeros(n, dtype=np.uint64)
    if n >= 8:
        d = data.astype(np.uint64)
        acc = np.zeros(n - 7, dtype=np.uint64)
        for b in range(8):
            acc |= d[b : n - 7 + b] << np.uint64(8 * b)
        x[: n - 7] = acc
    return ((x * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - hash_bits)).astype(
        np.uint32
    )


def find_best_matches(
    data: np.ndarray,
    start: int,
    *,
    min_run: int = 3,
    max_run: int = MAX_RUN,
    min_dist: int = 1,
    max_dist: int = 32 * 1024,
    max_candidates: int = 16,
    hash_bits: int = 15,
) -> tuple[np.ndarray, np.ndarray]:
    """Best match (run, dist) at every position in data[start:].

    data: uint8 array = [history | chunk]; start = history length. Matches
    may begin inside the history (reference semantics, Lz77Huffman.java:71).

    Returns (run, dist) int32 arrays of length n-start; run=0 where no match
    of >= min_run exists (or the grid is disabled via min_run=0).
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    m = n - start
    if m <= 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if min_run == 0 or max_run == 0:
        return np.zeros(m, np.int32), np.zeros(m, np.int32)

    if min_dist == 1 and max_dist == 1:
        return _rle_matches(data, start, min_run, max_run)

    best_run = np.zeros(m, dtype=np.int32)
    best_dist = np.zeros(m, dtype=np.int32)
    pos = np.arange(start, n, dtype=np.int64)

    # Three candidate levels: 3-byte hash (minimum match length — finds
    # len-3 matches), 4-byte hash (denser buckets for typical matches),
    # 8-byte hash (long matches that crowd out of the short buckets).
    # Level hashes are bucket keys only — the scorer verifies every byte.
    levels = [_hash3(data, hash_bits), _hash4(data, hash_bits)]
    if n >= 8 and max_candidates >= 8:
        levels.append(_hash8(data, hash_bits))

    for h in levels:
        # Stable sort by hash groups positions; within a group positions
        # ascend, so the k-th predecessor in the bucket is the k-nearest
        # earlier position with the same key.
        order = np.argsort(h, kind="stable").astype(np.int64)
        sorted_h = h[order]
        group_changed = np.empty(n, dtype=bool)
        group_changed[0] = True
        group_changed[1:] = sorted_h[1:] != sorted_h[:-1]
        group_id = np.cumsum(group_changed) - 1
        first_idx = np.nonzero(group_changed)[0]
        group_first = first_idx[group_id]
        rank = np.arange(n, dtype=np.int64) - group_first

        for k in range(1, max_candidates + 1):
            valid = rank >= k
            cand_sorted = np.where(valid, order[np.maximum(np.arange(n) - k, 0)], -1)
            cand_full = np.empty(n, dtype=np.int64)
            cand_full[order] = cand_sorted  # candidate position, by position
            cand = cand_full[start:]
            dist = pos - cand
            ok = (cand >= 0) & (dist >= min_dist) & (dist <= max_dist)
            if not ok.any():
                continue
            run = _match_lengths(data, pos, cand, ok, max_run)
            run = np.where(ok, run, 0)
            # Prefer longer runs; on ties prefer the nearer candidate (k
            # ascends distance within a level; across levels, keep the
            # incumbent unless strictly longer, then fix up equal-run
            # smaller-distance below).
            better = (run > best_run) | ((run == best_run) & (run > 0) & (dist < best_dist))
            best_run = np.where(better, run, best_run)
            best_dist = np.where(better, dist.astype(np.int32), best_dist)

    best_run = np.where(best_run >= min_run, best_run, 0)
    best_dist = np.where(best_run > 0, best_dist, 0)
    # A match cannot extend past the end of the buffer; _match_lengths caps.
    return best_run, best_dist


def _match_lengths(
    data: np.ndarray, pos: np.ndarray, cand: np.ndarray, ok: np.ndarray, max_run: int
) -> np.ndarray:
    """Common-prefix length of data[pos:] vs data[cand:], capped at max_run
    and the buffer end. Vectorized in 16-byte chunks with early exit."""
    n = data.size
    run = np.zeros(pos.size, dtype=np.int32)
    active = ok.copy()
    limit = np.minimum(max_run, n - pos).astype(np.int32)
    chunk = 16
    # Pad data so fixed-size chunk loads never go out of bounds; pad bytes
    # can't produce false matches because `limit` caps at the true end...
    pad = np.concatenate([data, np.zeros(chunk + max_run, dtype=np.uint8)])
    offset = 0
    while active.any() and offset < max_run:
        a_idx = pos[active] + offset
        c_idx = cand[active] + offset
        eq = np.ones(a_idx.size, dtype=bool)
        add = np.zeros(a_idx.size, dtype=np.int32)
        # Compare 16 bytes; find first mismatch.
        blk_a = pad[a_idx[:, None] + np.arange(chunk)]
        blk_c = pad[c_idx[:, None] + np.arange(chunk)]
        neq = blk_a != blk_c
        first = np.where(neq.any(axis=1), neq.argmax(axis=1), chunk).astype(np.int32)
        run_active = run[active] + first
        run[active] = run_active
        still = first == chunk
        new_active = np.zeros_like(active)
        idx_active = np.nonzero(active)[0]
        new_active[idx_active[still]] = True
        active = new_active
        offset += chunk
    return np.minimum(run, limit)


def _rle_matches(
    data: np.ndarray, start: int, min_run: int, max_run: int
) -> tuple[np.ndarray, np.ndarray]:
    """Specialized distance-1 matcher (the RLE_* strategy family).

    run[p] = length of the run of bytes equal to data[p-1] starting at p,
    capped at max_run. Fully vectorized via run-boundary prefix tricks.
    """
    n = data.size
    m = n - start
    eq_prev = np.zeros(n, dtype=bool)
    eq_prev[1:] = data[1:] == data[:-1]
    # For each p, the length of consecutive True starting at p in eq_prev:
    # standard trick: distance to next False.
    idx = np.arange(n + 1, dtype=np.int64)
    false_pos = np.nonzero(~np.concatenate([eq_prev, np.array([False])]))[0]
    next_false = false_pos[np.searchsorted(false_pos, idx[:n])]
    run = (next_false - idx[:n]).astype(np.int32)
    run = np.minimum(run, max_run)
    run = run[start:]
    run = np.where(run >= min_run, run, 0)
    dist = np.where(run > 0, 1, 0).astype(np.int32)
    return run.astype(np.int32), dist


def parse_tokens(
    run: np.ndarray,
    dist: np.ndarray,
    *,
    min_run: int,
    lazy: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy (optionally lazy) parse via pointer doubling.

    run/dist: best match at every position (run=0 -> literal only).
    Returns (token_pos, token_run, token_dist) where token_run=0 denotes a
    literal at token_pos. Token order is ascending position — identical to
    the serial greedy walk's output.
    """
    m = run.size
    if m == 0:
        return (np.zeros(0, np.int64),) + (np.zeros(0, np.int32),) * 2
    run = run.astype(np.int64)
    use = run.copy()
    if lazy:
        # Defer a match when the next position has a strictly longer one
        # (one-step lazy evaluation, zlib-style).
        nxt = np.zeros_like(use)
        nxt[:-1] = use[1:]
        defer = (use > 0) & (nxt > use)
        use = np.where(defer, 0, use)
    step = np.where(use > 0, use, 1)
    nxt = np.minimum(np.arange(m, dtype=np.int64) + step, m)

    # Orbit of 0 under `nxt` by pointer doubling: after round k, reached
    # holds every nxt^j(0) with j < 2^(k+1).
    reached = np.zeros(m + 1, dtype=bool)
    reached[0] = True
    jump = np.concatenate([nxt, np.array([m], dtype=np.int64)])
    max_rounds = int(np.ceil(np.log2(max(m, 2)))) + 1
    for _ in range(max_rounds):
        hit = np.zeros(m + 1, dtype=bool)
        src = np.nonzero(reached)[0]
        hit[jump[src]] = True
        new_reached = reached | hit
        if new_reached[m] and (new_reached == reached).all():
            break
        reached = new_reached
        jump = jump[jump]

    token_pos = np.nonzero(reached[:m])[0]
    token_run = use[token_pos].astype(np.int32)
    token_dist = np.where(token_run > 0, dist[token_pos], 0).astype(np.int32)
    return token_pos, token_run, token_dist


def exact_greedy_tokens(
    buf: np.ndarray,
    start: int,
    *,
    min_run: int,
    max_run: int,
    min_dist: int,
    max_dist: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-semantics serial greedy tokenizer — the ratio oracle.

    Exhaustive distance scan per visited position with smallest-distance
    tie-break, overlap wraparound, greedy commit, literal iff best run <
    ``min_run`` (≙ ``comp/Lz77Huffman.java:68-130``). O(n * max_dist):
    only for measuring "compressed size <= reference at equivalent
    effort", never a production path. Uses the native C core when built;
    the NumPy fallback vectorizes the distance scan per position.
    """
    try:
        from .. import native

        if native.available():
            return native.oracle_tokenize(
                buf,
                start,
                min_run=min_run,
                max_run=max_run,
                min_dist=min_dist,
                max_dist=max_dist,
            )
    except Exception:
        pass

    n = buf.size
    pos_l: list[int] = []
    run_l: list[int] = []
    dist_l: list[int] = []
    i = start
    while i < n:
        best_run = 0
        best_dist = 0
        dmax = min(i, max_dist)
        if min_run > 0 and dmax >= min_dist:
            cap = min(max_run, n - i)
            dists = np.arange(min_dist, dmax + 1)
            # Candidate source rows: for overlap (dist < cap) the source
            # repeats with period dist — build each row explicitly.
            runs = np.zeros(dists.size, np.int64)
            for k, d in enumerate(dists):
                src = buf[i - d : i - d + cap]
                if src.size < cap:  # overlapping match: tile the window
                    reps = -(-cap // d)
                    src = np.tile(buf[i - d : i], reps)[:cap]
                neq = np.nonzero(src != buf[i : i + cap])[0]
                runs[k] = neq[0] if neq.size else cap
            k = int(np.argmax(runs))  # first max = smallest distance
            best_run = int(runs[k])
            best_dist = int(dists[k])
        pos_l.append(i - start)
        if best_run >= min_run and min_run > 0:
            run_l.append(best_run)
            dist_l.append(best_dist)
            i += best_run
        else:
            run_l.append(0)
            dist_l.append(0)
            i += 1
    return (
        np.asarray(pos_l, np.int64),
        np.asarray(run_l, np.int32),
        np.asarray(dist_l, np.int32),
    )
