"""Device LZ77 resolve in plain ``jax.numpy``: tokens -> final bytes
(SURVEY.md §7's ``lz77_resolve``; ≙ the reference's ring-dictionary copy
loop, ``decomp/Open.java:589-617``).

Each lane is one front-compacted token stream (literal byte | match
run/dist, -1 padding) covering at most ``N_POS`` output bytes. Resolve
runs in three vectorized steps over every lane at once:

1. **Expand.** Token starts are the exclusive cumsum of token sizes; one
   scatter marks each token's index at its start, and a running max
   fills the covering token of every output position.
2. **Sources.** Every match position copies ``out[p] = out[p - d]``.
   Inside a maximal constant-distance region starting at ``A`` that
   iterates to ``src(p) = p - k*d`` with ``k = min(floor((p-A)/d) + 1,
   floor(32768/d))`` (the *capped region-mod* form): RLE runs and
   periodic copies collapse to
   near-constant chain depth, and every source stays within 32 KiB of its
   position, the DEFLATE window bound (``decomp/Open.java:592-593``).
3. **Pointer jumping** over [32 KiB resolved tail | tile]: each round a
   position that still has no byte reads its source's byte and source
   (``take_along_axis``). Sources point strictly backwards and positions
   are below 2^17, so 17 rounds always suffice; the loop stops as soon as
   every position holds a byte.

The 32 KiB ``tail`` chains tiles of members larger than ``N_POS``: no
source reaches further back than the previous tile's last 32 KiB
(≙ the 32 KiB ring dictionary, ``decomp/Open.java:64-66,201``).

The summary reports the first copy-before-start (or oversized distance)
position per lane and the unresolved residue; callers route a lane with
either to the host resolve, which raises the exact reference Reason.
Differentially tested against :func:`resolve_reference` and the C
runtime's ``td_resolve_tokens``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import jax_setup  # noqa: F401

N_POS = 65536  # tile output space (profile members are <= 64 KiB; larger members tile)
TOKEN_MATCH_BIT = 1 << 26
W_CAP = 32768  # max emitted back-jump = the DEFLATE window (decomp/Open.java:592)
TAIL = 32768  # resolved history bytes ahead of a chained tile
MAX_ROUNDS = 17  # (TAIL + N_POS) < 2**17 positions: every chain resolves


# ---------------------------------------------------------------------------
# NumPy reference (tests)
# ---------------------------------------------------------------------------


def resolve_reference(tokens: np.ndarray, history: bytes = b"") -> bytes:
    """Serial expansion oracle (matches native td_resolve_tokens).

    ``history`` seeds the dictionary for tile-chained streams; returned
    bytes exclude it.
    """
    out = bytearray(history)
    h = len(history)
    for t in tokens:
        t = int(t)
        if t < 0:
            break
        if not t & TOKEN_MATCH_BIT:
            out.append(t & 0xFF)
            continue
        run = (t >> 16) & 0x3FF
        dist = (t & 0xFFFF) + 1
        if dist > len(out):
            raise ValueError("copy before start")
        for _ in range(run):
            out.append(out[-dist])
    return bytes(out[h:])


# ---------------------------------------------------------------------------
# Device resolve
# ---------------------------------------------------------------------------


def _expand(tokens: jnp.ndarray, hist: int):
    """(L, N) tokens -> (val, src, summary) in tile coordinates.

    val: the literal byte at literal positions, 0 past the stream end and
    at error positions, -1 at match positions; src: the capped source at
    match positions, the position itself elsewhere; summary (L, 8) int32:
    [first error position (N if none), total output bytes, match
    positions to resolve, 0, ...].
    """
    L, N = tokens.shape
    lanes = jnp.arange(L, dtype=jnp.int32)[:, None]
    pos = jnp.arange(N, dtype=jnp.int32)[None, :]
    kidx = jnp.broadcast_to(pos, (L, N))  # token slot index
    valid = tokens >= 0
    is_m = valid & (tokens >= 256)
    sizes = jnp.where(valid, jnp.where(is_m, (tokens >> 16) & 0x3FF, 1), 0)
    incl = jnp.cumsum(sizes, axis=1)
    total = incl[:, -1]
    starts = incl - sizes
    # The covering token of every position: slot index scattered to the
    # token's start, then a running max (empty runs lose to the later
    # token that starts at the same position).
    mark = jnp.full((L, N), -1, jnp.int32).at[
        lanes, jnp.where(valid & (sizes > 0), starts, N)
    ].max(kidx, mode="drop")
    cov = jax.lax.cummax(mark, axis=1)
    rec = jnp.take_along_axis(tokens, jnp.maximum(cov, 0), axis=1)
    in_stream = pos < total[:, None]
    lit = in_stream & (rec >= 0) & (rec < 256)
    match_pos = in_stream & ~lit
    dm1 = rec & 0xFFFF
    d = jnp.where(match_pos, dm1 + 1, 0)
    # dist-1 >= 0x8000 never occurs in spec-valid DEFLATE (distances are
    # <= 32768, decomp/Open.java:592); flag it at the match's start.
    big_dist = match_pos & (mark >= 0) & (dm1 >= 0x8000)

    # Constant-distance regions: break where the distance changes (every
    # literal bounds a region, since it has d == 0).
    prev_d = jnp.concatenate([jnp.full((L, 1), -1, jnp.int32), d[:, :-1]], axis=1)
    brk = (d != prev_d) | (d == 0)
    A = jax.lax.cummax(jnp.where(brk, pos, -1), axis=1)
    dd = jnp.maximum(d, 1)
    i = pos - A
    q = i // dd
    # Full region-mod source (the earliest byte of the chain: decides
    # copy-before-start; it never exceeds the capped source) and the
    # emitted capped jump (within 32 KiB).
    src_mod = A - dd + (i - q * dd)
    k = jnp.maximum(jnp.minimum(q + 1, W_CAP // dd), 1)
    src = jnp.where(match_pos, pos - k * dd, pos)

    err = (match_pos & (src_mod < -hist)) | big_dist
    err_pos = jnp.min(jnp.where(err, pos, N), axis=1)
    val = jnp.where(lit, rec & 0xFF, jnp.where(match_pos & ~err, -1, 0))
    src = jnp.where(err, pos, src)
    n_match = jnp.sum(match_pos & ~err, axis=1, dtype=jnp.int32)
    zero = jnp.zeros_like(total)
    summ = jnp.stack([err_pos, total, n_match] + [zero] * 5, axis=1)
    return val, src, summ


def _jump(val: jnp.ndarray, src: jnp.ndarray):
    """Pointer jumping until every position holds a byte (<= 17 rounds).

    val (L, M) int32 bytes, -1 where unresolved; src (L, M) strictly
    backward sources (self where resolved). Returns (val, rounds)."""

    def cond(carry):
        r, v, _ = carry
        return (r < MAX_ROUNDS) & jnp.any(v < 0)

    def body(carry):
        r, v, s = carry
        todo = v < 0
        v = jnp.where(todo, jnp.take_along_axis(v, s, axis=1), v)
        s = jnp.where(todo, jnp.take_along_axis(s, s, axis=1), s)
        return r + 1, v, s

    r, val, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), val, src))
    return val, r


@functools.partial(jax.jit, static_argnames=("chained",))
def _resolve(tokens, tail, *, chained: bool):
    L, N = tokens.shape
    val, src, summ = _expand(tokens, TAIL if chained else 0)
    hist = jnp.asarray(tail, jnp.int32)
    full_val = jnp.concatenate([hist, val], axis=1)
    full_src = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(TAIL, dtype=jnp.int32)[None, :], (L, TAIL)), src + TAIL],
        axis=1,
    )
    out, rounds = _jump(full_val, full_src)
    y = out[:, TAIL:]
    residue = jnp.sum(y < 0, axis=1, dtype=jnp.int32)
    y = jnp.maximum(y, 0)
    summ = summ.at[:, 3].set(residue)
    return y, summ, rounds, jnp.sum(residue)


def resolve_tokens_device(tokens, *, tail=None):
    """Full device resolve: compacted tokens (L, N_POS) -> final bytes.

    ``tail`` (L, 32768) int32/uint8 resolved history bytes chains tiles
    of members larger than N_POS (None = stream start).

    Returns (y (L, N) int32 bytes (0 past the stream end), summary (L, 8)
    [err_pos, total, n_match, residue, 0...], rounds, unresolved). A lane
    with an error position < N or a nonzero residue goes to the host
    resolve (decode_jax_v2._decode_single_block_device does exactly that).
    """
    tokens = jnp.asarray(tokens, jnp.int32)
    assert tokens.shape[1] == N_POS
    chained = tail is not None
    if tail is None:
        tail = jnp.zeros((tokens.shape[0], TAIL), jnp.int32)
    return _resolve(tokens, tail, chained=chained)


# ---------------------------------------------------------------------------
# Tile chaining for members / streams larger than N_POS
# ---------------------------------------------------------------------------


def split_tokens_tiles(tokens: np.ndarray) -> np.ndarray:
    """Split one member's token stream at N_POS output boundaries.

    tokens: (K,) int32 front-compacted (-1 padding). A match token
    straddling a tile boundary is split in two with the same distance
    (valid: the second half's source still lies within 32 KiB; runs are
    <= 258 < N_POS so a token spans at most two tiles). Returns
    (T, N_POS) int32, -1 padded — tile t covers output bytes
    [t*N_POS, (t+1)*N_POS). Fully vectorized (the engine's big-member
    path runs this per lane). ≙ unbounded streaming with the bounded
    ring dictionary, decomp/Open.java:64-66.
    """
    toks = tokens[tokens >= 0].astype(np.int64)
    is_m = (toks & TOKEN_MATCH_BIT) != 0
    runs = np.where(is_m, (toks >> 16) & 0x3FF, 1)
    ends = np.cumsum(runs)
    total = int(ends[-1]) if toks.size else 0
    T = max(1, -(-total // N_POS))
    out = np.full((T, N_POS), -1, np.int32)
    if not toks.size:
        return out
    starts = ends - runs
    t0 = starts // N_POS
    straddle = ends > (t0 + 1) * N_POS  # always a match (literals are 1 byte)
    cut = (t0 + 1) * N_POS
    dist_m1 = toks & 0xFFFF
    first = np.where(
        straddle, TOKEN_MATCH_BIT | ((cut - starts) << 16) | dist_m1, toks
    )
    # Each tile's sequence = [the (at most one) straddler's second half
    # from the previous tile] ++ [tokens starting in this tile, in order].
    head = np.zeros(T, np.int64) - 1
    head[t0[straddle] + 1] = TOKEN_MATCH_BIT | (
        (ends[straddle] - cut[straddle]) << 16
    ) | dist_m1[straddle]
    has_head = head >= 0
    tile_first_idx = np.searchsorted(t0, np.arange(T))
    rank = np.arange(toks.size) - tile_first_idx[t0]
    out[has_head, 0] = head[has_head]
    out[t0, rank + has_head[t0]] = first
    return out


def resolve_tokens_tiled(tiles):
    """Resolve (L, T, N_POS) tile-split token streams with chained tails.

    Tiles at index t of every lane resolve in one batched call; each
    step feeds its last 32 KiB forward as the next step's resolved
    history. Returns (y (L, T, N_POS) int32 bytes, summaries
    (L, T, 8), unresolved total).
    """
    tiles = jnp.asarray(tiles)
    L, T, M = tiles.shape
    assert M == N_POS
    ys, summs = [], []
    unres_total = jnp.zeros((), jnp.int32)
    tail = None
    for t in range(T):
        y, summ, _rounds, unres = resolve_tokens_device(tiles[:, t], tail=tail)
        ys.append(y)
        summs.append(summ)
        unres_total = unres_total + unres
        tail = y[:, M - TAIL :]
    return jnp.stack(ys, axis=1), jnp.stack(summs, axis=1), unres_total


def resolve_big_streams(token_arrays):
    """Device resolve for arbitrary-size token streams (members beyond
    one 64 KiB tile — continuous members, foreign streams).

    token_arrays: list of (K,) int32 host token streams (front-compacted,
    -1 padded, possibly > N_POS slots). Each splits into N_POS output
    tiles (``split_tokens_tiles``), lanes group by tile count, and tile
    step t of every lane in a group resolves in one batched device call
    with the previous step's last 32 KiB chained as the resolved tail —
    O(1) device memory per lane regardless of stream length
    (≙ the reference's unbounded streaming over a bounded ring
    dictionary, decomp/Open.java:64-66).

    Returns (outs, residues): per stream, the resolved bytes (np.uint8,
    trimmed to the stream's total output) and its unresolved-residue
    count (nonzero => the caller must fall back to host resolve).
    """
    tiles = [split_tokens_tiles(np.asarray(t, np.int32)) for t in token_arrays]
    totals = []
    for t in token_arrays:
        toks = np.asarray(t, np.int64)
        toks = toks[toks >= 0]
        is_m = (toks & TOKEN_MATCH_BIT) != 0
        totals.append(int(np.where(is_m, (toks >> 16) & 0x3FF, 1).sum()))
    outs: list = [None] * len(tiles)
    resid = np.zeros(len(tiles), np.int64)
    bygroup: dict[int, list[int]] = {}
    for i, tl in enumerate(tiles):
        bygroup.setdefault(tl.shape[0], []).append(i)
    for T, idxs in sorted(bygroup.items()):
        batch = jnp.asarray(np.stack([tiles[i] for i in idxs], axis=0))
        ys, summs, _unres = resolve_tokens_tiled(batch)
        ys = np.asarray(ys, np.uint8).reshape(len(idxs), T * N_POS)
        summs = np.asarray(summs)
        for j, i in enumerate(idxs):
            outs[i] = ys[j, : totals[i]]
            # Unresolved residue OR a flagged copy-before-start: either
            # way the caller must re-run the lane through host resolve
            # (which raises the exact reference Reason in stream order).
            resid[i] = int(summs[j, :, 3].sum()) + int(
                (summs[j, :, 0] < N_POS).sum()
            )
    return outs, resid


@functools.partial(jax.jit, static_argnames=("T",))
def split_tiles_device(tokens: jnp.ndarray, T: int) -> jnp.ndarray:
    """(L, K) device token streams -> (L, T, N_POS) tile-split, ON DEVICE.

    The device analog of ``split_tokens_tiles`` for the full-device
    big-member pipeline: per tile, tokens starting in the tile keep
    their order via one 2-operand ``lax.sort`` (key = stream index;
    the straddling match's second half sorts first with key 0), with
    run caps applied arithmetically. A token spans at most two tiles
    (runs <= 258 < N_POS).
    """
    L, K = tokens.shape
    valid = tokens >= 0
    is_m = valid & ((tokens & TOKEN_MATCH_BIT) != 0)
    runs = jnp.where(valid, jnp.where(is_m, (tokens >> 16) & 0x3FF, 1), 0)
    ends = jnp.cumsum(runs, axis=1)
    starts = ends - runs
    t0 = starts // N_POS
    idx = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :], (L, K))
    dist_m1 = tokens & 0xFFFF
    tiles = []
    for t in range(T):
        cut = (t + 1) * N_POS
        start_in = valid & (t0 == t)
        run1 = jnp.minimum(ends, cut) - starts
        val_first = jnp.where(
            is_m, TOKEN_MATCH_BIT | (run1 << 16) | dist_m1, tokens
        )
        head_in = is_m & (t0 == t - 1) & (ends > t * N_POS)
        run2 = ends - t * N_POS
        val = jnp.where(
            start_in,
            val_first,
            jnp.where(head_in, TOKEN_MATCH_BIT | (run2 << 16) | dist_m1, -1),
        )
        key = jnp.where(start_in, idx + 1, jnp.where(head_in, 0, K + 2))
        _k, sval = jax.lax.sort((key, val), dimension=1, num_keys=1)
        if K >= N_POS:
            sval = sval[:, :N_POS]
        else:
            sval = jnp.pad(sval, ((0, 0), (0, N_POS - K)), constant_values=-1)
        tiles.append(sval)
    return jnp.stack(tiles, axis=1)
