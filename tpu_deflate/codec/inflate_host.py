"""Host (serial) raw-DEFLATE decoder: the framework's semantic reference.

A complete RFC 1951 state machine with the reference library's exact error
taxonomy and error precedence (``decomp/Open.java:83-890``):

- block header loop, stored / fixed / dynamic blocks;
- full-depth LUT symbol decode (``kernels.huffman.build_decode_lut``);
- 32 KiB LZ77 dictionary persisting across blocks;
- exact degenerate-code semantics: empty distance code, single 1-bit
  distance code padded with a dummy (reserved) symbol 31, mandatory EOB
  code, complete-tree validation with UNDER/OVER_FULL precedence;
- `end_exactly` bookkeeping: whole-bytes-consumed accounting so container
  readers can continue parsing the trailer right after the payload.

Every device decode path is differentially tested against this decoder.
"""

from __future__ import annotations

import io

import numpy as np

from ..format.errors import DataFormatError, Reason
from ..format.tables import (
    CLEN_ORDER,
    DIST_BASE,
    DIST_EXTRA,
    EOB_SYMBOL,
    FIXED_DIST_LENGTHS,
    FIXED_LITLEN_LENGTHS,
    LENGTH_BASE,
    LENGTH_EXTRA,
    NUM_CLEN_SYMS,
    WINDOW_SIZE,
)
from ..kernels.bitio import BitReader
from ..kernels.huffman import DecodeTable, build_decode_lut, validate_code_lengths

_FIXED_LITLEN_LUT = build_decode_lut(FIXED_LITLEN_LENGTHS)
_FIXED_DIST_LUT = build_decode_lut(FIXED_DIST_LENGTHS)

_S_HEADER = 0  # between blocks: next is a block header (or EOF if last seen)
_S_STORED = 1  # inside a stored block
_S_HUFFMAN = 2  # inside a fixed/dynamic Huffman block
_S_DONE = 3  # final block fully decoded


class Inflater:
    """Incremental raw-DEFLATE decoder reading from a byte source.

    ``source`` is any object with ``read(n) -> bytes``. Decoded bytes are
    pulled with :meth:`read`; ``b''`` signals clean end of stream.
    """

    def __init__(self, source, *, buffer_size: int = 16 * 1024):
        self._reader = BitReader(source, buffer_size=buffer_size)
        self._state = _S_HEADER
        self._last_block_seen = False
        # LZ77 dictionary: ring buffer of the last 32 KiB of output.
        self._window = np.zeros(WINDOW_SIZE, dtype=np.uint8)
        self._window_pos = 0
        self._window_len = 0
        # Stored-block state
        self._stored_remaining = 0
        # Huffman-block state
        self._litlen_lut: DecodeTable | None = None
        self._dist_lut: DecodeTable | None = None
        # Output staging (decoded but not yet handed to the caller)
        self._pending = bytearray()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def is_done(self) -> bool:
        return self._state == _S_DONE and not self._pending

    def read(self, n: int) -> bytes:
        """Decode and return up to n bytes (b'' only at clean end)."""
        if n < 0:
            raise ValueError("negative read size")
        while len(self._pending) < n and self._state != _S_DONE:
            self._step(n - len(self._pending))
        out = bytes(self._pending[:n])
        del self._pending[:n]
        return out

    def read_all(self) -> bytes:
        while self._state != _S_DONE:
            self._step(1 << 30)
        out = bytes(self._pending)
        self._pending.clear()
        return out

    def detach_tail(self) -> bytes:
        """After the stream is done: return over-read bytes (they precede the
        source's current position). Enables the `end_exactly` container
        contract without repositioning the source."""
        assert self._state == _S_DONE
        return self._reader.detach()

    @property
    def consumed_bytes(self) -> int:
        """Whole input bytes consumed (partial byte counts as consumed)."""
        return self._reader.consumed_bytes

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------

    def _step(self, want: int) -> None:
        """Advance the state machine, producing at most ~want+258 bytes."""
        if self._state == _S_HEADER:
            if self._last_block_seen:
                self._state = _S_DONE
                return
            self._last_block_seen = self._reader.read_bits(1) == 1
            btype = self._reader.read_bits(2)
            if btype == 0:
                self._begin_stored()
            elif btype == 1:
                self._litlen_lut = _FIXED_LITLEN_LUT
                self._dist_lut = _FIXED_DIST_LUT
                self._state = _S_HUFFMAN
            elif btype == 2:
                self._litlen_lut, self._dist_lut = self._parse_dynamic_header()
                self._state = _S_HUFFMAN
            else:
                raise DataFormatError(Reason.RESERVED_BLOCK_TYPE, "Reserved block type")
        elif self._state == _S_STORED:
            self._stored_step(want)
        elif self._state == _S_HUFFMAN:
            self._huffman_step(want)

    # -- stored blocks --------------------------------------------------

    def _begin_stored(self) -> None:
        self._reader.align_to_byte()
        length = self._reader.read_bits(16)
        nlen = self._reader.read_bits(16)
        if length != (nlen ^ 0xFFFF):
            raise DataFormatError(
                Reason.UNCOMPRESSED_BLOCK_LENGTH_MISMATCH,
                "len/nlen mismatch in uncompressed block",
            )
        self._stored_remaining = length
        self._state = _S_STORED
        if length == 0:
            self._state = _S_HEADER

    def _stored_step(self, want: int) -> None:
        take = min(self._stored_remaining, max(want, 1), 1 << 20)
        data = self._reader.read_aligned_bytes(take)
        self._emit_literal_bytes(np.frombuffer(data, dtype=np.uint8))
        self._stored_remaining -= take
        if self._stored_remaining == 0:
            self._state = _S_HEADER

    # -- dynamic header -------------------------------------------------

    def _parse_dynamic_header(self) -> tuple[DecodeTable, DecodeTable | None]:
        r = self._reader
        num_litlen = r.read_bits(5) + 257
        num_dist = r.read_bits(5) + 1
        num_clen = r.read_bits(4) + 4

        clen_lengths = np.zeros(NUM_CLEN_SYMS, dtype=np.int64)
        for i in range(num_clen):
            clen_lengths[CLEN_ORDER[i]] = r.read_bits(3)
        validate_code_lengths(clen_lengths)
        clen_lut = build_decode_lut(clen_lengths)

        code_lens = np.zeros(num_litlen + num_dist, dtype=np.int64)
        i = 0
        run_val = -1
        while i < code_lens.size:
            sym = self._decode_symbol(clen_lut)
            if sym < 16:
                run_val = sym
                code_lens[i] = sym
                i += 1
                continue
            if sym == 16:
                if run_val == -1:
                    raise DataFormatError(
                        Reason.NO_PREVIOUS_CODE_LENGTH_TO_COPY,
                        "No code length value to copy",
                    )
                run_len = r.read_bits(2) + 3
            elif sym == 17:
                run_val = 0
                run_len = r.read_bits(3) + 3
            else:  # 18
                run_val = 0
                run_len = r.read_bits(7) + 11
            if i + run_len > code_lens.size:
                raise DataFormatError(
                    Reason.CODE_LENGTH_CODE_OVER_FULL, "Run exceeds number of codes"
                )
            code_lens[i : i + run_len] = run_val
            i += run_len

        litlen_lengths = code_lens[:num_litlen]
        if litlen_lengths[EOB_SYMBOL] == 0:
            raise DataFormatError(
                Reason.END_OF_BLOCK_CODE_ZERO_LENGTH,
                "End-of-block symbol has zero code length",
            )
        # Pad to the full 288-symbol alphabet (absent symbols have length 0).
        full_litlen = np.zeros(288, dtype=np.int64)
        full_litlen[:num_litlen] = litlen_lengths
        validate_code_lengths(full_litlen)
        litlen_lut = build_decode_lut(full_litlen)

        dist_lengths = code_lens[num_litlen:]
        if dist_lengths.size == 1 and dist_lengths[0] == 0:
            # Empty distance code: the block must be all literals.
            return litlen_lut, None
        one_count = int((dist_lengths == 1).sum())
        other_positive = int((dist_lengths > 1).sum())
        full_dist = np.zeros(32, dtype=np.int64)
        full_dist[: dist_lengths.size] = dist_lengths
        if one_count == 1 and other_positive == 0:
            # Single 1-bit distance code: complete the tree with a dummy
            # (reserved) symbol 31, so the other bit pattern decodes to a
            # reserved-symbol error rather than an invalid-code error.
            full_dist[31] = 1
        validate_code_lengths(full_dist)
        return litlen_lut, build_decode_lut(full_dist)

    # -- Huffman block decode -------------------------------------------

    def _decode_symbol(self, lut: DecodeTable) -> int:
        bits, avail = self._reader.peek_bits_upto(15)
        sym = int(lut.symbol[bits])
        length = int(lut.length[bits])
        if length > avail:
            raise DataFormatError.unexpected_end()
        self._reader.skip_bits(length)
        return sym

    def _huffman_step(self, want: int) -> None:
        r = self._reader
        produced = 0
        litlen_lut = self._litlen_lut
        dist_lut = self._dist_lut
        out = self._pending
        window = self._window
        while produced < want:
            sym = self._decode_symbol(litlen_lut)
            if sym < 256:
                out.append(sym)
                window[self._window_pos] = sym
                self._window_pos = (self._window_pos + 1) % WINDOW_SIZE
                if self._window_len < WINDOW_SIZE:
                    self._window_len += 1
                produced += 1
                continue
            if sym == EOB_SYMBOL:
                self._state = _S_HEADER
                return
            # Length/distance pair
            if sym > 285:
                raise DataFormatError(
                    Reason.RESERVED_LENGTH_SYMBOL, f"Reserved run length symbol: {sym}"
                )
            run = int(LENGTH_BASE[sym - 257]) + r.read_bits(int(LENGTH_EXTRA[sym - 257]))
            if dist_lut is None:
                raise DataFormatError(
                    Reason.LENGTH_ENCOUNTERED_WITH_EMPTY_DISTANCE_CODE,
                    "Length symbol encountered with empty distance code",
                )
            dist_sym = self._decode_symbol(dist_lut)
            if dist_sym > 29:
                raise DataFormatError(
                    Reason.RESERVED_DISTANCE_SYMBOL, f"Reserved distance symbol: {dist_sym}"
                )
            dist = int(DIST_BASE[dist_sym]) + r.read_bits(int(DIST_EXTRA[dist_sym]))
            if dist > self._window_len:
                raise DataFormatError(
                    Reason.COPY_FROM_BEFORE_DICTIONARY_START,
                    "Attempting to copy from before start of dictionary",
                )
            self._copy_match(run, dist)
            produced += run

    def _copy_match(self, run: int, dist: int) -> None:
        window = self._window
        pos = self._window_pos
        src = (pos - dist) % WINDOW_SIZE
        if dist >= run and src + run <= WINDOW_SIZE and pos + run <= WINDOW_SIZE:
            # No wraparound on either side: bulk copy. The ring regions can
            # still overlap when dist is close to the window size (the write
            # lands on the oldest bytes), so snapshot the source first.
            chunk = window[src : src + run].copy()
            window[pos : pos + run] = chunk
            self._pending += chunk.tobytes()
            self._window_pos = (pos + run) % WINDOW_SIZE
        else:
            for _ in range(run):
                b = window[src]
                window[pos] = b
                self._pending.append(b)
                src = (src + 1) % WINDOW_SIZE
                pos = (pos + 1) % WINDOW_SIZE
            self._window_pos = pos
        self._window_len = min(WINDOW_SIZE, self._window_len + run)

    def _emit_literal_bytes(self, data: np.ndarray) -> None:
        """Append raw bytes (stored block) to output and dictionary."""
        self._pending += data.tobytes()
        n = data.size
        if n >= WINDOW_SIZE:
            self._window[:] = data[-WINDOW_SIZE:]
            self._window_pos = 0
            self._window_len = WINDOW_SIZE
        elif n:
            pos = self._window_pos
            first = min(n, WINDOW_SIZE - pos)
            self._window[pos : pos + first] = data[:first]
            if n > first:
                self._window[: n - first] = data[first:]
            self._window_pos = (pos + n) % WINDOW_SIZE
            self._window_len = min(WINDOW_SIZE, self._window_len + n)


def inflate(data: bytes) -> bytes:
    """One-shot raw-DEFLATE decode of a complete in-memory stream."""
    return Inflater(io.BytesIO(data)).read_all()
