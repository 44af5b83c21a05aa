"""Member catalog: seekable decode and checkpoint/resume
(SURVEY.md §5.4 build component).

The TD stream profile embeds a bgzf-style size subfield in every member
header, so any profile stream doubles as its own index: a catalog maps
uncompressed byte ranges to members without decoding anything. This
enables:

- ``read_range(a, b)``: decode only the members covering [a, b) — random
  access into multi-TB archives at member (64 KiB) granularity;
- ``resume_point(done_bytes)``: the (input offset, output offset) pair
  from which an interrupted decode job restarts — nothing before it needs
  re-reading;
- failure isolation (SURVEY.md §5.3): ``decode_all(on_error="skip")``
  decodes every member independently and reports bad members instead of
  failing the whole job.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .codec.decode_jax import MemberIndex, split_members
from .format.errors import DataFormatError


@dataclass
class MemberEntry:
    index: MemberIndex
    out_start: int  # uncompressed offset of this member's first byte

    @property
    def out_end(self) -> int:
        return self.out_start + self.index.isize


class MemberCatalog:
    """Index over a TD-profile gzip stream (or any stream after a one-time
    host scan)."""

    def __init__(self, data: bytes):
        self._data = data
        buf = np.frombuffer(data, dtype=np.uint8)
        members = split_members(buf)
        if members is None:
            raise ValueError(
                "stream has no TD member index; re-encode with the profile "
                "encoder or use the streaming decoder"
            )
        self.entries: list[MemberEntry] = []
        off = 0
        for m in members:
            self.entries.append(MemberEntry(m, off))
            off += m.isize
        self.total_uncompressed = off

    # ------------------------------------------------------------------

    def _decode_member(self, e: MemberEntry) -> bytes:
        payload = self._data[e.index.payload_start : e.index.end - 8]
        from . import native
        from .format.errors import OutputCapacityError, Reason

        if native.available():
            try:
                out, _ = native.inflate_raw(payload, e.index.isize + 1)
            except OutputCapacityError:
                raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "size mismatch")
        else:
            from .codec.inflate_host import inflate

            out = inflate(payload)

        if len(out) != e.index.isize:
            raise DataFormatError(Reason.DECOMPRESSED_SIZE_MISMATCH, "size mismatch")
        if native.available():
            got_crc = native.crc32(out)
        else:
            from .kernels.checksum import crc32 as _crc

            got_crc = _crc(out)
        if got_crc != e.index.crc32:
            raise DataFormatError(
                Reason.DECOMPRESSED_CHECKSUM_MISMATCH, "Decompression CRC-32 mismatch"
            )
        return out

    def read_range(self, start: int, end: int) -> bytes:
        """Decode exactly the uncompressed byte range [start, end)."""
        start = max(0, start)
        end = min(end, self.total_uncompressed)
        if end <= start:
            return b""
        out = bytearray()
        for e in self.entries:
            if e.out_end <= start or e.out_start >= end:
                continue
            chunk = self._decode_member(e)
            lo = max(0, start - e.out_start)
            hi = min(e.index.isize, end - e.out_start)
            out += chunk[lo:hi]
        return bytes(out)

    def resume_point(self, done_bytes: int) -> tuple[int, int]:
        """(compressed offset, uncompressed offset) of the first member not
        fully contained in the already-produced prefix ``done_bytes`` —
        restart an interrupted job from here."""
        for e in self.entries:
            if e.out_end > done_bytes:
                return e.index.start, e.out_start
        return len(self._data), self.total_uncompressed

    def decode_all(self, *, on_error: str | None = None, config=None):
        """Decode every member; with on_error='skip', bad members yield
        b'' placeholders and are reported in the second return value.

        ``config`` (a DecoderConfig/FrameworkConfig) supplies the default
        failure-isolation policy (SURVEY.md §5.3/§5.6)."""
        if on_error is None:
            from .engine import _decoder_cfg

            on_error = _decoder_cfg(config).on_error
        outs: list[bytes] = []
        bad: list[int] = []
        for i, e in enumerate(self.entries):
            try:
                outs.append(self._decode_member(e))
            except (DataFormatError, ValueError):
                if on_error == "raise":
                    raise
                outs.append(b"")
                bad.append(i)
        return b"".join(outs), bad
