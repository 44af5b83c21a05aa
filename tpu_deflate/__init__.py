"""tpu-deflate: a data-parallel DEFLATE/gzip/zlib framework.

Full capability surface of the reference Java library (RFC 1951/1952/1950
encode+decode, strategy system, error taxonomy, container metadata, CLI)
re-architected for data-parallel execution: NumPy vector paths on host,
JAX kernels (XLA) on the GPU, and mesh-sharded
pipelines over several devices.

One-shot convenience API below; streaming classes live in
``tpu_deflate.streams``; device pipelines in ``tpu_deflate.dist`` and
``tpu_deflate.codec``.
"""

from __future__ import annotations

import io

from .codec import deflate_encode as strategies
from .codec.deflate_encode import (
    BinarySplitStrategy,
    FULL_DYNAMIC,
    FULL_STATIC,
    LITERAL_DYNAMIC,
    LITERAL_STATIC,
    Lz77HuffmanStrategy,
    MultiStrategy,
    RLE_DYNAMIC,
    RLE_STATIC,
    StoredStrategy,
    Strategy,
)
from .codec.inflate_host import Inflater, inflate
from .format.errors import DataFormatError, Reason
from .format.gzip_meta import GzipMetadata, OperatingSystem
from .format.zlib_meta import CompressionLevel, ZlibMetadata
from .kernels.checksum import adler32, adler32_combine, crc32, crc32_combine
from .streams.deflater import Deflater
from .streams.gzip_stream import GzipReader, GzipWriter
from .streams.inflater import InflaterReader
from .streams.markable import MarkableFileStream
from .streams.zlib_stream import ZlibReader, ZlibWriter

__version__ = "0.1.0"

# Effort levels -> strategy compositions (≙ reference preset combinations).
# Every level >= its reference-preset counterpart on ratio (measured by
# scripts/ratio_vs_reference.py against the exact=True oracle presets):
# e1 == RLE_DYNAMIC bit-for-bit; e2+ beat exhaustive-greedy FULL_DYNAMIC
# via lazy parsing over 3/4/8-byte-hash candidate levels.
_EFFORT_STRATEGIES = {
    0: StoredStrategy(),
    1: RLE_DYNAMIC,
    2: Lz77HuffmanStrategy(True, lazy=True, max_candidates=16),
    3: Lz77HuffmanStrategy(True, lazy=True, max_candidates=32),
    4: MultiStrategy(
        [StoredStrategy(), Lz77HuffmanStrategy(True, lazy=True, max_candidates=32)]
    ),
    5: MultiStrategy(
        [
            StoredStrategy(),
            BinarySplitStrategy(
                MultiStrategy(
                    [
                        Lz77HuffmanStrategy(True, lazy=True, max_candidates=64),
                        Lz77HuffmanStrategy(False, lazy=True, max_candidates=64),
                    ]
                ),
                min_block_len=4096,
            ),
        ]
    ),
}


def strategy_for_effort(effort: int) -> Strategy:
    """Map an effort level (0..5) to a strategy composition."""
    if effort not in _EFFORT_STRATEGIES:
        raise ValueError(f"effort must be in 0..5, got {effort}")
    return _EFFORT_STRATEGIES[effort]


def deflate(data: bytes, *, effort: int = 2, strategy: Strategy | None = None) -> bytes:
    """One-shot raw-DEFLATE compress."""
    sink = io.BytesIO()
    d = Deflater(sink, strategy=strategy or strategy_for_effort(effort))
    d.write(data)
    d.finish()
    return sink.getvalue()


def gzip_compress(
    data: bytes,
    *,
    effort: int = 2,
    strategy: Strategy | None = None,
    metadata: GzipMetadata | None = None,
) -> bytes:
    sink = io.BytesIO()
    w = GzipWriter(sink, metadata, strategy=strategy or strategy_for_effort(effort))
    w.write(data)
    w.finish()
    return sink.getvalue()


def gzip_decompress(data: bytes, *, multi_member: bool = True) -> bytes:
    return GzipReader(io.BytesIO(data), multi_member=multi_member).read()


def zlib_compress(
    data: bytes,
    *,
    effort: int = 2,
    strategy: Strategy | None = None,
    preset_dictionary: bytes | None = None,
) -> bytes:
    sink = io.BytesIO()
    w = ZlibWriter(
        sink,
        strategy=strategy or strategy_for_effort(effort),
        preset_dictionary=preset_dictionary,
    )
    w.write(data)
    w.finish()
    return sink.getvalue()


def zlib_decompress(data: bytes, *, preset_dictionary: bytes | None = None) -> bytes:
    return ZlibReader(io.BytesIO(data), preset_dictionary=preset_dictionary).read()
