"""Per-platform choice of implementation for each device stage.

One table, keyed by ``jax.devices()[0].platform``. Only the platforms
listed here are accepted: any other raises, so a stage never silently
falls back to an implementation nobody measured.

Stages whose implementation is the same everywhere (every decode stage,
token compaction, LZ77 resolve, CRC, the encoder's analyze and emit) are
plain XLA and have no entry.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Backend:
    #: Whether ``device_resolve="auto"`` resolves LZ77 and checks CRCs
    #: on the device (True) or pulls tokens and resolves on the host.
    device_resolve: bool


_TABLE = {
    "gpu": Backend(device_resolve=True),
    "cpu": Backend(device_resolve=False),
}


def backend_for(platform: str) -> Backend:
    """The stage table of one platform; raises ValueError for any other."""
    try:
        return _TABLE[platform]
    except KeyError:
        raise ValueError(
            f"unsupported JAX platform {platform!r}; expected one of {sorted(_TABLE)}"
        ) from None


def current() -> Backend:
    """The stage table of the default JAX device's platform."""
    import jax

    return backend_for(jax.devices()[0].platform)
