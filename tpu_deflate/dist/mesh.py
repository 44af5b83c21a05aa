"""Device mesh and topology management (SURVEY.md §2.2 build component).

The reference has no distribution; this framework scales by sharding the
*member/lane* axis of the batched codec kernels over a
``jax.sharding.Mesh``. One logical axis (``data``) suffices for the codec
(members are independent). The cards of one host all reach each other
at the same rate, so the mesh follows the algorithm only; a second axis
(``host``) is the multi-host layout, lanes sharding over the product of
both axes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_DIST_STATE = {"initialized": False}


def init_distributed(
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Multi-host runtime bring-up: ``jax.distributed.initialize``.

    Gated so single-host runs never pay for (or hang on) coordinator
    discovery: runs only when a coordinator address is given explicitly
    or via the standard env (``TD_COORDINATOR``/``JAX_COORDINATOR_ADDRESS``,
    with ``TD_NUM_PROCESSES``/``TD_PROCESS_ID``). Returns True iff the
    distributed runtime is (now) initialized. Idempotent.

    ≙ SURVEY.md §2.2/§5.8: the reference has no communication backend at
    all; this is the bring-up that makes ``make_pod_mesh`` meshes span
    hosts.
    """
    import os

    if _DIST_STATE["initialized"]:
        return True
    coordinator_address = (
        coordinator_address
        or os.environ.get("TD_COORDINATOR")
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not coordinator_address:
        return False
    if num_processes is None and os.environ.get("TD_NUM_PROCESSES"):
        num_processes = int(os.environ["TD_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TD_PROCESS_ID"):
        process_id = int(os.environ["TD_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _DIST_STATE["initialized"] = True
    return True


def make_codec_mesh(n_devices: int | None = None, *, axis: str = "data") -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_pod_mesh(hosts: int, chips_per_host: int) -> Mesh:
    """2-D (host, data) mesh for multi-host slices."""
    devs = np.array(jax.devices()[: hosts * chips_per_host]).reshape(
        hosts, chips_per_host
    )
    return Mesh(devs, ("host", "data"))


def mesh_from_config(cfg) -> Mesh | None:
    """Build the mesh a :class:`~tpu_deflate.config.MeshConfig` describes.

    Returns None for the trivial 1x1 topology (single-device paths need
    no mesh). hosts > 1 yields the 2-D (host, data) pod mesh; otherwise a
    1-D mesh over ``chips_per_host`` devices under the configured axis
    name. ≙ SURVEY.md §5.6: every config knob has a consumer.
    """
    if cfg.hosts <= 1 and cfg.chips_per_host <= 1:
        return None
    if cfg.hosts > 1:
        devs = np.array(jax.devices()[: cfg.hosts * cfg.chips_per_host]).reshape(
            cfg.hosts, cfg.chips_per_host
        )
        return Mesh(devs, (cfg.host_axis, cfg.data_axis))
    return Mesh(np.array(jax.devices()[: cfg.chips_per_host]), (cfg.data_axis,))


def lane_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (lane/member) dimension, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_lanes(n_lanes: int, n_shards: int) -> int:
    """Lanes padded up so the lane axis divides evenly across shards."""
    return -(-n_lanes // n_shards) * n_shards
