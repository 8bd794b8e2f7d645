"""Multi-host / multi-process execution.

The reference is strictly single-process (SURVEY.md §1: "no scheduler, no
distributed runtime"); this module is the framework's multi-host layer on the
jax single-controller-per-process SPMD model:

* ``initialize`` wraps ``jax.distributed.initialize`` (coordinator + process
  rank, or env auto-detection on managed clusters);
* ``global_mesh`` builds the 1-D paths mesh over ALL devices of the job —
  after distributed initialisation ``jax.devices()`` spans every host, so the
  per-step regression psums ride ICI within a slice and DCN across hosts;
* ``host_local_sims_to_global`` turns each process's local block of simulated
  paths into one globally-sharded array (the multi-host analog of
  ``SpotSimResultsFromPanels`` ingestion, SpotSimResultsFromPanels.cs:36-117),
  with cross-process shape validation;
* ``replicate_to_global`` lifts host-replicated inputs (engine arrays, curve
  data — identical on every process by construction) into fully-replicated
  global arrays so they can feed a multi-process ``jit``.

Per-sim output panels are not materialised in multi-process runs (each
process only holds its own path shard); reduced outputs (NPV, SE, deltas,
profiles, triggers) are replicated on every process.
"""
from __future__ import annotations

import typing as tp

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import AXIS


def initialize(
    coordinator_address: tp.Optional[str] = None,
    num_processes: tp.Optional[int] = None,
    process_id: tp.Optional[int] = None,
    local_device_ids: tp.Optional[tp.Sequence[int]] = None,
) -> None:
    """Initialise the multi-process runtime (idempotent).

    With all arguments ``None`` jax auto-detects cluster environments
    (SLURM, ...); pass ``coordinator_address='host:port'`` +
    ``num_processes`` + ``process_id`` explicitly otherwise.  Must run before
    the first backend use in every process of the job.
    """
    if is_initialized():
        return
    kwargs: tp.Dict[str, tp.Any] = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def is_initialized() -> bool:
    # jax >= 0.9 exposes jax.distributed.is_initialized(); the old
    # global_state attribute no longer exists (probing it always returned
    # False, which broke initialize()'s idempotency: a second call would
    # reach jax.distributed.initialize() and raise).
    probe = getattr(jax.distributed, "is_initialized", None)
    if callable(probe):
        return bool(probe())
    state = getattr(jax.distributed, "global_state", None)
    return state is not None and getattr(state, "client", None) is not None


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def global_mesh() -> Mesh:
    """1-D paths mesh over every device in the job (all hosts)."""
    return Mesh(np.array(jax.devices()), (AXIS,))


def _assert_uniform_across_processes(value: tp.Sequence[int], what: str) -> None:
    """Every process must contribute the same ``value`` (shape metadata)."""
    if process_count() == 1:
        return
    from jax.experimental import multihost_utils

    arr = np.asarray(value, dtype=np.int64)
    gathered = multihost_utils.process_allgather(arr)  # [num_processes, ...]
    if not (gathered == gathered[0]).all():
        raise ValueError(
            f"{what} differs across processes: {gathered.tolist()} — every "
            "host must supply path blocks of identical shape."
        )


def host_local_sims_to_global(
    spot_local: jnp.ndarray,     # [N+1, S_local]
    factors_local: jnp.ndarray,  # [N+1, F, S_local]
    mesh: tp.Optional[Mesh] = None,
) -> tp.Tuple[jax.Array, jax.Array]:
    """Assemble per-process path blocks into globally path-sharded arrays.

    Process p's block becomes global sim columns [p*S_local, (p+1)*S_local);
    global path identity is therefore ``process_index * S_local + local_id``.
    Requires S_local to be a multiple of the local device count so each
    device owns a contiguous block.
    """
    mesh = mesh if mesh is not None else global_mesh()
    n_steps, s_local = spot_local.shape
    f = factors_local.shape[1]
    _assert_uniform_across_processes(
        [n_steps, f, s_local], "simulation panel shape"
    )
    local_devices = jax.local_device_count()
    if s_local % local_devices != 0:
        raise ValueError(
            f"Local sim count ({s_local}) must be a multiple of the local "
            f"device count ({local_devices})."
        )
    s_global = s_local * process_count()
    spot_sharding = NamedSharding(mesh, P(None, AXIS))
    fac_sharding = NamedSharding(mesh, P(None, None, AXIS))
    spot_global = jax.make_array_from_process_local_data(
        spot_sharding, np.asarray(spot_local), (n_steps, s_global)
    )
    factors_global = jax.make_array_from_process_local_data(
        fac_sharding, np.asarray(factors_local), (n_steps, f, s_global)
    )
    return spot_global, factors_global


def replicate_to_global(tree, mesh: tp.Optional[Mesh] = None):
    """Lift host-replicated pytree leaves into fully-replicated global arrays.

    Every process must hold identical values (true for engine arrays built
    deterministically from the same valuation inputs).  No-op in
    single-process runs.
    """
    if process_count() == 1:
        return tree
    mesh = mesh if mesh is not None else global_mesh()

    def lift(x):
        arr = np.asarray(x)
        sharding = NamedSharding(mesh, P(*([None] * arr.ndim)))
        return jax.make_array_from_process_local_data(sharding, arr, arr.shape)

    return jax.tree_util.tree_map(lift, tree)


def replicate_key(key, mesh: tp.Optional[Mesh] = None):
    """Lift a PRNG key (identical on every process by construction — same
    seed) into a fully-replicated global key array for multi-process jits."""
    if process_count() == 1:
        return key
    data = replicate_to_global(np.asarray(jax.random.key_data(key)), mesh)
    return jax.random.wrap_key_data(data)
