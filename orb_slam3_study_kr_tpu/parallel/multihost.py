"""Multi-host (multi-process) runtime for the distributed solvers.

The reference has no multi-node capability at all (SURVEY.md section 2.4);
this is the designed-new part of the engine: each host joins a
`jax.distributed` cluster, the global device mesh spans every process, and
the landmark-sharded Schur BA (parallel/dist_ba.py) runs unchanged as one
SPMD program — shard_map + psum compile to collectives across processes.
The tests exercise the same code path with N local CPU processes x M
virtual devices per process (tests/test_multihost.py, SURVEY.md section
4's multi-host test recipe).

Data model: SLAM map state is host-replicated numpy (every process tracks
the same session deterministically or receives the same solve inputs);
solver inputs become *global* jax.Arrays via `put_global`, which works in
both single-process (plain device_put) and multi-process mode (each
process donates its addressable shards).  Replicated outputs (poses) are
read locally; landmark-sharded outputs are gathered with
`gather_sharded`."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join the jax.distributed cluster (call before any other jax use).

    coordinator_address: "host:port" of process 0."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over EVERY device in the cluster (all processes)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def put_global(arr, mesh: Mesh, spec: P):
    """Host-replicated numpy -> global jax.Array with the given sharding.

    In single-process mode this is a plain device_put; in multi-process
    mode every process holds the SAME full array and donates the shards
    its local devices own."""
    sharding = NamedSharding(mesh, spec)
    arr = np.asarray(arr)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx])


def fetch_replicated(x) -> np.ndarray:
    """Read a fully-replicated global array from the local process."""
    shards = x.addressable_shards
    return np.asarray(shards[0].data)


def gather_sharded(x, mesh: Mesh) -> np.ndarray:
    """Gather a sharded global array to full numpy on every process: an
    in-program all-gather (reshard to fully replicated), then a local
    read."""
    if jax.process_count() == 1:
        return np.asarray(x)
    rep = NamedSharding(mesh, P())
    y = jax.jit(lambda a: a, out_shardings=rep)(x)
    return fetch_replicated(y)
