"""Multi-host (multi-process) execution entry point.

The reference's scale-out story is a single host's fork pools
(/root/reference/catch/probe.py:766-894).  Here it is a
jax.distributed process group: each host owns a slice of the devices,
`jax.device_count()` reports the GLOBAL device count, and one
`jax.sharding.Mesh` built from `jax.devices()` spans every host
(catch_tpu/parallel/mesh.py builds exactly that — jax.devices() is the
global list once jax.distributed is initialized).

Layout for the probe-design pipeline over such a mesh:
- The corpus and probe tensors are replicated per host (they are MBs);
  candidate verification shards over the global device axis
  (ops/scan_sparse._verify_chunk_sharded), which is pure data
  parallelism — no collectives, so nothing crosses hosts during the
  scan.
- The greedy solve shards the position axis; each iteration reduces
  per-set scores with jax.lax.psum and broadcasts one chosen id
  (catch_tpu/parallel/set_cover.py), so the network between hosts
  carries only per-iteration scalars — the design point SURVEY.md §5
  calls for.

Single-host runs need none of this: maybe_initialize() is a no-op
unless the standard coordination environment is present, and every
code path here is exercised at n_processes=1 by the test suite and the
multichip dryrun (__graft_entry__.dryrun_multichip), which is how the
multi-host path is validated without multi-host hardware.

Launch example (2 hosts):
    host0$ CATCH_TPU_COORDINATOR=host0:8476 CATCH_TPU_NUM_PROCESSES=2 \
           CATCH_TPU_PROCESS_ID=0 design.py ...
    host1$ CATCH_TPU_COORDINATOR=host0:8476 CATCH_TPU_NUM_PROCESSES=2 \
           CATCH_TPU_PROCESS_ID=1 design.py ...
On a GPU cluster launched through SLURM or Open MPI,
jax.distributed.initialize() detects all three values from the
launcher's environment and the variables can be omitted (set
CATCH_TPU_MULTIHOST=1 to request initialization in that case).
"""

import logging
import os

logger = logging.getLogger(__name__)

__all__ = ["maybe_initialize", "is_initialized", "process_index",
           "process_count"]

_initialized = False


def maybe_initialize():
    """Initialize jax.distributed from the environment, if requested.

    Reads CATCH_TPU_COORDINATOR (host:port), CATCH_TPU_NUM_PROCESSES,
    and CATCH_TPU_PROCESS_ID; or just CATCH_TPU_MULTIHOST=1 to let JAX
    detect them (SLURM or Open MPI launch environment).  No-op when
    none are set, so single-host users never pay for or see any of
    this.

    Returns True when running with an initialized process group.
    """
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("CATCH_TPU_COORDINATOR")
    auto = os.environ.get("CATCH_TPU_MULTIHOST")
    if not coord and not auto:
        return False
    import jax

    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
        kwargs["num_processes"] = int(
            os.environ["CATCH_TPU_NUM_PROCESSES"])
        kwargs["process_id"] = int(os.environ["CATCH_TPU_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    _initialized = True
    logger.info(
        "jax.distributed initialized: process %d of %d, %d local / %d "
        "global devices", jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count())
    return True


def is_initialized():
    return _initialized


def process_index():
    import jax
    return jax.process_index()


def process_count():
    import jax
    return jax.process_count()
