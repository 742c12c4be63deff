"""Multi-device (mesh) execution for catch-tpu.

The reference parallelizes with fork-based process pools on one host
(/root/reference/catch/probe.py:766-1005, base_filter.py:111-165,
set_cover_filter.py:848-900, cluster.py:107-194).  Here the equivalents
are jax.sharding over a Mesh:

- P1 (sequence scan): candidate (probe, alignment) pairs sharded
  across devices, each verified against the replicated corpus + probe
  tensors (catch_tpu/ops/scan_sparse._verify_chunk_sharded).
- P3 (set cover): candidate sets sharded across devices; each greedy
  iteration computes per-set scores locally and merges the pick with
  psum/pmin collectives (catch_tpu/parallel/set_cover.py).
- P2/P4 (per-group filtering, pairwise distances) remain host loops
  over device-resident batched kernels; groups are independent.

Multi-host: catch_tpu/parallel/distributed.py initializes a
jax.distributed process group from the environment, after which
make_mesh() spans every host's devices and the same sharded code paths
run with the network between hosts carrying only per-iteration
scalars.
"""

from catch_tpu.parallel.mesh import make_mesh
from catch_tpu.parallel.set_cover import solve_instance_sharded
from catch_tpu.parallel.distributed import maybe_initialize
