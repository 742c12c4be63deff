"""catch-tpu: a JAX probe-design engine.

A from-scratch JAX/XLA framework with the
capabilities of broadinstitute/catch: design of compact DNA oligo probe
sets that guarantee configurable coverage of diverse input genomes under
a mismatch/longest-common-substring hybridization model, minimized via
greedy weighted multi-universe set cover.

Architecture (vs. the CPU reference at /root/reference):

- The reference's k-mer hash map + per-candidate anchored-LCS scan
  (reference catch/probe.py:507-1271) is replaced by a device-resident
  pipeline (catch_tpu/ops/scan_instance): a stride-sampled exact k-mer
  join against a dense probe seed table, batched maximal-window
  verification, and a segmented-scan interval merge that assembles the
  set-cover instance without moving candidates or spans to the host.
  Seeding is exhaustive (every k-run of exact matches counts as a
  seed), making the engine deterministic with recall >= the
  reference's Monte-Carlo k-mer sampling.
- The reference's greedy multi-universe set cover
  (reference catch/utils/set_cover.py:147) runs as batched greedy
  steps on device with boundary-indexed segment sums
  (catch_tpu/ops/set_cover), with a sharded path merging
  per-iteration scores with jax.lax.psum across a device mesh.
- The reference's fork-based multiprocessing pools are replaced by
  jax.sharding over a Mesh, single- or multi-host
  (catch_tpu/parallel/).
"""

__version__ = "0.1.0"

from catch_tpu.genome import Genome
from catch_tpu.probe import Probe
