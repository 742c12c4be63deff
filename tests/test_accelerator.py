"""End-to-end parity of the device pipeline with the CPU host path.

The suite pins JAX to a virtual CPU mesh (conftest.py), so device
kernels normally never touch real hardware under pytest.
test_design_on_accelerator_matches_cpu designs a small corpus in a
SUBPROCESS on the default platform, through the device-resident
instance pipeline, and asserts the probe set equals the in-process CPU
host-path design.  It carries the ``gpu`` marker and skips on a host
without an NVIDIA GPU; run it on a GPU host with

    python -m pytest tests/ -m gpu

The analogue of the reference's determinism-across-process-counts tests
(reference test_set_cover_filter.py:134-175), across platforms.
"""

import json
import os
import subprocess
import sys

import pytest

_SNIPPET = r"""
import json, sys, os
sys.path.insert(0, {repo!r})
os.chdir({repo!r})
os.environ["CATCH_TPU_INSTANCE"] = "force"
import jax
from catch_tpu.utils import seq_io
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.designer import ProbeDesigner

genomes = seq_io.read_genomes_from_fasta(
    "tests/data/zaire_ebolavirus.fasta.gz")[:8]
scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=30)
d = ProbeDesigner([genomes], [DuplicateFilter(), scf],
                  probe_length=100, probe_stride=50)
d.design()
print(json.dumps({{
    "platform": jax.devices()[0].platform,
    "probes": sorted(p.seq_str for p in d.final_probes),
}}))
"""


def _gpu_present():
    """Whether nvidia-smi lists a GPU (asked without starting JAX, so
    the card stays free for the subprocess)."""
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return False
    return r.returncode == 0 and "GPU" in r.stdout


def test_parity_hash_current():
    """bench.py's committed accelerator-parity golden must equal what
    the CPU host path produces today — this is what keeps the bench's
    accel_parity check honest without a live CPU run per bench."""
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    got, n = bench.accel_parity_hash(instance_mode="host")
    assert n > 0
    assert got == bench.ACCEL_PARITY_SHA


def test_accelerator_snippet_is_valid_python():
    """The subprocess script of the GPU test formats and compiles (the
    GPU test itself skips on a host without a card)."""
    compile(_SNIPPET.format(repo="/checkout"), "<snippet>", "exec")


@pytest.mark.gpu
def test_design_on_accelerator_matches_cpu():
    if not _gpu_present():
        pytest.skip("needs an NVIDIA GPU (nvidia-smi lists none)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "-c", _SNIPPET.format(repo=repo)],
        capture_output=True, text=True, timeout=1500, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["platform"] == "gpu"

    # In-process CPU host-path reference
    os.environ["CATCH_TPU_INSTANCE"] = "host"
    try:
        from catch_tpu.utils import seq_io
        from catch_tpu.filters.duplicate import DuplicateFilter
        from catch_tpu.filters.set_cover_filter import SetCoverFilter
        from catch_tpu.designer import ProbeDesigner

        genomes = seq_io.read_genomes_from_fasta(os.path.join(
            repo, "tests/data/zaire_ebolavirus.fasta.gz"))[:8]
        scf = SetCoverFilter(mismatches=2, lcf_thres=60,
                             cover_extension=30)
        d = ProbeDesigner([genomes], [DuplicateFilter(), scf],
                          probe_length=100, probe_stride=50)
        d.design()
        want = sorted(p.seq_str for p in d.final_probes)
    finally:
        os.environ.pop("CATCH_TPU_INSTANCE", None)

    assert len(want) > 0
    assert result["probes"] == want
