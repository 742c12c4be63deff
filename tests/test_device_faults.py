"""A fault on the device path must propagate, never turn into a host run.

Each test makes one device program (or the device setup around it)
raise and asserts that the user-facing entry point raises too, where it
once logged the fault and finished on the host.  Also covers the
compile-cache directory rule and the GPU guard of chip_smoke.py and
bench.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.genome import Genome
from catch_tpu.ops import scan_instance, scan_sparse, set_cover
from catch_tpu.ops.cover import CoverModel, ProbeSearcher
from catch_tpu.probe import Probe
from catch_tpu.utils import lsh, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class DeviceFault(RuntimeError):
    pass


def _raise(*args, **kwargs):
    raise DeviceFault("simulated device fault")


def _corpus(n=3, length=400, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=length)
    seqs = []
    for _ in range(n):
        s = base.copy()
        m = rng.random(length) < 0.02
        s[m] = rng.choice(list("ACGT"), size=int(m.sum()))
        seqs.append("".join(s))
    return seqs


def _filter_input():
    seqs = _corpus()
    probes = [Probe.from_str(s[i:i + 40]) for s in seqs
              for i in range(0, len(s) - 40 + 1, 20)]
    return [probes], [[Genome.from_one_seq(s) for s in seqs]]


def _run_filter():
    probes, genomes = _filter_input()
    scf = SetCoverFilter(mismatches=1, lcf_thres=40, cover_extension=5)
    return scf.filter(probes, genomes, input_is_grouped=True)


@pytest.fixture
def device_route(monkeypatch):
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")


def test_filter_device_route_runs(device_route):
    out = _run_filter()
    assert len(out[0]) > 0


def test_scan_fault_raises_without_retry(device_route, monkeypatch):
    calls = []

    def fault(*args, **kwargs):
        calls.append(1)
        raise DeviceFault("simulated device fault")

    monkeypatch.setattr(scan_instance, "scan_to_boundary_instance", fault)
    with pytest.raises(DeviceFault):
        _run_filter()
    assert len(calls) == 1


def test_packed_readback_fault_raises(device_route, monkeypatch):
    monkeypatch.setattr(scan_instance, "_pack_merged_jit", _raise)
    with pytest.raises(DeviceFault):
        _run_filter()


def test_solve_fault_on_device_instance_raises(device_route, monkeypatch):
    monkeypatch.setattr(scan_instance, "instance_to_host", _raise)
    with pytest.raises(DeviceFault):
        _run_filter()


def test_device_solver_fault_raises(monkeypatch):
    monkeypatch.setattr(set_cover, "_solve_device_steps", _raise)
    inst, _ = set_cover.build_instance(
        {0: {0: {1, 2, 3}}, 1: {0: {3, 4}}}, universe_p={0: 1.0})
    with pytest.raises(DeviceFault):
        set_cover.solve_instance(inst, force_device=True)


def test_batched_scan_fault_raises(monkeypatch):
    monkeypatch.setattr(scan_sparse, "scan_corpus_sparse", _raise)
    seqs = _corpus()
    searcher = ProbeSearcher([Probe.from_str(seqs[0][:40])],
                             CoverModel(1, 40))
    with pytest.raises(DeviceFault):
        searcher.find_probe_covers_flat(seqs, force_batch=True)


def test_signature_kernel_fault_raises(monkeypatch):
    monkeypatch.setattr(lsh, "_DEVICE_SIG_MIN_CELLS", 0)
    monkeypatch.setattr(lsh, "_minhash_sig_kernel", _raise)
    seqs = [s[:100] for s in _corpus()]
    with pytest.raises(DeviceFault):
        lsh.BatchedNearNeighbor(
            lsh.MinHashFamily(10, rng=np.random.default_rng(0)), 3, 0.6,
            0.8, seqs)


def test_signature_device_route_matches_numpy(monkeypatch):
    seqs = [s[i:i + 100] for s in _corpus(length=600)
            for i in range(0, 500, 50)]

    def sigs(cells):
        monkeypatch.setattr(lsh, "_DEVICE_SIG_MIN_CELLS", cells)
        return lsh.BatchedNearNeighbor(
            lsh.MinHashFamily(10, rng=np.random.default_rng(0)), 3, 0.6,
            0.8, seqs)._sig

    assert np.array_equal(sigs(0), sigs(1 << 62))


def test_mesh_fault_raises(monkeypatch, tmp_path):
    import catch_tpu.parallel
    from catch_tpu.cli import design

    monkeypatch.setattr(catch_tpu.parallel, "make_mesh", _raise)
    fasta = tmp_path / "g.fasta"
    fasta.write_text("".join(">g%d\n%s\n" % (i, s)
                             for i, s in enumerate(_corpus())))
    args = design.init_and_parse_args("basic", [
        str(fasta), "-o", str(tmp_path / "p.fasta"), "-pl", "40",
        "-ps", "20", "-m", "1", "-l", "40", "--num-devices", "2"])
    with pytest.raises(DeviceFault):
        design.main(args)


# -- compile cache -----------------------------------------------------

def test_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = profiling.compilation_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("from_env", [True, False])
def test_enable_compilation_cache(monkeypatch, tmp_path, from_env):
    import jax

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.delenv("CATCH_TPU_NO_COMPILE_CACHE", raising=False)
    if from_env:
        want = str(tmp_path / "from_env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = str(tmp_path / "checkout_cache")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(profiling, "_CHECKOUT_CACHE_DIR", want)
    profiling.enable_compilation_cache()
    assert updates["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


def test_compilation_cache_opt_out(monkeypatch):
    import jax

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setenv("CATCH_TPU_NO_COMPILE_CACHE", "1")
    profiling.enable_compilation_cache()
    assert updates == {}


# -- GPU guards --------------------------------------------------------

def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_exits_nonzero(script):
    r = _run_cpu([script], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# -- chip_smoke's references -------------------------------------------

def test_reference_helper_reproduces_accel_parity_golden(tmp_path):
    """The helper that made chip_smoke's ebola175 golden reproduces the
    committed 8-genome parity golden."""
    import bench
    import chip_smoke

    cfg = bench.ACCEL_PARITY_CONFIG
    argv = ["-pl", str(cfg["probe_length"]), "-ps",
            str(cfg["probe_stride"]), "-m", str(cfg["mismatches"]),
            "-l", str(cfg["lcf_thres"]), "-e", str(cfg["cover_extension"])]
    sha, n = chip_smoke.reference_design_sha(cfg["n_genomes"], argv,
                                             str(tmp_path))
    assert sha == bench.ACCEL_PARITY_SHA
    assert n == 188


def test_numpy_reference_route_runs_no_device_scan(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(scan_sparse, "scan_corpus_sparse", _raise)
    monkeypatch.setattr(scan_instance, "scan_to_boundary_instance", _raise)
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    before = ProbeSearcher._BATCH_MIN_BP
    with chip_smoke.numpy_reference_route():
        _run_filter()
    assert ProbeSearcher._BATCH_MIN_BP == before
    assert os.environ["CATCH_TPU_INSTANCE"] == "force"


def test_shape_recorder_lowers_recorded_shapes():
    import jax
    import jax.numpy as jnp
    import chip_smoke

    @jax.jit
    def f(x, *, k):
        return x * k

    rec = chip_smoke._ShapeRecorder(f)
    rec(jnp.ones(8), k=2)
    rec(jnp.ones(8), k=2)
    rec(jnp.ones(16), k=2)
    assert len(rec.calls) == 2
    lines = rec.memory_lines("f")
    assert len(lines) == 2 and all(line.startswith("  f ") for line in lines)
