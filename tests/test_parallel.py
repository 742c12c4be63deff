"""Multi-device equivalence tests on the virtual 8-device CPU mesh.

The counterpart of the reference's "same output for num_processes in
{None,1,2,4}" tests (/root/reference/catch/filter/tests/
test_set_cover_filter.py:134-175): device count must not change results.
"""

import random
import unittest

import numpy as np
import pytest

import jax

from catch_tpu.ops import set_cover
from catch_tpu.parallel import make_mesh, solve_instance_sharded


def _random_instance(rng, n_sets=40, n_universes=4, u_size=200):
    sets = {}
    for sid in range(n_sets):
        per_u = {}
        for u in range(n_universes):
            if rng.random() < 0.3:
                continue
            k = rng.randint(1, u_size // 2)
            per_u[u] = set(rng.sample(range(u_size), k))
        if per_u:
            sets[sid] = per_u
    costs = {sid: rng.choice([1.0, 2.0, 3.0]) for sid in sets}
    ranks = {sid: rng.choice([1, 1, 1, 2, 5]) for sid in sets}
    universe_p = {u: rng.choice([0.5, 0.9, 1.0]) for u in range(n_universes)}
    return sets, costs, ranks, universe_p


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_sharded_set_cover_matches_host(n_devices):
    rng = random.Random(101)
    for trial in range(3):
        sets, costs, ranks, universe_p = _random_instance(rng)
        inst, set_ids = set_cover.build_instance(
            sets, costs=costs, universe_p=universe_p, ranks=ranks)
        expected = set_cover.solve_instance(inst, force_device=False)
        mesh = make_mesh(n_devices)
        got = solve_instance_sharded(inst, mesh=mesh)
        assert got.tolist() == expected.tolist(), \
            f"trial {trial}, n_devices {n_devices}"


def test_sharded_set_cover_single_universe():
    sets = {0: {0: {1, 2}, 1: {1}}, 1: {0: {1, 2, 4}},
            2: {1: {2, 3}}, 3: {0: {4, 5}, 1: {4}}}
    inst, set_ids = set_cover.build_instance(sets)
    expected = set_cover.solve_instance(inst, force_device=False)
    got = solve_instance_sharded(inst, mesh=make_mesh(8))
    assert got.tolist() == expected.tolist()


def test_sharded_set_cover_ranks_tiering():
    # Rank-0 sets must be exhausted before rank-1 sets are touched
    sets = {0: {0: {0, 1}}, 1: {0: {2, 3}}, 2: {0: {0, 1, 2, 3}}}
    ranks = {0: 0, 1: 0, 2: 1}
    inst, set_ids = set_cover.build_instance(sets, ranks=ranks)
    got = solve_instance_sharded(inst, mesh=make_mesh(4))
    chosen = {set_ids[i] for i in got.tolist()}
    assert chosen == {0, 1}


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError):
        make_mesh(len(jax.devices()) + 1)


class TestShardedPipeline(unittest.TestCase):
    """The real SetCoverFilter pipeline emits an identical probe set for
    every device count (the counterpart of the reference's
    num_processes-invariance contract, test_set_cover_filter.py:134-175)."""

    def test_set_cover_filter_mesh_invariance(self):
        from catch_tpu.utils import seq_io
        from catch_tpu.filters.duplicate import DuplicateFilter
        from catch_tpu.filters.set_cover_filter import SetCoverFilter
        from catch_tpu.designer import ProbeDesigner
        from catch_tpu.parallel import make_mesh

        genomes = seq_io.read_genomes_from_fasta(
            "tests/data/zaire_ebolavirus.fasta.gz")[:3]

        def run(mesh):
            scf = SetCoverFilter(mismatches=1, lcf_thres=80,
                                 cover_extension=20, mesh=mesh)
            d = ProbeDesigner([genomes], [DuplicateFilter(), scf],
                              probe_length=80, probe_stride=40)
            d.design()
            return sorted(p.seq_str for p in d.final_probes)

        want = run(None)
        self.assertGreater(len(want), 0)
        for n in (2, 8):
            got = run(make_mesh(n))
            self.assertEqual(got, want)
