"""Tests for the device set-cover solver.

Expectations ported from the reference's behavioral contract
(/root/reference/catch/utils/tests/test_set_cover.py): golden outputs on
hand-computable instances (which are tie-insensitive), representation
equivalence (sets vs arrays vs interval sets) on random instances, and
the per-universe coverage invariant.
"""

from collections import defaultdict
import random

import numpy as np
import pytest

from catch_tpu.ops import set_cover as sc
from catch_tpu.utils.intervals import IntervalSet


class TestApprox:
    def test_complete_unweighted(self):
        inp = {0: {1, 2}, 1: {1, 2, 4}, 2: {2, 4}, 3: {4, 5}, 4: {3}}
        assert sc.approx(inp) == {1, 3, 4}

    def test_partial_unweighted1(self):
        inp = {0: {1, 2}, 1: {1, 2, 4}, 2: {2, 4}, 3: {4, 5}, 4: {3}}
        assert sc.approx(inp, p=0.6) == {1}

    def test_partial_unweighted2(self):
        inp = {0: {1, 2}, 1: {1, 2, 4}, 2: {2, 4}, 3: {4, 5}, 4: {2, 3, 6}}
        assert sc.approx(inp, p=0.81) == {1, 4}

    def test_complete_weighted1(self):
        inp = {0: {1, 2}, 1: {1, 2, 4}, 2: {2, 4}, 3: {4, 5}, 4: {3}}
        costs = {0: 2, 1: 1000, 2: 3, 3: 1, 4: 10}
        assert sc.approx(inp, costs=costs) == {0, 3, 4}

    def test_complete_weighted2(self):
        inp = {0: {1, 2}, 1: {1, 2, 3, 4, 5}, 2: {4}, 3: {5}, 4: {3}}
        costs = {0: 2, 1: 1000, 2: 3, 3: 1, 4: 10}
        assert sc.approx(inp, costs=costs) == {0, 2, 3, 4}

    def test_partial_weighted1(self):
        inp = {0: {1, 2}, 1: {1, 2, 3, 4, 5}, 2: {4}, 3: {5}, 4: {3}}
        costs = {0: 2, 1: 1000, 2: 3, 3: 1, 4: 10}
        assert sc.approx(inp, costs=costs, p=0.1) == {3}

    def test_partial_weighted2(self):
        inp = {0: {1, 2}, 1: {2, 3}, 2: {4, 5}, 3: {5}, 4: {4}}
        costs = {0: 2, 1: 1000, 2: 100, 3: 10, 4: 10}
        assert sc.approx(inp, costs=costs, p=0.7) == {0, 3, 4}

    def test_partial_weighted3(self):
        inp = {0: {1, 2}, 1: {3}, 2: {4}, 3: {2, 5}, 4: {1}}
        costs = {0: 2, 1: 1000, 2: 999, 3: 10, 4: 10}
        assert sc.approx(inp, costs=costs, p=0.8) == {0, 2, 3}

    def test_partial_weighted4(self):
        inp = {0: {1, 2}, 1: {3, 4, 5}, 2: {3}, 3: {4}, 4: {5}}
        costs = {0: 2.1, 1: 3, 2: 2, 3: 2, 4: 2}
        assert sc.approx(inp, costs=costs, p=0.6) == {1}

    def test_partial_weighted5(self):
        inp = {0: {1, 2}, 1: {2, 3, 4, 5}, 2: {3}, 3: {4}, 4: {5}}
        costs = {0: 3, 1: 4, 2: 1, 3: 1, 4: 2}
        assert sc.approx(inp, costs=costs, p=0.8) == {1}
        costs = {0: 3, 1: 4.1, 2: 1, 3: 1, 4: 2}
        # The optimal solution is {1}, but greedy fails to find it
        assert sc.approx(inp, costs=costs, p=0.8) == {0, 2, 3}

    def test_no_elements(self):
        assert sc.approx({}) == set()
        assert sc.approx({0: set()}) == set()

    def test_one_element(self):
        assert sc.approx({0: {1}}) == {0}

    def test_invalid_p(self):
        with pytest.raises(ValueError):
            sc.approx({0: {1}}, p=1.5)
        with pytest.raises(ValueError):
            sc.approx({0: {1}}, p=-0.1)

    def test_negative_cost(self):
        with pytest.raises(ValueError):
            sc.approx({0: {1}}, costs={0: -1})


class TestApproxMultiuniverse:
    def test_one_universe_complete_unweighted(self):
        sets = {0: {0: {1, 2}}, 1: {0: {1, 2, 4}}, 2: {0: {2, 4}},
                3: {0: {4, 5}}, 4: {0: {3}}}
        assert sc.approx_multiuniverse(sets) == {1, 3, 4}

    def test_two_universes_complete_unweighted(self):
        sets = {0: {0: {1, 2}}, 1: {0: {1, 2, 4}}, 2: {0: {2, 4}},
                3: {0: {4}, 1: {5}}, 4: {1: {3}}}
        assert sc.approx_multiuniverse(sets) == {1, 3, 4}

    def test_one_universe_partial_unweighted(self):
        sets = {0: {0: {1, 2}}, 1: {0: {1, 2, 4}}, 2: {0: {2, 4}},
                3: {0: {4, 5}}, 4: {0: {3}}}
        assert sc.approx_multiuniverse(sets, universe_p={0: 0.6}) == {1}

    def test_two_universes_partial_unweighted1(self):
        sets = {0: {1: {1, 2}}, 1: {1: {1, 2, 4}}, 2: {1: {2, 4}},
                3: {0: {5}, 1: {4}}, 4: {0: {3}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 0.3}) == {3, 4}

    def test_two_universes_partial_unweighted2(self):
        sets = {0: {0: {2}, 1: {1}}, 1: {0: {2, 4}, 1: {1}},
                2: {0: {2, 4}}, 3: {0: {4}, 1: {5}}, 4: {0: {3}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 0.5}) == {1, 4}

    def test_two_universes_partial_weighted1(self):
        sets = {0: {0: {1, 2}}, 1: {0: {1, 2}, 1: {3, 4, 5}},
                2: {1: {4}}, 3: {1: {5}}, 4: {1: {3}}}
        costs = {0: 2, 1: 1000, 2: 3, 3: 1, 4: 10}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.1, 1: 0.1}) == {0, 3}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.0, 1: 0.1}) == {3}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.5, 1: 0.5}) == {0, 2, 3}

    def test_two_universes_partial_weighted2(self):
        sets = {0: {0: {1, 2}}, 1: {0: {2, 3}, 1: {4, 5}},
                2: {0: {3}}, 3: {1: {4}}, 4: {1: {5}}}
        costs = {0: 3, 1: 4, 2: 1, 3: 1, 4: 2}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 1.0, 1: 0.5}) == {0, 2, 3}

    def test_two_universes_partial_weighted3(self):
        sets = {0: {1: {1, 2}}, 1: {0: {3, 4, 5}, 1: {2}},
                2: {0: {3}}, 3: {0: {4}}, 4: {0: {5}}}
        costs = {0: 1000, 1: 4, 2: 1, 3: 1, 4: 2}
        # The optimal solution is {1} but greedy fails to find it
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.6, 1: 0.5}) == {1, 2, 3}
        costs = {0: 1000, 1: 4, 2: 1.5, 3: 1.5, 4: 2}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.6, 1: 0.5}) == {1}

    def test_three_universes_partial_weighted(self):
        sets = {0: {0: {1, 2}}, 1: {0: {2}, 1: {3, 4}}, 2: {1: {3}},
                3: {1: {4}, 2: {6}}, 4: {2: {5}}}
        costs = {0: 3, 1: 4, 2: 1, 3: 1, 4: 1000}
        assert sc.approx_multiuniverse(
            sets, costs, {0: 0.5, 1: 0.5, 2: 1.0}) == {0, 3, 4}

    def test_same_value_different_universe1(self):
        sets = {0: {0: {1, 2}}, 1: {1: {1}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 1.0}) == {0, 1}

    def test_same_value_different_universe2(self):
        sets = {0: {0: {1, 2}, 1: {1}}, 1: {1: {1}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 1.0}) == {0}

    def test_same_value_different_universe3(self):
        sets = {0: {0: {1, 2}, 1: {2}}, 1: {0: {1, 2, 3}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 1.0}) == {0, 1}

    def test_tuple_universe_id(self):
        sets = {0: {(0, 0): {1, 2}, (1, 0): {2}}, 1: {(0, 0): {1, 2, 3}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={(0, 0): 1.0, (1, 0): 1.0}) == {0, 1}

    def test_one_universe_rank(self):
        sets = {0: {0: {1, 2, 3}}, 1: {0: {1, 2, 3, 4}},
                2: {0: {1, 2, 3}}, 3: {0: {1, 2, 3}}}
        ranks = {0: 5, 1: 10, 2: 1, 3: 10}
        assert sc.approx_multiuniverse(sets, ranks=ranks) == {1, 2}

    def test_two_universes_ranks(self):
        sets = {0: {0: {1, 2, 3, 4}, 1: {1}}, 1: {0: {1, 2, 3}},
                2: {0: {4}, 1: {1}}, 3: {0: {2}}}
        ranks = {0: 100, 1: 3, 2: 2, 3: 1}
        assert sc.approx_multiuniverse(sets, ranks=ranks) == {1, 2, 3}

    def test_cost_and_ranks1(self):
        sets = {0: {0: {1, 2, 3, 4, 5}}, 1: {0: {1, 2, 3}},
                2: {0: {3, 4}}, 3: {0: {1, 2, 3, 4}}}
        ranks = {0: 2, 1: 1, 2: 1, 3: 1}
        costs = {0: 1, 1: 1, 2: 1, 3: 10}
        assert sc.approx_multiuniverse(
            sets, costs=costs, ranks=ranks) == {0, 1, 2}

    def test_cost_and_ranks2(self):
        sets = {0: {0: {1, 2, 3, 4}}, 1: {0: {1, 2, 3}},
                2: {0: {3, 4}}, 3: {0: {1, 2, 3, 4}}}
        ranks = {0: 2, 1: 1, 2: 1, 3: 1}
        costs = {0: 1, 1: 1, 2: 1, 3: 10}
        assert sc.approx_multiuniverse(
            sets, costs=costs, ranks=ranks) == {1, 2}

    def test_partial_coverage_with_ranks(self):
        sets = {0: {0: {1, 2, 3}}, 1: {0: {4, 5, 6}},
                2: {0: {7, 8, 9}}, 3: {0: {10, 11, 12}}}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.25},
            ranks={0: 2, 1: 1, 2: 2, 3: 2}) == {1}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.5},
            ranks={0: 3, 1: 1, 2: 3, 3: 2}) == {1, 3}

    def test_two_universe_partial_coverage_with_ranks(self):
        sets = {0: {0: {1, 2, 3}, 1: {1, 2, 3}}, 1: {0: {4, 5, 6}},
                2: {0: {7, 8, 9}, 1: {1}}}
        ranks = {0: 10, 1: 5, 2: 1}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.1, 1: 0.1}, ranks=ranks) == {2}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.1, 1: 0.5}, ranks=ranks) == {0, 2}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.5, 1: 0.1}, ranks=ranks) == {1, 2}
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 0.5, 1: 0.5}, ranks=ranks) == {0, 1, 2}

    def test_with_intervalsets(self):
        sets = {
            0: {0: IntervalSet([(1, 100)]), 1: IntervalSet([(1, 5)])},
            1: {0: IntervalSet([(20, 30)])},
            2: {0: IntervalSet([(40, 50)]), 1: IntervalSet([(20, 50)])},
        }
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 0.1},
            use_intervalsets=True) == {0}

    def test_with_intervalsets_single_interval(self):
        sets = {
            0: {0: IntervalSet([(1, 100)]), 1: (1, 5)},
            1: {0: (20, 30)},
            2: {0: IntervalSet([(40, 50)]), 1: (20, 50)},
        }
        assert sc.approx_multiuniverse(
            sets, universe_p={0: 1.0, 1: 0.1},
            use_intervalsets=True) == {0}

    def test_arrays_and_intervalsets_conflict(self):
        with pytest.raises(ValueError):
            sc.approx_multiuniverse({0: {0: {1}}}, use_arrays=True,
                                    use_intervalsets=True)

    def test_missing_cost(self):
        with pytest.raises(ValueError):
            sc.approx_multiuniverse({0: {0: {1}}, 1: {0: {2}}},
                                    costs={0: 1})

    def test_missing_rank(self):
        with pytest.raises(ValueError):
            sc.approx_multiuniverse({0: {0: {1}}, 1: {0: {2}}},
                                    ranks={0: 1})

    def test_missing_universe_p(self):
        with pytest.raises(ValueError):
            sc.approx_multiuniverse({0: {0: {1}, 1: {2}}},
                                    universe_p={0: 1.0})

    def test_no_elements(self):
        assert sc.approx_multiuniverse({}) == set()
        assert sc.approx_multiuniverse({0: {0: set()}}) == set()

    def test_one_element(self):
        assert sc.approx_multiuniverse({0: {0: {1}}}) == {0}


def _verify_partial_cover(sets, universe_p, output):
    """Coverage invariant from the reference test harness."""
    universes = defaultdict(set)
    for sbu in sets.values():
        for uid, s in sbu.items():
            universes[uid].update(s)
    for uid, universe in universes.items():
        covered = set()
        for sid in output:
            if uid in sets[sid]:
                covered.update(sets[sid][uid])
        assert len(covered & universe) >= universe_p[uid] * len(universe)


class TestRandomInstances:
    """Randomized representation-equivalence + invariant tests
    (reference test_set_cover.py:545-556 analogue)."""

    def _random_instance(self, rng, contiguous):
        n_sets = rng.randint(5, 25)
        n_univ = rng.randint(1, 4)
        sets = {}
        for sid in range(n_sets):
            sbu = {}
            for uid in range(n_univ):
                if rng.random() < 0.3:
                    continue
                if contiguous:
                    start = rng.randint(0, 300)
                    length = rng.randint(1, 60)
                    sbu[uid] = set(range(start, start + length))
                else:
                    sbu[uid] = {rng.randint(0, 500)
                                for _ in range(rng.randint(1, 40))}
            if sbu:
                sets[sid] = sbu
        universe_p = {uid: rng.choice([0.5, 0.8, 1.0])
                      for uid in range(n_univ)}
        # Restrict universe_p to universes that exist
        seen = set()
        for sbu in sets.values():
            seen.update(sbu.keys())
        universe_p = {u: p for u, p in universe_p.items() if u in seen}
        return sets, universe_p

    def test_random_equivalence_and_invariant(self):
        rng = random.Random(1)
        for trial in range(10):
            contiguous = trial % 2 == 0
            sets, universe_p = self._random_instance(rng, contiguous)
            if not sets:
                continue
            out_sets = sc.approx_multiuniverse(sets, universe_p=universe_p)
            _verify_partial_cover(sets, universe_p, out_sets)
            # arrays representation must give identical output
            sets_arr = {sid: {uid: list(s) for uid, s in sbu.items()}
                        for sid, sbu in sets.items()}
            out_arr = sc.approx_multiuniverse(
                sets_arr, universe_p=universe_p, use_arrays=True)
            assert out_sets == out_arr
            if contiguous:
                sets_ivl = {
                    sid: {uid: IntervalSet(
                        sc._runs_to_intervals(
                            np.array(sorted(s), dtype=np.int64)))
                        for uid, s in sbu.items()}
                    for sid, sbu in sets.items()}
                out_ivl = sc.approx_multiuniverse(
                    sets_ivl, universe_p=universe_p, use_intervalsets=True)
                assert out_sets == out_ivl

    def test_host_device_parity(self):
        """The numpy mirror and the jitted device solver must produce
        identical pick orders on random instances."""
        rng = random.Random(3)
        for trial in range(4):
            sets, universe_p = self._random_instance(rng, trial % 2 == 0)
            if not sets:
                continue
            ranks = {sid: rng.choice([1, 1, 1, 2, 3])
                     for sid in sets.keys()}
            costs = {sid: rng.choice([1.0, 1.0, 2.0, 10.0])
                     for sid in sets.keys()}
            inst, _ = sc.build_instance(
                sets, costs=costs, universe_p=universe_p, ranks=ranks)
            host = sc.solve_instance(inst, force_device=False)
            dev = sc.solve_instance(inst, force_device=True)
            assert list(host) == list(dev)

    def test_lazy_parity_random(self):
        """The lazy-greedy solver must produce a pick order bit-identical
        to the full-rescan mirror, including rank tiers, costs, partial
        coverage, and float32 ratio ties."""
        rng = random.Random(11)
        for trial in range(6):
            sets, universe_p = self._random_instance(rng, trial % 2 == 0)
            if not sets:
                continue
            ranks = {sid: rng.choice([1, 1, 1, 2, 3]) for sid in sets}
            costs = {sid: rng.choice([1.0, 1.0, 2.0, 10.0])
                     for sid in sets}
            inst, _ = sc.build_instance(
                sets, costs=costs, universe_p=universe_p, ranks=ranks)
            full = sc._solve_host(inst)
            lazy = sc._solve_host_lazy(inst)
            assert list(full) == list(lazy)

    def test_lazy_parity_large_instance(self):
        """Large instance with many equal-ratio ties (the production
        shape: unit costs, interval sets over a long position axis)."""
        rng = np.random.default_rng(5)
        n_sets, n_univ, span = 3000, 4, 20000
        set_ids, univ_ids, starts, ends = [], [], [], []
        for s in range(n_sets):
            for u in range(n_univ):
                if rng.random() < 0.6:
                    k = int(rng.integers(1, 4))
                    for _ in range(k):
                        a = int(rng.integers(0, span - 120))
                        ln = int(rng.integers(60, 120))
                        set_ids.append(s)
                        univ_ids.append(u)
                        starts.append(a)
                        ends.append(a + ln)
        inst = sc.build_instance_from_cover_arrays(
            np.array(set_ids), np.array(univ_ids), np.array(starts),
            np.array(ends), n_sets=n_sets, n_universes=n_univ,
            universe_p=np.full(n_univ, 0.95))
        full = sc._solve_host(inst)
        lazy = sc._solve_host_lazy(inst)
        assert list(full) == list(lazy)
        assert len(full) > 100  # nontrivial pick count

    def test_matches_reference_greedy(self):
        """Against a straightforward host reimplementation of the greedy
        rule (lowest-id tie-break)."""
        rng = random.Random(7)
        for _ in range(8):
            sets, universe_p = self._random_instance(rng, False)
            if not sets:
                continue
            got = sc.approx_multiuniverse(sets, universe_p=universe_p)
            want = _host_greedy(sets, universe_p)
            assert got == want


def _host_greedy(sets, universe_p):
    """Simple host greedy with lowest-id tie-break (oracle)."""
    universes = defaultdict(set)
    for sbu in sets.values():
        for uid, s in sbu.items():
            universes[uid].update(s)
    can_unc = {u: int(len(s) - universe_p[u] * len(s))
               for u, s in universes.items()}
    left = {u: len(s) - can_unc[u] for u, s in universes.items()}
    not_in = sorted(sets.keys())
    chosen = set()
    while any(v > 0 for v in left.values()):
        best, best_ratio = None, float("inf")
        for sid in not_in:
            num = 0
            for uid, s in sets[sid].items():
                num += min(left[uid], len(s & universes[uid]))
            if num == 0:
                continue
            ratio = 1.0 / num
            if ratio < best_ratio:
                best, best_ratio = sid, ratio
        if best is None:
            break
        chosen.add(best)
        not_in.remove(best)
        for uid, s in sets[best].items():
            universes[uid] -= s
            left[uid] = max(0, len(universes[uid]) - can_unc[uid])
    return chosen
