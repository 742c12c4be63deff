"""Parity tests: device-resident instance pipeline vs the host path.

The device pipeline (ops/scan_instance + solve_boundary_instance) must
produce the exact same merged cover intervals and the exact same greedy
pick sequence as the host path (scan_sparse/per-sequence scan ->
build_instance_from_cover_arrays -> host lazy solver) on any workload
it accepts.  Shape constants are monkeypatched small so the slabbed /
subrange / batched code paths are exercised on CPU-sized corpora.
"""

import os

import numpy as np
import pytest

from catch_tpu.filters.candidates import make_candidate_probes_from_sequences
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.genome import Genome
from catch_tpu.ops import scan_instance, set_cover
from catch_tpu.ops.cover import CoverModel, ProbeSearcher

BASES = np.array(list("ACGT"))


def _corpus(rng, n_genomes, n_len, mut=0.03, n_chrs=1):
    base = rng.choice(BASES, size=n_len)
    genomes = []
    for _ in range(n_genomes):
        seq = base.copy()
        m = rng.random(n_len) < mut
        seq[m] = rng.choice(BASES, size=int(m.sum()))
        if n_chrs == 1:
            genomes.append(Genome.from_one_seq("".join(seq)))
        else:
            bounds = np.linspace(0, n_len, n_chrs + 1).astype(int)
            chrs = {f"chr{i}": "".join(seq[a:b]) for i, (a, b) in
                    enumerate(zip(bounds[:-1], bounds[1:]))}
            genomes.append(Genome.from_chrs(chrs))
    return genomes


@pytest.fixture
def small_shapes(monkeypatch):
    """Shrink static shapes so CPU tests hit the slab/subrange/batch
    paths instead of the single-dispatch fast case."""
    monkeypatch.setattr(scan_instance, "_SLAB_SAMPLES", 1 << 11)
    monkeypatch.setattr(scan_instance, "_T_SLAB", 1 << 15)
    monkeypatch.setattr(scan_instance, "_C_CHUNK", 1 << 10)
    monkeypatch.setattr(scan_instance, "_SPAN_CAP", 1 << 12)
    monkeypatch.setattr(scan_instance, "_BATCH_CHUNKS", 4)
    monkeypatch.setattr(scan_instance, "_UNION_CAP", 1 << 10)


def _run_pipeline_direct(genomes, probes, model_kw, cover_extension=0,
                         universe_p=None, rank_idx=None, n_rank_vals=1):
    """Run scan_to_boundary_instance the way SetCoverFilter does."""
    model = CoverModel(**model_kw)
    searcher = ProbeSearcher(probes, model)
    pid_of = {}
    for i, p in enumerate(probes):
        pid_of[p] = i
    pid = np.array([pid_of[p] for p in searcher.probes], dtype=np.int64)
    sequences, seq_univ, seq_off, seq_len = [], [], [], []
    for j, g in enumerate(genomes):
        off = 0
        for s in g.seqs:
            sequences.append(s)
            seq_univ.append(j)
            seq_off.append(off)
            seq_len.append(len(s))
            off += len(s)
    nU = len(genomes)
    if universe_p is None:
        universe_p = np.ones(nU)
    if rank_idx is None:
        rank_idx = np.zeros(len(probes), dtype=np.int32)
    costs = np.ones(len(probes), dtype=np.float32)
    r = scan_instance.scan_to_boundary_instance(
        searcher, sequences, np.array(seq_univ), np.array(seq_off),
        np.array(seq_len), nU, cover_extension, universe_p, rank_idx,
        n_rank_vals, costs, pid)
    return searcher, pid, r, (sequences, np.array(seq_univ),
                              np.array(seq_off),
                              np.array(seq_len, dtype=np.int64))


def _host_instance(searcher, pid, seq_info, genomes, cover_extension,
                   universe_p, ranks):
    sequences, seq_univ, seq_off, seq_len = seq_info
    p_idx, s_idx, st, en = searcher.find_probe_covers_flat(
        sequences, force_batch=False)
    st = np.maximum(0, st - cover_extension)
    en = np.minimum(seq_len[s_idx], en + cover_extension)
    return set_cover.build_instance_from_cover_arrays(
        pid[p_idx], seq_univ[s_idx], st + seq_off[s_idx],
        en + seq_off[s_idx], n_sets=int(pid.max()) + 1 if len(pid) else 0,
        n_universes=len(genomes), universe_p=universe_p, ranks=ranks)


def _dev_intervals_as_tuples(dev, perm, pid, nU):
    """Readback of the device instance as (candidate, univ, gs, ge)."""
    import jax.numpy as jnp  # noqa: F401

    scan_instance.ensure_assembled(dev)  # stage E is deferred by default
    gs = np.asarray(dev["ivl_start"])
    ge = np.asarray(dev["ivl_end"])
    pb = np.asarray(dev["pair_bounds"])
    sb = np.asarray(dev["set_bounds"])
    uop = np.asarray(dev["univ_of_pair"])
    out = []
    S = len(perm)
    for s_solver in range(S):
        for pr in range(sb[s_solver], sb[s_solver + 1]):
            for i in range(pb[pr], pb[pr + 1]):
                out.append((int(pid[perm[s_solver]]), int(uop[pr]),
                            int(gs[i]), int(ge[i])))
    return sorted(out)


def _host_intervals_as_tuples(inst):
    out = []
    for i in range(len(inst.ivl_start)):
        pr = inst.pair_of_ivl[i]
        out.append((int(inst.set_of_pair[pr]), int(inst.univ_of_pair[pr]),
                    int(inst.ivl_start[i]), int(inst.ivl_end[i])))
    return sorted(out)


@pytest.mark.parametrize("model_kw,ext", [
    (dict(mismatches=2, lcf_thres=60), 30),
    (dict(mismatches=0, lcf_thres=60), 0),
    (dict(mismatches=2, lcf_thres=80), 0),   # fast path (lcf >= plen)
    (dict(mismatches=1, lcf_thres=60, island_of_exact_match=25), 10),
])
def test_instance_parity(small_shapes, model_kw, ext):
    rng = np.random.default_rng(17)
    genomes = _corpus(rng, 6, 1500)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))
    searcher, pid, r, seq_info = _run_pipeline_direct(
        genomes, probes, model_kw, cover_extension=ext)
    assert r is not None
    dev, perm = r
    inst = _host_instance(searcher, pid, seq_info, genomes, ext,
                          np.ones(len(genomes)), None)
    # identical merged intervals, universe sizes, and coverage floors
    assert _dev_intervals_as_tuples(dev, perm, pid, len(genomes)) == \
        _host_intervals_as_tuples(inst)
    assert np.array_equal(
        np.asarray(dev["u_size"])[:len(genomes)], inst.u_size)
    assert np.array_equal(
        np.asarray(dev["can_uncover"])[:len(genomes)], inst.can_uncover)
    # identical pick sequence
    order_dev = set_cover.solve_boundary_instance(dev, len(perm))
    chosen_dev = pid[perm[order_dev]]
    chosen_host = set_cover.solve_instance(inst)
    assert np.array_equal(chosen_dev, np.asarray(chosen_host))


def test_instance_parity_multichrom_partial_coverage(small_shapes):
    rng = np.random.default_rng(5)
    genomes = _corpus(rng, 5, 2000, n_chrs=3)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))
    universe_p = np.array([0.5, 1.0, 0.8, 0.65, 1.0])
    searcher, pid, r, seq_info = _run_pipeline_direct(
        genomes, probes, dict(mismatches=2, lcf_thres=60),
        cover_extension=20, universe_p=universe_p)
    assert r is not None
    dev, perm = r
    inst = _host_instance(searcher, pid, seq_info, genomes, 20,
                          universe_p, None)
    assert _dev_intervals_as_tuples(dev, perm, pid, len(genomes)) == \
        _host_intervals_as_tuples(inst)
    order_dev = set_cover.solve_boundary_instance(dev, len(perm))
    assert np.array_equal(pid[perm[order_dev]],
                          np.asarray(set_cover.solve_instance(inst)))


def test_instance_parity_with_ranks(small_shapes):
    rng = np.random.default_rng(23)
    genomes = _corpus(rng, 4, 1200)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))
    ranks_raw = rng.integers(0, 3, size=len(probes)).astype(np.int64)
    rank_vals = np.unique(ranks_raw)
    rank_idx = np.searchsorted(rank_vals, ranks_raw).astype(np.int32)
    searcher, pid, r, seq_info = _run_pipeline_direct(
        genomes, probes, dict(mismatches=2, lcf_thres=60),
        cover_extension=0, rank_idx=rank_idx,
        n_rank_vals=len(rank_vals))
    assert r is not None
    dev, perm = r
    inst = _host_instance(searcher, pid, seq_info, genomes, 0,
                          np.ones(len(genomes)), ranks_raw)
    order_dev = set_cover.solve_boundary_instance(dev, len(perm))
    assert np.array_equal(pid[perm[order_dev]],
                          np.asarray(set_cover.solve_instance(inst)))


def test_filter_device_path_matches_host_path(small_shapes, monkeypatch):
    rng = np.random.default_rng(41)
    genomes = _corpus(rng, 8, 1800)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))

    monkeypatch.setenv("CATCH_TPU_INSTANCE", "host")
    f1 = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25)
    out_host = f1.filter([probes], [genomes], input_is_grouped=True)

    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    f2 = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25)
    out_dev = f2.filter([probes], [genomes], input_is_grouped=True)
    assert [p.seq_str for p in out_dev[0]] == \
        [p.seq_str for p in out_host[0]]
    # the forced run really took the device path
    assert f2.last_run_stats["set_cover_picks"] > 0


@pytest.mark.parametrize("n_devices", [2, 8])
def test_device_pipeline_sharded_over_mesh(small_shapes, monkeypatch,
                                           n_devices):
    """The device-resident instance pipeline shards stages A/B/C over
    the mesh (round-robin dispatch placement) and must produce the
    bit-identical probe set at any device count — the counterpart of
    the reference's num_processes-invariance contract
    (reference test_set_cover_filter.py:134-175)."""
    from catch_tpu.parallel import make_mesh

    rng = np.random.default_rng(77)
    genomes = _corpus(rng, 6, 2200)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))

    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    f1 = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25)
    out_single = f1.filter([probes], [genomes], input_is_grouped=True)
    assert f1.last_run_stats["set_cover_picks"] > 0

    mesh = make_mesh(n_devices)
    f2 = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=25,
                        mesh=mesh)
    out_mesh = f2.filter([probes], [genomes], input_is_grouped=True)
    assert f2.last_run_stats["set_cover_picks"] > 0, \
        "mesh run must take the device pipeline, not a fallback"
    assert [p.seq_str for p in out_mesh[0]] == \
        [p.seq_str for p in out_single[0]]


def test_merge_runs_group_longer_than_out_width():
    """Running-max propagation must span the full input, not the OUT
    compaction width: one long interval plus many short gapped ones in
    a single group is one merged run even when the group has far more
    rows than OUT (regression: the doubling loop was bounded by OUT,
    fragmenting long groups and inflating u_size)."""
    import jax.numpy as jnp

    n = 1 << 14
    out_w = 1 << 12          # < n: propagation must cross this width
    k = np.zeros(n, np.int32)
    s = np.zeros(n, np.int32)
    e = np.zeros(n, np.int32)
    s[0], e[0] = 0, 100000
    s[1:] = 3 * np.arange(1, n, dtype=np.int32)
    e[1:] = s[1:] + 1
    mk, ms, me, nr = scan_instance._merge_runs(
        jnp.asarray(k), jnp.asarray(s), jnp.asarray(e), out_w)
    assert int(nr) == 1
    assert (int(ms[0]), int(me[0])) == (0, 100000)


class TestPackedReadback:
    """The compact merged-instance readback (_pack_merged_jit +
    _unpack_merged) must reproduce the (key, start, end) rows exactly,
    including rows that escape the 16-bit delta/length fields."""

    def _roundtrip(self, k, s, e, b_pos, ecap=1 << 12):
        import jax.numpy as jnp
        n = len(k)
        N = scan_instance._next_pow2(max(n, 8))
        pad = N - n
        kd = jnp.asarray(np.concatenate(
            [k, np.full(pad, np.iinfo(np.int32).max)]).astype(np.int32))
        sd = jnp.asarray(np.concatenate([s, np.zeros(pad)]).astype(
            np.int32))
        ed = jnp.asarray(np.concatenate([e, np.zeros(pad)]).astype(
            np.int32))
        packed, ei, ek, ee, ne = scan_instance._pack_merged_jit(
            kd, sd, ed, jnp.int32(n), N=N, b_pos=b_pos, ECAP=ecap)
        dev = dict(packed=(packed, ei, ek, ee, ne, N, b_pos),
                   merged=(kd, sd, ed), n_merged=n)
        ko, so, eo = scan_instance._unpack_merged(dev)
        return ko, so, eo, int(ne)

    def test_small_rows_no_escapes(self):
        k = np.array([0, 0, 1, 1, 1, 5, 9])
        s = np.array([3, 40, 0, 10, 90, 7, 0])
        e = np.array([20, 55, 5, 60, 95, 30, 2])
        ko, so, eo, ne = self._roundtrip(k, s, e, b_pos=2)
        assert ne == 0
        assert ko.tolist() == k.tolist()
        assert so.tolist() == s.tolist()
        assert eo.tolist() == e.tolist()

    def test_key_delta_and_length_escapes(self):
        # Row 0's absolute key exceeds 16 bits (first-row delta IS the
        # key); row 2 jumps by > 2^16; row 3 has a > 2^16-long run.
        k = np.array([1 << 20, (1 << 20) + 3, (1 << 21) + 7,
                      (1 << 21) + 7, (1 << 21) + 8])
        s = np.array([5, 1, 2, 100, 0])
        e = np.array([9, 4, 10, 100 + (1 << 17), 3])
        ko, so, eo, ne = self._roundtrip(k, s, e, b_pos=4)
        assert ne == 3
        assert ko.tolist() == k.tolist()
        assert so.tolist() == s.tolist()
        assert eo.tolist() == e.tolist()

    def test_wide_positions_b3_b4(self):
        for b_pos, top in [(3, (1 << 24) - 10), (4, (1 << 30))]:
            k = np.array([2, 4, 4])
            s = np.array([top - 5, 1, top - 1])
            e = np.array([top - 1, 8, top])
            ko, so, eo, ne = self._roundtrip(k, s, e, b_pos=b_pos)
            assert so.tolist() == s.tolist()
            assert eo.tolist() == e.tolist()
            assert ko.tolist() == k.tolist()

    def test_escape_overflow_falls_back_to_unpacked(self, caplog):
        # Every row escapes with ECAP=2 -> decoder must use the
        # unpacked device buffers and still be exact.
        k = (np.arange(5) + 1) * (1 << 18)
        s = np.arange(5) * 10
        e = s + 4
        ko, so, eo, ne = self._roundtrip(k, s, e, b_pos=2, ecap=2)
        assert ne == 5
        assert ko.tolist() == k.tolist()
        assert so.tolist() == s.tolist()
        assert eo.tolist() == e.tolist()


def test_union_group_longer_than_union_cap():
    """_union_jit with per-universe group length >> OUT: the union of
    nested intervals under one universe collapses to one run."""
    import jax.numpy as jnp

    nU = 4
    n = 1 << 13
    out_w = 1 << 8
    # Pair keys all map to universe 1 (key % nU == 1); intervals are
    # one [0, 50000) plus gapped fragments.
    k = (np.arange(n, dtype=np.int32) * nU) + 1
    s = np.zeros(n, np.int32)
    e = np.zeros(n, np.int32)
    s[0], e[0] = 0, 50000
    s[1:] = 5 * np.arange(1, n, dtype=np.int32)
    e[1:] = s[1:] + 2
    uk, us, ue, nr = scan_instance._union_jit(
        jnp.asarray(k), jnp.asarray(s), jnp.asarray(e), jnp.int32(nU),
        OUT=out_w)
    assert int(nr) == 1
    assert (int(uk[0]), int(us[0]), int(ue[0])) == (1, 0, 50000)


def test_plan_grid_matches_exact_counts(small_shapes):
    """The per-block planning sums read back from stage A reconstruct
    the exact int64 hit prefix grid (lo/hi 16-bit halves recombined)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    genomes = _corpus(rng, 3, 1200)
    seqs = [s for g in genomes for s in g.seqs]
    probes = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(seqs, probe_length=80,
                                             probe_stride=40))
    model = CoverModel(mismatches=2, lcf_thres=60)
    searcher = ProbeSearcher(probes, model)
    kj, s = scan_instance._join_params_stride(searcher)
    L = searcher.Lmax
    row = L + kj
    P = len(searcher.probes)
    flat = np.zeros(P * row + kj - 1, dtype=np.uint8)
    flat[:P * row].reshape(P, row)[:, :L] = searcher.probe_codes
    TBL = scan_instance._next_pow2(P * row)
    tbl_h, _, _ = scan_instance._build_table_jit(
        jnp.asarray(flat), kj=kj, row=row, TBL=TBL)

    Q = scan_instance._SLAB_SAMPLES
    corpus = searcher.alphabet.encode(
        np.frombuffer("".join(seqs).encode(), dtype=np.uint8))
    mega = np.zeros(Q * s + kj + 8, dtype=np.uint8)
    mega[:len(corpus)] = corpus
    lo, cnt, bs_lo, bs_hi, _maxb = scan_instance._stage_a_jit(
        jnp.asarray(mega), jnp.int32(0), jnp.int32(len(corpus) - kj),
        tbl_h, kj=kj, s=s, Q=Q)
    block64 = (np.asarray(bs_lo).astype(np.int64)
               + (np.asarray(bs_hi).astype(np.int64) << 16))
    stride = min(scan_instance._PLAN_BLOCK, Q)
    exact = np.cumsum(np.asarray(cnt).astype(np.int64))
    assert np.array_equal(np.cumsum(block64), exact[stride - 1::stride])
    assert int(np.asarray(cnt).sum()) > 0


class TestOverflowAndRetryPaths:
    """The pipeline's buffer-escalation and guard branches, each forced
    by shrinking one static capacity and checked for exact parity with
    the host instance (the reference idiom of guard-rail tests,
    test_probe.py:792-941)."""

    def _parity(self, genomes, ext=10):
        seqs = [s for g in genomes for s in g.seqs]
        probes = DuplicateFilter()._filter(
            make_candidate_probes_from_sequences(seqs, probe_length=80,
                                                 probe_stride=40))
        searcher, pid, r, seq_info = _run_pipeline_direct(
            genomes, probes, dict(mismatches=2, lcf_thres=60),
            cover_extension=ext)
        assert r is not None
        dev, perm = r
        inst = _host_instance(searcher, pid, seq_info, genomes, ext,
                              np.ones(len(genomes)), None)
        assert _dev_intervals_as_tuples(dev, perm, pid, len(genomes)) \
            == _host_intervals_as_tuples(inst)
        assert np.array_equal(
            np.asarray(dev["u_size"])[:len(genomes)], inst.u_size)

    def test_stage_c_span_cap_escalation(self, small_shapes, monkeypatch):
        """A verify chunk emitting more spans than _SPAN_CAP re-runs
        wider and is merged alone (the fixed-width batch stacker skips
        it)."""
        monkeypatch.setattr(scan_instance, "_SPAN_CAP", 1 << 6)
        rng = np.random.default_rng(29)
        self._parity(_corpus(rng, 5, 1500))

    def test_lookup_bucket_overflow_full_bisection(self, small_shapes,
                                                   monkeypatch):
        """Hash buckets wider than the bounded bisection covers must
        trigger the exact full-searchsorted re-dispatch — output
        identical.  _LK_ROUNDS=0 makes every nonempty bucket
        overflow."""
        # rounds is a static jit argument read from this global at
        # call time, so the patch reaches the compiled kernel (0
        # rounds -> invalid ranges the escalation must overwrite)
        monkeypatch.setattr(scan_instance, "_LK_ROUNDS", 0)
        rng = np.random.default_rng(43)
        self._parity(_corpus(rng, 4, 1400))

    def test_window_slot_overflow_rerun(self, small_shapes,
                                        monkeypatch):
        """A row with more qualifying windows than the per-row slot
        cap (_TS_WINDOWS) must re-dispatch the full-width compaction
        variant — output identical."""
        monkeypatch.setattr(scan_instance, "_TS_WINDOWS", 1)
        rng = np.random.default_rng(41)
        self._parity(_corpus(rng, 5, 1500, mut=0.06))

    def test_union_cap_rerun(self, small_shapes, monkeypatch):
        """Per-universe union runs exceeding _UNION_CAP trigger the
        wider re-run readback."""
        monkeypatch.setattr(scan_instance, "_UNION_CAP", 1 << 3)
        rng = np.random.default_rng(31)
        # mismatchy corpus -> fragmented per-universe unions (> 8 runs)
        self._parity(_corpus(rng, 6, 1600, mut=0.10))

    def test_pair_key_overflow_guard_returns_none(self, small_shapes):
        """P * n_universes beyond int32 falls back to the host path
        (pair keys are probe * nU + universe in int32)."""
        rng = np.random.default_rng(7)
        genomes = _corpus(rng, 2, 600)
        seqs = [s for g in genomes for s in g.seqs]
        probes = DuplicateFilter()._filter(
            make_candidate_probes_from_sequences(seqs, probe_length=80,
                                                 probe_stride=40))
        from catch_tpu.ops.cover import CoverModel, ProbeSearcher
        searcher = ProbeSearcher(probes, CoverModel(2, 60))
        pid = np.arange(len(searcher.probes), dtype=np.int64)
        nU_huge = (np.iinfo(np.int32).max // len(searcher.probes)) + 1
        r = scan_instance.scan_to_boundary_instance(
            searcher, seqs, np.zeros(len(seqs), dtype=np.int64),
            np.zeros(len(seqs), dtype=np.int64),
            np.array([len(s) for s in seqs], dtype=np.int64),
            nU_huge, 0, np.ones(2),  # universe_p unused past the guard
            np.zeros(len(probes), np.int32), 1,
            np.ones(len(probes), np.float32), pid)
        assert r is None


def test_duplicate_candidates_last_wins(small_shapes, monkeypatch):
    """Duplicate candidate sequences map to the last candidate id, and
    tie-breaks order by candidate id (not searcher order)."""
    rng = np.random.default_rng(3)
    genomes = _corpus(rng, 4, 1000)
    seqs = [s for g in genomes for s in g.seqs]
    probes = make_candidate_probes_from_sequences(
        seqs, probe_length=80, probe_stride=40)  # with duplicates
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "host")
    f1 = SetCoverFilter(mismatches=2, lcf_thres=60)
    out_host = f1.filter([probes], [genomes], input_is_grouped=True)
    monkeypatch.setenv("CATCH_TPU_INSTANCE", "force")
    f2 = SetCoverFilter(mismatches=2, lcf_thres=60)
    out_dev = f2.filter([probes], [genomes], input_is_grouped=True)
    assert [p.seq_str for p in out_dev[0]] == \
        [p.seq_str for p in out_host[0]]
