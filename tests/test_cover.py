"""Tests for the cover engine (catch_tpu.ops.cover).

Includes a brute-force oracle implementing the engine's declared
semantics (all maximal <=m-mismatch windows containing a k_seed match
run and meeting the length threshold), plus reference-style planted
probe recall tests (modeled on the reference's randomized engine tests,
/root/reference/catch/tests/test_probe.py:792-941).
"""

import unittest

import numpy as np
import pytest

from catch_tpu.probe import Probe
from catch_tpu.ops import cover
from catch_tpu.utils import intervals


def oracle_covers(probes, sequence, mismatches, lcf_thres, k_seed,
                  island=0, merge=True):
    """Brute-force implementation of the engine's cover semantics."""
    n = len(sequence)
    out = {}
    if n < k_seed:
        return out
    for p in probes:
        if p in out:
            continue
        lp = len(p)
        thres = min(lcf_thres, lp, n)
        spans = []
        for a in range(-(lp - 1), n):
            start = max(0, a)
            end = min(n, a + lp)
            ov = end - start
            if ov < max(thres, k_seed) or thres <= 0:
                continue
            match = [sequence[start + j] == p.seq_str[start - a + j]
                     for j in range(ov)]
            # All maximal windows with <= mismatches mismatches
            mism = [j for j in range(ov) if not match[j]]
            P = [-1] + mism + [ov] * (mismatches + 1)
            nm = len(mism)
            for t in range(nm + 1):
                lo = P[t] + 1
                hi = P[t + mismatches + 1]
                if hi - lo < thres:
                    continue
                # longest run of matches within the window
                best_run = run = 0
                for j in range(lo, hi):
                    if match[j]:
                        run += 1
                        best_run = max(best_run, run)
                    else:
                        run = 0
                req = max(k_seed, island) if island > 0 else k_seed
                if best_run < req:
                    continue
                spans.append((lo + start, hi + start))
        if spans:
            if merge:
                out[p] = intervals.merge_overlapping(spans)
            else:
                out[p] = sorted(set(spans))
    return out


def run_engine(probes, sequence, mismatches, lcf_thres, island=0,
               kmer_k=3, merge=True):
    model = cover.CoverModel(mismatches=mismatches, lcf_thres=lcf_thres,
                             island_of_exact_match=island)
    searcher = cover.ProbeSearcher(probes, model, kmer_probe_map_k=kmer_k)
    return searcher.find_probe_covers(sequence, merge_overlapping=merge), \
        searcher


class TestExactMatch:
    def test_exact_single_probe(self):
        seq = "ABCDEFGHIJKLMNOP"
        p = Probe.from_str("DEFGHI")
        got, s = run_engine([p], seq, 0, 6)
        assert s.seed_mode == "pigeonhole"
        assert got == {p: [(3, 9)]}

    def test_no_match(self):
        seq = "ABCDEFGHIJKLMNOP"
        p = Probe.from_str("XYZQRS")
        got, _ = run_engine([p], seq, 0, 6)
        assert got == {}

    def test_repeated_match_merged(self):
        seq = "ABCABCABC"
        p = Probe.from_str("ABC")
        got, _ = run_engine([p], seq, 0, 3)
        assert got == {p: [(0, 9)]}

    def test_multiple_probes(self):
        seq = "ABCDEFGHIJKLMNOP"
        p1 = Probe.from_str("ABCDEF")
        p2 = Probe.from_str("KLMNOP")
        p3 = Probe.from_str("ZZZZZZ")
        got, _ = run_engine([p1, p2, p3], seq, 0, 6)
        assert got == {p1: [(0, 6)], p2: [(10, 16)]}

    def test_sequence_shorter_than_seed(self):
        got, _ = run_engine([Probe.from_str("ABCDEF")], "AB", 0, 6)
        assert got == {}


class TestMismatches:
    def test_one_mismatch_full_lcf(self):
        seq = "ABCDEFGHIJKLMNOP"
        p = Probe.from_str("DEXGHI")  # 1 mismatch vs DEFGHI
        got0, _ = run_engine([p], seq, 0, 6, kmer_k=2)
        assert got0 == {}
        got1, _ = run_engine([p], seq, 1, 6, kmer_k=2)
        assert got1 == {p: [(3, 9)]}

    def test_lcf_thres_below_probe_len(self):
        seq = "ABCDEFGHIJKLMNOP"
        # last 4 chars match GHIJ; first two mismatch
        p = Probe.from_str("XYGHIJ")
        got, s = run_engine([p], seq, 0, 4, kmer_k=3)
        assert s.seed_mode == "random"
        assert got == {p: [(6, 10)]}

    def test_island_of_exact_match(self):
        seq = "ABCDEFGHIJKLMNOP"
        p = Probe.from_str("DXFGHI")  # mismatch at 2nd char; runs: 1, 4
        got, _ = run_engine([p], seq, 1, 6, island=0, kmer_k=1)
        assert got == {p: [(3, 9)]}
        got4, _ = run_engine([p], seq, 1, 6, island=4, kmer_k=1)
        assert got4 == {p: [(3, 9)]}
        got5, _ = run_engine([p], seq, 1, 6, island=5, kmer_k=1)
        assert got5 == {}


class TestClipping:
    def test_probe_hangs_off_left(self):
        # Probe tail matches sequence head; requires lcf < probe len
        seq = "DEFGHIJKLMNOP"
        p = Probe.from_str("XYZDEF")
        got, _ = run_engine([p], seq, 0, 3, kmer_k=3)
        assert p in got
        assert (0, 3) in got[p]

    def test_probe_hangs_off_right(self):
        seq = "ABCDEFGHI"
        p = Probe.from_str("GHIXYZ")
        got, _ = run_engine([p], seq, 0, 3, kmer_k=3)
        assert p in got
        assert (6, 9) in got[p]

    def test_sequence_shorter_than_seed(self):
        # Pigeonhole mode with m=0 yields k_seed = probe length; a
        # sequence shorter than the seed cannot be covered (reference
        # parity: /root/reference/catch/probe.py:1204-1212)
        seq = "CDEF"
        p = Probe.from_str("ABCDEFGH")
        got, _ = run_engine([p], seq, 0, 8, kmer_k=3)
        assert got == {}

    def test_sequence_shorter_than_probe(self):
        # With lcf < probe length (random seed mode, small k), thres'
        # becomes len(sequence) and the fully-overlapping alignment wins
        seq = "CDEF"
        p = Probe.from_str("ABCDEFGH")
        got, _ = run_engine([p], seq, 0, 4, kmer_k=3)
        assert got == {p: [(0, 4)]}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("m,lcf,k", [(0, 6, 3), (1, 6, 3), (2, 5, 2),
                                     (1, 4, 2)])
def test_random_vs_oracle(seed, m, lcf, k):
    rng = np.random.RandomState(seed * 100 + m * 10 + lcf)
    alpha = list("ACGT")
    seq = "".join(rng.choice(alpha, 60))
    probes = []
    for _ in range(8):
        if rng.rand() < 0.5:
            # random probe
            probes.append(Probe.from_str("".join(rng.choice(alpha, 6))))
        else:
            # planted probe with mutations
            s = rng.randint(0, 54)
            chars = list(seq[s:s + 6])
            for _ in range(rng.randint(0, m + 1)):
                i = rng.randint(0, 6)
                chars[i] = alpha[(alpha.index(chars[i]) + 1) % 4]
            probes.append(Probe.from_str("".join(chars)))
    got, _ = run_engine(probes, seq, m, lcf, kmer_k=k)
    want = oracle_covers(probes, seq, m, lcf, k)
    assert got == want


@pytest.mark.parametrize("seed", range(3))
def test_planted_probe_recall(seed):
    """Plant real probes into a random genome; all must be recovered.

    Unlike the reference's Monte-Carlo engine (95% recall asserted,
    /root/reference/catch/tests/test_probe.py:910-914), exhaustive
    seeding guarantees 100% recall of planted covers.
    """
    rng = np.random.RandomState(seed)
    alpha = list("ACGT")
    n = 5000
    seq = rng.choice(alpha, n)
    L, m = 50, 2
    planted = []
    for i in range(20):
        pos = rng.randint(0, n - L)
        chars = list(seq[pos:pos + L])
        for _ in range(rng.randint(0, m + 1)):
            j = rng.randint(0, L)
            chars[j] = alpha[(alpha.index(chars[j]) + 1) % 4]
        planted.append((Probe.from_str("".join(chars)), pos))
    seq = "".join(seq)
    probes = [p for p, _ in planted]
    model = cover.CoverModel(mismatches=m, lcf_thres=L)
    searcher = cover.ProbeSearcher(probes, model, kmer_probe_map_k=10)
    got = searcher.find_probe_covers(seq)
    for p, pos in planted:
        assert p in got, f"planted probe at {pos} not found"
        covered = any(s <= pos and e >= pos + L for s, e in got[p])
        assert covered, (pos, got[p])


def test_duplicate_probes_share_entry():
    seq = "ABCDEFGHIJKL"
    p1 = Probe.from_str("ABCDEF")
    p2 = Probe.from_str("ABCDEF")
    got, _ = run_engine([p1, p2], seq, 0, 6)
    assert len(got) == 1
    assert got[p1] == [(0, 6)]


def test_custom_cover_fn():
    # Covers iff the probe's clipped seq equals subsequence exactly and
    # returns a fixed-size range
    def fn(probe_seq, sequence, kmer_start, kmer_end, full_probe_len,
           full_seq_len):
        if probe_seq == sequence:
            return (0, len(sequence))
        return None

    seq = "ABCDEFGHIJKL"
    p = Probe.from_str("CDEFGH")
    model = cover.CoverModel(custom_fn=fn)
    searcher = cover.ProbeSearcher([p], model, kmer_probe_map_k=3)
    got = searcher.find_probe_covers(seq)
    assert got == {p: [(2, 8)]}


def test_merge_overlapping_false_keeps_distinct():
    seq = "ABCDABCDABCD"
    p = Probe.from_str("ABCD")
    got, _ = run_engine([p], seq, 0, 4, kmer_k=4, merge=False)
    assert got == {p: [(0, 4), (4, 8), (8, 12)]}


class TestBatchedCorpusScan(unittest.TestCase):
    """The one-dispatch megakernel (ops/scan_batch) must emit exactly
    the per-sequence engine's spans, merged per (probe, sequence)."""

    def _corpus(self, seed, n_seqs=6, lo=150, hi=900):
        rng = np.random.RandomState(seed)
        base = "".join(rng.choice(list("ACGT"), size=hi))
        seqs = []
        for i in range(n_seqs):
            n = int(rng.randint(lo, hi))
            # mutate a copy of a shared base so probes recur across seqs
            s = list(base[:n])
            for _ in range(n // 40):
                s[rng.randint(n)] = rng.choice(list("ACGT"))
            seqs.append("".join(s))
        return seqs

    def _assert_parity(self, model, probe_length=60, stride=25, seed=0):
        from catch_tpu.filters.candidates import (
            make_candidate_probes_from_sequences)
        from catch_tpu.filters.duplicate import DuplicateFilter
        seqs = self._corpus(seed)
        cands = make_candidate_probes_from_sequences(
            seqs, probe_length=probe_length, probe_stride=stride)
        probes = DuplicateFilter().filter(cands)
        searcher = cover.ProbeSearcher(probes, model)

        def merged(flat):
            p, i, s, e = flat
            out = {}
            for k in range(len(p)):
                out.setdefault((int(p[k]), int(i[k])), []).append(
                    (int(s[k]), int(e[k])))
            return {k: intervals.merge_overlapping(v)
                    for k, v in out.items()}

        got = merged(searcher.find_probe_covers_flat(seqs, force_batch=True))
        want = merged(searcher.find_probe_covers_flat(seqs,
                                                      force_batch=False))
        self.assertEqual(got, want)
        self.assertGreater(len(want), 0)

    def test_parity_mismatch_model(self):
        self._assert_parity(cover.CoverModel(mismatches=2, lcf_thres=40),
                            seed=1)

    def test_parity_fast_path(self):
        m = cover.CoverModel(mismatches=2, lcf_thres=60)
        self._assert_parity(m, probe_length=60, seed=2)

    def test_parity_exact(self):
        self._assert_parity(cover.CoverModel(mismatches=0, lcf_thres=30),
                            seed=3)

    def test_parity_island(self):
        self._assert_parity(
            cover.CoverModel(mismatches=2, lcf_thres=40,
                             island_of_exact_match=25), seed=4)

    def test_parity_short_and_empty_sequences(self):
        from catch_tpu.filters.candidates import (
            make_candidate_probes_from_sequences)
        seqs = self._corpus(5) + ["ACGT", ""]  # below k_seed
        cands = make_candidate_probes_from_sequences(
            seqs[:6], probe_length=60, probe_stride=25)
        searcher = cover.ProbeSearcher(
            cands, cover.CoverModel(mismatches=1, lcf_thres=40))
        a = searcher.find_probe_covers_flat(seqs, force_batch=True)
        b = searcher.find_probe_covers_flat(seqs, force_batch=False)
        key = lambda f: sorted(zip(*(x.tolist() for x in f)))
        self.assertEqual(key(a), key(b))


class TestJoinSlabbing(unittest.TestCase):
    """Device-join expansion and slab boundaries preserve the exact
    candidate set (scan_sparse._join_corpus vs the host mirror)."""

    def _mega(self, n_genomes=12):
        import gzip
        from catch_tpu.utils import seq_io
        from catch_tpu.filters.candidates import (
            make_candidate_probes_from_sequences)
        from catch_tpu.ops import encode
        genomes = seq_io.read_genomes_from_fasta(
            "tests/data/zaire_ebolavirus.fasta.gz")[:n_genomes]
        cands = []
        for g in genomes:
            cands.extend(make_candidate_probes_from_sequences(
                g.seqs, probe_length=100, probe_stride=50))
        probes = list({p.seq_str: p for p in cands}.values())
        searcher = cover.ProbeSearcher(
            probes, cover.CoverModel(mismatches=2, lcf_thres=60))
        seqs = [s for g in genomes for s in g.seqs]
        L = searcher.Lmax
        pos = L
        starts = []
        for s in seqs:
            starts.append(pos)
            pos += len(s) + L
        mega = np.zeros(pos + L, dtype=np.uint8)
        for st, s in zip(starts, seqs):
            mega[st:st + len(s)] = searcher.alphabet.encode(
                encode.encode_bytes(s))
        return searcher, mega[:pos]

    def _pairs(self, r):
        return set(zip(r[0].tolist(), r[1].tolist()))

    def test_device_join_matches_host_and_slabs(self):
        import os
        from catch_tpu.ops import scan_sparse
        searcher, mega = self._mega()
        os.environ["CATCH_TPU_JOIN"] = "host"
        try:
            want = self._pairs(scan_sparse._join_corpus(searcher, mega))
        finally:
            del os.environ["CATCH_TPU_JOIN"]
        self.assertGreater(len(want), 1000)
        got = self._pairs(scan_sparse._join_corpus(searcher, mega))
        self.assertEqual(got, want)
        # Tiny expansion slabs exercise cross-slab dedup
        save = scan_sparse._EXPAND_SLAB
        scan_sparse._EXPAND_SLAB = 1 << 14
        try:
            got = self._pairs(scan_sparse._join_corpus(searcher, mega))
        finally:
            scan_sparse._EXPAND_SLAB = save
        self.assertEqual(got, want)
        # Tiny hash slabs exercise minimizer-window ownership at edges
        save = scan_sparse._JOIN_SLAB
        scan_sparse._JOIN_SLAB = 1 << 15
        try:
            got = self._pairs(scan_sparse._join_corpus(searcher, mega))
        finally:
            scan_sparse._JOIN_SLAB = save
        self.assertEqual(got, want)


class TestPlantedProbesAtScale(unittest.TestCase):
    """Planted-probe recall at the reference's test scales (25 kb to
    1.6 Mb genomes, /root/reference/catch/tests/test_probe.py:792-941),
    run through BOTH the per-sequence and batched device paths.

    Exhaustive seeding guarantees 100% recall (the reference asserts
    only >= 95% for its Monte-Carlo k-mer map) and zero spurious
    probes; cover positions carry the reference's tolerance for chance
    extension (-7 .. +15 around the planted site).
    """

    def _run(self, seed, n, n_probes, L=100, m=2, lcf=85):
        rng = np.random.RandomState(seed)
        alpha = np.array(list("ACGT"))
        seq_arr = rng.choice(alpha, n)
        planted = []
        taken = set()
        for _ in range(n_probes):
            while True:
                pos = rng.randint(0, n - L)
                if all(abs(pos - t) >= L for t in taken):
                    break
            taken.add(pos)
            chars = list(seq_arr[pos:pos + L])
            for _ in range(rng.randint(0, m + 1)):
                j = rng.randint(0, L)
                chars[j] = alpha[(list(alpha).index(chars[j]) + 1) % 4]
            planted.append((Probe.from_str("".join(chars)), pos))
        # Decoys: random probes that should match nowhere
        decoys = [Probe.from_str("".join(rng.choice(alpha, L)))
                  for _ in range(n_probes // 4)]
        seq = "".join(seq_arr)
        probes = [p for p, _ in planted] + decoys
        model = cover.CoverModel(mismatches=m, lcf_thres=lcf)
        searcher = cover.ProbeSearcher(probes, model)

        for force_batch in (False, True):
            r = searcher.find_probe_covers_flat([seq],
                                                force_batch=force_batch)
            got = {}
            for pi, si, s, e in zip(*r):
                got.setdefault(int(pi), []).append((int(s), int(e)))
            for i, (p, pos) in enumerate(planted):
                self.assertIn(i, got, f"planted probe at {pos} missed "
                                      f"(force_batch={force_batch})")
                ok = any(pos - 7 <= s <= pos and
                         pos + L <= e <= pos + L + 15
                         for s, e in got[i])
                self.assertTrue(ok, (pos, got[i], force_batch))
            n_planted_found = sum(1 for i in got if i < len(planted))
            self.assertEqual(n_planted_found, len(planted))
            # A decoy landing a >= 85-long <=2-mismatch window in a
            # random 4-letter genome is cryptographically unlikely
            for i in got:
                self.assertLess(i, len(planted),
                                f"spurious decoy cover: {got[i]}")

    def test_25kb(self):
        self._run(seed=10, n=25_000, n_probes=40)

    def test_250kb(self):
        self._run(seed=11, n=250_000, n_probes=120)

    def test_1600kb(self):
        self._run(seed=12, n=1_600_000, n_probes=45)


class TestJoinSlabBoundary:
    """Slabbing the corpus-wide join must not lose candidate pairs at
    slab boundaries (a selected position in the overlap whose only
    selecting window starts in the previous slab is owned by no later
    slab)."""

    def test_slabbed_join_equals_unslabbed(self, monkeypatch):
        import numpy as np
        from catch_tpu.ops import scan_sparse
        from catch_tpu.ops.cover import CoverModel, ProbeSearcher
        from catch_tpu.filters.candidates import (
            make_candidate_probes_from_sequences)

        rng = np.random.default_rng(99)
        bases = np.array(list("ACGT"))
        seqs = ["".join(rng.choice(bases, size=3000)) for _ in range(4)]
        # probes tiled from the sequences so every position joins
        probes = make_candidate_probes_from_sequences(
            seqs, probe_length=100, probe_stride=50)
        searcher = ProbeSearcher(
            probes, CoverModel(mismatches=2, lcf_thres=60))

        def spans(slab):
            monkeypatch.setattr(scan_sparse, "_JOIN_SLAB", slab)
            s = ProbeSearcher(
                probes, CoverModel(mismatches=2, lcf_thres=60))
            r = scan_sparse.scan_corpus_sparse(s, seqs)
            return sorted(zip(*(x.tolist() for x in r)))

        unslabbed = spans(1 << 30)
        # tiny slabs force many boundaries through every sequence
        slabbed = spans(997)
        assert slabbed == unslabbed
        assert len(unslabbed) > 0
