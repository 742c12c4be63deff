"""Probe cover engine ("the forward pass") — host paths.

Replaces the reference's hash-map seeding + per-candidate anchored-LCS
scan (/root/reference/catch/probe.py:356-1271 and
/root/reference/catch/utils/longest_common_substring.py:59-158) with a
two-phase design.  This module holds the per-sequence host
implementation (the oracle for tiny workloads and custom models);
ops/scan_sparse batches phase 2 on device, and
ops/scan_instance runs the entire scan device-resident for the design
pipeline.

Phase 1 (seeding): an exact k-mer join of the sequence against a table
of probe k-mers (minimizer-sampled on the host path) yields candidate
(probe, alignment) pairs; a pair survives iff its overlap admits a
window of length thres' (necessary conditions for any qualifying
window).

Phase 2 (verification, vectorized): for each candidate alignment, build
the exact match vector and enumerate all *maximal* windows with
<= mismatches mismatches: with sentinel-padded sorted mismatch
positions P (P[0] = -1, P[nm+1] = ov), maximal windows are
(P[t], P[t+K+1]) exclusive.  A window qualifies iff its length is
>= thres' and it contains a run of >= max(k_seed, island) consecutive
matches (the run is simultaneously the shared-k-mer seed the reference
requires and the exact-match island).  Qualifying windows are emitted as
cover ranges and merged per probe.

Seeding semantics: the reference requires a shared k-mer drawn from a
k-mer->probe map that is either Monte-Carlo sampled (20 random k-mers
per probe) or pigeonholed at k-aligned offsets; both admit false
negatives or positional constraints.  Here the seed requirement is
*exhaustive*: any run of k_seed consecutive matches counts.  This is
deterministic and has recall >= either reference mode (it can only add
true covers; cf. SURVEY.md "Monte-Carlo random seeding mode").

Fast path: when lcf_thres >= probe length, island == 0, and either
mismatches == 0 or pigeonhole seeding guarantees an in-window seed,
phase 1 alone decides covers (threshold equals overlap, so
counts >= ov - mismatches makes the entire overlap the qualifying
window) and phase 2 is skipped.
"""

from collections import defaultdict
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from catch_tpu.ops import encode
from catch_tpu.utils import intervals

__all__ = [
    "CoverModel", "ProbeSearcher", "choose_seed_length",
    "probe_covers_sequence_by_longest_common_substring",
]

# Rolling-hash multiplier for k-mer seed codes (odd 64-bit; golden
# ratio).  Collisions only add phase-2 work, never wrong output.
_JOIN_MULT = np.uint64(0x9E3779B97F4A7C15)


class CoverModel:
    """Hybridization model parameters (the default LCS model).

    mismatches/lcf_thres/island_of_exact_match follow the reference
    contract (/root/reference/catch/probe.py:1274-1346).  custom_fn, if
    given, is a host callable with the reference's 6-argument signature;
    it replaces the default model and mismatches/lcf_thres are ignored.
    """

    def __init__(self, mismatches=None, lcf_thres=None,
                 island_of_exact_match=0, custom_fn=None):
        self.mismatches = mismatches
        self.lcf_thres = lcf_thres
        self.island_of_exact_match = island_of_exact_match
        self.custom_fn = custom_fn

    def __repr__(self):
        if self.custom_fn is not None:
            return f"CoverModel(custom={self.custom_fn})"
        return (f"CoverModel(m={self.mismatches}, lcf={self.lcf_thres}, "
                f"island={self.island_of_exact_match})")


def choose_seed_length(probe_lens, mismatches, lcf_thres, min_k=20, k=20):
    """Choose the seed (k-mer) length, mirroring the reference dispatcher.

    Returns (k_seed, mode) where mode is 'pigeonhole' or 'random'.
    Mirrors /root/reference/catch/probe.py:507-577 (including the
    decrement-until-divides pigeonhole k selection at :473-491).
    """
    lens = set(probe_lens)
    if not lens:
        return k, "random"
    L = next(iter(lens))
    if (mismatches is None or lcf_thres is None or len(lens) > 1
            or lcf_thres < L):
        return k, "random"
    if mismatches == 0:
        kp = L
    else:
        kp = int(L / mismatches)
        if kp == float(L) / mismatches:
            kp -= 1
        while L % kp != 0:
            kp -= 1
    if kp < min_k:
        return k, "random"
    return kp, "pigeonhole"


def probe_covers_sequence_by_longest_common_substring(
        mismatches, lcf_thres, island_of_exact_match=0):
    """Host closure with the reference cover-model contract.

    Provided for API parity and for oracle tests; the cover engine encodes
    the same model directly (see module docstring).
    """
    from catch_tpu.utils import lcs

    def lcf(probe_seq, sequence, kmer_start, kmer_end,
            full_probe_len, full_sequence_len):
        l, start = lcs.k_lcf_around_anchor(
            probe_seq, sequence, kmer_start, kmer_end, mismatches)
        if l < min(lcf_thres, full_probe_len, full_sequence_len):
            return None
        if island_of_exact_match > 0:
            if mismatches == 0:
                exact_l = l
            else:
                exact_l, _ = lcs.k_lcf_around_anchor(
                    probe_seq, sequence, kmer_start, kmer_end, 0)
            if exact_l < island_of_exact_match:
                return None
        return (start, start + l)

    return lcf


class ProbeSearcher:
    """Finds cover ranges of a fixed probe set in target sequences.

    The replacement for the reference's probe-finding pool
    protocol (open_probe_finding_pool / find_probe_covers_in_sequence /
    close_probe_finding_pool, /root/reference/catch/probe.py:782-1271):
    construct once per probe set, then query per sequence.  No pool
    lifecycle; probe tensors live on device for the searcher's lifetime.
    """

    def __init__(self, probes, model, kmer_probe_map_k=20, mesh=None):
        """
        Args:
            probes: list of catch_tpu.probe.Probe
            model: CoverModel
            kmer_probe_map_k: min_k and k for seed-length selection
                (reference SetCoverFilter's kmer_probe_map_k)
            mesh: optional jax.sharding.Mesh; when it has more than one
                device, the batched scan verifies candidates
                data-parallel across it (identical output)
        """
        self.model = model
        self.mesh = mesh
        # Lightweight run counters (candidate pairs admitted to
        # verification) for the north-star bench metrics.
        self.stats = {"candidates": 0}
        # Dedup by sequence, preserving first-occurrence order (the
        # reference's map keys by Probe which hashes by sequence).
        seen = {}
        for p in probes:
            if p.seq_str not in seen:
                seen[p.seq_str] = p
        self.probes = list(seen.values())
        self.probe_lens = np.array([len(p) for p in self.probes],
                                   dtype=np.int32)
        if len(self.probes) == 0:
            self.empty = True
            return
        self.empty = False

        m = None if model.custom_fn is not None else model.mismatches
        lcf = None if model.custom_fn is not None else model.lcf_thres
        self.k_seed, self.seed_mode = choose_seed_length(
            self.probe_lens.tolist(), m, lcf,
            min_k=kmer_probe_map_k, k=kmer_probe_map_k)
        if self.seed_mode == "random" and self.k_seed > self.probe_lens.min():
            raise ValueError("k is larger than the length of a probe")

        self.alphabet = encode.make_alphabet(
            [p.seq_bytes for p in self.probes])
        probe_codes = [self.alphabet.encode(p.seq_bytes)
                       for p in self.probes]
        self.Lmax = int(self.probe_lens.max())
        self.probe_codes = encode.pad_and_stack(probe_codes, self.Lmax)

        # Effective lcf threshold for device tiles (None -> unbounded)
        self.lcf_static = (int(lcf) if lcf is not None
                           else int(self.Lmax) + 1)
        self.K_static = int(m) if m is not None else None

        # Fast path validity (phase 1 alone decides covers); see module
        # docstring.  Checked per sequence against n.
        lens_equal = len(set(self.probe_lens.tolist())) == 1
        self.fast_ok = (
            model.custom_fn is None
            and model.island_of_exact_match == 0
            and lcf is not None and lens_equal and lcf >= self.Lmax
            and (self.seed_mode == "pigeonhole"
                 or (m is not None and m == 0)))


    # ------------------------------------------------------------------
    # Phase 1 driver
    # ------------------------------------------------------------------

    # Workloads below this many (alignment x probe) cells run phase 1
    # on the host (identical numpy math); tiny problems are dominated by
    # XLA compile/dispatch otherwise.
    _HOST_PHASE1_MAX_CELLS = 1 << 22

    def _candidates_host(self, seq_codes):
        """Host mirror of the phase-1 prefilter for tiny workloads."""
        n = len(seq_codes)
        L = self.Lmax
        padded = np.zeros(n + 2 * L, dtype=np.uint8)
        padded[L:L + n] = seq_codes
        # windows[a] = padded codes at alignment a-L+ ... build via
        # stride tricks: alignment a in [-(L-1), n-1]
        # Row r corresponds to alignment a = r - (L-1); window (r, j)
        # reads padded[L + a + j] = padded[r + j + 1]
        num_align = n + L - 1
        idx = (np.arange(num_align)[:, None] + np.arange(L)[None, :])
        win = padded[idx + 1]
        probes = self.probe_codes  # (P, L)
        match = (win[:, None, :] == probes[None, :, :]) & (win[:, None, :] > 0)
        counts = match.sum(axis=2, dtype=np.int32)  # (num_align, P)

        a = np.arange(num_align) - (L - 1)
        lens = self.probe_lens[None, :]
        ov = np.minimum(n, a[:, None] + lens) - np.maximum(0, a[:, None])
        ov = np.maximum(ov, 0)
        thres = np.minimum(np.minimum(self.lcf_static, lens), n)
        if self.K_static is None:
            need = np.full_like(counts, self.k_seed)
        else:
            need = np.maximum(thres - self.K_static, self.k_seed)
        cand = ((ov >= np.maximum(thres, self.k_seed)) & (counts >= need)
                & (lens > 0) & (thres > 0))
        w_idx, p_idx = np.nonzero(cand)
        return (p_idx.astype(np.int64),
                (w_idx - (L - 1)).astype(np.int64))

    # ------------------------------------------------------------------
    # Phase 1 via exact k-mer seed join (the scalable path)
    # ------------------------------------------------------------------
    #
    # Exhaustive seeding without an (alignment x probe) dense scan:
    # hash every k_seed-mer of every probe (all offsets) into one sorted
    # table, hash the sequence's k-mers, and join.  Any qualifying cover
    # must contain a run of >= k_seed consecutive matches (the engine's
    # seed requirement, see module docstring), i.e. an exact shared
    # k-mer, so the join finds every candidate pair phase 2 could
    # accept (plus pairs with no qualifying window, which it rejects).
    # The sparse phase-1 predicate (overlap + match count) is then
    # evaluated only on joined pairs.
    #
    # This replaces the reference's k-mer hash map
    # (/root/reference/catch/probe.py:356-577): deterministic and
    # exhaustive (recall >= the reference's Monte-Carlo sampling),
    # vectorized end to end, no shared-memory fork protocol.

    def _rolling_hashes(self, codes_2d, k=None):
        """Rolling k-mer hashes along the last axis (default k_seed).

        Returns (hashes, valid): hashes[..., i] covers codes[..., i:i+k];
        valid marks windows free of PAD (code 0).
        """
        k = self.k_seed if k is None else k
        W = codes_2d.shape[-1] - k + 1
        if W <= 0:
            shape = codes_2d.shape[:-1] + (0,)
            return (np.zeros(shape, np.uint64), np.zeros(shape, bool))
        c = codes_2d.astype(np.uint64)
        h = np.zeros(codes_2d.shape[:-1] + (W,), dtype=np.uint64)
        ok = np.ones(h.shape, dtype=bool)
        for j in range(k):
            cj = c[..., j:j + W]
            h *= _JOIN_MULT
            h += cj
            ok &= cj > 0
        return h, ok

    # ------------------------------------------------------------------
    # Minimizer seeding
    # ------------------------------------------------------------------
    #
    # Every qualifying cover carries a run of >= k_seed consecutive
    # exact matches: the verify phase requires seedmax >= k_seed
    # explicitly, and the fast path admits only full-overlap
    # candidates, where the pigeonhole k-selection (> K disjoint
    # k_seed-mers, <= K mismatches) guarantees an intact k_seed run.
    # A (w, kj)-minimizer scheme with kj + w - 1 <= k_seed therefore
    # preserves exhaustive seeding: any window of w consecutive
    # kj-mers lying fully inside the shared run selects the same
    # minimal-hash kj-mer on the probe and the sequence side (the
    # selection is content-determined; leftmost tie-break is
    # alignment-invariant within the run), so the join still finds
    # every qualifying pair while hashing only ~2/(w+1) of positions
    # on EACH side — a quadratic reduction in raw join hits, which is
    # what dominates the scan on conserved corpora (measured 300M raw
    # hits -> 483k candidate pairs on 50 Ebola genomes at w=1).

    _MINIMIZER_MIN_KJ = 12   # kj floor: 4^12 >> viral genome sizes
    _MINIMIZER_MAX_W = 20    # density floor 2/(w+1) ~ 10%

    def _join_params(self):
        """(kj, w) for the seed join; w == 1 disables minimizers."""
        k = self.k_seed
        if k <= self._MINIMIZER_MIN_KJ:
            return k, 1
        kj = max(self._MINIMIZER_MIN_KJ, k - self._MINIMIZER_MAX_W + 1)
        return kj, k - kj + 1

    @staticmethod
    def _minimizer_select(h, ok, w):
        """Union-of-window-minima positions for rows of hashes.

        h, ok: (..., W) hashes and validity.  Returns a boolean mask of
        selected positions (subset of ok).  Rows shorter than w select
        nothing — such rows cannot contain a complete window, and the
        caller's k_seed-run requirement already excludes them.
        """
        if w <= 1:
            return ok
        W = h.shape[-1]
        if W < w:
            return np.zeros_like(ok)
        x = np.where(ok, h, np.uint64(np.iinfo(np.uint64).max))
        sw = np.lib.stride_tricks.sliding_window_view(x, w, axis=-1)
        am = sw.argmin(axis=-1) + np.arange(W - w + 1)
        sel = np.zeros_like(ok)
        np.put_along_axis(sel.reshape(-1, W),
                          am.reshape(-1, W - w + 1), True, axis=-1)
        return sel & ok

    def _build_join_table(self):
        kj, w = self._join_params()
        h, ok = self._rolling_hashes(self.probe_codes, k=kj)
        sel = self._minimizer_select(h, ok, w)
        pi, pos = np.nonzero(sel)
        hv = h[pi, pos]
        order = np.argsort(hv, kind="stable")
        self._join_h = hv[order]
        self._join_p = pi[order].astype(np.int64)
        self._join_pos = pos[order].astype(np.int64)
        # Composite per-entry key term so the expansion needs a single
        # gather: pair key = (p << 34) + (seq_pos - probe_pos + Lmax - 1),
        # nonnegative since alignments reach back at most Lmax - 1.
        self._join_pkey = ((self._join_p << np.int64(34))
                           - self._join_pos + (self.Lmax - 1))

    def _join_pairs(self, codes):
        """Raw k-mer join of a 1-D code array against the probe table.

        Returns deduplicated candidate (probe_idx, alignment) int64
        arrays.  `codes` may be a single sequence or a PAD-separated
        concatenation of many (PAD windows never hash, and a gap of
        >= 1 PAD blocks cross-sequence k-mers); alignments are in the
        coordinates of `codes`.
        """
        if getattr(self, "_join_h", None) is None:
            self._build_join_table()
        kj, w = self._join_params()
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        h, ok = self._rolling_hashes(codes[None, :], k=kj)
        sel = self._minimizer_select(h, ok, w)
        pos_seq = np.flatnonzero(sel[0])
        if len(pos_seq) == 0 or len(self._join_h) == 0:
            return empty
        hs = h[0][pos_seq]
        lo = np.searchsorted(self._join_h, hs, side="left")
        hi = np.searchsorted(self._join_h, hs, side="right")
        cnt = hi - lo
        nz = cnt > 0
        lo, cnt, pos_seq = lo[nz], cnt[nz], pos_seq[nz]
        total = int(cnt.sum())
        if total == 0:
            return empty
        if len(codes) + self.Lmax >= (1 << 34):
            raise ValueError("corpus too large for the join key encoding")
        # Expand hits to (table index, seq position) with two cumsums
        # (no np.repeat / arange passes — the expansion is the join's
        # hottest loop at tens of millions of raw hits) and dedup on a
        # composite (probe, alignment) key built with a single gather:
        # key = (p << 34) + (seq_pos - probe_pos + Lmax - 1).
        csum = np.cumsum(cnt)
        step = np.ones(total, dtype=np.int64)
        step[0] = lo[0]
        step[csum[:-1]] = lo[1:] - lo[:-1] - cnt[:-1] + 1
        idx = np.cumsum(step)
        step[0] = pos_seq[0]
        step[1:] = 0
        step[csum[:-1]] = np.diff(pos_seq)
        pos_rep = np.cumsum(step)
        key = np.unique(self._join_pkey[idx] + pos_rep)
        p = key >> np.int64(34)
        a = (key & np.int64((1 << 34) - 1)) - (self.Lmax - 1)
        return p, a

    def _candidates_join(self, seq_codes):
        """Phase 1 by k-mer join; returns predicate-passing (p, a)."""
        n = len(seq_codes)
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        p, a = self._join_pairs(seq_codes)
        if len(p) == 0:
            return empty
        # Sparse phase-1 predicate
        lens = self.probe_lens[p].astype(np.int64)
        ov = np.minimum(n, a + lens) - np.maximum(0, a)
        thres = np.minimum(np.minimum(self.lcf_static, lens), n)
        keep = (ov >= np.maximum(thres, self.k_seed)) & (thres > 0)
        p, a = p[keep], a[keep]
        if len(p) == 0:
            return empty
        # The match-count predicate is only needed when phase 2 will be
        # skipped (the fast path takes candidates as covers verbatim);
        # otherwise _verify re-derives the full match vector anyway.
        fast = self.fast_ok and (
            n >= self.Lmax or (self.K_static == 0 and n >= self.k_seed))
        if self.K_static is not None and fast:
            counts = self._pair_match_counts(seq_codes, p, a)
            lens = self.probe_lens[p].astype(np.int64)
            thres = np.minimum(np.minimum(self.lcf_static, lens), n)
            keep = counts >= np.maximum(thres - self.K_static, self.k_seed)
            p, a = p[keep], a[keep]
        return p, a

    def _pair_match_counts(self, seq_codes, p, a, chunk=1 << 17):
        """Exact match counts over the overlap for candidate pairs."""
        n = len(seq_codes)
        L = self.Lmax
        out = np.empty(len(p), dtype=np.int64)
        j = np.arange(L)
        for c0 in range(0, len(p), chunk):
            sl = slice(c0, c0 + chunk)
            pc, ac = p[sl], a[sl]
            start = np.maximum(0, ac)
            lens = self.probe_lens[pc].astype(np.int64)
            ov = np.minimum(n, ac + lens) - start
            seq_idx = start[:, None] + j[None, :]
            seq_vals = np.where(seq_idx < n,
                                seq_codes[np.minimum(seq_idx, n - 1)], 0)
            probe_idx = (start - ac)[:, None] + j[None, :]
            probe_vals = np.take_along_axis(
                self.probe_codes[pc], np.minimum(probe_idx, L - 1), axis=1)
            valid = j[None, :] < ov[:, None]
            out[sl] = ((seq_vals == probe_vals) & (seq_vals > 0)
                       & valid).sum(axis=1)
        return out

    def _candidates_for_sequence(self, seq_codes):
        """Yield (probe_idx, alignment) candidate arrays for a sequence."""
        n = len(seq_codes)
        if (n + self.Lmax - 1) * len(self.probes) * self.Lmax \
                <= self._HOST_PHASE1_MAX_CELLS:
            return self._candidates_host(seq_codes)
        return self._candidates_join(seq_codes)

    # ------------------------------------------------------------------
    # Phase 2: host verification (vectorized numpy)
    # ------------------------------------------------------------------

    def _verify(self, seq_codes, cand_p, cand_a, chunk=1 << 17):
        """Verify candidates; emit qualifying (probe_idx, start, end) spans.

        Window math shared with catch_tpu.utils.lcs (see module
        docstring).  Candidates are processed in chunks to bound host
        memory (each chunk materializes O(chunk x Lmax) scratch).
        """
        C = len(cand_p)
        if C == 0:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int64))
        if C > chunk and self.model.custom_fn is None:
            parts = [self._verify(seq_codes, cand_p[c0:c0 + chunk],
                                  cand_a[c0:c0 + chunk])
                     for c0 in range(0, C, chunk)]
            return tuple(np.concatenate(x) for x in zip(*parts))
        n = len(seq_codes)
        L = self.Lmax
        K = self.K_static
        k_seed = self.k_seed
        island = self.model.island_of_exact_match
        seed_req = max(k_seed, island) if island > 0 else k_seed

        start = np.maximum(0, cand_a)
        lens = self.probe_lens[cand_p]
        end = np.minimum(n, cand_a + lens)
        ov = end - start
        thres = np.minimum(np.minimum(self.lcf_static, lens), n)

        j = np.arange(L)
        seq_idx = start[:, None] + j[None, :]
        seq_vals = np.where(seq_idx < n, seq_codes[np.minimum(seq_idx, n - 1)],
                            0)
        probe_idx = (start - cand_a)[:, None] + j[None, :]
        probe_vals = np.take_along_axis(
            self.probe_codes[cand_p], np.minimum(probe_idx, L - 1), axis=1)
        valid = j[None, :] < ov[:, None]
        match = (seq_vals == probe_vals) & (seq_vals > 0) & valid

        if self.model.custom_fn is not None:
            return self._verify_custom(seq_codes, cand_p, cand_a, start, ov,
                                       match, lens, n)

        # Sorted mismatch positions with sentinels: P[:,0] = -1, then
        # mismatch positions, then ov (as fill).  Mismatches are sparse
        # for real candidates (they share a seed), so scatter them into
        # place by within-row rank instead of sorting (O(total
        # mismatches) vs O(C L log L)).
        mask = valid & ~match
        nm = mask.sum(axis=1)
        C_here = len(cand_p)
        Kk = K
        P = np.empty((C_here, L + Kk + 2), dtype=np.int64)
        P[:] = ov[:, None]
        P[:, 0] = -1
        rows, cols = np.nonzero(mask)
        if len(rows):
            k_in_row = (np.arange(len(rows))
                        - np.searchsorted(rows, rows, side="left"))
            P[rows, 1 + k_in_row] = cols

        # Maximal windows t: (P[t], P[t+K+1]) exclusive, t in 0..nm
        t_cols = L + 1
        lenW = P[:, Kk + 1:Kk + 1 + t_cols] - P[:, :t_cols] - 1
        # Match runs r[i] = P[i+1] - P[i] - 1, i in 0..L+K
        runs = P[:, 1:] - P[:, :-1] - 1
        # Sliding max of runs over windows of size K+1
        seedmax = runs[:, :t_cols]
        for s in range(1, Kk + 1):
            seedmax = np.maximum(seedmax, runs[:, s:s + t_cols])
        t_idx = np.arange(t_cols)[None, :]
        qualify = ((t_idx <= nm[:, None]) & (lenW >= thres[:, None])
                   & (seedmax >= seed_req) & (thres[:, None] > 0))

        rows, ts = np.nonzero(qualify)
        span_start = P[rows, ts] + 1 + start[rows]
        span_end = P[rows, ts + Kk + 1] + start[rows]
        return cand_p[rows], span_start, span_end

    def _verify_custom(self, seq_codes, cand_p, cand_a, start, ov, match,
                       lens, n):
        """Slow escape hatch: call a user cover fn per candidate anchor.

        Mirrors the reference's per-(position, probe) invocation of
        dynamically-loaded models (/root/reference/catch/probe.py:1095-1098):
        for every maximal run of >= k_seed consecutive matches, the fn is
        called once per k-mer anchor position within the run.
        """
        fn = self.model.custom_fn
        k = self.k_seed
        out_p, out_s, out_e = [], [], []
        for c in range(len(cand_p)):
            p_i = int(cand_p[c])
            probe = self.probes[p_i]
            a = int(cand_a[c])
            st = int(start[c])
            o = int(ov[c])
            if o < k:
                continue
            probe_clip_start = st - a
            probe_seq = probe.seq_str[probe_clip_start:probe_clip_start + o]
            m = match[c, :o]
            # anchors: positions i where m[i:i+k] all True
            run_ok = np.convolve(m.astype(np.int64),
                                 np.ones(k, dtype=np.int64),
                                 mode="valid") == k
            anchor_positions = np.flatnonzero(run_ok)
            if len(anchor_positions) == 0:
                continue
            subseq = self._seq_str_cache[st:st + o]
            for i in anchor_positions:
                r = fn(probe_seq, subseq, int(i), int(i) + k,
                       int(lens[c]), n)
                if r is None:
                    continue
                out_p.append(p_i)
                out_s.append(r[0] + st)
                out_e.append(r[1] + st)
        return (np.array(out_p, dtype=np.int64),
                np.array(out_s, dtype=np.int64),
                np.array(out_e, dtype=np.int64))

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def _scan_one_sequence(self, sequence):
        """Per-sequence scan: flat (probe_idx, start, end) span arrays.

        Shared body of find_probe_covers and find_probe_covers_flat's
        per-sequence loop (single source of truth for the fast-path
        predicate and phase dispatch).
        """
        n = len(sequence)
        empty = tuple(np.empty(0, dtype=np.int64) for _ in range(3))
        if n < self.k_seed:
            return empty
        seq_bytes = encode.encode_bytes(sequence)
        seq_codes = self.alphabet.encode(seq_bytes)
        self._seq_str_cache = sequence  # for the custom-fn path

        cand_p, cand_a = self._candidates_for_sequence(seq_codes)
        self.stats["candidates"] += len(cand_p)

        fast = self.fast_ok and (
            n >= self.Lmax or (self.K_static == 0 and n >= self.k_seed))
        if fast:
            p_idx = cand_p
            span_start = np.maximum(0, cand_a)
            span_end = np.minimum(n, cand_a + self.probe_lens[cand_p])
        else:
            p_idx, span_start, span_end = self._verify(
                seq_codes, cand_p, cand_a)
        return p_idx, span_start, span_end

    def find_probe_covers(self, sequence, merge_overlapping=True):
        """Find cover ranges of every probe in `sequence`.

        Args:
            sequence: target sequence as a string
            merge_overlapping: merge overlapping ranges per probe (the
                reference's contract; False keeps distinct ranges for
                depth analysis)

        Returns:
            dict mapping Probe -> sorted list of (start, end) ranges
        """
        if self.empty:
            return {}
        p_idx, span_start, span_end = self._scan_one_sequence(sequence)
        return self._group_spans(p_idx, span_start, span_end,
                                 merge_overlapping)

    # Corpora with at least this many total bases route to the sparse
    # batched scan (corpus-wide k-mer join + device verify chunks,
    # ops/scan_sparse).  Below it, the per-sequence host path wins:
    # tiny workloads are dominated by device dispatch and the
    # verify-chunk compile.
    _BATCH_MIN_BP = 1 << 19

    def find_probe_covers_flat(self, sequences, force_batch=None):
        """Unmerged cover spans of every probe across many sequences.

        The corpus-scale path: large workloads run one corpus-wide
        k-mer join plus chunked device verification (ops/scan_sparse),
        small ones loop the per-sequence engine.  Returns flat int64
        arrays (probe_idx, seq_idx, start, end) in per-sequence local
        coordinates; spans are NOT merged (downstream consumers merge
        per (probe, universe), which commutes with cover extension).

        probe_idx indexes self.probes (the deduplicated probe list).
        """
        empty = tuple(np.empty(0, dtype=np.int64) for _ in range(4))
        if self.empty or not sequences:
            return empty
        total_bp = sum(len(s) for s in sequences)
        multi_dev = self.mesh is not None and self.mesh.devices.size > 1
        use_batch = (force_batch if force_batch is not None
                     else (total_bp >= self._BATCH_MIN_BP or multi_dev))
        if use_batch and self.model.custom_fn is not None:
            use_batch = False
        if use_batch:
            from catch_tpu.ops import scan_sparse
            r = scan_sparse.scan_corpus_sparse(self, sequences)
            if r is not None:
                return r
        out_p, out_i, out_s, out_e = [], [], [], []
        for i, sequence in enumerate(sequences):
            p_idx, s, e = self._scan_one_sequence(sequence)
            if len(p_idx):
                out_p.append(p_idx)
                out_i.append(np.full(len(p_idx), i, dtype=np.int64))
                out_s.append(s)
                out_e.append(e)
        if not out_p:
            return empty
        return (np.concatenate(out_p), np.concatenate(out_i),
                np.concatenate(out_s), np.concatenate(out_e))

    def _group_spans(self, p_idx, span_start, span_end, merge_overlapping):
        if len(p_idx) == 0:
            return {}
        order = np.lexsort((span_end, span_start, p_idx))
        p_idx = p_idx[order]
        s = span_start[order]
        e = span_end[order]
        out = {}
        boundaries = np.flatnonzero(np.diff(p_idx)) + 1
        groups = np.split(np.arange(len(p_idx)), boundaries)
        for g in groups:
            pi = int(p_idx[g[0]])
            spans = list(zip(s[g].tolist(), e[g].tolist()))
            if merge_overlapping:
                spans = intervals.merge_overlapping(spans)
            else:
                spans = sorted(set(spans))
            out[self.probes[pi]] = spans
        return out
