"""Clustering input sequences by MinHash similarity (Mash-style).

Capability parity with the reference
(/root/reference/catch/utils/cluster.py:28-431): MinHash signatures with
one shared hash function, Mash-distance -> Jaccard-distance conversion,
average-linkage hierarchical clustering (scipy) and 'simple' connected
components with an early-stop heuristic; the
``cluster_with_minhash_signatures`` facade.

Device design: the reference fills a condensed distance matrix with
a fork-based process pool (cluster.py:107-194) and parallelizes the DFS
neighborhood scans the same way (:274-331).  Here all pairwise distances
are computed on device: signatures live as an (n, N) int32 matrix, and
one jitted vmapped kernel evaluates a full row of capped-union MinHash
collision counts at once (exactly the reference's sorted-merge
estimator, lsh.py:166-215, vectorized).  The DFS / linkage logic stays
on host.
"""

from collections import defaultdict
import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp

from catch_tpu.utils import lsh

logger = logging.getLogger(__name__)

__all__ = ["make_signatures_with_minhash", "cluster_with_minhash_signatures",
           "find_connected_components",
           "cluster_hierarchically_from_dist_matrix",
           "cluster_greedy_from_signatures"]


def make_signatures_with_minhash(family, seqs):
    """Signature per sequence using one shared MinHash function.

    Args:
        family: lsh.MinHashFamily
        seqs: dict mapping sequence header to sequence

    Returns:
        dict mapping header to signature tuple
    """
    h = family.make_h()
    return {name: h(seq) for name, seq in seqs.items()}


def _jaccard_dist_from_mash_dist(mash_dist, k):
    """Mash distance (≈1-ANI) -> Jaccard distance
    (reference cluster.py:47-67, from Eq. 4 of Ondov et al. 2016)."""
    return 1.0 - 1.0 / (2.0 * np.exp(k * mash_dist) - 1)


def _pair_dists(A, sigs, N):
    """Jaccard distances of signature A against every row of sigs.

    Implements the reference's sorted-merge estimator with the
    union-rank cap at N: a shared hash value v (present in both
    signatures) is counted iff its union rank (#A<v + #B<v - #shared<v
    + 1) is <= N.  With both signatures of length N the union scan
    always consumes exactly N values, so the denominator is N.
    """
    def pair(B):
        idx = jnp.searchsorted(A, B)
        is_match = (idx < N) & (A[jnp.minimum(idx, N - 1)] == B)
        cA = idx
        cB = jnp.arange(N)
        cM_excl = jnp.cumsum(is_match) - is_match
        capped = is_match & (cA + cB - cM_excl + 1 <= N)
        return 1.0 - jnp.sum(capped) / N

    return jax.vmap(pair)(sigs)


@functools.partial(jax.jit, static_argnames=("N",))
def _row_dists_kernel(sigs, j, *, N):
    """Distances of signature j against all signatures."""
    return _pair_dists(sigs[j], sigs, N)


@functools.partial(jax.jit, static_argnames=("N", "B"))
def _block_dists_kernel(sigs, j0, *, N, B):
    """Distances of signatures [j0, j0+B) against all signatures —
    the all-pairs matrix is computed in B-row blocks so the host pays
    ~n/B device roundtrips instead of one per explored row.

    The estimator is evaluated as a lax.scan over the N signature
    columns with broadcast compare-reduces per step, in place of the
    per-pair searchsorted of _pair_dists (a gather per element).  Per
    column j of a signature Bsig, the union rank of Bsig[j] is
    #A<v + j - #shared before j + 1; the value counts iff shared and
    rank <= N — exactly the sorted-merge walk of _pair_dists.
    """
    n = sigs.shape[0]
    blk = jax.lax.dynamic_slice(sigs, (j0, 0), (B, N))
    A = blk[:, None, :]                      # (B, 1, N)

    def step(carry, col):
        cm, cap, j = carry
        Bj = col[None, :, None]              # (1, n, 1)
        lt = jnp.sum(A < Bj, axis=-1, dtype=jnp.int32)   # (B, n)
        eq = jnp.any(A == Bj, axis=-1)                   # (B, n)
        ok = eq & (lt + j - cm + 1 <= N)
        return (cm + eq.astype(jnp.int32),
                cap + ok.astype(jnp.int32), j + 1), None

    init = (jnp.zeros((B, n), jnp.int32), jnp.zeros((B, n), jnp.int32),
            jnp.int32(0))
    (cm, cap, _), _ = jax.lax.scan(step, init, sigs.T)
    return 1.0 - cap.astype(jnp.float32) / N


@functools.partial(jax.jit, static_argnames=("N", "B"))
def _block_codes_kernel(sigs, j0, cap_thr, cap_early, *, N, B):
    """Thresholded adjacency codes for rows [j0, j0+B): 0 = farther
    than the clustering threshold, 1 = within it but beyond the
    early-stop threshold (explored by the DFS), 2 = within BOTH
    (absorbed without exploration).  The DFS nests its early-stop test
    inside the threshold test, so code 2 requires both conditions —
    when the clustering threshold is below the early-stop threshold, a
    pair within early but beyond the threshold must code 0, not 1.
    Thresholds arrive as minimum capped-intersection counts (exact
    integer comparisons — no float32/64 boundary mismatches against
    the row kernel's float distances), so the readback is n^2 bytes
    instead of 4*n^2.
    """
    d = _block_dists_kernel(sigs, j0, N=N, B=B)
    cap = jnp.round((1.0 - d) * N).astype(jnp.int32)
    wt = cap >= cap_thr
    we = cap >= cap_early
    return wt.astype(jnp.uint8) + (wt & we).astype(jnp.uint8)


def _min_cap(N, thr):
    """Smallest capped-intersection count whose float32 distance
    1 - cap/N is <= thr under the row kernel's float comparison —
    keeps the integer-coded path bit-consistent with it."""
    d32 = (np.float32(1.0)
           - np.arange(N + 1, dtype=np.float32) / np.float32(N))
    ok = np.flatnonzero(d32.astype(np.float64) <= thr)
    return int(ok[0]) if len(ok) else N + 1


class _DeviceDistances:
    """Device-resident signature matrix with batched distances."""

    _BLOCK = 256

    def __init__(self, signatures):
        self.n = len(signatures)
        self.N = len(signatures[0]) if self.n else 0
        mat = np.asarray(signatures, dtype=np.int64)
        # Hash values are < 2^31 - 1; int32 is exact
        self.sigs = jnp.asarray(mat.astype(np.int32))
        self._pad = None

    def row(self, j):
        """Distances of signature j to all signatures (np.float32[n])."""
        return np.asarray(_row_dists_kernel(self.sigs, jnp.int32(j),
                                            N=self.N))

    def _padded(self):
        B = min(self._BLOCK, max(1, self.n))
        if self._pad is None:
            n_pad = -(-self.n // B) * B
            if n_pad != self.n:
                pad = jnp.tile(self.sigs[:1], (n_pad - self.n, 1))
                self._pad = jnp.concatenate([self.sigs, pad])
            else:
                self._pad = self.sigs
        return self._pad, B

    def full_matrix(self):
        """The full (n, n) distance matrix, computed in row blocks."""
        sigs_pad, B = self._padded()
        n_pad = sigs_pad.shape[0]
        out = np.empty((n_pad, n_pad), dtype=np.float32)
        for j0 in range(0, n_pad, B):
            out[j0:j0 + B] = np.asarray(_block_dists_kernel(
                sigs_pad, jnp.int32(j0), N=self.N, B=B))
        return out[:self.n, :self.n]

    def code_matrix(self, threshold, early_stop):
        """(n, n) uint8 adjacency codes (see _block_codes_kernel) —
        the 1-byte readback form the connected-components DFS needs."""
        sigs_pad, B = self._padded()
        n_pad = sigs_pad.shape[0]
        cap_thr = jnp.int32(_min_cap(self.N, threshold))
        cap_early = jnp.int32(_min_cap(self.N, early_stop))
        out = np.empty((n_pad, n_pad), dtype=np.uint8)
        for j0 in range(0, n_pad, B):
            out[j0:j0 + B] = np.asarray(_block_codes_kernel(
                sigs_pad, jnp.int32(j0), cap_thr, cap_early,
                N=self.N, B=B))
        return out[:self.n, :self.n]


@functools.partial(jax.jit, static_argnames=("N",))
def _assign_to_reps_jit(qs, rs, n_reps, cap_thr, *, N):
    """Best representative per query signature.

    qs (Q, N) and rs (R_pad, N) are sorted MinHash signatures; rows of
    rs at or beyond n_reps are padding and can never win.  Returns
    (best_idx i32[Q], ok bool[Q]) where ok means the best rep's capped
    intersection count reaches cap_thr (i.e. distance within the
    clustering threshold).  Same capped-union estimator as
    _block_dists_kernel, scanned over the rep signatures' columns.
    """
    Q = qs.shape[0]
    R = rs.shape[0]
    A = qs[:, None, :]

    def step(carry, col):
        cm, cap, j = carry
        Bj = col[None, :, None]
        lt = jnp.sum(A < Bj, axis=-1, dtype=jnp.int32)
        eq = jnp.any(A == Bj, axis=-1)
        ok = eq & (lt + j - cm + 1 <= N)
        return (cm + eq.astype(jnp.int32),
                cap + ok.astype(jnp.int32), j + 1), None

    init = (jnp.zeros((Q, R), jnp.int32), jnp.zeros((Q, R), jnp.int32),
            jnp.int32(0))
    (_, cap, _), _ = jax.lax.scan(step, init, rs.T)
    cap = jnp.where(jnp.arange(R)[None, :] < n_reps, cap, -1)
    best = jnp.argmax(cap, axis=1).astype(jnp.int32)
    best_cap = jnp.max(cap, axis=1)
    return best, best_cap >= cap_thr


@functools.partial(jax.jit, static_argnames=("N",))
def _pair_caps_jit(qs, rs, *, N):
    """(Q, R) capped-intersection counts, in the narrowest dtype that
    holds N (counts are <= N; uint8 would silently wrap for signature
    lengths above 255)."""
    A = qs[:, None, :]
    R = rs.shape[0]

    def step(carry, col):
        cm, cap, j = carry
        Bj = col[None, :, None]
        lt = jnp.sum(A < Bj, axis=-1, dtype=jnp.int32)
        eq = jnp.any(A == Bj, axis=-1)
        ok = eq & (lt + j - cm + 1 <= N)
        return (cm + eq.astype(jnp.int32),
                cap + ok.astype(jnp.int32), j + 1), None

    init = (jnp.zeros((A.shape[0], R), jnp.int32),
            jnp.zeros((A.shape[0], R), jnp.int32), jnp.int32(0))
    (_, cap, _), _ = jax.lax.scan(step, init, rs.T)
    return cap.astype(jnp.uint8 if N <= 255 else jnp.int32)


# Above this many sequences the all-pairs methods are replaced by the
# greedy leader pass: the dense adjacency is O(n^2) in device compute
# AND readback (6.4e9 pairs at 80k sequences — hours), while the
# leader pass is O(n x n_clusters).  The reference has no path that
# completes at this scale either (its DFS evaluates every explored
# row against all unvisited candidates, cluster.py:274-331).
_ALL_PAIRS_MAX = 8192

_WAVE = 2048


def cluster_greedy_from_signatures(signatures, threshold_jaccard, N):
    """Leader clustering (Mash-screen / UCLUST style) over MinHash
    signatures: sequences are processed in input order in device-sized
    waves; each query joins the nearest cluster representative (ties
    to the earliest) among those that existed at the START of its wave,
    else — if no such representative is within the Jaccard threshold —
    it is matched against leaders created earlier in its OWN wave, and
    failing that becomes a new representative.

    Semantics vs the connected-components method: single-link chains
    through intermediate genomes do NOT merge clusters here (each
    member is within the threshold of its representative directly).
    For clade-structured inputs the outputs coincide; when they differ,
    this method over-splits, which is the safe direction for design
    (every cluster is still designed in full — at worst more probes).
    A BORDERLINE query — within the threshold of a pre-wave
    representative but nearer to a leader created in its own wave —
    takes the pre-wave representative, so its cluster membership can
    depend on the wave width; every assignment is still within the
    threshold of its representative, which is the property design
    correctness rests on.  O(n x n_clusters) total distance
    evaluations.

    Returns a list of index lists, descending size order (stable).
    """
    n = len(signatures)
    if n == 0:
        return []
    sigs = np.asarray(signatures, dtype=np.int64).astype(np.int32)
    cap_thr = _min_cap(N, threshold_jaccard)

    def pow2(x):
        return 1 if x <= 1 else 1 << int(x - 1).bit_length()

    rep_rows = []                      # global index of each leader
    assign = np.full(n, -1, dtype=np.int64)
    for w0 in range(0, n, _WAVE):
        wave = sigs[w0:w0 + _WAVE]
        Q = wave.shape[0]
        Qp = pow2(Q)
        if Qp != Q:
            wave = np.concatenate(
                [wave, np.zeros((Qp - Q, wave.shape[1]), np.int32)])
        unassigned = np.arange(Q, dtype=np.int64)
        if rep_rows:
            # Min bucket 128 keeps the compiled-shape count small as
            # the representative list grows (each fresh shape is a
            # fresh compile)
            Rp = max(128, pow2(len(rep_rows)))
            reps = np.zeros((Rp, sigs.shape[1]), dtype=np.int32)
            reps[:len(rep_rows)] = sigs[rep_rows]
            best, ok = _assign_to_reps_jit(
                jnp.asarray(wave), jnp.asarray(reps),
                jnp.int32(len(rep_rows)), jnp.int32(cap_thr),
                N=N)
            best = np.asarray(best)[:Q]
            ok = np.asarray(ok)[:Q]
            assign[w0:w0 + Q][ok] = best[ok]
            unassigned = np.flatnonzero(~ok)
        if len(unassigned):
            # Leader scan within the chunk's leftovers (only sequences
            # no existing representative claimed — usually a handful,
            # the whole chunk only while clusters are first being
            # discovered): one (L, L) capped-count block at the
            # bucketed leftover size, then a serial host pass so a
            # leftover can join a leader created earlier in the SAME
            # chunk (otherwise the first chunk would make every
            # sequence its own cluster).
            L = len(unassigned)
            Lp = min(max(256, pow2(L)), pow2(Q))
            blk = np.zeros((Lp, sigs.shape[1]), dtype=np.int32)
            blk[:L] = sigs[w0 + unassigned]
            caps = np.asarray(_pair_caps_jit(
                jnp.asarray(blk), jnp.asarray(blk),
                N=N)).astype(np.int32)[:L, :L]
            local_leaders = []         # positions within `unassigned`
            for ii in range(L):
                gi = w0 + unassigned[ii]
                if local_leaders:
                    row = caps[ii, local_leaders]
                    jj = int(np.argmax(row))
                    if row[jj] >= cap_thr:
                        assign[gi] = assign[w0 + unassigned[
                            local_leaders[jj]]]
                        continue
                local_leaders.append(ii)
                assign[gi] = len(rep_rows)
                rep_rows.append(gi)

    clusters = defaultdict(list)
    for i, c in enumerate(assign):
        clusters[int(c)].append(i)
    out = sorted(clusters.values(), key=len, reverse=True)
    return out


def cluster_hierarchically_from_dist_matrix(dist_matrix, threshold):
    """Average-linkage clustering of a condensed distance matrix
    (reference cluster.py:195-233)."""
    from scipy.cluster import hierarchy

    if len(dist_matrix) == 0:
        return [[0]]

    linkage = hierarchy.linkage(dist_matrix, method="average")
    clusters = hierarchy.fcluster(linkage, threshold, criterion="distance")

    first_clust_num = min(clusters)
    num_clusters = max(clusters) + 1 - first_clust_num
    elements_in_cluster = defaultdict(list)
    for i, clust_num in enumerate(clusters):
        elements_in_cluster[clust_num].append(i)
    cluster_sizes = {c: len(elements_in_cluster[c])
                     for c in range(first_clust_num,
                                    num_clusters + first_clust_num)}
    out = []
    for clust_num, _ in sorted(cluster_sizes.items(),
                               key=lambda t: t[1], reverse=True):
        out.append(elements_in_cluster[clust_num])
    return out


def find_connected_components(n, row_dist_fn, threshold,
                              early_stop_threshold=None):
    """Connected components by thresholded distances (reference
    cluster.py:236-355), with per-row batched distance evaluation.

    Args:
        n: number of elements
        row_dist_fn: function j -> np.array of distances from j to all
            elements (only entries for unvisited candidates are used)
        threshold: adjacency threshold (Jaccard distance)
        early_stop_threshold: if d(i, j) <= this, j is marked visited
            without exploring its neighborhood (default: jaccard dist of
            mash 0.02 at k=12, as in the reference)

    Returns:
        list of sorted index lists, in decreasing size order
    """
    if early_stop_threshold is None:
        early_stop_threshold = _jaccard_dist_from_mash_dist(0.02, 12)

    indices_to_consider = set(range(n))

    def dfs(i):
        visited = set()
        to_visit = [i]
        seen = {i}
        while to_visit:
            j = to_visit.pop()
            if j in visited:
                continue
            visited.add(j)
            candidates = [k for k in indices_to_consider if k not in seen]
            if not candidates:
                continue
            dists = row_dist_fn(j)
            for k in candidates:
                dist = dists[k]
                if dist <= threshold:
                    if dist <= early_stop_threshold:
                        visited.add(k)
                        seen.add(k)
                    else:
                        to_visit.append(k)
                        seen.add(k)
        return visited

    previously_visited = set()
    components = []
    for i in range(n):
        if i in previously_visited:
            continue
        cc = dfs(i)
        previously_visited.update(cc)
        indices_to_consider -= cc
        components.append(sorted(cc))
    components.sort(key=len, reverse=True)
    return components


def create_condensed_dist_matrix(n, row_dist_fn):
    """Condensed (scipy-form) distance matrix from batched row evals."""
    if n <= 1:
        return np.empty(0, dtype=np.float64)
    out = np.empty(n * (n - 1) // 2, dtype=np.float64)
    for i in range(n - 1):
        row = row_dist_fn(i)
        start = i * n - i * (i + 1) // 2 - i - 1
        out[start + i + 1:start + n] = row[i + 1:n]
    return out


def cluster_with_minhash_signatures(seqs, k=12, N=100, threshold=0.1,
                                    cluster_method="simple"):
    """Cluster sequences by MinHash signatures (reference
    cluster.py:358-430).

    Args:
        seqs: dict mapping sequence header to sequence
        k: k-mer size for hashing
        N: signature size
        threshold: clustering threshold in average nucleotide
            dissimilarity (1-ANI); converted internally to Jaccard
        cluster_method: 'simple' (connected components) or
            'hierarchical' (average linkage)

    Returns:
        list of collections of sequence headers, descending size order
    """
    num_seqs = len(seqs)
    logger.info("Producing signatures of %d sequences", num_seqs)
    family = lsh.MinHashFamily(k, N=N)
    signatures_map = make_signatures_with_minhash(family, seqs)

    seq_headers = list(seqs.keys())
    signatures = [signatures_map[name] for name in seq_headers]
    jaccard_dist_threshold = _jaccard_dist_from_mash_dist(threshold, k)

    if cluster_method in ("simple", "hierarchical") \
            and num_seqs > _ALL_PAIRS_MAX:
        logger.warning(
            "Input has %d sequences; the '%s' clustering method is "
            "all-pairs (quadratic) and does not complete at this scale, "
            "so the greedy leader method is used instead (see "
            "cluster_greedy_from_signatures)", num_seqs, cluster_method)
        cluster_method = "greedy"

    if cluster_method == "greedy":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of "
            "%f with the greedy leader method", num_seqs,
            jaccard_dist_threshold)
        clusters = cluster_greedy_from_signatures(
            signatures, jaccard_dist_threshold, N)
        return [[seq_headers[i] for i in cluster_idxs]
                for cluster_idxs in clusters]

    dd = _DeviceDistances(signatures)

    if cluster_method == "simple":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of %f "
            "based on connected components", num_seqs,
            jaccard_dist_threshold)
        # Precompute all pairwise adjacency codes in a few block
        # dispatches; the DFS then runs entirely on host pseudo-
        # distances that reproduce its two threshold comparisons
        # exactly (identical traversal, no per-row device roundtrips,
        # 1-byte readback per pair).
        early = _jaccard_dist_from_mash_dist(0.02, 12)
        if num_seqs > 1:
            codes = dd.code_matrix(jaccard_dist_threshold, early)
            # Translate one row at a time (the full float matrix would
            # be 8x the uint8 codes).  Code 1 exists only when the
            # threshold exceeds the early-stop value, where pseudo =
            # threshold reproduces "within threshold, beyond early".
            lut = np.array([2.0, jaccard_dist_threshold, 0.0],
                           dtype=np.float64)
            row_fn = lambda j: lut[codes[j]]  # noqa: E731
        else:
            row_fn = dd.row
        clusters = find_connected_components(
            num_seqs, row_fn, jaccard_dist_threshold,
            early_stop_threshold=early)
    elif cluster_method == "hierarchical":
        logger.info(
            "Clustering %d sequences at Jaccard distance threshold of %f "
            "using hierarchical method", num_seqs, jaccard_dist_threshold)
        dmat = dd.full_matrix()
        dist_matrix = create_condensed_dist_matrix(
            num_seqs, lambda j: dmat[j])
        clusters = cluster_hierarchically_from_dist_matrix(
            dist_matrix, jaccard_dist_threshold)
    else:
        raise ValueError(f"Unknown cluster_method '{cluster_method}'")

    return [[seq_headers[i] for i in cluster_idxs]
            for cluster_idxs in clusters]
