"""Device-resident corpus scan -> boundary-indexed set-cover instance.

The end-to-end device pipeline behind SetCoverFilter: from the encoded
corpus to a solver-ready set-cover instance without materializing
candidate pairs or cover spans on the host.  Replaces, for the main
design workload, the three-trip flow of ops/scan_sparse (host join ->
device verify -> host instance build), whose host<->device transfers
dominate wall-clock (readback of pairs + spans is ~70 MB per design on
the ebola175 bench vs ~privileged-scalar traffic here).

Stages (all jitted, all state device-resident):

  T. Probe seed table: hash every kj-mer of every probe (dense, all
     offsets) into one sorted (hash, solver_probe_id, offset) table.
  A. Query sampling: hash every s-th corpus position (s = the stride
     that guarantees any >= k_seed exact run contains a sampled kj-mer
     aligned with some probe-table entry; see below), look each hash up
     in the table with a vectorized binary search, emit per-sample hit
     counts.  Slabbed over the corpus at a fixed static shape.
  B. Hit expansion: turn (bucket, count) runs into flat (probe,
     alignment) pairs (bucket of each hit found by binary search over
     the hit prefix sums), sort, and deduplicate.  Slabbed by hit
     count.
  C. Verification: for fixed-size candidate chunks, rebuild the exact
     match vector from the device-resident corpus + probe tensors and
     enumerate all maximal <= K-mismatch windows containing a
     >= seed_req exact run (identical window math to ops/scan_sparse
     _verify_core, parity-tested), then apply cover extension, clamp to
     the chromosome, and emit (pair_key, start, end) spans in
     universe-local coordinates.
  D. Merge: sort spans by (pair_key, start) and merge overlapping or
     touching intervals per (set, universe) pair with a segmented-scan
     running maximum; a second pass keyed by universe alone yields the
     per-universe coverage union (universe sizes and spans).
  E. Assembly (DEFERRED — ensure_assembled): dense pair ids,
     interval/pair boundary indices, and global coordinates for the
     boundary-sum device solver (ops/set_cover.solve_boundary_instance).
     The default route instead reads the merged instance back through
     the compact pack (_pack_merged_jit: u16 key delta + narrow start
     + u16 length, escape channel for overflowing rows) and solves
     with the lazy-greedy host solver.

Host traffic: the encoded corpus + small lookup tables up; per-dispatch
counts, the tiny per-universe union, the packed merged instance, and
the final pick list down.

Seeding guarantee (stride sampling).  Every qualifying cover contains a
run of >= k_seed consecutive exact matches (the engine's exhaustive
seed requirement, ops/cover.py module docstring).  With kj <= k_seed
and stride s = k_seed - kj + 1, any such run contains s consecutive
aligned kj-mer start offsets, one of which is congruent to 0 mod s and
therefore sampled on the query side; the probe table is dense (all
offsets), so the joined pair is always found.  Compared to the host
path's (w, kj)-minimizers this needs no window-minima selection at all
and samples fewer positions (1/s vs ~2/(w+1) of them), at the price of
a denser probe table (a few MB).  Collisions of the 32-bit hash only
add candidate pairs that verification rejects; they never change
output.  The candidate set differs from the host join's (either is a
superset of the true cover pairs), so verified spans -- and everything
downstream -- are identical either way (parity-tested in
tests/test_scan_instance.py).
"""

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp

from catch_tpu.ops import encode
from catch_tpu.utils.profiling import maybe_trace

logger = logging.getLogger(__name__)

__all__ = ["scan_to_boundary_instance"]

# 32-bit rolling-hash multiplier (odd; golden ratio).  Must match
# between the probe table and the query side; nothing else depends on
# it.
_MULT = np.uint32(0x9E3779B1)
_HMAX = np.uint32(0xFFFFFFFF)
_I32MAX = np.int32(np.iinfo(np.int32).max)

# Static shapes (power-of-two buckets shared across workloads).
_SLAB_SAMPLES = 1 << 22     # query samples per stage-A dispatch
# Hits per stage-B dispatch.  Kept at the 2^22 width the merge kernels
# also use: compile time of the expansion+sort program grows with the
# sort width, and more, smaller dispatches cost only a scalar readback
# each.
_T_SLAB = 1 << 22
_C_CHUNK = 1 << 17          # candidates per stage-C dispatch
_SPAN_CAP = 1 << 18         # span buffer per stage-C dispatch
_BATCH_CHUNKS = 16          # stage-C buffers merged per D1 dispatch
_UNION_CAP = 1 << 16        # per-universe union runs (readback)


def _next_pow2(x):
    return 1 if x <= 1 else 1 << int(x - 1).bit_length()


def _gather_counts(scalars, devices):
    """Read a list of device scalars back with ONE transfer per device
    (each blocking scalar readback is a full host-device roundtrip, so
    a wave of N counts must not cost N roundtrips)."""
    if len(scalars) <= 1:
        return [int(x) for x in scalars]
    if len(devices) == 1:
        return [int(v) for v in np.asarray(jnp.stack(scalars))]
    by_dev = {}
    for i, x in enumerate(scalars):
        d = next(iter(x.devices()))
        by_dev.setdefault(d, []).append(i)
    out = [0] * len(scalars)
    for idxs in by_dev.values():
        vals = np.asarray(jnp.stack([scalars[i] for i in idxs]))
        for i, v in zip(idxs, vals):
            out[i] = int(v)
    return out


# ----------------------------------------------------------------------
# Stage T: probe seed table
# ----------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("kj", "row", "TBL"))
def _build_table_jit(flat_codes, *, kj, row, TBL):
    """Sorted (hash, probe, offset) table of every probe kj-mer.

    flat_codes: uint8[P * row + kj - 1] — probe code rows of width
    `row` = L + kj (each row: L codes then kj PAD zeros, so windows
    never span probes and row/offset fall out of the flat index by
    divmod).  The 1-D formulation keeps the minor dimension free of
    the non-aligned probe width, which the natural (P, L) 2D hash loop
    has; it was chosen for compile time.

    Returns (tbl_h u32[TBL], tbl_p i32[TBL], tbl_pos i32[TBL]) sorted
    by hash; unused rows carry hash sentinel HMAX (queries are clamped
    below it and never match).
    """
    n = flat_codes.shape[0] - (kj - 1)
    c = flat_codes.astype(jnp.uint32)
    h = jnp.zeros((n,), jnp.uint32)
    ok = jnp.ones((n,), bool)
    for j in range(kj):
        cj = jax.lax.slice(c, (j,), (j + n,))
        h = h * _MULT + cj
        ok = ok & (cj > 0)
    h = jnp.minimum(h, _HMAX - 1)
    f = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(ok, h, _HMAX)
    p_i = jnp.where(ok, f // row, 0)
    pos_i = jnp.where(ok, f % row, 0)
    pad = TBL - n
    key = jnp.concatenate([key, jnp.full((pad,), _HMAX, jnp.uint32)])
    p_i = jnp.concatenate([p_i, jnp.zeros((pad,), jnp.int32)])
    pos_i = jnp.concatenate([pos_i, jnp.zeros((pad,), jnp.int32)])
    return jax.lax.sort((key, p_i, pos_i), num_keys=1)


# ----------------------------------------------------------------------
# Stage A: sampled query hashes + table lookup
# ----------------------------------------------------------------------

# Stage A is two jits (sampled hashing, then table lookup), split for
# compile time; the extra dispatch is noise.

@functools.partial(jax.jit, static_argnames=("kj", "s", "Q"))
def _hash_samples_jit(mega, g0, n_last, *, kj, s, Q):
    """Clamped hashes of query samples g0 .. g0+Q-1 (sample g =
    position g*s); invalid samples (PAD in the window or past n_last)
    carry the sentinel HMAX.

    mega: uint8 corpus codes (0 = PAD), padded so position
        (g0+Q-1)*s + kj - 1 is readable.
    """
    c = jax.lax.dynamic_slice(mega, (g0 * s,), (Q * s + kj - 1,))
    c = c.astype(jnp.uint32)
    h = jnp.zeros((Q,), jnp.uint32)
    ok = jnp.ones((Q,), bool)
    for j in range(kj):
        cj = jax.lax.slice(c, (j,), (j + Q * s, ), (s,))
        h = h * _MULT + cj
        ok = ok & (cj > 0)
    h = jnp.minimum(h, _HMAX - 1)
    g = g0 + jnp.arange(Q, dtype=jnp.int32)
    ok = ok & (g * s <= n_last)
    return jnp.where(ok, h, _HMAX)


# Samples per planning block: the per-block hit sums read back for
# subrange planning are exact in int64 (the lo/hi 16-bit halves of the
# counts are summed separately, so a block sum can never overflow
# int32: 2^10 * 2^16 < 2^31 per half).
_PLAN_BLOCK = 1 << 10


# Radix-bucket parameters for the table lookup: queries first index a
# 2^_LK_BITS-entry prefix table of bucket boundaries, then bisect only
# within their bucket for _LK_ROUNDS rounds (covers buckets up to
# 2^_LK_ROUNDS entries).  jnp.searchsorted's full bisection is ~22
# rounds of Q-element gathers; this form needs 2 boundary gathers +
# 2x_LK_ROUNDS.  Buckets wider
# than 2^_LK_ROUNDS (heavily duplicated kj-mers) are detected via the
# max real-bucket width returned to the caller, which re-dispatches
# the exact full-bisection variant.
_LK_BITS = 16
_LK_ROUNDS = 8


def _lookup_core(tbl_h, q, full, rounds):
    TBL = tbl_h.shape[0]
    if full:
        lo = jnp.searchsorted(tbl_h, q, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(tbl_h, q, side="right").astype(jnp.int32)
        maxb = jnp.int32(0)
    else:
        shift = 32 - _LK_BITS
        edges = jnp.concatenate([
            (jnp.arange(1 << _LK_BITS, dtype=jnp.uint32)
             * jnp.uint32(1 << shift)),
            jnp.full((1,), _HMAX, jnp.uint32)])   # last edge: first
        bnd = jnp.searchsorted(tbl_h, edges,      # sentinel row
                               side="left").astype(jnp.int32)
        maxb = jnp.max(bnd[1:] - bnd[:-1])
        qj = (q >> shift).astype(jnp.int32)
        lo0 = bnd[qj]
        hi0 = bnd[qj + 1]

        def bisect(pred):
            lo_b, hi_b = lo0, hi0
            for _ in range(rounds):
                mid = (lo_b + hi_b) >> 1
                v = tbl_h[jnp.minimum(mid, TBL - 1)]
                go = pred(v)
                lo_b = jnp.where(go, mid + 1, lo_b)
                hi_b = jnp.where(go, hi_b, mid)
            return lo_b

        lo = bisect(lambda v: v < q)
        hi = bisect(lambda v: v <= q)
    cnt = jnp.where(q != _HMAX, hi - lo, 0)
    bs = min(_PLAN_BLOCK, cnt.shape[0])
    blocks = cnt.reshape(-1, bs)
    bs_lo = jnp.sum(blocks & 0xFFFF, axis=1, dtype=jnp.int32)
    bs_hi = jnp.sum(blocks >> 16, axis=1, dtype=jnp.int32)
    return lo, cnt, bs_lo, bs_hi, maxb


@functools.partial(jax.jit, static_argnames=("full", "rounds"))
def _lookup_jit(tbl_h, q, *, full, rounds):
    """Table hit ranges per sample hash: (lo, cnt, bs_lo, bs_hi, maxb).

    lo/cnt are i32[Q]; bs_lo/bs_hi are i32[Q/_PLAN_BLOCK] per-block
    sums of the low/high 16-bit halves of cnt, combined on the host
    into an exact int64 hit-count grid (a plain int32 cumsum readback
    can wrap past 2^31 hits per slab and silently corrupt subrange
    planning).  maxb is the widest real hash bucket (see _LK_BITS
    notes); when it exceeds 2^_LK_ROUNDS the bucketed results are
    invalid and the caller re-dispatches with full=True (exact
    searchsorted, maxb = 0).  Sentinel hashes (HMAX) never match
    (table rows are clamped below HMAX), so their cnt is 0 without
    extra masking... except that pad rows of the table ARE the
    sentinel, so mask explicitly.
    """
    return _lookup_core(tbl_h, q, full, rounds)


def _stage_a_jit(mega, g0, n_last, tbl_h, *, kj, s, Q, full=False):
    q = _hash_samples_jit(mega, g0, n_last, kj=kj, s=s, Q=Q)
    # rounds is passed as an explicit static argument (not read as a
    # trace-time global) so it participates in the jit cache key
    return _lookup_jit(tbl_h, q, full=full, rounds=_LK_ROUNDS)


# ----------------------------------------------------------------------
# Stage B: expansion + dedup + compaction
# ----------------------------------------------------------------------

# Stage B is two jits (hit expansion, then dedup+compaction), split
# for compile time like stage A.

@functools.partial(jax.jit, static_argnames=("T", "Q", "s"))
def _expand_hits_jit(lo, cnt, g0, i0, i1, tbl_p, tbl_pos, *, T, Q, s):
    """Expand hits of samples [i0, i1) to raw (probe, alignment) pairs.

    Returns (p i32[T], a i32[T]): entries past the true hit count carry
    the sentinel _I32MAX.  Alignment a means probe offset 0 sits at
    corpus position a (possibly before the owning sequence start; the
    verify chunk clips).

    Bucket resolution is scatter + cumsum, not binary search (a
    searchsorted over the hit prefix sums needs ~19 rounds of T-element
    gathers plus four more for the per-bucket fields).  Here the bucket
    id b(t) is the running count of bucket ENDS scattered at csum[i],
    and the per-bucket table offset (lo[b] - csum_excl[b]) propagates
    by scattering its per-bucket DELTA at each bucket start and
    cumsumming — the only remaining gathers are the two table lookups.
    Scatter width is Q into T.
    """
    iq = jnp.arange(Q, dtype=jnp.int32)
    cnt_sub = jnp.where((iq >= i0) & (iq < i1), cnt, 0)
    csum = jnp.cumsum(cnt_sub)
    total = csum[-1]
    csum_excl = csum - cnt_sub
    t = jnp.arange(T, dtype=jnp.int32)

    # b(t) = #{i : csum[i] <= t}: +1 scattered at each bucket end
    ends = jnp.minimum(csum, T)          # ends at T drop harmlessly
    b = jnp.cumsum(jnp.zeros((T + 1,), jnp.int32).at[ends].add(
        1, mode="drop")[:T])
    # offset(b) = lo[b] - csum_excl[b]; F(t) = offset(b(t)) via
    # scattered deltas at bucket starts (telescopes through empty
    # buckets, which share their start with the next bucket)
    off = lo - csum_excl
    d = jnp.concatenate([off[:1], off[1:] - off[:-1]])
    starts = jnp.minimum(csum_excl, T)
    F = jnp.cumsum(jnp.zeros((T + 1,), jnp.int32).at[starts].add(
        d, mode="drop")[:T])
    idx = F + t
    valid = t < total
    idxc = jnp.clip(idx, 0, tbl_p.shape[0] - 1)
    p = jnp.where(valid, tbl_p[idxc], _I32MAX)
    a = jnp.where(valid, (g0 + b) * s - tbl_pos[idxc], 0)
    return p, a


@functools.partial(jax.jit, static_argnames=("CAP",))
def _dedup_pairs_jit(p, a, *, CAP):
    """Sort raw pairs, drop duplicates, compact into CAP-sized buffers.

    Pairs come out sorted by (probe, alignment) with sentinel _I32MAX
    beyond n_pairs; n_pairs > CAP signals overflow (caller retries
    with a bigger CAP).
    """
    p_s, a_s = jax.lax.sort((p, a), num_keys=2)
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (p_s[1:] != p_s[:-1]) | (a_s[1:] != a_s[:-1])])
    keep = first & (p_s < _I32MAX)
    n_pairs = jnp.sum(keep, dtype=jnp.int32)
    dst = jnp.cumsum(keep.astype(jnp.int32)) - 1
    sc = jnp.where(keep, dst, CAP)
    out_p = jnp.full((CAP,), _I32MAX, jnp.int32).at[sc].set(
        p_s, mode="drop")
    out_a = jnp.zeros((CAP,), jnp.int32).at[sc].set(a_s, mode="drop")
    return out_p, out_a, n_pairs


def _stage_b_jit(lo, cnt, g0, i0, i1, tbl_p, tbl_pos, *, T, Q, CAP, s):
    p, a = _expand_hits_jit(lo, cnt, g0, i0, i1, tbl_p, tbl_pos,
                            T=T, Q=Q, s=s)
    return _dedup_pairs_jit(p, a, CAP=CAP)


# ----------------------------------------------------------------------
# Stage C: verification -> extended universe-local spans
# ----------------------------------------------------------------------

# Per-row cap on qualifying windows for the fast compaction: the
# (row, window) -> span compaction runs jnp.nonzero over a (C, tsw)
# domain, and tsw = 16 makes it 8x smaller than the full window count.
# Rows
# with more qualifying windows than this are counted in the `ovf`
# output and the caller re-dispatches the full-width variant.
_TS_WINDOWS = 16


@functools.partial(
    jax.jit,
    static_argnames=("L", "K", "C", "cap", "seed_req", "fast_ok",
                     "ext", "tsw"))
def _stage_c_jit(mega, codes_shift, lens_perm, pc, ac, off, n_pairs,
                 seq_starts, seq_ends, seq_lens, chrom_off, univ_of_seq,
                 k_seed, lcf, nU, *, L, K, C, cap, seed_req, fast_ok,
                 ext, tsw=_TS_WINDOWS):
    """Verify candidates [off, off+C) and emit instance-ready spans.

    Window math identical to ops/scan_sparse._verify_core (module
    docstring there); here the per-candidate fields are derived on
    device and qualifying spans leave in universe-local coordinates
    with cover extension applied, as (pair_key = probe * nU + universe,
    start, end) with sentinel keys beyond the qualifying count nq.

    The window is indexed relative to the WORD-ALIGNED alignment
    a2 = a & ~3: the corpus is gathered as uint32 words at a2 >> 2
    (4x fewer gather elements than the byte form) and unpacked with
    vector shifts; the probe side stays a plain fast row gather by
    storing FOUR pre-shifted copies of every probe row (codes_shift
    row r*P_pad + p holds probe p's codes at columns [r, r+len)), so
    no per-row data shift is ever needed.  The per-row validity band
    [i_lo, i_hi) (now in a2-relative coordinates) and all window math
    are shift-invariant.  The corpus pad before the first sequence
    keeps every a2 a valid (nonnegative) gather base.
    """
    Lw = L + 4                          # word-aligned window width
    P_pad = codes_shift.shape[0] // 4
    i = off + jnp.arange(C, dtype=jnp.int32)
    vmask = i < n_pairs
    ic = jnp.minimum(i, pc.shape[0] - 1)
    pg = jnp.where(vmask, pc[ic], 0)
    a = jnp.where(vmask, ac[ic], 0)
    r = a & 3
    a2 = a - r

    n_seqs = seq_ends.shape[0]
    sid = jnp.clip(jnp.searchsorted(seq_ends, a, side="right"), 0,
                   n_seqs - 1).astype(jnp.int32)
    s_lo = seq_starts[sid]
    s_hi = seq_ends[sid]
    plen = lens_perm[pg]
    start = jnp.maximum(s_lo, a)
    en = jnp.minimum(s_hi, a + plen)
    ov = jnp.maximum(en - start, 0)
    n_seq = s_hi - s_lo
    thres = jnp.minimum(jnp.minimum(lcf, plen), n_seq)
    thres = jnp.where(vmask, thres, 0)
    i_lo = start - a2                   # >= 0 by the leading pad
    i_hi = jnp.maximum(en - a2, i_lo)

    jL = jnp.arange(Lw, dtype=jnp.int32)
    t_cols = Lw + 1
    n_words = Lw // 4
    mega32 = jax.lax.bitcast_convert_type(
        mega.reshape(-1, 4), jnp.uint32)
    wbase = jnp.clip(a2, 0, mega.shape[0] - Lw) >> 2
    jw = jnp.arange(n_words, dtype=jnp.int32)
    words = mega32[wbase[:, None] + jw[None, :]]          # (C, n_words)
    seq_vals = jnp.stack(
        [(words >> (8 * k)).astype(jnp.uint8) for k in range(4)],
        axis=-1).reshape(C, Lw)
    probe_vals = codes_shift[r * P_pad + pg]
    validj = ((jL[None, :] >= i_lo[:, None])
              & (jL[None, :] < i_hi[:, None]))
    match = (seq_vals == probe_vals) & (seq_vals > 0) & validj

    if fast_ok:
        counts = jnp.sum(match, axis=1, dtype=jnp.int32)
        is_fast = (n_seq >= L) | ((K == 0) & (n_seq >= k_seed))
        need = jnp.maximum(thres - K, k_seed)
        qual_fast = (counts >= need) & (thres > 0)
    else:
        is_fast = jnp.zeros((C,), bool)
        qual_fast = jnp.zeros((C,), bool)

    mism = validj & ~match
    nm = jnp.sum(mism, axis=1, dtype=jnp.int32)
    # Sentinel-padded sorted mismatch positions: P[:, 0] = i_lo - 1,
    # then the mismatch positions ascending, then i_hi.  Built with a
    # row-wise sort rather than a 2D rank scatter.
    big = jnp.int32(1 << 30)
    sv = jnp.sort(jnp.where(mism, jL[None, :], big), axis=1)
    body = jnp.concatenate(
        [sv, jnp.full((C, K + 1), big, jnp.int32)],
        axis=1)[:, :Lw + K + 1]
    body = jnp.where(body >= big, i_hi[:, None], body)
    P = jnp.concatenate(
        [(i_lo - 1)[:, None], body], axis=1)

    lenW = P[:, K + 1:K + 1 + t_cols] - P[:, :t_cols] - 1
    runs = P[:, 1:] - P[:, :-1] - 1
    seedmax = runs[:, :t_cols]
    for sft in range(1, K + 1):
        seedmax = jnp.maximum(seedmax, runs[:, sft:sft + t_cols])
    tq = jnp.arange(t_cols, dtype=jnp.int32)
    qual = ((tq[None, :] <= nm[:, None]) & (lenW >= thres[:, None])
            & (seedmax >= seed_req) & (thres[:, None] > 0))
    if fast_ok:
        qual = jnp.where(is_fast[:, None],
                         (tq[None, :] == 0) & qual_fast[:, None], qual)

    nq = jnp.sum(qual, dtype=jnp.int32)
    TS = min(tsw, t_cols)
    if TS < t_cols:
        # Compact each row's qualifying window ids to its left edge
        # (cheap row sort), then enumerate over the (C, TS) domain.
        qt = jnp.sum(qual, axis=1, dtype=jnp.int32)
        ovf = jnp.sum(qt > TS, dtype=jnp.int32)
        tv = jnp.sort(jnp.where(qual, tq[None, :], jnp.int32(t_cols)),
                      axis=1)[:, :TS]
        qual2 = tv < t_cols
        rows, slots = jnp.nonzero(qual2, size=cap, fill_value=-1)
        okr = rows >= 0
        rc = jnp.maximum(rows, 0)
        tc = tv[rc, jnp.maximum(slots, 0)]
        tc = jnp.minimum(tc, t_cols - 1)
    else:
        ovf = jnp.int32(0)
        rows, ts = jnp.nonzero(qual, size=cap, fill_value=-1)
        okr = rows >= 0
        rc = jnp.maximum(rows, 0)
        tc = jnp.maximum(ts, 0)
    if fast_ok:
        sp_s = jnp.where(is_fast[rc], start[rc],
                         P[rc, tc] + 1 + a2[rc])
        sp_e = jnp.where(is_fast[rc], start[rc] + ov[rc],
                         P[rc, tc + K + 1] + a2[rc])
    else:
        sp_s = P[rc, tc] + 1 + a2[rc]
        sp_e = P[rc, tc + K + 1] + a2[rc]

    # Instance coordinates: chromosome-local, extended, clamped, offset
    # into the genome (universe), keyed by (probe, universe).
    sidr = sid[rc]
    ls = sp_s - seq_starts[sidr]
    le = sp_e - seq_starts[sidr]
    es = jnp.maximum(ls - ext, 0)
    ee = jnp.minimum(le + ext, seq_lens[sidr])
    us = es + chrom_off[sidr]
    ue = ee + chrom_off[sidr]
    key = jnp.where(okr, pg[rc] * nU + univ_of_seq[sidr], _I32MAX)
    us = jnp.where(okr, us, 0)
    ue = jnp.where(okr, ue, 0)
    return key, us, ue, nq, ovf


# ----------------------------------------------------------------------
# Stage D: segmented merge of (key, start, end) span sets
# ----------------------------------------------------------------------

def _merge_runs(k, s, e, OUT):
    """Sort spans by (key, start), merge overlapping/touching intervals
    per key, compact into OUT-sized buffers.  Shared by the pair-level
    and universe-level merges and idempotent (re-merging merged output
    is a no-op), so batches can be merged hierarchically.

    The per-group running maximum of interval ends uses an explicit
    Hillis-Steele doubling loop rather than lax.associative_scan, for
    compile time.  One scan
    serves both uses: within a key group sorted by start, every row of
    a later merge-run starts (and therefore ends) above every earlier
    run's maximum, so the group-prefix max at a run's last row IS that
    run's merged end.
    """
    k2, s2, e2 = jax.lax.sort((k, s, e), num_keys=2)
    valid = k2 < _I32MAX
    first = jnp.concatenate([jnp.ones((1,), bool), k2[1:] != k2[:-1]])
    gid = jnp.cumsum(first.astype(jnp.int32))

    rmax = e2
    d = 1
    # Propagate over the FULL input length, not OUT: a group (one key,
    # or one universe in the union pass) can span far more input rows
    # than the OUT compaction width, and truncating the doubling loop
    # at OUT silently fragments its merged runs (inflating u_size).
    n_in = k2.shape[0]
    while d < n_in:
        rs = jnp.concatenate([jnp.zeros((d,), rmax.dtype), rmax[:-d]])
        gs = jnp.concatenate([jnp.full((d,), -1, gid.dtype), gid[:-d]])
        rmax = jnp.where(gs == gid, jnp.maximum(rmax, rs), rmax)
        d *= 2

    rmax_prev = jnp.where(
        first, jnp.int32(-1),
        jnp.concatenate([jnp.zeros((1,), rmax.dtype), rmax[:-1]]))
    new_run = (first | (s2 > rmax_prev)) & valid
    run_id = jnp.cumsum(new_run.astype(jnp.int32)) - 1
    n_runs = jnp.sum(new_run, dtype=jnp.int32)
    nxt_new = jnp.concatenate([new_run[1:], jnp.ones((1,), bool)])
    nxt_valid = jnp.concatenate([valid[1:], jnp.zeros((1,), bool)])
    is_last = valid & (nxt_new | ~nxt_valid)
    sc_f = jnp.where(new_run, run_id, OUT)
    sc_l = jnp.where(is_last, run_id, OUT)
    out_k = jnp.full((OUT,), _I32MAX, jnp.int32).at[sc_f].set(
        k2, mode="drop")
    out_s = jnp.zeros((OUT,), jnp.int32).at[sc_f].set(s2, mode="drop")
    out_e = jnp.zeros((OUT,), jnp.int32).at[sc_l].set(rmax, mode="drop")
    return out_k, out_s, out_e, n_runs


@functools.partial(jax.jit, static_argnames=("OUT",))
def _merge_jit(k, s, e, *, OUT):
    return _merge_runs(k.reshape(-1), s.reshape(-1), e.reshape(-1), OUT)


@functools.partial(jax.jit, static_argnames=("OUT",))
def _union_jit(k, s, e, nU, *, OUT):
    """Universe-level union of merged pair intervals (key -> universe)."""
    ku = jnp.where(k < _I32MAX, k % nU, _I32MAX)
    return _merge_runs(ku, s, e, OUT)


# ----------------------------------------------------------------------
# Packed readback of the merged instance
# ----------------------------------------------------------------------

# Escape rows per pack dispatch (rows whose key delta or interval
# length exceeds 16 bits).  Typical instances escape a handful of rows
# (key deltas are small because keys are near-dense); overflow falls
# back to the unpacked readback.
_ESC_CAP = 1 << 12


@functools.partial(jax.jit, static_argnames=("N", "b_pos", "ECAP"))
def _pack_merged_jit(k, s, e, n, *, N, b_pos, ECAP):
    """Pack merged rows [0, n) into a compact byte stream for readback.

    Row layout (little-endian): u16 key delta from the previous row,
    then b_pos bytes of absolute start, then u16 interval length.  The
    merged buffer is compacted (valid rows are a prefix) and sorted by
    key, so key deltas are nonnegative and usually tiny.  Rows whose
    key delta or length exceeds 16 bits store 0 in that field and land
    in the escape channel with their absolute (key, end); the host
    decoder re-applies them (see _unpack_merged).  `b_pos` is chosen
    by the caller from the largest universe-local coordinate, which is
    known exactly (<= longest genome), so starts never escape.

    The readback is 4 + b_pos bytes/row instead of 12 unpacked, over N
    (the bucketed live count) instead of the full merge width.
    """
    k = k[:N]
    s = s[:N]
    e = e[:N]
    rows = jnp.arange(N, dtype=jnp.int32)
    valid = rows < n
    kprev = jnp.concatenate([jnp.zeros((1,), jnp.int32), k[:-1]])
    dk = jnp.where(valid, k - kprev, 0)
    ln = jnp.where(valid, e - s, 0)
    sv = jnp.where(valid, s, 0)
    key_esc = dk > 0xFFFF
    len_esc = ln > 0xFFFF
    esc = (key_esc | len_esc) & valid
    dk_st = jnp.where(key_esc, 0, dk)
    ln_st = jnp.where(len_esc, 0, ln)
    parts = [dk_st & 0xFF, (dk_st >> 8) & 0xFF]
    for b in range(b_pos):
        parts.append((sv >> (8 * b)) & 0xFF)
    parts += [ln_st & 0xFF, (ln_st >> 8) & 0xFF]
    packed = jnp.stack(parts, axis=1).astype(jnp.uint8).reshape(-1)

    n_esc = jnp.sum(esc, dtype=jnp.int32)
    dst = jnp.cumsum(esc.astype(jnp.int32)) - 1
    sc = jnp.where(esc, dst, ECAP)
    esc_idx = jnp.full((ECAP,), -1, jnp.int32).at[sc].set(
        rows, mode="drop")
    esc_key = jnp.zeros((ECAP,), jnp.int32).at[sc].set(k, mode="drop")
    esc_end = jnp.zeros((ECAP,), jnp.int32).at[sc].set(e, mode="drop")
    return packed, esc_idx, esc_key, esc_end, n_esc


def _unpack_merged(dev):
    """Decode the packed merged instance into host (key, start, end)
    int64 arrays; falls back to the unpacked device buffers when the
    escape channel overflowed (or no pack was dispatched)."""
    n = int(dev["n_merged"])
    pk = dev.get("packed")
    if pk is not None:
        packed, esc_idx, esc_key, esc_end, n_esc_dev, N, b_pos = pk
        n_esc = int(n_esc_dev)
        if n_esc <= esc_idx.shape[0]:
            width = 4 + b_pos
            rows = np.asarray(packed).reshape(N, width)[:n].astype(
                np.int64)
            dk = rows[:, 0] | (rows[:, 1] << 8)
            s = np.zeros(n, dtype=np.int64)
            for b in range(b_pos):
                s |= rows[:, 2 + b] << (8 * b)
            ln = rows[:, 2 + b_pos] | (rows[:, 3 + b_pos] << 8)
            k = np.cumsum(dk)
            e = s + ln
            if n_esc:
                idx = np.asarray(esc_idx[:n_esc]).astype(np.int64)
                kab = np.asarray(esc_key[:n_esc]).astype(np.int64)
                eab = np.asarray(esc_end[:n_esc]).astype(np.int64)
                # Escaped key deltas were stored as 0; shift every
                # suffix so the escaped rows take their absolute keys.
                # Corrections accumulate, so compute each row's needed
                # shift against the shifts already applied before it
                # (escape indices ascend), then apply them all with
                # one cumulative-sum pass.
                corr = np.zeros(n, dtype=np.int64)
                applied = np.int64(0)
                for i, ka in zip(idx, kab):
                    d = ka - (k[i] + applied)
                    corr[i] = d
                    applied += d
                k += np.cumsum(corr)
                e[idx] = eab
            return k, s, e
        logger.warning("Pack escape channel overflowed (%d rows); "
                       "reading the merged instance unpacked", n_esc)
    mk, ms, me = dev["merged"]
    return (np.asarray(mk[:n]).astype(np.int64),
            np.asarray(ms[:n]).astype(np.int64),
            np.asarray(me[:n]).astype(np.int64))


# ----------------------------------------------------------------------
# Stage E: instance assembly
# ----------------------------------------------------------------------

@functools.partial(jax.jit,
                   static_argnames=("OUT", "P_CAP", "S_pad", "nU_pad"))
def _assemble_jit(k, s, e, offsets_univ, n_merged, nU, *, OUT, P_CAP,
                  S_pad, nU_pad):
    """Boundary-indexed solver arrays from merged (key, start, end).

    Returns (ivl_start_g, ivl_end_g, pair_bounds, set_bounds,
    univ_of_pair, n_pairs, max_pairs_per_set, max_ivls_per_set).
    Global coordinates = universe-local + offsets_univ[universe].
    """
    valid = k < _I32MAX
    u = jnp.where(valid, k % nU, 0)
    gs = jnp.where(valid, s + offsets_univ[u], 0)
    ge = jnp.where(valid, e + offsets_univ[u], 0)

    pairfirst = valid & jnp.concatenate(
        [jnp.ones((1,), bool), k[1:] != k[:-1]])
    pair_id = jnp.cumsum(pairfirst.astype(jnp.int32)) - 1
    n_pairs = jnp.sum(pairfirst, dtype=jnp.int32)
    sc = jnp.where(pairfirst, pair_id, P_CAP)
    set_of_pair = jnp.full((P_CAP,), S_pad - 1, jnp.int32).at[sc].set(
        k // nU, mode="drop")
    univ_of_pair = jnp.full((P_CAP,), nU_pad - 1, jnp.int32).at[sc].set(
        u, mode="drop")
    row_idx = jnp.arange(OUT, dtype=jnp.int32)
    pb = jnp.zeros((P_CAP + 1,), jnp.int32).at[
        jnp.where(pairfirst, pair_id, P_CAP + 1)].set(
        row_idx, mode="drop")
    pb = jnp.where(jnp.arange(P_CAP + 1) >= n_pairs, n_merged, pb)
    set_bounds = jnp.searchsorted(
        set_of_pair, jnp.arange(S_pad + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    # Per-set maxima over REAL sets only (0..S_pad-2): the dummy set
    # S_pad-1 absorbs every padded pair, and letting its range into
    # these maxima makes the solver's per-step update loops span the
    # whole pad region.
    mp = jnp.max(set_bounds[1:S_pad] - set_bounds[:S_pad - 1])
    ivl_of_set = pb[set_bounds[1:S_pad]] - pb[set_bounds[:S_pad - 1]]
    mi = jnp.max(ivl_of_set)
    return (gs, ge, pb, set_bounds, univ_of_pair, n_pairs, mp, mi)


# ----------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------

def _join_params_stride(searcher):
    """(kj, s): kj-mer length and query stride for the device join.

    kj + s - 1 == k_seed preserves the exhaustive-seed guarantee (see
    module docstring); kj >= 12 bounds random hash-collision rates,
    matching the host minimizer parameters (ops/cover.py)."""
    k = searcher.k_seed
    kj = max(12, k - 20 + 1)
    kj = min(kj, k)
    return kj, k - kj + 1


def scan_to_boundary_instance(searcher, sequences, seq_univ, chrom_off,
                              seq_len, n_universes, cover_extension,
                              universe_p, rank_idx_cand, n_rank_vals,
                              cost_cand, pid_of):
    """Scan `sequences` and build a device set-cover instance.

    Args:
        searcher: ops.cover.ProbeSearcher (default model only)
        sequences: list of chromosome sequences (strings), flattened
            over genomes
        seq_univ / chrom_off / seq_len: int arrays per sequence: owning
            genome (universe) id, cumulative chromosome offset within
            the genome, chromosome length
        n_universes: number of genomes
        cover_extension: bp extension per cover range
        universe_p: float64[n_universes] required coverage fractions
        rank_idx_cand: int32[n_candidates] dense rank index per
            candidate probe
        n_rank_vals: number of distinct rank values
        cost_cand: float32[n_candidates]
        pid_of: int64[P] candidate id per searcher probe (last-wins)

    Returns:
        (dev, perm) where dev is the dict consumed by
        ops.set_cover.solve_boundary_instance and perm maps solver set
        ids to searcher probe indices (chosen candidate ids are
        pid_of[perm[order]]), or None when this workload cannot run on
        the device path (custom model, or coordinates exceeding int32).
    """
    import time as _time

    model = searcher.model
    if model.custom_fn is not None or searcher.K_static is None:
        return None
    _t_setup = _time.time()
    P = len(searcher.probes)
    nU = int(n_universes)
    if P == 0 or nU == 0 or not sequences:
        return None
    if P * nU >= np.iinfo(np.int32).max:
        return None
    L = searcher.Lmax
    K = int(searcher.K_static)
    k_seed = int(searcher.k_seed)
    island = model.island_of_exact_match
    seed_req = max(k_seed, island) if island > 0 else k_seed
    kj, s = _join_params_stride(searcher)

    # Mega corpus array: [L pad][seq0][L pad][seq1]...[tail pad].  The
    # tail covers both stage A's strided reads and stage C's L-window
    # gathers.
    # Shape bucketing: every array whose size enters a jitted program
    # is padded to a power-of-two bucket (corpus length, probe count,
    # sequence count), and the universe count is passed as a traced
    # scalar — so designs of different groups/clusters share compiled
    # executables instead of paying a fresh compile per exact shape (a
    # clustered design has tens of distinct group shapes).
    n_seqs = len(sequences)
    seq_lens = np.asarray([len(x) for x in sequences], dtype=np.int64)
    starts = np.empty(n_seqs, dtype=np.int64)
    # Leading pad of L + kj: the smallest alignment is
    # first_start - (row - 1) = 1, so stage C's window gather base is
    # always nonnegative (see _stage_c_jit).
    pos = L + kj
    for i, ln in enumerate(seq_lens):
        starts[i] = pos
        pos += int(ln) + L
    total = pos
    n_samples = (total + s - 1) // s
    # Slab width bucketed to the workload: a small group must not pay
    # for full-width slabs (hashing + lookup scale with the slab, and
    # a clustered design has many small groups).  Power-of-two buckets
    # keep the compiled-program count logarithmic.
    slab_q = min(_SLAB_SAMPLES, _next_pow2(n_samples))
    n_slabs = max(1, -(-n_samples // slab_q))
    tail = max(L, slab_q * s * n_slabs + kj - total) + 8
    if total + tail > np.iinfo(np.int32).max:
        return None
    mega_len = _next_pow2(total + tail)
    mega = np.zeros(mega_len, dtype=np.uint8)
    for i, x in enumerate(sequences):
        mega[starts[i]:starts[i] + seq_lens[i]] = searcher.alphabet.encode(
            encode.encode_bytes(x))
    ends = starts + seq_lens

    # Padded sequence tables: pad rows behave as zero-length sequences
    # at position `total` (never matched, never emit spans).
    ns_pad = _next_pow2(n_seqs)
    starts_p = np.full(ns_pad, total, dtype=np.int64)
    starts_p[:n_seqs] = starts
    ends_p = np.full(ns_pad, total, dtype=np.int64)
    ends_p[:n_seqs] = ends
    seq_lens_p = np.zeros(ns_pad, dtype=np.int64)
    seq_lens_p[:n_seqs] = seq_lens
    chrom_off_p = np.zeros(ns_pad, dtype=np.int64)
    chrom_off_p[:n_seqs] = np.asarray(chrom_off)
    seq_univ_p = np.zeros(ns_pad, dtype=np.int64)
    seq_univ_p[:n_seqs] = np.asarray(seq_univ)

    perm = np.argsort(pid_of, kind="stable")
    P_pad = _next_pow2(max(P, 1))
    codes_perm = np.zeros((P_pad, searcher.probe_codes.shape[1]),
                          dtype=np.uint8)
    codes_perm[:P] = searcher.probe_codes[perm]
    lens_perm = np.zeros(P_pad, dtype=np.int32)
    lens_perm[:P] = searcher.probe_lens[perm].astype(np.int32)
    # Stage C's probe side: four pre-shifted copies of every probe row
    # (row r*P_pad + p holds probe p at columns [r, r+L)) so the
    # word-aligned corpus gather needs no per-row data shift — see
    # _stage_c_jit.
    Lw = L + 4
    codes_shift = np.zeros((4 * P_pad, Lw), dtype=np.uint8)
    for rr in range(4):
        codes_shift[rr * P_pad:(rr + 1) * P_pad, rr:rr + L] = \
            codes_perm[:, :L]

    # Mesh scale-out: stages A/B/C are embarrassingly parallel over
    # sample slabs / hit subranges / candidate chunks, so dispatches
    # round-robin over the mesh's addressable devices with the corpus
    # and lookup tables replicated; stage-C outputs hop to the first
    # device, where the merges and assembly run.  Dispatch order is
    # device-independent, so the instance is bit-identical at any
    # device count (the num_processes-invariance contract).
    mesh = getattr(searcher, "mesh", None)
    if mesh is not None and mesh.devices.size > 1:
        devices = [d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()]
    else:
        devices = [None]    # default placement, no replication

    def rep(x):
        a = jnp.asarray(x)
        if devices[0] is None:
            return [a]
        return [jax.device_put(a, d) for d in devices]

    mega_dev = rep(mega)
    codes_dev = rep(codes_shift)
    lens_dev = rep(lens_perm)
    seq_starts_dev = rep(starts_p.astype(np.int32))
    seq_ends_dev = rep(ends_p.astype(np.int32))
    seq_lens_dev = rep(seq_lens_p.astype(np.int32))
    chrom_off_dev = rep(chrom_off_p.astype(np.int32))
    univ_of_seq_dev = rep(seq_univ_p.astype(np.int32))

    # Largest universe-local coordinate any span can carry (spans are
    # clamped to chrom_off + seq_len per sequence); sizes the packed
    # readback's start field exactly.
    max_pos = int((chrom_off_p[:n_seqs] + seq_lens_p[:n_seqs]).max()) \
        if n_seqs else 0

    from catch_tpu.utils import profiling
    _dt = _time.time() - _t_setup
    searcher.stats.setdefault("phase_seconds", {})
    searcher.stats["phase_seconds"]["setup"] = \
        searcher.stats["phase_seconds"].get("setup", 0.0) + _dt
    profiling.add_phase("scan:setup", _dt)

    with maybe_trace("scan_instance"):
        return _run_pipeline(
            searcher, devices, mega_dev, codes_dev, codes_perm,
            lens_dev, seq_starts_dev, seq_ends_dev, seq_lens_dev,
            chrom_off_dev, univ_of_seq_dev, perm, pid_of, total,
            n_samples, kj, s, L, K, k_seed, seed_req, nU,
            cover_extension, universe_p, rank_idx_cand, n_rank_vals,
            cost_cand, max_pos)


def _run_pipeline(searcher, devices, mega_dev, codes_dev, codes_perm,
                  lens_dev, seq_starts_dev, seq_ends_dev, seq_lens_dev,
                  chrom_off_dev, univ_of_seq_dev, perm, pid_of, total,
                  n_samples, kj, s, L, K, k_seed, seed_req, nU,
                  cover_extension, universe_p, rank_idx_cand,
                  n_rank_vals, cost_cand, max_pos):
    import time as _time

    n_dev = len(devices)

    # Wall-clock per phase, measured at each phase's blocking readback
    # (dispatches are asynchronous, so a phase's time includes device
    # execution of work queued in it).  Feeds bench.py's breakdown.
    phases = searcher.stats.setdefault("phase_seconds", {})

    def _mark(key, t0):
        from catch_tpu.utils import profiling
        dt = _time.time() - t0
        phases[key] = phases.get(key, 0.0) + dt
        profiling.add_phase("scan:" + key, dt)
        return _time.time()

    t0 = _time.time()
    P = len(searcher.probes)
    P_pad = codes_perm.shape[0]
    # Stage T: probe rows flattened with kj-PAD gaps (see
    # _build_table_jit for why 1-D).  Pad probe rows are all-PAD, so
    # they contribute no table entries.
    row = L + kj
    flat = np.zeros(P_pad * row + kj - 1, dtype=np.uint8)
    flat[:P_pad * row].reshape(P_pad, row)[:, :L] = codes_perm
    TBL = _next_pow2(P_pad * row)
    tbl = _build_table_jit(jnp.asarray(flat), kj=kj, row=row, TBL=TBL)
    if devices[0] is None:
        tbl_by_dev = [tbl]
    else:
        tbl_by_dev = [tuple(jax.device_put(x, d) for x in tbl)
                      for d in devices]
    # tbl_p holds row indices into codes_dev, which is already in
    # solver (pid-sorted) order, so pair keys sort by candidate id.

    # Stage A over sample slabs, round-robin over the mesh devices
    n_last = total - kj  # last valid kj-mer start position
    slab_q = min(_SLAB_SAMPLES, _next_pow2(n_samples))
    slabs = []
    for si, g0 in enumerate(range(0, n_samples, slab_q)):
        di = si % n_dev
        lo, cnt, bs_lo, bs_hi, maxb = _stage_a_jit(
            mega_dev[di], jnp.int32(g0), jnp.int32(n_last),
            tbl_by_dev[di][0], kj=kj, s=s, Q=slab_q)
        slabs.append([di, g0, lo, cnt, bs_lo, bs_hi, maxb])
    # Bucketed-lookup escalation: a hash bucket too wide for the
    # bounded bisection (heavily duplicated kj-mers) invalidates the
    # whole wave — one batched readback of the per-slab max widths,
    # then exact full-bisection re-dispatches where needed.
    maxbs = _gather_counts([x[6] for x in slabs], devices)
    for sl, mb in zip(slabs, maxbs):
        if mb >= (1 << _LK_ROUNDS):
            di, g0 = sl[0], sl[1]
            lo, cnt, bs_lo, bs_hi, _ = _stage_a_jit(
                mega_dev[di], jnp.int32(g0), jnp.int32(n_last),
                tbl_by_dev[di][0], kj=kj, s=s, Q=slab_q, full=True)
            sl[2:6] = [lo, cnt, bs_lo, bs_hi]
    t0 = _mark("table_and_hash", t0)

    # Stage B: expansion subranges with <= _T_SLAB hits each; each
    # subrange runs on the device that holds its slab's hit ranges.
    pending_b = []   # dispatched, counts not yet read
    pair_bufs = []   # (device idx, p_c, a_c, n)
    n_candidates = 0
    for di, g0, lo, cnt, bs_lo, bs_hi, _maxb in slabs:
        # One per-block readback of the hit sums per slab; every
        # subrange decision below is host math on the exact int64
        # prefix grid built from the 16-bit halves (see _lookup_jit).
        # (Reading prefix values at varying host-constant indices
        # instead compiled a fresh one-off device program per distinct
        # index — tens of uncacheable compiles per corpus.)
        stride = min(_PLAN_BLOCK, slab_q)
        block64 = (np.asarray(bs_lo).astype(np.int64)
                   + (np.asarray(bs_hi).astype(np.int64) << 16))
        grid = np.cumsum(block64)
        slab_total = int(grid[-1])
        if slab_total == 0:
            continue
        # Expansion width bucketed to this slab's hit count (small
        # groups must not sort 4M-wide buffers for 100k hits).
        T_eff = min(_T_SLAB, max(1 << 16, _next_pow2(slab_total)))
        # Split the sample range so each piece expands <= T_eff hits
        # (75% target leaves headroom for grid-cell granularity).
        n_parts = max(1, -(-slab_total // (T_eff * 3 // 4)))
        if n_parts == 1:
            bounds = [0, slab_q]
        else:
            targets = np.arange(1, n_parts) * (slab_total / n_parts)
            cut = (np.searchsorted(grid, targets) + 1) * stride
            bounds = sorted(set(
                [0] + [int(min(c, slab_q)) for c in cut] + [slab_q]))

        def hits_before(i):
            return int(grid[i // stride - 1]) if i else 0

        for i0, i1 in zip(bounds[:-1], bounds[1:]):
            if i0 >= i1:
                continue
            sub_total = hits_before(i1) - hits_before(i0)
            if sub_total == 0:
                continue
            if sub_total > T_eff:
                logger.warning("Expansion subrange still exceeds the "
                               "hit slab; falling back to host scan")
                return None
            # Dispatch only; counts are read back after every device
            # has work queued so the mesh runs subranges concurrently.
            p_c, a_c, n_pairs = _stage_b_jit(
                lo, cnt, jnp.int32(g0), jnp.int32(i0), jnp.int32(i1),
                tbl_by_dev[di][1], tbl_by_dev[di][2],
                T=T_eff, Q=slab_q, CAP=T_eff, s=s)
            pending_b.append((di, lo, cnt, g0, i0, i1, T_eff, p_c, a_c,
                              n_pairs))
    # One batched readback of every subrange's pair count (each
    # blocking scalar readback is a full host-device roundtrip).
    counts_b = _gather_counts([x[9] for x in pending_b], devices)
    for (di, lo, cnt, g0, i0, i1, T_eff, p_c, a_c, n_pairs), n in zip(
            pending_b, counts_b):
        # CAP == T_eff >= subrange hits >= deduplicated pairs, so the
        # compaction cannot overflow by construction
        assert n <= T_eff, (n, T_eff)
        if n:
            pair_bufs.append((di, p_c, a_c, n))
            n_candidates += n
    searcher.stats["candidates"] += n_candidates
    t0 = _mark("join_expand", t0)
    if not pair_bufs:
        return None

    # Stage C + batched D1 merges
    ext = int(cover_extension)
    merged_bufs = []   # (k, s, e) device buffers, each _D1_OUT wide
    chunk_accum = []
    span_total = 0

    def flush_batch():
        nonlocal chunk_accum
        if not chunk_accum:
            return
        n_acc = _next_pow2(len(chunk_accum))
        n_pad = n_acc - len(chunk_accum)
        ks = jnp.stack([x[0] for x in chunk_accum]
                       + [jnp.full((_SPAN_CAP,), _I32MAX, jnp.int32)] * n_pad)
        ss = jnp.stack([x[1] for x in chunk_accum]
                       + [jnp.zeros((_SPAN_CAP,), jnp.int32)] * n_pad)
        es = jnp.stack([x[2] for x in chunk_accum]
                       + [jnp.zeros((_SPAN_CAP,), jnp.int32)] * n_pad)
        mk, ms, me, _ = _merge_jit(ks, ss, es,
                                   OUT=_next_pow2(n_acc * _SPAN_CAP))
        merged_bufs.append((mk, ms, me))
        chunk_accum = []

    def _dispatch_c(di, p_c, a_c, n, off, C, cap, tsw=_TS_WINDOWS):
        return _stage_c_jit(
            mega_dev[di], codes_dev[di], lens_dev[di], p_c, a_c,
            jnp.int32(off), jnp.int32(n), seq_starts_dev[di],
            seq_ends_dev[di], seq_lens_dev[di],
            chrom_off_dev[di], univ_of_seq_dev[di],
            jnp.int32(k_seed), jnp.int32(searcher.lcf_static),
            jnp.int32(nU), L=L, K=K, C=C, cap=cap, seed_req=seed_req,
            fast_ok=searcher.fast_ok, ext=ext, tsw=tsw)

    # Chunk width bucketed per pair buffer (a 100k-pair group must not
    # verify at full chunk width); a narrower chunk also gets a
    # narrower span cap and is merged alone (the fixed-width batcher
    # only stacks _SPAN_CAP buffers).
    chunks = []
    for (di, p_c, a_c, n) in pair_bufs:
        C_eff = min(_C_CHUNK, _next_pow2(n))
        cap_eff = min(_SPAN_CAP, _next_pow2(C_eff * (K + 1)))
        for off in range(0, n, C_eff):
            chunks.append((di, p_c, a_c, n, off, C_eff, cap_eff))
    # Dispatch in waves (all devices busy before any count readback),
    # consume in chunk order so the merge sequence — and therefore the
    # instance — is identical at any device count.
    wave = _BATCH_CHUNKS * max(2, n_dev)
    for w0 in range(0, len(chunks), wave):
        pend = []
        for (di, p_c, a_c, n, off, C_eff, cap_eff) in chunks[w0:w0 + wave]:
            pend.append((di, p_c, a_c, n, off,
                         _dispatch_c(di, p_c, a_c, n, off, C_eff,
                                     cap_eff)))
        scalars = []
        for x in pend:
            scalars.extend([x[5][3], x[5][4]])
        counts_c = _gather_counts(scalars, devices)
        for w, ((di, p_c, a_c, n, off, (key, us, ue, nq, ovf)),
                (_, _, _, _, _, C_eff, cap_eff)) in enumerate(
                zip(pend, chunks[w0:w0 + wave])):
            nqi, ovfi = counts_c[2 * w], counts_c[2 * w + 1]
            cap = cap_eff
            tsw = _TS_WINDOWS
            # Rare re-runs: a row with more qualifying windows than
            # the per-row slot cap forces the full-width compaction
            # variant; a span count beyond the buffer re-runs wider.
            while ovfi > 0 or nqi > cap:
                if ovfi > 0:
                    tsw = 1 << 30        # clamped to the window count
                if nqi > cap:
                    cap = _next_pow2(nqi)
                key, us, ue, nq, ovf = _dispatch_c(
                    di, p_c, a_c, n, off, C_eff, cap, tsw)
                nqi, ovfi = int(nq), int(ovf)
            if nqi == 0:
                continue
            span_total += nqi
            if di != 0 and devices[0] is not None:
                # merges and assembly run on the first device
                key = jax.device_put(key, devices[0])
                us = jax.device_put(us, devices[0])
                ue = jax.device_put(ue, devices[0])
            if key.shape[0] != _SPAN_CAP:
                # escalated cap: merge this chunk alone so batch
                # stacking keeps a fixed width
                mk, ms, me, _ = _merge_jit(
                    key[None], us[None], ue[None],
                    OUT=_next_pow2(key.shape[0]))
                merged_bufs.append((mk, ms, me))
                continue
            chunk_accum.append((key, us, ue))
            if len(chunk_accum) == _BATCH_CHUNKS:
                flush_batch()
    flush_batch()
    t0 = _mark("verify", t0)
    if not merged_bufs:
        return None

    # Stage D2: merge across batch outputs (hierarchically if needed)
    while len(merged_bufs) > 1:
        group = merged_bufs[:_BATCH_CHUNKS]
        merged_bufs = merged_bufs[_BATCH_CHUNKS:]
        width = max(x[0].shape[0] for x in group)
        ks = jnp.stack([_pad_to(x[0], width, _I32MAX) for x in group])
        ss = jnp.stack([_pad_to(x[1], width, 0) for x in group])
        es = jnp.stack([_pad_to(x[2], width, 0) for x in group])
        out = _next_pow2(len(group) * width)
        mk, ms, me, _ = _merge_jit(ks, ss, es, OUT=out)
        merged_bufs.append((mk, ms, me))
    mk, ms, me = merged_bufs[0]
    # Final pass guarantees a single globally merged, sorted buffer
    OUT = mk.shape[0]
    mk, ms, me, n_runs = _merge_jit(mk[None], ms[None], me[None], OUT=OUT)
    n_merged = int(n_runs)
    t0 = _mark("merge", t0)
    if n_merged == 0:
        return None
    # The default solve route reads the merged instance back on the
    # host (instance_to_host).  Dispatch the compact packing now and
    # start its host copy so the transfer overlaps the union +
    # metadata work below (and the readback that remains at solve
    # time is 4 + b_pos bytes/row instead of 12, over the live prefix
    # instead of the full merge width).
    b_pos = 2 if max_pos <= 0xFFFF else (
        3 if max_pos <= 0xFFFFFF else 4)
    N_pack = min(OUT, _next_pow2(max(n_merged, 1 << 10)))
    packed, esc_idx, esc_key, esc_end, n_esc = _pack_merged_jit(
        mk, ms, me, jnp.int32(n_merged), N=N_pack, b_pos=b_pos,
        ECAP=_ESC_CAP)
    for x in (packed, esc_idx, esc_key, esc_end, n_esc):
        x.copy_to_host_async()
    packed_tuple = (packed, esc_idx, esc_key, esc_end, n_esc,
                    N_pack, b_pos)

    # Universe unions -> u_size / u_span on host (tiny readback)
    uk, us_, ue_, n_u_runs = _union_jit(mk, ms, me, jnp.int32(nU),
                                        OUT=_UNION_CAP)
    nur = int(n_u_runs)
    if nur > _UNION_CAP:
        uk, us_, ue_, n_u_runs = _union_jit(
            mk, ms, me, jnp.int32(nU), OUT=_next_pow2(nur))
        nur = int(n_u_runs)
    ukh = np.asarray(uk[:nur]).astype(np.int64)
    ush = np.asarray(us_[:nur]).astype(np.int64)
    ueh = np.asarray(ue_[:nur]).astype(np.int64)
    u_size = np.zeros(nU, dtype=np.int64)
    u_span = np.zeros(nU, dtype=np.int64)
    np.add.at(u_size, ukh, ueh - ush)
    np.maximum.at(u_span, ukh, ueh)
    offsets = np.zeros(nU + 1, dtype=np.int64)
    np.cumsum(u_span, out=offsets[1:])
    u_len = int(offsets[-1])
    if u_len >= np.iinfo(np.int32).max:
        logger.warning("Global position axis exceeds int32; falling "
                       "back to the host instance build")
        return None
    universe_p = np.asarray(universe_p, dtype=np.float64)
    can_uncover = (u_size - universe_p * u_size).astype(np.int64)

    # Stage E (boundary arrays for the device solver) is DEFERRED:
    # the default solve route is the lazy host solver, which reads the
    # packed merge back and never touches the boundary arrays, so
    # running _assemble_jit here (plus its two blocking scalar
    # readbacks) charged every design for a program only the opt-in
    # device-solver route executes.  ensure_assembled() materializes
    # it on demand.
    S_pad = _next_pow2(P_pad + 1)
    nU_pad = _next_pow2(nU + 1)
    cost_perm = np.ones(S_pad, dtype=np.float32)
    cost_perm[:P] = np.asarray(cost_cand, dtype=np.float32)[pid_of[perm]]
    rank_perm = np.full(S_pad, n_rank_vals, dtype=np.int32)
    rank_perm[:P] = np.asarray(rank_idx_cand, dtype=np.int32)[
        pid_of[perm]]
    can_unc_pad = np.zeros(nU_pad, dtype=np.int32)
    can_unc_pad[:nU] = can_uncover
    u_size_pad = np.zeros(nU_pad, dtype=np.int32)
    u_size_pad[:nU] = u_size

    _mark("assemble", t0)
    dev = dict(
        cost=jnp.asarray(cost_perm),
        rank_idx=jnp.asarray(rank_perm),
        can_uncover=jnp.asarray(can_unc_pad),
        u_size=jnp.asarray(u_size_pad),
        U_pad=_next_pow2(u_len), n_rank_vals=n_rank_vals,
        S_pad=S_pad, nU_pad=nU_pad,
        # For the host lazy solver route: the packed merged intervals
        # (universe-local) plus host metadata to rebuild an exact
        # SetCoverInstance from one compact readback; `merged` is the
        # unpacked fallback and ensure_assembled's input.
        packed=packed_tuple,
        merged=(mk, ms, me), n_merged=n_merged, offsets=offsets,
        nU=nU, u_size_host=u_size, can_uncover_host=can_uncover)
    return dev, perm


def ensure_assembled(dev):
    """Materialize the boundary-indexed solver arrays (stage E) on a
    device instance that deferred them; idempotent."""
    if "ivl_start" in dev:
        return dev
    mk, ms, me = dev["merged"]
    OUT = mk.shape[0]
    nU = dev["nU"]
    nU_pad = dev["nU_pad"]
    off_pad = np.zeros(nU_pad, dtype=np.int32)
    off_pad[:nU] = dev["offsets"][:nU]
    (gs, ge, pb, set_bounds, univ_of_pair, n_pairs_d, mp, mi) = \
        _assemble_jit(mk, ms, me, jnp.asarray(off_pad),
                      jnp.int32(dev["n_merged"]), jnp.int32(nU),
                      OUT=OUT, P_CAP=OUT, S_pad=dev["S_pad"],
                      nU_pad=nU_pad)
    dev.update(
        ivl_start=gs, ivl_end=ge, pair_bounds=pb, set_bounds=set_bounds,
        univ_of_pair=univ_of_pair,
        max_pairs_per_set=_next_pow2(int(mp)),
        max_ivls_per_set=_next_pow2(int(mi)))
    return dev


def instance_to_host(dev, perm, pid_of, n_candidates, rank_idx_cand,
                     n_rank_vals, cost_cand):
    """Read the merged intervals back and build the exact host
    SetCoverInstance the host pipeline would have built.

    One compact transfer (3 x int32 x n_merged); set ids are candidate
    ids (solver order is pid-ascending, so the relabeling preserves the
    sorted-by-pair invariant the solvers rely on).  The host lazy
    solver on this instance reproduces the host path bit for bit.
    """
    from catch_tpu.ops import set_cover as sc

    nU = dev["nU"]
    offsets = dev["offsets"]
    k, s, e = _unpack_merged(dev)
    pair_ids, pair_of_ivl = np.unique(k, return_inverse=True)
    solver_set_of_pair = (pair_ids // nU).astype(np.int64)
    univ_of_pair = (pair_ids % nU).astype(np.int32)
    set_of_pair = pid_of[perm[solver_set_of_pair]].astype(np.int32)
    g_start = s + offsets[k % nU]
    g_end = e + offsets[k % nU]

    rank_vals_dummy = int(n_rank_vals)
    cost = np.asarray(cost_cand, dtype=np.float32)
    rank_idx = np.asarray(rank_idx_cand, dtype=np.int32)
    return sc.SetCoverInstance(
        n_sets=n_candidates, n_universes=nU,
        u_size=dev["u_size_host"],
        can_uncover=dev["can_uncover_host"],
        ivl_start=g_start, ivl_end=g_end,
        pair_of_ivl=pair_of_ivl.astype(np.int32),
        set_of_pair=set_of_pair, univ_of_pair=univ_of_pair,
        cost=cost, rank_idx=rank_idx, n_rank_vals=rank_vals_dummy,
        u_len=int(offsets[-1]),
        pos_univ_offsets=offsets)


def _pad_to(x, width, fill):
    if x.shape[0] == width:
        return x
    pad = jnp.full((width - x.shape[0],), fill, jnp.int32)
    return jnp.concatenate([x, pad])
