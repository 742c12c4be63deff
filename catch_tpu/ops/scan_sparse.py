"""Sparse batched cover scan: corpus-wide k-mer join + device verify.

The corpus-scale replacement for the reference's per-sequence
process-pool scan (/root/reference/catch/probe.py:1008-1271).  A dense
scan would evaluate O(corpus_bp x probes x probe_len) cells over *all*
alignments, but real candidate pairs are sparse (~1 per corpus position
on viral panels), so the scan is reformulated sparsely:

1. All sequences are concatenated into one PAD-separated array (gap =
   Lmax, so k-mers never span sequences and every alignment maps to a
   unique sequence via searchsorted over sequence ends).
2. One corpus-wide exhaustive k-mer join against the probe seed table
   (vectorized numpy; slabbed to bound host memory) yields candidate
   (probe, alignment) pairs — the equivalent of the reference's k-mer
   hash map, deterministic and with recall >= its Monte-Carlo sampling.
3. Phase 2 runs on device in fixed-size candidate chunks: each chunk
   gathers its sequence/probe windows from device-resident tensors,
   derives the exact match vector, builds sentinel-padded mismatch
   positions with a row-wise sort, and enumerates all maximal
   <=K-mismatch windows containing a >=seed_req exact run — the same
   window math as ops/cover.py's host verify, bit-for-bit
   (parity-tested in tests/test_cover.py).  Qualifying spans are
   extracted with a static cap; true counts are returned so the host
   retries an overflowing chunk with a doubled cap.

The fast path (lcf >= probe length with pigeonhole seeding or zero
mismatches) skips the window math per candidate and emits the clamped
overlap iff the match count passes the phase-1 predicate, matching
ops/cover.py's per-sequence fast path.

Scratch is bounded by the chunk size (~350 MB at C=128k, L=100),
independent of corpus size.
"""

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp

from catch_tpu.utils.profiling import maybe_trace

logger = logging.getLogger(__name__)

__all__ = ["scan_corpus_sparse"]

# Candidates verified per device dispatch.  Peak scratch ~ C * (L+K+2)
# int32 * ~6 arrays (~350 MB at C=2**17, L=100), independent of corpus
# size.
_CHUNK = 1 << 17

# Hash/join slab width (positions per slab) bounding host memory for
# the corpus-wide rolling hash (u64 hashes = 8 B/position).
_JOIN_SLAB = 1 << 24

# Raw join hits expanded per device dispatch (bounds device scratch for
# the expansion+sort+dedup kernel: ~6 int32 arrays of this length).
_EXPAND_SLAB = 1 << 26


def _verify_core(mega, probe_codes_flat, pg, start, poff0, ov, thres,
                 n_seq, k_seed, *, L, K, C, cap, seed_req, fast_ok):
    """Traced body of the candidate verification (see _verify_chunk).

    mega: (mega_len + L,) uint8 codes (0 = PAD; L tail pad)
    probe_codes_flat: (P, L) uint8
    pg/start/poff0/ov/thres/n_seq: (C,) int32 per candidate —
        global probe id, clipped span start (mega coords), offset of
        `start` into the probe, overlap length, effective lcf
        threshold, owning-sequence length.  Padded candidates have
        ov = thres = 0 and never qualify.
    k_seed: int32 scalar

    Returns (sp_p, sp_s, sp_e, ok, nq): span buffers (first entries
    where ok=True are valid), plus the true qualifying-window count
    for overflow detection (nq > cap => retry with a bigger cap).
    """
    jL = jnp.arange(L, dtype=jnp.int32)
    t_cols = L + 1

    # Alignment-relative window: position i compares mega[a+i] against
    # probe[i] with the clipped overlap [i_lo, i_hi) as the validity
    # band, so the probe side is a plain row gather (the start-relative
    # form needs a per-element take_along_axis shift).  a >= 0 because
    # the corpus leading pad is >= L-1 and candidates overlap their
    # sequence.
    a = start - poff0
    i_lo = poff0
    i_hi = poff0 + ov
    abase = jnp.clip(a, 0, mega.shape[0] - L)
    seq_vals = mega[abase[:, None] + jL[None, :]]              # (C, L)
    probe_vals = probe_codes_flat[pg]
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
    # Sentinel-padded sorted mismatch positions: P[c,0] = i_lo - 1,
    # P[c,1+r] = position of the r-th mismatch, rest = i_hi.  Built
    # with a row-wise sort rather than a (C, L) rank scatter.
    big = jnp.int32(1 << 30)
    sv = jnp.sort(jnp.where(mism, jL[None, :], big), axis=1)
    body = jnp.concatenate(
        [sv, jnp.full((C, K + 1), big, jnp.int32)], axis=1)[:, :L + K + 1]
    body = jnp.where(body >= big, i_hi[:, None], body)
    P = jnp.concatenate(
        [(i_lo - 1)[:, None], body], axis=1)

    lenW = P[:, K + 1:K + 1 + t_cols] - P[:, :t_cols] - 1
    runs = P[:, 1:] - P[:, :-1] - 1
    seedmax = runs[:, :t_cols]
    for s in range(1, K + 1):
        seedmax = jnp.maximum(seedmax, runs[:, s:s + t_cols])
    tq = jnp.arange(t_cols, dtype=jnp.int32)
    qual = ((tq[None, :] <= nm[:, None]) & (lenW >= thres[:, None])
            & (seedmax >= seed_req) & (thres[:, None] > 0))
    if fast_ok:
        qual = jnp.where(is_fast[:, None],
                         (tq[None, :] == 0) & qual_fast[:, None], qual)

    nq = jnp.sum(qual, dtype=jnp.int32)
    rows, ts = jnp.nonzero(qual, size=cap, fill_value=-1)
    ok = rows >= 0
    rc = jnp.maximum(rows, 0)
    tc = jnp.maximum(ts, 0)
    if fast_ok:
        sp_s = jnp.where(is_fast[rc], start[rc],
                         P[rc, tc] + 1 + a[rc])
        sp_e = jnp.where(is_fast[rc], start[rc] + ov[rc],
                         P[rc, tc + K + 1] + a[rc])
    else:
        sp_s = P[rc, tc] + 1 + a[rc]
        sp_e = P[rc, tc + K + 1] + a[rc]
    return pg[rc], sp_s, sp_e, ok, nq


_verify_chunk = functools.partial(
    jax.jit, static_argnames=("L", "K", "C", "cap", "seed_req",
                              "fast_ok"))(_verify_core)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "L", "K", "C_loc", "cap_loc", "seed_req",
                     "fast_ok"))
def _verify_chunk_sharded(mega, probe_codes_flat, pg, start, poff0, ov,
                          thres, n_seq, k_seed, *, mesh, L, K, C_loc,
                          cap_loc, seed_req, fast_ok):
    """Data-parallel verification over a device mesh.

    The candidate axis is sharded (each device verifies C_loc
    candidates against the replicated corpus + probe tensors — the
    device form of the reference's per-range scan fan-out,
    /root/reference/catch/probe.py:1230-1257); no collectives are
    needed because candidates are independent.  Outputs keep the shard
    axis: (n_dev, cap_loc) span buffers and (n_dev,) counts.
    """
    from jax.sharding import PartitionSpec as P

    def body(mega, codes, pg, start, poff0, ov, thres, n_seq, k_seed):
        sp_p, sp_s, sp_e, ok, nq = _verify_core(
            mega, codes, pg, start, poff0, ov, thres, n_seq, k_seed,
            L=L, K=K, C=C_loc, cap=cap_loc, seed_req=seed_req,
            fast_ok=fast_ok)
        return sp_p[None], sp_s[None], sp_e[None], ok[None], nq[None]

    sh = P("d")
    repl = P()
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(repl, repl, sh, sh, sh, sh, sh, sh, repl),
        out_specs=(sh, sh, sh, sh, sh),
        check_vma=False,
    )(mega, probe_codes_flat, pg, start, poff0, ov, thres, n_seq, k_seed)


@functools.partial(jax.jit, static_argnames=("T", "S", "cap"))
def _expand_join_jit(lo, cnt, pos_seq, total, join_p, join_pos,
                     *, T, S, cap):
    """Expand (bucket lo, count) join hits to deduplicated (p, a) pairs.

    The device form of the join's hot loop: raw hits (tens to hundreds
    of millions on conserved corpora — each candidate pair shares ~15
    selected minimizers) are materialized, gathered, sorted, and
    deduplicated entirely on device; only the deduplicated pairs return
    to the host.

    lo/cnt/pos_seq: (S,) int32 bucket starts / sizes / query positions
        (cnt == 0 padding allowed; boundary scatters use add, which
        telescopes across empty buckets)
    total: int32 true number of hits (= sum(cnt) over real entries)
    join_p/join_pos: probe table columns, int32
    T: static hit capacity (>= total); S, cap: static shapes

    Returns (p, a, ok, n_pairs): deduplicated pairs in the first
    entries where ok is True; n_pairs > cap signals overflow.
    """
    csum = jnp.cumsum(cnt)
    # Table index per hit via one scatter + cumsum (see the host mirror
    # in ProbeSearcher._join_pairs).
    step = jnp.ones((T,), jnp.int32)
    step = step.at[0].set(lo[0])
    step = step.at[csum[:-1]].add(lo[1:] - lo[:-1] - cnt[:-1],
                                  mode="drop")
    idx = jnp.cumsum(step)
    step2 = jnp.zeros((T,), jnp.int32)
    step2 = step2.at[0].set(pos_seq[0])
    step2 = step2.at[csum[:-1]].add(pos_seq[1:] - pos_seq[:-1],
                                    mode="drop")
    pos_rep = jnp.cumsum(step2)

    t = jnp.arange(T, dtype=jnp.int32)
    valid = t < total
    idx = jnp.clip(idx, 0, join_p.shape[0] - 1)
    p = jnp.where(valid, join_p[idx], jnp.int32(np.iinfo(np.int32).max))
    a = jnp.where(valid, pos_rep - join_pos[idx], 0)
    p_s, a_s = jax.lax.sort((p, a), num_keys=2)
    first = jnp.concatenate([
        jnp.ones((1,), bool),
        (p_s[1:] != p_s[:-1]) | (a_s[1:] != a_s[:-1])])
    keep = first & (t < total)  # sorted: valids occupy the front
    n_pairs = jnp.sum(keep, dtype=jnp.int32)
    rows = jnp.nonzero(keep, size=cap, fill_value=-1)[0]
    ok = rows >= 0
    rc = jnp.maximum(rows, 0)
    return p_s[rc], a_s[rc], ok, n_pairs


def _device_join(searcher, pos_seq, hs):
    """Expansion + dedup of join hits on device, slabbed by hit count.

    pos_seq/hs: selected query positions and their hashes (host arrays).
    Returns deduplicated (p, a) int64 arrays (deduplicated per slab;
    cross-slab duplicates are impossible because slabs partition query
    positions and a pair's hits from one shared region span < Lmax
    positions... they are possible at slab edges, so a final host-side
    unique runs only when there is more than one slab).
    """
    lo = np.searchsorted(searcher._join_h, hs, side="left")
    hi = np.searchsorted(searcher._join_h, hs, side="right")
    cnt = (hi - lo).astype(np.int64)
    nz = cnt > 0
    lo, cnt, pos_seq = lo[nz], cnt[nz], pos_seq[nz]
    if len(lo) == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    csum_all = np.cumsum(cnt)
    total_all = int(csum_all[-1])

    join_p_dev = jnp.asarray(searcher._join_p.astype(np.int32))
    join_pos_dev = jnp.asarray(searcher._join_pos.astype(np.int32))

    # Slab boundaries on the query axis so each slab expands at most
    # _EXPAND_SLAB hits.
    bounds = [0]
    while csum_all[-1] - (csum_all[bounds[-1] - 1] if bounds[-1] else 0) \
            > _EXPAND_SLAB:
        base = csum_all[bounds[-1] - 1] if bounds[-1] else 0
        nxt = int(np.searchsorted(csum_all, base + _EXPAND_SLAB,
                                  side="right"))
        nxt = max(nxt, bounds[-1] + 1)
        bounds.append(nxt)
    bounds.append(len(lo))

    out_p, out_a = [], []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        if b0 == b1:
            continue
        base = csum_all[b0 - 1] if b0 else 0
        total = int(csum_all[b1 - 1] - base)
        S = _next_pow2(b1 - b0)
        T = _next_pow2(max(total, 1))
        cap = _next_pow2(max(total // 4, 1 << 12))
        lo_p = np.zeros(S, np.int32)
        cnt_p = np.zeros(S, np.int32)
        pos_p = np.zeros(S, np.int32)
        lo_p[:b1 - b0] = lo[b0:b1]
        cnt_p[:b1 - b0] = cnt[b0:b1]
        pos_p[:b1 - b0] = pos_seq[b0:b1]
        while True:
            p, a, ok, n_pairs = _expand_join_jit(
                jnp.asarray(lo_p), jnp.asarray(cnt_p), jnp.asarray(pos_p),
                jnp.int32(total), join_p_dev, join_pos_dev,
                T=T, S=S, cap=cap)
            n = int(n_pairs)
            if n <= cap:
                break
            cap = _next_pow2(n)
        # Valid pairs occupy the first n rows (nonzero emits ascending
        # row indices before the fill), so transfer exactly n entries —
        # device->host readback is the scan's scarcest resource.
        out_p.append(np.asarray(p[:n]).astype(np.int64))
        out_a.append(np.asarray(a[:n]).astype(np.int64))
    p = np.concatenate(out_p)
    a = np.concatenate(out_a)
    if len(bounds) > 2:
        # A pair found from minimizers in two different slabs appears
        # once per slab; dedup across slabs.
        key = np.unique(p * np.int64(1 << 34) + a)
        p, a = key >> np.int64(34), key & np.int64((1 << 34) - 1)
    return p, a


def _join_corpus(searcher, mega_codes):
    """Corpus-wide k-mer join: minimizer selection on the host (slabbed
    to bound the u64 hash memory), expansion + dedup on device.

    Returns deduplicated (probe_idx, alignment) int64 arrays in mega
    coordinates.
    """
    import os

    n = len(mega_codes)
    k = searcher.k_seed
    if os.environ.get("CATCH_TPU_JOIN") == "host":
        return _join_corpus_host(searcher, mega_codes)
    if getattr(searcher, "_join_h", None) is None:
        searcher._build_join_table()
    kj, w = searcher._join_params()
    pos_parts, hash_parts = [], []
    for s0 in range(0, n, _JOIN_SLAB):
        s1 = min(n, s0 + _JOIN_SLAB)
        # Overlap of k_seed codes so every minimizer window *starting*
        # in [s0, s1] is fully contained in some slab (window needs
        # codes q .. q + w + kj - 2, and kj + w - 1 == k_seed).  Window
        # argmins are window-local decisions, so the union of the
        # slabs' selections equals the unslabbed selection.  Windows
        # starting exactly in the overlap [s1, s1 + w) are evaluated by
        # both this slab and the next; the duplicated selected
        # positions yield duplicated join hits, which the pair dedup
        # removes.  (Do NOT mask the overlap positions out instead: a
        # position in [s1, s1 + w) whose only selecting window starts
        # before s1 is owned by no later slab, and masking it loses
        # recall.)
        h, ok = searcher._rolling_hashes(
            mega_codes[None, s0:min(n, s1 + k)], k=kj)
        sel = searcher._minimizer_select(h, ok, w)
        pos = np.flatnonzero(sel[0])
        pos_parts.append(pos + s0)
        hash_parts.append(h[0][pos])
    pos_seq = np.concatenate(pos_parts)
    hs = np.concatenate(hash_parts)
    if len(pos_seq) == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    return _device_join(searcher, pos_seq, hs)


def _join_corpus_host(searcher, mega_codes):
    """Host mirror of _join_corpus (CATCH_TPU_JOIN=host; also the
    shape the per-sequence path uses via ProbeSearcher._join_pairs)."""
    n = len(mega_codes)
    k = searcher.k_seed
    if n <= _JOIN_SLAB:
        return searcher._join_pairs(mega_codes)
    ps, as_ = [], []
    for s0 in range(0, n, _JOIN_SLAB):
        s1 = min(n, s0 + _JOIN_SLAB)
        p, a = searcher._join_pairs(mega_codes[s0:min(n, s1 + k)])
        ps.append(p)
        as_.append(a + s0)
    p = np.concatenate(ps)
    a = np.concatenate(as_)
    span = np.int64(n + searcher.Lmax)
    key = np.unique(p * span + (a + searcher.Lmax - 1))
    p = key // span
    a = key % span - (searcher.Lmax - 1)
    return p, a


def scan_corpus_sparse(searcher, sequences):
    """Scan `sequences` (list of str) against searcher's probes.

    Returns (probe_idx, seq_idx, start, end) int64 arrays of unmerged
    cover spans in per-sequence local coordinates, or None if this
    workload cannot run on the batched path (custom model, or corpus
    too large for int32 device coordinates).
    """
    from catch_tpu.ops import encode

    model = searcher.model
    if model.custom_fn is not None or searcher.K_static is None:
        return None
    L = searcher.Lmax
    K = int(searcher.K_static)
    k_seed = int(searcher.k_seed)
    island = model.island_of_exact_match
    seed_req = max(k_seed, island) if island > 0 else k_seed

    # Mega array: [L pad][seq0][L pad][seq1]...[L tail pad]
    n_seqs = len(sequences)
    seq_lens = np.array([len(s) for s in sequences], dtype=np.int64)
    starts = np.empty(n_seqs, dtype=np.int64)
    pos = L
    for i, ln in enumerate(seq_lens):
        starts[i] = pos
        pos += int(ln) + L
    total = pos
    if total + L > np.iinfo(np.int32).max:
        return None
    mega = np.zeros(total + L, dtype=np.uint8)
    for i, s in enumerate(sequences):
        mega[starts[i]:starts[i] + seq_lens[i]] = searcher.alphabet.encode(
            encode.encode_bytes(s))
    ends = starts + seq_lens

    with maybe_trace("cover_scan_join"):
        p, a = _join_corpus(searcher, mega[:total])
    empty = tuple(np.empty(0, dtype=np.int64) for _ in range(4))
    if len(p) == 0:
        return empty

    # Sparse phase-1 predicate in mega coordinates (gap = L guarantees
    # each alignment window touches exactly one sequence).
    sid = np.searchsorted(ends, a, side="right")
    sid = np.minimum(sid, n_seqs - 1)
    s_lo = starts[sid]
    s_hi = ends[sid]
    plens = searcher.probe_lens[p].astype(np.int64)
    st = np.maximum(s_lo, a)
    en = np.minimum(s_hi, a + plens)
    ov = en - st
    n_seq = s_hi - s_lo
    thres = np.minimum(np.minimum(searcher.lcf_static, plens), n_seq)
    keep = (ov >= np.maximum(thres, k_seed)) & (thres > 0)
    if not np.any(keep):
        return empty
    p, a, st, ov, thres, n_seq = (
        x[keep] for x in (p, a, st, ov, thres, n_seq))
    searcher.stats["candidates"] += len(p)

    # Device-resident corpus + probe tensors
    mega_dev = jnp.asarray(mega)
    codes_dev = jnp.asarray(searcher.probe_codes)

    mesh = getattr(searcher, "mesh", None)
    n_dev = mesh.devices.size if mesh is not None else 1
    if n_dev > 1:
        C_loc = min(_CHUNK, max(1 << 10,
                                _next_pow2(-(-len(p) // n_dev))))
        C = C_loc * n_dev
    else:
        C_loc = C = min(_CHUNK, max(1 << 10, _next_pow2(len(p))))
    cap0 = 2 * C_loc

    def dispatch(sl, cap_loc):
        args = (
            mega_dev, codes_dev,
            jnp.asarray(_pad_i32(p[sl], C)),
            jnp.asarray(_pad_i32(st[sl], C)),
            jnp.asarray(_pad_i32(st[sl] - a[sl], C)),
            jnp.asarray(_pad_i32(ov[sl], C)),
            jnp.asarray(_pad_i32(thres[sl], C)),
            jnp.asarray(_pad_i32(n_seq[sl], C)),
            jnp.int32(k_seed))
        if n_dev > 1:
            return _verify_chunk_sharded(
                *args, mesh=mesh, L=L, K=K, C_loc=C_loc, cap_loc=cap_loc,
                seed_req=seed_req, fast_ok=searcher.fast_ok)
        return _verify_chunk(
            *args, L=L, K=K, C=C, cap=cap_loc, seed_req=seed_req,
            fast_ok=searcher.fast_ok)

    # Dispatch every chunk before reading any result back: JAX queues
    # the kernels asynchronously, so chunk i+1 computes while chunk i
    # transfers (the readback is the only sync point per chunk).
    slices = [slice(c0, min(c0 + C, len(p)))
              for c0 in range(0, len(p), C)]
    with maybe_trace("cover_scan_verify"):
        pending = [dispatch(sl, cap0) for sl in slices]
    # Valid spans occupy a contiguous prefix of each (per-device) span
    # buffer, so slice on device and issue ONE readback per output
    # array at exactly the qualifying-span size (device->host transfers
    # cross the host link).
    dev_p, dev_s, dev_e = [], [], []
    for sl, (sp_p, sp_s, sp_e, ok, nq) in zip(slices, pending):
        nq_arr = _to_host(nq).reshape(-1)
        cap = cap0
        while int(nq_arr.max()) > cap:  # rare overflow: retry, bigger cap
            cap = _next_pow2(int(nq_arr.max()))
            sp_p, sp_s, sp_e, ok, nq = dispatch(sl, cap)
            nq_arr = _to_host(nq).reshape(-1)
        if int(nq_arr.max()) == 0:
            continue
        if sp_p.ndim == 1:
            n_q = int(nq_arr[0])
            dev_p.append(sp_p[:n_q])
            dev_s.append(sp_s[:n_q])
            dev_e.append(sp_e[:n_q])
        else:
            if not sp_p.is_fully_addressable:
                # The mesh spans processes: every process gathers the
                # whole span buffers and slices them on the host.
                sp_p, sp_s, sp_e = (_to_host(x) for x in (sp_p, sp_s, sp_e))
            for d in range(sp_p.shape[0]):
                n_d = int(nq_arr[d])
                if n_d:
                    dev_p.append(sp_p[d, :n_d])
                    dev_s.append(sp_s[d, :n_d])
                    dev_e.append(sp_e[d, :n_d])
    if not dev_p:
        return empty
    sp_p, sp_s, sp_e = (_concat_to_host(x) for x in (dev_p, dev_s, dev_e))
    sidx = np.searchsorted(ends, sp_s, side="right")
    sidx = np.minimum(sidx, n_seqs - 1)
    return (sp_p, sidx.astype(np.int64),
            sp_s - starts[sidx], sp_e - starts[sidx])


def _to_host(x):
    """Host copy of a device array; an array sharded over a mesh that
    spans processes is gathered from every process (a collective: all
    processes call it in the same order)."""
    if x.is_fully_addressable:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _concat_to_host(parts):
    """int64 host concatenation of span pieces: one readback when they
    are device arrays, none when they were gathered already."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts).astype(np.int64)
    return np.asarray(jnp.concatenate(parts)).astype(np.int64)


def _pad_i32(x, C):
    out = np.zeros(C, dtype=np.int32)
    out[:len(x)] = x
    return out


def _next_pow2(x):
    return 1 if x <= 1 else 1 << int(x - 1).bit_length()
