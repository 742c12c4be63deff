"""End-to-end benchmark: full probe design on the Ebola test corpus.

Primary config: the complete design pipeline (candidate tiling ->
duplicate filter -> cover scan -> greedy multi-universe set cover) on
the first 175 genomes of the Zaire ebolavirus fixture with the
reference README's recommended hybridization model (-pl 100 -m 2 -l 60
-e 50) — the same workload as /root/reference/bin/design.py on the
same input.

Flu-scale config (BASELINE config #4; skipped with
CATCH_TPU_BENCH_FAST=1): the real design_large CLI path — large-tier
defaults, MinHash LSH near-duplicate filtering, cluster-and-design-
separately — on a seeded 10,000-genome influenza-A-like corpus (8
segments as 8 datasets, 135.9 Mbp, 12 subtype clades).  The recorded
reference-CATCH result on the identical corpus is in FLU_REF.

Scale config (also skipped with CATCH_TPU_BENCH_FAST=1): a synthetic
~51 Mbp corpus of 2,700 mutated genome copies run with MinHash
near-duplicate filtering + cluster-and-design-separately.

The bench needs a GPU: with no GPU visible it exits non-zero before any
phase, and any phase's exception ends the run with a non-zero exit.
Every JSON line names the device (platform, device_kind, count) and the
card's name and power limit as nvidia-smi reports them.

Prints the primary-metric JSON line immediately after the primary
config (flushed, so a later timeout cannot destroy it), then reprints
a superset of it after the scale config and after the accelerator
parity check — a consumer taking either the first or the last JSON
line gets the primary metric:
    {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, ...}

vs_baseline is the speedup (baseline_seconds / our_seconds) over the
reference CPU implementation measured on this host; see BASELINE_S
below.  NOTE the baseline caveat: this host has 2 CPUs, so the
reference ran with min(nCPU, 8) = 2 workers; on a typical 8-CPU box
the reference would be roughly 4x faster than BASELINE_S, i.e. divide
vs_baseline by ~4 for an 8-worker-normalized comparison.  Extra keys
report the north-star metrics from BASELINE.json (candidate pairs
evaluated/s, set-cover picks/s), a per-phase breakdown of the scan,
and the scale-config result.
"""

import json
import os
import sys
import time

# Reference CATCH wall-clock for the primary workload on this host,
# measured 2026-08-19 with:
#   PYTHONPATH=/root/reference python /root/reference/bin/design.py \
#     ebola175.fasta -o ref_175.fasta \
#     -pl 100 -m 2 -l 60 -e 50 --max-num-processes 8
# Host: 2 CPUs (the reference pool caps at min(nCPU, 8) = 2 workers).
# Result: 1621 s wall-clock, 163 probes (rc=0).  We emit 159 probes on
# the same input: exhaustive seeding finds strictly more true covers
# than the reference's Monte-Carlo k-mer sampling, so the greedy cover
# needs fewer probes (coverage parity is tested against the reference
# goldens in tests/test_reference_golden.py).
BASELINE_S = 1621.0
N_GENOMES = 175

# Scale corpus: SCALE_STRAINS diverged lineages (SCALE_STRAIN_MUT from
# the base genome, far beyond the cluster threshold) each with
# SCALE_COPIES_PER close variants (SCALE_COPY_MUT), mimicking a
# multi-subtype viral download: clustering should split by lineage and
# each cluster's design runs the batched device pipeline.
SCALE_STRAINS = 30
SCALE_COPIES_PER = 90
SCALE_STRAIN_MUT = 0.12
SCALE_COPY_MUT = 0.005


def run_primary():
    from catch_tpu.utils import seq_io
    from catch_tpu.filters.duplicate import DuplicateFilter
    from catch_tpu.filters.set_cover_filter import SetCoverFilter
    from catch_tpu.designer import ProbeDesigner

    genomes = seq_io.read_genomes_from_fasta(
        "tests/data/zaire_ebolavirus.fasta.gz")[:N_GENOMES]

    t0 = time.time()
    scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50)
    filters = [DuplicateFilter(), scf]
    designer = ProbeDesigner([genomes], filters, probe_length=100,
                             probe_stride=50)
    designer.design()
    elapsed = time.time() - t0
    return elapsed, len(designer.final_probes), \
        getattr(scf, "last_run_stats", {}) or {}, \
        getattr(scf, "_last_searcher", None)


# Flu-scale config (BASELINE config #4): design_large (large-tier
# defaults: -pl 100 -ps 50 -m 5 -e 50, MinHash LSH 0.6, cluster 0.15)
# on a seeded 10,000-genome influenza-A-like corpus — 8 segments as 8
# datasets (the reference convention for segmented species), ~13.6
# kb/genome, 12 subtype clades at ~12% divergence with ~2% within.
# Reference CATCH on the identical corpus and command
# (bin/design_large.py seg1..seg8 --max-num-processes 8) is measured
# out of band on this host; its result is recorded in FLU_REF below.
FLU_GENOMES = int(os.environ.get("CATCH_TPU_FLU_GENOMES", "10000"))
# Generated corpora live in the checkout (listed in .gitignore).
BENCH_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".bench_data")
FLU_DIR = os.path.join(BENCH_DATA, "flu%d" % FLU_GENOMES)
# Measured 2026-08-21: the reference was killed incomplete at its
# 3,600 s budget, still inside MinHash clustering of the 80,000
# sequences (quadratic connected-components DFS; it had not produced
# any candidate probes yet).
FLU_REF = {"status": "incomplete", "budget_s": 3600}


def run_flu10k():
    """BASELINE config #4 through the real design_large CLI path."""
    from catch_tpu.utils.synthetic import (influenza_like_segments,
                                           write_segment_fastas)
    from catch_tpu.utils import profiling
    from catch_tpu.cli import design

    segs, subtype_of = influenza_like_segments(n_genomes=FLU_GENOMES,
                                               seed=0)
    paths = write_segment_fastas(segs, subtype_of, FLU_DIR)
    total_bp = sum(s.size for s in segs)
    out_fasta = os.path.join(FLU_DIR, "probes_out.fasta")
    profiling.reset_phases()
    t0 = time.time()
    args = design.init_and_parse_args(
        args_type="large", argv=list(paths) + ["-o", out_fasta])
    design.main(args)
    elapsed = time.time() - t0
    with open(out_fasta) as f:
        n_probes = sum(1 for line in f if line.startswith(">"))
    return elapsed, n_probes, total_bp, profiling.snapshot_phases()


def run_scale():
    """Synthetic flu-scale corpus through the clustering+LSH pipeline."""
    import numpy as np
    from catch_tpu.utils import seq_io
    from catch_tpu.filters.near_duplicate import (
        NearDuplicateFilterWithMinHash)
    from catch_tpu.filters.set_cover_filter import SetCoverFilter
    from catch_tpu.designer import ProbeDesigner
    from catch_tpu.genome import Genome

    base_genome = seq_io.read_genomes_from_fasta(
        "tests/data/zaire_ebolavirus.fasta.gz")[0]
    base = np.frombuffer(base_genome.seqs[0].encode(), dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(0)

    def mutate(seq, rate):
        out = seq.copy()
        m = np.flatnonzero(rng.random(len(out)) < rate)
        out[m] = bases[rng.integers(0, 4, size=len(m))]
        return out

    genomes = []
    for _ in range(SCALE_STRAINS):
        strain = mutate(base, SCALE_STRAIN_MUT)
        for _ in range(SCALE_COPIES_PER):
            copy = mutate(strain, SCALE_COPY_MUT)
            genomes.append(Genome.from_one_seq(copy.tobytes().decode()))
    total_bp = sum(g.size() for g in genomes)

    t0 = time.time()
    scf = SetCoverFilter(mismatches=4, lcf_thres=80, cover_extension=50)
    designer = ProbeDesigner(
        [genomes], [NearDuplicateFilterWithMinHash(0.6), scf],
        probe_length=100, probe_stride=50,
        cluster_threshold=0.15, cluster_merge_after=scf,
        cluster_method="choose")
    designer.design()
    elapsed = time.time() - t0
    return elapsed, len(designer.final_probes), total_bp


# Solver-throughput config (BASELINE "set-cover iters/s" north star):
# one synthetic instance at production scale — 1,048,576 positions
# (128 universes x 8,192), 100,000 sets, ~4 intervals/set — solved by
# (a) the lazy-greedy host solver (the production route; runs to
# completion) and (b) the boundary-sum device solver (the
# device-resident route; timed over a bounded number of dispatches).
SOLVER_N_SETS = 100_000
SOLVER_N_UNIV = 128
SOLVER_U_LEN = 8192
SOLVER_DEV_DISPATCH = 4


def solver_instance():
    """The solver-throughput instance: (host SetCoverInstance, the
    deferred device dict the scan pipeline would have produced for it).
    """
    import numpy as np
    import jax.numpy as jnp
    from catch_tpu.ops import scan_instance, set_cover

    rng = np.random.default_rng(5)
    n_ivl = SOLVER_N_SETS * 4
    set_ids = np.repeat(np.arange(SOLVER_N_SETS), 4)
    univ_ids = rng.integers(0, SOLVER_N_UNIV, size=n_ivl)
    starts = rng.integers(0, SOLVER_U_LEN - 400, size=n_ivl)
    ends = starts + rng.integers(150, 400, size=n_ivl)
    inst = set_cover.build_instance_from_cover_arrays(
        set_ids, univ_ids, starts, ends, n_sets=SOLVER_N_SETS,
        n_universes=SOLVER_N_UNIV,
        universe_p=np.ones(SOLVER_N_UNIV))

    # Keys sorted by (set, universe); coordinates already global so
    # offsets are 0.
    def pow2(x):
        return 1 if x <= 1 else 1 << int(x - 1).bit_length()

    imax = np.iinfo(np.int32).max
    k = (inst.set_of_pair.astype(np.int64)[inst.pair_of_ivl]
         * SOLVER_N_UNIV
         + inst.univ_of_pair[inst.pair_of_ivl])
    OUT = pow2(len(k))

    def pad(x, fill):
        return jnp.asarray(np.concatenate(
            [x.astype(np.int64),
             np.full(OUT - len(x), fill, np.int64)]).astype(np.int32))

    S_pad = pow2(SOLVER_N_SETS + 1)
    nU_pad = pow2(SOLVER_N_UNIV + 1)
    cost_p = np.ones(S_pad, np.float32)
    rank_p = np.full(S_pad, inst.n_rank_vals, np.int32)
    rank_p[:SOLVER_N_SETS] = inst.rank_idx
    cu_p = np.zeros(nU_pad, np.int32)
    cu_p[:SOLVER_N_UNIV] = inst.can_uncover
    us_p = np.zeros(nU_pad, np.int32)
    us_p[:SOLVER_N_UNIV] = inst.u_size
    dev = dict(
        cost=jnp.asarray(cost_p), rank_idx=jnp.asarray(rank_p),
        can_uncover=jnp.asarray(cu_p), u_size=jnp.asarray(us_p),
        U_pad=pow2(inst.u_len), n_rank_vals=inst.n_rank_vals,
        S_pad=S_pad, nU_pad=nU_pad,
        merged=(pad(k, imax), pad(inst.ivl_start, 0),
                pad(inst.ivl_end, 0)),
        n_merged=len(k),
        offsets=np.zeros(SOLVER_N_UNIV + 1, np.int64),
        nU=SOLVER_N_UNIV)
    scan_instance.ensure_assembled(dev)
    return inst, dev


def run_solver_throughput():
    from catch_tpu.ops import set_cover

    inst, dev = solver_instance()
    t0 = time.time()
    order = set_cover._solve_host_lazy(inst)
    host_s = time.time() - t0
    res = {
        "positions": inst.u_len, "sets": SOLVER_N_SETS,
        "intervals": len(inst.ivl_start),
        "host_lazy_picks": len(order),
        "host_lazy_s": round(host_s, 2),
        "host_lazy_picks_per_s": round(len(order) / host_s, 1),
    }

    # Device boundary solver on the same instance: warm dispatch
    # (compile), then the timed bounded solve
    set_cover.solve_boundary_instance(dev, SOLVER_N_SETS, max_dispatches=1)
    t0 = time.time()
    dorder = set_cover.solve_boundary_instance(
        dev, SOLVER_N_SETS, max_dispatches=SOLVER_DEV_DISPATCH)
    dev_s = time.time() - t0
    res["device_boundary_picks"] = len(dorder)
    res["device_boundary_s"] = round(dev_s, 2)
    res["device_boundary_picks_per_s"] = round(
        len(dorder) / dev_s, 1) if dev_s > 0 else None
    return res


# Avoid-path background config (BASELINE config #3 analogue; opt-in
# with CATCH_TPU_BENCH_AVOID=1): the candidate ranks of an ebola
# design are computed against a synthetic 100 Mbp background FASTA
# streamed through the tolerant-model scan on BOTH strands (the
# reference streams human-scale FASTAs here,
# set_cover_filter.py:580-612).  Records bp/s and peak RSS.
AVOID_BG_BP = 100_000_000
AVOID_BG_CHROMS = 4


def run_avoid_background():
    import resource

    import numpy as np
    from catch_tpu.utils import seq_io
    from catch_tpu.filters.duplicate import DuplicateFilter
    from catch_tpu.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu.filters.set_cover_filter import SetCoverFilter

    bg_dir = BENCH_DATA
    os.makedirs(bg_dir, exist_ok=True)
    bg_path = os.path.join(
        bg_dir, "background_%dmbp.fasta" % (AVOID_BG_BP // 10**6))
    genomes = seq_io.read_genomes_from_fasta(
        "tests/data/zaire_ebolavirus.fasta.gz")[:8]
    if not os.path.exists(bg_path):
        rng = np.random.default_rng(11)
        bases = np.frombuffer(b"ACGT", dtype=np.uint8)
        per = AVOID_BG_BP // AVOID_BG_CHROMS
        # Plant a few ebola fragments per chromosome so the scan has
        # true positives to find (validates detection, not just
        # throughput over random sequence)
        frag_src = genomes[0].seqs[0]
        with open(bg_path + ".tmp", "w") as f:
            for c in range(AVOID_BG_CHROMS):
                chrom = bases[rng.integers(0, 4, size=per)]
                for _ in range(5):
                    fs = int(rng.integers(0, len(frag_src) - 500))
                    frag = np.frombuffer(
                        frag_src[fs:fs + 500].encode(), dtype=np.uint8)
                    at = int(rng.integers(0, per - 500))
                    chrom[at:at + 500] = frag
                f.write(">bgchrom%d\n" % c)
                f.write(chrom.tobytes().decode())
                f.write("\n")
        os.replace(bg_path + ".tmp", bg_path)
    cands = DuplicateFilter()._filter(
        make_candidate_probes_from_sequences(
            [s for g in genomes for s in g.seqs],
            probe_length=100, probe_stride=50))
    scf = SetCoverFilter(mismatches=2, lcf_thres=60,
                         cover_extension=50,
                         avoided_genomes=[bg_path])
    t0 = time.time()
    ranks = scf._make_ranks(cands, [genomes])
    elapsed = time.time() - t0
    scanned_bp = AVOID_BG_BP * 2   # both strands
    return {
        "background_bp": AVOID_BG_BP,
        "strands": 2,
        "n_candidates": len(cands),
        "n_flagged": int(np.sum(ranks > ranks.min())),
        "seconds": round(elapsed, 2),
        "bp_per_s": int(scanned_bp / elapsed),
        "peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024,
    }


# Expected probe-set hash of ACCEL_PARITY_CONFIG on the CPU host path
# (188 probes).  The design is deterministic, so this is a committed
# golden rather than a live CPU run (which costs ~60 s of the bench
# budget); tests/test_accelerator.py::test_parity_hash_current asserts
# the CPU host path still produces it, so drift is caught by the suite.
ACCEL_PARITY_CONFIG = dict(n_genomes=8, mismatches=2, lcf_thres=60,
                           cover_extension=30, probe_length=100,
                           probe_stride=50)
ACCEL_PARITY_SHA = \
    "db4e9fa9db4f4ee5d8370375ff5b3723e4d2fec5e7f9d2a274b4299b"


def accel_parity_hash(instance_mode=None):
    """Probe-set hash of the parity config; mode 'force' runs the
    device-resident pipeline, 'host' the host path."""
    import hashlib

    from catch_tpu.utils import seq_io
    from catch_tpu.filters.duplicate import DuplicateFilter
    from catch_tpu.filters.set_cover_filter import SetCoverFilter
    from catch_tpu.designer import ProbeDesigner

    cfg = ACCEL_PARITY_CONFIG
    prev = os.environ.get("CATCH_TPU_INSTANCE")
    if instance_mode is not None:
        os.environ["CATCH_TPU_INSTANCE"] = instance_mode
    try:
        g = seq_io.read_genomes_from_fasta(
            "tests/data/zaire_ebolavirus.fasta.gz")[:cfg["n_genomes"]]
        scf = SetCoverFilter(mismatches=cfg["mismatches"],
                             lcf_thres=cfg["lcf_thres"],
                             cover_extension=cfg["cover_extension"])
        d = ProbeDesigner([g], [DuplicateFilter(), scf],
                          probe_length=cfg["probe_length"],
                          probe_stride=cfg["probe_stride"])
        d.design()
        ps = sorted(p.seq_str for p in d.final_probes)
        return hashlib.sha224("".join(ps).encode()).hexdigest(), len(ps)
    finally:
        if instance_mode is not None:
            if prev is None:
                os.environ.pop("CATCH_TPU_INSTANCE", None)
            else:
                os.environ["CATCH_TPU_INSTANCE"] = prev


def run_accel_parity():
    """Small design through the device-resident pipeline on the real
    accelerator, checked against the committed CPU-host golden.

    The pytest suite pins JAX to CPU; this and chip_smoke.py check
    the device pipeline's output on the card.
    """
    got, n = accel_parity_hash(instance_mode="force")
    if n == 0:
        return "no-probes"
    return "ok" if got == ACCEL_PARITY_SHA else \
        "MISMATCH: %s != %s" % (got[:12], ACCEL_PARITY_SHA[:12])


def device_info():
    """The device as JAX reports it: platform, kind and count."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_info():
    """Name and power limit of each card, as nvidia-smi reports them
    (the limit bounds the clocks a card holds under load)."""
    import subprocess
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except OSError as e:
        return "nvidia-smi unavailable: %s" % e
    return "; ".join(x.strip() for x in r.stdout.splitlines()
                     if x.strip()) or r.stderr.strip()


def main():
    dev = device_info()
    if dev["platform"] != "gpu":
        print("bench.py measures the GPU, but JAX found no GPU "
              "(platform %r)" % dev["platform"], file=sys.stderr)
        return 1
    from catch_tpu.utils.profiling import enable_compilation_cache
    enable_compilation_cache()
    from catch_tpu.utils.timeout import TimeoutException, time_limit

    # Wall-clock budget for the whole bench: everything after the
    # primary config runs under what remains of it, so partial results
    # always survive.  A phase that runs out of budget is recorded and
    # makes the run exit non-zero; any other exception ends the run.
    budget = float(os.environ.get("CATCH_TPU_BENCH_BUDGET", "2100"))
    t_start = time.time()
    failed = False

    # The primary config runs twice: the first run of the process
    # includes compilation or persistent-cache loads (the one-shot CLI
    # experience, see README "Cold starts"), the second is warm.
    elapsed, n_probes, stats, searcher = run_primary()
    runs = [round(elapsed, 2)]
    e2, n2, s2, sr2 = run_primary()
    runs.append(round(e2, 2))
    if e2 < elapsed:
        elapsed, n_probes, stats, searcher = e2, n2, s2, sr2
    vs = (BASELINE_S / elapsed) if BASELINE_S else None
    out = {
        "metric": "ebola175_design_e2e_pl100_m2_l60_e50",
        "value": round(elapsed, 2),
        "unit": "s",
        "vs_baseline": round(vs, 2) if vs else None,
        "value_runs": runs,
        "primary_cold_s": runs[0],
        "primary_warm_s": round(min(runs[1:]), 2),
        "n_probes": n_probes,
        "baseline_s": BASELINE_S,
        "baseline_cpus": 2,
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "n_devices": dev["count"],
        "card": card_info(),
    }
    if stats.get("candidates_evaluated") and stats.get("scan_seconds"):
        out["candidates_per_s"] = int(
            stats["candidates_evaluated"] / stats["scan_seconds"])
    if stats.get("set_cover_picks") and stats.get("solve_seconds"):
        out["set_cover_picks_per_s"] = round(
            stats["set_cover_picks"] / stats["solve_seconds"], 1)
    for key in ("scan_seconds", "solve_seconds"):
        if key in stats:
            out[key] = round(stats[key], 2)
    # Which scan route ran: groups on the device pipeline / on the
    # host-instance route (chosen by corpus size)
    if stats.get("groups_device") is not None:
        out["scan_route"] = "%dd/%dh" % (stats["groups_device"],
                                         stats["groups_host"])
    phases = (searcher.stats.get("phase_seconds", {})
              if searcher is not None else {})
    if phases:
        out["scan_phases"] = {k: round(v, 2) for k, v in phases.items()}

    # The primary metric is unloseable: print + flush it NOW.  Later
    # prints are supersets of this line; a consumer taking either the
    # first or the last JSON line gets the primary metric.
    print(json.dumps(out), flush=True)

    if not os.environ.get("CATCH_TPU_BENCH_FAST"):
        # Flu-scale headline (BASELINE config #4) — one run (the
        # corpus is 135 Mbp; the budget cannot fit a best-of-N).
        from catch_tpu.utils import profiling
        left = budget - (time.time() - t_start)
        if left < 420:
            out["flu10k_skipped"] = "budget (%.0f s left)" % left
        else:
            try:
                with time_limit(int(left - 240)):
                    f_el, f_probes, f_bp, f_phases = run_flu10k()
                out["flu10k_metric"] = \
                    "flu10k_design_large_8seg_m5_e50_lsh_cluster"
                out["flu10k_seconds"] = round(f_el, 2)
                out["flu10k_bp"] = f_bp
                out["flu10k_n_probes"] = f_probes
                out["flu10k_bp_per_s"] = int(f_bp / f_el)
                # NB: filter phases are cumulative BUSY time across
                # the group-pipeline threads, so they sum past
                # wall-clock when stages overlap (by design)
                out["flu10k_phases"] = f_phases
                out["flu10k_reference"] = FLU_REF
            except TimeoutException:
                out["flu10k_error"] = "timeout (%.0f s left)" % left
                failed = True
        print(json.dumps(out), flush=True)

        left = budget - (time.time() - t_start)
        if left < 240:
            out["scale_skipped"] = "budget (%.0f s left)" % left
        else:
            try:
                profiling.reset_phases()
                with time_limit(int(left - 60)):
                    s_elapsed, s_probes, s_bp = run_scale()
                out["scale_phases"] = profiling.snapshot_phases()
                out["scale_metric"] = "synthetic51mbp_cluster_lsh_design"
                out["scale_seconds"] = round(s_elapsed, 2)
                out["scale_bp"] = s_bp
                out["scale_n_probes"] = s_probes
                out["scale_bp_per_s"] = int(s_bp / s_elapsed)
            except TimeoutException:
                out["scale_error"] = "timeout (budget %.0f s)" % left
                failed = True
        print(json.dumps(out), flush=True)

        if os.environ.get("CATCH_TPU_BENCH_AVOID"):
            try:
                with time_limit(900):
                    out["avoid_background"] = run_avoid_background()
            except TimeoutException:
                out["avoid_background"] = {"error": "timeout"}
                failed = True
            print(json.dumps(out), flush=True)

        left = budget - (time.time() - t_start)
        if left < 180:
            out["solver_skipped"] = "budget (%.0f s left)" % left
        else:
            try:
                with time_limit(int(min(left - 90, 420))):
                    out["solver_throughput"] = run_solver_throughput()
            except TimeoutException:
                out["solver_throughput"] = {"error": "timeout"}
                failed = True
        print(json.dumps(out), flush=True)

        left = budget - (time.time() - t_start)
        if left < 60:
            out["accel_parity"] = "skipped: budget"
        else:
            try:
                with time_limit(int(min(left - 20, 600))):
                    out["accel_parity"] = run_accel_parity()
            except TimeoutException:
                out["accel_parity"] = "timeout"
            failed = failed or out["accel_parity"] != "ok"
        print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
