"""Smoke test of the probe-design path on NVIDIA GPUs.

Usage, from the root of a checkout:

    python chip_smoke.py                 # one card: phases 1-5
    python chip_smoke.py --four-cards    # the multi-card path on 4 cards

Every phase drives the user's entry points in this one process
(``design.main(design.init_and_parse_args(...))`` and the
analyze_probe_coverage CLI) at real data sizes, on device programs
compiled for the card, and compares what comes out with a plain
reference, with zero tolerance:

1. ebola175 design (first 175 genomes of the Zaire ebolavirus fixture,
   3.3 Mbp, ``-pl 100 -m 2 -l 60 -e 50``) through the device scan
   pipeline; the probe set must equal EBOLA175_SHA, made by the
   per-sequence numpy engine and the host solver.  Prints
   ``memory_analysis()`` of the verify and merge programs at this run's
   shapes and the card's peak memory.
2. The reference goldens (tests/data/golden) with the device pipeline
   forced, and bench.run_accel_parity().
3. Coverage analysis of the phase-1 probes over the 175 genomes (the
   sparse scan pipeline); its TSV must equal the numpy engine's.
4. design_large on a seeded influenza-like corpus (FLU_GENOMES genomes,
   8 segments); the probe set must equal FLU_SHA.  The clustering
   kernel's adjacency codes and the device MinHash signatures must
   equal their host estimators.
5. The device set-cover solvers: pick orders equal the host solvers'.

Each phase prints its verdict with its cold (first) and warm (second)
wall-clock beside the card's name and power limit.  Any failed phase
makes the script exit non-zero.  With no GPU visible it exits non-zero
before any phase.  The last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import shutil
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
EBOLA_FASTA = os.path.join(REPO, "tests", "data", "zaire_ebolavirus.fasta.gz")
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
# Scratch for generated inputs and outputs (listed in .gitignore);
# emptied at the start and end of every run.
WORK_DIR = os.path.join(REPO, ".smoke_work")

EBOLA175_ARGV = ["-pl", "100", "-m", "2", "-l", "60", "-e", "50"]
# Probe-set hash (sha224 of the sorted probe sequences, concatenated)
# of `design ebola175.fasta -pl 100 -m 2 -l 60 -e 50` through the
# per-sequence numpy engine and the host solver, with no device program
# in the loop.  Made with:
#   JAX_PLATFORMS=cpu python -c "import chip_smoke as c; \
#     print(c.reference_design_sha(175, c.EBOLA175_ARGV, '/tmp/w'))"
EBOLA175_SHA = \
    "faad15b0a0c78d3984b0bf3234016bcee8decb47e212e26f6bbbaaba"

# design_large on influenza_like_segments(n_genomes=FLU_GENOMES, seed=0)
# (8 segments, 13.6 Mbp; 1,475 probes) with the large-tier defaults,
# made by the same CLI on the CPU backend:
#   JAX_PLATFORMS=cpu python -c "import chip_smoke as c; \
#     print(c.flu_design_sha(c.FLU_GENOMES, '/tmp/w'))"
FLU_GENOMES = 1000
FLU_SHA = "56a6803c2217fee57255bf52337a072f9c005fc39672b2dfacd7e99f"


# ----------------------------------------------------------------------
# Inputs and references (no device program)
# ----------------------------------------------------------------------

def write_ebola_subset(n_genomes, path):
    """Write the first n_genomes records of the ebola fixture."""
    n = 0
    with gzip.open(EBOLA_FASTA, "rt") as src, open(path, "w") as dst:
        for line in src:
            if line.startswith(">"):
                n += 1
                if n > n_genomes:
                    break
            dst.write(line)
    return path


def probe_seqs(fasta_path):
    from catch_tpu.utils import seq_io
    return sorted(seq_io.read_fasta(fasta_path).values())


def probe_sha(seqs):
    return hashlib.sha224("".join(sorted(seqs)).encode()).hexdigest()


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update({k: v for k, v in kv.items() if v is not None})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def numpy_reference_route():
    """Route every cover scan through the per-sequence numpy engine
    (ProbeSearcher._scan_one_sequence) and every solve through the host
    solvers, so no JAX device program runs in the design."""
    from catch_tpu.ops.cover import ProbeSearcher
    old = ProbeSearcher._BATCH_MIN_BP
    ProbeSearcher._BATCH_MIN_BP = 1 << 62
    try:
        with env(CATCH_TPU_INSTANCE="host"):
            yield
    finally:
        ProbeSearcher._BATCH_MIN_BP = old


def run_design(datasets, argv, out, args_type="basic"):
    """The user's path: design.main on parsed CLI arguments; returns
    the sorted probe sequences of the output FASTA."""
    from catch_tpu.cli import design
    design.main(design.init_and_parse_args(
        args_type, list(datasets) + ["-o", out] + list(argv)))
    return probe_seqs(out)


def reference_design_sha(n_genomes, argv, workdir):
    """(sha, n_probes) of `design` on the first n_genomes ebola genomes
    through the numpy reference route."""
    os.makedirs(workdir, exist_ok=True)
    fasta = write_ebola_subset(
        n_genomes, os.path.join(workdir, "ebola%d.fasta" % n_genomes))
    with numpy_reference_route():
        seqs = run_design([fasta], list(argv) + ["--num-devices", "1"],
                          os.path.join(workdir, "ref_probes.fasta"))
    return probe_sha(seqs), len(seqs)


def write_flu_corpus(n_genomes, workdir):
    """Segment FASTAs of the seeded influenza-like corpus, written
    fresh (never reused) into workdir/flu."""
    from catch_tpu.utils.synthetic import (influenza_like_segments,
                                           write_segment_fastas)
    out_dir = os.path.join(workdir, "flu")
    shutil.rmtree(out_dir, ignore_errors=True)
    segs, subtype_of = influenza_like_segments(n_genomes=n_genomes, seed=0)
    return write_segment_fastas(segs, subtype_of, out_dir, force=True)


def flu_design_sha(n_genomes, workdir, paths=None):
    """(sha, n_probes) of design_large with its defaults on the seeded
    influenza-like corpus, on whatever backend JAX runs."""
    if paths is None:
        paths = write_flu_corpus(n_genomes, workdir)
    seqs = run_design(paths, [], os.path.join(workdir, "flu_probes.fasta"),
                      args_type="large")
    return probe_sha(seqs), len(seqs)


# ----------------------------------------------------------------------
# Phase plumbing
# ----------------------------------------------------------------------

class PhaseFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def twice(fn):
    """Run fn cold then warm; both results must agree.  Returns
    ((cold_s, warm_s), result)."""
    t0 = time.time()
    r1 = fn()
    t1 = time.time()
    r2 = fn()
    t2 = time.time()
    check(r1 == r2, "warm run disagrees with the cold run")
    return (t1 - t0, t2 - t1), r1


class _ShapeRecorder:
    """Stands in for a jitted function and records the abstract
    arguments of each distinct call signature, so the program can be
    lowered again at exactly the shapes a run used."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {}

    def __call__(self, *args, **kw):
        import jax
        structs = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype)
                        if isinstance(a, jax.Array) else a for a in args)
        key = (tuple((s.shape, str(s.dtype)) if hasattr(s, "shape")
                     else s for s in structs), tuple(sorted(kw.items())))
        self.calls.setdefault(key, (structs, kw))
        return self.fn(*args, **kw)

    def memory_lines(self, name):
        out = []
        for structs, kw in self.calls.values():
            ma = self.fn.lower(*structs, **kw).compile().memory_analysis()
            fields = {f: getattr(ma, f + "_in_bytes", None) for f in (
                "argument_size", "output_size", "temp_size",
                "generated_code_size")} if ma is not None else None
            out.append("  %s %s %s: %s" % (
                name, structs[0].shape, {
                    k: v for k, v in kw.items()
                    if k in ("C", "cap", "OUT", "L", "K", "tsw")},
                fields))
        return out


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_ebola175(work, state):
    """ebola175 through `design` on the default device route."""
    from catch_tpu.ops import scan_instance
    from catch_tpu.utils import profiling

    fasta = write_ebola_subset(175, os.path.join(work, "ebola175.fasta"))
    out = os.path.join(work, "ebola175_probes.fasta")
    rec_c = _ShapeRecorder(scan_instance._stage_c_jit)
    rec_m = _ShapeRecorder(scan_instance._merge_jit)
    scan_instance._stage_c_jit, scan_instance._merge_jit = rec_c, rec_m
    try:
        profiling.reset_phases()
        times, seqs = twice(lambda: run_design(
            [fasta], EBOLA175_ARGV + ["--num-devices", "1"], out))
    finally:
        scan_instance._stage_c_jit = rec_c.fn
        scan_instance._merge_jit = rec_m.fn
    check("scan:verify" in profiling.snapshot_phases(),
          "the design did not take the device scan pipeline")
    sha = probe_sha(seqs)
    check(sha == EBOLA175_SHA, "probe set %s (%d probes) != golden %s"
          % (sha[:16], len(seqs), str(EBOLA175_SHA)[:16]))
    state["ebola175_fasta"] = fasta
    state["ebola175_probes"] = out
    lines = rec_c.memory_lines("_stage_c_jit")
    lines += rec_m.memory_lines("_merge_jit")
    lines.append("  peak_bytes_in_use after the run: %s" % peak_bytes())
    return times, "%d probes == numpy-reference golden\n%s" % (
        len(seqs), "\n".join(lines))


def phase_reference_goldens(work, state):
    """The reference goldens with the device instance pipeline forced."""
    import numpy as np
    import bench
    from catch_tpu.ops.cover import CoverModel, ProbeSearcher
    from catch_tpu.probe import Probe
    from catch_tpu.utils import seq_io

    def gold(name):
        return sorted(seq_io.read_fasta(
            os.path.join(GOLDEN_DIR, name)).values())

    def g(name):
        return os.path.join(GOLDEN_DIR, name)

    ebola5 = write_ebola_subset(5, os.path.join(work, "ebola5.fasta"))
    ebola10 = write_ebola_subset(10, os.path.join(work, "ebola10.fasta"))
    out = os.path.join(work, "golden_probes.fasta")
    cases = [
        ("ebola5_m0", [ebola5], ["-pl", "100", "-m", "0", "-e", "0"],
         "ref_ebola5_m0.fasta", 426),
        ("identify_m0", [g("identify_a.fasta"), g("identify_b.fasta")],
         ["-pl", "60", "-ps", "30", "-m", "0", "-e", "0", "-i",
          "-c", "0.5"], "ref_identify_m0.fasta", 8),
        ("avoid_m0", [g("avoid_target.fasta")],
         ["-pl", "60", "-ps", "30", "-m", "0", "-e", "0",
          "--avoid-genomes", g("avoid_bg.fasta")], "ref_avoid_m0.fasta",
         10),
    ]

    def run():
        got = {}
        with env(CATCH_TPU_INSTANCE="force"):
            for name, ds, argv, _, _ in cases:
                got[name] = run_design(ds, argv + ["--num-devices", "1"],
                                       out)
            got["ebola10_m2"] = run_design(
                [ebola10], EBOLA175_ARGV + ["--num-devices", "1"], out)
        got["accel_parity"] = bench.run_accel_parity()
        return got

    times, got = twice(run)
    notes = []
    for name, _, _, golden, n in cases:
        want = gold(golden)
        check(len(want) == n and got[name] == want,
              "%s: %d probes, golden %d, equal=%s"
              % (name, len(got[name]), len(want), got[name] == want))
        notes.append("%s %d" % (name, n))
    m2 = got["ebola10_m2"]
    check(len(m2) <= 128, "ebola10_m2: %d probes > 128" % len(m2))
    # Full coverage, re-checked by the per-sequence numpy engine
    searcher = ProbeSearcher([Probe.from_str(s) for s in m2],
                             CoverModel(2, 60))
    for gnm in seq_io.read_genomes_from_fasta(ebola10):
        for seq in gnm.seqs:
            cov = np.zeros(len(seq) + 1, dtype=np.int64)
            for spans in searcher.find_probe_covers(seq).values():
                for a, b in spans:
                    cov[max(0, a - 50)] += 1
                    cov[min(len(seq), b + 50)] -= 1
            check(np.all(np.cumsum(cov[:-1]) > 0),
                  "ebola10_m2 leaves a genome position uncovered")
    notes.append("ebola10_m2 %d <= 128, full coverage" % len(m2))
    check(got["accel_parity"] == "ok",
          "accel_parity: %s" % got["accel_parity"])
    notes.append("accel_parity ok")
    return times, ", ".join(notes)


def phase_coverage_analysis(work, state):
    """analyze_probe_coverage of the phase-1 probes (sparse scan)."""
    from catch_tpu.cli import analyze_probe_coverage as apc

    fasta = state.get("ebola175_fasta") or write_ebola_subset(
        175, os.path.join(work, "ebola175.fasta"))
    probes = state.get("ebola175_probes")
    if probes is None:
        probes = os.path.join(work, "ebola175_ref_probes.fasta")
        with numpy_reference_route():
            run_design([fasta], EBOLA175_ARGV + ["--num-devices", "1"],
                       probes)

    def analyze(tsv):
        apc.main(apc.init_and_parse_args(
            ["-d", fasta, "-f", probes, "-m", "2", "-l", "60", "-e", "50",
             "--write-analysis-to-tsv", tsv]))
        with open(tsv) as f:
            return f.read()

    tsv = os.path.join(work, "analysis.tsv")
    times, got = twice(lambda: analyze(tsv))
    with numpy_reference_route():
        want = analyze(os.path.join(work, "analysis_ref.tsv"))
    check(got == want, "per-genome coverage differs from the numpy "
          "engine's")
    n_rows = got.count("\n") - 1
    return times, "%d genome strands, TSV == numpy engine's" % n_rows


def phase_design_large(work, state):
    """design_large on the influenza-like corpus, plus the clustering
    and MinHash device kernels against their host estimators."""
    import numpy as np
    from catch_tpu.cli import design
    from catch_tpu.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu.utils import cluster, lsh, seq_io

    paths = write_flu_corpus(FLU_GENOMES, work)
    times, (sha, n_probes) = twice(
        lambda: flu_design_sha(FLU_GENOMES, work, paths))
    check(sha == FLU_SHA, "design_large probe set %s (%d probes) != "
          "golden %s" % (sha[:16], n_probes, str(FLU_SHA)[:16]))
    notes = ["%d genomes, %d probes == CPU golden" % (FLU_GENOMES,
                                                      n_probes)]

    # Clustering adjacency codes vs the host estimator, thresholded by
    # _min_cap, on sequences spread over segments and subtypes
    args = design.init_and_parse_args("large", ["x", "-o", "y"])
    thr = cluster._jaccard_dist_from_mash_dist(
        args.cluster_and_design_separately, 12)
    early = cluster._jaccard_dist_from_mash_dist(0.02, 12)
    seqs = []
    for p in paths[:4]:
        recs = list(seq_io.read_fasta(p).values())
        seqs += recs[::max(1, len(recs) // 96)][:96]
    family = lsh.MinHashFamily(12, N=100)
    sigs = list(cluster.make_signatures_with_minhash(
        family, dict(enumerate(seqs))).values())
    codes = cluster._DeviceDistances(sigs).code_matrix(thr, early)
    N = 100
    cap_thr = cluster._min_cap(N, thr)
    cap_early = cluster._min_cap(N, early)
    want = np.zeros_like(codes)
    for i in range(len(sigs)):
        for j in range(len(sigs)):
            cap = int(round((1.0 - family.estimate_jaccard_dist(
                sigs[i], sigs[j])) * N))
            want[i, j] = (cap >= cap_thr) + (cap >= cap_thr
                                             and cap >= cap_early)
    check(np.array_equal(codes, want),
          "cluster codes differ from the host estimator at %d pairs"
          % int(np.sum(codes != want)))
    notes.append("cluster codes %dx%d == host (counts %s)" % (
        len(sigs), len(sigs), np.bincount(codes.ravel(),
                                          minlength=3).tolist()))

    # Device MinHash signatures vs numpy on one cluster's probes
    # (segment 1 of subtype 0)
    cl = [s for h, s in seq_io.read_fasta(paths[0]).items()
          if "subtype00" in h]
    cand = sorted({p.seq_str for p in make_candidate_probes_from_sequences(
        cl, probe_length=100, probe_stride=50)})
    nn = lsh.BatchedNearNeighbor(
        lsh.MinHashFamily(10, rng=np.random.default_rng(0)), 3, 0.6, 0.8,
        cand)
    old_cells = lsh._DEVICE_SIG_MIN_CELLS

    def sig(cells):
        lsh._DEVICE_SIG_MIN_CELLS = cells
        nn.family._rng = np.random.default_rng(0)
        t0 = time.time()
        nn._build_minhash()
        return nn._sig.copy(), time.time() - t0

    try:
        sig_np, t_np = sig(1 << 62)
        sig_dev, t_dev_cold = sig(0)
        sig_dev2, t_dev = sig(0)
    finally:
        lsh._DEVICE_SIG_MIN_CELLS = old_cells
    check(np.array_equal(sig_np, sig_dev) and np.array_equal(
        sig_dev, sig_dev2), "device MinHash signatures differ from numpy")
    notes.append("LSH signatures %s == numpy (numpy %.3f s, device "
                 "%.3f s cold / %.3f s warm)" % (
                     sig_np.shape, t_np, t_dev_cold, t_dev))
    return times, "; ".join(notes)


def phase_solvers(work, state):
    """Device set-cover solvers against the host solvers."""
    import bench
    from catch_tpu.filters.candidates import (
        make_candidate_probes_from_sequences)
    from catch_tpu.filters.duplicate import DuplicateFilter
    from catch_tpu.filters.set_cover_filter import SetCoverFilter
    from catch_tpu.ops import set_cover
    from catch_tpu.utils import seq_io

    inst, dev = bench.solver_instance()
    ebola10 = write_ebola_subset(10, os.path.join(work, "ebola10.fasta"))
    genomes = seq_io.read_genomes_from_fasta(ebola10)
    cands = DuplicateFilter()._filter(make_candidate_probes_from_sequences(
        [s for g in genomes for s in g.seqs], probe_length=100,
        probe_stride=50))
    scf = SetCoverFilter(mismatches=2, lcf_thres=60, cover_extension=50)
    with numpy_reference_route():
        set_ids, univ, st, en = scf._make_cover_arrays(cands, genomes)
    inst10 = set_cover.build_instance_from_cover_arrays(
        set_ids, univ, st, en, n_sets=len(cands), n_universes=len(genomes),
        universe_p=scf._make_universe_p(genomes),
        ranks=scf._make_ranks(cands, [genomes]))

    def run():
        boundary = set_cover.solve_boundary_instance(
            dev, bench.SOLVER_N_SETS,
            max_dispatches=bench.SOLVER_DEV_DISPATCH).tolist()
        steps = set_cover._solve_device_steps(inst10).tolist()
        return boundary, steps

    times, (boundary, steps) = twice(run)
    t0 = time.time()
    lazy = set_cover._solve_host_lazy(inst).tolist()
    t_lazy = time.time() - t0
    check(len(boundary) > 0 and boundary == lazy[:len(boundary)],
          "boundary solver's %d picks differ from the host lazy solver's "
          "first picks" % len(boundary))
    full = set_cover._solve_host(inst10).tolist()
    check(len(steps) > 0 and steps == full,
          "batched-step solver's %d picks differ from the host solver's %d"
          % (len(steps), len(full)))
    return times, ("boundary solver %d picks == host lazy prefix (%d "
                   "positions, %d sets; lazy full solve %d picks in "
                   "%.2f s); batched-step solver %d picks == host on "
                   "ebola10 m2" % (len(boundary), inst.u_len,
                                   inst.n_sets, len(lazy), t_lazy,
                                   len(steps)))


def phase_four_cards(work, state):
    """The multi-card path: ebola175 design on 4 cards vs device 0,
    and the sharded dryrun's comparisons."""
    import __graft_entry__

    fasta = write_ebola_subset(175, os.path.join(work, "ebola175.fasta"))
    one = run_design([fasta], EBOLA175_ARGV + ["--num-devices", "1"],
                     os.path.join(work, "one_card.fasta"))
    times, four = twice(lambda: run_design(
        [fasta], EBOLA175_ARGV + ["--num-devices", "4"],
        os.path.join(work, "four_cards.fasta")))
    check(four == one, "4-card probe set differs from the 1-card one")
    check(probe_sha(one) == EBOLA175_SHA, "1-card probe set != golden")
    __graft_entry__.dryrun_multichip(4)
    return times, ("ebola175 4 cards == 1 card == golden (%d probes); "
                   "dryrun_multichip(4) bit-identical" % len(one))


PHASES = {
    "1": ("ebola175_design", phase_ebola175),
    "2": ("reference_goldens", phase_reference_goldens),
    "3": ("coverage_analysis", phase_coverage_analysis),
    "4": ("design_large_flu", phase_design_large),
    "5": ("set_cover_solvers", phase_solvers),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card path, on 4 cards")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print("chip_smoke.py needs a GPU; JAX found platform %r"
              % devices[0].platform, file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print("chip_smoke.py --four-cards needs 4 GPUs; JAX found %d"
              % len(devices), file=sys.stderr)
        return 2

    sys.path.insert(0, REPO)
    import bench
    from catch_tpu.utils.profiling import enable_compilation_cache
    enable_compilation_cache()

    card = bench.card_info()
    kind = devices[0].device_kind
    print("card: %s" % card)
    print("device_kind: %s, %d device(s)" % (kind, len(devices)))

    todo = ([("four_cards", phase_four_cards)] if args.four_cards
            else list(PHASES.values()))
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    state = {}
    failed = []
    t_all = time.time()
    try:
        for name, fn in todo:
            t0 = time.time()
            try:
                (cold, warm), note = fn(WORK_DIR, state)
            except Exception:
                failed.append(name)
                traceback.print_exc()
                print("phase %s: FAIL after %.2f s [%s]"
                      % (name, time.time() - t0, card), flush=True)
                continue
            print("phase %s: ok | cold %.2f s | warm %.2f s | [%s] | %s"
                  % (name, cold, warm, card, note), flush=True)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    print("total wall-clock %.2f s [%s]" % (time.time() - t_all, card))
    if failed:
        print("failed phases: %s" % ", ".join(failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
