#!/usr/bin/env python3
"""Design probes for genome capture (main executable).

Flag-compatible with the reference bin/design.py (argument names,
defaults, validation, and the two-tier 'basic'/'large' defaults;
/root/reference/bin/design.py:42-985).  ``--max-num-processes`` and
``--use-native-dict-when-finding-tolerant-coverage`` are accepted for
compatibility; the device replaces process pools.

Run as ``python -m catch_tpu.cli.design`` or via the installed
``catch-design`` entry point.
"""

import argparse
import logging
import os
import random

from catch_tpu import designer as probe_designer
from catch_tpu.analysis import coverage as coverage_analysis
from catch_tpu.filters.adapter import AdapterFilter
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.filters.fasta import FastaFilter
from catch_tpu.filters.n_expansion import NExpansionFilter
from catch_tpu.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu.filters.polya import PolyAFilter
from catch_tpu.filters.reverse_complement import ReverseComplementFilter
from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.utils import log, seq_io, version

_ARGS_TYPES = ("basic", "large")


def main(args):
    log.configure_logging(args.log_level)
    logger = logging.getLogger(__name__)
    from catch_tpu.utils.profiling import enable_compilation_cache
    enable_compilation_cache()
    from catch_tpu.parallel.distributed import maybe_initialize
    maybe_initialize()

    if args.args_type == "large":
        logger.warning(
            "design_large relaxes several defaults (e.g. -m, -e) to "
            "favor runtime over probe count; see 'design_large --help' "
            "for the values, and pass any argument explicitly to "
            "override its relaxed default.")

    if args.ncbi_api_key:
        from catch_tpu.utils import ncbi_neighbors
        ncbi_neighbors.ncbi_api_key = args.ncbi_api_key

    # Load one genome group per dataset argument: either a FASTA path
    # or 'download:TAXID[-SEGMENT]' fetched from NCBI.
    genomes_grouped = []
    genomes_grouped_names = []
    for ds in args.dataset:
        if ds.startswith("collection:"):
            raise ValueError(
                "'collection:' inputs are not supported here; give each "
                "dataset as a FASTA path or as 'download:taxid'.")
        elif ds.startswith("download:"):
            from catch_tpu.utils import ncbi_neighbors
            taxid = ds[len("download:"):]
            taxid_fn = (os.path.join(args.write_taxid_acc,
                                     str(taxid) + ".txt")
                        if args.write_taxid_acc else None)
            taxid, _, segment = taxid.partition("-")
            ds_fasta_tf = ncbi_neighbors.construct_fasta_for_taxid(
                taxid, segment=segment or None, write_to=taxid_fn)
            genomes_grouped.append(
                seq_io.read_genomes_from_fasta(ds_fasta_tf.name))
            genomes_grouped_names.append("taxid:" + str(taxid))
            ds_fasta_tf.close()
        elif os.path.isfile(ds):
            genomes_grouped.append(seq_io.read_genomes_from_fasta(ds))
            genomes_grouped_names.append(os.path.basename(ds))
        else:
            raise ValueError(
                f"Cannot interpret dataset {ds!r}: it is neither an "
                "existing FASTA file nor a 'download:taxid' spec "
                "(named dataset labels are not supported). If it was "
                "meant to be a FASTA path, check that the path exists.")

    if (args.limit_target_genomes and
            args.limit_target_genomes_randomly_with_replacement):
        raise Exception(
            "--limit-target-genomes and "
            "--limit-target-genomes-randomly-with-replacement are "
            "mutually exclusive")
    elif args.limit_target_genomes:
        genomes_grouped = [genomes[:args.limit_target_genomes]
                           for genomes in genomes_grouped]
    elif args.limit_target_genomes_randomly_with_replacement:
        k = args.limit_target_genomes_randomly_with_replacement
        genomes_grouped = [random.choices(genomes, k=k)
                           for genomes in genomes_grouped]

    if args.args_type != "large":
        total_input_size = sum(sum(g.size() for g in genomes)
                               for genomes in genomes_grouped)
        if ((len(args.dataset) > 1 and not args.identify)
                or total_input_size > 10000000):
            recommended = []
            if (not args.filter_with_lsh_hamming
                    and not args.filter_with_lsh_minhash):
                recommended.append("--filter-with-lsh-minhash 0.6")
            if not args.cluster_and_design_separately:
                recommended.append("--cluster-and-design-separately 0.15")
            if not args.cluster_from_fragments:
                recommended.append("--cluster-from-fragments 50000")
            rec_str = ""
            if recommended:
                rec_str = (" Suggested flags: "
                           + ", ".join("'" + x + "'" for x in recommended))
            logger.warning(
                "This is a large input; if runtime or memory become a "
                "problem, design_large (or the individual speed flags "
                "it enables) trades a slightly larger probe set for a "
                f"much cheaper design.{rec_str}")

    avoided_genomes_fasta = []
    if args.avoid_genomes:
        for ag in args.avoid_genomes:
            if os.path.isfile(ag):
                avoided_genomes_fasta.append(ag)
            else:
                raise ValueError(
                    f"--avoid-genomes entry {ag!r} is not an existing "
                    "FASTA file (named dataset labels are not "
                    "supported here)")

    if not args.lcf_thres:
        args.lcf_thres = args.probe_length
    for name, val in (("PROBE_STRIDE", args.probe_stride),
                      ("LCF_THRES", args.lcf_thres),
                      ("ISLAND_OF_EXACT_MATCH",
                       args.island_of_exact_match)):
        if val > args.probe_length:
            logger.warning(
                "%s (%d) exceeds PROBE_LENGTH (%d); such settings are "
                "rarely what you want and their behavior is not "
                "well-defined", name, val, args.probe_length)
    if args.mismatches / args.probe_length > 0.15:
        logger.warning(
            "MISMATCHES (%d) is unusually high for PROBE_LENGTH (%d); "
            "expect a slower design and, in practice, weaker "
            "enrichment", args.mismatches, args.probe_length)

    if args.kmer_probe_map_k:
        if args.kmer_probe_map_k > args.probe_length:
            raise Exception(
                "KMER_PROBE_MAP_K (%d) cannot exceed PROBE_LENGTH (%d)"
                % (args.kmer_probe_map_k, args.probe_length))
        kmer_probe_map_k_scf = args.kmer_probe_map_k
        kmer_probe_map_k_af = args.kmer_probe_map_k
        kmer_probe_map_k_analyzer = args.kmer_probe_map_k
    else:
        if args.probe_length <= 20:
            logger.warning(
                "With a PROBE_LENGTH this small (%d), a small "
                "--kmer-probe-map-k makes the probe-to-target mapping "
                "more sensitive", args.probe_length)
        kmer_probe_map_k_scf = 20
        kmer_probe_map_k_af = 20
        kmer_probe_map_k_analyzer = 10

    if args.add_adapters:
        if not (args.adapter_a or args.adapter_b):
            logger.warning(
                "--add-adapters without --adapter-a/--adapter-b uses "
                "the built-in default adapter sequences")
    else:
        if args.adapter_a or args.adapter_b:
            raise Exception(
                "--adapter-a/--adapter-b have no effect unless "
                "--add-adapters is also given")

    if args.small_seq_skip is not None and args.small_seq_min is not None:
        raise Exception(
            "--small-seq-skip and --small-seq-min are mutually "
            "exclusive")

    if args.cluster_and_design_separately and args.identify:
        raise Exception(
            "--identify needs the per-dataset genome groupings, which "
            "--cluster-and-design-separately collapses; the two cannot "
            "be combined")
    if args.cluster_from_fragments and \
            not args.cluster_and_design_separately:
        raise Exception(
            "--cluster-from-fragments only applies when "
            "--cluster-and-design-separately is set")

    custom_cover_range_fn = (tuple(args.custom_hybridization_fn)
                             if args.custom_hybridization_fn else None)
    custom_cover_range_tolerant_fn = (
        tuple(args.custom_hybridization_fn_tolerant)
        if args.custom_hybridization_fn_tolerant else None)

    # Assemble the ordered filter chain (reference design.py:255-400)
    filters = []

    if args.filter_from_fasta:
        filters.append(FastaFilter(args.filter_from_fasta,
                                   skip_reverse_complements=True))

    if args.filter_polya:
        polya_length, polya_mismatches = args.filter_polya
        if polya_length > args.probe_length:
            logger.warning(
                "The poly(A) run length to filter (%d) exceeds "
                "PROBE_LENGTH (%d); no probe can contain such a run",
                polya_length, args.probe_length)
        if polya_length < 10:
            logger.warning(
                "A poly(A) run length this short (%d) will drop many "
                "probes", polya_length)
        if polya_mismatches > 10:
            logger.warning(
                "Tolerating %d mismatches in poly(A) runs is "
                "aggressive and will drop many probes", polya_mismatches)
        filters.append(PolyAFilter(polya_length, polya_mismatches))

    if (args.filter_with_lsh_hamming is not None
            and args.filter_with_lsh_minhash is not None):
        raise Exception("--filter-with-lsh-hamming and "
                        "--filter-with-lsh-minhash are mutually "
                        "exclusive")
    if args.filter_with_lsh_hamming is not None:
        if args.filter_with_lsh_hamming > args.mismatches:
            logger.warning(
                "FILTER_WITH_LSH_HAMMING (%d) above MISMATCHES (%d) "
                "can collapse probes the model distinguishes, so the "
                "design may fall short of the requested coverage",
                args.filter_with_lsh_hamming, args.mismatches)
        filters.append(NearDuplicateFilterWithHammingDistance(
            args.filter_with_lsh_hamming, args.probe_length))
    elif args.filter_with_lsh_minhash is not None:
        if args.mismatches < 3:
            logger.warning(
                "At MISMATCHES=%d (<= 2), MinHash near-duplicate "
                "collapsing (especially with a large threshold) can "
                "leave the design short of the requested coverage",
                args.mismatches)
        filters.append(NearDuplicateFilterWithMinHash(
            args.filter_with_lsh_minhash))
    else:
        filters.append(DuplicateFilter())

    # Host-side pool cap: the grouped-filter thread pool honors the
    # reference's --max-num-processes knob
    # (/root/reference/bin/design.py:215, :912-922).
    if args.max_num_processes is not None:
        from catch_tpu.filters import base as filter_base
        filter_base.set_max_num_processes_for_filter_over_groupings(
            args.max_num_processes)

    # Device mesh: shard the cover scan and the greedy solve across
    # accelerators when more than one is visible.  With
    # jax.distributed initialized (see catch_tpu.parallel.distributed)
    # the mesh spans every process's devices.
    import jax
    from catch_tpu.parallel import make_mesh
    mesh = None
    n_dev = jax.device_count()
    limit = args.num_devices if args.num_devices else n_dev
    if args.max_num_processes is not None:
        limit = min(limit, args.max_num_processes)
    n_use = min(n_dev, limit)
    if n_use > 1:
        mesh = make_mesh(n_use)
        logger.info("Sharding the scan and solve across %d devices",
                    n_use)

    scf = SetCoverFilter(
        mismatches=args.mismatches, lcf_thres=args.lcf_thres,
        island_of_exact_match=args.island_of_exact_match,
        mismatches_tolerant=args.mismatches_tolerant,
        lcf_thres_tolerant=args.lcf_thres_tolerant,
        island_of_exact_match_tolerant=args.island_of_exact_match_tolerant,
        custom_cover_range_fn=custom_cover_range_fn,
        custom_cover_range_tolerant_fn=custom_cover_range_tolerant_fn,
        identify=args.identify, avoided_genomes=avoided_genomes_fasta,
        coverage=args.coverage, cover_extension=args.cover_extension,
        kmer_probe_map_k=kmer_probe_map_k_scf,
        kmer_probe_map_use_native_dict=(
            args.use_native_dict_when_finding_tolerant_coverage),
        mesh=mesh)
    filters.append(scf)

    if args.add_adapters:
        adapter_a = (tuple(args.adapter_a) if args.adapter_a
                     else ("ATACGCCATGCTGGGTCTCC", "CGTACTTGGGAGTCGGCCAT"))
        adapter_b = (tuple(args.adapter_b) if args.adapter_b
                     else ("AGGCCCTGGCTGCTGATATG", "GACCTTTTGGGACAGCGGTG"))
        filters.append(AdapterFilter(
            adapter_a, adapter_b, mismatches=args.mismatches,
            lcf_thres=args.lcf_thres,
            island_of_exact_match=args.island_of_exact_match,
            custom_cover_range_fn=custom_cover_range_fn,
            kmer_probe_map_k=kmer_probe_map_k_af))

    if args.expand_n is not None:
        filters.append(NExpansionFilter(
            limit_n_expansion_randomly=args.expand_n))

    if args.add_reverse_complements:
        filters.append(ReverseComplementFilter())

    if args.skip_set_cover:
        filter_before_scf = filters[filters.index(scf) - 1]
        filters.remove(scf)

    if args.cluster_and_design_separately:
        cluster_threshold = args.cluster_and_design_separately
        cluster_merge_after = (filter_before_scf if args.skip_set_cover
                               else scf)
        cluster_method = args.cluster_and_design_separately_method
        cluster_fragment_length = args.cluster_from_fragments
    else:
        cluster_threshold = None
        cluster_merge_after = None
        cluster_method = None
        cluster_fragment_length = None

    pb = probe_designer.ProbeDesigner(
        genomes_grouped, filters, probe_length=args.probe_length,
        probe_stride=args.probe_stride,
        allow_small_seqs=args.small_seq_min,
        seq_length_to_skip=args.small_seq_skip,
        cluster_threshold=cluster_threshold,
        cluster_merge_after=cluster_merge_after,
        cluster_method=cluster_method,
        cluster_fragment_length=cluster_fragment_length)
    pb.design()

    seq_io.write_probe_fasta(pb.final_probes, args.output_probes)

    if (args.print_analysis or args.write_analysis_to_tsv
            or args.write_sliding_window_coverage
            or args.write_probe_map_counts_to_tsv):
        analyzer = coverage_analysis.Analyzer(
            pb.final_probes, args.mismatches, args.lcf_thres,
            genomes_grouped, genomes_grouped_names,
            island_of_exact_match=args.island_of_exact_match,
            custom_cover_range_fn=custom_cover_range_fn,
            cover_extension=args.cover_extension,
            kmer_probe_map_k=kmer_probe_map_k_analyzer,
            rc_too=args.add_reverse_complements)
        analyzer.run()
        if args.write_analysis_to_tsv:
            analyzer.write_data_matrix_as_tsv(args.write_analysis_to_tsv)
        if args.write_sliding_window_coverage:
            analyzer.write_sliding_window_coverage(
                args.write_sliding_window_coverage)
        if args.write_probe_map_counts_to_tsv:
            analyzer.write_probe_map_counts(
                args.write_probe_map_counts_to_tsv)
        if args.print_analysis:
            analyzer.print_analysis()
    else:
        print(len(pb.final_probes))


def init_and_parse_args(args_type, argv=None):
    """Setup and parse command-line arguments ('basic' or 'large'
    defaults; reference design.py:448-980)."""
    if args_type not in _ARGS_TYPES:
        raise ValueError(
            f"Argument type '{args_type}' is invalid; it must be one of "
            f"{_ARGS_TYPES}")

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    parser.add_argument("dataset", nargs="+",
        help=("One or more target datasets (e.g., one per species), "
              "each either 'download:TAXID' (NCBI download; "
              "'download:TAXID-SEGMENT' for segmented viruses) or a "
              "path to a FASTA file"))
    parser.add_argument("-o", "--output-probes", required=True,
        help=("The file to which all final probes should be written "
              "(FASTA format)"))
    parser.add_argument("--write-taxid-acc",
        help=("If 'download:' labels are used, write downloaded "
              "accessions to WRITE_TAXID_ACC/TAXID.txt"))
    parser.add_argument("-pl", "--probe-length", type=int, default=100,
        help="Make probes be PROBE_LENGTH nt long")
    parser.add_argument("-ps", "--probe-stride", type=int, default=50,
        help=("Generate candidate probes from the input that are "
              "separated by PROBE_STRIDE nt"))

    default_mismatches = {"basic": 0, "large": 5}
    parser.add_argument("-m", "--mismatches", type=int,
        default=default_mismatches[args_type],
        help=("Allow for MISMATCHES mismatches when determining whether "
              "a probe covers a sequence"))
    parser.add_argument("-l", "--lcf-thres", type=int,
        help=("(Optional) Cover threshold: shared substring length with "
              "at most MISMATCHES mismatches; defaults to PROBE_LENGTH"))
    parser.add_argument("--island-of-exact-match", type=int, default=0,
        help=("(Optional) Require an exact match of at least this "
              "length for a probe to cover a sequence"))
    parser.add_argument("--custom-hybridization-fn", nargs=2,
        help=("(Optional) Args: <PATH> <FUNC>; dynamically loaded "
              "custom hybridization model (6-argument contract; see the "
              "reference documentation)"))

    def check_coverage(val):
        fval = float(val)
        ival = int(fval)
        if 0 <= fval <= 1:
            return fval
        elif fval > 1 and fval == ival:
            return ival
        raise argparse.ArgumentTypeError(
            "%s is an invalid coverage value" % val)

    parser.add_argument("-c", "--coverage", type=check_coverage,
        default=1.0,
        help=("Fraction of each target genome to cover (float in "
              "[0,1]), or number of bp to cover (int > 1)"))

    default_cover_extension = {"basic": 0, "large": 50}
    parser.add_argument("-e", "--cover-extension", type=int,
        default=default_cover_extension[args_type],
        help="Extend coverage on each side of a probe by this many nt")

    parser.add_argument("-i", "--identify", dest="identify",
        action="store_true",
        help=("Design probes meant to identify a dataset against the "
              "others; coverage should generally be small"))
    parser.add_argument("--avoid-genomes", nargs="+",
        help=("One or more FASTA files of genomes to avoid (probes are "
              "penalized by how much they cover them)"))
    parser.add_argument("-mt", "--mismatches-tolerant", type=int,
        help="(Optional) More tolerant value for 'mismatches'")
    parser.add_argument("-lt", "--lcf-thres-tolerant", type=int,
        help="(Optional) More tolerant value for 'lcf_thres'")
    parser.add_argument("--island-of-exact-match-tolerant", type=int,
        default=0,
        help="(Optional) More tolerant value for 'island_of_exact_match'")
    parser.add_argument("--custom-hybridization-fn-tolerant", nargs=2,
        help="(Optional) More tolerant custom hybridization model")

    parser.add_argument("--print-analysis", dest="print_analysis",
        action="store_true",
        help="Print analysis of the probe set's coverage")
    parser.add_argument("--write-analysis-to-tsv",
        help="(Optional) File for a TSV matrix of the coverage analysis")
    parser.add_argument("--write-sliding-window-coverage",
        help=("(Optional) File for average probe-set coverage within "
              "sliding windows of each target genome"))
    parser.add_argument("--write-probe-map-counts-to-tsv",
        help=("(Optional) File for a TSV of the number of sequences "
              "each probe maps to (not counting reverse complements)"))

    parser.add_argument("--filter-from-fasta",
        help=("(Optional) Keep only candidate probes equal to sequences "
              "in this FASTA (headers containing 'reverse complement' "
              "are ignored); useful with --skip-set-cover"))
    parser.add_argument("--skip-set-cover", dest="skip_set_cover",
        action="store_true",
        help="Skip the set cover filter")

    parser.add_argument("--add-adapters", dest="add_adapters",
        action="store_true",
        help=("Add adapters to the ends of probes; to specify adapter "
              "sequences, use --adapter-a and --adapter-b"))
    parser.add_argument("--adapter-a", nargs=2,
        help="(Optional) Args: <X> <Y>; custom A adapter (5'/3' ends)")
    parser.add_argument("--adapter-b", nargs=2,
        help="(Optional) Args: <X> <Y>; custom B adapter (5'/3' ends)")

    parser.add_argument("--filter-polya", nargs=2, type=int,
        help=("(Optional) Args: <X> <Y>; drop probes containing X or "
              "more 'A' bases tolerating up to Y mismatches (likewise "
              "'T')"))

    parser.add_argument("--add-reverse-complements",
        dest="add_reverse_complements", action="store_true",
        help="Add to the output the reverse complement of each probe")
    parser.add_argument("--expand-n", nargs="?", type=int, default=None,
        const=3,
        help=("Expand 'N' bases into real bases; optional INT limits the "
              "number expanded (default 3), the rest replaced randomly"))

    parser.add_argument("--limit-target-genomes", type=int,
        help="(Optional) Use only the first N target genomes per dataset")
    parser.add_argument(
        "--limit-target-genomes-randomly-with-replacement", type=int,
        help=("(Optional) Randomly select N target genomes per dataset "
              "with replacement"))

    def check_cluster_and_design_separately(val):
        fval = float(val)
        if 0 < fval <= 0.5:
            return fval
        raise argparse.ArgumentTypeError(
            "%s is an invalid average nucleotide dissimilarity" % val)

    default_cads = {"basic": None, "large": 0.15}
    parser.add_argument("--cluster-and-design-separately",
        type=check_cluster_and_design_separately,
        default=default_cads[args_type],
        help=("(Optional) Cluster input sequences at this average "
              "nucleotide dissimilarity threshold (in (0,0.5]; ~0.15 "
              "recommended), design separately per cluster, and merge"))
    parser.add_argument("--cluster-and-design-separately-method",
        choices=["choose", "simple", "hierarchical"], default="choose",
        help=("(Optional) Clustering method: connected components "
              "('simple'), agglomerative ('hierarchical'), or a "
              "heuristic choice ('choose')"))
    default_cff = {"basic": None, "large": 50000}
    parser.add_argument("--cluster-from-fragments", type=int,
        default=default_cff[args_type],
        help=("(Optional) Break sequences into fragments of this length "
              "(~50000 recommended) and cluster the fragments; requires "
              "--cluster-and-design-separately"))

    parser.add_argument("--filter-with-lsh-hamming", type=int,
        help=("(Optional) Filter near-duplicate candidate probes via "
              "Hamming-distance LSH at this distance (commensurate with "
              "but not greater than MISMATCHES)"))

    def check_filter_with_lsh_minhash(val):
        fval = float(val)
        if 0.0 <= fval <= 1.0:
            return fval
        raise argparse.ArgumentTypeError(
            "%s is an invalid Jaccard distance" % val)

    default_flm = {"basic": None, "large": 0.6}
    parser.add_argument("--filter-with-lsh-minhash",
        type=check_filter_with_lsh_minhash,
        default=default_flm[args_type],
        help=("(Optional) Filter near-duplicate candidate probes via "
              "MinHash LSH at this maximum Jaccard distance (10-mers; "
              "values ~0.5-0.7 typical)"))

    parser.add_argument("--small-seq-skip", type=int,
        help=("(Optional) Do not create candidate probes from sequences "
              "of length <= SMALL_SEQ_SKIP"))
    parser.add_argument("--small-seq-min", type=int,
        help=("(Optional) Allow input sequences shorter than "
              "PROBE_LENGTH, down to this minimum length (the candidate "
              "probe equals the sequence)"))

    def check_max_num_processes(val):
        ival = int(val)
        if ival >= 1:
            return ival
        raise argparse.ArgumentTypeError(
            "MAX_NUM_PROCESSES must be an int >= 1")

    parser.add_argument("--max-num-processes",
        type=check_max_num_processes,
        help=("(Optional) Cap on the number of accelerator devices the "
              "scan and solve shard across (kept for compatibility "
              "with the reference CLI, whose pools it capped; "
              "parallelism here comes from the device mesh)"))
    parser.add_argument("--num-devices", type=int,
        help=("(Optional) Number of accelerator devices to shard "
              "across (default: all visible devices; across all hosts "
              "when jax.distributed is initialized — see "
              "catch_tpu.parallel.distributed)"))
    parser.add_argument("--kmer-probe-map-k", type=int,
        help=("(Optional) Seed k-mer length for mapping candidate "
              "probes to target sequences (pigeonhole when possible, "
              "else this length)"))
    parser.add_argument("--use-native-dict-when-finding-tolerant-coverage",
        dest="use_native_dict_when_finding_tolerant_coverage",
        action="store_true",
        help=("Accepted for compatibility with the reference CLI; no "
              "shared-memory dict exists in this implementation"))
    parser.add_argument("--ncbi-api-key",
        help=("API key to use for NCBI e-utils (increases the limit on "
              "requests/second)"))

    parser.add_argument("--debug", dest="log_level",
        action="store_const", const=logging.DEBUG,
        default=logging.WARNING, help="Debug output")
    parser.add_argument("--verbose", dest="log_level",
        action="store_const", const=logging.INFO, help="Verbose output")
    parser.add_argument("-V", "--version", action="version",
        version=version.get_version())

    args = parser.parse_args(argv)
    args.args_type = args_type
    return args


def run():
    main(init_and_parse_args(args_type="basic"))


if __name__ == "__main__":
    run()
