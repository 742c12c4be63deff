"""SetCoverFilter: probe selection by multi-universe set cover.

Behavioral parity with the reference SetCoverFilter
(/root/reference/catch/filter/set_cover_filter.py:195-930): per-group
set-cover instances over target genomes with cover extension, required
coverage (fractional or bp), identification ranks, avoided-genome
penalty ranks (tolerant hybridization model, both strands), and custom
cover functions.

Design: the cover engine (ProbeSearcher) replaces the k-mer map + fork
pool; on the default route the device scan (ops/scan_instance) builds
each group's set-cover instance on device, and one compact readback
feeds the lazy-greedy host solver.  The host route's cover spans flow
directly into flat interval arrays
(ops/set_cover.build_instance_from_cover_arrays) with no per-probe
Python dict materialization.
"""

import logging

import numpy as np

from catch_tpu.filters.base import BaseFilter
from catch_tpu.ops import set_cover
from catch_tpu.ops.cover import CoverModel, ProbeSearcher
from catch_tpu.utils import dynamic_load, seq_io

logger = logging.getLogger(__name__)

__all__ = ["SetCoverFilter"]

_RC_MAP = {"A": "T", "T": "A", "C": "G", "G": "C"}


def _reverse_complement(sequence):
    return "".join(_RC_MAP.get(b, b) for b in sequence[::-1])


class SetCoverFilter(BaseFilter):
    """Selects candidate probes via greedy multi-universe set cover."""

    device_bound = True

    @property
    def group_local(self):
        # Identification ranks count hits across ALL groupings, so the
        # filter is only safe to run one group at a time when
        # identification is off.  (Avoided-genome ranks scan only the
        # group's own candidates against external FASTAs — group-local.)
        return not self.identify

    def __init__(self, mismatches, lcf_thres, island_of_exact_match=0,
                 mismatches_tolerant=None, lcf_thres_tolerant=None,
                 island_of_exact_match_tolerant=None,
                 custom_cover_range_fn=None,
                 custom_cover_range_tolerant_fn=None,
                 identify=False, avoided_genomes=[], coverage=1.0,
                 cover_extension=0, kmer_probe_map_k=20,
                 kmer_probe_map_use_native_dict=False, mesh=None):
        """Args mirror the reference contract
        (set_cover_filter.py:200-290); kmer_probe_map_use_native_dict is
        accepted for compatibility and ignored (no shared-memory dict
        exists here).  `mesh` is an optional jax.sharding.Mesh: with
        more than one device, the cover scan verifies data-parallel
        across it and the greedy solve shards candidate sets over it
        (catch_tpu/parallel/set_cover.py) — the output probe set is
        identical for every device count (the counterpart of the
        reference's num_processes-invariance contract,
        reference test_set_cover_filter.py:134-175)."""
        self.mesh = mesh
        if custom_cover_range_fn is not None:
            fn_path, fn_name = custom_cover_range_fn
            fn = dynamic_load.load_function_from_path(fn_path, fn_name)
            self.model = CoverModel(custom_fn=fn)
        else:
            self.model = CoverModel(mismatches, lcf_thres,
                                    island_of_exact_match)

        if not mismatches_tolerant:
            mismatches_tolerant = mismatches
        if not lcf_thres_tolerant:
            lcf_thres_tolerant = lcf_thres
        if not island_of_exact_match_tolerant:
            island_of_exact_match_tolerant = island_of_exact_match
        if custom_cover_range_tolerant_fn is not None:
            fn_path, fn_name = custom_cover_range_tolerant_fn
            fn = dynamic_load.load_function_from_path(fn_path, fn_name)
            self.tolerant_model = CoverModel(custom_fn=fn)
        else:
            self.tolerant_model = CoverModel(
                mismatches_tolerant, lcf_thres_tolerant,
                island_of_exact_match_tolerant)

        if identify:
            if (coverage <= 1.0 and coverage >= 0.25) or \
               (coverage > 1 and coverage >= 5000):
                logger.warning(
                    "Identification is enabled but the required coverage "
                    "is high; generally coverage should be small when "
                    "performing identification")

        self.identify = identify
        self.avoided_genomes = avoided_genomes
        self.coverage = coverage
        self.cover_extension = cover_extension
        self.kmer_probe_map_k = kmer_probe_map_k

        self.requires_probe_groupings = True
        # Test hook kept for API parity (process count is meaningless
        # here; output must be identical regardless)
        self._force_num_processes = None

    # ------------------------------------------------------------------

    def _prepare_scan(self, candidate_probes, target_genomes):
        """Searcher + flattened corpus bookkeeping shared by the host
        and device instance paths."""
        searcher = ProbeSearcher(candidate_probes, self.model,
                                 kmer_probe_map_k=self.kmer_probe_map_k,
                                 mesh=self.mesh)
        self._last_searcher = searcher
        # Reference semantics: later duplicates take the id
        # (set_cover_filter.py:407-410 builds probe->id with last-wins)
        probe_id = {}
        for i, p in enumerate(candidate_probes):
            probe_id[p] = i
        pid_of = np.array([probe_id[p] for p in searcher.probes],
                          dtype=np.int64) if not searcher.empty else \
            np.empty(0, dtype=np.int64)

        # Flatten all chromosome sequences across genomes with per-seq
        # (genome id, chromosome offset, length) bookkeeping; one
        # corpus-level scan replaces the per-sequence loop.
        sequences, seq_univ, seq_off, seq_len = [], [], [], []
        for j, gnm in enumerate(target_genomes):
            length_so_far = 0
            for sequence in gnm.seqs:
                sequences.append(sequence)
                seq_univ.append(j)
                seq_off.append(length_so_far)
                seq_len.append(len(sequence))
                length_so_far += len(sequence)
        seq_univ = np.array(seq_univ, dtype=np.int64)
        seq_off = np.array(seq_off, dtype=np.int64)
        seq_len = np.array(seq_len, dtype=np.int64)
        return searcher, pid_of, sequences, seq_univ, seq_off, seq_len

    def _make_cover_arrays(self, candidate_probes, target_genomes,
                           prepared=None):
        """Cover spans of every candidate in every target genome.

        Returns flat arrays (set_ids, univ_ids, starts, ends) with
        cover extension applied and clamped per chromosome, and
        coordinates offset into genome-global positions
        (reference set_cover_filter.py:414-470).
        """
        searcher, pid_of, sequences, seq_univ, seq_off, seq_len = (
            prepared if prepared is not None
            else self._prepare_scan(candidate_probes, target_genomes))
        logger.info("Computing coverage across %d target genomes "
                    "(%d sequences)", len(target_genomes), len(sequences))

        p_idx, s_idx, st, en = searcher.find_probe_covers_flat(sequences)
        if len(p_idx) == 0:
            z = np.empty(0, dtype=np.int64)
            return z, z.copy(), z.copy(), z.copy()
        # Cover extension, clamped per chromosome, then offset into
        # genome-global coordinates (reference set_cover_filter.py:414-470)
        st = np.maximum(0, st - self.cover_extension)
        en = np.minimum(seq_len[s_idx], en + self.cover_extension)
        return (pid_of[p_idx], seq_univ[s_idx],
                st + seq_off[s_idx], en + seq_off[s_idx])

    def _tolerant_bp_batched(self, searcher, sequences, rc_too=True):
        """Per-searcher-probe bp covered across `sequences` (and their
        reverse complements) under the tolerant model, via ONE batched
        corpus scan instead of a per-sequence/per-strand loop
        (reference :473-530 runs a process pool per sequence here).

        Merging is per (probe, strand-sequence) — identical semantics
        to summing find_probe_covers' merged ranges per strand.
        Returns int64[len(searcher.probes)] of total covered bp.
        """
        strands = list(sequences)
        if rc_too:
            strands += [_reverse_complement(s) for s in sequences]
        bp = np.zeros(len(searcher.probes), dtype=np.int64)
        if not strands:
            return bp
        p_idx, s_idx, st, en = searcher.find_probe_covers_flat(strands)
        if len(p_idx) == 0:
            return bp
        group = p_idx * np.int64(len(strands)) + s_idx
        gk, gs, ge = set_cover._merge_by_group(group, st, en)
        np.add.at(bp, (gk // len(strands)).astype(np.int64), ge - gs)
        return bp

    # Avoided-genome sequences are scanned in batches of about this
    # many bases so human-scale backgrounds stream through the batched
    # scan without materializing the whole FASTA.
    _AVOID_BATCH_BP = 1 << 26

    def _make_ranks(self, candidate_probes, target_genomes_grouped):
        """Integer rank per set id (reference :614-735): tuples
        (0, groupings_hit or 0) / (1, avoided_bp), densified.

        All scans run through the batched corpus path: one scan per
        grouping (both strands at once) for identification, and one
        scan per ~64 Mbp batch of avoided sequence.
        """
        need_searcher = self.identify or len(self.avoided_genomes) > 0
        searcher = None
        pid_of = None
        if need_searcher:
            searcher = ProbeSearcher(
                candidate_probes, self.tolerant_model,
                kmer_probe_map_k=self.kmer_probe_map_k, mesh=self.mesh)
            probe_row = {p: i for i, p in enumerate(searcher.probes)}
            pid_of = np.array(
                [probe_row[p] for p in candidate_probes], dtype=np.int64)

        n_cand = len(candidate_probes)
        if self.identify:
            hits = np.zeros(n_cand, dtype=np.int64)
            for i, genomes_from_group in enumerate(target_genomes_grouped):
                logger.info(
                    "Computing coverage in grouping %d (of %d) to count "
                    "number of groupings hit", i + 1,
                    len(target_genomes_grouped))
                seqs = [s for gnm in genomes_from_group for s in gnm.seqs]
                bp = self._tolerant_bp_batched(searcher, seqs)
                hits += (bp[pid_of] >= 1)
            if np.any(hits == 0):
                logger.critical(
                    "There is a probe that does not 'hit' any target "
                    "genome grouping, but every candidate probe "
                    "should hit at least one")
            rank_val = [(0, int(h)) for h in hits]
        else:
            rank_val = [(0, 0)] * n_cand

        if self.avoided_genomes:
            avoided_bp = np.zeros(n_cand, dtype=np.int64)
            for fasta_path in self.avoided_genomes:
                batch, batch_bp = [], 0
                for sequence in seq_io.iterate_fasta(fasta_path):
                    batch.append(sequence)
                    batch_bp += len(sequence)
                    if batch_bp >= self._AVOID_BATCH_BP:
                        logger.info("Computing coverage across an "
                                    "avoided-sequence batch (%d bp)",
                                    batch_bp)
                        avoided_bp += self._tolerant_bp_batched(
                            searcher, batch)[pid_of]
                        batch, batch_bp = [], 0
                if batch:
                    logger.info("Computing coverage across an "
                                "avoided-sequence batch (%d bp)", batch_bp)
                    avoided_bp += self._tolerant_bp_batched(
                        searcher, batch)[pid_of]
            for i in range(n_cand):
                if avoided_bp[i] > 0:
                    rank_val[i] = (1, int(avoided_bp[i]))

        all_rank_tuples = sorted(set(rank_val))
        tuple_rank_idx = {t: i for i, t in enumerate(all_rank_tuples)}
        return np.array([tuple_rank_idx[t] for t in rank_val],
                        dtype=np.int64)

    def _make_universe_p(self, target_genomes):
        """Required coverage per universe (reference :761-792)."""
        if self.coverage <= 1.0:
            return np.full(len(target_genomes), self.coverage,
                           dtype=np.float64)
        p = np.empty(len(target_genomes), dtype=np.float64)
        for j, gnm in enumerate(target_genomes):
            desired = min(self.coverage, gnm.size())
            p[j] = float(desired) / gnm.size()
        return p

    # ------------------------------------------------------------------

    def _solve_group_device(self, prepared, target_genomes, ranks,
                            universe_p, stats):
        """The fully device-resident scan -> instance -> solve path
        (ops/scan_instance + ops/set_cover.solve_boundary_instance):
        the corpus, candidate pairs, cover spans, and coverage state
        never leave the device; the host reads back per-dispatch
        scalars and the final pick list.  Returns chosen candidate ids
        (np array), or None when the workload takes the host instance
        route (custom model, small corpus, CATCH_TPU_INSTANCE=host, an
        empty instance, or coordinates beyond int32).  Device faults
        propagate.
        """
        import os
        import time as _time
        searcher, pid_of, sequences, seq_univ, seq_off, seq_len = prepared
        if searcher.empty or self.model.custom_fn is not None \
                or searcher.K_static is None:
            return None
        mode = os.environ.get("CATCH_TPU_INSTANCE")
        if mode == "host":
            return None
        total_bp = int(np.sum(seq_len)) if len(seq_len) else 0
        if mode != "force" and total_bp < searcher._BATCH_MIN_BP:
            return None
        from catch_tpu.ops import scan_instance

        rank_vals = np.unique(ranks)
        rank_idx = np.searchsorted(rank_vals, ranks).astype(np.int32)
        costs = np.ones(len(rank_idx), dtype=np.float32)
        t0 = _time.time()
        r = scan_instance.scan_to_boundary_instance(
            searcher, sequences, seq_univ, seq_off, seq_len,
            len(target_genomes), self.cover_extension,
            universe_p, rank_idx, len(rank_vals), costs, pid_of)
        stats["scan_seconds"] += _time.time() - t0
        if r is None:
            return None
        dev, perm = r
        t0 = _time.time()
        if os.environ.get("CATCH_TPU_SOLVE") == "device":
            # All-device greedy: only pick ids leave the device.
            # Slower per pick than the lazy host solver (each step
            # rescans the instance), but independent of host readback
            # bandwidth; kept for validation and for instances whose
            # readback would dominate.
            order = set_cover.solve_boundary_instance(dev, len(perm))
            chosen = pid_of[perm[order]] if len(order) else \
                np.empty(0, dtype=np.int64)
        else:
            # Default: one compact readback of the merged instance,
            # then the lazy-greedy host solver (identical picks).
            inst = scan_instance.instance_to_host(
                dev, perm, pid_of, len(rank_idx), rank_idx,
                len(rank_vals), costs)
            chosen = set_cover.solve_instance(inst)
        stats["solve_seconds"] += _time.time() - t0
        stats["set_cover_picks"] += len(chosen)
        return np.asarray(chosen, dtype=np.int64)

    def _filter(self, input, target_genomes_grouped):
        """Per-group set-cover selection; input is grouped probes."""
        import time as _time
        # The designer's group pipeline calls this once per group;
        # with accumulation on, totals aggregate across those calls
        # instead of each call resetting the run stats.
        stats = getattr(self, "last_run_stats", None)
        if stats is None or not getattr(self, "stats_accumulate", False):
            stats = {"scan_seconds": 0.0, "solve_seconds": 0.0,
                     "candidates_evaluated": 0, "set_cover_picks": 0,
                     "groups_device": 0, "groups_host": 0}
        self.last_run_stats = stats
        selected_probes = []
        for group_i, (possible_probes, target_genomes) in enumerate(
                zip(input, target_genomes_grouped)):
            possible_probes = list(possible_probes)
            logger.info("Building set cover input (group %d of %d)",
                        group_i + 1, len(input))
            if len(possible_probes) == 0:
                selected_probes.append([])
                continue
            prepared = self._prepare_scan(possible_probes, target_genomes)
            ranks = self._make_ranks(possible_probes,
                                     target_genomes_grouped)
            universe_p = self._make_universe_p(target_genomes)
            # Snapshot the searcher's candidate counter: a device scan
            # that hands the group to the host route (empty instance,
            # int32 guard) has already counted its candidates, and the
            # host scan would count the group again.
            cand_before = prepared[0].stats["candidates"]
            chosen = self._solve_group_device(
                prepared, target_genomes, ranks, universe_p, stats)
            stats["groups_device" if chosen is not None
                  else "groups_host"] += 1
            if chosen is None:
                prepared[0].stats["candidates"] = cand_before
                t0 = _time.time()
                set_ids, univ_ids, starts, ends = self._make_cover_arrays(
                    possible_probes, target_genomes, prepared=prepared)
                stats["scan_seconds"] += _time.time() - t0
                inst = set_cover.build_instance_from_cover_arrays(
                    set_ids, univ_ids, starts, ends,
                    n_sets=len(possible_probes),
                    n_universes=len(target_genomes),
                    universe_p=universe_p, ranks=ranks)
                logger.info("Solving set cover instance (group %d of %d)",
                            group_i + 1, len(input))
                t0 = _time.time()
                chosen = set_cover.solve_instance(inst, mesh=self.mesh)
                stats["solve_seconds"] += _time.time() - t0
                stats["set_cover_picks"] += len(chosen)
            stats["candidates_evaluated"] += \
                self._last_searcher.stats["candidates"]
            n_min_rank = int(np.sum(ranks[chosen] > ranks.min())) \
                if len(chosen) else 0
            if n_min_rank:
                logger.warning(
                    "The solution for group %d chose %d probes with rank "
                    "above the minimum (e.g., probes hitting avoided "
                    "genomes or multiple groupings)", group_i, n_min_rank)
            # Deterministic output order: ascending set id = candidate
            # order (the reference iterates a Python set of ints here,
            # set_cover_filter.py:921-928)
            chosen_sorted = np.sort(chosen)
            selected_probes.append(
                [possible_probes[i] for i in chosen_sorted])
        return selected_probes
