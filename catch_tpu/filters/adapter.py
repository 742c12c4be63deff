"""Assigns 'A'/'B' PCR adapters to probes to avoid overlap chains.

Behavioral parity with the reference AdapterFilter
(/root/reference/catch/filter/adapter_filter.py:120-393): per target
sequence, probes selected by greedy earliest-finish interval scheduling
vote 'A' and all other aligned probes vote 'B'; per sequence, the vote
assignment may be flipped if that makes the cumulative plurality sum
more decisive; final adapter per probe is the majority vote ('B' on
ties, since the reference uses strict > for 'A').

The cover finding reuses the device cover engine instead of the
fork-based probe-finding pool.
"""

import logging

from catch_tpu.filters.base import BaseFilter
from catch_tpu.ops.cover import CoverModel, ProbeSearcher
from catch_tpu.utils import dynamic_load, intervals

logger = logging.getLogger(__name__)

__all__ = ["AdapterFilter"]


class AdapterFilter(BaseFilter):
    """Adds 'A' or 'B' adapters to each probe."""

    def __init__(self, adapter_a, adapter_b, mismatches, lcf_thres,
                 island_of_exact_match=0, custom_cover_range_fn=None,
                 kmer_probe_map_k=20):
        """adapter_a/adapter_b are (5'-end, 3'-end) sequence tuples; the
        hybridization model args follow the SetCoverFilter contract."""
        if len(adapter_a) != 2 or len(adapter_b) != 2:
            raise ValueError(
                "adapter_a/adapter_b arguments must be tuples of length "
                "2, giving the sequences to add onto the 5' and 3' ends")
        self.adapter_a_5end, self.adapter_a_3end = adapter_a
        self.adapter_b_5end, self.adapter_b_3end = adapter_b

        if custom_cover_range_fn is not None:
            fn_path, fn_name = custom_cover_range_fn
            fn = dynamic_load.load_function_from_path(fn_path, fn_name)
            self.model = CoverModel(custom_fn=fn)
        else:
            self.model = CoverModel(mismatches, lcf_thres,
                                    island_of_exact_match)
        self.kmer_probe_map_k = kmer_probe_map_k

    def _votes_in_sequence(self, probes, searcher, sequence):
        """Per-probe vote from one sequence: (1,0) 'A' if chosen by
        interval scheduling, (0,1) 'B' if aligned but not chosen,
        (0,0) if not aligned (reference :191-241)."""
        probe_cover_ranges = searcher.find_probe_covers(sequence)
        aligned_probes = set(probe_cover_ranges.keys())
        ivals = []
        for p, cover_ranges in probe_cover_ranges.items():
            for cover_range in cover_ranges:
                ivals.append((cover_range, p))
        chosen_probes = set(intervals.schedule(ivals))
        votes = []
        for p in probes:
            if p in chosen_probes:
                votes.append((1, 0))
            elif p in aligned_probes:
                votes.append((0, 1))
            else:
                votes.append((0, 0))
        return votes

    @staticmethod
    def _sum_plurality(votes):
        return sum(max(v) for v in votes)

    def _make_votes_across_target_genomes(self, probes, target_genomes):
        """Cumulative (A, B) votes per probe across all sequences, with
        the per-sequence flip heuristic (reference :243-296, :334-358)."""
        searcher = ProbeSearcher(probes, self.model,
                                 kmer_probe_map_k=self.kmer_probe_map_k)

        cumulative = [(0, 0)] * len(probes)
        for genomes_from_group in target_genomes:
            for g in genomes_from_group:
                for sequence in g.seqs:
                    votes = self._votes_in_sequence(
                        probes, searcher, sequence)
                    flipped = [(b, a) for (a, b) in votes]
                    with_nonflipped = [
                        (ca + a, cb + b)
                        for (ca, cb), (a, b) in zip(cumulative, votes)]
                    with_flipped = [
                        (ca + a, cb + b)
                        for (ca, cb), (a, b) in zip(cumulative, flipped)]
                    if (self._sum_plurality(with_flipped) >
                            self._sum_plurality(with_nonflipped)):
                        cumulative = with_flipped
                    else:
                        cumulative = with_nonflipped
        return cumulative

    def _filter(self, input, target_genomes):
        """Return the input probes with adapters prepended/appended."""
        input = list(input)
        logger.info("Computing adapter votes across all target genomes")
        votes = self._make_votes_across_target_genomes(
            input, target_genomes)
        logger.info("Adding adapters to probes based on votes")
        out = []
        for p, vote in zip(input, votes):
            assert len(vote) == 2
            if vote[0] > vote[1]:
                new_p = p.with_prepended_str(self.adapter_a_5end) \
                    .with_appended_str(self.adapter_a_3end)
            else:
                new_p = p.with_prepended_str(self.adapter_b_5end) \
                    .with_appended_str(self.adapter_b_3end)
            out.append(new_p)
        return out
