"""Filter pipeline: candidate generation and probe filters.

The equivalent of the reference's catch/filter package.
Filters share the BaseFilter contract (catch_tpu/filters/base.py);
the compute-heavy filters (SetCoverFilter, AdapterFilter) drive the
device cover engine (catch_tpu/ops/cover.py) and the device set-cover
solver (catch_tpu/ops/set_cover.py) instead of fork-based process
pools.
"""

from catch_tpu.filters.base import BaseFilter
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.filters.set_cover_filter import SetCoverFilter
from catch_tpu.filters.reverse_complement import ReverseComplementFilter
from catch_tpu.filters.n_expansion import NExpansionFilter
from catch_tpu.filters.polya import PolyAFilter
from catch_tpu.filters.fasta import FastaFilter
from catch_tpu.filters.near_duplicate import (
    NearDuplicateFilterWithHammingDistance, NearDuplicateFilterWithMinHash)
from catch_tpu.filters.adapter import AdapterFilter
from catch_tpu.filters.naive_redundant import NaiveRedundantFilter
from catch_tpu.filters.dominating_set import DominatingSetFilter
