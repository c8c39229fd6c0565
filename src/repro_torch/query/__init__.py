"""Analytics pushdown on compressed data, on the card.

``AggSpec`` describes one aggregate (COUNT / SUM / MIN / MAX / GROUP BY
count with optional top-k) with an optional filter predicate;
``evaluate_aggregates`` executes a batch of specs against a snapshot's
runs and memtable, computing on the packed OPD codes whenever the snapshot
allows it; ``AggPartial`` is the mergeable partial-aggregate contract.
"""

from repro_torch.query.spec import (AggPartial, AggResult, AggSpec, GroupBy,
                                    finalize_partial, merge_partials,
                                    numeric_values)
from repro_torch.query.planner import resolve_specs
from repro_torch.query.executor import evaluate_aggregates

__all__ = [
    "AggSpec", "GroupBy", "AggPartial", "AggResult",
    "finalize_partial", "merge_partials", "numeric_values",
    "resolve_specs", "evaluate_aggregates",
]
