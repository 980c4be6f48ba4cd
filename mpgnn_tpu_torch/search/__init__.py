"""Greedy metapath search: relation-scoring sweeps on the device, bag
bookkeeping on the host, and the engine that drives them
(main.py:1191-1476)."""

from mpgnn_tpu_torch.search.bags import (  # noqa: F401
    bag_gap_selection,
    build_dictionaries,
    clean_dictionaries,
    connected_relations,
    create_bags,
    flat_gap_selection,
    relabel_from_predictions,
)
from mpgnn_tpu_torch.search.engine import (  # noqa: F401
    MetapathState,
    SearchResult,
    evaluate_and_select,
    find_metapaths,
)
from mpgnn_tpu_torch.search.scoring import (  # noqa: F401
    BagScore,
    FlatScore,
    retrain_bags_predictions,
    score_bag_tasks,
    score_relations_bags,
    score_relations_flat,
)
