"""Central configuration (a copy of the JAX package's ``config.py``).

Every magic number that is hard-coded in the reference becomes a named field
here (reference locations cited per field). A single frozen dataclass flows
through the search engine so experiments are reproducible and checkpointable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ScorerConfig:
    """Relation-scorer hyperparameters (reference: main.py)."""

    lr: float = 0.1                      # main.py:522  (Adam for Score model)
    epochs_flat: int = 100               # main.py:755  (hop-0 relation scoring)
    epochs_bags: int = 50                # main.py:890  (bag scoring per restart)
    max_consecutive_misses: int = 2      # main.py:884  (while rest < 2)
    freeze_loss_threshold: float = 1e-4  # main.py:540  (retrieve_destinations_low_loss)
    init_noise: float = 0.2              # main.py:491-492 (U(-0.2, 0.2) around min label)
    weight_clamp_min: float = 0.0        # main.py:668
    weight_clamp_max: float = 1.0        # main.py:668-669
    # Hard cap on restart iterations so a vmapped sweep has a static bound.
    # The reference has no cap; empirically restarts converge in < 10 rounds.
    max_restarts: int = 16


@dataclasses.dataclass(frozen=True)
class BagConfig:
    """Bag construction / relabeling thresholds (reference: main.py)."""

    positive_min_label: float = 0.9      # main.py:553  (min(dest labels) > 0.9)
    relabel_threshold: float = 0.9       # main.py:613  (max(pred) > 0.9)
    attribution_threshold: float = 0.01  # main.py:460  (clean_dictionaries dot < 0.01)


@dataclasses.dataclass(frozen=True)
class MPGNNConfig:
    """Metapath-GNN evaluation hyperparameters (reference: main.py)."""

    lr: float = 0.01                     # main.py:1119
    weight_decay: float = 5e-4           # main.py:1119
    epochs: int = 1000                   # main.py:1121 / 1145
    hidden_dim: int = 64                 # run.sh (--hidden_dim 64)
    dropout: float = 0.6                 # model.py:200-201
    # Mixed precision: "float32" (reference parity) or "bfloat16" in the
    # JAX package. The port trains in float32 only and refuses "bfloat16"
    # (ROADMAP.md A1).
    compute_dtype: str = "float32"
    # Aggregation backend for MPGNN training/eval. The port trains with
    # "segment" (gather + index_add_), "csr" (the sorted-CSR kernels K1/K2)
    # and "pallas" (the fused dense RelConv kernels K3/K4); the JAX
    # package's "auto", "dense", "ell", "ell2", "onehot" and "halo" raise
    # until they are ported (ROADMAP.md A1, A3, A12).
    backend: str = "segment"
    # Dropout-mask RNG, kept for parity of the config with the JAX
    # package. In the port every value means the same thing: masks are
    # drawn from a torch.Generator on the training device, seeded from the
    # run's seed. The JAX package's "rbg" (XLA's RngBitGenerator, a TPU
    # device feature) has no counterpart and is not inherited.
    dropout_rng: str = "auto"
    # Weight decompositions of CustomRGCNConv (mp_rgcn_layer.py:120-137):
    # num_bases shares B basis matrices across hop convs' weights; num_blocks
    # makes every hop weight block-diagonal. None = full weights, the only
    # form the port trains so far (ROADMAP.md A4).
    num_bases: Optional[int] = None
    num_blocks: Optional[int] = None
    # Halo (node-sharded) collective: "a2a" or "ppermute" in the JAX
    # package. The port has no halo backend yet and refuses any value but
    # the default (ROADMAP.md A12).
    halo_exchange: str = "a2a"
    # Halo local aggregation: "segment", "csr" or "auto" in the JAX
    # package. The port refuses any value but the default (ROADMAP.md A12).
    halo_local: str = "auto"


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search-loop structure (reference: main.py:1191-1476)."""

    max_extension_hops: int = 3          # main.py:1381 (for k in range(3) -> max length 4)
    # False = reference parity (strict < bag gap cut, main.py:1424 — an
    # upstream bug that blocks extension exactly when one relation clearly
    # wins); True = hop-0-style <= cut (recommended for >= 4-relation data)
    bag_gap_inclusive: bool = False
    # Bounded frontier (documented divergence, like bag_gap_inclusive):
    # after each gap cut keep at most this many lowest-loss survivors per
    # state (None = reference parity: keep every survivor). The reference's
    # faithful np.diff cut can keep essentially ALL candidates — on a
    # 237-relation power-law KG it kept 236/237 hop-1 extensions (the
    # largest gap sat under the single worst relation, main.py:1410-1424),
    # fanning hop 2 out to ~56k (state, relation) instances that neither
    # the reference nor any faithful port would finish. A beam cap makes
    # many-relation searches terminate; planted-path recovery is unaffected
    # whenever the true relation scores in the top-k (it scores loss≈0).
    max_extensions_per_state: Optional[int] = None
    top_k_final: int = 3                 # main.py:1465 (best 3 metapaths by val F1)
    seed: int = 30                       # main.py:31-32 (torch.manual_seed(30))
    split_seed: int = 415                # main.py:293 (train_test_split random_state)
    scorer: ScorerConfig = dataclasses.field(default_factory=ScorerConfig)
    bags: BagConfig = dataclasses.field(default_factory=BagConfig)
    mpgnn: MPGNNConfig = dataclasses.field(default_factory=MPGNNConfig)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset location + format selection (reference CLI: main.py:1489-1506)."""

    dataset: str = "synthetic"           # synthetic | fb15k-237 | DBLP | IMDB | ACM
    folder: str = ""
    node_file: str = "node.dat"
    link_file: str = "link.dat"
    label_file: str = "label.dat"
    relations_legend_file: Optional[str] = None


DEFAULT_SEARCH = SearchConfig()
