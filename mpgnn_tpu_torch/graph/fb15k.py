"""FB15K-237 preprocessing, the reference's ``data/fb15k-237/
data_processing.py`` (:27-323): convert a many-to-one relation into node
labels, detach the label relation from the graph, re-id entities and
relations, and build optional bag-of-words + PCA text features.

The same files as the JAX package's ``graph/fb15k.py``, byte for byte, in
numpy and the standard library (no pandas, no sklearn, no NLTK):

* the TSVs are read as ``pandas.read_csv(sep='\\t')`` reads them (blank
  lines skipped, a field that starts with ``"`` quoted); a name in pandas'
  default missing-value set becomes ``nan``, as pandas' NaN prints;
* relations are re-id'd in sorted order (the reference iterates a Python
  set, data_processing.py:191-195);
* continent labels (data_processing.py:19-26, :74-120) resolve names
  through the offline table of ``graph.continents``, with the reference's
  overrides and failed-geocode label 6;
* text cleanup is the JAX package's fallback for a machine without NLTK
  corpora: punctuation stripped, lower case, whitespace collapsed;
* ``build_bow_features`` is CountVectorizer's defaults (lower case,
  ``(?u)\\b\\w\\w+\\b`` tokens, sorted vocabulary) and an exact PCA (centred
  data, SVD, sklearn's ``svd_flip`` on the rows of V^T). sklearn's
  ``PCA(svd_solver='auto')`` takes a randomized solver on large inputs, and
  the JAX package leaves it unseeded, so the two agree only where sklearn
  takes an exact solver (at most 500 rows and columns, or 10x more rows
  than columns).
"""

from __future__ import annotations

import csv
import os
import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpgnn_tpu_torch.graph.continents import continent_of

Triplet = Tuple[str, str, str]   # (source entity, relation, destination)

# pandas.read_csv's default missing-value strings
_NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
])

CONTINENT_IDS = {  # data_processing.py:84-92
    "EU": 0, "AS": 1, "SA": 2, "NA": 3, "AF": 4, "OC": 5, None: 6
}

# the three location relations whose labels geocode to continents
# (data_processing.py:74)
CONTINENT_RELATIONS = (
    "/base/biblioness/bibs_location/country/continent",
    "/base/biblioness/bibs_location/state/continent",
    "/people/person/place_of_birth/continent",
)


def _read_tsv(path: str, width: int) -> List[List[Optional[str]]]:
    """Rows of a tab-separated file, each padded with None (a missing
    value) to ``width`` fields; blank lines skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    return [[None if v in _NA_STRINGS else v for v in r[:width]]
            + [None] * (width - len(r)) for r in rows]


def load_triplet_files(path: str) -> Tuple[List[Tuple[str, str]],
                                           List[Triplet]]:
    """(names, triplets): the (entity, name) rows of ``FB15k_mid2name.txt``
    (a missing name reads ``'nan'``) and the (source, relation,
    destination) rows of train/test/dev.tsv in that order
    (data_processing.py:35-43). A missing split is skipped with a warning:
    the upstream snapshot ships without train.tsv."""
    names = [(e, "nan" if n is None else n) for e, n in
             _read_tsv(os.path.join(path, "FB15k_mid2name.txt"), 2)]
    triplets: List[Triplet] = []
    found = False
    for f in ("train.tsv", "test.tsv", "dev.tsv"):
        fp = os.path.join(path, f)
        if os.path.exists(fp):
            found = True
            triplets.extend(tuple(r) for r in _read_tsv(fp, 3))
        else:
            warnings.warn(f"{fp} missing; continuing without it")
    if not found:
        raise FileNotFoundError(f"no triplet TSVs found under {path}")
    return names, triplets


def many_to_one_relations(triplets: Sequence[Triplet]) -> List[str]:
    """Relations, sorted, whose source entities are all distinct: the
    candidates for label conversion (data_processing.py:45-51)."""
    sources: Dict[str, List[str]] = {}
    for s, r, _ in triplets:
        sources.setdefault(r, []).append(s)
    return [r for r in sorted(sources)
            if len(sources[r]) == len(set(sources[r]))]


def preprocess_fb15k(
    path: str,
    relation: str,
    out_dir: Optional[str] = None,
    descriptions_file: str = "entity2textlong.txt",
    bow_components: int = 100,
    continent_table: Optional[Dict[str, str]] = None,
) -> Dict[str, object]:
    """Write link.dat / node.dat / label.dat / relations_legend.dat (and
    node_bow.dat where descriptions exist) into ``out_dir`` (default
    ``path``) in the reference formats; return the arrays.

    The labels are the destination ids (sorted) of ``relation`` per source
    entity. For one of the three ``*/continent`` pseudo-relations
    (``CONTINENT_RELATIONS``) the graph relation is the prefix without
    ``/continent`` and the labels are the continents of its destinations'
    names (``CONTINENT_IDS``, unknown 6); ``continent_table`` overlays
    extra name -> code entries."""
    out_dir = out_dir or path
    names, triplets = load_triplet_files(path)

    continent_mode = relation in CONTINENT_RELATIONS
    if continent_mode:
        relation = relation[: -len("/continent")]

    filtered = [t for t in triplets if t[1] == relation]
    possible_destinations = sorted(set(t[2] for t in filtered))
    dest_id = {d: i for i, d in enumerate(possible_destinations)}
    continent_counts: Dict[object, int] = {}
    labels_by_entity: Dict[str, int] = {}
    if continent_mode:
        name_of = dict(names)
        for s, _, d in filtered:
            code = continent_of(str(name_of.get(d, "")),
                                extra=continent_table)
            labels_by_entity[s] = CONTINENT_IDS[code]
            continent_counts[code] = continent_counts.get(code, 0) + 1
    else:
        for s, _, d in filtered:
            labels_by_entity[s] = dest_id[d]

    # "link unlinked nodes" (data_processing.py:153-164): for every triplet
    # whose source is a label destination, one copy per labeled source
    source_entities = sorted(set(t[0] for t in filtered))
    dest_set = set(possible_destinations)
    extra = [(elm, r, d) for s, r, d in triplets if s in dest_set
             for elm in source_entities]
    triplets = [t for t in triplets + extra
                if t[1] != relation and t[2] not in dest_set
                and t[0] not in dest_set]

    # entity re-id: name-file order minus the label destinations
    entities = [e for e, _ in names if e not in dest_set]
    entity_id = {e: i for i, e in enumerate(entities)}
    relation_id = {r: i for i, r in enumerate(sorted(set(
        t[1] for t in triplets)))}

    src = np.array([entity_id[t[0]] for t in triplets])
    rel = np.array([relation_id[t[1]] for t in triplets])
    dst = np.array([entity_id[t[2]] for t in triplets])
    labels = {entity_id[e]: v for e, v in labels_by_entity.items()
              if e in entity_id}
    feat_dim = len(possible_destinations) + 1
    num_entities = len(entities)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "link.dat"), "w") as f:
        for s, r, d in zip(src, rel, dst):
            f.write(f"{s}\t{r}\t{d}\n")
    with open(os.path.join(out_dir, "node.dat"), "w") as f:
        # zero features of width |destinations| + 1 (the reference's
        # one-hot fill is commented out, data_processing.py:176-188)
        zeros = "\t".join(["0.0"] * feat_dim)
        for i in range(num_entities):
            f.write(f"{i}\t{zeros}\t\n")
    with open(os.path.join(out_dir, "label.dat"), "w") as f:
        for k, v in labels.items():
            f.write(f"{k}\t{v}\n")
    with open(os.path.join(out_dir, "relations_legend.dat"), "w") as f:
        for r, i in relation_id.items():
            f.write(f"{r}\t{i}\n")

    desc_path = os.path.join(path, descriptions_file)
    if os.path.exists(desc_path) and os.path.getsize(desc_path) > 100:
        bow = build_bow_features(desc_path, entity_id, num_entities,
                                 bow_components)
        with open(os.path.join(out_dir, "node_bow.dat"), "w") as f:
            for i in range(num_entities):
                f.write(str(i) + "\t" + "\t".join(str(v) for v in bow[i])
                        + "\t\n")

    return {
        "src": src, "rel": rel, "dst": dst,
        "labels": labels,
        "num_entities": num_entities,
        "num_relations": len(relation_id),
        "relation_id": relation_id,
        "many_to_one": many_to_one_relations(triplets),
        "label_mode": "continent" if continent_mode else "destination",
        "continent_counts": continent_counts,
    }


def _simple_preprocess(text: str) -> str:
    """Text cleanup (data_processing.py:262-281) without NLTK: strip
    punctuation, lower-case, collapse whitespace."""
    return " ".join(re.sub(r"[^\w\s]", "", text).lower().split())


_TOKEN = re.compile(r"(?u)\b\w\w+\b")


def count_vectorize(texts: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """([texts, vocabulary] int64 counts, sorted vocabulary): sklearn's
    ``CountVectorizer()`` with its defaults."""
    docs = [_TOKEN.findall(t.lower()) for t in texts]
    vocab = sorted(set(w for d in docs for w in d))
    col = {w: j for j, w in enumerate(vocab)}
    counts = np.zeros((len(docs), len(vocab)), dtype=np.int64)
    for i, d in enumerate(docs):
        for w in d:
            counts[i, col[w]] += 1
    return counts, vocab


def pca_transform(x: np.ndarray, n_components: int) -> np.ndarray:
    """[rows, n_components] float64 principal-component scores of ``x``:
    the centred data's SVD, each right singular vector's sign set so that
    its largest entry is positive (sklearn's ``svd_flip`` with
    ``u_based_decision=False``), U * S."""
    xc = np.asarray(x, dtype=np.float64)
    xc = xc - xc.mean(axis=0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    signs = np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(axis=1)])
    return (u * signs)[:, :n_components] * s[:n_components]


def build_bow_features(
    desc_path: str,
    entity_id: Dict[str, int],
    num_entities: int,
    num_components: int = 100,
) -> np.ndarray:
    """Bag-of-words + PCA text features (data_processing.py:293-321): word
    counts of the cleaned descriptions of the entities in ``entity_id``,
    reduced to min(``num_components``, rows, vocabulary) components;
    entities without a description get zero rows. [num_entities, k]
    float64."""
    rows = [r for r in _read_tsv(desc_path, 2) if r[0] in entity_id]
    ids = [entity_id[r[0]] for r in rows]
    bow, vocab = count_vectorize(
        [_simple_preprocess(r[1] or "") for r in rows])
    n_comp = min(num_components, bow.shape[0], bow.shape[1])
    out = np.zeros((num_entities, n_comp), dtype=np.float64)
    out[ids] = pca_transform(bow, n_comp)
    return out
