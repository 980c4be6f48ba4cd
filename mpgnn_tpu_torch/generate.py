"""Data-generation CLI (reference: data/run_data.sh + the synthetic
generator's argparse, create_graph_multi_metapath_deterministic.py:440-461,
and the FB15K preprocessor, data_processing.py:325-334). Host only: it
touches no device.

    python -m mpgnn_tpu_torch.generate synthetic --num_nodes 5000 \
        --max_rel_for_node 7 --metapath red-red-blue --overlap 0 \
        --shared_relations 0 --out data/synthetic/my_run
    python -m mpgnn_tpu_torch.generate powerlaw --num_nodes 2000000 \
        --num_edges 100000000 --num_relations 16 --metapath_len 2 \
        --seed 17 --out data/powerlaw_kg_100m --format npy
    python -m mpgnn_tpu_torch.generate fb15k --path data/fb15k-237 \
        --relation /people/person/gender

The same flags, files and summary line as the JAX package's CLI.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="dataset generation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("synthetic", help="planted-metapath synthetic graph")
    sp.add_argument("--num_nodes", type=int, required=True)
    sp.add_argument("--max_rel_for_node", type=int, required=True)
    sp.add_argument("--metapath", type=str, required=True)
    sp.add_argument("--overlap", type=int, default=0)
    sp.add_argument("--shared_relations", type=int, default=0)
    sp.add_argument("--metapath2", type=str, required=False)
    sp.add_argument("--metapath3", type=str, required=False)
    sp.add_argument("--multiclass", action="store_true",
                    help="one label class per planted path (plus background "
                         "class 0) instead of the reference's binary union")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out", type=str, required=True)

    fp = sub.add_parser("fb15k", help="FB15K-237 label-relation conversion")
    fp.add_argument("--path", type=str, required=True)
    fp.add_argument("--relation", type=str, required=True)
    fp.add_argument("--out", type=str, default=None)

    kp = sub.add_parser(
        "powerlaw",
        help="power-law KG with a planted metapath (KG-scale stress load)",
    )
    kp.add_argument("--num_nodes", type=int, required=True)
    kp.add_argument("--num_edges", type=int, required=True)
    kp.add_argument("--num_relations", type=int, default=237)
    kp.add_argument("--metapath_len", type=int, default=2)
    kp.add_argument("--alpha", type=float, default=1.2)
    kp.add_argument("--rel_alpha", type=float, default=1.1)
    kp.add_argument("--num_heads", type=int, default=None)
    kp.add_argument("--seed", type=int, default=0)
    kp.add_argument("--out", type=str, required=True)
    kp.add_argument("--format", type=str, default="dat",
                    choices=["dat", "npy"],
                    help="'dat' = the five reference text files; 'npy' = "
                         "binary per-array .npy files + a float32 feature "
                         "memmap (the out-of-core loading path: at 100M+ "
                         "edges text serialization alone costs minutes and "
                         "the loader would parse GBs of TSV)")

    args = ap.parse_args(argv)
    if args.cmd == "synthetic":
        from mpgnn_tpu_torch.graph.generate import generate_synthetic_graph

        g = generate_synthetic_graph(
            args.num_nodes, args.max_rel_for_node, args.metapath,
            overlap=args.overlap, shared_relations=args.shared_relations,
            seed=args.seed, out_dir=args.out, metapath2=args.metapath2,
            metapath3=args.metapath3, multiclass=args.multiclass,
        )
        extras = [g[k] for k in ("metapath2_relations", "metapath3_relations")
                  if g.get(k) is not None]
        print(
            f"wrote {args.out}: {args.num_nodes} nodes, {len(g['src'])} edges, "
            f"planted metapath (eval order) {g['metapath_relations']}"
            + (f" + extra paths {extras}" if extras else "")
            + (f", {len(set(g['labels'].tolist()))} classes"
               if args.multiclass else "")
        )
    elif args.cmd == "powerlaw":
        from mpgnn_tpu_torch.graph.generate import (
            generate_powerlaw_kg,
            write_npy_dir,
        )

        g = generate_powerlaw_kg(
            args.num_nodes, args.num_edges, args.num_relations,
            metapath_len=args.metapath_len, alpha=args.alpha,
            rel_alpha=args.rel_alpha, num_heads=args.num_heads,
            seed=args.seed,
            out_dir=args.out if args.format == "dat" else None,
        )
        if args.format == "npy":
            write_npy_dir(args.out, g, args.num_relations)
        import numpy as _np

        deg = _np.bincount(g["src"], minlength=args.num_nodes)
        print(
            f"wrote {args.out}: {args.num_nodes} nodes, {len(g['src'])} "
            f"edges, {args.num_relations} relations, planted metapath "
            f"(eval order) {g['metapath_relations']}, "
            f"{len(g['label_nodes'])} labeled "
            f"({int(g['labels'][g['label_nodes']].sum())} positive), "
            f"max out-degree {int(deg.max())}"
        )
    else:
        from mpgnn_tpu_torch.graph.fb15k import preprocess_fb15k

        res = preprocess_fb15k(args.path, args.relation, out_dir=args.out)
        extra = ""
        if res["label_mode"] == "continent":
            extra = f", continent counts {res['continent_counts']}"
        print(
            f"wrote {args.out or args.path}: {res['num_entities']} entities, "
            f"{len(res['src'])} links, {res['num_relations']} relations, "
            f"{len(res['labels'])} labels ({res['label_mode']} mode){extra}"
        )


if __name__ == "__main__":
    main()
