"""Synthetic on-disk mini-TCGA tree for tests and smoke runs — the
counterpart of ``imp_tpu/data/synthetic.py``, drawing the same numbers from
the same seed, so both packages build the same tree.

It writes the layout the readers expect: 5-fold label CSVs for all four
tasks, per-slide .h5 feature bags under the reference's h5 key, per-slide
molecular CSVs (``gene_name``, ``fpkm_uq_unstranded``) and a
signatures.csv with the six gene groups.  Labels are learnable: each class
shifts the bag features and the survival bin sets survival months.

CSVs go through the standard library's ``csv``; ``h5py`` is imported only
to write the bags, and ``bags=False`` skips them (a host without h5py then
reads bags with its own ``SlideDataset._load_bag``).
"""

from __future__ import annotations

import csv
import json
import os
import os.path as osp

import numpy as np

GENE_GROUP_NAMES = [
    "Tumor Suppressor Genes",
    "Oncogenes",
    "Protein Kinases",
    "Cell Differentiation Markers",
    "Transcription Factors",
    "Cytokines and Growth Factors",
]


def _write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _num(v) -> str:
    """A cell as pandas writes it: ints plain, floats by their repr."""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return repr(float(v))


def materialize(
    root: str,
    num_slides: int = 24,
    bag_min: int = 64,
    bag_max: int = 256,
    feat_dim: int = 512,
    num_genes: int = 240,
    group_size: int = 30,
    feature_name: str = "features_clip_vit_b16",
    h5_key: str = "clip_vit_b32_feature",
    num_folds: int = 5,
    seed: int = 0,
    bags: bool = True,
) -> str:
    """Create the tree under ``root`` and return the dataset root."""
    rng = np.random.default_rng(seed)
    ds = osp.join(root, "tcga_glioma")
    bag_dir = osp.join(ds, feature_name)
    mol_dir = osp.join(ds, "molecular")
    os.makedirs(bag_dir, exist_ok=True)
    os.makedirs(mol_dir, exist_ok=True)
    for sub in ("survival", "classification", "grading", "subtyping"):
        os.makedirs(osp.join(ds, "labels", sub), exist_ok=True)

    gene_names = [f"GENE{g}" for g in range(num_genes)]
    # signatures: six disjoint groups of ``group_size`` genes, ragged columns
    sig = [gene_names[gi * group_size : (gi + 1) * group_size] for gi in range(len(GENE_GROUP_NAMES))]
    max_len = max(len(v) for v in sig)
    _write_csv(osp.join(ds, "labels", "signatures.csv"), GENE_GROUP_NAMES,
               [[col[r] if r < len(col) else "" for col in sig] for r in range(max_len)])

    records = []
    n_surv_bins, n_cls, n_grade, n_sub = 4, 6, 3, 3
    class_dirs = rng.normal(size=(n_cls, feat_dim)).astype(np.float32)
    for i in range(num_slides):
        sid = f"SYN-{i:04d}-01A"
        cls_label = int(i % n_cls)
        surv_bin = cls_label % n_surv_bins
        n_patches = int(rng.integers(bag_min, bag_max + 1))
        bag = rng.normal(size=(n_patches, feat_dim)).astype(np.float32)
        bag += 0.75 * class_dirs[cls_label]
        if bags:
            import h5py

            with h5py.File(osp.join(bag_dir, sid + ".h5"), "w") as f:
                f.create_dataset(h5_key, data=bag)
        expr = rng.lognormal(mean=1.0, sigma=1.0, size=num_genes).astype(np.float32)
        expr[:group_size] += 3.0 * surv_bin  # informative genes
        _write_csv(osp.join(mol_dir, sid + ".csv"), ["gene_name", "fpkm_uq_unstranded"],
                   [[g, _num(v)] for g, v in zip(gene_names, expr)])
        surv_months = float(10.0 + 25.0 * surv_bin + rng.normal(0, 2.0))
        records.append(
            dict(
                features=sid + ".h5",
                cls_label=cls_label,
                grade=cls_label % n_grade,
                subtype=cls_label % n_sub,
                surv_bin=surv_bin,
                survival_months=max(surv_months, 1.0),
                censorship=int(rng.random() < 0.3),
            )
        )

    idx = np.arange(num_slides)
    for fold in range(1, num_folds + 1):
        perm = np.random.default_rng(fold).permutation(idx)
        n_test = max(2, num_slides // 5)
        for split, rows in (("train", perm[n_test:]), ("test", perm[:n_test])):
            for task, label_col, extra in (
                ("survival", "surv_bin", ("survival_months", "censorship")),
                ("classification", "cls_label", ()),
                ("grading", "grade", ()),
                ("subtyping", "subtype", ()),
            ):
                _write_csv(
                    osp.join(ds, "labels", task, f"{task}_{split}_{fold}.csv"),
                    ["features", "labels", *extra],
                    [[records[r]["features"], _num(records[r][label_col]),
                      *(_num(records[r][e]) for e in extra)] for r in rows],
                )

    with open(osp.join(ds, "synthetic_meta.json"), "w") as f:
        json.dump(dict(num_slides=num_slides, feat_dim=feat_dim, num_genes=num_genes,
                       group_size=group_size, seed=seed), f)
    return root
