"""External-cohort (CPTAC) test set — the counterpart of
``imp_tpu/data/external.py`` (reference ``dataset_new.py:192-389`` and
``tools/test_new.py``): the out-of-distribution evaluation of a trained
model.  The set lives under ``<DATASET.ROOT>/test/`` with

    labels/{survival,grading}/{survival,grading}_test.csv
        (columns: patients, labels[, survival_months, censorship])
    <FEATURE_NAME>/<patient>.h5
    molecular/<patient>.csv        (optional: missing => GAN imputation)

A patient without a bag file is left out.  A slide with no molecular CSV
gets a zero omics vector and ``without_omic = 1``, so UMEML_GAN generates
its omics embedding (the reference's custom_collate keeps None omics and
flips the flag, ``dataset_new.py:381-389``, ``mbtrain.py:438-439``).  The
label CSV is read with the standard library's ``csv``; the JAX package
reads it with pandas.
"""

from __future__ import annotations

import csv
import os.path as osp
from typing import List, Tuple

import numpy as np

from .datum import Datum
from .manager import EpochLoader, SlideDataset, read_molecular

TASK_SUBDIR = {"survival": "survival", "grading": "grading"}
CLASSNAMES = {
    "survival": {0: "SGrade I", 1: "SGrade II", 2: "SGrade III", 3: "SGrade IIII"},
    "grading": {0: "Grade 4", 1: "Grade 3", 2: "Grade 2"},
}


class ExternalSlideDataset(SlideDataset):
    """SlideDataset whose slides may lack their molecular CSV; the omics
    vector is cut or zero-padded to ``omic_dim`` genes."""

    def __init__(self, cfg, data_source, omic_dim: int, cache: bool = True):
        super().__init__(cfg, data_source, cache=cache)
        self.omic_dim = omic_dim

    def _load_raw(self, idx: int):
        molpath = self.data_source[idx].molpath
        mol = read_molecular(molpath) if molpath and osp.isfile(molpath) else None
        return self._load_bag(idx), mol

    def __getitem__(self, idx: int):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        item = self.data_source[idx]
        bag, mol = self._load_raw(idx)
        n = min(bag.shape[0], self.bag_pad)
        img = np.zeros((self.bag_pad, bag.shape[1]), dtype=np.float32)
        img[:n] = bag[:n]
        mask = np.zeros((self.bag_pad,), dtype=bool)
        mask[:n] = True
        missing = mol is None
        if missing:
            mol = np.zeros((self.omic_dim,), np.float32)
        out = {
            "img": img,
            "img_mask": mask,
            "mol": mol[: self.omic_dim] if len(mol) >= self.omic_dim
            else np.pad(mol, (0, self.omic_dim - len(mol))),
            "label": np.int32(item.label),
            "without_omic": np.float32(1.0 if missing else 0.0),
            "patient_id": item.patientid,
            "index": np.int32(idx),
        }
        if self.is_survival:
            out["survival_month"] = np.float32(item.survival["survival_months"])
            out["censorship"] = np.float32(item.survival["censorship"])
        if self._cache is not None:
            self._cache[idx] = out
        return out


def read_external_items(cfg) -> List[Datum]:
    """The external cohort's slides of ``cfg.TASK.NAME`` (Survival or
    Grading), in the label CSV's order."""
    task = cfg.TASK.NAME.lower()
    if task not in TASK_SUBDIR:
        raise ValueError(f"the external cohort has labels for {sorted(TASK_SUBDIR)}, "
                         f"not TASK.NAME={cfg.TASK.NAME!r}")
    sub = TASK_SUBDIR[task]
    base = osp.join(osp.abspath(osp.expanduser(cfg.DATASET.ROOT)), "test")
    bag_dir = osp.join(base, cfg.DATASET.FEATURE_NAME)
    mol_dir = osp.join(base, "molecular")
    names = CLASSNAMES[task]

    with open(osp.join(base, "labels", sub, f"{sub}_test.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    items = []
    for row in rows:
        pid = row["patients"].strip()
        impath = osp.join(bag_dir, pid + ".h5")
        if not osp.isfile(impath):
            continue
        molpath = osp.join(mol_dir, pid + ".csv")
        label = int(float(row["labels"]))
        survival = None
        if task == "survival":
            survival = {
                "labels": label,
                "survival_months": float(row["survival_months"]),
                "censorship": int(float(row["censorship"])),
            }
        items.append(
            Datum(
                patientid=pid,
                impath=impath,
                molpath=molpath if osp.isfile(molpath) else "",
                label=label,
                classname=names[label],
                survival=survival,
            )
        )
    return items


def build_test_new(cfg, omic_dim: int) -> Tuple[ExternalSlideDataset, EpochLoader]:
    ds = ExternalSlideDataset(cfg, read_external_items(cfg), omic_dim=omic_dim)
    loader = EpochLoader(ds, cfg.DATALOADER.TEST.BATCH_SIZE, shuffle=False,
                         prefetch=cfg.TPU.PREFETCH)
    return ds, loader
