"""TCGA-glioma dataset readers — the counterpart of
``imp_tpu/data/datasets.py``: one generic reader, parameterised by task and
registered under the reference's seven names, over the 5-fold CSV layout

    <root>/tcga_glioma/labels/<task>/<task>_{train,test}_<fold>.csv
    <root>/tcga_glioma/<FEATURE_NAME>/<id>.h5         (patch-feature bag)
    <root>/tcga_glioma/molecular/<id>.csv             (bulk RNA-seq)

The label CSVs are read with the standard library's ``csv`` (columns
``features``, ``labels`` and, for Survival, ``survival_months`` and
``censorship``), so the port needs no pandas.
"""

from __future__ import annotations

import csv
import os.path as osp
from typing import Dict

from ..utils.registry import Registry
from ..utils.tools import verify_str_arg
from .datum import Datum, DatasetBase

DATASET_REGISTRY = Registry("DATASET")

TASK_SPECS: Dict[str, Dict] = {
    "survival": {
        "label_subdir": "labels/survival",
        "csv_prefix": "survival",
        "classnames": {0: "SGrade I", 1: "SGrade II", 2: "SGrade III", 3: "SGrade IIII"},
        "survival": True,
    },
    "classification": {
        "label_subdir": "labels/classification",
        "csv_prefix": "classification",
        "classnames": {
            0: "G4 GBM",
            1: "G4 Astro",
            2: "G3 Astro",
            3: "G2 Astro",
            4: "G3 Oligo",
            5: "G2 Oligo",
        },
        "survival": False,
    },
    "grading": {
        "label_subdir": "labels/grading",
        "csv_prefix": "grading",
        "classnames": {0: "Grade 4", 1: "Grade 3", 2: "Grade 2"},
        "survival": False,
    },
    "subtyping": {
        "label_subdir": "labels/subtyping",
        "csv_prefix": "subtyping",
        "classnames": {0: "GBM", 1: "Astro", 2: "Oligo"},
        "survival": False,
    },
}


def _int(v: str) -> int:
    return int(float(v))


class TCGAGlioma(DatasetBase):
    """Generic TCGA-glioma reader for one task + fold."""

    dataset_dir = "tcga_glioma"
    task = "survival"

    def __init__(self, cfg):
        spec = TASK_SPECS[self.task]
        root = osp.abspath(osp.expanduser(cfg.DATASET.ROOT))
        self.dataset_dir = osp.join(root, type(self).dataset_dir)
        self._meta_folder = osp.join(self.dataset_dir, spec["label_subdir"])
        self._bag_folder = osp.join(self.dataset_dir, cfg.DATASET.FEATURE_NAME)
        self._mol_folder = osp.join(self.dataset_dir, "molecular")
        self._fold = verify_str_arg(cfg.DATASET.FOLD, "Fold", ("1", "2", "3", "4", "5"))
        self.classnames_dict = spec["classnames"]
        self._is_survival = spec["survival"]

        train = self._read_split(
            osp.join(self._meta_folder, f"{spec['csv_prefix']}_train_{self._fold}.csv")
        )
        val = self._read_split(
            osp.join(self._meta_folder, f"{spec['csv_prefix']}_test_{self._fold}.csv")
        )
        test = val  # the reference evaluates val == test (5-fold CV)
        super().__init__(train=train, val=val or None, test=test)

    def _read_split(self, meta_path: str):
        with open(meta_path, newline="") as f:
            rows = list(csv.DictReader(f))
        items = []
        for row in rows:
            bag_name = row["features"]
            patient_id = bag_name.split(".")[0]
            mol_name = bag_name.replace(".h5", ".csv")
            label = _int(row["labels"])
            survival = None
            if self._is_survival:
                survival = {
                    "labels": label,
                    "survival_months": float(row["survival_months"]),
                    "censorship": _int(row["censorship"]),
                }
            items.append(
                Datum(
                    patientid=patient_id,
                    impath=osp.join(self._bag_folder, bag_name),
                    molpath=osp.join(self._mol_folder, mol_name),
                    label=label,
                    classname=self.classnames_dict[label],
                    survival=survival,
                )
            )
        return items


def _make(task_name: str):
    class _DS(TCGAGlioma):
        task = task_name

    return _DS


# all seven reference-registered names resolve to the generic reader
TCGA_Glioma_S = DATASET_REGISTRY.register_as("TCGA_Glioma_S")(_make("survival"))
TCGA_Glioma_S_UMEML = DATASET_REGISTRY.register_as("TCGA_Glioma_S_UMEML")(_make("survival"))
TCGA_Glioma_C = DATASET_REGISTRY.register_as("TCGA_Glioma_C")(_make("classification"))
TCGA_Glioma_C_UMEML = DATASET_REGISTRY.register_as("TCGA_Glioma_C_UMEML")(
    _make("classification")
)
TCGA_Glioma_G = DATASET_REGISTRY.register_as("TCGA_Glioma_G")(_make("grading"))
TCGA_Glioma_G_UMEML = DATASET_REGISTRY.register_as("TCGA_Glioma_G_UMEML")(_make("grading"))
TCGA_Glioma_Sub = DATASET_REGISTRY.register_as("TCGA_Glioma_Sub")(_make("subtyping"))


def build_dataset(cfg) -> DatasetBase:
    return DATASET_REGISTRY.get(cfg.DATASET.NAME)(cfg)
