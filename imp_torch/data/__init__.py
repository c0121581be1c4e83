from .datum import Datum, DatasetBase, get_event_and_censorship
from .datasets import DATASET_REGISTRY, TASK_SPECS, TCGAGlioma, build_dataset
from .manager import (
    DataManager,
    EpochLoader,
    SlideDataset,
    collate,
    load_gene_group_indexes,
    read_molecular,
)
from . import synthetic

__all__ = [
    "Datum",
    "DatasetBase",
    "get_event_and_censorship",
    "DATASET_REGISTRY",
    "TASK_SPECS",
    "TCGAGlioma",
    "build_dataset",
    "DataManager",
    "EpochLoader",
    "SlideDataset",
    "collate",
    "load_gene_group_indexes",
    "read_molecular",
    "synthetic",
]
