"""DataManager: host-side input pipeline — the counterpart of
``imp_tpu/data/manager.py`` (reference ``medmm/data/data_manager.py``).

Fixed-shape, boolean-masked numpy batches: bags are padded (or truncated)
to ``DATASET.BAG_PAD`` with an ``img_mask``; gene-group indexes come from
signatures.csv + one molecular CSV; an LRU host cache plus a prefetch
thread overlap bag IO with the card; shuffling is seeded by seed + epoch.

CSVs are read with the standard library's ``csv``; ``h5py`` is imported only
by the bag reader (:meth:`SlideDataset._load_raw`), so a host without it can
run everything else (and substitute its own bag reader).
"""

from __future__ import annotations

import csv
import os.path as osp
import queue
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .datasets import build_dataset
from .datum import Datum, get_event_and_censorship

GENE_GROUP_COLUMNS = [
    "Tumor Suppressor Genes",
    "Oncogenes",
    "Protein Kinases",
    "Cell Differentiation Markers",
    "Transcription Factors",
    "Cytokines and Growth Factors",
]

#: cells pandas reads as missing by default (the JAX package's reader)
_NA = {"", "NA", "N/A", "NaN", "nan", "null", "NULL", "None", "<NA>", "n/a", "-NaN", "-nan"}


def _read_columns(path: str) -> Dict[str, List[str]]:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {h: [] for h in header}
        for row in reader:
            for h, v in zip(header, row):
                cols[h].append(v)
    return cols


def read_molecular(path: str) -> np.ndarray:
    """The ``fpkm_uq_unstranded`` column of a molecular CSV, float32."""
    values = _read_columns(path)["fpkm_uq_unstranded"]
    return np.asarray([float("nan") if v in _NA else float(v) for v in values], np.float32)


def load_gene_group_indexes(signatures_path: str, molecular_csv_path: str) -> List[List[int]]:
    """Row indexes of each gene group inside the per-slide molecular CSV
    (reference ``umeml_gan.py:347-369``)."""
    signatures = _read_columns(signatures_path)
    gene_names = _read_columns(molecular_csv_path)["gene_name"]
    groups = []
    for col in GENE_GROUP_COLUMNS:
        genes = {v for v in signatures[col] if v not in _NA}
        groups.append([i for i, name in enumerate(gene_names) if name in genes])
    return groups


class SlideDataset:
    """Item reader: h5 bag + molecular CSV -> numpy sample dict."""

    def __init__(self, cfg, data_source: List[Datum], cache: bool = True):
        self.cfg = cfg
        self.data_source = data_source
        self.h5_key = cfg.DATASET.H5_KEY
        self.bag_pad = int(cfg.DATASET.BAG_PAD)
        self.is_survival = cfg.TASK.NAME == "Survival"
        # LRU host cache with a byte budget (a 10k x 512 fp32 bag is ~20 MB)
        self._cache: Optional[OrderedDict] = OrderedDict() if cache else None
        self._cache_budget = int(float(getattr(cfg.DATALOADER, "CACHE_GB", 8.0)) * (1 << 30))
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

    def __len__(self):
        return len(self.data_source)

    def _load_raw(self, idx: int):
        import h5py

        item = self.data_source[idx]
        with h5py.File(item.impath, "r") as f:
            bag = np.asarray(f[self.h5_key][:], dtype=np.float32)
        return bag, read_molecular(item.molpath)

    @staticmethod
    def _nbytes(sample: Dict) -> int:
        return sum(v.nbytes for v in sample.values() if isinstance(v, np.ndarray))

    def __getitem__(self, idx: int) -> Dict:
        if self._cache is not None:
            with self._cache_lock:
                if idx in self._cache:
                    self._cache.move_to_end(idx)
                    return self._cache[idx]
        item = self.data_source[idx]
        bag, mol = self._load_raw(idx)
        if bag.shape[0] > self.bag_pad:
            if not getattr(self, "_overflow_warned", False):
                self._overflow_warned = True
                mode = getattr(self.cfg.DATALOADER, "BAG_OVERFLOW", "truncate")
                print(
                    f"WARNING: slide bags exceed DATASET.BAG_PAD={self.bag_pad} "
                    f"(first: {bag.shape[0]} patches); overflow mode: {mode}"
                )
            if getattr(self.cfg.DATALOADER, "BAG_OVERFLOW", "truncate") == "sample":
                # seeded uniform subset, original order
                sel = np.random.default_rng(idx).choice(bag.shape[0], self.bag_pad, replace=False)
                bag = bag[np.sort(sel)]
        n = min(bag.shape[0], self.bag_pad)
        img = np.zeros((self.bag_pad, bag.shape[1]), dtype=np.float32)
        img[:n] = bag[:n]
        mask = np.zeros((self.bag_pad,), dtype=bool)
        mask[:n] = True
        out = {
            "img": img,
            "img_mask": mask,
            "mol": mol,
            "label": np.int32(item.label),
            "patient_id": item.patientid,
            "index": np.int32(idx),
        }
        if self.is_survival:
            out["label"] = np.int32(item.survival["labels"])
            out["survival_month"] = np.float32(item.survival["survival_months"])
            out["censorship"] = np.float32(item.survival["censorship"])
        if self._cache is not None:
            size = self._nbytes(out)
            if size <= self._cache_budget:
                with self._cache_lock:
                    if idx not in self._cache:
                        self._cache[idx] = out
                        self._cache_bytes += size
                    while self._cache_bytes > self._cache_budget and self._cache:
                        _, evicted = self._cache.popitem(last=False)
                        self._cache_bytes -= self._nbytes(evicted)
        return out

    def get_event_and_censorship(self):
        return get_event_and_censorship(self.data_source)


def collate(samples: List[Dict]) -> Dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = list(vals) if key == "patient_id" else np.stack(vals)
    return out


class EpochLoader:
    """Iterable over batches with optional shuffling and thread prefetch."""

    def __init__(self, dataset: SlideDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch * 9973).shuffle(idx)
        for start in range(0, n, self.batch_size):
            yield idx[start : start + self.batch_size]

    def __iter__(self):
        if self.prefetch <= 0:
            for batch_idx in self._index_batches():
                yield collate([self.dataset[int(i)] for i in batch_idx])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for batch_idx in self._index_batches():
                    q.put(collate([self.dataset[int(i)] for i in batch_idx]))
                q.put(sentinel)
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                t.join()
                raise item
            yield item
        t.join()


class DataManager:
    """Builds the dataset + three loaders and exposes derived metadata
    (reference ``data_manager.py:241-344``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        dataset = build_dataset(cfg)
        self.dataset = dataset

        cache = bool(getattr(cfg.DATALOADER, "CACHE", True))
        prefetch = int(cfg.TPU.PREFETCH)
        self.train_set = SlideDataset(cfg, dataset.train, cache=cache)
        self.val_set = SlideDataset(cfg, dataset.val, cache=cache) if dataset.val else None
        self.test_set = SlideDataset(cfg, dataset.test, cache=cache)

        seed = max(cfg.SEED, 0)
        self.train_loader = EpochLoader(
            self.train_set, cfg.DATALOADER.TRAIN.BATCH_SIZE,
            shuffle=cfg.DATALOADER.TRAIN.SAMPLER == "RandomSampler", seed=seed, prefetch=prefetch,
        )
        self.val_loader = (
            EpochLoader(self.val_set, cfg.DATALOADER.TEST.BATCH_SIZE, shuffle=False,
                        prefetch=prefetch)
            if self.val_set
            else None
        )
        self.test_loader = EpochLoader(
            self.test_set, cfg.DATALOADER.TEST.BATCH_SIZE, shuffle=False, prefetch=prefetch
        )

        self.num_classes = dataset.num_classes
        self.lab2cname = dataset.lab2cname

        # ---- omic metadata ------------------------------------------------
        self.omic_dim = None
        self.gene_group_indexes = None
        if dataset.train and dataset.train[0].molpath and osp.isfile(dataset.train[0].molpath):
            self.omic_dim = len(read_molecular(dataset.train[0].molpath))
            sig_path = cfg.DATASET.SIGNATURES
            if not sig_path:
                default = osp.join(osp.abspath(osp.expanduser(cfg.DATASET.ROOT)),
                                   "tcga_glioma", "labels", "signatures.csv")
                sig_path = default if osp.isfile(default) else ""
            if sig_path:
                self.gene_group_indexes = load_gene_group_indexes(
                    sig_path, dataset.train[0].molpath
                )
        if self.gene_group_indexes is None and self.omic_dim:
            # fallback: even chunks (documented deviation — the reference
            # requires signatures.csv; we degrade gracefully without it)
            n_groups = cfg.MODEL.UMEML.PROTOTYPES
            chunk = self.omic_dim // n_groups
            self.gene_group_indexes = [
                list(range(g * chunk, (g + 1) * chunk)) for g in range(n_groups)
            ]

        self._omic_means = None

    @property
    def omic_sizes(self):
        if self.gene_group_indexes is None:
            return []
        return [len(g) for g in self.gene_group_indexes]

    def compute_omic_means(self) -> np.ndarray:
        """Mean molecular vector over the train split — used for in-sample
        omics-deletion imputation (reference ``trainer.py:286-291``)."""
        if self._omic_means is None:
            mols = [self.train_set[i]["mol"] for i in range(len(self.train_set))]
            self._omic_means = np.mean(np.stack(mols), axis=0)
        return self._omic_means

    def show_summary(self):
        print(f"Dataset    {self.cfg.DATASET.NAME}")
        print(f"# classes  {self.num_classes}")
        print(f"# train    {len(self.train_set):,}")
        if self.val_set:
            print(f"# val      {len(self.val_set):,}")
        print(f"# test     {len(self.test_set):,}")
        if self.omic_dim:
            print(f"# genes    {self.omic_dim:,} (groups: {self.omic_sizes})")
