"""Datum + DatasetBase — a copy of ``imp_tpu/data/datum.py`` (reference
``medmm/data/datasets/base_dataset.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.tools import check_isfile


class Datum:
    """One sample: WSI-bag .h5 path, molecular .csv path, label, classname,
    survival dict, patient id (reference ``base_dataset.py:17-56`` and the
    UMEML variant ``tcga_glioma_s_umeml.py:17-61``)."""

    def __init__(
        self,
        patientid: str = "",
        impath: str = "",
        molpath: str = "",
        label: int = 0,
        classname: str = "",
        survival: Optional[Dict] = None,
    ):
        assert isinstance(impath, str)
        check_isfile(impath)
        self._patientid = patientid
        self._impath = impath
        self._molpath = molpath
        self._label = int(label)
        self._classname = classname
        self._survival = survival

    patientid = property(lambda self: self._patientid)
    impath = property(lambda self: self._impath)
    molpath = property(lambda self: self._molpath)
    label = property(lambda self: self._label)
    classname = property(lambda self: self._classname)
    survival = property(lambda self: self._survival)


class DatasetBase:
    """Train/val/test splits with label bookkeeping
    (reference ``base_dataset.py:58-218``)."""

    dataset_dir = ""

    def __init__(self, train=None, val=None, test=None):
        self._train = train or []
        self._val = val
        self._test = test or []
        self._num_classes = self.get_num_classes(self._train)
        self._lab2cname, self._classnames = self.get_lab2cname(self._train)

    train = property(lambda self: self._train)
    val = property(lambda self: self._val)
    test = property(lambda self: self._test)
    num_classes = property(lambda self: self._num_classes)
    lab2cname = property(lambda self: self._lab2cname)
    classnames = property(lambda self: self._classnames)

    @staticmethod
    def get_num_classes(data_source: List[Datum]) -> int:
        if not data_source:
            return 0
        return max(item.label for item in data_source) + 1

    @staticmethod
    def get_lab2cname(data_source: List[Datum]):
        container = {(item.label, item.classname) for item in data_source}
        mapping = {label: classname for label, classname in container}
        labels = sorted(mapping.keys())
        classnames = [mapping[l] for l in labels]
        return mapping, classnames


def get_event_and_censorship(data_source: List[Datum]):
    """Per-patient event time / censorship aggregation used for the IPCW
    baseline (reference ``data_manager.py:418-441``)."""
    event_times, censorships = {}, {}
    for data in data_source:
        et = data.survival["survival_months"]
        cs = data.survival["censorship"]
        event_times.setdefault(data.patientid, []).append(et)
        censorships.setdefault(data.patientid, []).append(cs)
    times = np.array([np.mean(v) for v in event_times.values()])
    cens = np.array([int(np.mean(v)) for v in censorships.values()])
    return times, cens
