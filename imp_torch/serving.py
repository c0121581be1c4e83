"""Model export + serving — the PyTorch counterpart of ``imp_tpu/serving.py``.

The JAX package AOT-exports a StableHLO program that a serving host calls
with no model code.  This port keeps the artifact's layout minus the
program, and :func:`load_model` rebuilds the model from the manifest with
the port's own code::

    manifest.json   input/output shapes + model/task metadata, the config
                    dict, the gene groups and the attention implementation
    params.pt       the model's state dict (``torch.save``)
    aux.npz         data-derived constants (train-set ``omic_means``)

Serving keeps the masked fixed-shape contract: ragged bags are padded to
``bag_pad`` with a boolean mask, short batches are wrap-padded to the
exported batch size, and pad rows are dropped from every output.
``torch.export`` artifacts and export from a trainer wait for later slices
(ROADMAP.md §A); until then :func:`export_model` takes the pieces directly.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import threading
from typing import Any, Dict, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
PARAMS = "params.pt"
AUX = "aux.npz"

#: output field names of the UMEML eval forward, in exported order
_MBTRAIN_OUTPUTS = ("logits", "importance_path", "importance_omic")

#: batch fields that are replicated, not per-sample — never sliced/chunked
_REPLICATED_KEYS = ("omic_means",)


def survival_risk(logits: np.ndarray) -> np.ndarray:
    """logits → hazards → S → risk = −ΣS, the exact eval math of the
    reference (``medmm/evaluation/evaluator.py:369-382``)."""
    hazards = 1.0 / (1.0 + np.exp(-np.asarray(logits)))
    S = np.cumprod(1.0 - hazards, axis=1)
    return -S.sum(axis=1)


def even_gene_groups(num_genes: int, n_groups: int) -> list:
    """The DataManager's fallback gene groups without a signatures file:
    ``n_groups`` even chunks of ``num_genes // n_groups`` genes."""
    chunk = num_genes // n_groups
    return [list(range(g * chunk, (g + 1) * chunk)) for g in range(n_groups)]


def mbtrain_batch_template(cfg, batch_size: int, num_genes: int) -> Dict[str, np.ndarray]:
    """The host batch the MBTRAIN eval step takes, zero-filled at its
    static shapes: its keys, shapes and dtypes are the serving contract."""
    b, n, d = batch_size, cfg.DATASET.BAG_PAD, cfg.DATASET.PATH.DIM
    return {
        "img": np.zeros((b, n, d), np.float32),
        "img_mask": np.zeros((b, n), bool),
        "mol": np.zeros((b, num_genes), np.float32),
        "without_omic": np.zeros((b,), np.float32),
        "insample_without_omic": np.zeros((b, num_genes), np.int32),
        "omic_means": np.zeros((num_genes,), np.float32),
    }


def export_model(
    model,
    cfg,
    batch_template: Dict[str, np.ndarray],
    out_dir: str,
    omic_means: np.ndarray,
) -> Dict[str, Any]:
    """Write ``model`` (a UMEML_GAN of the port), its config and the serving
    input contract ``batch_template`` to the artifact directory ``out_dir``."""
    hb = batch_template
    manifest = {
        "format": 1,
        "kind": "mbtrain",
        "model": cfg.MODEL.NAME,
        "trainer": cfg.TRAINER.NAME,
        "task": cfg.TASK.NAME,
        "num_classes": int(model.num_classes),
        "batch_size": int(hb["img"].shape[0]),
        "platforms": ["cuda", "cpu"],
        "torch_version": torch.__version__,
        "outputs": list(_MBTRAIN_OUTPUTS),
        "batch_keys": {
            k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype)}
            for k, v in hb.items()
        },
        "bag_pad": int(hb["img"].shape[1]),
        "feat_dim": int(hb["img"].shape[2]),
        "num_genes": int(hb["mol"].shape[1]),
        "config": cfg.to_dict(),
        "gene_group_indexes": [list(g) for g in model.gene_group_indexes],
        "attention": model.attention,
    }
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               osp.join(out_dir, PARAMS))
    np.savez(osp.join(out_dir, AUX), omic_means=np.asarray(omic_means, np.float32))
    with open(osp.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingModel:
    """A loaded artifact: pads ragged inputs, runs the port's eval forward
    on ``device``, strips pad rows.  Construct via :func:`load_model`."""

    def __init__(self, out_dir: str, device="cuda"):
        from .config import CfgNode, get_cfg_default
        from .models import build_model

        with open(osp.join(out_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        cfg = get_cfg_default()
        cfg.merge_from_other_cfg(CfgNode(self.manifest["config"]))
        cfg.TPU.ATTENTION = self.manifest["attention"]
        cfg.freeze()
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(
            self.manifest["model"],
            cfg=cfg,
            num_classes=self.manifest["num_classes"],
            gene_group_indexes=self.manifest["gene_group_indexes"],
            device=self.device,
        )
        state = torch.load(osp.join(out_dir, PARAMS), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state, strict=True)
        with np.load(osp.join(out_dir, AUX)) as aux:
            self._aux = dict(aux)
        self.batch_size = self.manifest["batch_size"]
        self.bag_pad = self.manifest.get("bag_pad")
        # one forward at a time: concurrent HTTP requests queue here
        self._call_lock = threading.Lock()

    # -------------------------------------------------------------- #
    def _pad_bags(self, bags) -> Tuple[np.ndarray, np.ndarray]:
        """Stack ragged per-slide feature bags to [b, bag_pad, d] + mask.
        Bags longer than ``bag_pad`` are truncated."""
        n, d = self.bag_pad, self.manifest["feat_dim"]
        img = np.zeros((len(bags), n, d), np.float32)
        mask = np.zeros((len(bags), n), bool)
        for i, bag in enumerate(bags):
            bag = np.asarray(bag, np.float32)
            t = min(bag.shape[0], n)
            img[i, :t] = bag[:t]
            mask[i, :t] = True
        return img, mask

    def predict(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Run the eval forward on a (possibly ragged) host batch.

        ``batch["img"]`` may be a list of per-slide ``[n_i, d]`` bags; other
        expected keys missing from ``batch`` are zero-filled (the ablation
        masks) or taken from the artifact's aux arrays (``omic_means``).
        Batches smaller than the exported batch size are wrap-padded and the
        pad rows dropped from every output."""
        keys = self.manifest["batch_keys"]
        hb = dict(batch)
        if "img" in keys and "img" in hb and isinstance(hb["img"], (list, tuple)):
            hb["img"], hb["img_mask"] = self._pad_bags(hb["img"])
        per_sample = [k for k in ("img", "mol", "label") if k in hb]
        if not per_sample:
            per_sample = [k for k in hb if k not in _REPLICATED_KEYS]
        b = int(np.shape(hb[per_sample[0]])[0])
        B = self.batch_size
        if b > B:
            raise ValueError(f"batch of {b} exceeds the exported batch size {B}; split it")
        full = {}
        for k, spec in keys.items():
            if k in hb:
                v = np.asarray(hb[k]).astype(spec["dtype"])
            elif k in self._aux:
                v = self._aux[k].astype(spec["dtype"])
            else:  # absent ablation masks etc.: zeros at the exported shape
                v = np.zeros(spec["shape"], spec["dtype"])
            if list(v.shape) != spec["shape"]:
                if v.shape[1:] != tuple(spec["shape"][1:]):
                    raise ValueError(
                        f"batch['{k}'] trailing dims {v.shape[1:]} != exported "
                        f"{tuple(spec['shape'][1:])}"
                    )
                v = v[np.arange(spec["shape"][0]) % v.shape[0]]  # wrap-pad
            full[k] = torch.from_numpy(v).to(self.device)
        with self._call_lock, torch.no_grad():
            out = self.model(full)
            return {
                name: out[name][:b].float().cpu().numpy()
                for name in self.manifest["outputs"]
            }

    def predict_many(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """:meth:`predict` for batches of ANY size: per-sample inputs are
        split into exported-batch-size chunks and the outputs concatenate
        back in order.  Replicated inputs (``omic_means``) pass through."""
        per_sample = [k for k in ("img", "mol", "label") if k in batch]
        if not per_sample:
            per_sample = [k for k in batch if k not in _REPLICATED_KEYS]
        b = len(batch[per_sample[0]])
        B = self.batch_size
        if b <= B:
            return self.predict(batch)

        def sliced(k, v, s, e):
            # KNOWN per-sample keys must match the batch length exactly (a
            # malformed field, e.g. 7 labels for 8 samples, would otherwise
            # be broadcast to every chunk); unknown keys keep the length
            # heuristic (over HTTP everything arrives as JSON lists)
            if k in _REPLICATED_KEYS:
                return v
            n = len(v) if isinstance(v, (list, tuple)) else (
                np.asarray(v).shape[0] if np.ndim(v) else None
            )
            if k in ("img", "mol", "label") and n != b:
                raise ValueError(
                    f"per-sample input {k!r} has length {n}, expected the batch size {b}"
                )
            if isinstance(v, (list, tuple)):  # ragged bag lists
                return list(v[s:e]) if n == b else v
            v = np.asarray(v)
            return v[s:e] if v.ndim and v.shape[0] == b else v

        chunks = [
            self.predict({k: sliced(k, v, s, min(s + B, b)) for k, v in batch.items()})
            for s in range(0, b, B)
        ]
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}

    def require_survival(self) -> None:
        """Raise ValueError unless the artifact is a survival model (risk is
        defined on survival logits only)."""
        if not str(self.manifest["task"]).lower().startswith("survival"):
            raise ValueError(
                f"'risk' is only defined for survival artifacts; "
                f"this export's task is {self.manifest['task']!r}"
            )

    def predict_risk(self, batch: Dict[str, Any]) -> np.ndarray:
        """Survival convenience: logits → hazards → S → risk = −ΣS."""
        self.require_survival()
        return survival_risk(self.predict_many(batch)["logits"])


def load_model(out_dir: str, device="cuda") -> ServingModel:
    return ServingModel(out_dir, device=device)


# =========================================================================
# HTTP serving host (stdlib only; python -m imp_torch.tools.serve)
# =========================================================================


def make_http_server(
    artifact_dir: str, host: str = "127.0.0.1", port: int = 8500, device="cuda"
):
    """A threaded stdlib HTTP server around a loaded artifact.

    * ``GET /health`` — ``{"status": "ok", ...manifest summary...}``
    * ``POST /predict`` — body ``{"batch": {...}, "risk": false}``;
      ``batch["img"]`` may be a ragged list of per-slide ``[n_i, d]`` bags,
      any batch size is accepted.  Response ``{"outputs": {name: lists},
      "batch_size": b}`` plus ``"risk"`` when asked of a survival artifact.
      Bad input answers 400, a failure of the server 500.

    Pass ``port=0`` for an ephemeral port (``server.server_address[1]``).
    Call ``serve_forever()`` to run and ``server_close()`` when done."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    model = ServingModel(artifact_dir, device=device)
    summary = {
        "status": "ok",
        "model": model.manifest["model"],
        "trainer": model.manifest["trainer"],
        "task": model.manifest["task"],
        "batch_size": model.batch_size,
        "bag_pad": model.bag_pad,
        "attention": model.manifest["attention"],
        "device": str(model.device),
        "outputs": model.manifest["outputs"],
        "inputs": model.manifest["batch_keys"],
    }

    class Handler(BaseHTTPRequestHandler):
        server_version = "imp-torch-serve/1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health"):
                self._reply(200, summary)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path.rstrip("/") != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                batch = req.get("batch") or {}
                if not batch:
                    raise ValueError("empty 'batch'")
                want_risk = bool(req.get("risk"))
                if want_risk:
                    model.require_survival()
                outs = model.predict_many(batch)
                resp = {
                    "outputs": {k: v.tolist() for k, v in outs.items()},
                    "batch_size": int(next(iter(outs.values())).shape[0]),
                }
                if want_risk:
                    resp["risk"] = survival_risk(outs["logits"]).tolist()
                self._reply(200, resp)
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:  # bad input shapes/keys/json
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # genuine server-side failure
                import traceback

                traceback.print_exc()
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.serving_model = model
    return server
