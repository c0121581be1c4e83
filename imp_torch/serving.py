"""Model export + serving — the PyTorch counterpart of ``imp_tpu/serving.py``.

:func:`export_trainer` exports any trainer's own eval forward (the
counterpart of JAX's ``export_trainer``); :func:`export_model` exports a
UMEML_GAN given as a model, its config and a batch template.  The artifact
is a directory that a serving host loads and calls with no model code::

    manifest.json   input/output shapes, model/task metadata, the config,
                    the attention, the pseudo-inverse mode and the device
    model.pt2       the eval forward as a ``torch.export`` program
                    (``torch.export.save``) of the state dict and the
                    batch: static shapes, the trainer's device, K1 and K6
                    as the registered operators ``imp_torch::flash_fwd``
                    and ``imp_torch::pinv_fwd``; it holds no weights
    params.pt       the model's state dict (``torch.save``), the weights'
                    one copy: the program takes it as its first input, so
                    new weights need no new export
    aux.npz         data-derived constants (train-set ``omic_means``)

Two artifact kinds, as in JAX: ``mbtrain`` (UMEML and UMEML_GAN; outputs
``logits``, ``importance_path``, ``importance_omic``) and ``generic``
(every ``StandardTrainer``; output ``logits``).  The program is the forward
the trainer evaluates with: ``model(batch, train=False)`` under its
``TRAINER.PREC`` policy, the model in eval mode, under ``torch.no_grad``.
:func:`load_model` serves it through :class:`ServingModel` and never
imports ``imp_torch.models``; :func:`rebuild_model` rebuilds the live
module from ``params.pt`` and the config, as a reference.  A model that
``torch.export`` cannot take makes the export raise, naming the model and
the error; nothing falls back to the rebuilt module.

Serving keeps the masked fixed-shape contract: ragged bags are padded to
``bag_pad`` with a boolean mask, short batches are wrap-padded to the
exported batch size, and pad rows are dropped from every output.  Export
captures the eval program of one device: :func:`export_trainer` refuses a
trainer on a mesh of more than one rank.
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_unflatten

MANIFEST = "manifest.json"
PROGRAM = "model.pt2"
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


@contextlib.contextmanager
def numerics(prec: str):
    """What every forward of the port runs under, for the extent of a
    call: no TF32 (the model builders turn it off) and the precision
    policy's product setting (:func:`imp_torch.engine.precision.
    bf16_matmul_scope`).  A program does not record these flags."""
    from .engine.precision import bf16_matmul_scope

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        with bf16_matmul_scope(None if prec == "fp32" else torch.bfloat16):
            yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class _Eval(nn.Module):
    """``model(batch, train=False)`` under the precision policy of ``dtype``
    (None: float32), returning those of ``outputs`` that the model gives."""

    def __init__(self, model: nn.Module, outputs: Tuple[str, ...],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model, self.outputs, self.dtype = model, tuple(outputs), dtype

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from .engine.precision import amp_call

        out = amp_call(self.model, "forward", self.dtype, batch, train=False)
        out = out if isinstance(out, dict) else {"logits": out}
        return {k: out[k] for k in self.outputs if k in out}


class EvalForward(nn.Module):
    """The eval forward of a trainer (:class:`_Eval`) as a function of the
    model's state dict and a batch.  The model is held outside the module
    tree, so its program takes the weights as inputs and holds none of its
    own, as JAX's program takes its params: ``params.pt`` is their one copy."""

    def __init__(self, model: nn.Module, outputs: Tuple[str, ...],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self._eval = (_Eval(model, outputs, dtype),)  # a tuple: not a submodule

    def forward(self, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return torch.func.functional_call(
            self._eval[0], {f"model.{k}": v for k, v in state.items()}, (batch,))


def _model_modes(model: nn.Module) -> Tuple[str, Optional[str]]:
    """(attention, pinv_mode) of the TransLayers ``model`` holds:
    ``flash``, ``nystrom`` or ``none``; the Nyström pseudo-inverse's mode,
    or None without a Nyström layer."""
    from .ops.attention import ExactSelfAttention, NystromAttention

    modules = list(model.modules())
    pinv = sorted({m.pinv_mode for m in modules if isinstance(m, NystromAttention)})
    if len(pinv) > 1:
        raise ValueError(f"one pinv_mode per model, found {pinv}")
    attention = ("flash" if any(isinstance(m, ExactSelfAttention) for m in modules)
                 else "nystrom" if pinv else "none")
    return attention, (pinv[0] if pinv else None)


def _write(out_dir: str, model: nn.Module, batch: Dict[str, torch.Tensor], kind: str,
           prec: str, manifest: Dict[str, Any], omic_means) -> Dict[str, Any]:
    """Export ``model``'s eval forward at ``batch``'s static shapes and
    write the artifact; returns the manifest."""
    dtype = None if prec == "fp32" else torch.bfloat16  # the trainers' policy
    forward = EvalForward(model, _MBTRAIN_OUTPUTS if kind == "mbtrain" else ("logits",), dtype)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), numerics(prec):
            program = torch.export.export(forward, (state, batch), strict=False)
    except Exception as e:  # name the model and what stopped the export
        msg = str(e).strip().splitlines()
        raise RuntimeError(f"torch.export cannot export {manifest['model']} "
                           f"({manifest['trainer']}): {type(e).__name__}: "
                           f"{msg[0] if msg else ''}") from e
    finally:
        model.train(was_training)
    if program.state_dict:  # every weight must come from params.pt
        raise RuntimeError(f"the program of {manifest['model']} holds weights of its own: "
                           f"{sorted(program.state_dict)[:4]}")
    spec = program.call_spec.out_spec
    names = list(tree_unflatten([None] * spec.num_leaves, spec))
    attention, pinv_mode = _model_modes(model)
    if pinv_mode:  # every builder of a model with a Nyström layer takes it
        manifest["build"]["kwargs"]["pinv_mode"] = pinv_mode
    first = batch["img" if "img" in batch else "mol" if "mol" in batch else "label"]
    manifest = {
        "format": 2,
        "kind": kind,
        **manifest,
        "batch_size": int(first.shape[0]),
        "torch_version": torch.__version__,
        "device": str(first.device),
        "attention": attention,
        "pinv_mode": pinv_mode,
        "prec": prec,
        "outputs": names,
        "batch_keys": {
            k: {"shape": list(v.shape), "dtype": str(v.cpu().numpy().dtype)}
            for k, v in batch.items()
        },
    }
    if "img" in batch:
        manifest["bag_pad"] = int(batch["img"].shape[1])
        manifest["feat_dim"] = int(batch["img"].shape[2])
    if "mol" in batch:
        manifest["num_genes"] = int(batch["mol"].shape[1])
    os.makedirs(out_dir, exist_ok=True)
    program.example_inputs = None  # the manifest holds the shapes; no batch in the file
    torch.export.save(program, osp.join(out_dir, PROGRAM))
    torch.save({k: v.cpu() for k, v in state.items()}, osp.join(out_dir, PARAMS))
    aux = {} if omic_means is None else {"omic_means": np.asarray(omic_means, np.float32)}
    np.savez(osp.join(out_dir, AUX), **aux)
    with open(osp.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def export_model(
    model,
    cfg,
    batch_template: Dict[str, np.ndarray],
    out_dir: str,
    omic_means: np.ndarray,
) -> Dict[str, Any]:
    """Write ``model`` (a UMEML_GAN of the port), its config and the serving
    input contract ``batch_template`` to the artifact directory ``out_dir``,
    the program exported on the model's device in float32."""
    device = next(model.parameters()).device
    batch = {k: torch.from_numpy(np.asarray(omic_means if k == "omic_means" else v)).to(device)
             for k, v in batch_template.items()}
    groups = [list(g) for g in model.gene_group_indexes]
    return _write(out_dir, model, batch, "mbtrain", "fp32", {
        "model": cfg.MODEL.NAME,
        "trainer": cfg.TRAINER.NAME,
        "task": cfg.TASK.NAME,
        "num_classes": int(model.num_classes),
        "config": cfg.to_dict(),
        "gene_group_indexes": groups,
        "build": {"name": cfg.MODEL.NAME, "num_classes": int(model.num_classes),
                  "kwargs": {"gene_group_indexes": groups}},
    }, omic_means)


def example_eval_batch(trainer) -> Tuple[Dict[str, torch.Tensor], str]:
    """(batch, kind): the first batch of the trainer's test (else val)
    loader as its eval forward takes it, on its device — MBTRAIN's through
    its ``_eval_batch`` with no ablation (``without_omic`` and the
    in-sample mask zero unless the slide has no omics), a
    ``StandardTrainer``'s its ``ARRAY_KEYS`` fields."""
    from .engine.mbtrain import MBTRAIN

    loader = trainer.test_loader or trainer.val_loader
    raw = next(iter(loader))
    if not isinstance(trainer, MBTRAIN):
        return trainer._device_batch(raw), "generic"
    saved = trainer.__dict__.get("_ablation")  # the trainer's own evaluation state
    trainer._set_ablation(loader, 0.0, 0.0)
    try:
        return trainer._eval_batch(raw, "test", 0), "mbtrain"
    finally:
        if saved is None:
            del trainer._ablation
        else:
            trainer._ablation = saved


def _build_spec(trainer, kind: str) -> Dict[str, Any]:
    """What :func:`rebuild_model` passes the model's builder."""
    from .models import survival_num_classes

    cfg = trainer.cfg
    num_classes = survival_num_classes(cfg.TASK.NAME, trainer.num_classes)
    if kind == "mbtrain":
        kwargs = ({"gene_group_indexes": [list(g) for g in trainer.dm.gene_group_indexes or ()]}
                  if trainer.is_gan else {"omic_dim": int(trainer.dm.omic_dim)})
        return {"name": cfg.MODEL.NAME, "num_classes": num_classes, "kwargs": kwargs}
    return {"name": trainer.MODEL_NAME, "num_classes": num_classes,
            "kwargs": trainer.build_kwargs()}


def export_trainer(trainer, out_dir: str) -> Dict[str, Any]:
    """Export ``trainer``'s eval forward to ``out_dir`` (see the module
    docstring), at the static shapes of its first test (else val) batch,
    on its device, under its ``TRAINER.PREC``."""
    if trainer.mesh.size != 1:
        raise ValueError(
            f"export_trainer captures the eval program of one device; this trainer runs "
            f"a {trainer.mesh.shape} mesh — rebuild with TPU.MESH_SHAPE=(1,) for export "
            f"(serving replicates the artifact per replica instead of sharding one call)")
    batch, kind = example_eval_batch(trainer)
    cfg = trainer.cfg
    build = _build_spec(trainer, kind)
    manifest = {
        "model": cfg.MODEL.NAME,
        "trainer": cfg.TRAINER.NAME,
        "task": cfg.TASK.NAME,
        "num_classes": int(trainer.num_classes),
        "config": cfg.to_dict(),
        "build": build,
    }
    if "gene_group_indexes" in build["kwargs"]:
        manifest["gene_group_indexes"] = build["kwargs"]["gene_group_indexes"]
    return _write(out_dir, trainer.model, batch, kind, cfg.TRAINER.PREC, manifest,
                  getattr(trainer, "omic_means", None))


def read_manifest(out_dir: str) -> Dict[str, Any]:
    with open(osp.join(out_dir, MANIFEST)) as f:
        return json.load(f)


def rebuild_model(out_dir: str, device="cuda") -> nn.Module:
    """The live module of an artifact, rebuilt from its config and build
    arguments with the port's model code and loaded from ``params.pt``, on
    ``device`` in eval mode: the reference a served program is held
    against.  Call it as the trainer's eval forward calls the model
    (``model(batch, train=False)``, under ``TRAINER.PREC`` the manifest's
    ``prec``)."""
    from .config import CfgNode, get_cfg_default
    from .engine import fusion_trainers  # noqa: F401  (registers the fusion nets)
    from .models import build_model

    manifest = read_manifest(out_dir)
    cfg = get_cfg_default()
    cfg.merge_from_other_cfg(CfgNode(manifest["config"]))
    cfg.MODEL.UMEML.PROTO_INIT = "uniform"  # the prototypes come from params.pt
    cfg.freeze()
    spec = manifest["build"]
    model = build_model(spec["name"], cfg=cfg, num_classes=spec["num_classes"],
                        device=device, **spec["kwargs"])
    state = torch.load(osp.join(out_dir, PARAMS), map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


class ServingModel:
    """A loaded artifact: pads ragged inputs, calls the exported program on
    ``device``, strips pad rows.  Construct via :func:`load_model`.  A
    program exported on another kind of device is moved with
    ``torch.export.passes.move_to_device_pass``."""

    def __init__(self, out_dir: str, device="cuda"):
        from . import ops  # noqa: F401  (registers the operators the program calls)

        self.manifest = read_manifest(out_dir)
        self.device = torch.device(device)
        program = torch.export.load(osp.join(out_dir, PROGRAM))
        if torch.device(self.manifest["device"]).type != self.device.type:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self._program = program.module()
        self._state = torch.load(osp.join(out_dir, PARAMS), map_location=self.device,
                                 weights_only=True)
        with np.load(osp.join(out_dir, AUX)) as aux:
            self._aux = dict(aux)
        self.batch_size = self.manifest["batch_size"]
        self.bag_pad = self.manifest.get("bag_pad")
        # one call at a time: concurrent HTTP requests queue here
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
        """Run the exported program on a (possibly ragged) host batch.

        ``batch["img"]`` may be a list of per-slide ``[n_i, d]`` bags; other
        expected keys missing from ``batch`` are zero-filled (the ablation
        masks, labels) or taken from the artifact's aux arrays
        (``omic_means``).  Batches smaller than the exported batch size are
        wrap-padded and the pad rows dropped from every output."""
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
        outs = self.call(full)
        return {name: outs[name][:b].float().cpu().numpy() for name in self.manifest["outputs"]}

    def call(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The exported program on a batch of tensors on the device, with
        every key of ``batch_keys`` at its exported shape: the named
        outputs, as tensors."""
        with self._call_lock, torch.no_grad(), numerics(self.manifest["prec"]):
            return self._program(self._state, {k: batch[k] for k in self.manifest["batch_keys"]})

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
    """A threaded stdlib HTTP server around a loaded artifact of either kind.

    * ``GET /health`` — ``{"status": "ok", "kind": ..., ...manifest summary...}``
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
        "kind": model.manifest["kind"],
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
