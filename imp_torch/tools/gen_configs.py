"""Generate the full config matrix (4 tasks x 13 methods) — the port's copy
of ``tools/gen_configs.py``, which transcribes the reference code's
experiment settings (its ``configs/``): baselines train 20 epochs at
batch 1 / lr 2e-4 / wd 1e-5 with constant warmup (HFB: lr 1e-5 / wd 1e-6 /
12 epochs); the UMEML family trains 10 epochs at batch 2 with linear warmup
on Survival (fusion=concat, wd 1e-4) and constant warmup elsewhere
(fusion=bilinear, wd 1e-5).  ``configs/Survival/UMEML_GAN_THROUGHPUT.yaml``
is written by hand and not generated.

    python -m imp_torch.tools.gen_configs [--out-dir DIR]

``--out-dir`` (default: the repository's ``configs/``) is the one addition:
the files land in ``DIR/<Task>/<Method>.yaml``.
"""

import argparse
import os
import os.path as osp

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

TASKS = {
    "Survival": dict(
        dataset="TCGA_Glioma_S", umeml_dataset="TCGA_Glioma_S_UMEML",
        task="Survival", loss="nllsurvloss", umeml_loss="nllsurvloss_new",
        evaluator="Survival", umeml_evaluator="Survival_UMEML",
    ),
    "Grading": dict(
        dataset="TCGA_Glioma_G", umeml_dataset="TCGA_Glioma_G_UMEML",
        task="Grading", loss="celoss", umeml_loss="celoss",
        evaluator="Classification", umeml_evaluator="Classification_UMEML",
    ),
    "Classification": dict(
        dataset="TCGA_Glioma_C", umeml_dataset="TCGA_Glioma_C_UMEML",
        task="Classification", loss="celoss", umeml_loss="celoss",
        evaluator="Classification", umeml_evaluator="Classification_UMEML",
    ),
    "Subtyping": dict(
        dataset="TCGA_Glioma_Sub", umeml_dataset="TCGA_Glioma_Sub",
        task="Subtyping", loss="celoss", umeml_loss="celoss",
        evaluator="Classification", umeml_evaluator="Classification_UMEML",
    ),
}

# method -> (model_name_key, optim overrides)
BASELINES = {
    "ABMIL": dict(model="abmil"),
    "TransMIL": dict(model="transmil"),
    "SNN": dict(model="snn"),
    "SNNM": dict(model="snnm"),
    "CLIPOMIC": dict(model="clipomic"),
    "MCAT": dict(model="mcat", fusion="concat"),
    "CMTA": dict(model="cmta", fusion="concat"),
    "Porpoise": dict(model="porpoise", fusion="bilinear"),
    "ConCAT": dict(model="porpoise", fusion="concat"),
    "ADD": dict(model="porpoise", fusion="add"),
    "HFB": dict(model="hfb", lr="1e-5", wd="1e-6", epochs=12),
}

HEADER = """DATASET:
  NAME: "{dataset}"
  FEATURE_NAME: "features_clip_vit_b16"
  TYPE: "{dtype}"
  SURVIVAL_ENDPOINT: "DSS"
  MODALITY: "pathology"
  BAG_PAD: 10000
  PATH:
    FEATURE: "conch"
    SAMPLE: False
    NUM: 4096
    DIM: 512
  OMIC:
    TYPE: "all"
    PATHWAY: "combine"
    DIM: 1000

TASK:
  NAME: "{task}"
  LOSS: "{loss}"

DATALOADER:
  TRAIN:
    BATCH_SIZE: {batch}
  TEST:
    BATCH_SIZE: {batch}
  NUM_WORKERS: 8
"""

OPTIM = """
OPTIM:
  NAME: "adam"
  LR: {lr}
  WEIGHT_DECAY: {wd}
  STEPSIZE: [4000]
  MAX_EPOCH: {epochs}
  ADAM_BETA1: 0.9
  ADAM_BETA2: 0.999
  MOMENTUM: 0.9
  LR_SCHEDULER: "cosine"
  WARMUP_EPOCH: 1
  WARMUP_TYPE: "{warmup}"
  WARMUP_CONS_LR: 1e-5

TRAIN:
  PRINT_FREQ: 100

TEST:
  EVALUATOR: "{evaluator}"
"""


def write(path, text):
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=osp.join(REPO, "configs"),
                    help="root of the <Task>/<Method>.yaml tree (default: the repo's configs/)")
    out_dir = ap.parse_args(argv).out_dir
    for task_dir, t in TASKS.items():
        dtype = "Survival" if task_dir == "Survival" else "Classification"
        # --- baselines -----------------------------------------------------
        for method, m in BASELINES.items():
            if task_dir == "Subtyping" and method in ("CLIPOMIC", "TransMIL"):
                pass  # the reference ships these only partially; keep all
            text = HEADER.format(
                dataset=t["dataset"], dtype=dtype, task=t["task"],
                loss=t["loss"], batch=1,
            )
            text += OPTIM.format(
                lr=m.get("lr", "2e-4"), wd=m.get("wd", "1e-5"),
                epochs=m.get("epochs", 20), warmup="constant",
                evaluator=t["evaluator"],
            )
            text += f"""
MODEL:
  NAME: "{m['model']}"
"""
            if "fusion" in m:
                text += f"  FUSION: {m['fusion']}\n"
            text += """  SIZE: "small"
  DROPOUT: 0.25

TRAINER:
  PREC: "fp32"
"""
            write(osp.join(out_dir, task_dir, method + ".yaml"), text)

        # --- UMEML / UMEML_GAN ----------------------------------------------
        for method in ("UMEML", "UMEML_GAN"):
            survival = task_dir == "Survival"
            text = HEADER.format(
                dataset=t["umeml_dataset"], dtype=dtype, task=t["task"],
                loss=t["umeml_loss"], batch=2,
            )
            if survival:
                text += "\nLOSS:\n  ALPHA: 0.5\n  REDUCTION: \"mean\"\n"
            text += OPTIM.format(
                lr="2e-4", wd="1e-4" if survival else "1e-5", epochs=10,
                warmup="linear" if survival else "constant",
                evaluator=t["umeml_evaluator"],
            )
            text += f"""
MODEL:
  NAME: "{method.lower()}"
  FUSION: {"concat" if survival else "bilinear"}
  SIZE: "small"
  DROPOUT: 0.25
  PROJECT_DIM: 256
  HIDDEN_DIM: 256
  NUM_CLUSTERS: 10
  UMEML:
    PROTOTYPES: 6
    REGISTERS: 3
    ALPHA: 5.0

TRAINER:
  PREC: "fp32"
"""
            write(osp.join(out_dir, task_dir, method + ".yaml"), text)
    print("configs generated")


if __name__ == "__main__":
    main()
