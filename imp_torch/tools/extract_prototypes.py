"""PLIP-text prototype extraction for the PyTorch port — the counterpart of
``tools/extract_prototypes.py`` (reference
``extract_prototype_with_plip_train.py:35-112``), with the same CLI:

    python -m imp_torch.tools.extract_prototypes --embeddings X.npy \\
        [--prompts prompts/prompt.json] [--out prototypes_plip.npy] \\
        [--target-dim 256] [--device cuda|cpu]

A linear autoencoder (512 -> 256 -> 512, MSE, Adam at lr 1e-4, 100 epochs
of batch 8, the batch order from ``np.random.default_rng(seed)``) trains on
the prompts' embeddings, one row per prompt in the order of the JSON file
(``--embeddings``, ``[N, 512]``); each category's prototype is the mean of
its prompts' codes, saved as ``[1, n_categories, 256]`` float32 for
``MODEL.UMEML.PROTO_INIT=plip``.  The autoencoder runs on the card unless
``--device cpu``.  ``--plip-dir`` (a local HuggingFace PLIP checkpoint)
needs ``transformers``, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def init_autoencoder(d: int, target_dim: int,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The JAX tool's init: encoder U(±1/√d), decoder U(±1/√target_dim),
    zero biases (drawn from ``generator``: other numbers than JAX's)."""
    bound_e, bound_d = 1.0 / np.sqrt(d), 1.0 / np.sqrt(target_dim)
    return {
        "enc_w": torch.empty(d, target_dim).uniform_(-bound_e, bound_e, generator=generator),
        "enc_b": torch.zeros(target_dim),
        "dec_w": torch.empty(target_dim, d).uniform_(-bound_d, bound_d, generator=generator),
        "dec_b": torch.zeros(d),
    }


def train_autoencoder(embeddings: np.ndarray, target_dim: int = 256, num_epochs: int = 100,
                      batch_size: int = 8, lr: float = 1e-4, seed: int = 0, device="cuda",
                      params: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
    """Linear AE (d -> target_dim -> d), MSE, Adam — the reference's
    schedule.  ``params`` (numpy ``enc_w [d, t]``, ``enc_b``, ``dec_w [t, d]``,
    ``dec_b``) replaces the init drawn from ``seed``; the batch order is
    ``np.random.default_rng(seed)``'s, as in the JAX tool.  Returns the
    trained parameters on ``device``."""
    from ..optim.builders import Chain, Optimizer, ScaleByAdam, ScaleByLearningRate

    device = torch.device(device)
    n, d = embeddings.shape
    if params is None:
        params = init_autoencoder(d, target_dim, torch.Generator().manual_seed(seed))
    names = ("enc_w", "enc_b", "dec_w", "dec_b")
    p = {k: torch.tensor(np.asarray(params[k], np.float32), device=device, requires_grad=True)
         for k in names}
    opt = Optimizer([p[k] for k in names], Chain(ScaleByAdam(), ScaleByLearningRate(lr)))
    x_all = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    rng = np.random.default_rng(seed)
    for epoch in range(num_epochs):
        order = rng.permutation(n)
        losses = []
        for s in range(0, n, batch_size):
            xb = x_all[torch.as_tensor(order[s : s + batch_size], device=device)]
            rec = (xb @ p["enc_w"] + p["enc_b"]) @ p["dec_w"] + p["dec_b"]
            loss = ((rec - xb) ** 2).mean()
            opt.step(torch.autograd.grad(loss, [p[k] for k in names]))
            losses.append(loss.detach() * len(xb))
        if (epoch + 1) % 20 == 0:
            print(f"Epoch {epoch+1:03d}/{num_epochs}, MSE: {float(sum(losses)) / n:.6f}")
    return {k: v.detach() for k, v in p.items()}


def category_prototypes(emb: np.ndarray, counts: Sequence[int],
                        params: Dict[str, torch.Tensor]) -> np.ndarray:
    """The mean code of each category's rows (consecutive, ``counts`` rows
    each), ``[1, n_categories, target_dim]`` float32."""
    z = emb @ params["enc_w"].cpu().numpy() + params["enc_b"].cpu().numpy()
    starts = np.cumsum([0, *counts])
    protos = [z[a:b].mean(axis=0) for a, b in zip(starts[:-1], starts[1:])]
    return np.stack(protos)[None].astype(np.float32)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", default="prompts/prompt.json")
    ap.add_argument("--embeddings", default="", help="precomputed [N,512] .npy")
    ap.add_argument("--plip-dir", default="", help="local HF PLIP checkpoint dir")
    ap.add_argument("--out", default="prototypes_plip.npy")
    ap.add_argument("--target-dim", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="where the autoencoder trains")
    args = ap.parse_args(argv)

    with open(args.prompts) as f:
        prompt_dict = json.load(f)
    categories = list(prompt_dict.keys())
    counts = [len(prompt_dict[c]) for c in categories]

    if args.embeddings:
        emb = np.load(args.embeddings).astype(np.float32)
    elif args.plip_dir:
        emb = encode_prompts_with_plip(args.plip_dir, prompt_dict)
    else:
        raise SystemExit("Provide --embeddings or --plip-dir")
    if emb.shape[0] != sum(counts):
        raise SystemExit(f"{emb.shape[0]} embedding rows for {sum(counts)} prompts ({counts})")

    params = train_autoencoder(emb, target_dim=args.target_dim, device=args.device)
    p_proto = category_prototypes(emb, counts, params)
    np.save(args.out, p_proto)
    print(f"Saved prototypes {p_proto.shape} -> {args.out} (categories: {categories})")
    return p_proto


def encode_prompts_with_plip(plip_dir: str, prompt_dict) -> np.ndarray:
    """Encode prompts with a local HF PLIP text encoder (CPU torch), taking
    the CLS (first) token of the last hidden state like the reference."""
    try:
        from transformers import CLIPProcessor, CLIPTextModel
    except ImportError as e:
        raise SystemExit(f"transformers/torch required for --plip-dir: {e}")
    processor = CLIPProcessor.from_pretrained(plip_dir)
    text_encoder = CLIPTextModel.from_pretrained(plip_dir).eval()
    all_prompts = [p for plist in prompt_dict.values() for p in plist]
    out = []
    with torch.no_grad():
        for i in range(0, len(all_prompts), 8):
            inputs = processor(
                text=all_prompts[i : i + 8], return_tensors="pt",
                padding=True, truncation=True,
            )
            hidden = text_encoder(**inputs).last_hidden_state
            out.append(hidden[:, 0, :].numpy())
    return np.concatenate(out, axis=0).astype(np.float32)


if __name__ == "__main__":
    main()
