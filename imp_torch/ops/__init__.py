"""Ops of the port, each the counterpart of the ``imp_tpu/ops`` module of the
same name: ``attention`` (MHA, Nyström, the exact attention, TransLayer),
``flash_attention`` (K1 forward, K2/K3 backward), ``pinv`` (the fused
Newton-Schulz pseudo-inverse, K6 forward and K7 backward, the counterpart
of ``pinv_kernel.py``), ``modularity`` (K4/K5), ``blocks`` and ``pairing``.
On a CUDA tensor each kernel wrapper launches its Hopper kernel or raises;
on a CPU tensor it runs its plain PyTorch version.

The names exported here are not those of a submodule: an exported
``flash_attention`` function would hide the ``flash_attention`` module from
``import imp_torch.ops.flash_attention as fa``."""

from .attention import PINV_MODES, moore_penrose_pinv
from .modularity import compute_modularity_pair
from .pinv import PinvNewtonSchulz, pinv_newton_schulz

__all__ = [
    "PINV_MODES",
    "PinvNewtonSchulz",
    "compute_modularity_pair",
    "moore_penrose_pinv",
    "pinv_newton_schulz",
]
