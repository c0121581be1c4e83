"""The port's bench tools (``imp_torch.tools.{bench,ab_step,bench_anatomy,
bench_flash,bench_pinv,bench_vit}`` and ``imp_torch.utils.profiling``) on
the CPU at a tiny size (batch 2, bags of 64 x 32, hidden 32, the bench's
3 360 genes): what each knockout and each A/B arm builds, every anatomy
section under the JAX tool's names, the ``--check`` paths of the kernel
tools on the plain versions, the ViT FLOP count against the JAX tool's,
the baseline's keying, and that the timing module imports with no CUDA.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import imp_torch.ops.attention as A
from imp_torch.tools import ab_step, bench, bench_anatomy, bench_flash, bench_pinv, bench_vit

REPO = Path(__file__).resolve().parents[1]
TINY = {"batch_size": 2, "bag_pad": 64, "feat_dim": 32, "hidden": 32, "device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _one_step(replace_ratio=0.0, **kw):
    """(loss, parameters before, parameters after, GAN optimizer steps) of
    one step from seed 0."""
    step, state, batch = bench.build_step(**{**TINY, **kw})
    model = state["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = step(state, batch, torch.Generator().manual_seed(0), replace_ratio)
    gan_steps = [state[k].count for k in ("gen_opt", "dis_p_opt", "dis_o_opt")]
    return loss.item(), before, model.state_dict(), gan_steps


def _moved(before, after, keep):
    return [k for k in before if keep(k) and not torch.equal(before[k], after[k])]


def test_knockouts():
    """``no_gan``: the discriminators stay as they were and no GAN optimizer
    steps (the generators still take the main update: the bench's main
    optimizer holds them, with coupled decay and no mask, in JAX too);
    ``no_opt``: no main parameter moves, the GAN phase still steps;
    ``no_mod``/``no_kd``: each drops its own term from the loss."""
    gan = lambda k: k.startswith(("gan_generator", "gan_discriminator"))  # noqa: E731
    dis = lambda k: k.startswith("gan_discriminator")  # noqa: E731
    full, b0, a0, steps = _one_step()
    assert _moved(b0, a0, dis) and _moved(b0, a0, lambda k: not gan(k)) and steps == [1, 1, 1]
    _, b, a, steps = _one_step(no_gan=True)
    assert not _moved(b, a, dis) and _moved(b, a, lambda k: not gan(k)) and steps == [0, 0, 0]
    _, b, a, steps = _one_step(no_opt=True)
    assert not _moved(b, a, lambda k: not gan(k))
    assert _moved(b, a, gan) and steps == [1, 1, 1]  # the GAN phase still steps
    # the main loss is task + modularity + distillation: each knockout
    # drops its own term, the same one with or without the other
    no_mod = _one_step(no_mod=True)[0]
    no_kd = _one_step(no_kd=True)[0]
    task = _one_step(no_mod=True, no_kd=True)[0]
    mod, kd = full - no_mod, full - no_kd
    assert abs(mod) > 1e-3 and abs(kd) > 1e-3
    np.testing.assert_allclose(no_kd - task, mod, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(no_mod - task, kd, rtol=1e-5, atol=1e-6)


def test_step_is_its_parts():
    """``step`` is ``step.loss_and_grads`` (encode, GAN phase, main loss and
    gradients) then the main update: the same loss and parameters."""
    runs = []
    for whole in (True, False):
        step, state, batch = bench.build_step(**TINY)
        g = torch.Generator().manual_seed(0)
        if whole:
            loss = step(state, batch, g, 0.1)
        else:
            loss, grads = step.loss_and_grads(state, batch, g, 0.1)
            state["opt_state"].step(grads)
        runs.append((loss.item(), state["model"].state_dict()))
    (loss_a, a), (loss_b, b) = runs
    assert loss_a == loss_b
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("knob", ab_step.KNOBS)
def test_ab_step_arms_build_their_variants(knob, monkeypatch):
    fused_calls = []
    fused = A.pinv_newton_schulz
    monkeypatch.setattr(A, "pinv_newton_schulz",
                        lambda *a, **k: fused_calls.append(1) or fused(*a, **k))
    # the fused pseudo-inverse takes m % 128 == 0: 128 landmarks at hidden 256
    shape = {**TINY, "hidden": 256} if knob == "pinv" else TINY
    arms = {}
    for arm in ("A", "B"):
        kw = ab_step.arm_kwargs(knob, arm)
        step, state, batch = bench.build_step(**shape, **kw)
        fused_calls.clear()
        loss = step(state, batch, torch.Generator().manual_seed(0), 0.1)
        arms[arm] = (kw, state["model"], loss.item(), len(fused_calls))
    (kw_a, model_a, loss_a, fused_a), (kw_b, model_b, loss_b, fused_b) = arms.values()
    if knob == "head_fused":
        assert model_a.head_fused and not model_b.head_fused
    elif knob == "pinv":
        assert {m.pinv_mode for m in model_a.modules() if isinstance(m, A.NystromAttention)} \
            == {"fused"}
        assert fused_a == 6 and fused_b == 0  # six TransLayers with grad a step
    elif knob == "stacked":
        assert hasattr(model_a, "pair_decoder") and not hasattr(model_b, "pair_decoder")
        assert hasattr(model_b, "path_decoder")
    elif knob == "bagbf16":
        assert model_a.bag_dtype == torch.bfloat16 and model_b.bag_dtype is None
    elif knob == "prec":
        assert kw_a == {"prec": "bf16"} and kw_b == {"prec": "fp32"}
        assert loss_a != loss_b  # computed in bf16
    else:
        assert kw_a == kw_b == {} and loss_a == loss_b
    assert np.isfinite(loss_a) and np.isfinite(loss_b)


def test_anatomy_sections_run_under_the_jax_names():
    jax_names = re.findall(r'timed\("([^"]+)"', (REPO / "tools" / "bench_anatomy.py").read_text())
    assert list(bench_anatomy.SECTIONS) == jax_names
    results = bench_anatomy.run(iters=1, **TINY)
    assert list(results) == jax_names
    for name, r in results.items():
        assert r["finite"] and np.isfinite(r["host_ms"]) and r["device_busy_ms"] is None, name
        assert r["launches_per_call"] == {}, name  # the plain versions on the CPU


def test_bench_flash_check_on_the_plain_versions():
    out = bench_flash.main(["--n", "64", "--iters", "1", "--check", "--device", "cpu"])
    errs = ("fwd_rel_err", "dq_rel_err", "dk_rel_err", "dv_rel_err")
    assert max(out["check"]["fp32"][k] for k in errs) < 1e-4
    assert max(out["check"]["bf16"][k] for k in errs) < 3e-2  # bf16 operands
    assert out["flops"] == 4 * 2 * 8 * 64 * 64 * 32
    assert set(out["timed"]) == {"bf16", "fp32"}
    for t in out["timed"].values():  # the plain version on the CPU launches nothing
        assert t["launches_per_call"] == dict.fromkeys(bench_flash.FLASH_KERNELS, 0.0)


def test_bench_pinv_check_on_the_plain_versions():
    out = bench_pinv.main(["--g", "2", "--m", "16", "--check", "--timing-iters", "1",
                           "--device", "cpu"])
    assert out["check"]["fwd_rel_err"] < bench_pinv.FWD_TOL
    assert out["check"]["grad_rel_err"] < bench_pinv.GRAD_TOL
    assert set(out["ms"]) == {"fused fwd", "fused fwd+bwd", "chain fwd", "chain fwd+bwd"}


def test_vit_flops_match_the_jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bench_vit", REPO / "tools" / "bench_vit.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for name in ("ViT-B/16", "ViT-B/32"):
        assert bench_vit.vit_flops_per_image(name) == jax_tool.vit_flops_per_image(name)


def test_bench_windows_and_the_baseline_keying(tmp_path):
    step, state, batch = bench.build_step(**TINY)
    timing = bench.time_windows(step, state, batch, 2, "cpu", burn_in=1, windows=3,
                                window_steps=1)
    assert len(timing["windows"]) == 3 and timing["best"] == max(timing["windows"])
    assert timing["value"] == sorted(timing["windows"])[1]
    assert timing["launches_per_step"] == dict.fromkeys(bench.STEP_KERNELS, 0.0)  # plain on CPU
    desc = bench.describe(2, 64, 32, 3360, 32, "fp32", state["model"], {"no_gan": False}, "cpu")
    assert desc["attention"] == "nystrom" and desc["pinv_mode"] == "chain"
    path = str(tmp_path / "output" / "baseline.json")
    assert bench.baseline_ratio(path, desc, 100.0) == 1.0  # a new key records itself
    assert bench.baseline_ratio(path, desc, 50.0) == 0.5
    other = {**desc, "batch": 8}
    assert bench.baseline_ratio(path, other, 10.0) == 1.0  # never compared with batch 2
    assert bench.baseline_ratio(path, {**desc, "prec": "bf16"}, 7.0) == 1.0
    with open(path) as f:
        table = json.load(f)
    assert len(table) == 3 and table[json.dumps(desc, sort_keys=True)]["slides_per_sec"] == 100.0
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.check_device("cuda")


def test_profiling_imports_with_no_cuda():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'triton', 'imp_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from imp_torch.utils import profiling\n"
        "assert not torch.cuda.is_available()\n"
        "ms = profiling.call_ms(lambda: torch.ones(4).sum(), 2, 'cpu')\n"
        "print('ok', ms >= 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=str(REPO), timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok True", res.stderr
