"""Properties of the PyTorch port that need no card: it imports nothing of
JAX or the JAX package, its entry points default to the card, the CPU
path launches no kernel, and the kernel build fails loudly without nvcc."""
import importlib.util
import os
import pkgutil
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, as the other files)
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.bridge import keystr_name, torch_name
from repro_torch.configs import get_arch
from repro_torch.kernels import build, ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.serving import ServeEngine

ROOT = os.path.join(os.path.dirname(__file__), "..")
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, prefix="repro_torch."))


def test_every_module_is_listed():
    for name in ("repro_torch.kernels.ops", "repro_torch.models.model_zoo",
                 "repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.bridge", "repro_torch.launch.train",
                 "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                 "repro_torch.obs.spans", "repro_torch.obs.telemetry",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.elastic.trainer", "repro_torch.elastic.runtime",
                 "repro_torch.models.mamba2",
                 *(f"repro_torch.core.{m}" for m in (
                     "events", "trace", "scaling", "tfwd", "lp",
                     "objectives", "milp", "milp_fast", "allocator", "loop",
                     "backend"))):
        assert name in MODULES


def test_import_hygiene_no_jax_no_repro():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        f"for m in {MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")


def test_model_defaults_to_cuda_and_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_arch("gemma-2b-smoke"))


def test_serve_engine_defaults_to_cuda_and_raises_without_card():
    _no_card()
    model = Model(get_arch("gemma-2b-smoke"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model)


def test_serve_cli_defaults_to_cuda_and_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b-smoke"])


def test_serve_cli_runs_on_cpu_without_launching_kernels(capsys):
    ops.reset_launches()
    res = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "4", "--dtype", "bfloat16"])
    assert res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < 512)).all()
    assert "device=cpu" in capsys.readouterr().out
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_cpu_forward_prefill_decode_launch_no_kernel():
    ops.reset_launches()
    model = Model(get_arch("gemma-2b-smoke"), device="cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 8)))
    logits, _ = model({"tokens": toks})
    assert torch.isfinite(logits).all()
    _, cache = model.prefill({"tokens": toks}, cache_len=12)
    model.decode_step(cache, toks[:, :1], 8)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_engine_rejects_a_model_on_another_device():
    model = Model(get_arch("gemma-2b-smoke"), device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(model, device="meta")


def test_kernel_build_raises_clearly_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rms_norm(x, torch.empty(8, device="meta"))
    q = torch.empty(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("bad", ["blocks.0", "['blocks'][x]", "['a']b"])
def test_bridge_rejects_non_keystr_names(bad):
    with pytest.raises(ValueError):
        torch_name(bad)


def test_bridge_name_mapping():
    assert torch_name("['blocks'][0]['mixer']['wq']") == "blocks.0.mixer.wq"
    assert torch_name("['embed']") == "embed"
    assert torch_name("['opt_state'].mu['embed']") == "opt_state.mu.embed"
    assert torch_name("['opt_state'].step") == "opt_state.step"
    assert keystr_name("blocks.0.mixer.wq") == "['blocks'][0]['mixer']['wq']"


def _code_lines(path: str) -> list:
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.lstrip().startswith("#")]


def test_control_plane_copies_differ_from_the_jax_package_only_in_imports():
    """The copies are the JAX package's modules with ``repro.`` renamed
    ``repro_torch.``; comment lines may be reworded."""
    names = ["core/" + m for m in (
        "events", "trace", "scaling", "tfwd", "lp", "objectives", "milp",
        "milp_fast", "allocator", "loop", "backend")]
    names += ["obs/spans", "obs/telemetry", "data/pipeline"]
    for name in names:
        want = [ln.replace("repro.", "repro_torch.") for ln in _code_lines(
            os.path.join(ROOT, "src", "repro", name + ".py"))]
        got = _code_lines(os.path.join(ROOT, "src", "repro_torch",
                                       name + ".py"))
        if name == "core/trace":
            # the JAX package's lazy re-exports of its scheduler traces
            # end the file; the port raises for them until sched is copied
            cut = lambda lines: lines[:next(  # noqa: E731
                i for i, ln in enumerate(lines) if ln.startswith("_SCHED"))]
            want, got = cut(want), cut(got)
        assert got == want, name


@pytest.mark.parametrize("cmd", [
    ["chip_smoke.py"],
])
def test_card_only_scripts_exit_2_without_a_card(cmd):
    """The chip script finds no card here: it exits 2 and prints no
    result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env |= {"PYTHONPATH": os.path.join(ROOT, "src"),
            "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, *cmd], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 2, res.stderr
    assert res.stdout == ""


def _ptxas_entry(name: str, regs: int, spills: int = 0) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


@pytest.mark.parametrize("fault,want", [
    (None, {}),
    ("spill", {"tc_spills": ["_ZN2fa13flash_tc_dkdvILi256EEEv"]}),
    ("entry", {"setmaxnreg_bad_entry": {"_ZN2fa12flash_tc_fwdILi256EEEv": 128}}),
])
def test_chip_smoke_build_check_finds_spills_and_wrong_entry_registers(
        fault, want):
    """chip_smoke's build phase reads ptxas' log: a tensor-core kernel
    that spills, or a setmaxnreg kernel (ce_tc_*, flash_tc_fwd,
    flash_tc_dkdv) that does not enter with 168 registers, is a fault;
    flash_tc_dq (no setmaxnreg) may use any count."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = (_ptxas_entry("_ZN2fa12flash_tc_fwdILi256EEEv",
                        128 if fault == "entry" else 168)
           + _ptxas_entry("_ZN2fa13flash_tc_dkdvILi256EEEv", 168,
                          8 if fault == "spill" else 0)
           + _ptxas_entry("_ZN2fa11flash_tc_dqILi256EEEv", 228)
           + _ptxas_entry("_Z9ce_tc_fwdv", 168)
           + _ptxas_entry("_Z9flash_fwdIfLi32EEvv", 64, 12))
    ptxas = smoke.ptxas_report(log)
    assert len(ptxas) == 5 and "Used 228 registers" in ptxas[
        "_ZN2fa11flash_tc_dqILi256EEEv"]
    faults = smoke.tc_faults(ptxas)
    assert faults["tc_kernels"] == {"ce_tc_": 1, "flash_tc_": 3}
    assert faults["setmaxnreg_kernels"] == 3
    assert list(faults["tc_spills"]) == want.get("tc_spills", [])
    assert faults["setmaxnreg_bad_entry"] == want.get(
        "setmaxnreg_bad_entry", {})
