"""Platform plumbing: compile-cache placement, the GPU-only smoke script,
and no code path for an accelerator the system does not run on."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = str(REPO)
    env.update(overrides)
    return env


@pytest.mark.parametrize("case", ["variable_set", "variable_unset",
                                  "cpu_default"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed,
    git-ignored directory inside the checkout; nothing when the CPU is the
    default platform.  Importing the package must not pick a device."""
    env = {"variable_set": _env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
           "variable_unset": _env(),
           "cpu_default": _env(JAX_PLATFORMS="cpu")}[case]
    out = subprocess.run(
        [sys.executable, "-c",
         "import orb_slam3_study_kr_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    got = out.stdout.strip().splitlines()[-1]
    want = {"variable_set": str(tmp_path),
            "variable_unset": str(REPO / ".jax_cache"),
            "cpu_default": "None"}[case]
    assert got == want
    if case == "variable_unset":
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """With no GPU the smoke script exits non-zero and prints no verdict;
    alone in a directory (no package) it fails too."""
    script = REPO / "chip_smoke.py"
    env = _env(JAX_PLATFORMS="cpu")
    cwd = REPO
    if where == "script_alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
        env.pop("JAX_PLATFORMS")
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_no_code_for_other_accelerators():
    """No Pallas import or backend branch for an accelerator other than the
    GPU, anywhere in the package, the scripts or the tests."""
    other = "tp" + "u"
    pattern = re.compile(
        rf"pallas\.{other}|pallas import {other}|pl{other}|"
        rf"[\"']{other}[\"']|mosaic_{other}|lib{other}", re.IGNORECASE)
    files = [p for p in REPO.rglob("*.py")
             if ".git" not in p.parts and "chiprun_out" not in p.parts
             and p.resolve() != pathlib.Path(__file__).resolve()]
    assert any("ops" in p.parts for p in files)
    hits = [f"{p.relative_to(REPO)}:{i + 1}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines())
            if pattern.search(line)]
    assert not hits, hits
