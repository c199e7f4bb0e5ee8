"""Import hygiene of the PyTorch port: shadow1_tpu_torch and chip_smoke.py
must never pull in JAX or the JAX package.

A fresh subprocess (tests/conftest.py imports jax in this one) imports
every module of shadow1_tpu_torch, walked from the filesystem so a
subpackage that fails to import cannot be skipped silently, and asserts
that neither `jax` nor `shadow1_tpu` reached sys.modules.  A text scan of
the package and chip_smoke.py catches imports on code paths an import
does not execute.  Entry points default to the CUDA card and never fall
back to the CPU."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "shadow1_tpu_torch")


def _modules():
    names = []
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                names.append(mod[:-len(".__init__")]
                             if mod.endswith(".__init__") else mod)
    for m in ("core.engine", "core.megakernel", "transport.tcp",
              "transport.cong", "apps.bulk", "cli", "config.assemble",
              "routing.apsp", "observe"):
        assert f"shadow1_tpu_torch.{m}" in names
    return sorted(names)


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_import_pulls_in_no_jax():
    prog = (
        "import sys\n"
        "for m in sys.argv[1:]:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flax' or m.startswith('flax.') or "
        "m == 'shadow1_tpu' or m.startswith('shadow1_tpu.'))\n"
        "assert not bad, bad\n"
        "print('TORCH_HYGIENE_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", prog, *_modules()],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "TORCH_HYGIENE_OK" in out.stdout


def test_sources_name_no_jax():
    pat = re.compile(r"\b(import|from)\s+(jax|flax)\b|\bshadow1_tpu\.\w|"
                     r"\b(import|from)\s+shadow1_tpu\b")
    hits = []
    for path in _sources():
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if pat.search(line.replace("shadow1_tpu_torch", "")):
                    hits.append(f"{os.path.relpath(path, REPO)}:{n}: "
                                f"{line.strip()}")
    assert not hits, "JAX-package references:\n" + "\n".join(hits)


def _entry_points():
    from shadow1_tpu_torch import convert, sim
    from shadow1_tpu_torch.config import assemble
    from shadow1_tpu_torch.core import params, state
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    return {
        "config.assemble.load": lambda: assemble.load(config),
        "sim.build_phold": lambda: sim.build_phold(num_hosts=4),
        "sim.build_bulk": lambda: sim.build_bulk(num_hosts=4),
        "convert.state_from_jax": lambda: convert.state_from_jax({}),
        "convert.params_from_jax": lambda: convert.params_from_jax({}, {}),
        "params.make_net_params": lambda: params.make_net_params(
            [[1]], [[1.0]], [0, 0], [1, 1], [1, 1]),
        "state.make_sim_state": lambda: state.make_sim_state(4),
    }


@pytest.mark.parametrize("name", ["config.assemble.load",
                                  "sim.build_phold", "sim.build_bulk",
                                  "convert.state_from_jax",
                                  "convert.params_from_jax",
                                  "params.make_net_params",
                                  "state.make_sim_state"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every entry point that places tensors takes device=None as the
    CUDA card and raises when there is none; nothing falls back to the
    CPU on its own.  (engine.run_until / run_chunked and the kernel
    wrappers follow the device of the state they are given.)"""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cli_without_a_card_fails(tmp_path):
    """`python -m shadow1_tpu_torch run CONFIG` with no card and no
    `--device cpu` exits non-zero, names the missing device and writes no
    artifact: it does not carry on on the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = tmp_path / "out"
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    r = subprocess.run([sys.executable, "-m", "shadow1_tpu_torch", "run",
                        config, "--data-directory", str(out)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not out.exists() and r.stdout == ""
