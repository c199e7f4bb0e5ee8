"""The port's CLI (`python -m shadow1_tpu_torch run`) against the JAX CLI
(CPU).

* `examples/tgen-2host` to 20 s through both CLIs in this process: the
  same heartbeat.csv bytes, the same summary.json and the same printed
  summary line, except `wall_seconds`;
* the jittered config of chip_smoke.py (JITTER_CONFIG: edge jitter and
  loss, a cpufrequency host) through the port's CLI: heartbeat.csv's
  sha256 and summary.json equal the JAX CLI's constants that chip_smoke.py
  holds the card to (the JAX CLI's own run is the slow test below);
* every JAX flag the port does not carry exits with RC_USAGE and names
  the flag and its ROADMAP item; no card exits with RC_FAILED, and any
  other RuntimeError of the assembly propagates;
* (slow) the JAX CLI reproduces chip_smoke.py's constants (tgen-2host to
  60 s, tgen-100host to 120 s, the jittered config), and the two CLIs
  agree on tgen-100host to 6 s (the clients' first streams start at 5 s;
  the port's plain path on a CPU takes far longer than the JAX package's
  to reach 120 s, which chip_smoke.py holds the card to).
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os

import pytest

from shadow1_tpu import cli as jcli
from shadow1_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    """(rc, printed summary, summary.json, heartbeat.csv bytes) of one CLI
    run, wall_seconds dropped; argv[3] is the data directory."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    line.pop("wall_seconds")
    with open(os.path.join(argv[3], "summary.json")) as f:
        summary = json.load(f)
    summary.pop("wall_seconds")
    with open(os.path.join(argv[3], "heartbeat.csv"), "rb") as f:
        hb = f.read()
    return rc, line, summary, hb


def _argv(config, out, stop=None, extra=()):
    argv = ["run", config, "--data-directory", str(out), "--quiet"]
    return argv + (["--stop-time", str(stop)] if stop else []) + list(extra)


def _port(config, out, stop=None, extra=()):
    return _run(tcli.main,
                _argv(config, out, stop, extra) + ["--device", "cpu"])


def _jax(config, out, stop=None, extra=()):
    return _run(jcli.main, _argv(config, out, stop, extra))


def _constants(rc, line, summary, hb):
    """What chip_smoke.JAX_CLI records of a run."""
    return dict(rc=rc, heartbeat_sha256=hashlib.sha256(hb).hexdigest(),
                summary=summary)


def test_tgen_2host_equals_jax_cli(tmp_path):
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    t = _port(config, tmp_path / "port", 20)
    j = _jax(config, tmp_path / "jax", 20)
    assert j[0] == 0 and j[2]["streams_completed"] >= 2
    assert t[0] == j[0]
    assert t[3] == j[3], "heartbeat.csv differs"
    assert t[2] == j[2], "summary.json differs"
    assert t[1] == j[1], "printed summary differs"
    assert {**t[1], "object_census": t[2]["object_census"]} == t[2]


def test_jitter_config_equals_jax_constants(tmp_path):
    cs = _chip_smoke()
    config = cs.write_jitter_config(tmp_path / "config")
    got = _constants(*_port(config, tmp_path / "port"))
    assert got["summary"]["drops_inet"] > 0
    assert got == cs.JAX_CLI["jitter"]


@pytest.mark.parametrize("argv,flag,item", [
    (["--devices", "2"], "--devices", 9),
    (["--worlds", "2"], "--worlds", 9),
    (["--sweep", "s.json"], "--sweep", 9),
    (["--bucket"], "--bucket", 4),
    (["--netem", "e.json"], "--netem", 5),
    (["--churn", "0.5"], "--churn", 5),
    (["--pcap"], "--pcap", 8),
    (["--log-level", "debug"], "--log-level", 8),
    (["--profile"], "--profile", 8),
    (["--scope", "flows"], "--scope", 8),
    (["--trace-packets", "0.1"], "--trace-packets", 8),
    (["--digest-every", "2"], "--digest-every", 8),
    (["--flight-rows", "64"], "--flight-rows", 8),
    (["--checkpoint-every", "1"], "--checkpoint-every", 8),
    (["--auto-resume"], "--auto-resume", 10),
    (["--watchdog", "5"], "--watchdog", 10),
    (["--progress"], "--progress", 6),
])
def test_refused_flags(argv, flag, item, tmp_path, capsys):
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    out = tmp_path / "out"
    rc = tcli.main(["run", config, "--data-directory", str(out),
                    "--device", "cpu", *argv])
    err = capsys.readouterr().err
    assert rc == tcli.RC_USAGE == 2
    assert flag in err and f"ROADMAP queue 1 item {item}" in err
    assert not out.exists(), "a refused run wrote its data directory"


def test_cubic_flag_runs(tmp_path):
    """`--tcp-congestion-control cubic` is carried: the run exits 0 and
    writes its artifacts (tests/test_torch_cubic.py holds them to the JAX
    CLI's)."""
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    rc, line, summary, hb = _port(config, tmp_path / "out", 3,
                                  ["--tcp-congestion-control", "cubic"])
    assert rc == tcli.RC_OK == 0
    assert summary["simulated_seconds"] == 3.0
    assert hb.count(b"\n") == 1 + 2 * 3      # a row per host a second


def test_no_card_fails_without_running(tmp_path, capsys, monkeypatch):
    """With no card and the default --device, the run exits RC_FAILED,
    names the missing device and writes nothing."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    out = tmp_path / "out"
    rc = tcli.main(["run", config, "--data-directory", str(out)])
    assert rc == tcli.RC_FAILED == 3
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_other_runtime_errors_propagate(tmp_path, monkeypatch):
    """A RuntimeError from assembly other than the missing card (a CUDA
    fault, say) is not reported as a usage error: it propagates."""
    def fail(args):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(tcli, "build_world", fail)
    config = os.path.join(REPO, "examples", "tgen-2host",
                          "shadow.config.xml")
    with pytest.raises(RuntimeError, match="out of memory"):
        tcli.main(["run", config, "--device", "cpu"])


@pytest.mark.slow
def test_jax_cli_constants(tmp_path):
    """The JAX CLI's runs that chip_smoke.JAX_CLI records (~8 min)."""
    cs = _chip_smoke()
    runs = {"tgen-2host": os.path.join(REPO, cs.CLI_2HOST),
            "tgen-100host": os.path.join(REPO, cs.CLI_100HOST),
            "jitter": cs.write_jitter_config(tmp_path / "j")}
    for name, config in runs.items():
        got = _constants(*_jax(config, tmp_path / name))
        assert got == cs.JAX_CLI[name], name


@pytest.mark.slow
def test_tgen_100host_equals_jax_cli(tmp_path):
    """examples/tgen-100host to 6 s through both CLIs."""
    config = os.path.join(REPO, "examples", "tgen-100host",
                          "shadow.config.xml")
    t = _port(config, tmp_path / "port", 6)
    j = _jax(config, tmp_path / "jax", 6)
    assert j[2]["streams_completed"] > 0
    assert t == j
