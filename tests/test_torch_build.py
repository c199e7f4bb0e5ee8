"""The port's kernel build keys (shadow1_tpu_torch/core/_build.py), on the
CPU: no nvcc runs here.  A library's name is keyed by the hash of its
`.cu` and of every header it includes, so an edit to a shared phase
header (csrc/*.cuh, the TCP machine's tcp.cuh among them) rebuilds every
kernel that includes it."""

import shutil

from shadow1_tpu_torch.core import _build


def test_sources_follow_includes():
    names = {n: [p.name for p in _build._sources(n)] for n in _build.NAMES}
    assert names["window"][0] == "window.cu"
    assert set(names["window"]) == {
        "window.cu", "exchange.cuh", "deliver.cuh", "transport.cuh",
        "phold_tick.cuh", "bulk_tick.cuh", "tgen_tick.cuh", "tcp.cuh",
        "xla_cbrt.cuh", "common.cuh"}
    for n in ("exchange", "deliver", "transport"):
        assert set(names[n]) == {f"{n}.cu", f"{n}.cuh", "tcp.cuh",
                                 "xla_cbrt.cuh", "common.cuh"}


def test_header_edit_changes_the_key(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = {n: _build.lib_path(n) for n in _build.NAMES}
    with open(src / "deliver.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.NAMES}
    changed = {n for n in _build.NAMES if before[n] != after[n]}
    assert changed == {"deliver", "window"}


def test_tcp_header_edit_rebuilds_every_kernel(tmp_path, monkeypatch):
    """The TCP machine (csrc/tcp.cuh) is one copy of device code that the
    exchange, K_DELIVER, K_TRANSPORT and K_WINDOW all include."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = {n: _build.lib_path(n) for n in _build.NAMES}
    with open(src / "tcp.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.NAMES}
    assert {n for n in _build.NAMES if before[n] != after[n]} == \
        set(_build.NAMES)
