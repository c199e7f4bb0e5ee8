"""Loopback emissions in the port (engine._loopback_insert) against the
JAX package (CPU).

* `_stage_emissions` on the 4-host tgen world with random emission lanes
  of which many address their own host, inbox slabs filled so that some
  have no free slot left, with and without loss and the PDS trail: the
  state and the placed mask, leaf for leaf;
* the loopback world of chip_smoke.py (host 0 listens and runs the
  client graph with itself as its peer, the other hosts stream to it)
  to 6 s on the port's persistent and per-phase paths, leaf for leaf
  against the JAX reference graph, whose trajectory is the constant
  chip_smoke.py holds the card to.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu import sim as jsim
from shadow1_tpu.apps import tgen as jtgen
from shadow1_tpu.core import emit as jemit
from shadow1_tpu.core import engine as jeng
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.apps import tgen as ttgen
from shadow1_tpu_torch.core import emit as temit
from shadow1_tpu_torch.core import engine as teng

from _torch_parity import assert_same, jax_statics, jax_tree

MS = 1_000_000
SEC = 1_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_loopback_world(**kw):
    """chip_smoke.loopback_world built by the JAX package."""
    cs = _chip_smoke()
    h = cs.LOOP_HOSTS
    js, jp, ja = jsim.build_tgen(h, **kw)
    srv = jtgen.parse_tgen(jsim._TGEN_SERVER_XML.format(port=8888))
    cli = jtgen.parse_tgen(jsim._TGEN_CLIENT_XML.format(
        port=8888, sendsize=50 * 1024, recvsize=200 * 1024, streams=3))
    app = jtgen.build_state(h, [srv, cli], np.ones(h, np.int64),
                            cs.loopback_start_times(h),
                            resolve_peer=lambda s: (0, 8888))
    return js.replace(app=app), jp, ja


@functools.lru_cache(maxsize=None)
def _jax_run():
    js, jp, ja = _jax_loopback_world()
    return jeng.run_until(js, jp.replace(megakernel=False), ja,
                          _chip_smoke().LOOP_NS)


def test_loopback_world_equals_jax_world():
    cs = _chip_smoke()
    js, jp, _ja = _jax_loopback_world()
    ts, tp, ta = cs.loopback_world(device="cpu")
    assert_same(convert.to_numpy(ts), jax_tree(js), "loopback world state")
    assert_same(convert.to_numpy(tp), jax_tree(jp), "loopback world params")
    assert (ts.app.cur >= 0).all() and teng._may_loopback(ta)


@pytest.mark.parametrize("persistent", [True, False])
def test_loopback_run_equals_jax(persistent):
    cs = _chip_smoke()
    jout = _jax_run()
    assert cs.tgen_summary(jout) == cs.JAX_LOOP_FINAL
    ts, tp, ta = cs.loopback_world(persistent=persistent, device="cpu")
    tout = teng.run_until(ts, tp, ta, cs.LOOP_NS)
    assert_same(convert.to_numpy(tout), jax_tree(jout),
                f"loopback world persistent={persistent}")


@functools.lru_cache(maxsize=None)
def _jax_stage(pds_trail, lossy):
    js, jp, ja = _jax_loopback_world(reliability=0.9 if lossy else 1.0)
    jp = jp.replace(pds_trail=pds_trail)
    fn = jax.jit(lambda s, em, t, act: jeng._stage_emissions(
        s, jp, em, t, act, ja, jp.bw_up_Bps))
    return js, jp, fn


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pds_trail,lossy", [(False, False), (True, True)])
def test_stage_emissions_loopback_equals_jax(seed, pds_trail, lossy):
    """Every host stages up to E emissions, about half to itself; its
    inbox slab keeps 0, 1, 3 or all of its free slots, so the loopback
    rows take free slots in ascending order around taken ones, and some
    overflow (counted drops, ERR_POOL_OVERFLOW)."""
    js, jp, fn = _jax_stage(pds_trail, lossy)
    rng = np.random.default_rng(seed)
    tree = jax_tree(js)
    ib = {k: np.array(v) for k, v in tree["inbox"].items()}
    pool = {k: np.array(v) for k, v in tree["pool"].items()}
    h = tree["hosts"]["send_ctr"].shape[0]
    p1, ic = ib["blk"].shape
    ki = p1 // h
    keep_free = rng.choice([0, 1, 3, ki], h)
    for hh in range(h):
        taken = rng.permutation(ki)[:ki - keep_free[hh]]
        ib["stage"][hh * ki + taken] = 2
        ib["blk"][hh * ki + taken] = rng.integers(0, 1 << 30, (len(taken),
                                                                ic))
    p0 = pool["stage"].shape[0]
    pool["stage"] = rng.choice(np.array([0, 0, 1, 2], np.int32), p0)
    tree["inbox"], tree["pool"] = ib, pool
    hosts = {k: np.array(v) for k, v in tree["hosts"].items()}
    hosts["send_ctr"] = rng.integers(0, 1 << 40, h)
    hosts["tx_queued"] = rng.choice(np.array([0, 0, 2], np.int32), h)
    tree["hosts"] = hosts

    lanes = teng._n_lanes(ttgen.Tgen())
    pc = pool["blk"].shape[1]
    valid = rng.random((h, lanes)) < 0.7
    blk = rng.integers(0, 1 << 30, (h, lanes, pc)).astype(np.int32)
    src = np.arange(h)[:, None]
    dst = np.where(rng.random((h, lanes)) < 0.5, src,
                   rng.integers(0, h, (h, lanes)))
    blk[:, :, pc - 4] = dst                      # OEXT_DST
    blk[:, :, 3] = 6                             # TCP
    blk[:, :, 8] = rng.choice([0, 1460, 700], (h, lanes))
    t_send = np.where(rng.random((h, lanes)) < 0.5, 0,
                      5 * SEC + rng.integers(0, MS, (h, lanes)))
    blk[:, :, 10] = t_send & ((1 << 31) - 1)     # ICOL_TIME_LO / _HI
    blk[:, :, 11] = t_send >> 31
    tick = 5 * SEC + rng.integers(0, MS, h)
    active = rng.random(h) < 0.9

    def rebuild(obj, d):
        return obj.replace(**{k: jax.numpy.asarray(v) for k, v in d.items()})
    jstate = js.replace(inbox=rebuild(js.inbox, ib),
                        pool=rebuild(js.pool, pool),
                        hosts=rebuild(js.hosts, hosts))
    jem = jemit.empty(h, lanes, pc).replace(valid=jax.numpy.asarray(valid),
                                            blk=jax.numpy.asarray(blk))
    jout, jplaced = fn(jstate, jem, jax.numpy.asarray(tick),
                       jax.numpy.asarray(active))

    ts = convert.state_from_jax(tree, device="cpu", app_cls=ttgen.TgenState)
    tp = convert.params_from_jax(jax_tree(jp), jax_statics(jp),
                                 device="cpu")
    tem = temit.empty(h, lanes, pc, "cpu").replace(
        valid=torch.from_numpy(valid), blk=torch.from_numpy(blk))
    tout, tplaced = teng._stage_emissions(
        ts, tp, tem, torch.from_numpy(tick), torch.from_numpy(active),
        ttgen.Tgen(), tp.bw_up_Bps)
    label = f"staging seed={seed} pds={pds_trail} lossy={lossy}"
    assert_same({"state": convert.to_numpy(tout),
                 "placed": tplaced.numpy()},
                {"state": jax_tree(jout), "placed": np.asarray(jplaced)},
                label)
    loop = valid & (dst == src)
    assert (np.asarray(jplaced) & loop).any(), "no loopback row placed"
    assert int(jout.hosts.pkts_dropped_pool.sum()) > 0, "no slab filled"
