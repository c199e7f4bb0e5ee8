"""Observability: per-host heartbeats and the run summary's object census
(counterpart of shadow1_tpu/observe.py's Tracker and census).

A heartbeat is one device-to-host copy of the packed counter block per
interval, diffed host-side and appended to `heartbeat.csv` in the data
directory; the rows are formatted exactly as the JAX package writes them,
so the two files compare byte for byte.  Packet capture, the event log's
drain and the progress line are not ported (ROADMAP queue 1 items 6, 8).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .core import simtime
from .core.state import (SOCK_FREE, SOCK_TCP, SOCK_UDP, STAGE_FREE,
                         STAGE_IN_FLIGHT, STAGE_RX_QUEUED, STAGE_TX_QUEUED)

SEC = simtime.SIMTIME_ONE_SECOND

_FIELDS = ("bytes_sent", "bytes_recv", "pkts_sent", "pkts_recv",
           "pkts_dropped_inet", "pkts_dropped_router")


def _pack_heartbeat(hosts) -> np.ndarray:
    """[len(_FIELDS) + 2, H] int64: the counters, then tx_queued and
    rx_queued, fetched in one copy."""
    rows = [getattr(hosts, f).to(torch.int64) for f in _FIELDS]
    rows.append(hosts.tx_queued.to(torch.int64))
    rows.append(hosts.rx_queued.to(torch.int64))
    return torch.stack(rows).cpu().numpy()


class Tracker:
    """Appends per-host heartbeat rows to DATA_DIR/heartbeat.csv; one
    instance per run."""

    HEADER = ("time_s,host,bytes_sent_per_s,bytes_recv_per_s,"
              "pkts_sent,pkts_recv,drops_inet,drops_router,"
              "tx_queued,rx_queued\n")

    def __init__(self, data_dir: str, hostnames, interval_s: int = 1,
                 per_host_interval_s=None):
        self.dir = data_dir
        self.hostnames = list(hostnames)
        self.interval_ns = interval_s * SEC
        h = len(self.hostnames)
        # Per-host heartbeat frequency (<host heartbeatfrequency>); 0 =
        # the global interval.
        per = np.zeros(h, np.int64) if per_host_interval_s is None \
            else np.asarray(per_host_interval_s, np.int64)
        self.per_host_ns = np.where(per > 0, per * SEC, self.interval_ns)
        # The run loop samples at the finest interval any host asked for.
        self.sample_interval_ns = int(min(self.interval_ns,
                                          self.per_host_ns.min())) \
            if h else self.interval_ns
        self._next_row = np.zeros(h, np.int64)
        self._last_row_t = np.zeros(h, np.int64)
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "heartbeat.csv")
        with open(self.path, "w") as f:
            f.write(self.HEADER)
        self._last = {f: np.zeros(h, np.int64) for f in _FIELDS}

    def heartbeat(self, state, now_ns: int):
        packed = _pack_heartbeat(state.hosts)
        n = len(_FIELDS)
        cur = {f: packed[i] for i, f in enumerate(_FIELDS)}
        txq, rxq = packed[n], packed[n + 1]
        with open(self.path, "a") as f:
            for i, name in enumerate(self.hostnames):
                if now_ns < self._next_row[i]:
                    continue
                self._next_row[i] = now_ns + self.per_host_ns[i]
                # Rates divide by the host's own elapsed time.
                dt_s = max((now_ns - self._last_row_t[i]) / SEC, 1e-9)
                self._last_row_t[i] = now_ns
                d = {k: int(cur[k][i] - self._last[k][i]) for k in _FIELDS}
                f.write(f"{now_ns / SEC:.3f},{name},"
                        f"{d['bytes_sent'] / dt_s:.1f},"
                        f"{d['bytes_recv'] / dt_s:.1f},"
                        f"{d['pkts_sent']},{d['pkts_recv']},"
                        f"{d['pkts_dropped_inet']},{d['pkts_dropped_router']},"
                        f"{int(txq[i])},{int(rxq[i])}\n")
                # The baseline advances only for written rows.
                for k in _FIELDS:
                    self._last[k][i] = cur[k][i]

    def summary(self, summary: dict, state):
        """Write DATA_DIR/summary.json: `summary` plus the census."""
        summary = dict(summary)
        summary["object_census"] = census(state)
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)


def census(state) -> dict:
    """Live-object census from the dense tables (Shadow's ObjectCounter):
    packets in the outbox and the inbox by stage, sockets by type."""
    stage = state.pool.stage.cpu().numpy()
    istage = state.inbox.stage.cpu().numpy()
    stype = state.socks.stype.cpu().numpy()
    return {
        "packets_free": int((stage == STAGE_FREE).sum())
        + int((istage == STAGE_FREE).sum()),
        "packets_tx_queued": int((stage == STAGE_TX_QUEUED).sum()),
        "packets_in_flight": int((stage == STAGE_IN_FLIGHT).sum())
        + int((istage == STAGE_IN_FLIGHT).sum()),
        "packets_rx_queued": int((istage == STAGE_RX_QUEUED).sum()),
        "sockets_free": int((stype == SOCK_FREE).sum()),
        "sockets_udp": int((stype == SOCK_UDP).sum()),
        "sockets_tcp": int((stype == SOCK_TCP).sum()),
    }
