"""Modeled tgen: a traffic-generator action-graph interpreter
(counterpart of shadow1_tpu/apps/tgen.py).

Shadow's tgen plugin walks a GraphML action graph: `start` (peers list)
-> `stream`/`transfer` (sendsize/recvsize) -> `end` (count/time bounds)
-> `pause` (time choices) -> back to `start`.  Servers run a graph with a
single `start` node carrying `serverport`.  Here the parsed action tables
live in the app state, every host holds a cursor into its graph, and one
tick advances every host's interpreter.  A stream is a paired TCP
exchange: the client connects, writes `sendsize` bytes and half-closes;
the server (which learns the stream spec from the peer's app registers,
the modeled stream header) replies with `recvsize` bytes and closes.
Completion = the client saw the full reply and the connection tore down
cleanly.

The model refuses at load what it does not interpret: fan-out graphs
(a node with several successors), conflicting peers lists within one
graph, and stream clients with no peers.  One stream is in flight per host
at a time (CLIENT_SLOT).

On the persistent path (params.persistent, the default) K_WINDOW runs the
tick on the card: its device copy is csrc/tgen_tick.cuh
(`device_tick = "tgen"`), which this module's `on_tick` and `next_time`
are the plain versions of.  On the per-phase path `on_tick` runs as plain
torch between K_DELIVER and K_TRANSPORT.  Tgen may send to its own host
(a client whose peer is its own listener), so it keeps the engine's
default `may_loopback = True`: loopback emissions go straight into the
sender's inbox slab (engine._loopback_insert).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .. import resolve_device
from ..core import rng, simtime
from ..core.state import (I32, I64, SOCK_TCP, TCPS_CLOSED, TCPS_CLOSEWAIT,
                          TCPS_ESTABLISHED, TCPS_TIMEWAIT, Tree, host_ids)
from ..transport import tcp

INV = simtime.SIMTIME_INVALID
SEC = simtime.SIMTIME_ONE_SECOND
M32 = 0xFFFFFFFF

# Action-node types.
NT_START = 0
NT_STREAM = 1
NT_END = 2
NT_PAUSE = 3

CLIENT_SLOT = 1      # client-side connection slot (0 = server listener)
EPH_BASE = 41000     # ephemeral local ports cycle so 4-tuples never collide
EPH_RANGE = 20000


# ---------------------------------------------------------------------------
# tgen GraphML parsing (host side, set-up time)
# ---------------------------------------------------------------------------

_NS = "{http://graphml.graphdrawing.org/xmlns}"

_SIZE_UNITS = {
    "b": 1, "byte": 1, "bytes": 1,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
    "kib": 1 << 10, "mib": 1 << 20, "gib": 1 << 30, "tib": 1 << 40,
}


def parse_size(text: str) -> int:
    """'1 MiB' / '100 kb' / '5242880' -> bytes (tgen size grammar)."""
    parts = str(text).strip().split()
    if len(parts) == 1:
        return int(float(parts[0]))
    if len(parts) == 2:
        unit = parts[1].lower()
        if unit not in _SIZE_UNITS:
            raise ValueError(f"unknown size unit {parts[1]!r}")
        return int(float(parts[0]) * _SIZE_UNITS[unit])
    raise ValueError(f"cannot parse size {text!r}")


def _parse_times_s(text: str):
    """'1,2,3' or '5' -> list of seconds (floats allowed)."""
    return [float(x) for x in str(text).split(",") if x != ""]


@dataclasses.dataclass
class TgenGraph:
    """One parsed tgen action graph (host side)."""

    node_ids: list          # node id strings
    ntype: np.ndarray       # [N] NT_*
    nxt: np.ndarray         # [N] successor node (local index), -1 = none
    sendsize: np.ndarray    # [N] i64 bytes (stream nodes)
    recvsize: np.ndarray    # [N] i64 bytes
    count: np.ndarray       # [N] i64 loop bound (end nodes), 0 = unbounded
    pause_s: list           # [N] list of pause-time choices (seconds)
    peers: list             # [N] list of "host:port" strings (start nodes)
    serverport: int         # > 0 if this graph is a server
    start_node: int         # entry node index

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)


_NODE_TYPES = {"start": NT_START, "stream": NT_STREAM, "transfer": NT_STREAM,
               "end": NT_END, "pause": NT_PAUSE}


def parse_tgen(source: str) -> TgenGraph:
    """Parse a tgen GraphML action graph (path or literal XML)."""
    text = source
    if not source.lstrip().startswith("<"):
        with open(source) as f:
            text = f.read()
    root = ET.fromstring(text)
    keys = {}
    for k in root.iter(_NS + "key"):
        keys[k.get("id")] = k.get("attr.name")
    graph = root.find(_NS + "graph")
    if graph is None:
        raise ValueError("tgen graphml has no <graph>")

    ids, attrs = [], []
    for node in graph.findall(_NS + "node"):
        ids.append(node.get("id"))
        d = {}
        for data in node.findall(_NS + "data"):
            d[keys.get(data.get("key"), data.get("key"))] = data.text or ""
        attrs.append(d)
    index = {n: i for i, n in enumerate(ids)}
    n = len(ids)

    # Node type from the id prefix (tgen convention: ids are the action
    # name, optionally suffixed, e.g. "stream", "pause2").
    ntype = np.zeros(n, np.int32)
    for i, nid in enumerate(ids):
        base = "".join(c for c in nid if not c.isdigit()).strip("-_")
        if base not in _NODE_TYPES:
            raise ValueError(f"unknown tgen action {nid!r}")
        ntype[i] = _NODE_TYPES[base]

    nxt = np.full(n, -1, np.int32)
    for edge in graph.findall(_NS + "edge"):
        s = index[edge.get("source")]
        t = index[edge.get("target")]
        if nxt[s] != -1:
            raise ValueError(
                f"tgen action node {ids[s]!r} has multiple successors; "
                f"the modeled interpreter supports single-chain graphs "
                f"only (real-tgen fan-out is not modeled)")
        nxt[s] = t

    sendsize = np.zeros(n, np.int64)
    recvsize = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    pause_s = [[] for _ in range(n)]
    peers = [[] for _ in range(n)]
    serverport = 0
    for i, d in enumerate(attrs):
        if "sendsize" in d:
            sendsize[i] = parse_size(d["sendsize"])
        if "recvsize" in d:
            recvsize[i] = parse_size(d["recvsize"])
        if "count" in d:
            count[i] = int(float(d["count"]))
        if "time" in d and ntype[i] == NT_PAUSE:
            pause_s[i] = _parse_times_s(d["time"])
        if "peers" in d:
            peers[i] = [p.strip() for p in d["peers"].split(",") if p.strip()]
        if "serverport" in d and ntype[i] == NT_START:
            serverport = int(d["serverport"])

    start = next(i for i in range(n) if ntype[i] == NT_START)
    return TgenGraph(node_ids=ids, ntype=ntype, nxt=nxt, sendsize=sendsize,
                     recvsize=recvsize, count=count, pause_s=pause_s,
                     peers=peers, serverport=serverport, start_node=start)


# ---------------------------------------------------------------------------
# Interpreter state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TgenState(Tree):
    """Concatenated action tables + per-host interpreter registers."""

    # --- static tables (concatenation of every distinct graph) ---
    ntype: torch.Tensor       # [N] i32
    nxt: torch.Tensor         # [N] i32 global successor, -1 = halt
    sendsize: torch.Tensor    # [N] i64
    recvsize: torch.Tensor    # [N] i64
    count: torch.Tensor       # [N] i64
    pause_t: torch.Tensor     # [N,PC] i64 ns choices (0-padded)
    pause_n: torch.Tensor     # [N] i32 number of choices
    peer_host: torch.Tensor   # [N,MP] i32 resolved host index (-1 pad)
    peer_port: torch.Tensor   # [N,MP] i32
    peer_n: torch.Tensor      # [N] i32

    # --- per-host registers ---
    cur: torch.Tensor         # [H] i32 global node index, -1 = no program
    start_t: torch.Tensor     # [H] i64 process starttime
    stop_t: torch.Tensor      # [H] i64 process stoptime, INV = none
    started: torch.Tensor     # [H] bool
    finished: torch.Tensor    # [H] bool (end-count reached or stopped)
    iters: torch.Tensor       # [H] i64 completed end-node visits
    wait_until: torch.Tensor  # [H] i64 pause deadline, INV = not pausing
    t_next: torch.Tensor      # [H] i64 instant-transition re-tick, INV = none
    stream_active: torch.Tensor  # [H] bool
    conn_ctr: torch.Tensor    # [H] i64 streams initiated (port/peer cycling)
    cur_send: torch.Tensor    # [H] i64 active stream spec (read by servers)
    cur_recv: torch.Tensor    # [H] i64
    streams_done: torch.Tensor    # [H] i64 observable: completed streams
    streams_failed: torch.Tensor  # [H] i64

    TABLES = ("ntype", "nxt", "sendsize", "recvsize", "count", "pause_t",
              "pause_n", "peer_host", "peer_port", "peer_n")


class Tgen:
    """Static app marker (same class attributes as the JAX Tgen; the
    tables live in TgenState)."""

    # Bursty TCP fan-in: deliver up to 4 queued arrivals per host per
    # micro-step (engine rx_batch rounds).
    rx_batch = 4
    # The tick K_WINDOW runs on the card (csrc/tgen_tick.cuh).
    device_tick = "tgen"

    def __init__(self, client_slot: int = CLIENT_SLOT):
        self.client_slot = int(client_slot)

    def __hash__(self):
        return hash(("tgen", self.client_slot))

    def __eq__(self, other):
        return isinstance(other, Tgen) and \
            other.client_slot == self.client_slot

    def next_time(self, state):
        a = state.app
        has = a.cur >= 0
        inv = torch.full_like(a.start_t, INV)
        t_start = torch.where(has & ~a.started, a.start_t, inv)
        t_pause = torch.where(has & a.started & ~a.finished, a.wait_until,
                              inv)
        return torch.minimum(torch.minimum(t_start, t_pause), a.t_next)

    def on_tick(self, state, params, em, tick_t, active):
        """The client pass (start/stop, the node at each cursor, the
        cursor advance), then the server pass over every socket of every
        host, which reads the peers' stream registers as the client pass
        left them, then the sink.  Off-mesh only."""
        a = state.app
        socks = state.socks
        h = a.cur.shape[0]
        dev = a.cur.device
        rows = host_ids(state)
        cs = self.client_slot
        slot = torch.full((h,), cs, dtype=I32, device=dev)
        inv = torch.full((h,), INV, dtype=I64, device=dev)

        # -- start / stop ----------------------------------------------------
        t_next = torch.where(active, inv, a.t_next)
        start_now = active & ~a.started & (a.cur >= 0) & \
            (a.start_t <= tick_t)
        started = a.started | start_now
        stopped = active & started & (a.stop_t != INV) & \
            (a.stop_t <= tick_t)
        finished = a.finished | stopped

        run = active & started & ~finished & (a.cur >= 0)
        cur = torch.clamp(a.cur, 0, a.ntype.shape[0] - 1).to(I64)
        ntype = a.ntype[cur]

        # -- START: instant hop into the first action ------------------------
        advance = run & (ntype == NT_START)

        # -- STREAM ----------------------------------------------------------
        at_stream = run & (ntype == NT_STREAM)
        # The start node's peers sit on every node of its graph
        # (build_state), so they are gathered from `cur` directly.
        init = at_stream & ~a.stream_active
        np_ = torch.clamp(a.peer_n[cur], min=1)
        pk = torch.remainder(a.conn_ctr, np_.to(I64)).to(I32)
        pkc = torch.clamp(pk, 0, a.peer_host.shape[1] - 1).to(I64)
        dsth = a.peer_host[cur, pkc]
        dstp = a.peer_port[cur, pkc]
        init = init & (dsth >= 0)
        lport = (EPH_BASE + torch.remainder(a.conn_ctr, EPH_RANGE)).to(I32)
        if bool(init.any()):
            socks = tcp.connect_v(socks, init, slot, dsth, dstp, lport,
                                  tick_t)
        stream_active = a.stream_active | init
        conn_ctr = a.conn_ctr + init.to(I64)
        cur_send = torch.where(init, a.sendsize[cur], a.cur_send)
        cur_recv = torch.where(init, a.recvsize[cur], a.cur_recv)

        # progress: the request bytes into the send buffer, half-close
        # once all of them are written.
        streaming = at_stream & stream_active
        target = (1 + cur_send) & M32
        ok = bad = torch.zeros_like(streaming)
        if bool(streaming.any()):
            socks = tcp.write_v(socks, streaming, slot, target, now=tick_t)
            written = socks.snd_end[:, cs] == target
            socks = tcp.close_v(socks, streaming & written, slot)
            # completion / failure.
            cstate = socks.tcp_state[:, cs]
            got = socks.bytes_recv[:, cs]
            torn = (cstate == TCPS_TIMEWAIT) | (cstate == TCPS_CLOSED)
            ok = streaming & torn & (got >= cur_recv)
            bad = streaming & ~ok & ((socks.error[:, cs] != 0) |
                                     (torn & (got < cur_recv)))
        fin_stream = ok | bad
        streams_done = a.streams_done + ok.to(I64)
        streams_failed = a.streams_failed + bad.to(I64)
        stream_active = stream_active & ~fin_stream
        advance = advance | fin_stream

        # -- END -------------------------------------------------------------
        at_end = run & (ntype == NT_END)
        iters = a.iters + at_end.to(I64)
        cnt = a.count[cur]
        done = at_end & (cnt > 0) & (iters >= cnt)
        finished = finished | done
        advance = advance | (at_end & ~done)

        # -- PAUSE -----------------------------------------------------------
        at_pause = run & (ntype == NT_PAUSE)
        need_draw = at_pause & (a.wait_until == INV)
        u = rng.keyed_uniform(params.purpose_words[rng.PURPOSE_HOST_APP],
                              rows, conn_ctr, iters)
        pn = torch.clamp(a.pause_n[cur], min=1)
        pick = torch.minimum((u * pn.to(torch.float32)).to(I32), pn - 1)
        pick = torch.clamp(pick, 0, a.pause_t.shape[1] - 1).to(I64)
        dur = a.pause_t[cur, pick]
        wait_until = torch.where(need_draw, tick_t + dur, a.wait_until)
        pause_done = at_pause & ~need_draw & (wait_until <= tick_t)
        wait_until = torch.where(pause_done, inv, wait_until)
        advance = advance | pause_done

        # -- cursor advance + instant re-tick --------------------------------
        nxt = a.nxt[cur]
        new_cur = torch.where(advance, nxt, a.cur)
        finished = finished | (advance & (nxt < 0))
        # Hosts that advanced onto an instantly-runnable node re-tick now.
        t_next = torch.where((advance & (nxt >= 0)) | start_now, tick_t,
                             t_next)
        a = a.replace(cur=new_cur, started=started, finished=finished,
                      iters=iters, wait_until=wait_until, t_next=t_next,
                      stream_active=stream_active, conn_ctr=conn_ctr,
                      cur_send=cur_send, cur_recv=cur_recv,
                      streams_done=streams_done,
                      streams_failed=streams_failed)

        # -- server pass (every host, every tick) ----------------------------
        # A child socket's stream spec comes from the connecting peer's
        # registers -- the modeled stream header.
        child = (socks.stype == SOCK_TCP) & (socks.parent >= 0) & \
            ((socks.tcp_state == TCPS_ESTABLISHED) |
             (socks.tcp_state == TCPS_CLOSEWAIT))
        peer = torch.clamp(socks.peer_host, 0, h - 1).to(I64)
        want_send = cur_send[peer]
        want_recv = cur_recv[peer]
        reply_ready = child & (socks.peer_host >= 0) & \
            (socks.bytes_recv >= want_send) & ~socks.app_closed
        rtarget = (1 + want_recv) & M32
        # incremental write bounded by the send buffer; both conditions
        # read the socket as the client pass left it.
        cap_end = (socks.snd_una + (socks.snd_buf_cap.to(I64) & M32)) & M32
        step_end = torch.where(
            tcp._sdiff(rtarget, socks.snd_una) <=
            tcp._sdiff(cap_end, socks.snd_una), rtarget, cap_end)
        grow = reply_ready & (tcp._sdiff(step_end, socks.snd_end) > 0)
        socks = socks.replace(
            snd_end=torch.where(grow, step_end, socks.snd_end),
            app_closed=socks.app_closed |
            (reply_ready & (socks.snd_end == rtarget)))

        # Sink: every host consumes what it receives (keeps windows open).
        socks = tcp.consume_all(socks)
        return state.replace(app=a, socks=socks), em


# ---------------------------------------------------------------------------
# Assembly: graphs + per-host programs -> TgenState
# ---------------------------------------------------------------------------


def build_state(num_hosts: int, graphs: list, host_graph, host_start_t,
                host_stop_t=None, resolve_peer=None,
                device=None) -> TgenState:
    """Concatenate parsed TgenGraphs into the state's tables.

    graphs: list of TgenGraph.
    host_graph: [H] int, graph index per host (-1 = no tgen program).
    host_start_t / host_stop_t: [H] ns.
    resolve_peer: callable "host:port" -> (host_index, port); required if
      any graph has peers.
    device: where the tensors live (None = the CUDA card).
    """
    dev = resolve_device(device)
    max_p = max([1] + [len(g.pause_s[i]) for g in graphs
                       for i in range(g.num_nodes)])
    max_peer = max([1] + [len(g.peers[i]) for g in graphs
                          for i in range(g.num_nodes)])
    ntype, nxt, sendsize, recvsize, count = [], [], [], [], []
    pause_t = []
    pause_n = []
    peer_host, peer_port, peer_n = [], [], []
    offsets = []
    off = 0
    for g in graphs:
        offsets.append(off)
        n = g.num_nodes
        # peers propagate from the start node to every node of the graph so
        # stream nodes can gather them without a second indirection.
        g_ph = [-1] * max_peer
        g_pp = [0] * max_peer
        g_pn = 0
        seen_peers = None
        for i in range(n):
            if g.peers[i]:
                if seen_peers is not None and g.peers[i] != seen_peers:
                    raise ValueError(
                        f"tgen graph defines conflicting peers lists "
                        f"({seen_peers} vs {g.peers[i]}); the modeled "
                        f"interpreter shares one peers list per graph")
                seen_peers = g.peers[i]
                for j, spec in enumerate(g.peers[i][:max_peer]):
                    hidx, port = resolve_peer(spec)
                    g_ph[j], g_pp[j] = hidx, port
                g_pn = len(g.peers[i][:max_peer])
        # A client graph with stream actions but no resolvable peers would
        # hang at the stream node forever (init never fires); fail loudly
        # at assembly instead.
        has_stream = any(int(t) == NT_STREAM for t in g.ntype)
        if has_stream and g.serverport <= 0 and g_pn == 0:
            raise ValueError(
                "tgen client graph has stream actions but no peers list; "
                "add a 'peers' attribute (host:port, ...) to the start or "
                "stream node")
        for i in range(n):
            ntype.append(int(g.ntype[i]))
            nxt.append(off + int(g.nxt[i]) if g.nxt[i] >= 0 else -1)
            sendsize.append(int(g.sendsize[i]))
            recvsize.append(int(g.recvsize[i]))
            count.append(int(g.count[i]))
            ts = [int(round(s * SEC)) for s in g.pause_s[i]][:max_p]
            pause_t.append(ts + [0] * (max_p - len(ts)))
            pause_n.append(len(ts))
            peer_host.append(list(g_ph))
            peer_port.append(list(g_pp))
            peer_n.append(g_pn)
        off += n

    hg = np.asarray(host_graph, np.int64)
    cur0 = np.full(num_hosts, -1, np.int32)
    for hh in range(num_hosts):
        if hg[hh] >= 0:
            g = graphs[int(hg[hh])]
            # Server graphs never run an interpreter; their listener is
            # installed at assembly.
            if g.serverport <= 0:
                cur0[hh] = offsets[int(hg[hh])] + g.start_node

    if host_stop_t is None:
        host_stop_t = np.full(num_hosts, INV, np.int64)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    def zh(dtype):
        return torch.zeros((num_hosts,), dtype=dtype, device=dev)

    return TgenState(
        ntype=t(ntype, I32), nxt=t(nxt, I32), sendsize=t(sendsize, I64),
        recvsize=t(recvsize, I64), count=t(count, I64),
        pause_t=t(pause_t, I64), pause_n=t(pause_n, I32),
        peer_host=t(peer_host, I32), peer_port=t(peer_port, I32),
        peer_n=t(peer_n, I32),
        cur=t(cur0, I32),
        start_t=t(np.broadcast_to(np.asarray(host_start_t, np.int64),
                                  (num_hosts,)), I64),
        stop_t=t(np.broadcast_to(np.asarray(host_stop_t, np.int64),
                                 (num_hosts,)), I64),
        started=zh(torch.bool), finished=zh(torch.bool), iters=zh(I64),
        wait_until=torch.full((num_hosts,), INV, dtype=I64, device=dev),
        t_next=torch.full((num_hosts,), INV, dtype=I64, device=dev),
        stream_active=zh(torch.bool), conn_ctr=zh(I64), cur_send=zh(I64),
        cur_recv=zh(I64), streams_done=zh(I64), streams_failed=zh(I64))
