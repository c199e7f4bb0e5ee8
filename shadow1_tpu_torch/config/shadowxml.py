"""shadow.config.xml parsing (a copy of shadow1_tpu/config/shadowxml.py;
the port imports nothing of the JAX package).

Implements Shadow's simulation-spec schema
(src/main/core/support/configuration.c per configuration.h:24-101): `<shadow stoptime bootstraptime>`, `<topology
path|cdata>`, `<plugin id path>`, `<host id quantity iphint *hints
bandwidthdown/up ...>` containing `<process plugin starttime stoptime
arguments>`.  Existing reference configs parse unchanged; attributes tied
to real-process execution (preload, startsymbol) are accepted and carried
through for the future real-code substrate.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import xml.etree.ElementTree as ET

# Silent acceptance is worse than rejection (reference consumes every
# configuration.h attribute); anything outside these sets triggers a loud
# warning so config typos cannot pass unnoticed.
_SHADOW_ATTRS = {"stoptime", "bootstraptime", "environment", "preload"}
_HOST_ATTRS = {"id", "quantity", "iphint", "citycodehint", "countrycodehint",
               "geocodehint", "typehint", "bandwidthdown", "bandwidthup",
               "interfacebuffer", "socketrecvbuffer", "socketsendbuffer",
               "cpufrequency", "loglevel", "heartbeatfrequency", "logpcap",
               "pcapdir", "heartbeatloglevel", "heartbeatloginfo"}
_PROCESS_ATTRS = {"plugin", "starttime", "time", "stoptime", "arguments",
                  "preload"}
_PLUGIN_ATTRS = {"id", "path", "startsymbol"}
_NETEM_ATTRS = {"churnrate", "churndowntime", "churnstart", "churnend"}
_NETEM_EVENT_ATTRS = {"time", "kind", "a", "b", "value", "groups"}
_NETEM_GROUP_ATTRS = {"host", "id"}


def _warn_unknown(tag, el, known):
    for a in el.keys():
        if a not in known:
            print(f"[shadow1-tpu] WARNING: unknown <{tag}> attribute "
                  f"{a!r} ignored (known: {sorted(known)})", file=sys.stderr)


@dataclasses.dataclass
class ProcessSpec:
    plugin: str
    starttime_s: int
    arguments: str
    stoptime_s: int | None = None
    preload: str | None = None


@dataclasses.dataclass
class HostSpec:
    id: str
    processes: list
    quantity: int = 1
    iphint: str | None = None
    citycodehint: str | None = None
    countrycodehint: str | None = None
    geocodehint: str | None = None
    typehint: str | None = None
    bandwidthdown_KiBps: int | None = None
    bandwidthup_KiBps: int | None = None
    interfacebuffer: int | None = None
    socketrecvbuffer: int | None = None
    socketsendbuffer: int | None = None
    cpufrequency: int | None = None
    loglevel: str | None = None
    heartbeatfrequency_s: int | None = None
    logpcap: bool = False
    pcapdir: str | None = None

    def hints(self) -> dict:
        return {k: getattr(self, k) for k in
                ("iphint", "citycodehint", "countrycodehint", "geocodehint",
                 "typehint") if getattr(self, k)}


@dataclasses.dataclass
class PluginSpec:
    id: str
    path: str
    startsymbol: str | None = None


@dataclasses.dataclass
class NetemSpec:
    """<netem> fault/dynamics section (docs/netem.md).  `events` uses the
    same schema as the --netem JSON file ({"time", "kind", "a", "b",
    "value", "groups"}, time in seconds, hosts by name); `groups` maps
    host name -> partition group id.  Churn attributes switch on seeded
    chaos mode over every host."""

    events: list = dataclasses.field(default_factory=list)
    groups: dict = dataclasses.field(default_factory=dict)
    churn_rate: float | None = None       # flaps/host/second
    churn_downtime_s: float = 5.0         # mean down-time
    churn_start_s: float = 0.0
    churn_end_s: float | None = None      # default: stoptime


@dataclasses.dataclass
class ShadowConfig:
    stoptime_s: int
    bootstrap_end_s: int
    topology_path: str | None    # resolved against the config's directory
    topology_cdata: str | None
    plugins: dict               # id -> PluginSpec
    hosts: list                 # [HostSpec]
    environment: str | None = None
    preload_path: str | None = None
    base_dir: str = "."
    netem: NetemSpec | None = None

    def topology_source(self) -> str:
        """What routing/graphml.load accepts: inline XML or a path."""
        if self.topology_cdata:
            return self.topology_cdata
        if self.topology_path:
            return self.topology_path
        raise ValueError("config has no <topology>")


def _int(el, name, default=None):
    v = el.get(name)
    return default if v is None else int(v)


def parse(path_or_xml: str) -> ShadowConfig:
    """Parse a shadow.config.xml file path or literal XML string."""
    if path_or_xml.lstrip().startswith("<"):
        text, base = path_or_xml, "."
    else:
        with open(path_or_xml) as f:
            text = f.read()
        base = os.path.dirname(os.path.abspath(path_or_xml))
    root = ET.fromstring(text)
    if root.tag != "shadow":
        raise ValueError(f"expected <shadow> root, got <{root.tag}>")
    _warn_unknown("shadow", root, _SHADOW_ATTRS)
    stoptime = _int(root, "stoptime")
    if stoptime is None:
        raise ValueError("<shadow> requires stoptime")

    topo_path = topo_cdata = None
    plugins: dict = {}
    hosts: list = []
    netem_spec = None
    for el in root:
        if el.tag == "topology":
            p = el.get("path")
            if p:
                p = os.path.expanduser(p)
                topo_path = p if os.path.isabs(p) else os.path.join(base, p)
            if el.text and el.text.strip():
                topo_cdata = el.text.strip()
        elif el.tag == "plugin":
            _warn_unknown("plugin", el, _PLUGIN_ATTRS)
            pid = el.get("id")
            plugins[pid] = PluginSpec(id=pid, path=el.get("path") or "",
                                      startsymbol=el.get("startsymbol"))
        elif el.tag == "netem":
            _warn_unknown("netem", el, _NETEM_ATTRS)
            cr = el.get("churnrate")
            netem_spec = NetemSpec(
                churn_rate=float(cr) if cr is not None else None,
                churn_downtime_s=float(el.get("churndowntime") or 5.0),
                churn_start_s=float(el.get("churnstart") or 0.0),
                churn_end_s=(float(el.get("churnend"))
                             if el.get("churnend") else None),
            )
            for ne in el:
                if ne.tag == "event":
                    _warn_unknown("event", ne, _NETEM_EVENT_ATTRS)
                    ev = {"time": float(ne.get("time") or 0),
                          "kind": ne.get("kind")}
                    for k in ("a", "b"):
                        if ne.get(k) is not None:
                            ev[k] = ne.get(k)
                    if ne.get("value") is not None:
                        ev["value"] = float(ne.get("value"))
                    if ne.get("groups"):
                        ev["groups"] = [int(g) for g in
                                        ne.get("groups").split(",") if g]
                    netem_spec.events.append(ev)
                elif ne.tag == "group":
                    _warn_unknown("group", ne, _NETEM_GROUP_ATTRS)
                    netem_spec.groups[ne.get("host")] = \
                        int(ne.get("id") or 0)
        elif el.tag == "host" or el.tag == "node":  # "node" = legacy alias
            _warn_unknown(el.tag, el, _HOST_ATTRS)
            procs = []
            for pe in el:
                if pe.tag not in ("process", "application"):
                    continue
                _warn_unknown(pe.tag, pe, _PROCESS_ATTRS)
                st = pe.get("starttime") or pe.get("time")
                procs.append(ProcessSpec(
                    plugin=pe.get("plugin"),
                    starttime_s=int(st) if st is not None else 0,
                    arguments=pe.get("arguments") or "",
                    stoptime_s=_int(pe, "stoptime"),
                    preload=pe.get("preload"),
                ))
            hosts.append(HostSpec(
                id=el.get("id"),
                processes=procs,
                quantity=_int(el, "quantity", 1) or 1,
                iphint=el.get("iphint"),
                citycodehint=el.get("citycodehint"),
                countrycodehint=el.get("countrycodehint"),
                geocodehint=el.get("geocodehint"),
                typehint=el.get("typehint"),
                bandwidthdown_KiBps=_int(el, "bandwidthdown"),
                bandwidthup_KiBps=_int(el, "bandwidthup"),
                interfacebuffer=_int(el, "interfacebuffer"),
                socketrecvbuffer=_int(el, "socketrecvbuffer"),
                socketsendbuffer=_int(el, "socketsendbuffer"),
                cpufrequency=_int(el, "cpufrequency"),
                loglevel=el.get("loglevel"),
                heartbeatfrequency_s=_int(el, "heartbeatfrequency"),
                logpcap=(el.get("logpcap") or "").lower() == "true",
                pcapdir=el.get("pcapdir"),
            ))

    return ShadowConfig(
        stoptime_s=stoptime,
        bootstrap_end_s=_int(root, "bootstraptime", 0) or 0,
        topology_path=topo_path,
        topology_cdata=topo_cdata,
        plugins=plugins,
        hosts=hosts,
        environment=root.get("environment"),
        preload_path=root.get("preload"),
        base_dir=base,
        netem=netem_spec,
    )
