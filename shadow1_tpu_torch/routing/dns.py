"""DNS / Address: hostname and IP identity for virtual hosts (a copy of
shadow1_tpu/routing/dns.py; the port imports nothing of the JAX package).

The reference keeps a global registry assigning each host a unique IPv4
address, skipping every reserved range, with bidirectional name<->IP
resolution (Shadow's src/main/routing/dns.c:30-100,
address.c).  Host identity is needed at setup time (config hostnames,
peers lists, iphints) and at log/observability time; the device-side
engine itself addresses hosts by dense index, so this registry is
host-side Python that maps names and IPs onto those indices.
"""

from __future__ import annotations

import dataclasses
import ipaddress


# Reserved IPv4 ranges a generated address must avoid (reference
# _dns_isRestricted, dns.c:74-100).
_RESTRICTED = [ipaddress.ip_network(c) for c in (
    "0.0.0.0/8", "10.0.0.0/8", "100.64.0.0/10", "127.0.0.0/8",
    "169.254.0.0/16", "172.16.0.0/12", "192.0.0.0/29", "192.0.2.0/24",
    "192.88.99.0/24", "192.168.0.0/16", "198.18.0.0/15", "198.51.100.0/24",
    "203.0.113.0/24", "224.0.0.0/4", "240.0.0.0/4", "255.255.255.255/32",
)]


def is_restricted(ip_int: int) -> bool:
    a = ipaddress.ip_address(ip_int)
    return any(a in net for net in _RESTRICTED)


@dataclasses.dataclass
class Address:
    """Refcount-free analog of the reference Address (address.c): the
    (id, ip, hostname) triple."""

    host_index: int
    ip: int          # host-order integer
    name: str

    @property
    def ip_str(self) -> str:
        return str(ipaddress.ip_address(self.ip))


class DNS:
    """Global name/IP registry (reference dns.c)."""

    def __init__(self):
        self._by_name: dict[str, Address] = {}
        self._by_ip: dict[int, Address] = {}
        self._by_index: dict[int, Address] = {}
        self._ip_counter = int(ipaddress.ip_address("1.0.0.0"))

    def _next_ip(self) -> int:
        while True:
            self._ip_counter += 1
            ip = self._ip_counter
            if not is_restricted(ip) and ip not in self._by_ip:
                return ip

    def register(self, host_index: int, name: str,
                 requested_ip: str | None = None) -> Address:
        """Assign `name` a unique IP (honoring a usable requested one, like
        the reference's iphint) and bind it to the dense host index."""
        if name in self._by_name:
            raise ValueError(f"hostname {name!r} already registered")
        ip = None
        if requested_ip and requested_ip != "0.0.0.0":
            cand = int(ipaddress.ip_address(requested_ip))
            if not is_restricted(cand) and cand not in self._by_ip:
                ip = cand
        if ip is None:
            ip = self._next_ip()
        addr = Address(host_index=host_index, ip=ip, name=name)
        self._by_name[name] = addr
        self._by_ip[ip] = addr
        self._by_index[host_index] = addr
        return addr

    def resolve_name(self, name: str) -> Address:
        """name -> Address (reference dns_resolveNameToAddress); dotted
        quads resolve through the IP table."""
        if name in self._by_name:
            return self._by_name[name]
        try:
            ip = int(ipaddress.ip_address(name))
        except ValueError:
            raise KeyError(f"unknown hostname {name!r}") from None
        return self.resolve_ip(ip)

    def resolve_ip(self, ip: int) -> Address:
        if ip not in self._by_ip:
            raise KeyError(f"unknown address {ipaddress.ip_address(ip)}")
        return self._by_ip[ip]

    def address_of(self, host_index: int) -> Address:
        return self._by_index[host_index]

    def __len__(self):
        return len(self._by_name)
