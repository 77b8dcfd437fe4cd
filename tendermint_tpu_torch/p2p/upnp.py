"""UPnP IGD port mapping for the p2p listen path.

Reference: p2p/upnp/upnp.go — SSDP-discover the Internet Gateway Device,
fetch its description XML, locate the WANIPConnection (or WANPPP)
control URL, then drive it with SOAP: AddPortMapping on listen,
DeletePortMapping on shutdown, GetExternalIPAddress for the advertised
address. stdlib only (socket + http.client + ElementTree); all blocking
network work is run in an executor by the async wrappers.

Best-effort by design: any failure leaves the node listening without a
NAT mapping (exactly the reference's getUPNPExternalAddress fallback,
node.go).
"""

from __future__ import annotations

import asyncio
import socket
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from http.client import HTTPConnection
from typing import Optional
from urllib.parse import urlparse

SSDP_ADDR = ("239.255.255.250", 1900)
_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
_WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


class UPnPError(Exception):
    pass


@dataclass
class Gateway:
    control_url: str  # absolute http URL of the WAN*Connection control
    service_type: str
    local_ip: str  # our address on the gateway's subnet

    # --- SOAP actions (reference upnp.go soapRequest) --------------------

    def _soap(self, action: str, body_xml: str) -> str:
        u = urlparse(self.control_url)
        envelope = (
            '<?xml version="1.0"?>\r\n'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            ' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            f"<s:Body>{body_xml}</s:Body></s:Envelope>"
        )
        conn = HTTPConnection(u.hostname, u.port or 80, timeout=5)
        try:
            conn.request(
                "POST",
                u.path or "/",
                envelope,
                {
                    "Content-Type": 'text/xml; charset="utf-8"',
                    "SOAPAction": f'"{self.service_type}#{action}"',
                },
            )
            resp = conn.getresponse()
            data = resp.read().decode(errors="replace")
            if resp.status != 200:
                raise UPnPError(f"{action}: HTTP {resp.status}: {data[:200]}")
            return data
        finally:
            conn.close()

    def add_port_mapping(
        self,
        ext_port: int,
        int_port: int,
        proto: str = "TCP",
        description: str = "tendermint-tpu p2p",
        lease_seconds: int = 0,
    ) -> None:
        self._soap(
            "AddPortMapping",
            f'<u:AddPortMapping xmlns:u="{self.service_type}">'
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{ext_port}</NewExternalPort>"
            f"<NewProtocol>{proto}</NewProtocol>"
            f"<NewInternalPort>{int_port}</NewInternalPort>"
            f"<NewInternalClient>{self.local_ip}</NewInternalClient>"
            "<NewEnabled>1</NewEnabled>"
            f"<NewPortMappingDescription>{description}"
            "</NewPortMappingDescription>"
            f"<NewLeaseDuration>{lease_seconds}</NewLeaseDuration>"
            "</u:AddPortMapping>",
        )

    def delete_port_mapping(self, ext_port: int, proto: str = "TCP") -> None:
        self._soap(
            "DeletePortMapping",
            f'<u:DeletePortMapping xmlns:u="{self.service_type}">'
            "<NewRemoteHost></NewRemoteHost>"
            f"<NewExternalPort>{ext_port}</NewExternalPort>"
            f"<NewProtocol>{proto}</NewProtocol>"
            "</u:DeletePortMapping>",
        )

    def get_external_ip(self) -> str:
        data = self._soap(
            "GetExternalIPAddress",
            f'<u:GetExternalIPAddress xmlns:u="{self.service_type}"/>',
        )
        start = data.find("<NewExternalIPAddress>")
        end = data.find("</NewExternalIPAddress>")
        if start < 0 or end < 0:
            raise UPnPError("no NewExternalIPAddress in response")
        return data[start + len("<NewExternalIPAddress>") : end].strip()


def _fetch_description(location: str) -> tuple[str, str]:
    """(service_type, control_url) from the IGD description XML."""
    u = urlparse(location)
    conn = HTTPConnection(u.hostname, u.port or 80, timeout=5)
    try:
        conn.request("GET", u.path or "/")
        resp = conn.getresponse()
        if resp.status != 200:
            raise UPnPError(f"description fetch: HTTP {resp.status}")
        root = ET.fromstring(resp.read())
    finally:
        conn.close()
    # namespace-agnostic scan for a WAN*Connection service
    for svc in root.iter():
        if not svc.tag.endswith("service"):
            continue
        st = ""
        ctrl = ""
        for child in svc:
            if child.tag.endswith("serviceType"):
                st = (child.text or "").strip()
            elif child.tag.endswith("controlURL"):
                ctrl = (child.text or "").strip()
        if st in _WAN_SERVICES and ctrl:
            if not ctrl.startswith("http"):
                ctrl = f"http://{u.hostname}:{u.port or 80}" + (
                    ctrl if ctrl.startswith("/") else "/" + ctrl
                )
            return st, ctrl
    raise UPnPError("no WANIPConnection/WANPPPConnection service found")


def discover(timeout: float = 3.0,
             ssdp_addr: tuple = SSDP_ADDR) -> Gateway:
    """SSDP M-SEARCH for an IGD, then resolve its control URL
    (reference upnp.go Discover)."""
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\nMX: 2\r\n'
        f"ST: {_ST}\r\n\r\n"
    ).encode()
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(msg, ssdp_addr)
        data, addr = s.recvfrom(4096)
        local_ip = s.getsockname()[0]
        if local_ip in ("0.0.0.0", ""):
            # connect a throwaway socket toward the gateway to learn our
            # address on its subnet
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.connect((addr[0], 1900))
                local_ip = probe.getsockname()[0]
            finally:
                probe.close()
    except (socket.timeout, OSError) as e:
        raise UPnPError(f"no UPnP gateway: {e}") from None
    finally:
        s.close()
    location = ""
    for line in data.decode(errors="replace").split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "location":
            location = v.strip()
            break
    if not location:
        raise UPnPError("SSDP response carried no LOCATION header")
    st, ctrl = _fetch_description(location)
    return Gateway(control_url=ctrl, service_type=st, local_ip=local_ip)


async def map_listen_port(
    port: int, logger=None, timeout: float = 3.0,
    ssdp_addr: tuple = SSDP_ADDR,
) -> Optional[Gateway]:
    """Best-effort NAT mapping of the p2p listen port at node start
    (reference node.go getUPNPExternalAddress): discover, AddPortMapping
    ext==int, log the external address. Returns the Gateway (for the
    shutdown unmap) or None."""
    loop = asyncio.get_running_loop()
    try:
        gw = await loop.run_in_executor(
            None, lambda: discover(timeout, ssdp_addr)
        )
        await loop.run_in_executor(
            None, lambda: gw.add_port_mapping(port, port)
        )
        ext_ip = await loop.run_in_executor(None, gw.get_external_ip)
        if logger is not None:
            logger.info(
                "upnp mapped p2p port", port=port, external_ip=ext_ip
            )
        return gw
    except (UPnPError, OSError, ET.ParseError) as e:
        if logger is not None:
            logger.info("upnp mapping unavailable", err=str(e))
        return None


async def unmap_listen_port(gw: Gateway, port: int, logger=None) -> None:
    loop = asyncio.get_running_loop()
    try:
        await loop.run_in_executor(
            None, lambda: gw.delete_port_mapping(port)
        )
    except (UPnPError, OSError) as e:
        if logger is not None:
            logger.info("upnp unmap failed", err=str(e))
