"""The port's UPnP port mapping against the contract of
``tests/test_upnp.py`` (SSDP discovery, the description fetch, the
WANIPConnection control URL and the SOAP AddPortMapping /
GetExternalIPAddress / DeletePortMapping actions, against an in-process
fake gateway on loopback), each test on both packages' roots with one
body; and parity: the port sends the gateway the same HTTP requests as the
JAX package, byte for byte."""

from __future__ import annotations

import asyncio
import importlib

import pytest

from .test_upnp import _FakeIGD

ROOTS = pytest.mark.parametrize(
    "root", ["tendermint_tpu_torch", "tendermint_tpu"], ids=["port", "ref"])


def upnp(root: str):
    return importlib.import_module(f"{root}.p2p.upnp")


@ROOTS
def test_discover_map_unmap_roundtrip(root):
    igd = _FakeIGD()
    try:
        gw = upnp(root).discover(timeout=3.0, ssdp_addr=igd.ssdp_addr)
        assert gw.service_type.endswith("WANIPConnection:1")
        assert gw.control_url.endswith("/ctl/IPConn")
        gw.add_port_mapping(26656, 26656)
        assert igd.mappings[26656][0] == 26656
        assert gw.get_external_ip() == "203.0.113.7"
        gw.delete_port_mapping(26656)
        assert 26656 not in igd.mappings
        assert igd.deleted == [26656]
    finally:
        igd.close()


@ROOTS
def test_async_map_listen_port_best_effort(root):
    u = upnp(root)
    igd = _FakeIGD()

    async def run():
        gw = await u.map_listen_port(26700, timeout=3.0, ssdp_addr=igd.ssdp_addr)
        assert gw is not None
        assert 26700 in igd.mappings
        await u.unmap_listen_port(gw, 26700)
        assert 26700 not in igd.mappings
        # no gateway at a dead address: None, never an exception
        assert await u.map_listen_port(
            26701, timeout=0.3, ssdp_addr=("127.0.0.1", 1)) is None

    try:
        asyncio.run(run())
    finally:
        igd.close()


def test_gateway_requests_match_reference(monkeypatch):
    """One gateway, the same flow through each package: discover, map,
    read the external address, unmap. The recorded requests (method, path,
    body, headers) are equal."""
    igd = _FakeIGD()
    logs = {}
    try:
        for root in ("tendermint_tpu_torch", "tendermint_tpu"):
            u = upnp(root)
            log = logs[root] = []

            class Recording(u.HTTPConnection):
                def request(self, method, url, body=None, headers={}, **kw):
                    log.append((method, url, body, dict(headers)))
                    return super().request(method, url, body=body, headers=headers, **kw)

            monkeypatch.setattr(u, "HTTPConnection", Recording)
            gw = u.discover(timeout=3.0, ssdp_addr=igd.ssdp_addr)
            gw.add_port_mapping(26656, 26656)
            assert gw.get_external_ip() == "203.0.113.7"
            gw.delete_port_mapping(26656)
    finally:
        igd.close()
    port, ref = logs["tendermint_tpu_torch"], logs["tendermint_tpu"]
    assert len(port) == 4 and port == ref
