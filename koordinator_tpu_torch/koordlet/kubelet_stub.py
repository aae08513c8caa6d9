"""Kubelet stub: the statesinformer's pod-list sync surface.

Reference ``pkg/koordlet/statesinformer/impl/kubelet_stub.go``: the
koordlet reads the authoritative pod list straight from the kubelet's
(secure) endpoint — ``GET /pods`` with a bearer token over HTTPS (or the
read-only HTTP port) — rather than watching the apiserver, so the node
agent sees exactly what the kubelet is running.
"""

from __future__ import annotations

import json
import ssl
import urllib.request
from typing import Dict, List, Mapping, Optional


class KubeletStub:
    def __init__(
        self,
        address: str = "127.0.0.1",
        port: int = 10250,
        scheme: str = "https",
        token: Optional[str] = None,
        token_path: Optional[str] = None,
        insecure_skip_verify: bool = True,
        ca_path: Optional[str] = None,
        timeout_seconds: float = 10.0,
    ):
        self.base = f"{scheme}://{address}:{port}"
        self.timeout = timeout_seconds
        self._token = token
        self._token_path = token_path
        if scheme == "https":
            # create_default_context loads the system trust store, so the
            # verifying mode actually works; ca_path pins the cluster CA
            ctx = ssl.create_default_context(cafile=ca_path)
            if insecure_skip_verify:
                # kubelet serving certs are cluster-internal; the reference
                # defaults to InsecureSkipVerify for the same reason
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl = ctx
        else:
            self._ssl = None

    def _bearer(self) -> Optional[str]:
        if self._token:
            return self._token
        if self._token_path:
            try:
                with open(self._token_path) as fh:
                    return fh.read().strip()
            except OSError:
                return None
        return None

    def get_all_pods(self) -> List[Dict]:
        """GET /pods -> the pod list (kubelet PodList .items)."""
        doc = self._get("/pods")
        return list(doc.get("items", []))

    def get_node_config(self) -> Mapping:
        """GET /configz -> kubelet configuration (cpu manager policy etc.,
        consumed by the NUMA topology reporter)."""
        return self._get("/configz")

    def _get(self, path: str) -> Dict:
        req = urllib.request.Request(self.base + path)
        token = self._bearer()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        kwargs = {"timeout": self.timeout}
        if self._ssl is not None:
            kwargs["context"] = self._ssl
        with urllib.request.urlopen(req, **kwargs) as resp:
            return json.loads(resp.read())
