"""Webhook serving machinery: HTTPS admission server + cert management.

The port's own copy of ``koordinator_tpu/manager/webhook_server.py``.

The reference's webhook framework (``pkg/webhook/server.go:80
SetupWithManager``) brings three pieces the decision logic alone lacks:

* **cert generation** — a self-signed CA + server certificate written to
  the cert dir (``pkg/webhook/util/generator``): here via the
  ``cryptography`` package, SANs covering the service DNS names.
* **cert rotation** — certs are re-generated before expiry and the
  server re-wraps its socket so new connections use the fresh cert
  (``pkg/webhook/util/controller`` keeps the webhook configuration's
  caBundle in sync; ``ca_bundle()`` is that output).
* **the admission HTTP surface** — ``/mutate-pod``, ``/validate-pod``,
  ``/validate-quota``, ``/validate-node`` endpoints speaking the
  AdmissionReview JSON envelope, dispatching to the existing handlers
  (manager/profile.py mutating, manager/validating.py validating);
  mutating replies carry an RFC-6902 JSON patch like the real thing.
"""

from __future__ import annotations

import base64
import datetime
import json
import os
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from koordinator_tpu_torch.httpserving import HTTPLifecycle
from koordinator_tpu_torch.manager.profile import mutate_by_profiles
from koordinator_tpu_torch.manager.validating import (
    validate_node_colocation,
    validate_pod,
    validate_quota_tree,
)

DEFAULT_CERT_VALIDITY_DAYS = 365  # generator.NewSelfSignedCert default
DEFAULT_ROTATE_BEFORE = 30 * 24 * 3600.0  # rotate within 30d of expiry


# ---------------------------------------------------------------------------
# Cert generation / rotation (pkg/webhook/util/generator analog)
# ---------------------------------------------------------------------------


class CertManager:
    """Self-signed CA + server cert in ``cert_dir``; rotation regenerates
    both when the server cert nears expiry."""

    def __init__(
        self,
        cert_dir: str,
        dns_names: Tuple[str, ...] = ("koord-webhook-service",),
        validity_days: int = DEFAULT_CERT_VALIDITY_DAYS,
        rotate_before_seconds: float = DEFAULT_ROTATE_BEFORE,
        clock: Callable[[], float] = time.time,
    ):
        self.cert_dir = cert_dir
        self.dns_names = dns_names
        self.validity_days = validity_days
        self.rotate_before = rotate_before_seconds
        self.clock = clock
        self.rotations = 0
        # set when generation tooling is PROVEN absent (FileNotFoundError
        # from the openssl exec): a condition that cannot change at
        # runtime, so later ticks skip the attempt instead of re-warning
        self._tooling_absent = False
        os.makedirs(cert_dir, exist_ok=True)

    @property
    def ca_path(self) -> str:
        return os.path.join(self.cert_dir, "ca.crt")

    @property
    def cert_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.crt")

    @property
    def key_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.key")

    def ensure(self) -> bool:
        """Generate certs if absent or near expiry; returns True when new
        certs were written (the caller re-wraps its TLS socket).

        When generation fails but a cert EXISTS (no tooling on a minimal
        image, a read-only operator-mounted cert_dir, transient ENOSPC),
        the existing cert keeps being served with a warning naming the
        real error instead of crashing the rotate tick — safe because
        both generators write to temp names and commit with os.replace
        only after every artifact succeeded, so a failed attempt never
        tears the served cert/CA pair.  A MISSING cert still raises
        (nothing to serve).  Proven-absent tooling (FileNotFoundError
        from the openssl exec — cannot change at runtime) is cached so
        the warning fires once, not every tick."""
        missing = not os.path.exists(self.cert_path)
        if not missing and (self._tooling_absent or not self._near_expiry()):
            return False
        try:
            self._generate()
        except OSError as exc:
            if missing:
                raise
            if isinstance(exc, FileNotFoundError):
                self._tooling_absent = True
            import logging

            logging.getLogger(__name__).warning(
                "cannot rotate webhook certs (%s); continuing to serve "
                "the existing certificate",
                exc,
            )
            return False
        return True

    def ca_bundle(self) -> str:
        """base64 CA cert — what the webhook-configuration controller
        patches into ValidatingWebhookConfiguration.caBundle."""
        with open(self.ca_path, "rb") as fh:
            return base64.b64encode(fh.read()).decode()

    def _near_expiry(self) -> bool:
        expires = self._cert_expiry()
        if expires is None:
            return True
        return self.clock() >= expires - self.rotate_before

    def _cert_expiry(self) -> Optional[float]:
        """The server cert's notAfter as a unix timestamp, or None when
        unreadable (treated as expired)."""
        try:
            from cryptography import x509

            with open(self.cert_path, "rb") as fh:
                cert = x509.load_pem_x509_certificate(fh.read())
            return cert.not_valid_after_utc.timestamp()
        except ImportError:
            pass
        except (OSError, ValueError):
            return None
        # no ``cryptography`` in this environment: the openssl CLI reads
        # the same field ("notAfter=<C-locale date> GMT")
        import subprocess

        try:
            proc = subprocess.run(
                ["openssl", "x509", "-enddate", "-noout", "-in", self.cert_path],
                capture_output=True,
                text=True,
            )
        except OSError:
            # no openssl binary either: honor the documented "None when
            # unreadable" contract; ensure() then decides whether to
            # keep serving the existing cert or fail loudly
            return None
        if proc.returncode != 0:
            return None
        # openssl prints C-locale dates ("notAfter=Aug  3 05:00:00 2027
        # GMT"); parse by hand — strptime's %b is LC_TIME-dependent and
        # would misread every cert under a non-English locale, churning
        # rotations forever
        months = {
            m: i + 1
            for i, m in enumerate(
                "Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov Dec".split()
            )
        }
        try:
            mon, day, clock, year = proc.stdout.strip().split(
                "=", 1
            )[1].split()[:4]
            hh, mm, ss = (int(v) for v in clock.split(":"))
            dt = datetime.datetime(
                int(year), months[mon], int(day), hh, mm, ss,
                tzinfo=datetime.timezone.utc,
            )
            return dt.timestamp()
        except (IndexError, KeyError, ValueError):
            return None

    def _commit_triple(self, ca_tmp: str, cert_tmp: str, key_tmp: str) -> None:
        """Atomically-as-possible swap the generated temp files into
        place.  Three files cannot be renamed as one transaction, so a
        mid-commit failure rolls already-replaced files back from saved
        bytes (best-effort) — the served cert/key/CA triple must never
        be left mismatched (a new ca.crt that did not sign the served
        tls.crt breaks every webhook call until the next rotation)."""
        saved = {}
        for final in (self.ca_path, self.cert_path, self.key_path):
            if os.path.exists(final):
                with open(final, "rb") as fh:
                    saved[final] = fh.read()
        done = []
        try:
            for tmp, final in (
                (ca_tmp, self.ca_path),
                (cert_tmp, self.cert_path),
                (key_tmp, self.key_path),
            ):
                os.replace(tmp, final)
                done.append(final)
        except OSError:
            for final in done:
                if final in saved:
                    try:
                        with open(final, "wb") as fh:
                            fh.write(saved[final])
                    except OSError:
                        pass  # best-effort: the original raise wins
            raise

    def _generate(self) -> None:
        """Self-signed CA + SAN server cert, via the ``cryptography``
        package when importable, else the openssl CLI (same artifacts:
        ca.crt / tls.crt / tls.key; the CLI path exists because minimal
        images carry the openssl binary but not the Python bindings)."""
        try:
            import cryptography  # noqa: F401
        except ImportError:
            self._generate_openssl()
        else:
            self._generate_cryptography()
        self.rotations += 1

    def _generate_openssl(self) -> None:
        import subprocess

        def run(*argv):
            subprocess.run(argv, capture_output=True, check=True)

        ca_key = os.path.join(self.cert_dir, "ca.key")
        csr = os.path.join(self.cert_dir, "server.csr")
        cnf = os.path.join(self.cert_dir, "openssl.cnf")
        srl = os.path.join(self.cert_dir, "ca.srl")
        # generate into temp names; only a fully successful sequence is
        # committed (os.replace), so a mid-sequence failure can never
        # leave a mismatched cert/key/CA triple being served
        ca_tmp, cert_tmp, key_tmp = (
            p + ".tmp" for p in (self.ca_path, self.cert_path, self.key_path)
        )
        sans = ",".join(
            f"DNS:{n}" for n in tuple(self.dns_names) + ("localhost",)
        )
        # explicit config: relying on the system default config risks
        # duplicate x509v3 extensions (-addext on top of the distro's
        # v3_ca section), which poisons chain validation
        with open(cnf, "w") as fh:
            fh.write(
                "[req]\n"
                "distinguished_name = dn\n"
                "prompt = no\n"
                "[dn]\n"
                "CN = placeholder\n"
                "[v3_ca]\n"
                "basicConstraints = critical,CA:TRUE\n"
                "subjectKeyIdentifier = hash\n"
                "[v3_server]\n"
                f"subjectAltName = {sans}\n"
            )
        days = str(self.validity_days)
        try:
            run(
                "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", ca_key, "-out", ca_tmp, "-days", days,
                "-subj", "/CN=koordinator-webhook-ca",
                "-config", cnf, "-extensions", "v3_ca",
            )
            run(
                "openssl", "req", "-newkey", "rsa:2048", "-nodes",
                "-keyout", key_tmp, "-out", csr,
                "-subj", f"/CN={self.dns_names[0]}", "-config", cnf,
            )
            run(
                "openssl", "x509", "-req", "-in", csr, "-CA", ca_tmp,
                "-CAkey", ca_key, "-CAcreateserial", "-out", cert_tmp,
                "-days", days, "-extfile", cnf, "-extensions", "v3_server",
            )
            self._commit_triple(ca_tmp, cert_tmp, key_tmp)
        finally:
            # parity with the cryptography path, which keeps the CA key
            # in memory only: a CA key (or CSR/config/serial scratch)
            # left in cert_dir would let anything that reads the dir —
            # or a volume snapshot of it — mint certs chaining to the
            # installed caBundle.  Runs even when the openssl binary is
            # absent (FileNotFoundError from the first run).
            # -CAcreateserial names the serial after the -CA file
            # (ca.crt.tmp -> ca.crt.srl); sweep both spellings
            for scratch in (ca_key, csr, cnf, srl,
                            os.path.splitext(ca_tmp)[0] + ".srl",
                            ca_tmp, cert_tmp, key_tmp):
                try:
                    os.unlink(scratch)
                except OSError:
                    pass

    def _generate_cryptography(self) -> None:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID

        now = datetime.datetime.fromtimestamp(
            self.clock(), tz=datetime.timezone.utc
        )
        until = now + datetime.timedelta(days=self.validity_days)

        ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        ca_name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, "koordinator-webhook-ca")]
        )
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(until)
            .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
            .sign(ca_key, hashes.SHA256())
        )

        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        cert = (
            x509.CertificateBuilder()
            .subject_name(
                x509.Name(
                    [x509.NameAttribute(NameOID.COMMON_NAME, self.dns_names[0])]
                )
            )
            .issuer_name(ca_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(until)
            .add_extension(
                x509.SubjectAlternativeName(
                    [x509.DNSName(n) for n in self.dns_names]
                    + [x509.DNSName("localhost")]
                ),
                False,
            )
            .sign(ca_key, hashes.SHA256())
        )

        # temp-then-rename: a mid-write failure (ENOSPC, kill) must not
        # leave a new ca.crt beside an old tls.crt — ca_bundle() would
        # publish a CA that never signed the served cert
        payloads = (
            (self.ca_path, ca_cert.public_bytes(serialization.Encoding.PEM)),
            (self.cert_path, cert.public_bytes(serialization.Encoding.PEM)),
            (
                self.key_path,
                key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.TraditionalOpenSSL,
                    serialization.NoEncryption(),
                ),
            ),
        )
        try:
            for path, data in payloads:
                with open(path + ".tmp", "wb") as fh:
                    fh.write(data)
            self._commit_triple(
                self.ca_path + ".tmp",
                self.cert_path + ".tmp",
                self.key_path + ".tmp",
            )
        finally:
            for path, _ in payloads:
                try:
                    os.unlink(path + ".tmp")
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# Admission endpoints (AdmissionReview envelope)
# ---------------------------------------------------------------------------


def _json_patch(original: Mapping, mutated: Mapping) -> List[Dict]:
    """Top-level RFC-6902 add/replace/remove ops for changed keys (the
    reference computes the patch from the mutated object the same way)."""
    ops = []
    for key, value in mutated.items():
        if key not in original:
            ops.append({"op": "add", "path": f"/{key}", "value": value})
        elif original[key] != value:
            ops.append({"op": "replace", "path": f"/{key}", "value": value})
    for key in original:
        if key not in mutated:
            ops.append({"op": "remove", "path": f"/{key}"})
    return ops


def admission_response(uid: str, allowed: bool, errs=(), patch=None) -> Dict:
    resp: Dict = {"uid": uid, "allowed": allowed}
    if errs:
        resp["status"] = {"message": "; ".join(errs)}
    if patch:
        resp["patchType"] = "JSONPatch"
        resp["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview", "response": resp}


class WebhookServer:
    """HTTPS admission server with managed certs.

    ``profiles_fn`` supplies the live ClusterColocationProfiles for the
    mutating path (the reference watches them as CRs).
    """

    def __init__(
        self,
        cert_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        profiles_fn: Callable[[], List[Mapping]] = lambda: [],
        cert_manager: Optional[CertManager] = None,
    ):
        self.certs = cert_manager or CertManager(cert_dir)
        self.profiles_fn = profiles_fn
        self.certs.ensure()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    review = json.loads(self.rfile.read(length) or b"{}")
                    body = outer.handle(self.path, review)
                    code = 200
                except Exception as exc:  # malformed review -> 400
                    body = {"error": str(exc)}
                    code = 400
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._wrap_tls()
        self._http = HTTPLifecycle(self._httpd)

    def _wrap_tls(self):
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certs.cert_path, self.certs.key_path)
        self._ssl_context = ctx
        self._httpd.socket = ctx.wrap_socket(
            self._httpd.socket, server_side=True
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "WebhookServer":
        self._http.start()
        return self

    def stop(self):
        self._http.stop()

    def rotate_if_needed(self) -> bool:
        """Cert rotation tick: regenerate near-expiry certs and reload the
        TLS context so NEW connections use them."""
        if self.certs.ensure():
            self._ssl_context.load_cert_chain(
                self.certs.cert_path, self.certs.key_path
            )
            return True
        return False

    # -- dispatch --
    def handle(self, path: str, review: Mapping) -> Dict:
        req = review.get("request") or {}
        uid = req.get("uid", "")
        obj = req.get("object") or {}
        if path == "/mutate-pod":
            mutated = mutate_by_profiles(obj, self.profiles_fn())
            return admission_response(
                uid, True, patch=_json_patch(obj, mutated)
            )
        if path == "/validate-pod":
            errs = validate_pod(obj)
            return admission_response(uid, not errs, errs)
        if path == "/validate-quota":
            errs = validate_quota_tree(obj.get("quotas") or [obj])
            return admission_response(uid, not errs, errs)
        if path == "/validate-node":
            errs = validate_node_colocation(obj)
            return admission_response(uid, not errs, errs)
        raise ValueError(f"unknown webhook path {path!r}")
