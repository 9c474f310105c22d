"""Webhook TLS: CA + server certificate generation and bootstrap (the
port's copy of the JAX package's ``webhooks/certs.py``; its ``main()``,
which attaches to a cluster through ``machinery/client.py``, comes with
that module).

A real kube-apiserver only calls webhooks over HTTPS, verifying the
serving cert against the ``caBundle`` registered in the
MutatingWebhookConfiguration (reference admission-webhook/main.go:625-640
serves on :443 with --tls-cert-file/--tls-private-key-file; the
kubeflow distribution provisions the pair with a cert bootstrap job).

This module is both halves of that story:

- :func:`generate_webhook_certs` — a self-signed CA plus a leaf cert
  with the webhook Service's DNS SANs, using the ``cryptography``
  package (no openssl subprocess).
- :func:`bootstrap` — the in-cluster job: ensure the cert Secret
  exists (generating on first run), then patch every webhook's
  ``clientConfig.caBundle`` so the apiserver trusts the serving cert —
  the same dance as kubeflow's webhook-cert-bootstrap job.
"""

from __future__ import annotations

import base64
import dataclasses
import datetime
import ipaddress
import os
from typing import Any, Optional

Obj = dict[str, Any]

SECRET_NAME = "admission-webhook-certs"
WEBHOOK_CONFIG_NAME = "odh-kubeflow-tpu-webhooks"


@dataclasses.dataclass
class CertBundle:
    ca_cert_pem: bytes
    ca_key_pem: bytes
    cert_pem: bytes
    key_pem: bytes

    @property
    def ca_bundle_b64(self) -> str:
        return base64.b64encode(self.ca_cert_pem).decode()

    def write(self, cert_dir: str) -> tuple[str, str, str]:
        """Write tls.crt / tls.key / ca.crt (the kubernetes.io/tls
        Secret mount layout) and return their paths."""
        os.makedirs(cert_dir, exist_ok=True)
        paths = (
            os.path.join(cert_dir, "tls.crt"),
            os.path.join(cert_dir, "tls.key"),
            os.path.join(cert_dir, "ca.crt"),
        )
        for path, data in zip(paths, (self.cert_pem, self.key_pem, self.ca_cert_pem)):
            with open(path, "wb") as f:
                f.write(data)
        os.chmod(paths[1], 0o600)
        return paths


def generate_webhook_certs(
    dns_names: Optional[list[str]] = None,
    valid_days: int = 825,
    ip_sans: Optional[list[str]] = None,
) -> CertBundle:
    """``ip_sans``: IP-address SANs (kube-apiserver serving certs carry
    the service cluster IP this way; clients that dial
    ``https://<ip>`` verify against them)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    dns_names = dns_names or [
        "admission-webhook",
        "admission-webhook.kubeflow",
        "admission-webhook.kubeflow.svc",
        "admission-webhook.kubeflow.svc.cluster.local",
        "localhost",
    ]
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=valid_days)

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "odh-kubeflow-tpu-webhook-ca")]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True,
                key_cert_sign=True,
                crl_sign=True,
                content_commitment=False,
                key_encipherment=False,
                data_encipherment=False,
                key_agreement=False,
                encipher_only=False,
                decipher_only=False,
            ),
            critical=True,
        )
        .sign(ca_key, hashes.SHA256())
    )

    key = ec.generate_private_key(ec.SECP256R1())
    cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, dns_names[0])])
        )
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName(n) for n in dns_names]
                + [
                    x509.IPAddress(ipaddress.ip_address(ip))
                    for ip in (ip_sans or [])
                ]
            ),
            critical=False,
        )
        .add_extension(
            x509.ExtendedKeyUsage([x509.ExtendedKeyUsageOID.SERVER_AUTH]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )

    pem = serialization.Encoding.PEM

    def key_pem(k) -> bytes:
        return k.private_bytes(
            pem,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )

    return CertBundle(
        ca_cert_pem=ca_cert.public_bytes(pem),
        ca_key_pem=key_pem(ca_key),
        cert_pem=cert.public_bytes(pem),
        key_pem=key_pem(key),
    )


# ---------------------------------------------------------------------------
# bootstrap job


def ensure_cert_secret(api, namespace: str = "kubeflow") -> CertBundle:
    """Get-or-create the kubernetes.io/tls Secret holding the pair.
    Idempotent: a second bootstrap run reuses the stored certs so the
    serving pod and the registered caBundle never diverge."""
    from odh_kubeflow_tpu_torch.machinery.store import NotFound

    try:
        secret = api.get("Secret", SECRET_NAME, namespace)
        data = secret.get("data") or {}
        if not all(k in data for k in ("ca.crt", "tls.crt", "tls.key")):
            raise RuntimeError(
                f"Secret {namespace}/{SECRET_NAME} exists but lacks "
                f"ca.crt/tls.crt/tls.key (has {sorted(data)}); delete it "
                "or provision a complete kubernetes.io/tls pair"
            )
        return CertBundle(
            ca_cert_pem=base64.b64decode(data["ca.crt"]),
            ca_key_pem=base64.b64decode(data.get("ca.key", b"")),
            cert_pem=base64.b64decode(data["tls.crt"]),
            key_pem=base64.b64decode(data["tls.key"]),
        )
    except NotFound:
        pass
    bundle = generate_webhook_certs()
    api.create(
        {
            "apiVersion": "v1",
            "kind": "Secret",
            "type": "kubernetes.io/tls",
            "metadata": {"name": SECRET_NAME, "namespace": namespace},
            "data": {
                "tls.crt": base64.b64encode(bundle.cert_pem).decode(),
                "tls.key": base64.b64encode(bundle.key_pem).decode(),
                "ca.crt": base64.b64encode(bundle.ca_cert_pem).decode(),
                "ca.key": base64.b64encode(bundle.ca_key_pem).decode(),
            },
        }
    )
    return bundle


def patch_ca_bundle(api, bundle: CertBundle) -> None:
    """Stamp clientConfig.caBundle into every webhook of the
    MutatingWebhookConfiguration (the reference distribution's
    cert-bootstrap equivalent)."""
    from odh_kubeflow_tpu_torch.machinery.store import NotFound

    try:
        cfg = api.get("MutatingWebhookConfiguration", WEBHOOK_CONFIG_NAME, None)
    except NotFound:
        return
    for hook in cfg.get("webhooks") or []:
        hook.setdefault("clientConfig", {})["caBundle"] = bundle.ca_bundle_b64
    api.update(cfg)


def bootstrap(api, namespace: str = "kubeflow") -> CertBundle:
    bundle = ensure_cert_secret(api, namespace)
    patch_ca_bundle(api, bundle)
    return bundle
