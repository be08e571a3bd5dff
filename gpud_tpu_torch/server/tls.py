"""Self-signed TLS for the local API; the port of ``gpud_tpu/server/tls.py``.

Reference: pkg/server/server.go:507-547 — a self-signed ECDSA cert is
generated at boot so the local API is always HTTPS (clients connect with
verification disabled; the value is wire privacy on shared hosts, not
identity).

``generate_self_signed`` and ``server_ssl_context`` are the reference's.
The daemon calls ``generate_in_child``: the certificate is made by this
file run as a script in a short-lived interpreter, so the daemon never
maps ``cryptography``'s 13 MB extension (a container that counts a mapped
file whole counts all of it against the daemon's memory).
"""

from __future__ import annotations

import datetime
import os
import ssl
import subprocess
import sys
import tempfile
from typing import Tuple


def generate_self_signed(common_name: str = "tpud.local") -> Tuple[str, str]:
    """Returns (cert_pem_path, key_pem_path) in a private temp dir."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName("localhost"), x509.DNSName(common_name)]
            ),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    d = tempfile.mkdtemp(prefix="tpud-tls-")
    cert_path = os.path.join(d, "cert.pem")
    key_path = os.path.join(d, "key.pem")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    os.chmod(key_path, 0o600)
    return cert_path, key_path


def server_ssl_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def generate_in_child(timeout: float = 60.0) -> Tuple[str, str]:
    """``generate_self_signed`` run in a child interpreter; raises
    RuntimeError with the child's error when it fails (no
    ``cryptography``, say)."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__)],
        capture_output=True, text=True, timeout=timeout,
    )
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 2:
        err = (proc.stderr.strip().splitlines() or ["no output"])[-1]
        raise RuntimeError(f"self-signed certificate: {err}")
    return lines[0], lines[1]


if __name__ == "__main__":
    print("\n".join(generate_self_signed()))
