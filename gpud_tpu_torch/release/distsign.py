"""Release distribution signing.

Reference: pkg/release/distsign (603 LoC) — ed25519 root/signing key
generation, signing-key endorsement by root keys, and package
signing/verification, used by the `gpud release` subcommands
(cmd/gpud/command/command.go:446-570). Same chain here:

  root key  ──signs──▶  signing key  ──signs──▶  package tarball

so root keys stay offline while signing keys rotate. The port of
``gpud_tpu/release/distsign.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

CHUNK = 1 << 20


def _require_crypto():
    """The ``cryptography`` names the signing entry points need, imported
    on their first call: the daemon imports this module transitively
    (update watcher → installer), and a host without the package must
    still run — only the signing entry points hard-require it (the
    reference imports it at module load, inside a ``try``). Without it,
    the reference's error."""
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey,
            Ed25519PublicKey,
        )
    except ImportError:
        raise RuntimeError(
            "the 'cryptography' package is required for release signing"
        ) from None
    return serialization, Ed25519PrivateKey, Ed25519PublicKey


# -- key generation ----------------------------------------------------------

def generate_keypair() -> Tuple[bytes, bytes]:
    """Returns (private_pem, public_pem)."""
    serialization, Ed25519PrivateKey, _ = _require_crypto()
    priv = Ed25519PrivateKey.generate()
    priv_pem = priv.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    pub_pem = priv.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    )
    return priv_pem, pub_pem


def write_keypair(dir_path: str, name: str) -> Tuple[str, str]:
    os.makedirs(dir_path, exist_ok=True)
    priv_pem, pub_pem = generate_keypair()
    priv_path = os.path.join(dir_path, f"{name}.key")
    pub_path = os.path.join(dir_path, f"{name}.pub")
    with open(priv_path, "wb") as f:
        f.write(priv_pem)
    os.chmod(priv_path, 0o600)
    with open(pub_path, "wb") as f:
        f.write(pub_pem)
    return priv_path, pub_path


def _load_private(path: str):
    serialization, Ed25519PrivateKey, _ = _require_crypto()
    with open(path, "rb") as f:
        key = serialization.load_pem_private_key(f.read(), password=None)
    if not isinstance(key, Ed25519PrivateKey):
        raise ValueError("not an ed25519 private key")
    return key


def _load_public(path: str):
    serialization, _, Ed25519PublicKey = _require_crypto()
    with open(path, "rb") as f:
        key = serialization.load_pem_public_key(f.read())
    if not isinstance(key, Ed25519PublicKey):
        raise ValueError("not an ed25519 public key")
    return key


# -- signing -------------------------------------------------------------------

def _file_digest(path: str) -> bytes:
    import hashlib

    h = hashlib.sha512()
    with open(path, "rb") as f:
        while True:
            b = f.read(CHUNK)
            if not b:
                break
            h.update(b)
    return h.digest()


def sign_key(root_key_path: str, signing_pub_path: str, out_path: str = "") -> str:
    """Root key endorses a signing public key (reference: sign-key)."""
    root = _load_private(root_key_path)
    with open(signing_pub_path, "rb") as f:
        payload = f.read()
    sig = root.sign(payload)
    out = out_path or signing_pub_path + ".rootsig"
    with open(out, "wb") as f:
        f.write(sig)
    return out


def verify_key(root_pub_path: str, signing_pub_path: str, sig_path: str) -> bool:
    root_pub = _load_public(root_pub_path)
    with open(signing_pub_path, "rb") as f:
        payload = f.read()
    with open(sig_path, "rb") as f:
        sig = f.read()
    try:
        root_pub.verify(sig, payload)
        return True
    except Exception:  # noqa: BLE001
        return False


def sign_package(signing_key_path: str, package_path: str, out_path: str = "") -> str:
    """Sign a package tarball's sha512 (reference: sign-package)."""
    key = _load_private(signing_key_path)
    sig = key.sign(_file_digest(package_path))
    out = out_path or package_path + ".sig"
    with open(out, "wb") as f:
        f.write(sig)
    return out


def verify_package(
    signing_pub_path: str,
    package_path: str,
    sig_path: str = "",
    root_pub_path: str = "",
    key_sig_path: str = "",
) -> Optional[str]:
    """Verify a package; optionally also verify the signing key's root
    endorsement. Returns error string or None."""
    if root_pub_path:
        if not key_sig_path:
            return "key_sig_path required when verifying the key chain"
        if not verify_key(root_pub_path, signing_pub_path, key_sig_path):
            return "signing key is not endorsed by the root key"
    pub = _load_public(signing_pub_path)
    sig_file = sig_path or package_path + ".sig"
    try:
        with open(sig_file, "rb") as f:
            sig = f.read()
    except OSError as e:
        return f"cannot read signature: {e}"
    try:
        pub.verify(sig, _file_digest(package_path))
        return None
    except Exception:  # noqa: BLE001
        return "signature verification failed"
