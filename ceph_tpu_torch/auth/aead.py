"""AEAD primitive with native and stdlib fallbacks.

AES-256-GCM via the `cryptography` wheel when importable; else the
native codec's AES-256-GCM (AES-NI + PCLMUL, ~1.1 GB/s — the same
NIST cipher, so the two interoperate on the wire; NIST-vector-pinned
in tests/test_native.py); else an encrypt-then-MAC construction from
the stdlib (SHAKE-256 XOF keystream XOR — one C-speed sponge squeeze
for the whole message, the Keccak-stream-cipher construction — and an
HMAC-SHA256 tag over nonce+aad+ciphertext). The surface matches what
cephx tickets and msgr secure mode need: (key, nonce, aad) sealing
with a 16-byte tag, tamper -> InvalidTag.

Every endpoint of the sim lives in one process, so both sides always
resolve to the SAME implementation — there is no cross-implementation
wire case. The fallback keeps the auth/secure planes runnable on
images without the wheel; it is a legitimate AEAD composition but not
a constant-time production cipher (this codebase is a simulation).
"""

from __future__ import annotations

import hmac
from hashlib import sha256, shake_256

TAG_LEN = 16


class InvalidTag(Exception):
    """Decrypt failed authentication (tampered or wrong key)."""


def _xor(key: bytes, nonce: bytes, data: bytes) -> bytes:
    n = len(data)
    ks = shake_256(len(key).to_bytes(4, "little") + key
                   + b"ks" + nonce).digest(n)
    if n >= 1024:
        # bulk path: elementwise XOR via numpy (zero-copy views in,
        # one output buffer out) — the bignum int round-trip this
        # replaces cost ~40% of a 64 KiB seal. Bytes are identical.
        import numpy as np
        return (np.frombuffer(data, np.uint8)
                ^ np.frombuffer(ks, np.uint8)).tobytes()
    x = int.from_bytes(data, "little") ^ int.from_bytes(ks, "little")
    return x.to_bytes(n, "little")


def _tag(key: bytes, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
    h = hmac.new(key, b"tag", sha256)
    for p in (nonce, aad, ct):
        h.update(len(p).to_bytes(4, "little"))
        h.update(p)
    return h.digest()[:TAG_LEN]


def _native_gcm():
    """The native codec's AES-256-GCM (AES-NI + PCLMUL) when the .so
    is already built and the CPU supports it — bit-identical output to
    cryptography's AESGCM, at ~0.8 GB/s vs the SHAKE fallback's ~0.3.
    Never triggers a compile (ready() gate)."""
    try:
        from .. import native
        if native.aes256gcm_supported():
            return native
    except Exception:          # noqa: BLE001 — optional native lib
        pass
    return None


class AEAD:
    """AESGCM-shaped: encrypt/decrypt(nonce, data, aad).

    Implementation selection (consistent within one process, which is
    the deployment unit of every cluster here): the `cryptography`
    wheel's AESGCM, else the native codec's AES-256-GCM (the same NIST
    cipher — the two interoperate on the wire), else the stdlib
    SHAKE-256 + HMAC construction."""

    def __init__(self, key: bytes):
        self._native = None
        try:
            from cryptography.hazmat.primitives.ciphers.aead import \
                AESGCM
            self._gcm = AESGCM(key)
            self._key = None
        except ImportError:
            self._gcm = None
            self._key = bytes(key)
            if len(self._key) == 32:   # native path is AES-256 only
                self._native = _native_gcm()

    def encrypt(self, nonce: bytes, plain, aad: bytes) -> bytes:
        """`plain` is one buffer or a list of segments; segments are
        staged into ONE contiguous buffer here (the only copy the
        secure framing path makes) before the cipher runs."""
        if isinstance(plain, (list, tuple)):
            plain = b"".join(plain)
        if self._gcm is not None:
            return self._gcm.encrypt(nonce, bytes(plain), aad)
        if self._native is not None:
            return self._native.aes256gcm_seal(self._key, nonce,
                                               bytes(plain), aad)
        ct = _xor(self._key, nonce, bytes(plain))
        return ct + _tag(self._key, nonce, aad, ct)

    def decrypt(self, nonce: bytes, blob: bytes, aad: bytes) -> bytes:
        if self._gcm is not None:
            from cryptography.exceptions import InvalidTag as _IT
            try:
                return self._gcm.decrypt(nonce, blob, aad)
            except _IT:
                raise InvalidTag from None
        if self._native is not None:
            try:
                return self._native.aes256gcm_open(self._key, nonce,
                                                   bytes(blob), aad)
            except ValueError:
                raise InvalidTag from None
        if len(blob) < TAG_LEN:
            raise InvalidTag
        ct, tag = blob[:-TAG_LEN], blob[-TAG_LEN:]
        if not hmac.compare_digest(_tag(self._key, nonce, aad, ct),
                                   tag):
            raise InvalidTag
        return _xor(self._key, nonce, ct)


def hkdf_sha256(secret: bytes, salt: bytes, info: bytes) -> bytes:
    """RFC 5869 HKDF-SHA256, L=32 (single expand block) — identical
    output to cryptography's HKDF, so either path derives the same
    session key."""
    prk = hmac.new(salt, secret, sha256).digest()
    return hmac.new(prk, info + b"\x01", sha256).digest()
