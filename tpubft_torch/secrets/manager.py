"""Secrets managers (port of tpubft/secrets/manager.py, the same bytes).
File format (versioned, self-describing):

  b"TPUBFTSEC1" | salt(16) | iv(16) | ciphertext | hmac-sha256(32)

where the hmac covers salt|iv|ciphertext under a key derived separately
from the same password (encrypt-then-MAC).

Port divergence (reference manager.py:23-33): the AES engine is the
port's own native/aescbc.cpp, built with g++ into ops/_build/ at first
use; a failed build raises ops/_build.BuildError. `aes256_cbc` is the
one call into it, shared with the PBES2 key writer (comm/_der.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import hmac as hmac_mod
import os

from tpubft_torch.ops import _build

_MAGIC = b"TPUBFTSEC1"
_PBKDF2_ITERS = 100_000


class SecretsError(Exception):
    pass


def _lib():
    lib = _build.load_host("aescbc")
    if getattr(lib, "_aes_typed", False):
        return lib
    for fn in (lib.aes256_cbc_encrypt, lib.aes256_cbc_decrypt):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_char_p, ctypes.c_uint32]
    lib._aes_typed = True
    return lib


def aes256_cbc(key: bytes, iv: bytes, data: bytes,
               decrypt: bool = False) -> bytes:
    """AES-256-CBC of `data` (a multiple of 16 bytes) under `key` (32
    bytes) and `iv` (16 bytes), through native/aescbc.cpp."""
    if len(key) != 32 or len(iv) != 16:
        raise SecretsError("AES-256-CBC needs a 32-byte key and a 16-byte IV")
    out = ctypes.create_string_buffer(len(data))
    fn = _lib().aes256_cbc_decrypt if decrypt else _lib().aes256_cbc_encrypt
    if fn(key, iv, data, out, len(data)) != 0:
        raise SecretsError("decryption failed" if decrypt
                           else "encryption failed")
    return out.raw


def _derive_keys(password: bytes, salt: bytes) -> tuple:
    material = hashlib.pbkdf2_hmac("sha256", password, salt, _PBKDF2_ITERS,
                                   dklen=64)
    return material[:32], material[32:]  # (aes key, hmac key)


def _pad(data: bytes) -> bytes:
    n = 16 - len(data) % 16
    return data + bytes([n]) * n


def _unpad(data: bytes) -> bytes:
    if not data or data[-1] < 1 or data[-1] > 16 \
            or data[-data[-1]:] != bytes([data[-1]]) * data[-1]:
        raise SecretsError("bad padding")
    return data[:-data[-1]]


class SecretsManagerEnc:
    """Encrypted secrets at rest (concord-bft secrets_manager_enc.h)."""

    def __init__(self, password: bytes) -> None:
        if not password:
            raise SecretsError("empty password")
        self._password = password

    def encrypt(self, plaintext: bytes) -> bytes:
        salt = os.urandom(16)
        iv = os.urandom(16)
        aes_key, mac_key = _derive_keys(self._password, salt)
        body = salt + iv + aes256_cbc(aes_key, iv, _pad(plaintext))
        tag = hmac_mod.new(mac_key, body, hashlib.sha256).digest()
        return _MAGIC + body + tag

    def decrypt(self, blob: bytes) -> bytes:
        if not blob.startswith(_MAGIC) or len(blob) < len(_MAGIC) + 64:
            raise SecretsError("not a tpubft secret blob")
        body, tag = blob[len(_MAGIC):-32], blob[-32:]
        salt, iv, ct = body[:16], body[16:32], body[32:]
        aes_key, mac_key = _derive_keys(self._password, salt)
        expect = hmac_mod.new(mac_key, body, hashlib.sha256).digest()
        if not hmac_mod.compare_digest(tag, expect):
            raise SecretsError("integrity check failed (wrong password "
                               "or tampered file)")
        if len(ct) % 16:
            raise SecretsError("truncated ciphertext")
        return _unpad(aes256_cbc(aes_key, iv, ct, decrypt=True))

    # file helpers (concord-bft encryptFile/decryptFile)
    def encrypt_file(self, path: str, plaintext: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(self.encrypt(plaintext))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def decrypt_file(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return self.decrypt(fh.read())


class SecretsManagerPlain:
    """Plaintext variant for tests (concord-bft secrets_manager_plain.h)."""

    def encrypt(self, plaintext: bytes) -> bytes:
        return plaintext

    def decrypt(self, blob: bytes) -> bytes:
        return blob

    def encrypt_file(self, path: str, plaintext: bytes) -> None:
        with open(path, "wb") as fh:
            fh.write(plaintext)

    def decrypt_file(self, path: str) -> bytes:
        with open(path, "rb") as fh:
            return fh.read()
