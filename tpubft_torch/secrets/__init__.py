"""Secrets manager — private key material encrypted at rest (port of
tpubft/secrets/).

Rebuild of concord-bft's secretsmanager/ (secrets_manager_enc.h,
secrets_manager_plain.h, aes.cpp, base64.cpp): AES-256-CBC (the port's
native C++ engine, native/aescbc.cpp, built by ops/_build.load_host)
with PBKDF2-HMAC-SHA256 key derivation, PKCS#7 padding, and
encrypt-then-MAC integrity; plus the plaintext variant for tests.
"""
from tpubft_torch.secrets.manager import (SecretsError, SecretsManagerEnc,
                                          SecretsManagerPlain)

__all__ = ["SecretsManagerEnc", "SecretsManagerPlain", "SecretsError"]
