"""Model encryption — AES cipher + key utilities, no external deps (a
copy of paddle_tpu/framework/crypto.py, so that either package decrypts
what the other encrypted: the same cipher, key derivation and byte
format).

Reference: paddle/fluid/framework/io/crypto/{aes_cipher.cc, cipher.cc,
cipher_utils.cc} (CryptoPP-backed AES exposed through pybind as
``core.Cipher``/``CipherFactory``/``CipherUtils``).  The environment has
no crypto library, so the AES-128/192/256 block cipher is implemented
directly (FIPS-197 tables, key-answer-tested) and runs in CTR mode with
an HMAC-SHA256 tag (encrypt-then-MAC) — authenticated encryption serving
the reference's AES/GCM role.  File format:
``b"PTAE1" | 16-byte nonce | ciphertext | 32-byte hmac``.

API shape follows the reference: ``CipherFactory.create_cipher()`` ->
cipher with ``encrypt/decrypt/encrypt_to_file/decrypt_from_file``, and
``CipherUtils.gen_key / gen_key_to_file / read_key_from_file``.
"""
from __future__ import annotations

import hmac
import hashlib
import os
import struct

__all__ = ["AESCipher", "CipherFactory", "CipherUtils"]

_SBOX = [
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67,
    0x2b, 0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59,
    0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7,
    0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1,
    0x71, 0xd8, 0x31, 0x15, 0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05,
    0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83,
    0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29,
    0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b,
    0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf, 0xd0, 0xef, 0xaa,
    0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c,
    0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc,
    0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19,
    0x73, 0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee,
    0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49,
    0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4,
    0xea, 0x65, 0x7a, 0xae, 0x08, 0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6,
    0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a, 0x70,
    0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9,
    0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e,
    0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf, 0x8c, 0xa1,
    0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0,
    0x54, 0xbb, 0x16,
]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36,
         0x6c, 0xd8, 0xab, 0x4d]


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1b) & 0xff if a & 0x100 else a


# precompute GF(2^8) multiply-by-2 and -by-3 tables for MixColumns
_MUL2 = [_xtime(i) for i in range(256)]
_MUL3 = [_xtime(i) ^ i for i in range(256)]


def _expand_key(key: bytes):
    nk = len(key) // 4
    nr = {4: 10, 6: 12, 8: 14}[nk]
    w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            t = [_SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    # round keys as flat 16-byte lists
    return [sum(w[4 * r:4 * r + 4], []) for r in range(nr + 1)], nr


def _encrypt_block(state: list, round_keys, nr: int) -> bytes:
    s = [b ^ k for b, k in zip(state, round_keys[0])]
    for rnd in range(1, nr):
        s = [_SBOX[b] for b in s]
        # ShiftRows on column-major state: byte i lives at 4*col+row;
        # row r rotates left by r
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        ns = [0] * 16
        for c in range(4):
            a0, a1, a2, a3 = s[4 * c:4 * c + 4]
            ns[4 * c + 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
            ns[4 * c + 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
            ns[4 * c + 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
            ns[4 * c + 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
        s = [b ^ k for b, k in zip(ns, round_keys[rnd])]
    s = [_SBOX[b] for b in s]
    s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
    return bytes(b ^ k for b, k in zip(s, round_keys[nr]))


_MAGIC = b"PTAE1"


class AESCipher:
    """AES-CTR + HMAC-SHA256 (reference AESCipher role)."""

    def __init__(self, key_len: int = 16):
        if key_len not in (16, 24, 32):
            raise ValueError("AES key length must be 16/24/32 bytes")
        self._key_len = key_len

    def _keys(self, key: bytes):
        if len(key) != self._key_len:
            raise ValueError(
                f"expected a {self._key_len}-byte key, got {len(key)}")
        enc_key = hashlib.sha256(b"enc" + key).digest()[:self._key_len]
        mac_key = hashlib.sha256(b"mac" + key).digest()
        return enc_key, mac_key

    def _ctr_stream(self, enc_key: bytes, nonce: bytes, n: int) -> bytes:
        rks, nr = _expand_key(enc_key)
        out = bytearray()
        hi, lo = struct.unpack(">QQ", nonce)
        for i in range((n + 15) // 16):
            ctr = struct.pack(">QQ", hi, (lo + i) & 0xFFFFFFFFFFFFFFFF)
            out += _encrypt_block(list(ctr), rks, nr)
        return bytes(out[:n])

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        if isinstance(plaintext, str):
            plaintext = plaintext.encode()
        enc_key, mac_key = self._keys(key)
        nonce = os.urandom(16)
        ct = bytes(p ^ s for p, s in zip(
            plaintext, self._ctr_stream(enc_key, nonce, len(plaintext))))
        tag = hmac.new(mac_key, _MAGIC + nonce + ct,
                       hashlib.sha256).digest()
        return _MAGIC + nonce + ct + tag

    def decrypt(self, blob: bytes, key: bytes) -> bytes:
        enc_key, mac_key = self._keys(key)
        if len(blob) < len(_MAGIC) + 16 + 32 or \
                not blob.startswith(_MAGIC):
            raise ValueError("not a paddle_tpu-encrypted payload")
        nonce = blob[len(_MAGIC):len(_MAGIC) + 16]
        ct, tag = blob[len(_MAGIC) + 16:-32], blob[-32:]
        want = hmac.new(mac_key, _MAGIC + nonce + ct,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("authentication failed: wrong key or "
                             "corrupted file")
        return bytes(c ^ s for c, s in zip(
            ct, self._ctr_stream(enc_key, nonce, len(ct))))

    def encrypt_to_file(self, plaintext: bytes, key: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key: bytes, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read(), key)


class CipherFactory:
    @staticmethod
    def create_cipher(config_file: str = None) -> AESCipher:
        # the reference reads a CryptoPP property file; the only knob that
        # survives is the key length
        key_len = 16
        if config_file and os.path.exists(config_file):
            with open(config_file) as f:
                for line in f:
                    if "keysize" in line.lower().replace("_", ""):
                        key_len = int(line.split("=")[-1].strip()) // 8 \
                            if int(line.split("=")[-1].strip()) > 32 \
                            else int(line.split("=")[-1].strip())
        return AESCipher(key_len)


class CipherUtils:
    @staticmethod
    def gen_key(length_bits: int = 128) -> bytes:
        if length_bits not in (128, 192, 256):
            raise ValueError("key length must be 128/192/256 bits")
        return os.urandom(length_bits // 8)

    @staticmethod
    def gen_key_to_file(length_bits: int, path: str) -> bytes:
        key = CipherUtils.gen_key(length_bits)
        with open(path, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()


def _aes_ecb_encrypt_block(key: bytes, block: bytes) -> bytes:
    """Raw single-block AES (test hook for FIPS-197 known answers)."""
    rks, nr = _expand_key(key)
    return _encrypt_block(list(block), rks, nr)
