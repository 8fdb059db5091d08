// aescbc — AES-256-CBC for secrets at rest (port of the reference
// package's native aescbc.cpp, byte for byte below this comment; the
// OpenSSL-AES role of concord-bft's secretsmanager/src/aes.cpp),
// implemented natively so key material never round-trips through slow
// pure-Python byte loops. C ABI, consumed via ctypes; built at first use
// by ops/_build.load_host("aescbc").
//
// Standard FIPS-197 AES with a 14-round 256-bit key schedule; CBC mode
// with caller-supplied IV. Padding/integrity live in the Python layer
// (PKCS#7 + HMAC-SHA256 encrypt-then-MAC in secrets/manager.py; PKCS#7
// for the PBES2 keys of comm/_der.py).

#include <cstdint>
#include <cstring>

namespace {

const uint8_t SBOX[256] = {
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

uint8_t INV_SBOX[256];
struct InvInit {
  InvInit() { for (int i = 0; i < 256; i++) INV_SBOX[SBOX[i]] = (uint8_t)i; }
} inv_init_;

const uint8_t RCON[15] = {0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,
                          0x1b,0x36,0x6c,0xd8,0xab,0x4d,0x9a};

inline uint8_t xtime(uint8_t x) {
  return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b));
}

inline uint8_t gmul(uint8_t a, uint8_t b) {
  uint8_t p = 0;
  for (int i = 0; i < 8; i++) {
    if (b & 1) p ^= a;
    a = xtime(a);
    b >>= 1;
  }
  return p;
}

struct Aes256 {
  uint8_t rk[15][16];  // round keys

  explicit Aes256(const uint8_t key[32]) {
    uint8_t w[60][4];
    memcpy(w, key, 32);
    for (int i = 8; i < 60; i++) {
      uint8_t t[4] = {w[i-1][0], w[i-1][1], w[i-1][2], w[i-1][3]};
      if (i % 8 == 0) {
        uint8_t tmp = t[0];
        t[0] = (uint8_t)(SBOX[t[1]] ^ RCON[i/8 - 1]);
        t[1] = SBOX[t[2]]; t[2] = SBOX[t[3]]; t[3] = SBOX[tmp];
      } else if (i % 8 == 4) {
        for (int k = 0; k < 4; k++) t[k] = SBOX[t[k]];
      }
      for (int k = 0; k < 4; k++) w[i][k] = (uint8_t)(w[i-8][k] ^ t[k]);
    }
    memcpy(rk, w, 240);
  }

  void encrypt_block(uint8_t s[16]) const {
    add_rk(s, 0);
    for (int r = 1; r < 14; r++) {
      sub_shift(s);
      mix(s);
      add_rk(s, r);
    }
    sub_shift(s);
    add_rk(s, 14);
  }

  void decrypt_block(uint8_t s[16]) const {
    add_rk(s, 14);
    inv_sub_shift(s);
    for (int r = 13; r >= 1; r--) {
      add_rk(s, r);
      inv_mix(s);
      inv_sub_shift(s);
    }
    add_rk(s, 0);
  }

 private:
  void add_rk(uint8_t s[16], int r) const {
    for (int i = 0; i < 16; i++) s[i] ^= rk[r][i];
  }

  static void sub_shift(uint8_t s[16]) {
    uint8_t t[16];
    // SubBytes + ShiftRows fused (column-major state layout)
    static const int M[16] = {0,5,10,15,4,9,14,3,8,13,2,7,12,1,6,11};
    for (int i = 0; i < 16; i++) t[i] = SBOX[s[M[i]]];
    memcpy(s, t, 16);
  }

  static void inv_sub_shift(uint8_t s[16]) {
    uint8_t t[16];
    static const int M[16] = {0,13,10,7,4,1,14,11,8,5,2,15,12,9,6,3};
    for (int i = 0; i < 16; i++) t[i] = INV_SBOX[s[M[i]]];
    memcpy(s, t, 16);
  }

  static void mix(uint8_t s[16]) {
    for (int c = 0; c < 4; c++) {
      uint8_t* p = s + 4 * c;
      uint8_t a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
      p[0] = (uint8_t)(xtime(a0) ^ (xtime(a1) ^ a1) ^ a2 ^ a3);
      p[1] = (uint8_t)(a0 ^ xtime(a1) ^ (xtime(a2) ^ a2) ^ a3);
      p[2] = (uint8_t)(a0 ^ a1 ^ xtime(a2) ^ (xtime(a3) ^ a3));
      p[3] = (uint8_t)((xtime(a0) ^ a0) ^ a1 ^ a2 ^ xtime(a3));
    }
  }

  static void inv_mix(uint8_t s[16]) {
    for (int c = 0; c < 4; c++) {
      uint8_t* p = s + 4 * c;
      uint8_t a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
      p[0] = (uint8_t)(gmul(a0,14) ^ gmul(a1,11) ^ gmul(a2,13) ^ gmul(a3,9));
      p[1] = (uint8_t)(gmul(a0,9) ^ gmul(a1,14) ^ gmul(a2,11) ^ gmul(a3,13));
      p[2] = (uint8_t)(gmul(a0,13) ^ gmul(a1,9) ^ gmul(a2,14) ^ gmul(a3,11));
      p[3] = (uint8_t)(gmul(a0,11) ^ gmul(a1,13) ^ gmul(a2,9) ^ gmul(a3,14));
    }
  }
};

}  // namespace

extern "C" {

// data length must be a multiple of 16 (padding done by the caller).
int aes256_cbc_encrypt(const uint8_t key[32], const uint8_t iv[16],
                       const uint8_t* in, uint8_t* out, uint32_t len) {
  if (len % 16) return -1;
  Aes256 aes(key);
  uint8_t chain[16];
  memcpy(chain, iv, 16);
  for (uint32_t off = 0; off < len; off += 16) {
    uint8_t block[16];
    for (int i = 0; i < 16; i++) block[i] = (uint8_t)(in[off+i] ^ chain[i]);
    aes.encrypt_block(block);
    memcpy(out + off, block, 16);
    memcpy(chain, block, 16);
  }
  return 0;
}

int aes256_cbc_decrypt(const uint8_t key[32], const uint8_t iv[16],
                       const uint8_t* in, uint8_t* out, uint32_t len) {
  if (len % 16) return -1;
  Aes256 aes(key);
  uint8_t chain[16];
  memcpy(chain, iv, 16);
  for (uint32_t off = 0; off < len; off += 16) {
    uint8_t block[16];
    memcpy(block, in + off, 16);
    uint8_t next_chain[16];
    memcpy(next_chain, block, 16);
    aes.decrypt_block(block);
    for (int i = 0; i < 16; i++) out[off+i] = (uint8_t)(block[i] ^ chain[i]);
    memcpy(chain, next_chain, 16);
  }
  return 0;
}

}  // extern "C"
