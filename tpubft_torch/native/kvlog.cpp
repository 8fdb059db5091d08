// kvlog — native log-structured KV engine (the RocksDB role of
// concord-bft's storage layer, storage/src/rocksdb_client.cpp, rebuilt as
// a small crash-consistent C++ engine for this framework).
//
// The port's copy of the JAX package's native/kvlog.cpp, byte for byte in
// behaviour and in the files it writes; built with g++ into ops/_build/
// at first use (ops/_build.load_host("kvlog")).
//
// Design: append-only WAL of checksummed batch records + full in-memory
// ordered index (std::map). Recovery replays complete records and stops at
// the first torn/corrupt tail. Compaction rewrites the live set as a single
// batch record into a temp file and atomically renames it over the log.
//
// Record framing:  [u32 magic 0x4b564c47][u32 crc32(payload)][u32 len][payload]
// Batch payload:   repeat{ u8 op(1=put,2=del) | u32 klen | key | [u32 vlen | val] }
// (shared with Python WriteBatch.encode, tpubft_torch/storage/interfaces.py)
//
// C ABI only — consumed via ctypes from tpubft_torch/storage/native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x4b564c47;  // "GLVK" little-endian

uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  }
} crc_init_;

uint32_t crc32(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

void wr_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
  p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

struct KvLog {
  std::map<std::string, std::string> index;
  std::string path;
  int fd = -1;
  uint64_t wal_bytes = 0;
  bool sync_writes = true;
  std::mutex mu;
};

// Apply a validated batch payload to the index. Returns false on malformed.
bool apply_payload(KvLog* db, const uint8_t* p, size_t n) {
  size_t off = 0;
  while (off < n) {
    if (off + 5 > n) return false;
    uint8_t op = p[off];
    uint32_t klen = rd_u32(p + off + 1);
    off += 5;
    if (off + klen > n) return false;
    std::string key((const char*)p + off, klen);
    off += klen;
    if (op == 1) {
      if (off + 4 > n) return false;
      uint32_t vlen = rd_u32(p + off);
      off += 4;
      if (off + vlen > n) return false;
      db->index[std::move(key)] = std::string((const char*)p + off, vlen);
      off += vlen;
    } else if (op == 2) {
      db->index.erase(key);
    } else {
      return false;
    }
  }
  return true;
}

bool validate_payload(const uint8_t* p, size_t n) {
  size_t off = 0;
  while (off < n) {
    if (off + 5 > n) return false;
    uint8_t op = p[off];
    uint32_t klen = rd_u32(p + off + 1);
    off += 5 + klen;
    if (off > n) return false;
    if (op == 1) {
      if (off + 4 > n) return false;
      uint32_t vlen = rd_u32(p + off);
      off += 4 + vlen;
      if (off > n) return false;
    } else if (op != 2) {
      return false;
    }
  }
  return off == n;
}

void append_put(std::vector<uint8_t>& out, const std::string& k,
                const std::string& v) {
  size_t base = out.size();
  out.resize(base + 9 + k.size() + v.size());
  out[base] = 1;
  wr_u32(out.data() + base + 1, (uint32_t)k.size());
  memcpy(out.data() + base + 5, k.data(), k.size());
  wr_u32(out.data() + base + 5 + k.size(), (uint32_t)v.size());
  memcpy(out.data() + base + 9 + k.size(), v.data(), v.size());
}

// Serialize the whole index as one batch payload (for compaction).
std::vector<uint8_t> snapshot_payload(KvLog* db) {
  std::vector<uint8_t> out;
  for (const auto& [k, v] : db->index) append_put(out, k, v);
  return out;
}

bool write_record(int fd, const uint8_t* payload, uint32_t len, bool sync) {
  uint8_t hdr[12];
  wr_u32(hdr, kMagic);
  wr_u32(hdr + 4, crc32(payload, len));
  wr_u32(hdr + 8, len);
  struct iovec {
    const uint8_t* p; size_t n;
  } parts[2] = {{hdr, 12}, {payload, len}};
  for (auto& part : parts) {
    size_t done = 0;
    while (done < part.n) {
      ssize_t w = ::write(fd, part.p + done, part.n - done);
      if (w < 0) return false;
      done += (size_t)w;
    }
  }
  if (sync && fsync(fd) != 0) return false;
  return true;
}

}  // namespace

extern "C" {

KvLog* kvlog_open(const char* path, int sync_writes) {
  KvLog* db = new KvLog;
  db->path = path;
  db->sync_writes = sync_writes != 0;
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) { delete db; return nullptr; }
  // Recover: scan records until torn/corrupt tail, then truncate there so
  // future appends start from a clean boundary.
  off_t valid_end = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint8_t hdr[12];
    ssize_t r = ::pread(fd, hdr, 12, valid_end);
    if (r != 12) break;
    if (rd_u32(hdr) != kMagic) break;
    uint32_t crc = rd_u32(hdr + 4), len = rd_u32(hdr + 8);
    if (len > (1u << 30)) break;
    buf.resize(len);
    r = ::pread(fd, buf.data(), len, valid_end + 12);
    if (r != (ssize_t)len) break;
    if (crc32(buf.data(), len) != crc) break;
    if (!apply_payload(db, buf.data(), len)) break;
    valid_end += 12 + len;
  }
  if (ftruncate(fd, valid_end) != 0) { ::close(fd); delete db; return nullptr; }
  if (lseek(fd, valid_end, SEEK_SET) < 0) { ::close(fd); delete db; return nullptr; }
  db->fd = fd;
  db->wal_bytes = (uint64_t)valid_end;
  return db;
}

void kvlog_close(KvLog* db) {
  if (!db) return;
  if (db->fd >= 0) ::close(db->fd);
  delete db;
}

// Atomically apply + log one batch (payload = WriteBatch encoding).
int kvlog_apply(KvLog* db, const uint8_t* payload, uint32_t len) {
  std::lock_guard<std::mutex> g(db->mu);
  // Recovery rejects len > 1GiB as corruption — refuse to write what we
  // could never replay.
  if (len > (1u << 30)) return -3;
  if (!validate_payload(payload, len)) return -2;
  if (!write_record(db->fd, payload, len, db->sync_writes)) {
    // Roll back a partial append so the torn bytes can't shadow later
    // successfully-committed records at recovery time.
    if (ftruncate(db->fd, (off_t)db->wal_bytes) == 0)
      lseek(db->fd, (off_t)db->wal_bytes, SEEK_SET);
    return -1;
  }
  apply_payload(db, payload, len);
  db->wal_bytes += 12 + len;
  return 0;
}

int kvlog_get(KvLog* db, const uint8_t* key, uint32_t klen, uint8_t** val,
              uint32_t* vlen) {
  std::lock_guard<std::mutex> g(db->mu);
  auto it = db->index.find(std::string((const char*)key, klen));
  if (it == db->index.end()) return 1;
  *vlen = (uint32_t)it->second.size();
  *val = (uint8_t*)malloc(it->second.size() ? it->second.size() : 1);
  memcpy(*val, it->second.data(), it->second.size());
  return 0;
}

void kvlog_free(uint8_t* p) { free(p); }

uint64_t kvlog_count(KvLog* db) {
  std::lock_guard<std::mutex> g(db->mu);
  return db->index.size();
}

uint64_t kvlog_wal_bytes(KvLog* db) {
  std::lock_guard<std::mutex> g(db->mu);
  return db->wal_bytes;
}

// Range scan [start, end) materialized as one buffer in batch-payload
// format (all ops = put). elen==0xFFFFFFFF means unbounded end.
int kvlog_scan(KvLog* db, const uint8_t* start, uint32_t slen,
               const uint8_t* end, uint32_t elen, uint8_t** out,
               uint32_t* outlen) {
  std::lock_guard<std::mutex> g(db->mu);
  std::string lo((const char*)start, slen);
  auto it = db->index.lower_bound(lo);
  auto stop = (elen == 0xFFFFFFFFu)
                  ? db->index.end()
                  : db->index.lower_bound(std::string((const char*)end, elen));
  std::vector<uint8_t> buf;
  for (; it != stop; ++it) append_put(buf, it->first, it->second);
  *outlen = (uint32_t)buf.size();
  *out = (uint8_t*)malloc(buf.size() ? buf.size() : 1);
  memcpy(*out, buf.data(), buf.size());
  return 0;
}

// Rewrite live set into <path>.tmp, fsync, rename over the log.
int kvlog_compact(KvLog* db) {
  std::lock_guard<std::mutex> g(db->mu);
  auto payload = snapshot_payload(db);
  std::string tmp = db->path + ".tmp";
  int fd = ::open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (!write_record(fd, payload.data(), (uint32_t)payload.size(), true)) {
    ::close(fd);
    return -1;
  }
  if (rename(tmp.c_str(), db->path.c_str()) != 0) { ::close(fd); return -1; }
  ::close(db->fd);
  db->fd = fd;
  db->wal_bytes = 12 + payload.size();
  return 0;
}

int kvlog_sync(KvLog* db) {
  std::lock_guard<std::mutex> g(db->mu);
  return fsync(db->fd) == 0 ? 0 : -1;
}

// Write a consistent snapshot of the live set to `path` (operator DB
// checkpoints — the RocksDB-checkpoint role of DbCheckpointManager).
int kvlog_checkpoint(KvLog* db, const char* path) {
  std::lock_guard<std::mutex> g(db->mu);
  auto payload = snapshot_payload(db);
  std::string tmp = std::string(path) + ".tmp";
  int fd = ::open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  bool ok = write_record(fd, payload.data(), (uint32_t)payload.size(), true);
  ::close(fd);
  if (!ok || rename(tmp.c_str(), path) != 0) {
    unlink(tmp.c_str());
    return -1;
  }
  return 0;
}

}  // extern "C"
