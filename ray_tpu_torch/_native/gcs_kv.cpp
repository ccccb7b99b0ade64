// Native GCS key-value storage engine.
//
// Reference: src/ray/gcs/gcs_kv_manager.h + store_client/ — the GCS's
// internal KV (function exports, named metadata, cluster config) is a
// C++ storage layer; here it is a namespaced hash map with binary
// snapshot/restore for the head's crash persistence. The Python
// control plane keeps only thin ctypes bindings (gcs_kv_native.py).
// The port's copy of ray_tpu/_native/gcs_kv.cpp, unchanged in behaviour.
//
// ABI conventions (shared with node_store.cpp): plain C symbols,
// two-phase reads (call with a buffer; a return value larger than the
// capacity means "grow and retry" — the data is only written when it
// fits), and a single mutex (the GCS KV is control-plane metadata, not
// a data-plane hot path).

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct KvStore {
  std::mutex mu;
  // map (not unordered): snapshot and keys() iterate in a stable
  // order, which keeps persisted images byte-identical for unchanged
  // state.
  std::map<std::string, std::map<std::string, std::string>> spaces;
  uint64_t version = 0;
};

std::string make_key(const uint8_t* k, size_t klen) {
  return std::string(reinterpret_cast<const char*>(k), klen);
}

void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 24) & 0xff);
}

bool get_u32(const uint8_t* data, size_t len, size_t& off, uint32_t& v) {
  if (off + 4 > len) return false;
  v = static_cast<uint32_t>(data[off]) |
      (static_cast<uint32_t>(data[off + 1]) << 8) |
      (static_cast<uint32_t>(data[off + 2]) << 16) |
      (static_cast<uint32_t>(data[off + 3]) << 24);
  off += 4;
  return true;
}

void put_blob(std::vector<uint8_t>& out, const std::string& s) {
  put_u32(out, static_cast<uint32_t>(s.size()));
  out.insert(out.end(), s.begin(), s.end());
}

bool get_blob(const uint8_t* data, size_t len, size_t& off,
              std::string& s) {
  uint32_t n;
  if (!get_u32(data, len, off, n)) return false;
  if (off + n > len) return false;
  s.assign(reinterpret_cast<const char*>(data + off), n);
  off += n;
  return true;
}

// Serialize the whole store (or one namespace's keys) into out.
void serialize_all(KvStore* kv, std::vector<uint8_t>& out) {
  uint32_t total = 0;
  for (auto& ns : kv->spaces) total += ns.second.size();
  put_u32(out, total);
  for (auto& ns : kv->spaces) {
    for (auto& entry : ns.second) {
      put_blob(out, ns.first);
      put_blob(out, entry.first);
      put_blob(out, entry.second);
    }
  }
}

}  // namespace

extern "C" {

void* gcs_kv_create() { return new KvStore(); }

void gcs_kv_destroy(void* h) { delete static_cast<KvStore*>(h); }

uint64_t gcs_kv_version(void* h) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  return kv->version;
}

// 1 = stored, 0 = key existed and overwrite was 0, -1 = key/value too
// large for the u32-length-prefixed snapshot format (a silently
// truncated prefix would corrupt persisted images).
int gcs_kv_put(void* h, const char* ns, const uint8_t* k, size_t klen,
               const uint8_t* v, size_t vlen, int overwrite) {
  if (klen >= UINT32_MAX || vlen >= UINT32_MAX) return -1;
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  auto& space = kv->spaces[ns];
  std::string key = make_key(k, klen);
  if (!overwrite && space.count(key)) return 0;
  space[key] = std::string(reinterpret_cast<const char*>(v), vlen);
  kv->version++;
  return 1;
}

// Value length, -1 if missing. Writes the value only when it fits cap.
long gcs_kv_get(void* h, const char* ns, const uint8_t* k, size_t klen,
                uint8_t* out, size_t cap) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  auto space = kv->spaces.find(ns);
  if (space == kv->spaces.end()) return -1;
  auto it = space->second.find(make_key(k, klen));
  if (it == space->second.end()) return -1;
  if (it->second.size() <= cap && out != nullptr) {
    std::memcpy(out, it->second.data(), it->second.size());
  }
  return static_cast<long>(it->second.size());
}

int gcs_kv_del(void* h, const char* ns, const uint8_t* k, size_t klen) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  auto space = kv->spaces.find(ns);
  if (space == kv->spaces.end()) return 0;
  size_t erased = space->second.erase(make_key(k, klen));
  if (erased) kv->version++;
  return erased ? 1 : 0;
}

int gcs_kv_exists(void* h, const char* ns, const uint8_t* k,
                  size_t klen) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  auto space = kv->spaces.find(ns);
  if (space == kv->spaces.end()) return 0;
  return space->second.count(make_key(k, klen)) ? 1 : 0;
}

// Keys with prefix, serialized [u32 count][u32 len, key]...; returns
// needed size (write happens only when it fits cap).
long gcs_kv_keys(void* h, const char* ns, const uint8_t* prefix,
                 size_t plen, uint8_t* out, size_t cap) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  std::vector<uint8_t> buf;
  std::string pref = make_key(prefix, plen);
  uint32_t count = 0;
  put_u32(buf, 0);  // patched below
  auto space = kv->spaces.find(ns);
  if (space != kv->spaces.end()) {
    for (auto& entry : space->second) {
      if (entry.first.compare(0, pref.size(), pref) == 0) {
        put_blob(buf, entry.first);
        count++;
      }
    }
  }
  buf[0] = count & 0xff;
  buf[1] = (count >> 8) & 0xff;
  buf[2] = (count >> 16) & 0xff;
  buf[3] = (count >> 24) & 0xff;
  if (buf.size() <= cap && out != nullptr) {
    std::memcpy(out, buf.data(), buf.size());
  }
  return static_cast<long>(buf.size());
}

// Full-image snapshot: [u32 count][ns, key, value]... (blobs are
// u32-length-prefixed). Returns needed size; writes only when it fits.
long gcs_kv_snapshot(void* h, uint8_t* out, size_t cap) {
  KvStore* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  std::vector<uint8_t> buf;
  serialize_all(kv, buf);
  if (buf.size() <= cap && out != nullptr) {
    std::memcpy(out, buf.data(), buf.size());
  }
  return static_cast<long>(buf.size());
}

// Merge a snapshot image into the store (restore-on-start semantics:
// existing keys are overwritten). Returns entries applied, -1 on a
// corrupt image (nothing applied).
long gcs_kv_restore(void* h, const uint8_t* data, size_t len) {
  KvStore* kv = static_cast<KvStore*>(h);
  // Parse FIRST, apply after: a truncated image must not half-apply.
  size_t off = 0;
  uint32_t count;
  if (!get_u32(data, len, off, count)) return -1;
  // A forged count must fail cleanly, not bad_alloc on reserve: every
  // entry needs at least 3 length prefixes (12 bytes).
  if (count > (len - off) / 12) return -1;
  std::vector<std::pair<std::string, std::pair<std::string, std::string>>>
      entries;
  entries.reserve(count);
  for (uint32_t i = 0; i < count; i++) {
    std::string ns, key, value;
    if (!get_blob(data, len, off, ns) ||
        !get_blob(data, len, off, key) ||
        !get_blob(data, len, off, value)) {
      return -1;
    }
    entries.emplace_back(std::move(ns),
                         std::make_pair(std::move(key), std::move(value)));
  }
  std::lock_guard<std::mutex> g(kv->mu);
  for (auto& e : entries) {
    kv->spaces[e.first][e.second.first] = e.second.second;
  }
  kv->version++;
  return static_cast<long>(entries.size());
}

}  // extern "C"
