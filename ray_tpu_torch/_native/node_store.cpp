// Native node object store — the worker daemon's blob store in C++.
//
// Reference: the raylet's local object store + LocalObjectManager
// (src/ray/object_manager/object_store.h, local_object_manager.h:110
// SpillObjects): primary copies of task/actor results keyed by 16-byte
// ids, owner-tagged for owner-death sweeps, spilled to disk past a cap
// and restored on fetch; pulled peer copies in a FIFO-evicted cache.
//
// The port's copy of ray_tpu/_native/node_store.cpp, with rt_ns_spilled
// (whether the only copy is on disk: the executor's fetch plans say so).
// Python binds via ctypes (rt_ns_* C API, see
// ray_tpu_torch/_private/node_store_native.py). Reads copy into caller
// buffers, so no store memory ever outlives the mutex — and because
// ctypes releases the GIL around calls, concurrent chunk fetches do
// their memcpy/pread without serializing the daemon's Python threads.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct Key {
  uint8_t b[16];
  bool operator==(const Key& o) const { return !memcmp(b, o.b, 16); }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h;
    memcpy(&h, k.b, 8);
    uint64_t l;
    memcpy(&l, k.b + 8, 8);
    return static_cast<size_t>(h * 1000003ULL ^ l);
  }
};

struct Entry {
  std::string data;        // in-memory bytes (empty once spilled)
  std::string spill_path;  // non-empty => on disk
  uint64_t size = 0;
  bool cached = false;
  std::string owner;
  uint64_t seq = 0;  // insertion order: spill victims are the oldest
};

struct NodeStore {
  std::mutex mu;
  std::unordered_map<Key, Entry, KeyHash> map;
  std::list<Key> cache_order;  // FIFO of cached (pulled) copies
  // seq -> key for IN-MEMORY primaries: spill victims pop from the
  // front in O(log n) instead of rescanning the whole map per victim.
  std::map<uint64_t, Key> primary_order;
  uint64_t cache_bytes = 0;
  uint64_t primary_bytes = 0;
  uint64_t cache_limit = 0;
  uint64_t primary_limit = 0;
  uint64_t fetches = 0;
  uint64_t spills = 0;
  uint64_t restores = 0;
  uint64_t next_seq = 0;
  std::string spill_dir;
};

std::string hex16(const uint8_t* id) {
  static const char* d = "0123456789abcdef";
  std::string out(32, '0');
  for (int i = 0; i < 16; i++) {
    out[2 * i] = d[id[i] >> 4];
    out[2 * i + 1] = d[id[i] & 0xF];
  }
  return out;
}

// mu held. Forget an entry entirely (memory + spill file + owner tag).
bool forget_locked(NodeStore* s, const Key& k) {
  auto it = s->map.find(k);
  if (it == s->map.end()) return false;
  Entry& e = it->second;
  if (!e.spill_path.empty()) {
    unlink(e.spill_path.c_str());
  } else if (e.cached) {
    s->cache_bytes -= e.data.size();
    for (auto c = s->cache_order.begin(); c != s->cache_order.end(); ++c) {
      if (*c == k) { s->cache_order.erase(c); break; }
    }
  } else {
    s->primary_bytes -= e.data.size();
    s->primary_order.erase(e.seq);
  }
  s->map.erase(it);
  return true;
}

// Recursive mkdir (the Python store uses os.makedirs; a nested spill
// dir must not silently disable spilling).
void mkdir_p(const std::string& path) {
  std::string cur;
  for (size_t i = 0; i <= path.size(); i++) {
    if (i == path.size() || path[i] == '/') {
      if (!cur.empty()) mkdir(cur.c_str(), 0777);
      if (i < path.size()) cur += '/';
      continue;
    }
    cur += path[i];
  }
}

// mu held. Spill the oldest in-memory primaries until under the cap.
// The spill WRITE happens under the mutex: daemon-side simplicity over
// concurrency — reads of spilled entries stream outside the lock
// (rt_ns_read).
void maybe_spill_locked(NodeStore* s, const Key& just_put) {
  while (s->primary_bytes > s->primary_limit) {
    // Oldest in-memory primary from the order index (never the blob
    // being put right now).
    auto ord = s->primary_order.begin();
    if (ord != s->primary_order.end() && ord->second == just_put)
      ++ord;
    if (ord == s->primary_order.end()) return;
    Key victim = ord->second;
    Entry& e = s->map[victim];
    mkdir_p(s->spill_dir);
    char path[4096];
    snprintf(path, sizeof(path), "%s/%d-%s-native.blob",
             s->spill_dir.c_str(), (int)getpid(),
             hex16(victim.b).c_str());
    FILE* f = fopen(path, "wb");
    if (f == nullptr) return;  // unwritable disk: keep in memory
    size_t n = fwrite(e.data.data(), 1, e.data.size(), f);
    fclose(f);
    if (n != e.data.size()) {
      unlink(path);
      return;
    }
    s->primary_bytes -= e.data.size();
    s->primary_order.erase(e.seq);
    e.spill_path = path;
    e.data.clear();
    e.data.shrink_to_fit();
    s->spills++;
  }
}

}  // namespace

extern "C" {

void* rt_ns_create(uint64_t cache_limit, uint64_t primary_limit,
                   const char* spill_dir) {
  NodeStore* s = new NodeStore();
  s->cache_limit = cache_limit;
  s->primary_limit = primary_limit;
  s->spill_dir = spill_dir ? spill_dir : "/tmp/ray_tpu_node_spill";
  return s;
}

void rt_ns_destroy(void* h) {
  NodeStore* s = static_cast<NodeStore*>(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (auto& kv : s->map) {
      if (!kv.second.spill_path.empty())
        unlink(kv.second.spill_path.c_str());
    }
  }
  delete s;
}

int rt_ns_put(void* h, const uint8_t* id, const uint8_t* data,
              uint64_t len, int cached, const char* owner) {
  NodeStore* s = static_cast<NodeStore*>(h);
  Key k;
  memcpy(k.b, id, 16);
  std::lock_guard<std::mutex> g(s->mu);
  forget_locked(s, k);  // reseal replaces any prior copy/spill
  Entry e;
  e.data.assign(reinterpret_cast<const char*>(data), len);
  e.size = len;
  e.cached = cached != 0;
  e.seq = s->next_seq++;
  if (owner != nullptr && owner[0] != '\0' && !e.cached) e.owner = owner;
  s->map.emplace(k, std::move(e));
  if (cached) {
    s->cache_order.push_back(k);
    s->cache_bytes += len;
    while (s->cache_bytes > s->cache_limit && !s->cache_order.empty()) {
      Key victim = s->cache_order.front();
      forget_locked(s, victim);  // erases from cache_order too
    }
  } else {
    s->primary_bytes += len;
    s->primary_order[s->map[k].seq] = k;
    maybe_spill_locked(s, k);
  }
  return 0;
}

// Copy [offset, offset+want) into out; returns the TOTAL object size,
// -1 when absent. Spilled entries stream from disk OUTSIDE the store
// mutex (a multi-GB restore from slow disk must not block every
// put/get/free on the node; a concurrent free unlinks the file and the
// read then reports the object absent — correct, it WAS freed).
int64_t rt_ns_read(void* h, const uint8_t* id, uint64_t offset,
                   uint8_t* out, uint64_t want, uint64_t* copied) {
  NodeStore* s = static_cast<NodeStore*>(h);
  Key k;
  memcpy(k.b, id, 16);
  std::string spill_path;
  uint64_t size = 0;
  uint64_t n = 0;
  {
    std::lock_guard<std::mutex> g(s->mu);
    auto it = s->map.find(k);
    if (it == s->map.end()) return -1;
    Entry& e = it->second;
    size = e.size;
    if (offset < size) {
      n = size - offset;
      if (n > want) n = want;
    }
    if (e.spill_path.empty()) {
      if (n > 0) memcpy(out, e.data.data() + offset, n);
      s->fetches++;
      if (copied != nullptr) *copied = n;
      return (int64_t)size;
    }
    spill_path = e.spill_path;
  }
  if (n > 0) {
    FILE* f = fopen(spill_path.c_str(), "rb");
    if (f == nullptr) return -1;  // freed concurrently
    if (fseek(f, (long)offset, SEEK_SET) != 0) {
      fclose(f);
      return -1;
    }
    size_t got = fread(out, 1, n, f);
    fclose(f);
    n = got;
  }
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->restores++;
    s->fetches++;
  }
  if (copied != nullptr) *copied = n;
  return (int64_t)size;
}

// 1 when the object's only copy is its spill file, 0 when it is in
// memory, -1 when it is absent.
int rt_ns_spilled(void* h, const uint8_t* id) {
  NodeStore* s = static_cast<NodeStore*>(h);
  Key k;
  memcpy(k.b, id, 16);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->map.find(k);
  if (it == s->map.end()) return -1;
  return it->second.spill_path.empty() ? 0 : 1;
}

int64_t rt_ns_size(void* h, const uint8_t* id) {
  NodeStore* s = static_cast<NodeStore*>(h);
  Key k;
  memcpy(k.b, id, 16);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->map.find(k);
  return it == s->map.end() ? -1 : (int64_t)it->second.size;
}

// ids: n contiguous 16-byte keys. Returns how many existed.
int rt_ns_free(void* h, const uint8_t* ids, uint32_t n) {
  NodeStore* s = static_cast<NodeStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  int freed = 0;
  for (uint32_t i = 0; i < n; i++) {
    Key k;
    memcpy(k.b, ids + 16 * i, 16);
    if (forget_locked(s, k)) freed++;
  }
  return freed;
}

int rt_ns_free_owner(void* h, const char* owner) {
  NodeStore* s = static_cast<NodeStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::vector<Key> victims;
  for (auto& kv : s->map) {
    if (kv.second.owner == owner && owner[0] != '\0')
      victims.push_back(kv.first);
  }
  for (auto& k : victims) forget_locked(s, k);
  return (int)victims.size();
}

// '\n'-joined unique owners into buf; returns the needed byte count
// (call again with a larger buffer if it exceeds buflen).
int64_t rt_ns_owners(void* h, char* buf, uint64_t buflen) {
  NodeStore* s = static_cast<NodeStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string joined;
  std::unordered_map<std::string, bool> seen;
  for (auto& kv : s->map) {
    const std::string& o = kv.second.owner;
    if (o.empty() || seen.count(o)) continue;
    seen[o] = true;
    if (!joined.empty()) joined += '\n';
    joined += o;
  }
  if (joined.size() <= buflen && buf != nullptr)
    memcpy(buf, joined.data(), joined.size());
  return (int64_t)joined.size();
}

void rt_ns_stats(void* h, uint64_t* out /* 9 slots */) {
  NodeStore* s = static_cast<NodeStore*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  uint64_t num_blobs = 0, bytes = 0, spilled = 0, spilled_bytes = 0;
  std::unordered_map<std::string, bool> owners;
  for (auto& kv : s->map) {
    const Entry& e = kv.second;
    if (!e.spill_path.empty()) {
      spilled++;
      spilled_bytes += e.size;
    } else {
      num_blobs++;
      bytes += e.data.size();
    }
    if (!e.owner.empty()) owners[e.owner] = true;
  }
  out[0] = num_blobs;
  out[1] = bytes;
  out[2] = s->fetches;
  out[3] = spilled;
  out[4] = spilled_bytes;
  out[5] = s->spills;
  out[6] = s->restores;
  out[7] = owners.size();
  out[8] = s->primary_bytes;
}

}  // extern "C"
