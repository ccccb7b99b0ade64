// plasma_store.cpp — shared-memory arena object store (plasma-lite).
//
// The port's copy of ray_tpu/_native/plasma_store.cpp, with checks a
// damaged or foreign segment cannot get past (rt_store_attach), pages
// reserved at create (posix_fallocate) and rt_store_mapped_size, which
// the Python side bounds its views with.
//
// Analogue of the reference's plasma store
// (src/ray/object_manager/plasma/store_runner.h, object_store.h,
// plasma_allocator.cc): ONE shared-memory arena mapped by every process,
// with an in-arena allocator and object table, instead of one POSIX
// segment per object (segment-per-object costs shm_open+ftruncate+mmap
// per object; the arena costs one lock round-trip per object).
//
// Layout:   [Header | ObjectEntry table | heap]
// All cross-process references are OFFSETS from the arena base (each
// process maps the arena at a different address).
//
// Concurrency: one process-shared ROBUST pthread mutex in the header.
// Robustness matters: a pool worker can be SIGKILLed while holding the
// lock; EOWNERDEAD lets the next locker recover instead of deadlocking
// (the reference store is single-process and serializes via its event
// loop; here clients mutate the arena directly, so the lock must
// survive client death).
//
// Eviction: sealed objects with refcount 0 are evictable, oldest
// lru_tick first — the same "evict only sealed, unused, LRU" policy as
// plasma's eviction_policy.cc.
//
// Built with the other two sources by ray_tpu_torch/_native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cerrno>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52415954505541ULL;  // "RAYTPUA"
constexpr uint32_t kVersion = 1;
constexpr uint64_t kAlign = 64;
constexpr int kIdSize = 16;

// Object states.
enum : int32_t {
  kEmpty = 0,       // table slot unused
  kCreated = 1,     // allocated, being written (not visible to get)
  kSealed = 2,      // immutable, visible
  kTombstone = 3,   // deleted slot (probe chains continue past it)
};

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint64_t offset;     // payload offset from arena base
  uint64_t size;       // payload size
  int32_t state;
  int32_t refcount;
  uint64_t lru_tick;
  int32_t creator_pid; // for reclaiming kCreated leaks of dead writers
  int32_t pad_;
};

// Free block header, stored inside the heap at the block's offset.
// Free list is singly linked, sorted by offset, so freeing can merge
// adjacent blocks in one pass.
struct FreeBlock {
  uint64_t size;       // block size including this header
  uint64_t next;       // offset of next free block (0 = end)
};

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t table_capacity;   // power of two
  uint64_t arena_size;
  uint64_t table_offset;
  uint64_t heap_offset;
  uint64_t heap_size;
  uint64_t free_head;        // offset of first free block (0 = none)
  uint64_t used_bytes;       // payload bytes in live objects
  uint64_t num_objects;      // created + sealed
  uint64_t lru_clock;
  uint64_t num_evictions;
  uint64_t alloc_failures;
  pthread_mutex_t lock;
};

struct Handle {
  uint8_t* base;
  uint64_t mapped_size;
  bool owner;
};

inline Header* header(Handle* h) {
  return reinterpret_cast<Header*>(h->base);
}

inline ObjectEntry* table(Handle* h) {
  return reinterpret_cast<ObjectEntry*>(h->base + header(h)->table_offset);
}

inline uint64_t align_up(uint64_t v, uint64_t a) {
  return (v + a - 1) & ~(a - 1);
}

// FNV-1a over the 16-byte id.
inline uint64_t hash_id(const uint8_t* id) {
  uint64_t x = 1469598103934665603ULL;
  for (int i = 0; i < kIdSize; i++) {
    x ^= id[i];
    x *= 1099511628211ULL;
  }
  return x;
}

void rebuild_free_list(Handle* h);

// Lock with EOWNERDEAD recovery: a client died mid-operation, so the
// free list may be torn (half-written splice). The object table is
// authoritative (entries are committed with a single state write), so
// recovery rebuilds the free list from the live entries; at worst the
// dead client's in-flight allocation leaks as a kCreated entry, which
// the dead-writer reclaim in evict_lru later frees.
int lock_arena(Handle* h) {
  Header* hd = header(h);
  int rc = pthread_mutex_lock(&hd->lock);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&hd->lock);
    rebuild_free_list(h);
    return 0;
  }
  return rc;
}

void unlock_arena(Header* hd) { pthread_mutex_unlock(&hd->lock); }

// Find the table slot for id (nullptr if absent). Caller holds lock.
ObjectEntry* find_entry(Handle* h, const uint8_t* id) {
  Header* hd = header(h);
  ObjectEntry* tab = table(h);
  uint32_t mask = hd->table_capacity - 1;
  uint32_t slot = static_cast<uint32_t>(hash_id(id)) & mask;
  for (uint32_t probe = 0; probe <= mask; probe++, slot = (slot + 1) & mask) {
    ObjectEntry* e = &tab[slot];
    if (e->state == kEmpty) return nullptr;
    if (e->state != kTombstone && memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return nullptr;
}

// Find a slot to insert id into (nullptr if table full). Caller holds lock.
ObjectEntry* insert_slot(Handle* h, const uint8_t* id) {
  Header* hd = header(h);
  ObjectEntry* tab = table(h);
  uint32_t mask = hd->table_capacity - 1;
  uint32_t slot = static_cast<uint32_t>(hash_id(id)) & mask;
  ObjectEntry* first_tomb = nullptr;
  for (uint32_t probe = 0; probe <= mask; probe++, slot = (slot + 1) & mask) {
    ObjectEntry* e = &tab[slot];
    if (e->state == kEmpty) return first_tomb ? first_tomb : e;
    if (e->state == kTombstone) {
      if (!first_tomb) first_tomb = e;
    } else if (memcmp(e->id, id, kIdSize) == 0) {
      return nullptr;  // duplicate id
    }
  }
  return first_tomb;  // table full of live entries -> nullptr
}

// First-fit allocation from the sorted free list. Caller holds lock.
// Returns payload offset, or 0 on failure.
uint64_t heap_alloc(Handle* h, uint64_t payload) {
  Header* hd = header(h);
  uint64_t need = align_up(payload < sizeof(FreeBlock) ? sizeof(FreeBlock)
                                                       : payload, kAlign);
  uint64_t prev = 0;
  uint64_t cur = hd->free_head;
  while (cur) {
    FreeBlock* b = reinterpret_cast<FreeBlock*>(h->base + cur);
    if (b->size >= need) {
      uint64_t rest = b->size - need;
      if (rest >= align_up(sizeof(FreeBlock), kAlign)) {
        // Split: tail remains free.
        uint64_t tail_off = cur + need;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(h->base + tail_off);
        tail->size = rest;
        tail->next = b->next;
        if (prev) reinterpret_cast<FreeBlock*>(h->base + prev)->next = tail_off;
        else hd->free_head = tail_off;
      } else {
        need = b->size;  // absorb the remainder
        if (prev) reinterpret_cast<FreeBlock*>(h->base + prev)->next = b->next;
        else hd->free_head = b->next;
      }
      return cur;
    }
    prev = cur;
    cur = b->next;
  }
  return 0;
}

// Free a block: insert into the offset-sorted free list and coalesce
// with adjacent free blocks. Caller holds lock.
void heap_free(Handle* h, uint64_t off, uint64_t payload) {
  Header* hd = header(h);
  uint64_t size = align_up(payload < sizeof(FreeBlock) ? sizeof(FreeBlock)
                                                       : payload, kAlign);
  uint64_t prev = 0;
  uint64_t cur = hd->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(h->base + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(h->base + off);
  blk->size = size;
  blk->next = cur;
  if (prev) reinterpret_cast<FreeBlock*>(h->base + prev)->next = off;
  else hd->free_head = off;
  // Merge with next.
  if (cur && off + blk->size == cur) {
    FreeBlock* nxt = reinterpret_cast<FreeBlock*>(h->base + cur);
    blk->size += nxt->size;
    blk->next = nxt->next;
  }
  // Merge with prev.
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(h->base + prev);
    if (prev + pb->size == off) {
      pb->size += blk->size;
      pb->next = blk->next;
    }
  }
}

// Remove an entry: tombstone it, then — if no probe chain continues
// past this slot (next slot empty) — convert it and any contiguous
// preceding tombstones back to kEmpty so lookup misses stay O(chain)
// instead of degrading to O(table) as tombstones accumulate.
void remove_entry(Handle* h, ObjectEntry* e) {
  Header* hd = header(h);
  ObjectEntry* tab = table(h);
  uint32_t mask = hd->table_capacity - 1;
  e->state = kTombstone;
  uint32_t idx = static_cast<uint32_t>(e - tab);
  if (tab[(idx + 1) & mask].state != kEmpty) return;
  uint32_t i = idx;
  do {
    if (tab[i].state != kTombstone) return;
    tab[i].state = kEmpty;
    i = (i - 1) & mask;
  } while (i != idx);
}

void evict_one(Handle* h, ObjectEntry* victim) {
  Header* hd = header(h);
  heap_free(h, victim->offset, victim->size);
  hd->used_bytes -= victim->size;
  hd->num_objects--;
  hd->num_evictions++;
  remove_entry(h, victim);
}

// Rebuild the free list from the object table (EOWNERDEAD recovery: the
// list links may be torn, but entries are committed with a single state
// store, so live offsets/sizes are trustworthy). O(n^2) selection over
// live entries — recovery-only, not a hot path.
void rebuild_free_list(Handle* h) {
  Header* hd = header(h);
  ObjectEntry* tab = table(h);
  hd->free_head = 0;
  uint64_t cursor = hd->heap_offset;
  uint64_t heap_end = hd->heap_offset + (hd->heap_size & ~(kAlign - 1));
  uint64_t tail = 0;  // last free block appended
  for (;;) {
    // Find the live block with the smallest offset >= cursor.
    ObjectEntry* next_live = nullptr;
    for (uint32_t i = 0; i < hd->table_capacity; i++) {
      ObjectEntry* e = &tab[i];
      if ((e->state == kCreated || e->state == kSealed) &&
          e->offset >= cursor &&
          (!next_live || e->offset < next_live->offset)) {
        next_live = e;
      }
    }
    uint64_t gap_end = next_live ? next_live->offset : heap_end;
    if (gap_end > cursor) {
      uint64_t off = cursor;
      FreeBlock* blk = reinterpret_cast<FreeBlock*>(h->base + off);
      blk->size = gap_end - cursor;
      blk->next = 0;
      if (tail) reinterpret_cast<FreeBlock*>(h->base + tail)->next = off;
      else hd->free_head = off;
      tail = off;
    }
    if (!next_live) return;
    uint64_t sz = next_live->size < sizeof(FreeBlock) ? sizeof(FreeBlock)
                                                      : next_live->size;
    cursor = next_live->offset + align_up(sz, kAlign);
  }
}

// Evict until at least `need` heap bytes could plausibly be satisfied.
// Policy (plasma's eviction_policy.cc, plus dead-writer reclaim):
//   1. sealed refcount-0 objects, oldest lru_tick first;
//   2. kCreated leftovers whose creator process no longer exists
//      (writer crashed between create and seal).
// Victims are gathered in batches of up to 64 per O(table) scan so a
// large reclaim is O(table * ceil(victims/64)), not O(table * victims),
// all under the arena lock. Caller holds lock. Returns true if
// anything was evicted.
bool evict_lru(Handle* h, uint64_t need) {
  Header* hd = header(h);
  ObjectEntry* tab = table(h);
  bool any = false;
  constexpr int kBatch = 64;
  for (;;) {
    // Gather up to kBatch oldest evictable entries in one scan
    // (insertion sort into a small local buffer, newest-evicted-last).
    ObjectEntry* batch[kBatch];
    int n = 0;
    for (uint32_t i = 0; i < hd->table_capacity; i++) {
      ObjectEntry* e = &tab[i];
      bool evictable =
          (e->state == kSealed && e->refcount == 0) ||
          (e->state == kCreated && e->creator_pid > 0 &&
           kill(e->creator_pid, 0) != 0 && errno == ESRCH);
      if (!evictable) continue;
      int j = n < kBatch ? n : kBatch - 1;
      if (j == kBatch - 1 && n == kBatch &&
          e->lru_tick >= batch[j]->lru_tick) {
        continue;  // older than everything buffered
      }
      while (j > 0 && batch[j - 1]->lru_tick > e->lru_tick) {
        batch[j] = batch[j - 1];
        j--;
      }
      batch[j] = e;
      if (n < kBatch) n++;
    }
    if (n == 0) return any;
    for (int i = 0; i < n; i++) {
      evict_one(h, batch[i]);
      any = true;
      uint64_t probe = heap_alloc(h, need);
      if (probe) {
        heap_free(h, probe, need);
        return true;
      }
    }
  }
}

}  // namespace

extern "C" {

// Create + initialize an arena. Returns handle or nullptr.
void* rt_store_create(const char* name, uint64_t arena_size,
                      uint32_t table_capacity) {
  // Round table capacity up to a power of two.
  uint32_t cap = 64;
  while (cap < table_capacity) cap <<= 1;

  shm_unlink(name);  // stale arena from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  // Reserve every page now: on a full /dev/shm the create fails here,
  // instead of a later write into a page tmpfs cannot back raising
  // SIGBUS in whichever process touches it first.
  if (ftruncate(fd, static_cast<off_t>(arena_size)) != 0 ||
      posix_fallocate(fd, 0, static_cast<off_t>(arena_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, arena_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }

  Header* hd = reinterpret_cast<Header*>(base);
  memset(hd, 0, sizeof(Header));
  hd->magic = kMagic;
  hd->version = kVersion;
  hd->table_capacity = cap;
  hd->arena_size = arena_size;
  hd->table_offset = align_up(sizeof(Header), kAlign);
  uint64_t table_bytes = align_up(cap * sizeof(ObjectEntry), kAlign);
  hd->heap_offset = hd->table_offset + table_bytes;
  if (hd->heap_offset + kAlign >= arena_size) {
    munmap(base, arena_size);
    shm_unlink(name);
    return nullptr;
  }
  hd->heap_size = arena_size - hd->heap_offset;
  memset(reinterpret_cast<uint8_t*>(base) + hd->table_offset, 0, table_bytes);

  // Heap starts as one big free block.
  FreeBlock* first = reinterpret_cast<FreeBlock*>(
      reinterpret_cast<uint8_t*>(base) + hd->heap_offset);
  first->size = hd->heap_size & ~(kAlign - 1);
  first->next = 0;
  hd->free_head = hd->heap_offset;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hd->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  Handle* h = new Handle{reinterpret_cast<uint8_t*>(base), arena_size, true};
  return h;
}

// Attach to an existing arena. Returns handle or nullptr.
void* rt_store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      static_cast<uint64_t>(st.st_size) < sizeof(Header) + kAlign) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* hd = reinterpret_cast<Header*>(base);
  // Every offset the table and the heap use must lie in the mapping: a
  // segment of this name that is not an arena (or is torn) is refused,
  // never read past its end.
  uint64_t mapped = static_cast<uint64_t>(st.st_size);
  uint32_t cap = hd->table_capacity;
  if (hd->magic != kMagic || hd->version != kVersion ||
      hd->arena_size != mapped || cap == 0 || (cap & (cap - 1)) != 0 ||
      hd->table_offset < sizeof(Header) ||
      hd->table_offset + static_cast<uint64_t>(cap) * sizeof(ObjectEntry) >
          hd->heap_offset ||
      hd->heap_offset + hd->heap_size != mapped) {
    munmap(base, st.st_size);
    return nullptr;
  }
  Handle* h = new Handle{reinterpret_cast<uint8_t*>(base),
                         static_cast<uint64_t>(st.st_size), false};
  return h;
}

void rt_store_detach(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(h->base, h->mapped_size);
  delete h;
}

int rt_store_destroy(void* hv, const char* name) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(h->base, h->mapped_size);
  delete h;
  return shm_unlink(name);
}

uint8_t* rt_store_base(void* hv) {
  return static_cast<Handle*>(hv)->base;
}

// Bytes mapped at rt_store_base: every view is bounded by it.
uint64_t rt_store_mapped_size(void* hv) {
  return static_cast<Handle*>(hv)->mapped_size;
}

// Allocate an object. Returns payload offset, 0 on failure (full).
uint64_t rt_store_create_object(void* hv, const uint8_t* id, uint64_t size) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return 0;
  ObjectEntry* e = insert_slot(h, id);
  if (!e) {
    // insert_slot fails for BOTH a full table and a duplicate id; a
    // duplicate must fail cleanly (never evict the live same-id object
    // or unrelated entries). Only a genuinely full table earns an
    // eviction pass: tombstoned entries free slots, then retry.
    if (find_entry(h, id) != nullptr || !evict_lru(h, size) ||
        !(e = insert_slot(h, id))) {
      hd->alloc_failures++;
      unlock_arena(hd);
      return 0;
    }
  }
  uint64_t off = heap_alloc(h, size);
  if (!off) {
    if (evict_lru(h, size)) off = heap_alloc(h, size);
    if (!off) {
      hd->alloc_failures++;
      unlock_arena(hd);
      return 0;
    }
    // Eviction turned slots into tombstones; our insert slot may have
    // been re-usable anyway, but re-find to be safe.
    e = insert_slot(h, id);
    if (!e) {
      heap_free(h, off, size);
      hd->alloc_failures++;
      unlock_arena(hd);
      return 0;
    }
  }
  memcpy(e->id, id, kIdSize);
  e->offset = off;
  e->size = size;
  e->state = kCreated;
  e->refcount = 0;
  e->lru_tick = ++hd->lru_clock;
  e->creator_pid = static_cast<int32_t>(getpid());
  hd->used_bytes += size;
  hd->num_objects++;
  unlock_arena(hd);
  return off;
}

// Seal: make the object visible to get(). Returns 0 ok, -1 not found.
int rt_store_seal(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return -1;
  ObjectEntry* e = find_entry(h, id);
  if (!e || e->state != kCreated) {
    unlock_arena(hd);
    return -1;
  }
  e->state = kSealed;
  e->lru_tick = ++hd->lru_clock;
  unlock_arena(hd);
  return 0;
}

// Seal + take a reference in one critical section: the object is never
// observable in the sealed-refcount-0 (evictable) state, so ownership
// hands off to the eventual releaser with no eviction race.
int rt_store_seal_pinned(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return -1;
  ObjectEntry* e = find_entry(h, id);
  if (!e || e->state != kCreated) {
    unlock_arena(hd);
    return -1;
  }
  e->state = kSealed;
  e->refcount = 1;
  e->lru_tick = ++hd->lru_clock;
  unlock_arena(hd);
  return 0;
}

// Get: addref + return payload offset (0 if absent/unsealed); size via out.
uint64_t rt_store_get(void* hv, const uint8_t* id, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return 0;
  ObjectEntry* e = find_entry(h, id);
  if (!e || e->state != kSealed) {
    unlock_arena(hd);
    return 0;
  }
  e->refcount++;
  e->lru_tick = ++hd->lru_clock;
  if (size_out) *size_out = e->size;
  uint64_t off = e->offset;
  unlock_arena(hd);
  return off;
}

// Peek: payload offset + size WITHOUT taking a reference (0 if
// absent/unsealed). For same-host peers mapping another process's
// arena: the peer stays read-only (never mutates refcounts in someone
// else's arena — a crashed peer then cannot leak pins); the OWNER pins
// on the peer's behalf for the lease's life (rt_store_get/release via
// the lease table), which is what keeps the peeked offset valid.
uint64_t rt_store_peek(void* hv, const uint8_t* id, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return 0;
  ObjectEntry* e = find_entry(h, id);
  if (!e || e->state != kSealed) {
    unlock_arena(hd);
    return 0;
  }
  if (size_out) *size_out = e->size;
  uint64_t off = e->offset;
  unlock_arena(hd);
  return off;
}

// Release a get() reference. Returns 0 ok, -1 not found.
int rt_store_release(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return -1;
  ObjectEntry* e = find_entry(h, id);
  if (!e || e->refcount <= 0) {
    unlock_arena(hd);
    return -1;
  }
  e->refcount--;
  unlock_arena(hd);
  return 0;
}

// Delete: free immediately if refcount 0, else mark for eviction (the
// entry stays until refs drain; evict_lru skips refcount>0). Returns 0.
int rt_store_delete(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return -1;
  ObjectEntry* e = find_entry(h, id);
  if (!e) {
    unlock_arena(hd);
    return -1;
  }
  if (e->refcount <= 0) {
    heap_free(h, e->offset, e->size);
    hd->used_bytes -= e->size;
    hd->num_objects--;
    remove_entry(h, e);
  } else {
    // Sealed-with-refs: make it eviction-eligible the moment refs
    // drain by aging it to the oldest possible tick.
    e->lru_tick = 0;
  }
  unlock_arena(hd);
  return 0;
}

int rt_store_contains(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return 0;
  ObjectEntry* e = find_entry(h, id);
  int ok = (e && e->state == kSealed) ? 1 : 0;
  unlock_arena(hd);
  return ok;
}

void rt_store_stats(void* hv, uint64_t* used, uint64_t* capacity,
                    uint64_t* num_objects, uint64_t* evictions,
                    uint64_t* alloc_failures) {
  Handle* h = static_cast<Handle*>(hv);
  Header* hd = header(h);
  if (lock_arena(h) != 0) return;
  if (used) *used = hd->used_bytes;
  if (capacity) *capacity = hd->heap_size;
  if (num_objects) *num_objects = hd->num_objects;
  if (evictions) *evictions = hd->num_evictions;
  if (alloc_failures) *alloc_failures = hd->alloc_failures;
  unlock_arena(hd);
}

}  // extern "C"
