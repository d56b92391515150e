// Shared-memory arena object store — the native tier of the object plane.
//
// TPU-native equivalent of the reference's plasma store
// (src/ray/object_manager/plasma/: PlasmaStore store.h:55, dlmalloc mmap
// arenas, ObjectLifecycleManager). Design differences, deliberate:
//   * One mmap'd POSIX shm segment per session (sparse; pages commit on
//     write) instead of a store *process* — on a TPU host every client is
//     local, so the index + allocator live inside the segment guarded by a
//     process-shared mutex, and there is no socket protocol at all:
//     create/seal/get are direct memory ops (~100ns), vs the reference's
//     UDS round-trip per call.
//   * Allocation: first-fit free list with split + coalesce-on-free.
//     64-byte aligned blocks so numpy/jax see aligned buffers
//     (jax.device_put zero-copy path needs alignment).
//   * Object index: open-addressed hash table keyed by 20-byte object ids
//     (TaskID + return index, mirroring the reference's lineage-embedded
//     ids, src/ray/common/id.h).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'53544f52ULL;  // "RTPUSTOR"
constexpr uint32_t kKeyLen = 20;
constexpr uint32_t kAlign = 64;
constexpr uint32_t kIndexSlots = 1 << 16;  // 65536 objects max per session

struct Slot {
  uint8_t key[kKeyLen];
  uint8_t state;  // 0 empty, 1 pending, 2 sealed, 3 tombstone, 4 doomed
  uint8_t pad[3];
  uint32_t pins;  // live zero-copy readers (plasma's client-pin rule:
                  // a mapped block is never recycled under a reader)
  uint64_t offset;
  uint64_t size;
};

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // offset of next free block, 0 = none
};

struct Header {
  uint64_t magic;
  uint64_t capacity;
  uint64_t heap_start;
  uint64_t free_head;      // offset of first free block
  uint64_t bytes_in_use;
  uint64_t num_objects;
  uint64_t prefault_cursor;  // background page-prefault progress
  pthread_mutex_t mutex;
  Slot slots[kIndexSlots];
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t capacity;
  Header* hdr;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~uint64_t(kAlign - 1); }

inline uint64_t hash_key(const uint8_t* key) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kKeyLen; ++i) {
    h ^= key[i];
    h *= 1099511628211ULL;
  }
  return h;
}

Slot* find_slot(Header* hdr, const uint8_t* key, bool for_insert) {
  uint64_t idx = hash_key(key) & (kIndexSlots - 1);
  Slot* first_tomb = nullptr;
  for (uint32_t probe = 0; probe < kIndexSlots; ++probe) {
    Slot* s = &hdr->slots[(idx + probe) & (kIndexSlots - 1)];
    if (s->state == 0) {
      if (for_insert) return first_tomb ? first_tomb : s;
      return nullptr;
    }
    if (s->state == 3) {
      if (for_insert && !first_tomb) first_tomb = s;
      continue;
    }
    if (memcmp(s->key, key, kKeyLen) == 0) return s;
  }
  return first_tomb;
}

// Allocate from the free list (first fit, split remainder). Caller holds
// the mutex. Returns 0 on failure.
uint64_t arena_alloc(Handle* h, uint64_t size) {
  Header* hdr = h->hdr;
  size = align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
  uint64_t prev_off = 0;
  uint64_t cur = hdr->free_head;
  while (cur) {
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(h->base + cur);
    if (fb->size >= size) {
      uint64_t remain = fb->size - size;
      if (remain >= align_up(sizeof(FreeBlock)) + kAlign) {
        // Split: tail remains free.
        uint64_t tail_off = cur + size;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(h->base + tail_off);
        tail->size = remain;
        tail->next = fb->next;
        if (prev_off) {
          reinterpret_cast<FreeBlock*>(h->base + prev_off)->next = tail_off;
        } else {
          hdr->free_head = tail_off;
        }
      } else {
        size = fb->size;  // take the whole block
        if (prev_off) {
          reinterpret_cast<FreeBlock*>(h->base + prev_off)->next = fb->next;
        } else {
          hdr->free_head = fb->next;
        }
      }
      hdr->bytes_in_use += size;
      return cur;
    }
    prev_off = cur;
    cur = fb->next;
  }
  return 0;
}

// Insert a block into the address-ordered free list and coalesce with
// neighbors. Caller holds the mutex.
void arena_free(Handle* h, uint64_t off, uint64_t size) {
  Header* hdr = h->hdr;
  size = align_up(size < sizeof(FreeBlock) ? sizeof(FreeBlock) : size);
  hdr->bytes_in_use -= size;
  uint64_t prev = 0, cur = hdr->free_head;
  while (cur && cur < off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(h->base + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(h->base + off);
  blk->size = size;
  blk->next = cur;
  if (prev) {
    reinterpret_cast<FreeBlock*>(h->base + prev)->next = off;
  } else {
    hdr->free_head = off;
  }
  // Coalesce with next.
  if (cur && off + blk->size == cur) {
    FreeBlock* nxt = reinterpret_cast<FreeBlock*>(h->base + cur);
    blk->size += nxt->size;
    blk->next = nxt->next;
  }
  // Coalesce with prev.
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(h->base + prev);
    if (prev + pb->size == off) {
      pb->size += blk->size;
      pb->next = blk->next;
    }
  }
}

}  // namespace

extern "C" {

// Open (and optionally create) the session arena. Returns nullptr on error.
void* rtpt_store_open(const char* name, uint64_t capacity, int create) {
  int flags = create ? (O_RDWR | O_CREAT) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(Header) + capacity;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  bool fresh = (st.st_size == 0);
  if (fresh) {
    if (!create || ftruncate(fd, (off_t)total) != 0) { close(fd); return nullptr; }
  } else {
    total = (uint64_t)st.st_size;
  }
  uint8_t* base = static_cast<uint8_t*>(
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Header* hdr = reinterpret_cast<Header*>(base);
  if (fresh) {
    memset(hdr, 0, sizeof(Header));
    hdr->capacity = total - sizeof(Header);
    hdr->heap_start = align_up(sizeof(Header));
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &attr);
    // One big free block spanning the heap.
    uint64_t first = hdr->heap_start;
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(base + first);
    fb->size = total - first;
    fb->next = 0;
    hdr->free_head = first;
    std::atomic_thread_fence(std::memory_order_release);
    hdr->magic = kMagic;
  } else {
    // Wait for the creator to finish initializing.
    for (int i = 0; i < 100000 && hdr->magic != kMagic; ++i) usleep(10);
    if (hdr->magic != kMagic) { munmap(base, total); close(fd); return nullptr; }
  }
  Handle* h = new Handle{fd, base, total, hdr};
  return h;
}

static int lock(Header* hdr) {
  int rc = pthread_mutex_lock(&hdr->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&hdr->mutex);
    rc = 0;
  }
  return rc;
}

// Create a pending object; returns byte offset from base, or 0 on failure.
uint64_t rtpt_store_create(void* handle, const uint8_t* key, uint64_t size) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return 0;
  Slot* s = find_slot(h->hdr, key, /*for_insert=*/true);
  uint64_t off = 0;
  if (s != nullptr && s->state != 1 && s->state != 2) {
    // Recreating over a doomed slot (deleted while readers were pinned)
    // orphans the old block until process teardown — acceptable: the
    // alternative is refusing recreation, which would wedge lineage
    // reconstruction behind arbitrary reader lifetimes.
    off = arena_alloc(h, size);
    if (off) {
      memcpy(s->key, key, kKeyLen);
      s->state = 1;
      s->pins = 0;
      s->offset = off;
      s->size = size;
      h->hdr->num_objects++;
    }
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return off;
}

int rtpt_store_seal(void* handle, const uint8_t* key) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return -1;
  Slot* s = find_slot(h->hdr, key, false);
  int rc = -1;
  if (s && s->state == 1) {
    s->state = 2;
    rc = 0;
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return rc;
}

// Look up a sealed object. Returns 0 and fills offset/size, else -1.
int rtpt_store_lookup(void* handle, const uint8_t* key, uint64_t* offset,
                      uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return -1;
  Slot* s = find_slot(h->hdr, key, false);
  int rc = -1;
  if (s && s->state == 2) {
    *offset = s->offset;
    *size = s->size;
    rc = 0;
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return rc;
}

// Look up AND pin a sealed object for zero-copy reading. The block will
// not be recycled until the matching release, even if deleted meanwhile.
int rtpt_store_acquire(void* handle, const uint8_t* key, uint64_t* offset,
                       uint64_t* size) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return -1;
  Slot* s = find_slot(h->hdr, key, false);
  int rc = -1;
  if (s && s->state == 2) {
    *offset = s->offset;
    *size = s->size;
    s->pins++;
    rc = 0;
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return rc;
}

// Drop a pin. Frees the block if the object was deleted while pinned.
int rtpt_store_release(void* handle, const uint8_t* key) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return -1;
  Slot* s = find_slot(h->hdr, key, false);
  int rc = -1;
  if (s && (s->state == 2 || s->state == 4) && s->pins > 0) {
    s->pins--;
    if (s->state == 4 && s->pins == 0) {
      arena_free(h, s->offset, s->size);
      s->state = 3;
    }
    rc = 0;
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return rc;
}

int rtpt_store_delete(void* handle, const uint8_t* key) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return -1;
  Slot* s = find_slot(h->hdr, key, false);
  int rc = -1;
  if (s && (s->state == 1 || s->state == 2)) {
    if (s->state == 2 && s->pins > 0) {
      s->state = 4;  // doomed: freed when the last reader releases
    } else {
      arena_free(h, s->offset, s->size);
      s->state = 3;  // tombstone keeps probe chains intact
    }
    h->hdr->num_objects--;
    rc = 0;
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return rc;
}

// Prefault one window of free space: tmpfs pages are allocated on first
// write (zero-fill major fault, ~1.4 GB/s); touching them once up front
// makes later object writes take minor faults (~10 GB/s). Walks the free
// list under the lock and memsets only free bytes inside the window
// (skipping FreeBlock headers), so concurrent objects are never touched.
// Returns 1 while more of the arena remains, 0 when done.
int rtpt_store_prefault_step(void* handle, uint64_t window) {
  Handle* h = static_cast<Handle*>(handle);
  Header* hdr = h->hdr;
  if (lock(hdr) != 0) return 0;
  uint64_t start = hdr->prefault_cursor;
  if (start < hdr->heap_start) start = hdr->heap_start;
  if (start >= h->capacity) {
    pthread_mutex_unlock(&hdr->mutex);
    return 0;
  }
  uint64_t end = start + window;
  if (end > h->capacity) end = h->capacity;
  for (uint64_t cur = hdr->free_head; cur;) {
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(h->base + cur);
    uint64_t lo = cur + sizeof(FreeBlock);
    uint64_t hi = cur + fb->size;
    if (lo < start) lo = start;
    if (hi > end) hi = end;
    if (lo < hi) memset(h->base + lo, 0, hi - lo);
    if (cur + fb->size >= end) break;
    cur = fb->next;
  }
  hdr->prefault_cursor = end;
  pthread_mutex_unlock(&hdr->mutex);
  return end < h->capacity ? 1 : 0;
}

// Enumerate sealed objects: fills keys_out (kKeyLen bytes each) and
// sizes_out up to max entries; returns the number written. Used by a
// restarted GCS to rebuild its object directory from the surviving arena
// (the reference instead replays object locations from raylet resync;
// here the arena IS the per-host object state and outlives the GCS).
uint64_t rtpt_store_list(void* handle, uint8_t* keys_out,
                         uint64_t* sizes_out, uint64_t max) {
  Handle* h = static_cast<Handle*>(handle);
  if (lock(h->hdr) != 0) return 0;
  uint64_t n = 0;
  for (uint32_t i = 0; i < kIndexSlots && n < max; ++i) {
    Slot* s = &h->hdr->slots[i];
    if (s->state == 2) {
      memcpy(keys_out + n * kKeyLen, s->key, kKeyLen);
      sizes_out[n] = s->size;
      ++n;
    }
  }
  pthread_mutex_unlock(&h->hdr->mutex);
  return n;
}

void rtpt_store_stats(void* handle, uint64_t* used, uint64_t* capacity,
                      uint64_t* num_objects) {
  Handle* h = static_cast<Handle*>(handle);
  lock(h->hdr);
  *used = h->hdr->bytes_in_use;
  *capacity = h->hdr->capacity;
  *num_objects = h->hdr->num_objects;
  pthread_mutex_unlock(&h->hdr->mutex);
}

// Populated watermark: bytes from arena start whose tmpfs pages are
// known-committed (the head's populate sweep advances it). Clients skip
// their create-time MADV_POPULATE_WRITE inside the watermark — faulting
// during the copy is cheaper than re-walking present pages.
void rtpt_store_set_populated(void* handle, uint64_t bytes) {
  Header* hdr = static_cast<Handle*>(handle)->hdr;
  if (lock(hdr) == 0) {
    if (bytes > hdr->prefault_cursor) hdr->prefault_cursor = bytes;
    pthread_mutex_unlock(&hdr->mutex);
  }
}

uint64_t rtpt_store_get_populated(void* handle) {
  return static_cast<Handle*>(handle)->hdr->prefault_cursor;
}

uint8_t* rtpt_store_base(void* handle) {
  return static_cast<Handle*>(handle)->base;
}

uint64_t rtpt_store_total_size(void* handle) {
  return static_cast<Handle*>(handle)->capacity;
}

void rtpt_store_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  munmap(h->base, h->capacity);
  close(h->fd);
  delete h;
}

int rtpt_store_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
