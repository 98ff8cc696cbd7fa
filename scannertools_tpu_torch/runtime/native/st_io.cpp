// Native IO runtime: mmap'd packed-container reader + decode staging ring.
//
// Reference parity: the C++ storage layer (packed_file_source.cpp:88-133
// random reads over the u64-header container; files_source.cpp block-buffer
// reads) and the engine's block-buffer allocator (scanner/util/memory.h).
// TPU-native role: the host data plane. The packed reader serves named-
// stream/PackedFile elements zero-copy out of the page cache; the ring
// buffer provides fixed-slot staging for decoded frame chunks so the
// prefetch thread and the device-feed thread exchange buffers without
// per-chunk allocation.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------- packed reader

struct StPacked {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t mapped = 0;
  uint64_t count = 0;
  const uint64_t* sizes = nullptr;  // points into the mapping
  uint64_t* offsets = nullptr;      // heap: absolute payload offsets
};

void* st_packed_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(uint64_t)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* h = new StPacked();
  h->fd = fd;
  h->base = static_cast<uint8_t*>(base);
  h->mapped = st.st_size;
  std::memcpy(&h->count, h->base, sizeof(uint64_t));
  if (h->mapped < sizeof(uint64_t) * (1 + h->count)) {
    munmap(base, st.st_size);
    ::close(fd);
    delete h;
    return nullptr;
  }
  h->sizes = reinterpret_cast<const uint64_t*>(h->base + sizeof(uint64_t));
  h->offsets = static_cast<uint64_t*>(
      std::malloc(sizeof(uint64_t) * (h->count ? h->count : 1)));
  uint64_t off = sizeof(uint64_t) * (1 + h->count);
  for (uint64_t i = 0; i < h->count; ++i) {
    h->offsets[i] = off;
    off += h->sizes[i];
  }
  return h;
}

uint64_t st_packed_count(void* p) {
  return static_cast<StPacked*>(p)->count;
}

uint64_t st_packed_size(void* p, uint64_t i) {
  auto* h = static_cast<StPacked*>(p);
  return i < h->count ? h->sizes[i] : 0;
}

// Zero-copy pointer into the mapping (valid until close).
const void* st_packed_ptr(void* p, uint64_t i) {
  auto* h = static_cast<StPacked*>(p);
  if (i >= h->count) return nullptr;
  return h->base + h->offsets[i];
}

void st_packed_read(void* p, uint64_t i, void* dst) {
  auto* h = static_cast<StPacked*>(p);
  if (i >= h->count) return;
  std::memcpy(dst, h->base + h->offsets[i], h->sizes[i]);
}

void st_packed_close(void* p) {
  auto* h = static_cast<StPacked*>(p);
  if (h->base) munmap(h->base, h->mapped);
  if (h->fd >= 0) ::close(h->fd);
  std::free(h->offsets);
  delete h;
}

// ------------------------------------------------------------ ring buffer

struct StRing {
  uint8_t* storage = nullptr;
  size_t slot_bytes = 0;
  int nslots = 0;
  std::atomic<uint64_t> head{0};  // next slot to produce into
  std::atomic<uint64_t> tail{0};  // next slot to consume
};

void* st_ring_create(size_t slot_bytes, int nslots) {
  auto* r = new StRing();
  r->slot_bytes = slot_bytes;
  r->nslots = nslots;
  // page-aligned slots: friendly to DMA engines and madvise
  if (posix_memalign(reinterpret_cast<void**>(&r->storage), 4096,
                     slot_bytes * nslots) != 0) {
    delete r;
    return nullptr;
  }
  return r;
}

// Producer: pointer to the next free slot, or null when full (non-blocking;
// caller decides to spin/sleep — GIL is released during the wait in python).
void* st_ring_acquire(void* p) {
  auto* r = static_cast<StRing*>(p);
  uint64_t h = r->head.load(std::memory_order_relaxed);
  if (h - r->tail.load(std::memory_order_acquire) >=
      static_cast<uint64_t>(r->nslots)) {
    return nullptr;
  }
  return r->storage + (h % r->nslots) * r->slot_bytes;
}

void st_ring_commit(void* p) {
  auto* r = static_cast<StRing*>(p);
  r->head.fetch_add(1, std::memory_order_release);
}

// Consumer: pointer to the oldest committed slot, or null when empty.
const void* st_ring_front(void* p) {
  auto* r = static_cast<StRing*>(p);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  if (t >= r->head.load(std::memory_order_acquire)) return nullptr;
  return r->storage + (t % r->nslots) * r->slot_bytes;
}

void st_ring_release(void* p) {
  auto* r = static_cast<StRing*>(p);
  r->tail.fetch_add(1, std::memory_order_release);
}

int st_ring_size(void* p) {
  auto* r = static_cast<StRing*>(p);
  return static_cast<int>(r->head.load() - r->tail.load());
}

void st_ring_destroy(void* p) {
  auto* r = static_cast<StRing*>(p);
  std::free(r->storage);
  delete r;
}

}  // extern "C"
