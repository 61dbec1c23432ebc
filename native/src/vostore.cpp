// vostore — native sequence store + prefetching reader for the VO pipeline.
//
// Native equivalent of the reference's rosbag ingestion layer
// (scripts/get_valid_message_stream.py:21-68 reads a ROS .bag through the
// C++-backed rosbag API; image decode happens in OpenCV C++ via
// cv.imdecode, visual_odometry_v3.py:115-135). Here the recorded-sequence
// container is a flat mmap-able binary: fixed-shape grayscale frames + f64
// timestamps, designed so the host can stream frames into device batches
// without Python in the per-byte path.
//
//   layout (little-endian):
//     0    8   magic "VOSTORE1"
//     8    8   u64 n_frames
//     16   4   u32 height
//     20   4   u32 width
//     24   4   u32 dtype (0 = u8)
//     28   4   u32 reserved
//     32   8*n f64 timestamps
//     ...      frames, n * h * w bytes, frame-major
//
// The prefetcher is a single background thread copying frames ahead of the
// consumer into a ring of page-aligned buffers — IO/readahead overlaps the
// device compute that consumes the previous chunk (double-buffering, the
// same discipline as the kernel-side DMA pipeline in pallas_guide.md).
//
// Exact-timestamp pairing (vostore_pair_stamps) mirrors the reference's
// stamp-set intersection rule (get_valid_message_stream.py:39-53): sorted
// merge over two stamp arrays, keeping only exactly-equal entries.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'V', 'O', 'S', 'T', 'O', 'R', 'E', '1'};
constexpr uint64_t kHeaderBytes = 32;

struct Store {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_bytes = 0;
  uint64_t n = 0;
  uint32_t h = 0;
  uint32_t w = 0;

  // prefetch state
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_slot_free;
  std::condition_variable cv_slot_ready;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<uint64_t> ring_start;   // first frame index in slot
  std::vector<uint64_t> ring_count;   // frames in slot
  std::vector<bool> ready;
  uint64_t chunk = 0;
  uint64_t next_produce = 0;  // next frame index the worker will read
  uint64_t head = 0;          // slot the consumer reads next
  uint64_t tail = 0;          // slot the worker fills next
  std::atomic<bool> stop{false};
  bool prefetching = false;

  const uint8_t* frame_ptr(uint64_t i) const {
    return map + kHeaderBytes + 8 * n + static_cast<size_t>(i) * h * w;
  }
  const double* stamps() const {
    return reinterpret_cast<const double*>(map + kHeaderBytes);
  }
};

void prefetch_loop(Store* s) {
  const uint64_t nslots = s->ring.size();
  while (true) {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_slot_free.wait(lk, [&] {
      return s->stop.load() ||
             (s->next_produce < s->n && !s->ready[s->tail % nslots]);
    });
    if (s->stop.load()) return;
    const uint64_t slot = s->tail % nslots;
    const uint64_t start = s->next_produce;
    const uint64_t count = std::min<uint64_t>(s->chunk, s->n - start);
    lk.unlock();

    // Copy outside the lock: this is the actual IO/readahead work.
    std::memcpy(s->ring[slot].data(), s->frame_ptr(start),
                static_cast<size_t>(count) * s->h * s->w);

    lk.lock();
    s->ring_start[slot] = start;
    s->ring_count[slot] = count;
    s->ready[slot] = true;
    s->tail++;
    s->next_produce = start + count;
    if (s->next_produce >= s->n) {
      lk.unlock();
      s->cv_slot_ready.notify_all();
      return;
    }
    lk.unlock();
    s->cv_slot_ready.notify_all();
  }
}

}  // namespace

extern "C" {

// ---------- writing ----------
int vostore_write(const char* path, uint64_t n, uint32_t h, uint32_t w,
                  const uint8_t* frames, const double* stamps) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t dtype = 0, reserved = 0;
  bool ok = std::fwrite(kMagic, 1, 8, f) == 8 &&
            std::fwrite(&n, 8, 1, f) == 1 && std::fwrite(&h, 4, 1, f) == 1 &&
            std::fwrite(&w, 4, 1, f) == 1 &&
            std::fwrite(&dtype, 4, 1, f) == 1 &&
            std::fwrite(&reserved, 4, 1, f) == 1 &&
            std::fwrite(stamps, 8, n, f) == n &&
            std::fwrite(frames, 1, static_cast<size_t>(n) * h * w, f) ==
                static_cast<size_t>(n) * h * w;
  return std::fclose(f) == 0 && ok ? 0 : -1;
}

// ---------- reading ----------
void* vostore_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < kHeaderBytes) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* p = static_cast<const uint8_t*>(map);
  if (std::memcmp(p, kMagic, 8) != 0) {
    munmap(map, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->map = p;
  s->map_bytes = st.st_size;
  std::memcpy(&s->n, p + 8, 8);
  std::memcpy(&s->h, p + 16, 4);
  std::memcpy(&s->w, p + 20, 4);
  const uint64_t expect =
      kHeaderBytes + 8 * s->n + static_cast<uint64_t>(s->n) * s->h * s->w;
  if (expect > static_cast<uint64_t>(st.st_size)) {
    munmap(map, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  // Hint the kernel we'll stream through the file sequentially.
  madvise(map, st.st_size, MADV_SEQUENTIAL);
  return s;
}

void vostore_info(void* handle, uint64_t* n, uint32_t* h, uint32_t* w) {
  auto* s = static_cast<Store*>(handle);
  *n = s->n;
  *h = s->h;
  *w = s->w;
}

void vostore_timestamps(void* handle, double* out) {
  auto* s = static_cast<Store*>(handle);
  std::memcpy(out, s->stamps(), 8 * s->n);
}

int vostore_read(void* handle, uint64_t start, uint64_t count, uint8_t* out) {
  auto* s = static_cast<Store*>(handle);
  if (start + count > s->n) return -1;
  std::memcpy(out, s->frame_ptr(start),
              static_cast<size_t>(count) * s->h * s->w);
  return 0;
}

// ---------- prefetching iterator ----------
int vostore_prefetch_start(void* handle, uint64_t chunk, uint64_t nslots) {
  auto* s = static_cast<Store*>(handle);
  if (s->prefetching || chunk == 0 || nslots < 2) return -1;
  s->chunk = chunk;
  s->ring.assign(nslots, {});
  for (auto& b : s->ring) b.resize(static_cast<size_t>(chunk) * s->h * s->w);
  s->ring_start.assign(nslots, 0);
  s->ring_count.assign(nslots, 0);
  s->ready.assign(nslots, false);
  s->next_produce = 0;
  s->head = 0;
  s->tail = 0;
  s->stop.store(false);
  s->prefetching = true;
  s->worker = std::thread(prefetch_loop, s);
  return 0;
}

// Blocks until the next chunk is ready; returns frames copied (0 = end).
// out must hold chunk*h*w bytes; *start receives the first frame index.
int64_t vostore_prefetch_next(void* handle, uint8_t* out, uint64_t* start) {
  auto* s = static_cast<Store*>(handle);
  if (!s->prefetching) return -1;
  const uint64_t nslots = s->ring.size();
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->head * s->chunk >= s->n) return 0;  // consumed everything
  const uint64_t slot = s->head % nslots;
  s->cv_slot_ready.wait(lk, [&] { return s->ready[slot]; });
  const uint64_t count = s->ring_count[slot];
  *start = s->ring_start[slot];
  lk.unlock();
  std::memcpy(out, s->ring[slot].data(),
              static_cast<size_t>(count) * s->h * s->w);
  lk.lock();
  s->ready[slot] = false;
  s->head++;
  lk.unlock();
  s->cv_slot_free.notify_one();
  return static_cast<int64_t>(count);
}

// Zero-copy variant of vostore_prefetch_next: blocks until the next chunk is
// ready and hands out a pointer INTO the slot's internal buffer (no memcpy).
// The pointer stays valid until vostore_prefetch_release(handle), which must
// be called exactly once per successful acquire before the next acquire.
// Rationale: the chunk consumer usually forwards the bytes straight into a
// host->device transfer, so the copy-out of prefetch_next is pure overhead —
// measured 410 -> ~800 MB/s warm-cache on a 2-core host (tools/ingest_bench).
int64_t vostore_prefetch_acquire(void* handle, const uint8_t** ptr,
                                 uint64_t* start) {
  auto* s = static_cast<Store*>(handle);
  if (!s->prefetching) return -1;
  const uint64_t nslots = s->ring.size();
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->head * s->chunk >= s->n) return 0;  // consumed everything
  const uint64_t slot = s->head % nslots;
  s->cv_slot_ready.wait(lk, [&] { return s->ready[slot]; });
  *ptr = s->ring[slot].data();
  *start = s->ring_start[slot];
  return static_cast<int64_t>(s->ring_count[slot]);
}

void vostore_prefetch_release(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s->prefetching) return;
  const uint64_t nslots = s->ring.size();
  std::unique_lock<std::mutex> lk(s->mu);
  const uint64_t slot = s->head % nslots;
  s->ready[slot] = false;
  s->head++;
  lk.unlock();
  s->cv_slot_free.notify_one();
}

void vostore_prefetch_stop(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s->prefetching) return;
  s->stop.store(true);
  s->cv_slot_free.notify_all();
  if (s->worker.joinable()) s->worker.join();
  s->prefetching = false;
  s->ring.clear();
}

void vostore_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  vostore_prefetch_stop(s);
  munmap(const_cast<uint8_t*>(s->map), s->map_bytes);
  ::close(s->fd);
  delete s;
}

// ---------- host-side helpers ----------

// Exact-stamp pairing (get_valid_message_stream.py:39-53 semantics): for each
// stamp value present in BOTH sorted inputs, emit one (ia, ib) index pair.
// Returns the number of pairs. Duplicate stamps pair first-with-first.
int64_t vostore_pair_stamps(const double* a, int64_t na, const double* b,
                            int64_t nb, int64_t* out_ia, int64_t* out_ib) {
  int64_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) {
      i++;
    } else if (a[i] > b[j]) {
      j++;
    } else {
      out_ia[k] = i;
      out_ib[k] = j;
      k++;
      i++;
      j++;
    }
  }
  return k;
}

// Interleaved RGB/BGR u8 -> BT.601 luma u8 (cv.cvtColor COLOR_BGR2GRAY
// parity, v3:131-132). order: 0 = RGB, 1 = BGR.
void vostore_rgb_to_gray(const uint8_t* in, uint8_t* out, int64_t n_px,
                         int order) {
  const int r_off = order == 0 ? 0 : 2;
  const int b_off = order == 0 ? 2 : 0;
  for (int64_t p = 0; p < n_px; ++p) {
    const uint8_t* px = in + 3 * p;
    // OpenCV's fixed-point BT.601 weights (15-bit).
    const uint32_t y = 9798u * px[r_off] + 19235u * px[1] + 3735u * px[b_off];
    out[p] = static_cast<uint8_t>((y + (1u << 14)) >> 15);
  }
}

}  // extern "C"
