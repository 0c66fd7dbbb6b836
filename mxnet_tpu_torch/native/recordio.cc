// Native RecordIO reader/writer + prefetching batch server.
//
// The host side of the port's record input path, kept byte for byte
// compatible with the JAX package's reader (mxnet_tpu/native/recordio.cc)
// and with the reference's dmlc-core RecordIOReader/Writer:
//  - the file is mmap'd once and records are served zero-copy;
//  - a background thread pool assembles shuffled batches of raw payloads
//    into contiguous host buffers;
//  - exposed as a C ABI for ctypes.
//
// Record framing:
// [u32 magic=0xced7230a][u32 lrec: cflag(3 bits)<<29 | len(29 bits)]
// [payload][pad to 4B].

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct Record {
  uint64_t offset;  // payload offset in file
  uint32_t length;
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<Record> records;
  std::string error;
};

bool index_records(Reader* r) {
  size_t pos = 0;
  while (pos + 8 <= r->size) {
    uint32_t magic, lrec;
    std::memcpy(&magic, r->base + pos, 4);
    std::memcpy(&lrec, r->base + pos + 4, 4);
    if (magic != kMagic) {
      r->error = "bad magic at offset " + std::to_string(pos);
      return false;
    }
    uint32_t len = lrec & ((1u << 29) - 1);
    if (pos + 8 + len > r->size) {
      r->error = "truncated record";
      return false;
    }
    r->records.push_back({pos + 8, len});
    size_t padded = (len + 3u) & ~3u;
    pos += 8 + padded;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Prefetching batch server: worker threads pull shuffled index ranges and
// pack payloads into contiguous buffers (lengths + offsets sidecar), the
// analog of iter_batchloader.h + iter_prefetcher.h rolled together.
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<uint8_t> data;     // concatenated payloads
  std::vector<int64_t> offsets;  // per-record start in `data`
  std::vector<int64_t> lengths;
};

struct BatchServer {
  Reader* reader = nullptr;
  int batch_size = 0;
  bool shuffle = false;
  uint64_t seed = 0;
  int epoch = 0;

  std::vector<uint32_t> order;
  size_t cursor = 0;

  std::deque<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t max_ready = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> active{0};
  std::mutex cursor_mu;

  ~BatchServer() { shutdown(); }

  void reset_order() {
    order.resize(reader->records.size());
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      std::shuffle(order.begin(), order.end(), rng);
    }
    cursor = 0;
  }

  bool next_indices(std::vector<uint32_t>* idx) {
    std::lock_guard<std::mutex> lk(cursor_mu);
    if (cursor >= order.size()) return false;
    size_t end = std::min(cursor + batch_size, order.size());
    idx->assign(order.begin() + cursor, order.begin() + end);
    cursor = end;
    // pad final batch by wrapping (reference last_batch_handle="pad")
    size_t need = batch_size - idx->size();
    for (size_t i = 0; i < need; ++i) idx->push_back(order[i % order.size()]);
    return true;
  }

  void worker_loop() {
    std::vector<uint32_t> idx;
    while (!stop.load()) {
      if (!next_indices(&idx)) break;
      Batch* b = new Batch();
      size_t total = 0;
      for (uint32_t i : idx) total += reader->records[i].length;
      b->data.resize(total);
      b->offsets.reserve(idx.size());
      b->lengths.reserve(idx.size());
      size_t at = 0;
      for (uint32_t i : idx) {
        const Record& rec = reader->records[i];
        std::memcpy(b->data.data() + at, reader->base + rec.offset,
                    rec.length);
        b->offsets.push_back(static_cast<int64_t>(at));
        b->lengths.push_back(rec.length);
        at += rec.length;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [this] {
        return ready.size() < max_ready || stop.load();
      });
      if (stop.load()) {
        delete b;
        active.fetch_sub(1);
        return;
      }
      ready.push_back(b);
      cv_ready.notify_one();
    }
    // only the LAST exiting worker marks end-of-epoch — an earlier
    // marker would make the consumer drop batches still in flight
    if (active.fetch_sub(1) == 1) {
      std::unique_lock<std::mutex> lk(mu);
      ready.push_back(nullptr);
      cv_ready.notify_all();
    }
  }

  void start(int num_workers) {
    stop.store(false);
    reset_order();
    active.store(num_workers);
    for (int i = 0; i < num_workers; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  void shutdown() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    for (Batch* b : ready) delete b;
    ready.clear();
  }
};

}  // namespace

extern "C" {

void* rio_open(const char* path) {
  Reader* r = new Reader();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  fstat(r->fd, &st);
  r->size = static_cast<size_t>(st.st_size);
  if (r->size > 0) {
    void* m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
    if (m == MAP_FAILED) {
      close(r->fd);
      delete r;
      return nullptr;
    }
    r->base = static_cast<const uint8_t*>(m);
    madvise(const_cast<uint8_t*>(r->base), r->size, MADV_SEQUENTIAL);
  }
  if (!index_records(r)) {
    // leave error retrievable via rio_error
  }
  return r;
}

const char* rio_error(void* h) {
  return static_cast<Reader*>(h)->error.c_str();
}

int64_t rio_count(void* h) {
  return static_cast<int64_t>(static_cast<Reader*>(h)->records.size());
}

int64_t rio_get(void* h, int64_t i, const uint8_t** ptr) {
  Reader* r = static_cast<Reader*>(h);
  if (i < 0 || static_cast<size_t>(i) >= r->records.size()) return -1;
  const Record& rec = r->records[i];
  *ptr = r->base + rec.offset;
  return rec.length;
}

void rio_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

// -- writer -----------------------------------------------------------------

void* rio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  return f;
}

int rio_writer_write(void* h, const uint8_t* data, int64_t len) {
  FILE* f = static_cast<FILE*>(h);
  uint32_t magic = kMagic;
  uint32_t lrec = static_cast<uint32_t>(len) & ((1u << 29) - 1);
  if (fwrite(&magic, 4, 1, f) != 1) return -1;
  if (fwrite(&lrec, 4, 1, f) != 1) return -1;
  if (len > 0 && fwrite(data, 1, len, f) != static_cast<size_t>(len))
    return -1;
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  size_t pad = (4 - (len % 4)) % 4;
  if (pad && fwrite(zeros, 1, pad, f) != pad) return -1;
  return 0;
}

void rio_writer_close(void* h) { fclose(static_cast<FILE*>(h)); }

// -- batch server -----------------------------------------------------------

void* rio_batch_server_create(void* reader, int batch_size, int shuffle,
                              uint64_t seed, int num_workers) {
  BatchServer* s = new BatchServer();
  s->reader = static_cast<Reader*>(reader);
  s->batch_size = batch_size;
  s->shuffle = shuffle != 0;
  s->seed = seed;
  s->start(num_workers > 0 ? num_workers : 2);
  return s;
}

// Returns a Batch* or nullptr at end of epoch.
void* rio_batch_next(void* server) {
  BatchServer* s = static_cast<BatchServer*>(server);
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_ready.wait(lk, [s] { return !s->ready.empty() || s->stop.load(); });
  if (s->ready.empty()) return nullptr;
  Batch* b = s->ready.front();
  s->ready.pop_front();
  s->cv_space.notify_one();
  return b;
}

int64_t rio_batch_total_bytes(void* batch) {
  return static_cast<int64_t>(static_cast<Batch*>(batch)->data.size());
}

const uint8_t* rio_batch_data(void* batch) {
  return static_cast<Batch*>(batch)->data.data();
}

const int64_t* rio_batch_offsets(void* batch) {
  return static_cast<Batch*>(batch)->offsets.data();
}

const int64_t* rio_batch_lengths(void* batch) {
  return static_cast<Batch*>(batch)->lengths.data();
}

int64_t rio_batch_size(void* batch) {
  return static_cast<int64_t>(static_cast<Batch*>(batch)->offsets.size());
}

void rio_batch_free(void* batch) { delete static_cast<Batch*>(batch); }

void rio_batch_server_reset(void* server) {
  BatchServer* s = static_cast<BatchServer*>(server);
  int workers = static_cast<int>(s->workers.size());
  s->shutdown();
  s->epoch += 1;
  s->start(workers > 0 ? workers : 2);
}

void rio_batch_server_destroy(void* server) {
  delete static_cast<BatchServer*>(server);
}

}  // extern "C"
