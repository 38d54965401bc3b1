// Async chunked checkpoint writer.
//
// The sampling loop hands off serialized chunk bytes and returns at
// once; a background thread appends length-prefixed, CRC32-protected
// records to disk. Readers validate the CRCs, so a crash mid-write loses
// at most the trailing partial record (the reference's append-only
// resume, src/sampling.jl:311-319). The record format is the JAX
// package's (cmblensing_tpu/native/ckpt.cpp), so either package reads
// the other's files.
//
// Record format: [u64 payload_len][u32 crc32][payload bytes]
//
// Built at first use by cmblensing_tpu_torch/native/__init__.py:
//   g++ -O2 -shared -fPIC -std=c++17 -pthread ckpt.cpp -o build/libckpt_<hash>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

uint32_t crc32_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* buf, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = crc32_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* fp = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> queue;
  std::atomic<bool> stopping{false};
  std::atomic<int64_t> pending{0};
  std::atomic<int64_t> written{0};
  std::atomic<bool> error{false};

  void run() {
    for (;;) {
      std::vector<uint8_t> item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stopping.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stopping.load()) break;
          continue;
        }
        item = std::move(queue.front());
        queue.pop_front();
      }
      uint64_t len = item.size();
      uint32_t crc = crc32(item.data(), item.size());
      if (fwrite(&len, sizeof(len), 1, fp) != 1 ||
          fwrite(&crc, sizeof(crc), 1, fp) != 1 ||
          (len > 0 && fwrite(item.data(), 1, len, fp) != len)) {
        error.store(true);
      }
      fflush(fp);
      {
        // the pending decrement must happen under the cv's mutex, or a
        // flusher can evaluate its predicate, miss this notify in the
        // window before it atomically sleeps, and block forever
        std::lock_guard<std::mutex> lk(mu);
        pending.fetch_sub(1);
        written.fetch_add(1);
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ckpt_open(const char* path, int append) {
  FILE* fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return nullptr;
  Writer* w = new Writer();
  w->fp = fp;
  w->worker = std::thread([w] { w->run(); });
  return w;
}

// Enqueue a record (copies buf); returns pending queue depth, or -1.
int64_t ckpt_write(void* handle, const uint8_t* buf, uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || w->error.load()) return -1;
  {
    // increment under mu too: a worker that pops + decrements before
    // the increment would let a concurrent flush observe pending==0
    // while this record is still unwritten
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.emplace_back(buf, buf + len);
    w->pending.fetch_add(1);
  }
  w->cv.notify_all();
  return w->pending.load();
}

// Block until all queued records hit the disk. Returns 0 on success.
int ckpt_flush(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv.wait(lk, [&] { return w->pending.load() == 0; });
  return w->error.load() ? -1 : 0;
}

int64_t ckpt_written(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  return w ? w->written.load() : -1;
}

int ckpt_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stopping.store(true);
  }
  w->cv.notify_all();
  w->worker.join();
  int rc = w->error.load() ? -1 : 0;
  fclose(w->fp);
  delete w;
  return rc;
}

// Reader: scan records, validating CRCs; stops at first corrupt/partial
// record. Returns number of valid records; fills offsets/lengths arrays
// up to max_records.
int64_t ckpt_scan(const char* path, uint64_t* offsets, uint64_t* lengths,
                  int64_t max_records) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  int64_t n = 0;
  uint64_t off = 0;
  for (;;) {
    uint64_t len;
    uint32_t crc;
    if (fread(&len, sizeof(len), 1, fp) != 1) break;
    if (fread(&crc, sizeof(crc), 1, fp) != 1) break;
    if (len > (1ull << 40)) break;  // corrupt length
    std::vector<uint8_t> buf(len);
    if (len > 0 && fread(buf.data(), 1, len, fp) != len) break;
    if (crc32(buf.data(), len) != crc) break;
    if (n < max_records) {
      offsets[n] = off + sizeof(len) + sizeof(crc);
      lengths[n] = len;
    }
    off += sizeof(len) + sizeof(crc) + len;
    n++;
  }
  fclose(fp);
  return n;
}

}  // extern "C"
