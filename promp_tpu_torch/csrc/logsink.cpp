// Async log/metrics sink: a background writer for the KV logger
// (port of runtime/logsink.cpp).
//
// Rows are queued from Python (ctypes) into an in-memory queue and put on
// disk by a dedicated writer thread, so log IO never blocks the loop that
// feeds the card.
//
// C ABI (for ctypes):
//   void*  logsink_open(const char* path);
//   void   logsink_write(void* handle, const char* data, size_t len);
//   void   logsink_flush(void* handle);
//   void   logsink_close(void* handle);
//   size_t logsink_queued(void* handle);     // rows not yet on disk
//   size_t logsink_dropped(void* handle);    // rows dropped (queue full)
//
// Bounded queue (64k rows): writers never block; on overflow rows are
// dropped and counted (metrics loss is preferable to stalling training).

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {

constexpr size_t kMaxQueuedRows = 65536;

struct Sink {
  FILE* file = nullptr;
  std::deque<std::string> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread writer;
  std::atomic<bool> stop{false};
  std::atomic<bool> flush_requested{false};
  std::atomic<size_t> dropped{0};
  std::condition_variable flush_cv;

  void Run() {
    std::deque<std::string> local;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] {
          return stop.load() || flush_requested.load() || !queue.empty();
        });
        local.swap(queue);
      }
      for (const auto& row : local) {
        fwrite(row.data(), 1, row.size(), file);
      }
      local.clear();
      if (flush_requested.exchange(false)) {
        fflush(file);
        flush_cv.notify_all();
      }
      if (stop.load()) {
        std::unique_lock<std::mutex> lock(mu);
        if (queue.empty()) break;
      }
    }
    fflush(file);
  }
};

}  // namespace

extern "C" {

void* logsink_open(const char* path) {
  FILE* f = fopen(path, "ab");
  if (!f) return nullptr;
  Sink* s = new Sink();
  s->file = f;
  s->writer = std::thread([s] { s->Run(); });
  return s;
}

void logsink_write(void* handle, const char* data, size_t len) {
  if (!handle) return;
  Sink* s = static_cast<Sink*>(handle);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->queue.size() >= kMaxQueuedRows) {
      s->dropped.fetch_add(1);
      return;
    }
    s->queue.emplace_back(data, len);
  }
  s->cv.notify_one();
}

void logsink_flush(void* handle) {
  if (!handle) return;
  Sink* s = static_cast<Sink*>(handle);
  s->flush_requested.store(true);
  s->cv.notify_one();
  std::unique_lock<std::mutex> lock(s->mu);
  s->flush_cv.wait_for(lock, std::chrono::seconds(5), [&] {
    return !s->flush_requested.load();
  });
}

size_t logsink_queued(void* handle) {
  if (!handle) return 0;
  Sink* s = static_cast<Sink*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->queue.size();
}

size_t logsink_dropped(void* handle) {
  if (!handle) return 0;
  return static_cast<Sink*>(handle)->dropped.load();
}

void logsink_close(void* handle) {
  if (!handle) return;
  Sink* s = static_cast<Sink*>(handle);
  s->stop.store(true);
  s->cv.notify_one();
  if (s->writer.joinable()) s->writer.join();
  fclose(s->file);
  delete s;
}

}  // extern "C"
