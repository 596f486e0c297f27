// Async durable checkpoint writer (port of runtime/ckptwriter.cpp).
//
// The (already serialized) snapshot is handed to a dedicated writer
// thread, which makes it durable:
//
//   write "<path>.tmp.<seq>"  ->  fsync(file)  ->  rename over <path>
//   ->  fsync(directory)
//
// so a preempted run can never observe a torn snapshot, and the training
// loop never blocks on disk. Submissions to the same path are applied in
// submission order (single worker, FIFO queue).
//
// C ABI (for ctypes):
//   void* ckpt_open(void);
//   long  ckpt_submit(void* h, const char* path, const char* data,
//                     size_t len);                 // >0 seq id, -1 error
//   int   ckpt_wait(void* h, long seq, int timeout_ms);
//                       // 1 = durable, 0 = timeout, -1 = that write failed
//   long  ckpt_pending(void* h);                   // jobs not yet durable
//   long  ckpt_errors(void* h);                    // total failed writes
//   void  ckpt_close(void* h);                     // drain queue + join

#include <fcntl.h>
#include <libgen.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

struct Job {
  long seq;
  std::string path;
  std::vector<char> data;
};

bool WriteDurable(const Job& job) {
  const std::string tmp = job.path + ".tmp." + std::to_string(job.seq);
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  size_t off = 0;
  while (off < job.data.size()) {
    ssize_t n = ::write(fd, job.data.data() + off, job.data.size() - off);
    if (n < 0) {
      ::close(fd);
      ::unlink(tmp.c_str());
      return false;
    }
    off += static_cast<size_t>(n);
  }
  if (::fsync(fd) != 0 || ::close(fd) != 0) {
    ::unlink(tmp.c_str());
    return false;
  }
  if (::rename(tmp.c_str(), job.path.c_str()) != 0) {
    ::unlink(tmp.c_str());
    return false;
  }
  // fsync the containing directory so the rename itself is durable
  std::vector<char> dirbuf(job.path.begin(), job.path.end());
  dirbuf.push_back('\0');
  int dfd = ::open(::dirname(dirbuf.data()), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    ::fsync(dfd);
    ::close(dfd);
  }
  return true;
}

struct Writer {
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;       // wakes the worker
  std::condition_variable done_cv;  // wakes waiters
  std::thread worker;
  bool stop = false;
  long next_seq = 1;
  long completed = 0;  // all seqs <= completed are finished (ok or failed)
  std::unordered_set<long> failed;
  std::atomic<long> errors{0};

  void Run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return stop || !queue.empty(); });
        if (queue.empty()) break;  // stop requested and fully drained
        job = std::move(queue.front());
        queue.pop_front();
      }
      const bool ok = WriteDurable(job);
      {
        std::lock_guard<std::mutex> lock(mu);
        completed = job.seq;
        if (!ok) {
          failed.insert(job.seq);
          errors.fetch_add(1);
        }
      }
      done_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ckpt_open(void) {
  Writer* w = new Writer();
  w->worker = std::thread([w] { w->Run(); });
  return w;
}

long ckpt_submit(void* handle, const char* path, const char* data,
                 size_t len) {
  if (!handle || !path || (!data && len > 0)) return -1;
  Writer* w = static_cast<Writer*>(handle);
  long seq;
  {
    std::lock_guard<std::mutex> lock(w->mu);
    if (w->stop) return -1;
    seq = w->next_seq++;
    Job job;
    job.seq = seq;
    job.path = path;
    job.data.assign(data, data + len);
    w->queue.push_back(std::move(job));
  }
  w->cv.notify_one();
  return seq;
}

int ckpt_wait(void* handle, long seq, int timeout_ms) {
  if (!handle) return -1;
  Writer* w = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lock(w->mu);
  const bool done = w->done_cv.wait_for(
      lock, std::chrono::milliseconds(timeout_ms),
      [&] { return w->completed >= seq; });
  if (!done) return 0;
  return w->failed.count(seq) ? -1 : 1;
}

long ckpt_pending(void* handle) {
  if (!handle) return 0;
  Writer* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  return (w->next_seq - 1) - w->completed;
}

long ckpt_errors(void* handle) {
  if (!handle) return 0;
  return static_cast<Writer*>(handle)->errors.load();
}

void ckpt_close(void* handle) {
  if (!handle) return;
  Writer* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lock(w->mu);
    w->stop = true;
  }
  w->cv.notify_one();
  if (w->worker.joinable()) w->worker.join();
  delete w;
}

}  // extern "C"
