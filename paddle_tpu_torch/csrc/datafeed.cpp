// The native datafeed engine: the C++ half of the host input path (a copy
// of paddle_tpu/ops/native/datafeed.cpp; the port builds its own).
//
// Text files of multi-slot records are parsed on reader threads and
// batched into a bounded channel of finished batches; Python copies each
// batch out through the C ABI below.  Dense slots come out as [B, dim]
// float32, sparse slots in the ragged encoding of tensor.sequence (flat
// int64 ids and per-row lengths).  The reader threads never take the GIL.
//
// Record format: one instance a line; for each slot in schema order,
// <count> <v0> <v1> ... .
//
// C ABI (loaded by paddle_tpu_torch/ops/native/__init__.py with ctypes):
//   df_create(schema, batch_size, nthreads, capacity) -> handle
//     schema: comma-separated "name:kind[:dim]", kind 'f' dense float32
//             (dim values per instance), 'u' sparse int64 id list
//   df_add_file(h, path); df_start(h);
//   df_next(h) -> rows in the ready batch (0 = exhausted)
//   df_dense(h, slot, float* out)
//   df_sparse_total(h, slot) -> total ids;  df_sparse(h, slot, ids, lens)
//   df_error(h) -> const char* ("" if none);  df_destroy(h)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::string name;
  char kind;    // 'f' dense float32, 'u' sparse int64
  int dim;      // dense width (kind 'f')
};

struct Batch {
  int rows = 0;
  // per dense slot: rows*dim floats; per sparse slot: flat ids + lengths
  std::vector<std::vector<float>> dense;
  std::vector<std::vector<int64_t>> sparse_ids;
  std::vector<std::vector<int64_t>> sparse_lens;
};

// framework/channel.h role: bounded MPMC queue of finished batches.
class BatchChannel {
 public:
  explicit BatchChannel(size_t cap) : cap_(cap) {}

  void Put(Batch&& b) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_put_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push_back(std::move(b));
    cv_get_.notify_one();
  }

  bool Get(Batch* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_get_.wait(lk, [&] { return !q_.empty() || done_ || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    cv_put_.notify_one();
    return true;
  }

  void SetDone() {            // producers finished; drain then stop
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    cv_get_.notify_all();
  }

  void Close() {              // consumer bailed; unblock producers
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_put_.notify_all();
    cv_get_.notify_all();
  }

 private:
  size_t cap_;
  std::deque<Batch> q_;
  bool done_ = false, closed_ = false;
  std::mutex mu_;
  std::condition_variable cv_put_, cv_get_;
};

class DataFeed {
 public:
  DataFeed(std::vector<Slot> slots, int batch_size, int nthreads,
           size_t capacity)
      : slots_(std::move(slots)),
        batch_size_(batch_size),
        nthreads_(nthreads),
        chan_(capacity) {}

  ~DataFeed() {
    chan_.Close();
    for (auto& t : threads_)
      if (t.joinable()) t.join();
  }

  void AddFile(const std::string& path) { files_.push_back(path); }

  void Start() {
    file_cursor_ = 0;
    live_readers_ = nthreads_;
    for (int i = 0; i < nthreads_; ++i)
      threads_.emplace_back([this] { ReadThread(); });
  }

  int Next() {
    if (!chan_.Get(&cur_)) return 0;
    return cur_.rows;
  }

  const Batch& Current() const { return cur_; }
  const std::vector<Slot>& slots() const { return slots_; }

  std::string TakeError() {
    std::lock_guard<std::mutex> lk(err_mu_);
    return err_;
  }

 private:
  bool NextFile(std::string* path) {
    size_t i = file_cursor_.fetch_add(1);
    if (i >= files_.size()) return false;
    *path = files_[i];
    return true;
  }

  void Fail(const std::string& msg) {
    {
      std::lock_guard<std::mutex> lk(err_mu_);
      if (err_.empty()) err_ = msg;
    }
    chan_.Close();
  }

  // data_feed.cc:469 ReadThread — files → instances → batches
  void ReadThread() {
    Batch b = NewBatch();
    std::string path;
    while (NextFile(&path)) {
      std::ifstream in(path);
      if (!in) {
        Fail("datafeed: cannot open " + path);
        break;
      }
      std::string line;
      while (std::getline(in, line)) {
        if (line.empty()) continue;
        if (!ParseOneInstance(line, &b)) {
          Fail("datafeed: bad record in " + path + ": " + line);
          break;
        }
        if (b.rows == batch_size_) {
          chan_.Put(std::move(b));
          b = NewBatch();
        }
      }
    }
    if (b.rows > 0) chan_.Put(std::move(b));
    if (--live_readers_ == 0) chan_.SetDone();
  }

  Batch NewBatch() {
    Batch b;
    b.dense.resize(slots_.size());
    b.sparse_ids.resize(slots_.size());
    b.sparse_lens.resize(slots_.size());
    for (size_t s = 0; s < slots_.size(); ++s)
      if (slots_[s].kind == 'f')
        b.dense[s].reserve(batch_size_ * slots_[s].dim);
    return b;
  }

  // MultiSlot line: per slot, <count> then count values
  bool ParseOneInstance(const std::string& line, Batch* b) {
    const char* p = line.c_str();
    char* end = nullptr;
    for (size_t s = 0; s < slots_.size(); ++s) {
      long count = std::strtol(p, &end, 10);
      if (end == p || count < 0) return false;
      p = end;
      if (slots_[s].kind == 'f') {
        if (count != slots_[s].dim) return false;
        for (long i = 0; i < count; ++i) {
          float v = std::strtof(p, &end);
          if (end == p) return false;
          p = end;
          b->dense[s].push_back(v);
        }
      } else {
        for (long i = 0; i < count; ++i) {
          long long v = std::strtoll(p, &end, 10);
          if (end == p) return false;
          p = end;
          b->sparse_ids[s].push_back(v);
        }
        b->sparse_lens[s].push_back(count);
      }
    }
    b->rows += 1;
    return true;
  }

  std::vector<Slot> slots_;
  int batch_size_, nthreads_;
  BatchChannel chan_;
  std::vector<std::string> files_;
  std::atomic<size_t> file_cursor_{0};
  std::atomic<int> live_readers_{0};
  std::vector<std::thread> threads_;
  Batch cur_;
  std::mutex err_mu_;
  std::string err_;
};

std::vector<Slot> ParseSchema(const std::string& schema) {
  std::vector<Slot> out;
  std::stringstream ss(schema);
  std::string item;
  while (std::getline(ss, item, ',')) {
    Slot s;
    size_t a = item.find(':');
    size_t b = item.find(':', a + 1);
    s.name = item.substr(0, a);
    s.kind = item[a + 1];
    s.dim = (b == std::string::npos) ? 1
                                     : std::stoi(item.substr(b + 1));
    out.push_back(s);
  }
  return out;
}

}  // namespace

extern "C" {

void* df_create(const char* schema, int batch_size, int nthreads,
                int capacity) {
  return new DataFeed(ParseSchema(schema), batch_size,
                      nthreads > 0 ? nthreads : 1,
                      capacity > 0 ? capacity : 8);
}

void df_add_file(void* h, const char* path) {
  static_cast<DataFeed*>(h)->AddFile(path);
}

void df_start(void* h) { static_cast<DataFeed*>(h)->Start(); }

int df_next(void* h) { return static_cast<DataFeed*>(h)->Next(); }

void df_dense(void* h, int slot, float* out) {
  const auto& b = static_cast<DataFeed*>(h)->Current();
  const auto& v = b.dense[slot];
  std::memcpy(out, v.data(), v.size() * sizeof(float));
}

long long df_sparse_total(void* h, int slot) {
  return static_cast<long long>(
      static_cast<DataFeed*>(h)->Current().sparse_ids[slot].size());
}

void df_sparse(void* h, int slot, long long* ids, long long* lens) {
  const auto& b = static_cast<DataFeed*>(h)->Current();
  const auto& i = b.sparse_ids[slot];
  const auto& l = b.sparse_lens[slot];
  std::memcpy(ids, i.data(), i.size() * sizeof(long long));
  std::memcpy(lens, l.data(), l.size() * sizeof(long long));
}

const char* df_error(void* h) {
  thread_local std::string err;
  err = static_cast<DataFeed*>(h)->TakeError();
  return err.c_str();
}

void df_destroy(void* h) { delete static_cast<DataFeed*>(h); }

}  // extern "C"
