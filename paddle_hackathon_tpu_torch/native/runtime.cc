// Native host runtime of the PyTorch/CUDA port: the port's own copy of
// the reference package's native runtime, with the same C ABI.
//
// Counterpart of the reference's C++ runtime services:
//   * TCP KV store       — rendezvous store for multi-host bootstrap
//                          (ref: paddle/fluid/distributed/store/tcp_store.h:120)
//   * host allocator     — auto-growth best-fit with usage stats
//                          (ref: paddle/fluid/memory/allocation/
//                           auto_growth_best_fit_allocator.cc, stats.h:112)
//   * workqueue          — dependency-counted async DAG scheduler
//                          (ref: paddle/fluid/framework/new_executor/
//                           interpretercore.cc:653 + workqueue/)
//   * host event tracer  — thread-local event recording + chrome trace
//                          (ref: paddle/fluid/platform/profiler/
//                           host_event_recorder.h, chrometracing_logger.cc)
//   * flags registry     — process-global key/value flags
//                          (ref: paddle/fluid/platform/flags.cc:36-157)
//
// Device memory and streams belong to torch's CUDA allocator and streams,
// so the native layer owns the *host-side* runtime: rendezvous, host
// staging buffers, host task scheduling, and instrumentation.  Exposed as
// a plain C ABI for ctypes.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#define PHT_API extern "C" __attribute__((visibility("default")))

namespace {

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Flags registry
// ---------------------------------------------------------------------------

struct FlagRegistry {
  std::mutex mu;
  std::unordered_map<std::string, std::string> flags;
};

FlagRegistry& flag_registry() {
  static FlagRegistry* r = new FlagRegistry();
  return *r;
}

// ---------------------------------------------------------------------------
// Allocator: auto-growth best-fit over malloc'd chunks
// ---------------------------------------------------------------------------

struct Block;

struct Chunk {
  void* base;
  size_t size;
};

struct Block {
  size_t size;      // payload bytes
  bool free;
  Block* prev;      // physical neighbor
  Block* next;
  int chunk_id;
};

constexpr size_t kAlign = 64;
constexpr size_t kHeader = (sizeof(Block) + kAlign - 1) / kAlign * kAlign;
constexpr size_t kDefaultChunk = size_t(1) << 20;  // 1 MiB

struct Allocator {
  std::mutex mu;
  std::multimap<size_t, Block*> free_blocks;
  std::vector<Chunk> chunks;
  // stats (ref memory/stats.h DEVICE_MEMORY_STAT current/peak)
  std::atomic<int64_t> in_use{0};
  std::atomic<int64_t> peak{0};
  std::atomic<int64_t> reserved{0};
  std::atomic<int64_t> alloc_count{0};
  std::atomic<int64_t> free_count{0};

  static size_t round_up(size_t n) { return (n + kAlign - 1) / kAlign * kAlign; }

  void* data_ptr(Block* b) {
    return reinterpret_cast<char*>(b) + kHeader;
  }
  Block* block_of(void* p) {
    return reinterpret_cast<Block*>(reinterpret_cast<char*>(p) - kHeader);
  }

  void* alloc(size_t n) {
    if (n == 0) n = kAlign;
    n = round_up(n);
    std::lock_guard<std::mutex> g(mu);
    auto it = free_blocks.lower_bound(n);
    Block* b;
    if (it != free_blocks.end()) {
      b = it->second;
      free_blocks.erase(it);
    } else {
      // grow: new chunk holding at least the request
      size_t payload = n + kHeader;
      size_t csize = payload > kDefaultChunk ? payload : kDefaultChunk;
      void* base = std::malloc(csize);
      if (!base) return nullptr;
      reserved += static_cast<int64_t>(csize);
      int cid = static_cast<int>(chunks.size());
      chunks.push_back({base, csize});
      b = reinterpret_cast<Block*>(base);
      b->size = csize - kHeader;
      b->free = true;
      b->prev = b->next = nullptr;
      b->chunk_id = cid;
    }
    // split if the remainder can hold another block
    if (b->size >= n + kHeader + kAlign) {
      char* raw = reinterpret_cast<char*>(b);
      Block* rest = reinterpret_cast<Block*>(raw + kHeader + n);
      rest->size = b->size - n - kHeader;
      rest->free = true;
      rest->chunk_id = b->chunk_id;
      rest->prev = b;
      rest->next = b->next;
      if (b->next) b->next->prev = rest;
      b->next = rest;
      b->size = n;
      free_blocks.emplace(rest->size, rest);
    }
    b->free = false;
    int64_t cur = in_use.fetch_add(static_cast<int64_t>(b->size)) +
                  static_cast<int64_t>(b->size);
    int64_t pk = peak.load();
    while (cur > pk && !peak.compare_exchange_weak(pk, cur)) {}
    alloc_count++;
    return data_ptr(b);
  }

  void erase_free(Block* b) {
    auto range = free_blocks.equal_range(b->size);
    for (auto it = range.first; it != range.second; ++it) {
      if (it->second == b) { free_blocks.erase(it); return; }
    }
  }

  void dealloc(void* p) {
    if (!p) return;
    std::lock_guard<std::mutex> g(mu);
    Block* b = block_of(p);
    in_use -= static_cast<int64_t>(b->size);
    free_count++;
    b->free = true;
    // coalesce with next
    if (b->next && b->next->free) {
      Block* nx = b->next;
      erase_free(nx);
      b->size += kHeader + nx->size;
      b->next = nx->next;
      if (nx->next) nx->next->prev = b;
    }
    // coalesce with prev
    if (b->prev && b->prev->free) {
      Block* pv = b->prev;
      erase_free(pv);
      pv->size += kHeader + b->size;
      pv->next = b->next;
      if (b->next) b->next->prev = pv;
      b = pv;
    }
    free_blocks.emplace(b->size, b);
  }
};

Allocator& allocator() {
  static Allocator* a = new Allocator();
  return *a;
}

// ---------------------------------------------------------------------------
// Host event tracer
// ---------------------------------------------------------------------------

struct TraceEvent {
  std::string name;
  int64_t start_ns;
  int64_t end_ns;
  int64_t tid;
};

struct Tracer {
  std::mutex mu;
  std::vector<TraceEvent> events;
  std::atomic<bool> active{false};
};

Tracer& tracer() {
  static Tracer* t = new Tracer();
  return *t;
}

struct TraceFrame {
  std::string name;
  int64_t start_ns;
};

thread_local std::vector<TraceFrame> trace_stack;

int64_t current_tid() {
  return static_cast<int64_t>(
      std::hash<std::thread::id>()(std::this_thread::get_id()) & 0x7fffffff);
}

// ---------------------------------------------------------------------------
// Workqueue: dependency-counted DAG scheduler
// ---------------------------------------------------------------------------

typedef void (*pht_task_fn)(void* arg, int32_t index);

struct WorkQueue {
  std::vector<std::thread> threads;
  std::deque<int32_t> ready;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  bool stop = false;

  // per-run state
  pht_task_fn fn = nullptr;
  void* arg = nullptr;
  std::vector<std::atomic<int32_t>> deps;
  const int32_t* adj = nullptr;
  const int32_t* adj_off = nullptr;
  std::atomic<int32_t> remaining{0};
  bool trace = false;

  explicit WorkQueue(int nthreads) {
    if (nthreads < 1) nthreads = 1;
    for (int i = 0; i < nthreads; i++) {
      threads.emplace_back([this] { worker_loop(); });
    }
  }

  ~WorkQueue() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
  }

  void worker_loop() {
    for (;;) {
      int32_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !ready.empty(); });
        if (stop && ready.empty()) return;
        idx = ready.front();
        ready.pop_front();
      }
      int64_t t0 = trace ? now_ns() : 0;
      fn(arg, idx);
      if (trace && tracer().active.load()) {
        TraceEvent ev{"wq_task_" + std::to_string(idx), t0, now_ns(),
                      current_tid()};
        std::lock_guard<std::mutex> g(tracer().mu);
        tracer().events.push_back(std::move(ev));
      }
      // release successors (ref interpretercore RunNextInstructions:710)
      std::vector<int32_t> newly;
      for (int32_t e = adj_off[idx]; e < adj_off[idx + 1]; e++) {
        int32_t succ = adj[e];
        if (deps[succ].fetch_sub(1) == 1) newly.push_back(succ);
      }
      bool finished = false;
      {
        std::lock_guard<std::mutex> g(mu);
        for (int32_t s : newly) ready.push_back(s);
        if (remaining.fetch_sub(1) == 1) finished = true;
      }
      if (!newly.empty()) cv.notify_all();
      if (finished) done_cv.notify_all();
    }
  }

  std::mutex run_mu;  // one DAG run at a time; per-run state is queue-global

  // Run a DAG of n tasks. dep_counts[i] = number of predecessors; CSR
  // adjacency (adj_off size n+1) lists successors. Blocks until all run.
  // Calling run_dag from inside a task of the same queue deadlocks.
  void run_dag(int32_t n, pht_task_fn f, void* a, const int32_t* dep_counts,
               const int32_t* adjacency, const int32_t* adj_offsets,
               bool with_trace) {
    std::lock_guard<std::mutex> run_guard(run_mu);
    std::unique_lock<std::mutex> lk(mu);
    fn = f;
    arg = a;
    adj = adjacency;
    adj_off = adj_offsets;
    trace = with_trace;
    deps = std::vector<std::atomic<int32_t>>(n);
    remaining = n;
    for (int32_t i = 0; i < n; i++) {
      deps[i].store(dep_counts[i]);
      if (dep_counts[i] == 0) ready.push_back(i);
    }
    cv.notify_all();
    done_cv.wait(lk, [this] { return remaining.load() == 0; });
  }
};

// ---------------------------------------------------------------------------
// TCP KV store
// ---------------------------------------------------------------------------

enum StoreOp : uint8_t {
  kSet = 1,
  kGet = 2,   // blocking wait-for-key with timeout
  kAdd = 3,
  kCheck = 4,
  kDelete = 5,
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct StoreServer {
  int listen_fd = -1;
  int port = 0;
  std::thread accept_thread;
  std::vector<std::thread> handlers;
  std::mutex handlers_mu;
  std::atomic<bool> stopping{false};

  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<std::string, std::string> data;

  bool start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return false;
    if (::listen(listen_fd, 128) < 0) return false;
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    accept_thread = std::thread([this] { accept_loop(); });
    return true;
  }

  void accept_loop() {
    for (;;) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (stopping.load()) return;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(handlers_mu);
      handlers.emplace_back([this, fd] { handle(fd); });
    }
  }

  void handle(int fd) {
    for (;;) {
      uint8_t op;
      if (!read_full(fd, &op, 1)) break;
      uint32_t klen;
      if (!read_full(fd, &klen, 4)) break;
      std::string key(klen, '\0');
      if (klen && !read_full(fd, &key[0], klen)) break;
      if (op == kSet) {
        uint32_t vlen;
        if (!read_full(fd, &vlen, 4)) break;
        std::string val(vlen, '\0');
        if (vlen && !read_full(fd, &val[0], vlen)) break;
        {
          std::lock_guard<std::mutex> g(mu);
          data[key] = std::move(val);
        }
        cv.notify_all();
        uint8_t ok = 1;
        if (!write_full(fd, &ok, 1)) break;
      } else if (op == kGet) {
        int64_t timeout_ms;
        if (!read_full(fd, &timeout_ms, 8)) break;
        std::string val;
        bool found = false;
        {
          std::unique_lock<std::mutex> lk(mu);
          auto pred = [&] { return data.count(key) > 0; };
          if (timeout_ms < 0) {
            cv.wait(lk, pred);
            found = true;
          } else {
            found = cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                pred);
          }
          if (found) val = data[key];
        }
        int32_t vlen = found ? static_cast<int32_t>(val.size()) : -1;
        if (!write_full(fd, &vlen, 4)) break;
        if (found && vlen && !write_full(fd, val.data(), val.size())) break;
      } else if (op == kAdd) {
        int64_t delta;
        if (!read_full(fd, &delta, 8)) break;
        int64_t result;
        {
          std::lock_guard<std::mutex> g(mu);
          int64_t cur = 0;
          auto it = data.find(key);
          if (it != data.end() && it->second.size() == 8)
            std::memcpy(&cur, it->second.data(), 8);
          result = cur + delta;
          std::string v(8, '\0');
          std::memcpy(&v[0], &result, 8);
          data[key] = std::move(v);
        }
        cv.notify_all();
        if (!write_full(fd, &result, 8)) break;
      } else if (op == kCheck) {
        uint8_t present;
        {
          std::lock_guard<std::mutex> g(mu);
          present = data.count(key) ? 1 : 0;
        }
        if (!write_full(fd, &present, 1)) break;
      } else if (op == kDelete) {
        uint8_t erased;
        {
          std::lock_guard<std::mutex> g(mu);
          erased = data.erase(key) ? 1 : 0;
        }
        if (!write_full(fd, &erased, 1)) break;
      } else {
        break;
      }
    }
    ::close(fd);
  }

  void shutdown() {
    stopping = true;
    ::shutdown(listen_fd, SHUT_RDWR);
    ::close(listen_fd);
    if (accept_thread.joinable()) accept_thread.join();
    std::lock_guard<std::mutex> g(handlers_mu);
    for (auto& t : handlers)
      if (t.joinable()) t.detach();  // blocked handlers die with process
    handlers.clear();
  }
};

struct StoreClient {
  int fd = -1;

  bool connect_to(const char* host, int port, int timeout_ms) {
    int64_t deadline = now_ns() + int64_t(timeout_ms) * 1000000;
    for (;;) {
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd < 0) return false;
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons(static_cast<uint16_t>(port));
      if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        ::close(fd);
        return false;
      }
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        return true;
      }
      ::close(fd);
      fd = -1;
      if (now_ns() > deadline) return false;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
  }

  bool send_key(uint8_t op, const char* key) {
    uint32_t klen = static_cast<uint32_t>(std::strlen(key));
    return write_full(fd, &op, 1) && write_full(fd, &klen, 4) &&
           write_full(fd, key, klen);
  }
};

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

// -- flags ------------------------------------------------------------------

PHT_API void pht_flag_set(const char* key, const char* value) {
  std::lock_guard<std::mutex> g(flag_registry().mu);
  flag_registry().flags[key] = value;
}

PHT_API int32_t pht_flag_get(const char* key, char* buf, int32_t buflen) {
  std::lock_guard<std::mutex> g(flag_registry().mu);
  auto it = flag_registry().flags.find(key);
  if (it == flag_registry().flags.end()) return -1;
  int32_t n = static_cast<int32_t>(it->second.size());
  if (buf && buflen > 0) {
    int32_t c = n < buflen - 1 ? n : buflen - 1;
    std::memcpy(buf, it->second.data(), c);
    buf[c] = '\0';
  }
  return n;
}

// -- allocator --------------------------------------------------------------

PHT_API void* pht_alloc(uint64_t n) { return allocator().alloc(n); }
PHT_API void pht_free(void* p) { allocator().dealloc(p); }

// which: 0=current_in_use 1=peak_in_use 2=reserved 3=alloc_count 4=free_count
PHT_API int64_t pht_mem_stat(int32_t which) {
  auto& a = allocator();
  switch (which) {
    case 0: return a.in_use.load();
    case 1: return a.peak.load();
    case 2: return a.reserved.load();
    case 3: return a.alloc_count.load();
    case 4: return a.free_count.load();
    default: return -1;
  }
}

PHT_API void pht_mem_reset_peak() {
  allocator().peak.store(allocator().in_use.load());
}

// -- tracer -----------------------------------------------------------------

PHT_API void pht_trace_enable(int32_t on) { tracer().active.store(on != 0); }

PHT_API void pht_trace_push(const char* name) {
  if (!tracer().active.load()) return;
  trace_stack.push_back({name, now_ns()});
}

PHT_API void pht_trace_pop() {
  if (trace_stack.empty()) return;
  TraceFrame f = trace_stack.back();
  trace_stack.pop_back();
  if (!tracer().active.load()) return;
  TraceEvent ev{std::move(f.name), f.start_ns, now_ns(), current_tid()};
  std::lock_guard<std::mutex> g(tracer().mu);
  tracer().events.push_back(std::move(ev));
}

PHT_API void pht_trace_record(const char* name, int64_t start_ns,
                              int64_t end_ns) {
  if (!tracer().active.load()) return;
  TraceEvent ev{name, start_ns, end_ns, current_tid()};
  std::lock_guard<std::mutex> g(tracer().mu);
  tracer().events.push_back(std::move(ev));
}

PHT_API int64_t pht_trace_count() {
  std::lock_guard<std::mutex> g(tracer().mu);
  return static_cast<int64_t>(tracer().events.size());
}

PHT_API void pht_trace_clear() {
  std::lock_guard<std::mutex> g(tracer().mu);
  tracer().events.clear();
}

// Writes chrome://tracing JSON; returns number of events written, -1 on error.
PHT_API int64_t pht_trace_dump_chrome(const char* path, int64_t pid) {
  std::vector<TraceEvent> evs;
  {
    std::lock_guard<std::mutex> g(tracer().mu);
    evs = tracer().events;
  }
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  auto escape = [](const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (char c : s) {
      if (c == '"' || c == '\\') {
        out += '\\';
        out += c;
      } else if (static_cast<unsigned char>(c) < 0x20) {
        char hex[8];
        std::snprintf(hex, sizeof(hex), "\\u%04x", c);
        out += hex;
      } else {
        out += c;
      }
    }
    return out;
  };
  std::fputs("{\"displayTimeUnit\":\"ms\",\"traceEvents\":[", f);
  for (size_t i = 0; i < evs.size(); i++) {
    const auto& e = evs[i];
    std::fprintf(f,
                 "%s{\"name\":\"%s\",\"ph\":\"X\",\"cat\":\"native\","
                 "\"pid\":%lld,\"tid\":%lld,\"ts\":%.3f,\"dur\":%.3f}",
                 i ? "," : "", escape(e.name).c_str(),
                 static_cast<long long>(pid), static_cast<long long>(e.tid),
                 e.start_ns / 1000.0, (e.end_ns - e.start_ns) / 1000.0);
  }
  std::fputs("]}", f);
  std::fclose(f);
  return static_cast<int64_t>(evs.size());
}

// -- workqueue --------------------------------------------------------------

PHT_API void* pht_wq_create(int32_t nthreads) {
  return new WorkQueue(nthreads);
}

PHT_API void pht_wq_destroy(void* wq) { delete static_cast<WorkQueue*>(wq); }

PHT_API void pht_wq_run_dag(void* wq, int32_t n, pht_task_fn fn, void* arg,
                            const int32_t* dep_counts, const int32_t* adj,
                            const int32_t* adj_offsets, int32_t with_trace) {
  if (n <= 0) return;
  static_cast<WorkQueue*>(wq)->run_dag(n, fn, arg, dep_counts, adj,
                                       adj_offsets, with_trace != 0);
}

// -- TCP store --------------------------------------------------------------

PHT_API void* pht_store_server_start(int32_t port) {
  auto* s = new StoreServer();
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

PHT_API int32_t pht_store_server_port(void* server) {
  return static_cast<StoreServer*>(server)->port;
}

PHT_API void pht_store_server_stop(void* server) {
  auto* s = static_cast<StoreServer*>(server);
  s->shutdown();
  delete s;
}

PHT_API void* pht_store_connect(const char* host, int32_t port,
                                int32_t timeout_ms) {
  auto* c = new StoreClient();
  if (!c->connect_to(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

PHT_API void pht_store_disconnect(void* client) {
  auto* c = static_cast<StoreClient*>(client);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

PHT_API int32_t pht_store_set(void* client, const char* key,
                              const uint8_t* val, int32_t vlen) {
  auto* c = static_cast<StoreClient*>(client);
  if (!c->send_key(kSet, key)) return -1;
  uint32_t n = static_cast<uint32_t>(vlen);
  if (!write_full(c->fd, &n, 4)) return -1;
  if (vlen && !write_full(c->fd, val, n)) return -1;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) && ok == 1 ? 0 : -1;
}

// Returns value length (copied into buf up to buflen), -1 on timeout,
// -2 on connection error. Blocks until the key exists (TCPStore wait+get).
PHT_API int32_t pht_store_get(void* client, const char* key, uint8_t* buf,
                              int32_t buflen, int64_t timeout_ms) {
  auto* c = static_cast<StoreClient*>(client);
  if (!c->send_key(kGet, key)) return -2;
  if (!write_full(c->fd, &timeout_ms, 8)) return -2;
  int32_t vlen;
  if (!read_full(c->fd, &vlen, 4)) return -2;
  if (vlen < 0) return -1;
  std::string val(static_cast<size_t>(vlen), '\0');
  if (vlen && !read_full(c->fd, &val[0], static_cast<size_t>(vlen))) return -2;
  if (buf && buflen > 0) {
    int32_t n = vlen < buflen ? vlen : buflen;
    std::memcpy(buf, val.data(), static_cast<size_t>(n));
  }
  return vlen;
}

PHT_API int64_t pht_store_add(void* client, const char* key, int64_t delta) {
  auto* c = static_cast<StoreClient*>(client);
  if (!c->send_key(kAdd, key)) return INT64_MIN;
  if (!write_full(c->fd, &delta, 8)) return INT64_MIN;
  int64_t result;
  if (!read_full(c->fd, &result, 8)) return INT64_MIN;
  return result;
}

PHT_API int32_t pht_store_check(void* client, const char* key) {
  auto* c = static_cast<StoreClient*>(client);
  if (!c->send_key(kCheck, key)) return -1;
  uint8_t present;
  if (!read_full(c->fd, &present, 1)) return -1;
  return present;
}

PHT_API int32_t pht_store_delete(void* client, const char* key) {
  auto* c = static_cast<StoreClient*>(client);
  if (!c->send_key(kDelete, key)) return -1;
  uint8_t erased;
  if (!read_full(c->fd, &erased, 1)) return -1;
  return erased;
}

// ---------------------------------------------------------------------------
// Buffered reader: staging ring for DataLoader batches
// (ref: paddle/fluid/operators/reader/buffered_reader.cc — double-buffered
//  host staging overlapping input pipeline with compute; here the staging
//  memcpy runs on C++ threads with the GIL released, and slots recycle to
//  avoid per-batch allocator churn.  A slot's buffer is reserved at
//  slot_bytes and keeps its address while a block fits: the port's
//  DataLoader page-locks it once and copies it to the card from there)
// ---------------------------------------------------------------------------

struct StagingRing {
  struct Slot {
    std::vector<char> buf;
    int64_t nbytes = 0;
    int64_t seq = -1;
  };
  std::vector<Slot> slots;
  std::deque<int32_t> free_slots;
  // ready queue ordered by sequence number so batches emit in order
  std::deque<int32_t> ready;
  std::mutex mu;
  std::condition_variable cv;
  bool closed = false;
  int64_t next_seq = 0;  // strict in-order delivery cursor

  explicit StagingRing(int32_t n, int64_t slot_bytes) : slots(n) {
    for (int32_t i = 0; i < n; i++) {
      slots[static_cast<size_t>(i)].buf.reserve(
          static_cast<size_t>(slot_bytes));
      free_slots.push_back(i);
    }
  }
};

PHT_API void* pht_reader_create(int32_t n_slots, int64_t slot_bytes) {
  if (n_slots < 2) n_slots = 2;
  return new StagingRing(n_slots, slot_bytes);
}

// Claim a free slot, copy `src` into it, enqueue as ready. Blocks while all
// slots are in flight (bounded prefetch). Returns slot id or -1 if closed.
PHT_API int32_t pht_reader_stage(void* ring, const void* src, int64_t nbytes,
                                 int64_t seq) {
  auto* r = static_cast<StagingRing*>(ring);
  int32_t idx;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [r] { return r->closed || !r->free_slots.empty(); });
    if (r->closed) return -1;
    idx = r->free_slots.front();
    r->free_slots.pop_front();
  }
  auto& slot = r->slots[static_cast<size_t>(idx)];
  slot.buf.resize(static_cast<size_t>(nbytes));
  std::memcpy(slot.buf.data(), src, static_cast<size_t>(nbytes));
  slot.nbytes = nbytes;
  slot.seq = seq;
  {
    std::lock_guard<std::mutex> g(r->mu);
    // insert keeping ready ordered by seq (workers may finish out of order)
    auto it = r->ready.begin();
    while (it != r->ready.end()
           && r->slots[static_cast<size_t>(*it)].seq < seq) ++it;
    r->ready.insert(it, idx);
  }
  r->cv.notify_all();
  return idx;
}

// Pop the next ready slot (lowest staged seq). Returns slot id, or -1 on
// timeout, -2 when closed and drained. *ptr/*nbytes describe the data.
PHT_API int32_t pht_reader_next(void* ring, void** ptr, int64_t* nbytes,
                                int64_t timeout_ms) {
  auto* r = static_cast<StagingRing*>(ring);
  std::unique_lock<std::mutex> lk(r->mu);
  // wait until the exact next sequence number is staged (producers may
  // finish out of order; delivery is strict FIFO by seq)
  bool ok = r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [r] {
    if (r->closed) return true;
    return !r->ready.empty()
        && r->slots[static_cast<size_t>(r->ready.front())].seq == r->next_seq;
  });
  if (!ok) return -1;
  if (r->ready.empty()
      || r->slots[static_cast<size_t>(r->ready.front())].seq != r->next_seq) {
    if (r->closed && r->ready.empty()) return -2;  // closed + drained
    if (r->closed) {
      // closed with a gap: emit what is there (best effort)
    } else {
      return -1;
    }
  }
  int32_t idx = r->ready.front();
  r->ready.pop_front();
  r->next_seq = r->slots[static_cast<size_t>(idx)].seq + 1;
  auto& slot = r->slots[static_cast<size_t>(idx)];
  *ptr = slot.buf.data();
  *nbytes = slot.nbytes;
  return idx;
}

PHT_API void pht_reader_release(void* ring, int32_t slot) {
  auto* r = static_cast<StagingRing*>(ring);
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->free_slots.push_back(slot);
  }
  r->cv.notify_all();
}

PHT_API void pht_reader_close(void* ring) {
  auto* r = static_cast<StagingRing*>(ring);
  {
    std::lock_guard<std::mutex> g(r->mu);
    r->closed = true;
  }
  r->cv.notify_all();
}

PHT_API void pht_reader_destroy(void* ring) {
  delete static_cast<StagingRing*>(ring);
}
