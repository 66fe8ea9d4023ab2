// Native serving tier: request coalescing queue + TCP predict front.
//
// A copy of the JAX package's csrc/serving_queue.cpp, kept in the port so
// that the port builds nothing from the JAX package; only these comments
// differ. It is built with g++ by utils/native.py.
//
// Analogue of the reference's C++ inference runtime
// (torchrec/inference/src/BatchingQueue.cpp:56-246 — deadline+size
// request coalescing into fixed batches; src/Batching.cpp — per-feature
// concat into contiguous forward args; src/ResultSplit.cpp — demuxing
// the combined prediction back per request; server.cpp:1-290 — the RPC
// front feeding the queue; protos/predictor.proto — the wire contract).
//
// Redesigned rather than translated:
//   * ONE static server batch size B: partial batches are padded by
//     repeating example 0 (the reference re-batches to variable combined
//     sizes), so the predict program sees one shape.
//   * the executor is the Python process: Python blocks in
//     srv_next_batch() (ctypes releases the GIL), receives the
//     coalesced dense [B,D] / ids [F,B,L] buffers, runs the predict
//     module, and posts the [B, R] predictions back via srv_complete();
//     this file owns queuing, collation (including the per-feature
//     transpose the device layout wants), padding, demux, and the wire
//     front. Equivalent division of labor to
//     BatchingQueue(+MemPinner) -> GPUExecutor -> ResultSplit.
//   * wire front: a length-prefixed binary TCP protocol (the image has
//     no gRPC runtime): request frame
//       [u32 magic 'TRS1'][u32 n][n*D f32 dense][F*n*L i32 ids]
//     response frame
//       [u32 n][n*R f32 preds]            on success
//       [u32 0xFFFFFFFF][u32 len][msg]    on error
//     One connection handler thread per client, blocking sockets.
//
// Build: g++ -O3 -shared -fPIC -pthread (utils/native.py).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Request {
  int64_t id = -1;
  int n = 0;                    // examples contributed
  bool notify_done = false;     // resolved via the completion queue
  std::vector<float> dense;     // [n, D]
  std::vector<int32_t> ids;     // [F, n, L]
  Clock::time_point t_enqueue;

  // result state
  enum State { PENDING, DONE, ERRORED, CANCELLED } state = PENDING;
  std::vector<float> result;    // [n, R] when DONE
  std::string error;
};

struct BatchEntry {
  int64_t req_id;
  int offset;  // example offset in the server batch
  int n;
};

struct Server {
  // config
  int B, D, F, L, R;
  int64_t max_latency_us;
  int max_pending;

  std::mutex mu;
  std::condition_variable cv_submit;   // waking the batch-taker
  std::condition_variable cv_result;   // waking request waiters
  std::condition_variable cv_done;     // waking the completion-queue drain
  std::deque<int64_t> done_queue;      // resolved notify_done requests
  std::deque<Request*> queue;          // pending, FIFO
  std::unordered_map<int64_t, Request*> live;  // all not-yet-reaped
  std::unordered_map<int64_t, std::vector<BatchEntry>> inflight;
  int64_t next_req_id = 0;
  int64_t next_batch_id = 0;
  bool stopped = false;

  // TCP front
  int listen_fd = -1;
  std::thread listener;
  std::mutex conn_mu;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // open handler sockets, for stop()
};

Server* S(void* h) { return static_cast<Server*>(h); }

void reap_locked(Server* s, Request* r) {
  s->live.erase(r->id);
  delete r;
}

}  // namespace

extern "C" {

void* srv_create(int batch_size, int dense_dim, int num_feats, int L,
                 int result_dim, int64_t max_latency_us, int max_pending) {
  if (batch_size <= 0 || dense_dim < 0 || num_feats <= 0 || L <= 0 ||
      result_dim <= 0 || max_pending <= 0) {
    return nullptr;
  }
  auto* s = new Server();
  s->B = batch_size;
  s->D = dense_dim;
  s->F = num_feats;
  s->L = L;
  s->R = result_dim;
  s->max_latency_us = max_latency_us;
  s->max_pending = max_pending;
  return s;
}

// Enqueue a request of n examples. dense is [n, D] f32 (may be null when
// D == 0), ids is [F, n, L] i32. notify_done=1 resolves the request via
// the completion queue (srv_next_done/srv_collect, one drain thread);
// notify_done=0 resolves via a blocking srv_wait (one waiter per
// request, the TCP handler mode). Returns the request id (>= 0), or
// -1 stopped, -2 bad n, -3 queue full.
int64_t srv_submit(void* h, int n, const float* dense, const int32_t* ids,
                   int notify_done) {
  Server* s = S(h);
  if (n <= 0 || n > s->B) return -2;
  if (s->D > 0 && !dense) return -2;
  auto* r = new Request();
  r->n = n;
  r->notify_done = notify_done != 0;
  if (s->D > 0) {
    r->dense.assign(dense, dense + (size_t)n * s->D);
  }
  r->ids.assign(ids, ids + (size_t)s->F * n * s->L);
  r->t_enqueue = Clock::now();
  int64_t rid;
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->stopped) {
      delete r;
      return -1;
    }
    if ((int)s->queue.size() >= s->max_pending) {
      delete r;
      return -3;
    }
    r->id = s->next_req_id++;
    rid = r->id;
    s->queue.push_back(r);
    s->live.emplace(r->id, r);
    // r must not be touched after this scope: once the lock drops, the
    // executor can batch, complete, and REAP it before we resume
    // (observed: reading r->id after unlock returned a reused heap
    // slot's garbage, orphaning the client's future)
  }
  s->cv_submit.notify_one();
  return rid;
}

// Blocking batch take + collation. Waits until >= B examples are pending
// or the oldest pending request ages past max_latency_us, then pops a
// FIFO prefix fitting B examples and writes the coalesced batch:
//   dense_out [B, D] f32, ids_out [F, B, L] i32 (pad tail = example 0).
// Returns the number of requests in the batch and sets *batch_id_out;
// returns 0 when the server is stopped and drained (buffers untouched),
// or -1 when wait_budget_us (>= 0) elapses with no batch ready — the
// double-buffered executor passes a bounded budget while a dispatched
// batch is still unfetched, so its results are never held hostage to
// future traffic. wait_budget_us < 0 waits indefinitely.
int srv_next_batch(void* h, float* dense_out, int32_t* ids_out,
                   int64_t* batch_id_out, int64_t wait_budget_us) {
  Server* s = S(h);
  std::vector<Request*> batch;
  int64_t batch_id;
  const bool bounded = wait_budget_us >= 0;
  const auto budget_end =
      Clock::now() + std::chrono::microseconds(
                         bounded ? wait_budget_us : 0);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    for (;;) {
      if (s->stopped && s->queue.empty()) return 0;
      int total = 0;
      for (auto* r : s->queue) total += r->n;
      if (total >= s->B || s->stopped) break;
      auto wake = Clock::time_point::max();
      if (!s->queue.empty()) {
        wake = s->queue.front()->t_enqueue +
               std::chrono::microseconds(s->max_latency_us);
        if (Clock::now() >= wake) break;
      }
      if (bounded) {
        if (Clock::now() >= budget_end) return -1;
        wake = std::min(wake, budget_end);
      }
      if (wake == Clock::time_point::max()) {
        s->cv_submit.wait(lk);
      } else {
        s->cv_submit.wait_until(lk, wake);
      }
    }
    int used = 0;
    while (!s->queue.empty() && used + s->queue.front()->n <= s->B) {
      batch.push_back(s->queue.front());
      used += s->queue.front()->n;
      s->queue.pop_front();
    }
    if (batch.empty()) {
      // front request alone exceeds remaining space: cannot happen
      // (submit bounds n <= B), but guard against a spurious wake
      return srv_next_batch(h, dense_out, ids_out, batch_id_out,
                            wait_budget_us);
    }
    batch_id = s->next_batch_id++;
    auto& entries = s->inflight[batch_id];
    int off = 0;
    for (auto* r : batch) {
      entries.push_back({r->id, off, r->n});
      off += r->n;
    }
  }

  // collate outside the lock: each request's examples are copied to its
  // offset; ids transpose [F, n, L] -> per-feature rows of [F, B, L]
  int off = 0;
  for (auto* r : batch) {
    if (s->D > 0) {
      std::memcpy(dense_out + (size_t)off * s->D, r->dense.data(),
                  sizeof(float) * (size_t)r->n * s->D);
    }
    for (int f = 0; f < s->F; ++f) {
      std::memcpy(ids_out + ((size_t)f * s->B + off) * s->L,
                  r->ids.data() + ((size_t)f * r->n) * s->L,
                  sizeof(int32_t) * (size_t)r->n * s->L);
    }
    off += r->n;
  }
  // pad tail with example 0 (results discarded by demux)
  for (int b = off; b < s->B; ++b) {
    if (s->D > 0) {
      std::memcpy(dense_out + (size_t)b * s->D, dense_out,
                  sizeof(float) * s->D);
    }
    for (int f = 0; f < s->F; ++f) {
      std::memcpy(ids_out + ((size_t)f * s->B + b) * s->L,
                  ids_out + (size_t)f * s->B * s->L,
                  sizeof(int32_t) * s->L);
    }
  }
  *batch_id_out = batch_id;
  return (int)batch.size();
}

// Post the executor's predictions for a batch: preds is [B, R] f32.
// Demuxes preds[offset:offset+n] to each request. Returns the number of
// requests completed, or -1 for an unknown batch id.
int srv_complete(void* h, int64_t batch_id, const float* preds) {
  Server* s = S(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->inflight.find(batch_id);
  if (it == s->inflight.end()) return -1;
  int done = 0;
  for (const auto& e : it->second) {
    auto lit = s->live.find(e.req_id);
    if (lit == s->live.end()) continue;  // waiter gave up and reaped
    Request* r = lit->second;
    if (r->state == Request::CANCELLED) {
      reap_locked(s, r);
      continue;
    }
    r->result.assign(preds + (size_t)e.offset * s->R,
                     preds + (size_t)(e.offset + e.n) * s->R);
    r->state = Request::DONE;
    if (r->notify_done) s->done_queue.push_back(r->id);
    ++done;
  }
  s->inflight.erase(it);
  s->cv_result.notify_all();
  s->cv_done.notify_all();
  return done;
}

// Mark every request of a batch errored (executor exception path).
int srv_fail_batch(void* h, int64_t batch_id, const char* msg) {
  Server* s = S(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->inflight.find(batch_id);
  if (it == s->inflight.end()) return -1;
  for (const auto& e : it->second) {
    auto lit = s->live.find(e.req_id);
    if (lit == s->live.end()) continue;
    Request* r = lit->second;
    if (r->state == Request::CANCELLED) {
      reap_locked(s, r);
      continue;
    }
    r->state = Request::ERRORED;
    r->error = msg ? msg : "executor error";
    if (r->notify_done) s->done_queue.push_back(r->id);
  }
  s->inflight.erase(it);
  s->cv_result.notify_all();
  s->cv_done.notify_all();
  return 0;
}

// Completion-queue drain (one thread): block until a notify_done request
// resolves; returns 1 and sets *rid_out/*n_out, or 0 when the server is
// stopped and the queue is drained.
int srv_next_done(void* h, int64_t* rid_out, int* n_out) {
  Server* s = S(h);
  std::unique_lock<std::mutex> lk(s->mu);
  for (;;) {
    while (!s->done_queue.empty()) {
      int64_t rid = s->done_queue.front();
      s->done_queue.pop_front();
      auto lit = s->live.find(rid);
      if (lit == s->live.end()) continue;  // cancelled + reaped
      *rid_out = rid;
      *n_out = lit->second->n;
      return 1;
    }
    // only exit once nothing can resolve anymore: batches in flight at
    // stop time still complete (the executor drains before exiting)
    if (s->stopped && s->inflight.empty() && s->queue.empty()) return 0;
    s->cv_done.wait(lk);
  }
}

// Fetch a resolved request's result ([n, R] into out) and reap it.
// Returns n, or -2 errored (message via err_out, reaped), -3 unknown,
// -4 not resolved yet (use only on ids from srv_next_done).
int srv_collect(void* h, int64_t req_id, float* out, char* err_out,
                int err_cap) {
  Server* s = S(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto lit = s->live.find(req_id);
  if (lit == s->live.end()) return -3;
  Request* r = lit->second;
  if (r->state == Request::PENDING) return -4;
  if (r->state != Request::DONE) {
    if (err_out && err_cap > 0) {
      std::strncpy(err_out, r->error.c_str(), err_cap - 1);
      err_out[err_cap - 1] = '\0';
    }
    reap_locked(s, r);
    return -2;
  }
  int n = r->n;
  std::memcpy(out, r->result.data(), sizeof(float) * (size_t)n * s->R);
  reap_locked(s, r);
  return n;
}

// Wait for a request's result; out must hold n*R floats. Returns the
// number of examples written, -1 on timeout (request stays live; call
// again or srv_cancel), -2 if the request errored (error text via
// srv_last_error), -3 unknown id. The request is reaped on any
// non-timeout return.
int srv_wait(void* h, int64_t req_id, float* out, int64_t timeout_us,
             char* err_out, int err_cap) {
  Server* s = S(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto lit = s->live.find(req_id);
  if (lit == s->live.end()) return -3;
  Request* r = lit->second;
  auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
  while (r->state == Request::PENDING) {
    if (s->cv_result.wait_until(lk, deadline) == std::cv_status::timeout &&
        r->state == Request::PENDING) {
      return -1;
    }
  }
  if (r->state == Request::ERRORED) {
    if (err_out && err_cap > 0) {
      std::strncpy(err_out, r->error.c_str(), err_cap - 1);
      err_out[err_cap - 1] = '\0';
    }
    reap_locked(s, r);
    return -2;
  }
  int n = r->n;
  std::memcpy(out, r->result.data(), sizeof(float) * (size_t)n * s->R);
  reap_locked(s, r);
  return n;
}

// Abandon a request: if still queued it is dropped; if in flight its
// result is discarded when the batch completes.
int srv_cancel(void* h, int64_t req_id) {
  Server* s = S(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto lit = s->live.find(req_id);
  if (lit == s->live.end()) return -3;
  Request* r = lit->second;
  for (auto qit = s->queue.begin(); qit != s->queue.end(); ++qit) {
    if (*qit == r) {
      s->queue.erase(qit);
      reap_locked(s, r);
      return 0;
    }
  }
  if (r->state == Request::PENDING) {
    r->state = Request::CANCELLED;  // in flight: reaped by complete/fail
  } else {
    // result/error already landed (its batch left `inflight`): nothing
    // will visit this request again — reap it here or it leaks in live
    reap_locked(s, r);
  }
  return 0;
}

int srv_pending(void* h) {
  Server* s = S(h);
  std::lock_guard<std::mutex> g(s->mu);
  int total = 0;
  for (auto* r : s->queue) total += r->n;
  return total;
}

// ---------------------------------------------------------------------
// TCP front (server.cpp role). Blocking sockets, one handler thread per
// connection; each connection serves framed requests sequentially.
// ---------------------------------------------------------------------

namespace {

constexpr uint32_t kMagic = 0x54525331;  // 'TRS1'
constexpr uint32_t kErrTag = 0xFFFFFFFFu;

bool read_full(int fd, void* buf, size_t len) {
  auto* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t k = ::recv(fd, p, len, 0);
    if (k <= 0) return false;
    p += k;
    len -= (size_t)k;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t len) {
  auto* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t k = ::send(fd, p, len, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    len -= (size_t)k;
  }
  return true;
}

bool send_err(int fd, const std::string& msg) {
  uint32_t hdr[2] = {kErrTag, (uint32_t)msg.size()};
  return write_full(fd, hdr, sizeof(hdr)) &&
         write_full(fd, msg.data(), msg.size());
}

void handle_conn(Server* s, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<float> dense;
  std::vector<int32_t> ids;
  std::vector<float> out;
  for (;;) {
    uint32_t hdr[2];
    if (!read_full(fd, hdr, sizeof(hdr))) break;
    if (hdr[0] != kMagic) {
      send_err(fd, "bad magic");
      break;
    }
    int n = (int)hdr[1];
    if (n <= 0 || n > s->B) {
      // can't trust the framing past a bad size: answer and drop
      send_err(fd, "batch size out of range");
      break;
    }
    dense.resize((size_t)n * s->D);
    ids.resize((size_t)s->F * n * s->L);
    if (s->D > 0 &&
        !read_full(fd, dense.data(), dense.size() * sizeof(float))) {
      break;
    }
    if (!read_full(fd, ids.data(), ids.size() * sizeof(int32_t))) break;
    int64_t rid = srv_submit(s, n, s->D > 0 ? dense.data() : nullptr,
                             ids.data(), /*notify_done=*/0);
    if (rid < 0) {
      if (!send_err(fd, rid == -3 ? "queue full" : "server stopped")) break;
      continue;
    }
    out.resize((size_t)n * s->R);
    char err[256] = {0};
    int got = srv_wait(s, rid, out.data(), 60'000'000, err, sizeof(err));
    if (got < 0) {
      if (got == -1) srv_cancel(s, rid);  // timeout: request still live
      if (!send_err(fd, got == -2 ? err : "predict timeout")) break;
      continue;
    }
    uint32_t rh = (uint32_t)got;
    if (!write_full(fd, &rh, sizeof(rh)) ||
        !write_full(fd, out.data(), (size_t)got * s->R * sizeof(float))) {
      break;
    }
  }
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    for (auto it = s->conn_fds.begin(); it != s->conn_fds.end(); ++it) {
      if (*it == fd) {
        s->conn_fds.erase(it);
        break;
      }
    }
  }
  ::close(fd);
}

}  // namespace

// Start the TCP listener on `port` (0 = ephemeral). Returns the bound
// port, or -1 on error. Stops (listener + handlers joined) via srv_stop.
int srv_serve_tcp(void* h, int port) {
  Server* s = S(h);
  if (s->listener.joinable()) return -2;  // one listener per server
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, (sockaddr*)&addr, &alen);
  s->listen_fd = fd;
  s->listener = std::thread([s, fd] {
    for (;;) {
      int cfd = ::accept(fd, nullptr, nullptr);
      if (cfd < 0) return;  // listener closed by srv_stop
      std::lock_guard<std::mutex> g(s->conn_mu);
      s->conn_fds.push_back(cfd);
      s->conns.emplace_back([s, cfd] { handle_conn(s, cfd); });
    }
  });
  return ntohs(addr.sin_port);
}

// Stop accepting + wake every waiter. Queued-but-unbatched requests are
// failed; the executor's srv_next_batch returns 0 once drained.
void srv_stop(void* h) {
  Server* s = S(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->stopped) return;
    s->stopped = true;
    for (auto* r : s->queue) {
      r->state = Request::ERRORED;
      r->error = "server stopped";
      if (r->notify_done) s->done_queue.push_back(r->id);
    }
    s->queue.clear();
  }
  s->cv_submit.notify_all();
  s->cv_result.notify_all();
  s->cv_done.notify_all();
  if (s->listen_fd >= 0) {
    ::shutdown(s->listen_fd, SHUT_RDWR);
    ::close(s->listen_fd);
    s->listen_fd = -1;
  }
  if (s->listener.joinable()) s->listener.join();
  std::vector<std::thread> conns;
  {
    std::lock_guard<std::mutex> g(s->conn_mu);
    conns.swap(s->conns);
    // unblock handlers parked in recv() on idle client connections —
    // without this, joining below deadlocks while any client stays open
    for (int fd : s->conn_fds) ::shutdown(fd, SHUT_RDWR);
    s->conn_fds.clear();
  }
  for (auto& t : conns) {
    if (t.joinable()) t.join();
  }
}

void srv_destroy(void* h) {
  Server* s = S(h);
  srv_stop(h);
  {
    // scope the guard: deleting s while it holds s->mu would destroy a
    // locked mutex and then unlock freed memory
    std::lock_guard<std::mutex> g(s->mu);
    for (auto& [_, r] : s->live) delete r;
    s->live.clear();
  }
  delete s;
}

}  // extern "C"
