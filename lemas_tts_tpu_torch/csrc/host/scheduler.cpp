// scheduler: native micro-batching request queue for TTS serving.
//
// The reference serves one request at a time and rebuilds its model per
// Gradio request (inference_gradio.py:270-271, SURVEY.md §3.4). This runtime
// component implements the TPU-friendly alternative: a thread-safe queue
// that coalesces concurrent requests into shape-bucketed micro-batches, so a
// single jitted program instance serves many clients (batch is the TPU
// scaling axis, SURVEY.md §5 long-context note).
//
// C ABI via ctypes (lemas_tts_tpu/native/batcher.py). Pure standard C++17 —
// no external deps.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <vector>

#define API extern "C" __attribute__((visibility("default")))

namespace {

struct Request {
  uint64_t id;
  int64_t bucket;     // shape bucket key (e.g. padded duration)
  int64_t cost;       // weight against max_cost (e.g. frames)
  int64_t enqueue_us;
};

int64_t now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Batcher {
  std::mutex mu;
  std::condition_variable cv;
  std::map<int64_t, std::deque<Request>> queues;  // per-bucket FIFO
  std::atomic<uint64_t> next_id{1};
  int64_t max_batch;
  int64_t max_cost;       // max summed cost per batch (0 = unlimited)
  int64_t max_wait_us;    // flush deadline for a non-full batch
  std::atomic<int64_t> depth{0};
  std::atomic<bool> closed{false};
};

}  // namespace

API void* batcher_create(int64_t max_batch, int64_t max_cost,
                         int64_t max_wait_us) {
  auto* b = new Batcher();
  b->max_batch = max_batch > 0 ? max_batch : 1;
  b->max_cost = max_cost;
  b->max_wait_us = max_wait_us > 0 ? max_wait_us : 0;
  return b;
}

API void batcher_destroy(void* h) { delete static_cast<Batcher*>(h); }

API void batcher_close(void* h) {
  auto* b = static_cast<Batcher*>(h);
  b->closed.store(true);
  b->cv.notify_all();
}

API int64_t batcher_depth(void* h) {
  return static_cast<Batcher*>(h)->depth.load();
}

// Enqueue a request; returns its id (>0), or 0 if the batcher is closed.
API uint64_t batcher_submit(void* h, int64_t bucket, int64_t cost) {
  auto* b = static_cast<Batcher*>(h);
  if (b->closed.load()) return 0;
  Request r{b->next_id.fetch_add(1), bucket, cost > 0 ? cost : 1, now_us()};
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->queues[bucket].push_back(r);
    // inside the lock: a consumer could otherwise pop + fetch_sub before
    // this fetch_add, making depth() transiently negative (breaks the
    // engine's queue-full backpressure accounting)
    b->depth.fetch_add(1);
  }
  b->cv.notify_one();
  return r.id;
}

// Collect the next micro-batch. Picks the bucket whose head request has
// waited longest, then fills from that bucket only (one compiled program per
// batch). Blocks up to timeout_us for the first request; once one request is
// pending, waits at most max_wait_us past its enqueue for the batch to fill.
// Writes up to max_batch ids/buckets; returns count (0 = timeout/closed).
API int64_t batcher_next_batch(void* h, uint64_t* ids, int64_t* bucket_out,
                               int64_t timeout_us) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);

  auto has_work = [&] {
    for (auto& kv : b->queues)
      if (!kv.second.empty()) return true;
    return false;
  };

  if (!has_work()) {
    if (timeout_us <= 0 ||
        !b->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                        [&] { return has_work() || b->closed.load(); }))
      return 0;
    if (!has_work()) return 0;  // closed
  }

  // oldest head across buckets; sentinel when another consumer drained all
  constexpr int64_t kNoBucket = INT64_MIN;
  auto pick = [&]() -> int64_t {
    int64_t best_bucket = kNoBucket, best_ts = INT64_MAX;
    for (auto& kv : b->queues) {
      if (!kv.second.empty() && kv.second.front().enqueue_us < best_ts) {
        best_ts = kv.second.front().enqueue_us;
        best_bucket = kv.first;
      }
    }
    return best_bucket;
  };

  int64_t bucket = pick();
  if (bucket == kNoBucket) return 0;  // raced with another consumer
  // allow the chosen bucket to fill up to the flush deadline (tracked against
  // the CURRENT pick's head — an older bucket may appear while waiting)
  if (b->max_wait_us > 0) {
    while (!b->closed.load()) {
      auto& bq = b->queues[bucket];
      if (bq.empty()) {
        bucket = pick();
        if (bucket == kNoBucket) return 0;
        continue;
      }
      if (int64_t(bq.size()) >= b->max_batch) break;
      const int64_t deadline = bq.front().enqueue_us + b->max_wait_us;
      const int64_t remain = deadline - now_us();
      if (remain <= 0) break;
      b->cv.wait_for(lk, std::chrono::microseconds(remain));
      const int64_t repick = pick();
      if (repick != kNoBucket) bucket = repick;
    }
    if (bucket == kNoBucket || b->queues[bucket].empty()) return 0;
  }

  auto& q = b->queues[bucket];
  int64_t count = 0, cost = 0;
  while (!q.empty() && count < b->max_batch) {
    if (b->max_cost > 0 && count > 0 && cost + q.front().cost > b->max_cost)
      break;
    ids[count] = q.front().id;
    bucket_out[count] = bucket;
    cost += q.front().cost;
    q.pop_front();
    ++count;
  }
  b->depth.fetch_sub(count);
  return count;
}

// Remove a still-queued request by id (client disconnect / engine-side
// timeout). Returns 1 if found and removed, 0 if unknown or already
// collected into a batch — the engine's dispatch-time cancellation check
// covers that race.
API int64_t batcher_cancel(void* h, uint64_t id) {
  auto* b = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  for (auto& kv : b->queues) {
    auto& q = kv.second;
    for (auto it = q.begin(); it != q.end(); ++it) {
      if (it->id == id) {
        q.erase(it);
        b->depth.fetch_sub(1);
        return 1;
      }
    }
  }
  return 0;
}

API const char* batcher_version() { return "scheduler 1.1 (lemas-tts-tpu)"; }
