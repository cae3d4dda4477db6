// Paged-KV page allocator + continuous-batching scheduler (C ABI).
//
// The PyTorch port's own copy of native/kv_runtime.cpp (the JAX package's
// scheduler), with the same logic so that both packages admit, grow and
// preempt requests alike; it emits the (block_table, seq_lens,
// positions) arrays of clusterfusion_tpu_torch/ops/paged_decoder_layer.py.
//
// The native runtime layer of the framework: the reference ships its paged
// batch-decode kernel for an external runner (SGLang) and leaves page
// bookkeeping to it — the per-request page lists arrive as
// paged_kv_indptr/indices and per-layer device pointer tables
// (reference: include/H100/llama/kernel_batch_sglang.cuh:118-123,
// README.md:55-76).  Here the framework owns that runtime: this module
// manages the page pool and request admission on the host in C++.
//
// Design:
// - Fixed pool of `num_pages` pages of `page_size` tokens; free pages kept
//   in a LIFO free list (O(1) alloc/free, good page locality for recently
//   freed pages).
// - Page 0 is reserved as the NULL page: batch rows are padded to a fixed
//   max_batch for jit shape stability, and padding rows carry an all-zero
//   block table — their (masked, seq_len=0) writes land in page 0, which is
//   never allocated to a request.
// - Requests: add(prompt_len) -> pending queue; prepare_batch() admits
//   pending requests FCFS while pages suffice, grows active requests across
//   page boundaries, and fills caller-provided output arrays.
//   commit_batch() advances lengths after the device step; release() frees
//   pages (on completion or cancellation).
// - Single-threaded by design: the Python engine drives it from one thread
//   and ctypes holds the GIL across these sub-microsecond calls.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  int64_t id = 0;
  int32_t len = 0;          // tokens currently cached (prompt + generated)
  std::vector<int32_t> pages;
  bool active = false;      // admitted into the running batch
};

struct Pool {
  int32_t page_size = 0;
  int32_t num_pages = 0;
  int32_t max_pages_per_req = 0;
  // Rolling-buffer mode (sliding-window attention): cap the REAL pages a
  // request owns at `window_pages`; block-table slots below the window
  // hold the NULL page (0) and their reads are masked out by the decode
  // kernels.  0 = off (full-context).  Recycling moves a page id from the
  // slot that just fell out of the window to the new tail slot — the old
  // slot's positions are provably below every future query's window
  // before the first overwrite lands (window <= (window_pages-1)*page+1).
  int32_t window_pages = 0;
  std::vector<int32_t> free_list;              // LIFO
  std::unordered_map<int64_t, Request> requests;
  std::deque<int64_t> pending;                 // FCFS admission queue
  std::vector<int64_t> running;                // admission order
  std::vector<int64_t> last_batch;             // rows of the last prepare

  int32_t free_pages() const {
    return static_cast<int32_t>(free_list.size());
  }

  bool alloc_pages(Request& r, int32_t n) {
    if (static_cast<int32_t>(free_list.size()) < n) return false;
    if (static_cast<int32_t>(r.pages.size()) + n > max_pages_per_req)
      return false;
    for (int32_t i = 0; i < n; ++i) {
      r.pages.push_back(free_list.back());
      free_list.pop_back();
    }
    return true;
  }

  // Append one table slot, recycling the page that fell out of the window
  // when rolling-buffer mode is on.  Returns false only when a fresh page
  // is needed and the pool is exhausted (or the slot cap is hit).
  bool grow_slot(Request& r) {
    int32_t j = static_cast<int32_t>(r.pages.size());
    if (j >= max_pages_per_req) return false;
    if (window_pages > 0 && j >= window_pages && r.pages[j - window_pages]) {
      r.pages.push_back(r.pages[j - window_pages]);
      r.pages[j - window_pages] = 0;            // NULL: masked, never read
      return true;
    }
    if (free_list.empty()) return false;
    r.pages.push_back(free_list.back());
    free_list.pop_back();
    return true;
  }

  // Admission allocation: `need` table slots, of which only the last
  // min(need, window_pages) hold real pages in rolling-buffer mode (the
  // prompt's below-window KV is never read — the prefill scatter's writes
  // to the NULL page are harmless by design).
  bool alloc_for_admission(Request& r, int32_t need) {
    int32_t realn = (window_pages > 0 && need > window_pages)
        ? window_pages : need;
    if (free_pages() < realn) return false;
    if (need > max_pages_per_req) return false;
    for (int32_t i = 0; i < need - realn; ++i) r.pages.push_back(0);
    return alloc_pages(r, realn);
  }

  int32_t admission_cost(int32_t need) const {
    return (window_pages > 0 && need > window_pages) ? window_pages : need;
  }

  void free_request(Request& r) {
    // NULL-page slots (rolling-buffer below-window placeholders) are not
    // pool pages; each real id appears in exactly one slot
    for (int32_t p : r.pages)
      if (p != 0) free_list.push_back(p);
    r.pages.clear();
  }
};

int32_t pages_needed(const Pool& pool, int32_t tokens) {
  // pages to hold `tokens` cached tokens plus the tail slot the decode
  // kernel writes the next token into
  return (tokens + 1 + pool.page_size - 1) / pool.page_size;
}

}  // namespace

extern "C" {

void* cf_pool_create(int32_t num_pages, int32_t page_size,
                     int32_t max_pages_per_req) {
  if (num_pages < 2 || page_size < 1 || max_pages_per_req < 1) return nullptr;
  auto* pool = new Pool();
  pool->page_size = page_size;
  pool->num_pages = num_pages;
  pool->max_pages_per_req = max_pages_per_req;
  pool->free_list.reserve(num_pages - 1);
  // page 0 reserved as the NULL page; LIFO pops from the back, so pushing
  // descending hands out page 1 first
  for (int32_t p = num_pages - 1; p >= 1; --p) pool->free_list.push_back(p);
  return pool;
}

void cf_pool_destroy(void* handle) {
  delete static_cast<Pool*>(handle);
}

int32_t cf_pool_free_pages(void* handle) {
  return static_cast<Pool*>(handle)->free_pages();
}

// Rolling-buffer mode for sliding-window attention: cap each request's
// REAL pages at `window_pages` (ceil(window/page_size)+1 covers every
// in-window position while the tail page fills).  0 disables.  Returns 0,
// or -1 on bad args / requests already present.
// Rolling-buffer page cap.  C API CONTRACT: the caller must guarantee the
// attention window (tokens) satisfies
//     window <= (window_pages - 1) * page_size + 1
// — i.e. window_pages >= ceil(window / page_size) + 1.  A smaller cap makes
// grow_slot recycle a page that still holds in-window KV, silently
// corrupting attention; this layer cannot check it (it never learns the
// token window).  The Python wrapper (runtime/native.py set_window) derives
// the cap from the token window and enforces the invariant — use that.
// window_pages == 0 disables the cap.  Fails (-1) once requests exist.
int32_t cf_pool_set_window(void* handle, int32_t window_pages) {
  auto* pool = static_cast<Pool*>(handle);
  if (window_pages < 0 || !pool->requests.empty()) return -1;
  pool->window_pages = window_pages;
  return 0;
}

int32_t cf_pool_num_requests(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  return static_cast<int32_t>(pool->requests.size());
}

// Queue a request whose prompt (prompt_len tokens) has been prefilled (or
// will be, once prepare_batch admits it and reports its pages).
// Returns 0 on success, -1 on duplicate id / bad args, -2 if the prompt
// can never fit (needs more than max_pages_per_req pages).
int32_t cf_request_add(void* handle, int64_t req_id, int32_t prompt_len) {
  auto* pool = static_cast<Pool*>(handle);
  if (prompt_len < 0) return -1;
  if (pool->requests.count(req_id)) return -1;
  if (pages_needed(*pool, prompt_len) > pool->max_pages_per_req) return -2;
  Request r;
  r.id = req_id;
  r.len = prompt_len;
  pool->requests.emplace(req_id, std::move(r));
  pool->pending.push_back(req_id);
  return 0;
}

// Free a request's pages and forget it.  Returns 0, or -1 if unknown.
int32_t cf_request_release(void* handle, int64_t req_id) {
  auto* pool = static_cast<Pool*>(handle);
  auto it = pool->requests.find(req_id);
  if (it == pool->requests.end()) return -1;
  pool->free_request(it->second);
  pool->requests.erase(it);
  for (auto q = pool->pending.begin(); q != pool->pending.end(); ++q) {
    if (*q == req_id) { pool->pending.erase(q); break; }
  }
  for (auto q = pool->running.begin(); q != pool->running.end(); ++q) {
    if (*q == req_id) { pool->running.erase(q); break; }
  }
  return 0;
}

int32_t cf_request_len(void* handle, int64_t req_id) {
  auto* pool = static_cast<Pool*>(handle);
  auto it = pool->requests.find(req_id);
  return it == pool->requests.end() ? -1 : it->second.len;
}

// Number of pages owned by a request; fills page ids into pages_out (caller
// provides space for max_pages_per_req entries).  Used by the engine to
// scatter prefill KV into the pool.  Returns the count, or -1.
int32_t cf_request_pages(void* handle, int64_t req_id, int32_t* pages_out) {
  auto* pool = static_cast<Pool*>(handle);
  auto it = pool->requests.find(req_id);
  if (it == pool->requests.end()) return -1;
  const auto& pages = it->second.pages;
  std::memcpy(pages_out, pages.data(), pages.size() * sizeof(int32_t));
  return static_cast<int32_t>(pages.size());
}

// Build the next decode batch:
// - admit pending requests FCFS while their full prompt page needs fit
//   (no partial admission; head-of-line blocking keeps FCFS fairness);
// - grow every running request that is about to cross a page boundary;
//   requests that cannot grow (pool exhausted) are preempted back to the
//   head of the pending queue with pages freed (their KV must be
//   re-prefilled on re-admission — the standard vLLM-style recompute
//   preemption policy);
// - fill, for row b = 0..B-1:
//     req_ids_out[b], seq_lens_out[b] (cached tokens), positions_out[b]
//     (== seq_lens: rope position of the token being decoded),
//     block_table_out[b * max_pages_per_req + j] (padded with page 0),
//     newly_admitted_out[b] (1 if this row still needs its prompt KV
//     scattered into the pool by the caller).
// Returns B (possibly 0), or -1 on bad args.
int32_t cf_prepare_batch(void* handle, int32_t max_batch,
                         int64_t* req_ids_out, int32_t* block_table_out,
                         int32_t* seq_lens_out, int32_t* positions_out,
                         int32_t* newly_admitted_out) {
  auto* pool = static_cast<Pool*>(handle);
  if (max_batch < 1) return -1;

  std::vector<int64_t> newly;
  // 1. grow running requests in admission order, so when the pool is tight
  //    the oldest requests take pages first and the *newest* fail and get
  //    preempted (FCFS fairness under memory pressure)
  std::vector<int64_t> preempted;
  for (int64_t id : pool->running) {
    Request& r = pool->requests.at(id);
    int32_t need = pages_needed(*pool, r.len);
    bool ok = true;
    while (static_cast<int32_t>(r.pages.size()) < need && ok)
      ok = pool->grow_slot(r);
    if (!ok) preempted.push_back(id);
  }
  for (int64_t id : preempted) {
    Request& r = pool->requests.at(id);
    pool->free_request(r);
    r.active = false;
    for (auto q = pool->running.begin(); q != pool->running.end(); ++q) {
      if (*q == id) { pool->running.erase(q); break; }
    }
    pool->pending.push_front(id);
  }

  // 2. admit pending FCFS while the batch has room and pages suffice
  while (!pool->pending.empty() &&
         static_cast<int32_t>(pool->running.size()) < max_batch) {
    int64_t id = pool->pending.front();
    Request& r = pool->requests.at(id);
    int32_t need = pages_needed(*pool, r.len);
    if (need > pool->max_pages_per_req) {
      // can only happen to a request preempted after growing to the cap;
      // it can never be decoded again — drop it (the engine notices via
      // cf_request_len == -1).  Engines should finish requests at
      // max_pages_per_req*page_size - 1 tokens so this is unreachable.
      pool->pending.pop_front();
      pool->requests.erase(id);
      continue;
    }
    if (pool->admission_cost(need) > pool->free_pages())
      break;                               // FCFS: no skip-ahead
    pool->alloc_for_admission(r, need);
    r.active = true;
    pool->pending.pop_front();
    pool->running.push_back(id);
    newly.push_back(id);
  }

  // 3. emit batch rows in admission order
  int32_t B = static_cast<int32_t>(pool->running.size());
  if (B > max_batch) B = max_batch;
  pool->last_batch.assign(pool->running.begin(), pool->running.begin() + B);
  for (int32_t b = 0; b < B; ++b) {
    const Request& r = pool->requests.at(pool->running[b]);
    req_ids_out[b] = r.id;
    seq_lens_out[b] = r.len;
    positions_out[b] = r.len;
    int32_t* row = block_table_out + b * pool->max_pages_per_req;
    std::memset(row, 0, pool->max_pages_per_req * sizeof(int32_t));
    std::memcpy(row, r.pages.data(), r.pages.size() * sizeof(int32_t));
    newly_admitted_out[b] = 0;
    for (int64_t id : newly)
      if (id == r.id) newly_admitted_out[b] = 1;
  }
  return B;
}

// After the device decode step for the last prepared batch: every row's
// request gains one cached token.  Returns 0, or -1 if no batch pending.
int32_t cf_commit_batch(void* handle) {
  auto* pool = static_cast<Pool*>(handle);
  if (pool->last_batch.empty()) return -1;
  for (int64_t id : pool->last_batch) {
    auto it = pool->requests.find(id);
    if (it != pool->requests.end()) it->second.len += 1;
  }
  pool->last_batch.clear();
  return 0;
}

// Abandon the last prepared batch without advancing lengths (e.g. a freshly
// admitted request finished at prefill and the engine must rebuild the
// batch).  Page allocations made during prepare stay valid.
int32_t cf_discard_batch(void* handle) {
  static_cast<Pool*>(handle)->last_batch.clear();
  return 0;
}

}  // extern "C"
