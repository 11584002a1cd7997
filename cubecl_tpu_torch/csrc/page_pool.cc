// Page pool: the host-side KV block manager of paged serving (which
// physical page of the device pools each sequence owns). Plain C++17 with
// a C interface, built by g++ at first use (utils/native.py:page_pool) and
// bound with ctypes by runtime/pages.py. Counterpart of the page_pool_*
// functions of cubecl_tpu/csrc/native.cc, with the same semantics, so
// that the same calls give the same page ids:
//
// - a fixed pool of num_pages page ids into the device pools
//   (L, Hkv, P, page, D), handed out from a free stack (lowest id first);
// - per-sequence ordered page lists, grown one page at a time;
// - fork() shares all pages by refcount (beam search, parallel sampling);
//   unshare_last() gives a branch a private copy of a shared last page;
// - automatic prefix caching: full pages registered under a chain hash
//   survive release on an evictable FIFO until pool pressure reclaims
//   them, and admit_cached() attaches the longest cached prefix.
//
// Every call takes one mutex: one serving thread drives a pool.
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct PagePool {
  std::vector<int32_t> free_list;  // stack of free page ids
  std::vector<int32_t> refcount;   // per page
  std::unordered_map<int64_t, std::vector<int32_t>> seqs;
  std::vector<uint64_t> page_hash;  // 0 = unregistered
  std::unordered_map<uint64_t, int32_t> prefix_map;
  std::vector<int32_t> evictable;  // refcount-0 cached pages, oldest first
  bool alive = false;
};

std::mutex g_mu;
std::vector<PagePool> g_pools;

PagePool* pool_of(int64_t h) {
  if (h < 0 || (size_t)h >= g_pools.size() || !g_pools[(size_t)h].alive)
    return nullptr;
  return &g_pools[(size_t)h];
}

// a free page, else the oldest cached one (its hash forgotten); -1 when
// the pool is exhausted. The caller holds the lock.
int32_t take_page(PagePool* p) {
  if (!p->free_list.empty()) {
    const int32_t pg = p->free_list.back();
    p->free_list.pop_back();
    return pg;
  }
  if (!p->evictable.empty()) {
    const int32_t pg = p->evictable.front();
    p->evictable.erase(p->evictable.begin());
    p->prefix_map.erase(p->page_hash[pg]);
    p->page_hash[pg] = 0;
    return pg;
  }
  return -1;
}

}  // namespace

extern "C" {

int64_t page_pool_create(int32_t num_pages) {
  if (num_pages <= 0) return -1;
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool p;
  p.alive = true;
  p.refcount.assign(num_pages, 0);
  p.page_hash.assign(num_pages, 0);
  p.free_list.reserve(num_pages);
  for (int32_t i = num_pages - 1; i >= 0; --i) p.free_list.push_back(i);
  for (size_t i = 0; i < g_pools.size(); ++i)
    if (!g_pools[i].alive) {
      g_pools[i] = std::move(p);
      return (int64_t)i;
    }
  g_pools.push_back(std::move(p));
  return (int64_t)g_pools.size() - 1;
}

int32_t page_pool_destroy(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  *p = PagePool();  // alive = false, storage released
  return 0;
}

// free + reclaimable (cached pages are evicted on demand)
int32_t page_pool_num_free(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  return (int32_t)(p->free_list.size() + p->evictable.size());
}

int32_t page_pool_seq_pages(int64_t h, int64_t seq) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(seq);
  return it == p->seqs.end() ? -1 : (int32_t)it->second.size();
}

// n fresh pages for a new sequence, all or nothing: 0, -2 if the sequence
// exists, -3 if the pool cannot hold it.
int32_t page_pool_alloc_seq(int64_t h, int64_t seq, int32_t n) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p || n < 0) return -1;
  if (p->seqs.count(seq)) return -2;
  if ((int64_t)(p->free_list.size() + p->evictable.size()) < n) return -3;
  auto& v = p->seqs[seq];
  v.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    const int32_t pg = take_page(p);
    p->refcount[pg] = 1;
    v.push_back(pg);
  }
  return 0;
}

// grow a sequence by one page: the new page id, -2 unknown, -3 exhausted.
int32_t page_pool_append(int64_t h, int64_t seq) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end()) return -2;
  const int32_t pg = take_page(p);
  if (pg < 0) return -3;
  p->refcount[pg] = 1;
  it->second.push_back(pg);
  return pg;
}

// dst shares every page of src (refcount + 1); nothing is allocated.
int32_t page_pool_fork(int64_t h, int64_t src, int64_t dst) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(src);
  if (it == p->seqs.end() || p->seqs.count(dst)) return -2;
  for (int32_t pg : it->second) p->refcount[pg]++;
  std::vector<int32_t> copy = it->second;
  p->seqs[dst] = std::move(copy);
  return 0;
}

// release a sequence; a page whose refcount reaches 0 goes to the free
// stack, or to the evictable FIFO if it carries a prefix hash. Returns the
// number of such pages.
int32_t page_pool_free_seq(int64_t h, int64_t seq) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end()) return -2;
  int32_t freed = 0;
  for (int32_t pg : it->second) {
    if (--p->refcount[pg] == 0) {
      if (p->page_hash[pg])
        p->evictable.push_back(pg);
      else
        p->free_list.push_back(pg);
      ++freed;
    }
  }
  p->seqs.erase(it);
  return freed;
}

// the (n_seqs, max_pages) int32 block table, each row padded by repeating
// its last page id: 0, or -2 for an unknown or empty sequence or one of
// more than max_pages pages.
int32_t page_pool_fill_table(int64_t h, const int64_t* seq_ids,
                             int32_t n_seqs, int32_t* out,
                             int32_t max_pages) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  for (int32_t i = 0; i < n_seqs; ++i) {
    auto it = p->seqs.find(seq_ids[i]);
    if (it == p->seqs.end()) return -2;
    const auto& v = it->second;
    if (v.empty() || (int32_t)v.size() > max_pages) return -2;
    int32_t* row = out + (size_t)i * max_pages;
    for (size_t j = 0; j < v.size(); ++j) row[j] = v[j];
    for (int32_t j = (int32_t)v.size(); j < max_pages; ++j) row[j] = v.back();
  }
  return 0;
}

// copy-on-write of a shared last page (a fork in mid-page): swap in a
// fresh private page and return (old << 32) | new, so that the caller
// copies the partial K/V on the device; -4 if the page is private already,
// -3 if the pool is exhausted, -2 for an unknown or empty sequence.
int64_t page_pool_unshare_last(int64_t h, int64_t seq) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end() || it->second.empty()) return -2;
  const int32_t pg = it->second.back();
  if (p->refcount[pg] <= 1) return -4;
  const int32_t fresh = take_page(p);
  if (fresh < 0) return -3;
  p->refcount[fresh] = 1;
  p->refcount[pg]--;
  it->second.back() = fresh;
  return ((int64_t)(uint32_t)pg << 32) | (uint32_t)fresh;
}

// register chain hashes for the first n (full) pages of seq; the first
// registration of a hash wins and a page keeps its first hash. Returns the
// number of pages that carry their hash, -2 for an unknown sequence or one
// of fewer than n pages.
int32_t page_pool_register_prefix(int64_t h, int64_t seq,
                                  const uint64_t* hashes, int32_t n) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end() || (int32_t)it->second.size() < n) return -2;
  int32_t reg = 0;
  for (int32_t i = 0; i < n; ++i) {
    const uint64_t hv = hashes[i];
    if (hv == 0) continue;
    const int32_t pg = it->second[i];
    if (p->page_hash[pg] == hv) {
      ++reg;
      continue;
    }
    if (p->page_hash[pg] != 0 || p->prefix_map.count(hv)) continue;
    p->page_hash[pg] = hv;
    p->prefix_map[hv] = pg;
    ++reg;
  }
  return reg;
}

// start seq from the cached prefix: attach each hit of the hash chain
// (refcount + 1, out of the evictable FIFO) up to the first miss. Returns
// the number of pages attached, -2 if the sequence exists.
int32_t page_pool_admit_cached(int64_t h, int64_t seq,
                               const uint64_t* hashes, int32_t n) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p) return -1;
  if (p->seqs.count(seq)) return -2;
  std::vector<int32_t> v;
  for (int32_t i = 0; i < n; ++i) {
    auto mit = p->prefix_map.find(hashes[i]);
    if (mit == p->prefix_map.end()) break;
    const int32_t pg = mit->second;
    if (p->refcount[pg] == 0) {
      for (size_t j = 0; j < p->evictable.size(); ++j)
        if (p->evictable[j] == pg) {
          p->evictable.erase(p->evictable.begin() + (std::ptrdiff_t)j);
          break;
        }
    }
    p->refcount[pg]++;
    v.push_back(pg);
  }
  const int32_t k = (int32_t)v.size();
  p->seqs[seq] = std::move(v);
  return k;
}

int32_t page_pool_refcount(int64_t h, int32_t page) {
  std::lock_guard<std::mutex> lk(g_mu);
  PagePool* p = pool_of(h);
  if (!p || page < 0 || (size_t)page >= p->refcount.size()) return -1;
  return p->refcount[page];
}

}  // extern "C"
