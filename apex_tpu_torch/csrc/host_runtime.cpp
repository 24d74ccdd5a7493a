// host_runtime: the port's native host-side runtime (C ABI, loaded by
// apex_tpu_torch/_native.py with ctypes; built with the host C++ compiler,
// not nvcc: nothing here runs on the card).  Same entry points and ABI
// version as the JAX package's library:
//  - apex_flatten / apex_unflatten: multithreaded memcpy gather / scatter
//    of host buffers at byte offsets (apex_C.flatten / unflatten);
//  - apex_plan_buckets: the greedy message-size bucket assignment apex DDP
//    builds on its first backward (apex/parallel/distributed.py:339-362):
//    walk tensors in order, close a bucket once the cumulative numel
//    reaches message_numel or at a trigger tensor;
//  - apex_fingerprint64: FNV-1a over raw bytes;
//  - apex_native_abi_version: 1.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over up to n_threads workers, partitioning the
// index space by contiguous blocks weighted by nbytes so each worker copies
// a similar byte volume.
template <typename Fn>
void parallel_over_tensors(const int64_t* nbytes, int64_t n, int n_threads,
                           Fn fn) {
  if (n <= 0) return;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) total += nbytes[i];
  int workers = std::max(1, std::min<int>(n_threads, (int)n));
  if (workers == 1 || total < (1 << 20)) {  // small payloads: not worth threads
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  int64_t per = (total + workers - 1) / workers;
  int64_t start = 0;
  for (int w = 0; w < workers && start < n; ++w) {
    int64_t end = start, acc = 0;
    while (end < n && (acc < per || end == start)) acc += nbytes[end++];
    if (w == workers - 1) end = n;
    pool.emplace_back([start, end, &fn]() {
      for (int64_t i = start; i < end; ++i) fn(i);
    });
    start = end;
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Gather n source buffers into dst at byte offsets[i]; nbytes[i] per buffer.
void apex_flatten(const void** srcs, const int64_t* nbytes,
                  const int64_t* offsets, int64_t n, char* dst,
                  int n_threads) {
  parallel_over_tensors(nbytes, n, n_threads, [&](int64_t i) {
    std::memcpy(dst + offsets[i], srcs[i], (size_t)nbytes[i]);
  });
}

// Scatter a flat buffer back into n destination buffers.
void apex_unflatten(const char* src, const int64_t* nbytes,
                    const int64_t* offsets, int64_t n, void** dsts,
                    int n_threads) {
  parallel_over_tensors(nbytes, n, n_threads, [&](int64_t i) {
    std::memcpy(dsts[i], src + offsets[i], (size_t)nbytes[i]);
  });
}

// Greedy bucket planning (apex/parallel/distributed.py:339-362 semantics):
// tensors are taken in order; the running bucket closes once its cumulative
// numel reaches message_numel, or immediately after a trigger tensor.
// Writes bucket_ids[i] for every tensor and returns the bucket count.
int64_t apex_plan_buckets(const int64_t* numels, const uint8_t* is_trigger,
                          int64_t n, int64_t message_numel,
                          int64_t* bucket_ids) {
  int64_t bucket = 0, acc = 0;
  bool open = false;
  for (int64_t i = 0; i < n; ++i) {
    bucket_ids[i] = bucket;
    open = true;
    acc += numels[i];
    bool trigger = is_trigger != nullptr && is_trigger[i];
    if (acc >= message_numel || trigger) {
      ++bucket;
      acc = 0;
      open = false;
    }
  }
  return bucket + (open ? 1 : 0);
}

// 64-bit FNV-1a over a byte buffer.
uint64_t apex_fingerprint64(const void* data, int64_t nbytes, uint64_t seed) {
  const unsigned char* p = (const unsigned char*)data;
  uint64_t h = seed ? seed : 0xCBF29CE484222325ULL;  // FNV offset basis
  for (int64_t i = 0; i < nbytes; ++i) {
    h ^= p[i];
    h *= 0x100000001B3ULL;  // FNV prime
  }
  return h;
}

int apex_native_abi_version(void) { return 1; }

}  // extern "C"
