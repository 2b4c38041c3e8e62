// First-fit-decreasing multipack bin packing: the host core of
// usdm_tpu_torch/data/packing.py::MultipackSampler (a copy of the JAX
// package's native/ffd.cpp, with the same C ABI): an FFD feasibility check
// and a multifit-style allocation of sequences to ranks' bins.  Host C++,
// not a GPU kernel.
//
// Built by data/packing.py with g++ at first use into usdm_tpu_torch/_build/
// (keyed by this file's hash) and loaded with ctypes.  One change from the
// JAX package's copy: with no lengths at all, ffd_allocate returns no batch
// (that copy reads lengths[0] past the empty array and emits one batch).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// Sort indices by length descending (stable for determinism).
std::vector<int64_t> sorted_desc(const int64_t* a, int64_t n) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(),
                   [&](int64_t i, int64_t j) { return a[i] > a[j]; });
  return idx;
}

}  // namespace

extern "C" {

// Can lengths a[0..n) fit into n_bins bins of capacity c using FFD?
int ffd_check(const int64_t* a, int64_t n, int64_t c, int64_t n_bins) {
  std::vector<int64_t> order = sorted_desc(a, n);
  std::vector<int64_t> space(static_cast<size_t>(n_bins), c);
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t size = a[order[static_cast<size_t>(oi)]];
    bool placed = false;
    for (auto& s : space) {
      if (s >= size) {
        s -= size;
        placed = true;
        break;
      }
    }
    if (!placed) return 0;
  }
  return 1;
}

// FFD with result: pack a[0..n) into open-ended bins of capacity c.
// out_bin[i] = bin id of item i.  Returns the number of bins used.
int64_t ffd_pack(const int64_t* a, int64_t n, int64_t c, int64_t* out_bin) {
  std::vector<int64_t> order = sorted_desc(a, n);
  std::vector<int64_t> space;  // remaining capacity per open bin
  space.reserve(64);
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t item = order[static_cast<size_t>(oi)];
    const int64_t size = a[item];
    int64_t placed = -1;
    for (size_t bi = 0; bi < space.size(); ++bi) {
      if (space[bi] >= size) {
        space[bi] -= size;
        placed = static_cast<int64_t>(bi);
        break;
      }
    }
    if (placed < 0) {
      space.push_back(c - size);
      placed = static_cast<int64_t>(space.size()) - 1;
    }
    out_bin[item] = placed;
  }
  return static_cast<int64_t>(space.size());
}

// Multifit-style allocation over a stream of lengths: repeatedly take the
// largest prefix that FFD-fits into n_ranks bins of capacity c, emit the bin
// belonging to `rank`, advance.  Outputs:
//   out_indices : concatenated item indices of this rank's batches
//   out_offsets : batch b = out_indices[out_offsets[b] .. out_offsets[b+1])
// Returns the number of batches (<= max_batches).  total_used accumulates the
// token count packed across ALL ranks (for the efficiency statistic).
int64_t ffd_allocate(const int64_t* lengths, int64_t n, int64_t c,
                     int64_t n_ranks, int64_t rank, int64_t* out_indices,
                     int64_t* out_offsets, int64_t max_batches,
                     int64_t* total_used) {
  std::vector<int64_t> cumsum(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < n; ++i) cumsum[static_cast<size_t>(i) + 1] = cumsum[static_cast<size_t>(i)] + lengths[i];

  int64_t start = 0;
  int64_t consumed = 0;
  int64_t n_batches = 0;
  int64_t out_pos = 0;
  *total_used = 0;
  out_offsets[0] = 0;

  std::vector<int64_t> bin_of;

  while (n_batches < max_batches && start < n) {  // n 0: no batch (the numpy twin's)
    // binary search the largest l such that lengths[start, start+l) fits
    // into n_ranks bins; upper bound from the cumulative-sum capacity.
    int64_t lo = 1;
    int64_t hi_limit = n - start;
    // r = first index where cumsum exceeds consumed + c*n_ranks
    int64_t budget = consumed + c * n_ranks;
    int64_t hi = static_cast<int64_t>(
                     std::upper_bound(cumsum.begin() + start, cumsum.end(), budget) -
                     (cumsum.begin() + start));  // elements usable
    if (hi > hi_limit + 1) hi = hi_limit + 1;
    if (hi < 1) break;
    // invariant: prefix of size lo fits; [hi,...) assumed not to fit
    while (hi - lo > 1) {
      int64_t mid = (lo + hi) / 2;
      if (ffd_check(lengths + start, mid, c, n_ranks)) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    if (lo <= 0) break;

    bin_of.assign(static_cast<size_t>(lo), -1);
    int64_t used_bins = ffd_pack(lengths + start, lo, c, bin_of.data());
    if (used_bins < n_ranks) break;  // final ragged chunk: drop (same as ref)

    for (int64_t i = 0; i < lo; ++i) {
      if (bin_of[static_cast<size_t>(i)] == rank) {
        out_indices[out_pos++] = start + i;
      }
      *total_used += lengths[start + i];
    }
    ++n_batches;
    out_offsets[n_batches] = out_pos;

    start += lo;
    consumed = cumsum[static_cast<size_t>(start)];
    if (start >= n) break;
  }
  return n_batches;
}

}  // extern "C"
