// Kernel B7 (piece merge): the merge of two ascending runs, the fused
// executor's piece merge (rdst_tpu_torch/ops/fused_sort.py piece_merge).
//
// It replaces the piece merge of rdst_tpu/ops/pallas_sort.py, _merge_asc_desc
// (:702) with _slice_stage (:670): a virtual-pad bitonic merge of an ascending
// and a descending run, whose strides at or above a piece ran as XLA slices,
// compares and selects, and the rest through the span and tail kernels.  That
// merge had no Pallas kernel of its own.  A bitonic merge of T elements makes
// log2(T) compare-exchange passes over them; this kernel merges the two runs
// in one pass (merge path: Odeh, Green, Mwassi, Shmueli and Birk, "Merge Path
// - Parallel Merging Made Simple", IPDPS Workshops 2012; Green, McColl and
// Bader, "GPU Merge Path", ICS 2012).
//
// What bounds it: every plane of both runs read once and the output written
// once, n * (bytes per element) * 2 over HBM bandwidth.  The design:
//
//   - merge_partition_kernel: one thread per boundary between output tiles
//     of kMergeThreads * E elements finds how many of the first d outputs
//     come from A by a binary search along that cross diagonal of the merge
//     matrix, comparing the key planes in global memory (widened to u32 in
//     registers).  The split points go to a scratch buffer the wrapper makes.
//   - merge_tile_kernel: one block per output tile.  It stages the key planes
//     of its A and B windows into shared memory (the windows are contiguous,
//     so consecutive threads load consecutive elements and the loads
//     coalesce), each thread finds its own sub-diagonal in the tile and
//     merges E elements serially, writing each output's source index into
//     shared memory.  Then every plane is written in output order: key
//     planes from shared memory, payload planes read from the runs in global
//     memory (the sources of a warp's 32 consecutive outputs are two
//     contiguous stretches, one in A and one in B), so loads and stores
//     coalesce and each element is read and written once.
//   - E follows the number of key planes, which is what the tile holds in
//     shared memory: (n_keys + 1) * kMergeThreads * E u32; E is odd, so the
//     threads of a warp writing their source indices (thread t at t * E + i)
//     fall on 32 distinct banks.
//
// Order: keys compare lexicographically over the first n_keys planes (u8,
// u16 or u32, widened to u32); on equal keys an element of A comes first, so
// the merge is stable and its output is that of a stable sort of the
// concatenation A ++ B, which is the plain version.
#include "bitonic.cuh"

namespace {

constexpr int kMergeThreads = 256;

__host__ __device__ constexpr int merge_elems(int n_keys) {
  return n_keys <= 2 ? 15 : (n_keys <= 4 ? 11 : 7);
}

struct MergePlanes {
  const void* a[kMaxPlanes];
  const void* b[kMaxPlanes];
  void* out[kMaxPlanes];
  int width[kMaxPlanes];
  int n_planes;
};

template <int K>
__device__ __forceinline__ bool lex_less(const uint32_t (&x)[K],
                                         const uint32_t (&y)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    if (x[p] != y[p]) return x[p] < y[p];
  }
  return false;
}

template <int K>
__device__ __forceinline__ void load_global(const MergePlanes& M,
                                            const void* const* src,
                                            long long i, uint32_t (&k)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p) k[p] = load_plane(src[p], M.width[p], i);
}

template <int K, int NV>
__device__ __forceinline__ void load_shared(const uint32_t* keys, int i,
                                            uint32_t (&k)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p) k[p] = keys[p * NV + i];
}

// splits[t] = the number of A's elements among the first min(t * tile, la +
// lb) outputs, for t < n_splits.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
merge_partition_kernel(MergePlanes M, long long la, long long lb,
                       long long tile, long long n_splits, long long* splits) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_splits) return;
  const long long diag = min(t * tile, la + lb);
  long long lo = max(0LL, diag - lb);
  long long hi = min(diag, la);
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    uint32_t x[K];
    uint32_t y[K];
    load_global<K>(M, M.b, diag - 1 - mid, x);
    load_global<K>(M, M.a, mid, y);
    if (lex_less<K>(x, y)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  splits[t] = lo;
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
merge_tile_kernel(MergePlanes M, long long la, long long lb,
                  const long long* splits) {
  constexpr int E = merge_elems(K);
  constexpr int NV = kMergeThreads * E;
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                         // K planes of NV keys
  int* sidx = reinterpret_cast<int*>(smem + K * NV);  // NV source indices
  const int tid = threadIdx.x;
  const long long d0 = static_cast<long long>(blockIdx.x) * NV;
  const long long d1 = min(d0 + NV, la + lb);
  const long long a0 = splits[blockIdx.x];
  const long long b0 = d0 - a0;
  const int na = static_cast<int>(splits[blockIdx.x + 1] - a0);
  const int nt = static_cast<int>(d1 - d0);
  const int nb = nt - na;

  // the tile's windows A[a0, a0 + na) ++ B[b0, b0 + nb), key planes only
#pragma unroll
  for (int p = 0; p < K; ++p) {
    uint32_t v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * kMergeThreads + tid;
      if (i < nt) {
        v[j] = i < na ? load_plane(M.a[p], M.width[p], a0 + i)
                      : load_plane(M.b[p], M.width[p], b0 + i - na);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * kMergeThreads + tid;
      if (i < nt) keys[p * NV + i] = v[j];
    }
  }
  __syncthreads();

  // this thread's outputs [d, d + E): the split of its diagonal, then a
  // serial merge; ai indexes A's window, bi the concatenated one (B from na)
  const int d = min(tid * E, nt);
  int lo = max(0, d - nb);
  int hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    uint32_t x[K];
    uint32_t y[K];
    load_shared<K, NV>(keys, na + d - 1 - mid, x);
    load_shared<K, NV>(keys, mid, y);
    if (lex_less<K>(x, y)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int ai = lo;
  int bi = na + d - lo;
  uint32_t ak[K];
  uint32_t bk[K];
  if (ai < na) load_shared<K, NV>(keys, ai, ak);
  if (bi < nt) load_shared<K, NV>(keys, bi, bk);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int pos = tid * E + i;
    if (pos < nt) {
      const bool take_a = bi >= nt || (ai < na && !lex_less<K>(bk, ak));
      if (take_a) {
        sidx[pos] = ai;
        if (++ai < na) load_shared<K, NV>(keys, ai, ak);
      } else {
        sidx[pos] = bi;
        if (++bi < nt) load_shared<K, NV>(keys, bi, bk);
      }
    }
  }
  __syncthreads();

  // every plane in output order
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    if (p >= M.n_planes) break;
    uint32_t v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * kMergeThreads + tid;
      if (i < nt) {
        const int s = sidx[i];
        if (p < K) {
          v[j] = keys[p * NV + s];
        } else {
          v[j] = s < na ? load_plane(M.a[p], M.width[p], a0 + s)
                        : load_plane(M.b[p], M.width[p], b0 + s - na);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * kMergeThreads + tid;
      if (i < nt) store_plane(M.out[p], M.width[p], d0 + i, v[j]);
    }
  }
}

template <int K>
int launch_merge(const MergePlanes& M, long long la, long long lb,
                 long long* splits, long long n_splits, cudaStream_t stream) {
  constexpr int NV = kMergeThreads * merge_elems(K);
  const long long n = la + lb;
  const long long tiles = (n + NV - 1) / NV;
  if (n_splits != tiles + 1 || tiles >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  const int smem = (K + 1) * NV * 4;
  cudaError_t err = cudaFuncSetAttribute(
      merge_tile_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pblocks = (n_splits + kMergeThreads - 1) / kMergeThreads;
  merge_partition_kernel<K>
      <<<static_cast<unsigned int>(pblocks), kMergeThreads, 0, stream>>>(
          M, la, lb, NV, n_splits, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tile_kernel<K>
      <<<static_cast<unsigned int>(tiles), kMergeThreads,
         static_cast<size_t>(smem), stream>>>(M, la, lb, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Output elements of one merge tile at n_keys key planes
// (fused_sort.merge_tile mirrors it).
extern "C" int rdst_piece_merge_tile(int n_keys) {
  return kMergeThreads * merge_elems(n_keys);
}

// a, b: n_planes device pointers each (runs of la and lb elements, keys
// first, both ascending); outs: n_planes planes of la + lb elements, widths
// in bytes, the same for a, b and outs.  splits: a device buffer of n_splits
// int64, n_splits = ceil((la + lb) / tile) + 1.
extern "C" int rdst_piece_merge(void* const* a, void* const* b,
                                void* const* outs, const int* widths,
                                int n_planes, int n_keys, long long la,
                                long long lb, long long* splits,
                                long long n_splits, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_keys < 1 ||
      n_keys > n_planes || la < 0 || lb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergePlanes M{};
  for (int p = 0; p < n_planes; ++p) {
    if (widths[p] != 1 && widths[p] != 2 && widths[p] != 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    M.a[p] = a[p];
    M.b[p] = b[p];
    M.out[p] = outs[p];
    M.width[p] = widths[p];
  }
  M.n_planes = n_planes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_keys) {
    case 1: return launch_merge<1>(M, la, lb, splits, n_splits, s);
    case 2: return launch_merge<2>(M, la, lb, splits, n_splits, s);
    case 3: return launch_merge<3>(M, la, lb, splits, n_splits, s);
    case 4: return launch_merge<4>(M, la, lb, splits, n_splits, s);
    case 5: return launch_merge<5>(M, la, lb, splits, n_splits, s);
    case 6: return launch_merge<6>(M, la, lb, splits, n_splits, s);
    case 7: return launch_merge<7>(M, la, lb, splits, n_splits, s);
    default: return launch_merge<8>(M, la, lb, splits, n_splits, s);
  }
}
