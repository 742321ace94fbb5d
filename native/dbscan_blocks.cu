// Per-block DBSCAN on an NVIDIA Hopper GPU, called from JAX through the XLA
// foreign function interface (cluster/dbscan_cuda.py builds and registers it).
//
// One thread block clusters one point block of `cap` points. Everything the
// solve touches stays in shared memory for the whole kernel:
//   - the eps-adjacency as a bitmask, cap x cap bits (128 KB at cap = 1024);
//   - the x/y coordinates, the labels and the cluster ids (4 KB each);
//   - validity, core and root flags as bitmasks.
// The min-label sweeps, pointer jumps, root ranking and border max run inside
// the kernel between block barriers, so one launch covers all blocks and no
// loop predicate goes back to the host.
//
// Semantics are those of cluster.dbscan.dbscan_padded (rules 1-5 of that
// module's docstring), bit for bit:
//   adj[i][j]  = dist(i, j) <= eps && valid[i] && valid[j]   (float32)
//   core[i]    = valid[i] && popcount(adj[i]) >= min_pts
//   root[i]    = least core index reachable from core point i over core-core
//                edges (the unique fixpoint of min-label propagation)
//   id[i]      = rank of root[i] among the roots, in index order (1-based)
//   label[i]   = id[i] for core points, else the max id over adjacent cores,
//                0 for noise and padding.
// The distances carry no multiply (|dx| + |dy|, or dx + dy for the legacy
// signed metric), so no FMA contraction can make them differ from XLA's.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCap = 1024;  // 32 words per row: one warp scans the roots

enum Metric : int32_t { kL1Motor = 0, kSignedSumXY = 1 };

__device__ __forceinline__ bool bit(const uint32_t* mask, int i) {
  return (mask[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ unsigned upto_mask(int lane) {
  return lane == 31 ? kFull : ((1u << (lane + 1)) - 1u);
}

template <int kMetric>
__device__ __forceinline__ float dist(float xi, float yi, float xj, float yj) {
  if (kMetric == kL1Motor) return fabsf(xi - xj) + fabsf(yi - yj);
  return (xi - xj) + (yi - yj);
}

size_t smem_bytes(int cap) {
  const int words = cap / 32;
  return sizeof(uint32_t) * (size_t(cap) * words  // adjacency
                             + 4 * size_t(cap)    // x, y, lab, cid
                             + 4 * size_t(words)); // valid, core, root, prefix
}

template <int kMetric>
__global__ void __launch_bounds__(1024)
dbscan_blocks_kernel(const float* __restrict__ coords,
                     const bool* __restrict__ valid,
                     int32_t* __restrict__ label_out,
                     int32_t* __restrict__ nclus_out,
                     bool* __restrict__ core_out,
                     int cap, float eps, int min_pts) {
  extern __shared__ uint32_t smem[];
  const int words = cap / 32;
  uint32_t* adj = smem;
  float* xs = reinterpret_cast<float*>(adj + size_t(cap) * words);
  float* ys = xs + cap;
  int* lab = reinterpret_cast<int*>(ys + cap);
  int* cid = lab + cap;
  uint32_t* vmask = reinterpret_cast<uint32_t*>(cid + cap);
  uint32_t* cmask = vmask + words;
  uint32_t* rmask = cmask + words;
  int* wprefix = reinterpret_cast<int*>(rmask + words);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t base = size_t(blockIdx.x) * cap;
  const float* cb = coords + 2 * base;

  for (int i = tid; i < cap; i += blockDim.x) {
    xs[i] = cb[2 * i];
    ys[i] = cb[2 * i + 1];
  }
  for (int k = warp; k < words; k += nwarps) {
    const unsigned bits = __ballot_sync(kFull, valid[base + 32 * k + lane]);
    if (lane == 0) vmask[k] = bits;
  }
  __syncthreads();

  // Adjacency rows, one warp per row: lane l tests column 32k + l and the
  // ballot packs the 32 results into word k. lab[i] starts as i for core
  // points and cap (= infinity) elsewhere.
  for (int i = warp; i < cap; i += nwarps) {
    const float xi = xs[i], yi = ys[i];
    const bool vi = bit(vmask, i);
    int count = 0;
    for (int k = 0; k < words; ++k) {
      const int j = 32 * k + lane;
      const bool hit = vi && ((vmask[k] >> lane) & 1u) &&
                       dist<kMetric>(xi, yi, xs[j], ys[j]) <= eps;
      const unsigned w = __ballot_sync(kFull, hit);
      if (lane == 0) adj[size_t(i) * words + k] = w;
      count += __popc(w);
    }
    if (lane == 0) lab[i] = (vi && count >= min_pts) ? i : cap;
  }
  __syncthreads();
  for (int k = warp; k < words; k += nwarps) {
    const unsigned bits = __ballot_sync(kFull, lab[32 * k + lane] < cap);
    if (lane == 0) cmask[k] = bits;
  }
  __syncthreads();

  // Min-label propagation over core-core edges with a pointer jump per row.
  // Labels only decrease and always name a core point reachable from the
  // row, so updating in place converges to the same unique fixpoint as the
  // synchronous sweeps of the plain path; a sweep in which no row changed
  // read only final values, hence is the fixpoint.
  volatile int* vlab = lab;
  bool again = true;
  while (again) {
    int changed = 0;
    for (int i = warp; i < cap; i += nwarps) {
      if (!bit(cmask, i)) continue;
      const uint32_t* row = adj + size_t(i) * words;
      int m = vlab[i];
      for (int k = 0; k < words; ++k) {
        const unsigned w = row[k] & cmask[k];
        if (w == 0u) continue;
        if ((w >> lane) & 1u) m = min(m, vlab[32 * k + lane]);
      }
      for (int off = 16; off > 0; off >>= 1)
        m = min(m, __shfl_xor_sync(kFull, m, off));
      m = min(m, vlab[m]);
      if (lane == 0 && m < vlab[i]) {
        vlab[i] = m;
        changed = 1;
      }
      __syncwarp();
    }
    again = __syncthreads_or(changed);
  }

  // Roots (core points that are their own label) ranked in index order.
  for (int k = warp; k < words; k += nwarps) {
    const int i = 32 * k + lane;
    const unsigned bits =
        __ballot_sync(kFull, ((cmask[k] >> lane) & 1u) && lab[i] == i);
    if (lane == 0) rmask[k] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < words ? __popc(rmask[lane]) : 0;
    int incl = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane < words) wprefix[lane] = incl - c;
    if (lane == 31) nclus_out[blockIdx.x] = incl;
  }
  __syncthreads();
  for (int i = tid; i < cap; i += blockDim.x) {
    int id = 0;
    if (bit(cmask, i)) {
      const int r = lab[i];
      id = wprefix[r >> 5] + __popc(rmask[r >> 5] & upto_mask(r & 31));
    }
    cid[i] = id;
  }
  __syncthreads();

  // Border points take the largest id among adjacent cores; lab is free now
  // and collects the final labels for one coalesced store.
  for (int i = warp; i < cap; i += nwarps) {
    int out = cid[i];
    if (!bit(cmask, i)) {
      const uint32_t* row = adj + size_t(i) * words;
      int m = 0;
      for (int k = 0; k < words; ++k) {
        const unsigned w = row[k] & cmask[k];
        if ((w >> lane) & 1u) m = max(m, cid[32 * k + lane]);
      }
      for (int off = 16; off > 0; off >>= 1)
        m = max(m, __shfl_xor_sync(kFull, m, off));
      out = m;
    }
    if (lane == 0) lab[i] = out;
  }
  __syncthreads();
  for (int i = tid; i < cap; i += blockDim.x) {
    label_out[base + i] = lab[i];
    core_out[base + i] = bit(cmask, i);
  }
}

template <int kMetric>
cudaError_t launch(cudaStream_t stream, int64_t n_blocks, int cap,
                   const float* coords, const bool* valid, int32_t* label,
                   int32_t* nclus, bool* core, float eps, int min_pts) {
  const size_t smem = smem_bytes(cap);
  cudaError_t err = cudaFuncSetAttribute(
      dbscan_blocks_kernel<kMetric>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int threads = cap < 128 ? 128 : cap;
  dbscan_blocks_kernel<kMetric><<<unsigned(n_blocks), threads, smem, stream>>>(
      coords, valid, label, nclus, core, cap, eps, min_pts);
  return cudaGetLastError();
}

ffi::Error DbscanBlocksImpl(cudaStream_t stream,
                            ffi::Buffer<ffi::F32> coords,
                            ffi::Buffer<ffi::PRED> valid,
                            ffi::ResultBuffer<ffi::S32> label,
                            ffi::ResultBuffer<ffi::S32> n_clusters,
                            ffi::ResultBuffer<ffi::PRED> core,
                            float eps, int32_t min_pts, int32_t metric) {
  const auto dims = coords.dimensions();
  if (dims.size() != 3 || dims[2] != 2)
    return ffi::Error::InvalidArgument("coords must be [B, cap, 2]");
  const int64_t n_blocks = dims[0];
  const int64_t cap = dims[1];
  if (cap < 32 || cap % 32 != 0 || cap > kMaxCap)
    return ffi::Error::InvalidArgument(
        "cap must be a multiple of 32 in [32, 1024]");
  if (n_blocks == 0) return ffi::Error::Success();
  cudaError_t err;
  if (metric == kL1Motor) {
    err = launch<kL1Motor>(stream, n_blocks, int(cap), coords.typed_data(),
                           valid.typed_data(), label->typed_data(),
                           n_clusters->typed_data(), core->typed_data(), eps,
                           min_pts);
  } else if (metric == kSignedSumXY) {
    err = launch<kSignedSumXY>(stream, n_blocks, int(cap),
                               coords.typed_data(), valid.typed_data(),
                               label->typed_data(), n_clusters->typed_data(),
                               core->typed_data(), eps, min_pts);
  } else {
    return ffi::Error::InvalidArgument("unknown metric code");
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    VtkcpDbscanBlocks, DbscanBlocksImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::PRED>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::PRED>>()
        .Attr<float>("eps")
        .Attr<int32_t>("min_pts")
        .Attr<int32_t>("metric"));
