// DFIRE step-form pair kernel (K4) for Hopper (sm_90a), bound to Python
// with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_dfire_kernel (the v1 kernel
// of dfire_pairs_pallas).  For every pose: the raw sum over receptor x
// ligand atom pairs with d2 <= cutoff2 of
//   dq[0][i][j] + sum_k dq[k][i][j] * [d2 >= s_k]
// from the (K, Nr, Nl) step tables, plus per-atom interface flags at
// d2 <= iface2.  Every (receptor tile, ligand tile, pose) has its own cull
// bit and interface bit; a pose is scored on a tile only where its cull bit
// is 1, and flagged only where both are.  The receptor is rigid (one copy
// for all poses) or per pose (receptor ANM).
//
// What bounds it on this card: the per-pair-pose issue rate (d2, the bin
// search, a shared-memory load), not bytes, provided each pair's K channels
// are read from device memory once a call: the tables are K x Nr x Nl
// values (35 MB at 1ppe's 1615 x 221 atoms with 21 channels), and read once
// a pose chunk they would be most of the call.  The TPU kernel kept a
// tile's channels in VMEM (21 x 32 x 128 x 4 B = 344 KB) and looped over
// every pose; an SM has 227 KB of shared memory.  What the design does:
//   * one block of 128 threads per 4 receptor rows x 128 ligand atoms
//     (512 pairs, inside one cull tile) loops over every pose of the call;
//     each thread owns one ligand atom and 4 receptor rows;
//   * before the pose loop each thread reads its 4 pairs' channels once,
//     forms their prefix sums in float (the chain's addition order, so each
//     pair's value is bit-equal to the TPU kernel's select chain) and keeps
//     them in shared memory, K x 512 floats (43 KB at K = 21); a thread
//     reads back only its own entries, at a bank fixed by its lane;
//   * per pose, the bin is a 5-step binary search over the thresholds in
//     shared memory and the pair's value one shared-memory load;
//   * a rigid receptor's 4 rows sit in registers; a per-pose receptor's
//     rows are read per pose, one address per warp (a broadcast);
//   * the ligand coordinates of the next pose are loaded while the current
//     one is scored;
//   * sums are deterministic: no float atomics.  Per pose, each warp
//     reduces its threads' sums in a fixed tree into shared memory; every
//     32 poses the 4 warp sums are added in order and written to the
//     block's partial row; a second kernel adds the rows in order.
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
// Atoms past the true counts (nr, nl) are padding and are skipped: the
// inputs are not padded.
//
// d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with explicit round-to-nearest
// intrinsics: no contraction into FMA, so d2 is bit-equal to the plain
// PyTorch version and no pair moves across a bin edge between the two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

#include "sum_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPairs = 4;           // receptor rows a thread owns
constexpr int kBlockPairs = kThreads * kPairs;
constexpr int kMaxChannels = 32;
constexpr int kBatch = 32;          // poses between two block reductions
constexpr int kWarps = kThreads / 32;

struct Thresholds {
  float v[kMaxChannels];
};

struct Inputs {
  const float* rec;          // (1 | g, nr, 3)
  const float* lig;          // (g, 3, nl)
  const int32_t* act;        // (n_r, n_l, g)
  const int32_t* iface_act;  // (n_r, n_l, g)
  float* ifr;                // (g, nr_pad) or null
  float* ifl;                // (g, nl_pad) or null
  int nr, nl, nr_pad, nl_pad, g, r_tile, l_tile, n_l, n_k;
  float cutoff2, iface2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Grid (nr_pad / block_rows, n_l); partial row = blockIdx.y * gridDim.x + blockIdx.x.
template <typename T, bool kPerPose>
__global__ void __launch_bounds__(kThreads)
dfire_pairs_v1_kernel(Inputs in, Thresholds thr, const T* __restrict__ dq,
                      float* __restrict__ partial) {
  extern __shared__ float s_cum[];   // [n_k][kBlockPairs]
  __shared__ float s_thr[kMaxChannels];
  __shared__ float s_red[kWarps][kBatch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_per_pass = kThreads / in.l_tile;
  const int r0 = blockIdx.x * kPairs * rows_per_pass;
  const int l = blockIdx.y;
  const int tile = (r0 / in.r_tile) * in.n_l + l;
  const int j = l * in.l_tile + tid % in.l_tile;     // ligand atom
  const int i0 = r0 + tid / in.l_tile;               // first receptor row
  const bool j_ok = j < in.nl;
  float* part = partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * in.g;

  // The 4 pairs' prefix sums, each channel read once, in channel order.
  bool ok[kPairs];
  float rx[kPairs], ry[kPairs], rz[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int i = i0 + k * rows_per_pass;
    ok[k] = j_ok && i < in.nr;
    if (ok[k]) {
      const T* src = dq + (size_t)i * in.nl + j;
      const size_t stride = (size_t)in.nr * in.nl;
      float acc = to_float(src[0]);
      s_cum[k * kThreads + tid] = acc;
      for (int c = 1; c < in.n_k; ++c) {
        acc = __fadd_rn(acc, to_float(src[c * stride]));
        s_cum[c * kBlockPairs + k * kThreads + tid] = acc;
      }
      if (!kPerPose) {
        rx[k] = in.rec[(size_t)i * 3];
        ry[k] = in.rec[(size_t)i * 3 + 1];
        rz[k] = in.rec[(size_t)i * 3 + 2];
      }
    }
  }
  if (tid < kMaxChannels) s_thr[tid] = thr.v[tid];
  __syncthreads();

  const int32_t* act = in.act + (size_t)tile * in.g;
  const int32_t* iface_act = in.iface_act + (size_t)tile * in.g;
  const size_t lig_pose = (size_t)3 * in.nl;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;   // the next pose's ligand atom
  if (j_ok) {
    nx = in.lig[j];
    ny = in.lig[in.nl + j];
    nz = in.lig[2 * in.nl + j];
  }
  for (int g0 = 0; g0 < in.g; g0 += kBatch) {
    const int n_batch = min(kBatch, in.g - g0);
    for (int b = 0; b < n_batch; ++b) {
      const int g = g0 + b;
      const float lx = nx, ly = ny, lz = nz;
      if (j_ok && g + 1 < in.g) {
        const float* lp = in.lig + (g + 1) * lig_pose + j;
        nx = lp[0];
        ny = lp[in.nl];
        nz = lp[2 * in.nl];
      }
      if (act[g] == 0) {   // the same for the whole block
        if (lane == 0) s_red[warp][b] = 0.0f;
        continue;
      }
      const bool do_iface = in.ifr != nullptr && iface_act[g] != 0;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        if (!ok[k]) continue;
        const int i = i0 + k * rows_per_pass;
        float ax = rx[k], ay = ry[k], az = rz[k];
        if (kPerPose) {
          const float* rp = in.rec + ((size_t)g * in.nr + i) * 3;
          ax = rp[0];
          ay = rp[1];
          az = rp[2];
        }
        const float dx = __fsub_rn(lx, ax);
        const float dy = __fsub_rn(ly, ay);
        const float dz = __fsub_rn(lz, az);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 <= in.cutoff2) {
          // Largest c with thresholds[c] <= d2 (thresholds ascend; channel
          // 0 is the baseline and is never compared).
          int c = 0;
#pragma unroll
          for (int step = kMaxChannels / 2; step > 0; step >>= 1) {
            if (d2 >= s_thr[c + step]) c += step;
          }
          sum = __fadd_rn(sum, s_cum[c * kBlockPairs + k * kThreads + tid]);
        }
        if (do_iface && d2 <= in.iface2) {
          in.ifr[(size_t)g * in.nr_pad + i] = 1.0f;
          in.ifl[(size_t)g * in.nl_pad + j] = 1.0f;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (lane == 0) s_red[warp][b] = sum;
    }
    __syncthreads();
    if (tid < n_batch) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
      part[g0 + tid] = s;
    }
    __syncthreads();
  }
}

template <typename T, bool kPerPose>
int launch(const Inputs& in, const Thresholds& thr, const void* dq, float* partial,
           dim3 grid, size_t smem, cudaStream_t s) {
  auto kernel = dfire_pairs_v1_kernel<T, kPerPose>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, s>>>(in, thr, static_cast<const T*>(dq), partial);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dfire_pairs_v1_launch(
    const void* rec, const void* lig, const void* dq, const void* act,
    const void* iface_act, void* partial, void* raw, void* ifr, void* ifl,
    int nr, int nl, int nr_pad, int nl_pad, int g, int rec_poses, int r_tile,
    int l_tile, int dq_bf16, int need_iface, const float* thresholds, int n_k,
    float cutoff2, float iface2, void* stream) {
  if (l_tile <= 0 || l_tile > kThreads || kThreads % l_tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int block_rows = kPairs * (kThreads / l_tile);
  if (r_tile <= 0 || r_tile % block_rows != 0 || nr_pad % r_tile != 0 ||
      nl_pad % l_tile != 0 || nr > nr_pad || nl > nl_pad || g < 1 || n_k < 1 ||
      n_k > kMaxChannels || (rec_poses != 1 && rec_poses != g) ||
      (need_iface && (ifr == nullptr || ifl == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Thresholds thr;
  const float inf = std::numeric_limits<float>::infinity();
  for (int k = 0; k < kMaxChannels; ++k) thr.v[k] = k < n_k ? thresholds[k] : inf;
  const Inputs in{static_cast<const float*>(rec), static_cast<const float*>(lig),
                  static_cast<const int32_t*>(act), static_cast<const int32_t*>(iface_act),
                  need_iface ? static_cast<float*>(ifr) : nullptr,
                  need_iface ? static_cast<float*>(ifl) : nullptr,
                  nr, nl, nr_pad, nl_pad, g, r_tile, l_tile, nl_pad / l_tile, n_k,
                  cutoff2, iface2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nr_pad / block_rows, nl_pad / l_tile);
  const size_t smem = (size_t)n_k * kBlockPairs * sizeof(float);
  float* f_part = static_cast<float*>(partial);
  int err;
  if (dq_bf16) {
    err = rec_poses == 1 ? launch<__nv_bfloat16, false>(in, thr, dq, f_part, grid, smem, s)
                         : launch<__nv_bfloat16, true>(in, thr, dq, f_part, grid, smem, s);
  } else {
    err = rec_poses == 1 ? launch<float, false>(in, thr, dq, f_part, grid, smem, s)
                         : launch<float, true>(in, thr, dq, f_part, grid, smem, s);
  }
  if (err != 0) return err;
  return sum_rows(f_part, nullptr, static_cast<float*>(raw), grid.x * grid.y, g, s);
}
