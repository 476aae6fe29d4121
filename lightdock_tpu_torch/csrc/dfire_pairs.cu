// DFIRE pair kernel for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces lightdock_tpu/ops/pallas_energy.py:_dfire_kernel_v2 (body
// _dfire_v2_tile_body).  For every pose: the raw DFIRE sum over receptor x
// ligand atom pairs with d2 <= 225, each pair taking the cumulative
// potential at the bin of d2, plus per-atom interface flags at
// d2 <= 2.45^2.  (receptor tile, ligand tile, pose chunk) triples whose
// cull bit is 0 are skipped.
//
// What bounds it on this card: not bytes (the coordinates of a 16-pose
// chunk are a few KB) but the per-pair issue rate (d2, the bin search, the
// mask) and the table gather, which hits L1/L2.  What the design does:
//   * one thread block per (receptor tile, ligand tile, pose chunk), 256
//     threads; each thread owns one ligand atom and keeps its coordinates
//     for all 16 poses in registers, so the inner loop over poses reads no
//     shared or global memory for the ligand;
//   * the table is laid out pair-major, cum[i][type_j][bin], so all bins of
//     one atom pair share a 128-byte line and the 16 poses of a chunk hit
//     the same line one after another;
//   * the bin is a 5-step binary search over the live thresholds held in
//     shared memory (padded with +inf), not a 20-compare chain; chunks
//     whose near bit is 0 start the search at the far split, as the TPU
//     kernel's far subtree did;
//   * sums are deterministic: no float atomics.  Each block reduces its
//     per-pose sums in a fixed tree and writes them to a per-tile partial
//     row; a second kernel adds the tiles in order.
// Interface flags are set by storing 1.0f (idempotent, so concurrent
// stores of the same value are harmless); the wrapper zeroes them first.
//
// d2 = ((dx*dx) + (dy*dy)) + (dz*dz) with explicit round-to-nearest
// intrinsics: no contraction into FMA, so d2 is bit-equal to the plain
// PyTorch version and no pair moves across a bin edge between the two.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
constexpr int kPoses = 16;       // poses per chunk (POSE_BLOCK)
constexpr int kMaxChannels = 32;
constexpr int kMaxRTile = 128;
constexpr int kWarps = kThreads / 32;

struct Thresholds {
  float v[kMaxChannels];
};

__global__ void __launch_bounds__(kThreads)
dfire_pairs_kernel(const float* __restrict__ rec,         // (nr_pad, 3)
                   const float* __restrict__ lig,         // (gp, 3, nl_pad)
                   const float* __restrict__ cum,         // (nr_pad, t1, kp)
                   const int32_t* __restrict__ lig_type,  // (nl_pad,)
                   const int32_t* __restrict__ act,       // (n_r, n_l, n_chunks)
                   const int32_t* __restrict__ iface_act, // (n_r, n_l, gp)
                   const int32_t* __restrict__ near,      // (n_r, n_l, n_chunks) or null
                   float* __restrict__ partial,           // (n_r * n_l, gp)
                   float* __restrict__ ifr,               // (gp, nr_pad) or null
                   float* __restrict__ ifl,               // (gp, nl_pad) or null
                   int nr_pad, int nl_pad, int gp, int r_tile, int l_tile,
                   int t1, int kp, Thresholds thr, int n_k, int split,
                   float cutoff2, float iface2) {
  __shared__ float s_rec[kMaxRTile * 3];
  __shared__ float s_thr[2 * kMaxChannels];
  __shared__ float s_red[kWarps][kPoses];

  const int c = blockIdx.x;
  const int l = blockIdx.y;
  const int r = blockIdx.z;
  const int n_l = gridDim.y;
  const int n_chunks = gridDim.x;
  const int tile = r * n_l + l;
  const int c0 = c * kPoses;
  const int tid = threadIdx.x;
  float* part = partial + (size_t)tile * gp + c0;

  if (act[(size_t)tile * n_chunks + c] == 0) {
    if (tid < kPoses) part[tid] = 0.0f;
    return;
  }
  const bool is_near = near == nullptr || near[(size_t)tile * n_chunks + c] != 0;
  bool do_iface = false;
  if (ifr != nullptr && is_near) {
    const int32_t* ia = iface_act + (size_t)tile * gp + c0;
    for (int p = 0; p < kPoses; ++p) do_iface |= ia[p] != 0;
  }
  // Far chunk: no pair is nearer than thresholds[split], so the search
  // starts there, and no pair can be inside the interface cutoff.
  const int k_lo = is_near ? 0 : split;

  const int r0 = r * r_tile;
  const int l0 = l * l_tile;
  for (int x = tid; x < r_tile * 3; x += kThreads) s_rec[x] = rec[(size_t)r0 * 3 + x];
  if (tid < 2 * kMaxChannels) s_thr[tid] = tid < n_k ? thr.v[tid] : CUDART_INF_F;
  __syncthreads();

  // Thread -> (ligand atom j, receptor rows i0, i0 + row_step, ...).
  const int j = tid % l_tile;
  const int i0 = tid / l_tile;
  const int row_step = kThreads / l_tile;

  float lx[kPoses], ly[kPoses], lz[kPoses], acc[kPoses];
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    const float* lp = lig + (size_t)(c0 + p) * 3 * nl_pad + l0 + j;
    lx[p] = lp[0];
    ly[p] = lp[nl_pad];
    lz[p] = lp[2 * nl_pad];
    acc[p] = 0.0f;
  }
  const int tb = lig_type[l0 + j];

  for (int i = i0; i < r_tile; i += row_step) {
    const float rx = s_rec[i * 3];
    const float ry = s_rec[i * 3 + 1];
    const float rz = s_rec[i * 3 + 2];
    const float* row = cum + ((size_t)(r0 + i) * t1 + tb) * kp;
#pragma unroll
    for (int p = 0; p < kPoses; ++p) {
      const float dx = __fsub_rn(lx[p], rx);
      const float dy = __fsub_rn(ly[p], ry);
      const float dz = __fsub_rn(lz[p], rz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= cutoff2) {
        // Largest b >= k_lo with thresholds[b] <= d2 (thresholds ascend).
        int b = k_lo;
#pragma unroll
        for (int step = kMaxChannels / 2; step > 0; step >>= 1) {
          if (d2 >= s_thr[b + step]) b += step;
        }
        acc[p] = __fadd_rn(acc[p], __ldg(row + b));
      }
      if (do_iface && d2 <= iface2) {
        ifr[(size_t)(c0 + p) * nr_pad + r0 + i] = 1.0f;
        ifl[(size_t)(c0 + p) * nl_pad + l0 + j] = 1.0f;
      }
    }
  }

  // Fixed-order block reduction of the 16 per-pose sums.
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < kPoses; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp][p] = v;
  }
  __syncthreads();
  if (tid < kPoses) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
    part[tid] = s;
  }
}

// raw[g] = sum over tiles, in tile order, of partial[tile][g].
__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ raw, int n_tiles, int gp) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= gp) return;
  float s = 0.0f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(size_t)t * gp + g];
  raw[g] = s;
}

}  // namespace

extern "C" int dfire_pairs_launch(
    const void* rec, const void* lig, const void* cum, const void* lig_type,
    const void* act, const void* iface_act, const void* near, void* partial,
    void* raw, void* ifr, void* ifl, int nr_pad, int nl_pad, int gp,
    int r_tile, int l_tile, int t1, int kp,
    const float* thresholds, int n_k, int split, float cutoff2, float iface2,
    void* stream) {
  if (r_tile <= 0 || r_tile > kMaxRTile || l_tile <= 0 ||
      l_tile > kThreads || kThreads % l_tile != 0 || n_k < 1 ||
      n_k > kMaxChannels || split < 0 || split >= n_k || nr_pad % r_tile != 0 ||
      nl_pad % l_tile != 0 || gp % kPoses != 0 || kp < n_k) {
    return (int)cudaErrorInvalidValue;
  }
  Thresholds thr;
  const float inf = std::numeric_limits<float>::infinity();
  for (int k = 0; k < kMaxChannels; ++k) thr.v[k] = k < n_k ? thresholds[k] : inf;
  const int n_r = nr_pad / r_tile;
  const int n_l = nl_pad / l_tile;
  const int n_chunks = gp / kPoses;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_chunks, n_l, n_r);
  dfire_pairs_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(rec), static_cast<const float*>(lig),
      static_cast<const float*>(cum), static_cast<const int32_t*>(lig_type),
      static_cast<const int32_t*>(act), static_cast<const int32_t*>(iface_act),
      static_cast<const int32_t*>(near), static_cast<float*>(partial),
      static_cast<float*>(ifr), static_cast<float*>(ifl), nr_pad, nl_pad, gp,
      r_tile, l_tile, t1, kp, thr, n_k, split, cutoff2, iface2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_tiles_kernel<<<(gp + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(raw), n_r * n_l, gp);
  return (int)cudaGetLastError();
}
